"""Carry parameters across from the JAX package, leaf by leaf.

``params_from_jax`` takes the nested dict that
``repro.models.model.init_params`` returns, with every leaf converted to a
numpy array (``np.asarray``), and gives the port's parameters on ``device``.
Shapes are checked against the port's ``param_defs``; a leaf the port does
not define, or one it lacks, is an error.
"""
from __future__ import annotations

import numpy as np
import torch

from .config import ModelConfig
from .model import param_defs
from .params import TORCH_DTYPES, tree_items


def params_from_jax(tree, cfg: ModelConfig, device) -> dict:
    defs = param_defs(cfg)
    want = {path for path, _ in tree_items(defs)}
    got = dict(tree_items(tree))
    if want != got.keys():
        raise KeyError(f"parameter trees differ: missing "
                       f"{sorted(want - got.keys())}, unexpected "
                       f"{sorted(got.keys() - want)}")

    def convert(node, prefix):
        if isinstance(node, dict):
            return {k: convert(v, f"{prefix}.{k}" if prefix else k)
                    for k, v in node.items()}
        x = np.asarray(got[prefix])
        if x.shape != tuple(node.shape):
            raise ValueError(f"{prefix}: shape {x.shape}, the port defines "
                             f"{node.shape}")
        # Through float32: numpy has no bfloat16 of its own, and the
        # widening is exact.
        t = torch.from_numpy(np.array(x, np.float32))
        return t.to(device=device, dtype=TORCH_DTYPES[node.dtype])

    return convert(defs, "")
