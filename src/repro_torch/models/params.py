"""Parameter metadata: the shape/dtype record of one tensor.

The counterpart of ``repro.distributed.sharding.ParamInfo``.  This port runs
on one device, so nothing here shards; ``axes`` and ``fsdp_dim`` are kept
so that definitions read the same in both packages.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "float16": torch.float16, "int32": torch.int32}
ITEMSIZE = {"float32": 4, "bfloat16": 2, "float16": 2, "int32": 4}


@dataclass(frozen=True)
class ParamInfo:
    """Shape/dtype/logical-axes record for one parameter tensor."""
    shape: tuple[int, ...]
    dtype: str = "float32"
    axes: tuple[Optional[str], ...] = ()
    fsdp_dim: Optional[int] = None
    init_scale: float = 0.02

    def __post_init__(self):
        if len(self.axes) not in (0, len(self.shape)):
            raise ValueError(f"axes {self.axes} do not match shape "
                             f"{self.shape}")


def tree_map(fn, tree, *rest):
    """``fn`` over every leaf of a nested dict in sorted-key order (JAX's
    flatten order), keeping the structure; with ``rest``, over the matching
    leaves of trees of the same structure, as ``fn(leaf, *others)``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(t[k] for t in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_items(tree, prefix: str = ""):
    """``(dotted key path, leaf)`` pairs in sorted-key order."""
    if not isinstance(tree, dict):
        yield prefix, tree
        return
    for k in sorted(tree):
        yield from tree_items(tree[k], f"{prefix}.{k}" if prefix else k)
