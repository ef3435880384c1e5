"""The weights, made from ``--seed`` on the device in one draw.

A family's reference lists its leaves (``reference.common.Leaf``: dotted
name, shape, mean, std) in the program's key layout.  One float32 buffer
holds them all: a single ``torch.randn`` call with a generator on the
device fills the drawn part, and each leaf is a view of its slice, scaled
and shifted in place; leaves with std 0 are filled with their mean.  The
program trains these views in place, and the reference draws them again
from the same seed, so both start from the same numbers.
"""
from __future__ import annotations

import math

import torch


def draw(layout, seed: int, device) -> tuple[torch.Tensor, dict]:
    """``(flat, leaves)``: the buffer and ``{name: view}`` in layout order."""
    drawn = [leaf for leaf in layout if leaf.std]
    const = [leaf for leaf in layout if not leaf.std]
    sizes = {leaf.name: math.prod(leaf.shape) for leaf in layout}
    n_drawn = sum(sizes[leaf.name] for leaf in drawn)
    flat = torch.empty(n_drawn + sum(sizes[leaf.name] for leaf in const),
                       dtype=torch.float32, device=device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    torch.randn(n_drawn, generator=gen, dtype=torch.float32, device=device,
                out=flat[:n_drawn])
    leaves, off = {}, 0
    with torch.no_grad():
        for leaf in drawn + const:
            t = flat[off:off + sizes[leaf.name]].view(leaf.shape)
            if leaf.std:
                t.mul_(leaf.std)
                if leaf.mean:
                    t.add_(leaf.mean)
            else:
                t.fill_(leaf.mean)
            leaves[leaf.name] = t
            off += sizes[leaf.name]
    return flat, {leaf.name: leaves[leaf.name] for leaf in layout}


def nest(leaves: dict) -> dict:
    """``{"a.b.c": t}`` as the program's nested tree ``{"a": {"b": {"c":
    t}}}``."""
    tree: dict = {}
    for name, t in leaves.items():
        node = tree
        *parts, last = name.split(".")
        for p in parts:
            node = node.setdefault(p, {})
        node[last] = t
    return tree
