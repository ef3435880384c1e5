"""Eager DTR executor over torch tensors — the PyTorch-prototype analogue.

The counterpart of ``repro.eager``: ``DTRArray`` wraps a tensor on the card
(or on the CPU, where the caller asks for it); every op goes through a
:class:`DTRContext`, which tracks metadata (size, cost, staleness), enforces
a byte budget by dropping the tensors of evicted arrays, and rematerializes
on access by replaying parent-op closures.
"""
from .executor import DTRArray, DTRContext, op

__all__ = ["DTRArray", "DTRContext", "op"]
