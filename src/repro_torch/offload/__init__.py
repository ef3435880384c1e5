"""Hybrid rematerialize-or-offload memory tier (``repro.offload``).

DTR frees device memory only by dropping recomputable bytes; this package
adds the second lever — moving bytes to a capacity-bounded **host tier**
over modeled H2D/D2H channels — and makes eviction a two-choice
``min(recompute cost, round-trip transfer cost)`` decision, with async
prefetch-back driven by a reuse-distance predictor.

Entry points:

* :class:`OffloadConfig` — knobs (host budget, bandwidths, latency,
  policy, prefetch); ``host_budget=0`` disables the tier bit-exactly.
* :class:`OffloadEngine` — mechanism attached to a ``DTRRuntime``.
* :func:`wrap_heuristic` — lifts a base heuristic into the two-choice
  :class:`HybridHeuristic` (or :class:`TransferHeuristic` for the
  offload-only policy), keeping the eviction index's separable contract.
* :func:`reuse_oracle` — exact reuse gaps from a captured trace, the
  validation reference for the EWMA predictor.

``repro.core.simulator.simulate(..., offload=OffloadConfig(...))`` and
``repro.trace.replay.run_trace(..., offload=...)`` wire it through.
"""
from .engine import (HybridHeuristic, OffloadEngine, TransferHeuristic,
                     wrap_heuristic)
from .host import HostTier
from .predictor import ReusePredictor, reuse_oracle, trace_access_stream
from .transfer import Channel, OffloadConfig, TransferModel

__all__ = [
    "Channel", "HostTier", "HybridHeuristic", "OffloadConfig",
    "OffloadEngine", "ReusePredictor", "TransferHeuristic", "TransferModel",
    "reuse_oracle", "trace_access_stream", "wrap_heuristic",
]
