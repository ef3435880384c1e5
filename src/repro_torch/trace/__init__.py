"""Trace capture & replay: serve/train workloads as first-class DTR logs.

The counterpart of ``repro.trace``: capture operator streams from the eager
executor, from aten graphs of serve/train steps (``make_fx`` on fake
tensors), or from a continuous-batching serve driver, then replay them
through the port's copy of the engine to verify engine equivalence and size
memory budgets on real dynamic traces.

CLI: ``python -m repro_torch.trace capture|replay``.
"""
from .capture import (ServeStepModel, WorkloadTrace, capture_eager_mlp,
                      capture_eager_treelstm, capture_fn,
                      capture_serve_step, capture_serve_trace,
                      capture_train_step, step_model_from_config)
from .record import TraceRecorder
from .replay import (DEFAULT_FRACTIONS, SEPARABLE, replay_budget_curve,
                     run_trace, smallest_budget, verify_oracle_equivalence)

__all__ = [
    "ServeStepModel", "WorkloadTrace", "TraceRecorder",
    "capture_eager_mlp", "capture_eager_treelstm", "capture_fn",
    "capture_serve_step", "capture_serve_trace", "capture_train_step",
    "step_model_from_config",
    "DEFAULT_FRACTIONS", "SEPARABLE", "replay_budget_curve", "run_trace",
    "smallest_budget", "verify_oracle_equivalence",
]
