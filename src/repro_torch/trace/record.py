"""TraceRecorder: mirror an eager DTR execution into a ``core.graph.Log``.

Attach a recorder to a :class:`repro.eager.DTRContext` and every ``wrap`` /
``call`` / ``release`` is re-emitted as ``Constant`` / ``Call`` / ``Release``
instructions with the *real* output sizes and the costs the runtime charged.
Rematerializations are deliberately not recorded — the log is the operator
stream the framework issued, exactly what the paper's instrumented PyTorch
prototype logs (Appendix C.6); replaying it reproduces the runtime's
decisions from scratch.

Use ``use_wallclock_cost=False`` on the context when capturing golden traces:
unit costs make the captured log (and therefore every replay decision)
bit-reproducible across hosts.
"""
from __future__ import annotations

from ..core.graph import Log, LogBuilder, as_meta


class TraceRecorder:
    """Builds a Log from eager-executor events (wrap/call/release)."""

    def __init__(self, name: str = "eager", meta=None) -> None:
        self.builder = LogBuilder(name=name)
        self.builder.log.meta = dict({"source": "eager"}, **(meta or {}))
        self._names: dict[int, str] = {}        # runtime tid -> log tensor
        self._released: set[int] = set()
        self._op_meta: dict | None = None       # one-shot tag for next event

    # ------------------------------------------------------------------
    # Tagging
    # ------------------------------------------------------------------
    def tag(self, **meta) -> "TraceRecorder":
        """Attach metadata to the next recorded instruction (one-shot)."""
        self._op_meta = meta
        return self

    def _take_meta(self, extra: dict | None = None):
        m = dict(self._op_meta or {})
        if extra:
            m.update(extra)
        self._op_meta = None
        return as_meta(m)

    # ------------------------------------------------------------------
    # Event hooks (called by DTRContext)
    # ------------------------------------------------------------------
    def on_constant(self, tid: int, name: str, nbytes: int,
                    shape=None, dtype=None) -> None:
        extra = {}
        if shape is not None:
            extra["shape"] = "x".join(map(str, shape)) or "scalar"
        if dtype is not None:
            extra["dtype"] = str(dtype)
        t = f"{name}.{tid}"
        self.builder.constant(nbytes, name=t, meta=self._take_meta(extra))
        self._names[tid] = t

    def on_call(self, op: str, cost: float, in_tids, out_tids,
                out_sizes, shapes=None) -> None:
        extra = {}
        if shapes is not None:
            extra["shapes"] = ";".join(
                "x".join(map(str, s)) or "scalar" for s in shapes)
        ins = [self._names[t] for t in in_tids]
        outs = [f"{op}.{t}" for t in out_tids]
        self.builder.call(ins, [int(s) for s in out_sizes], float(cost), op,
                          out_names=outs, meta=self._take_meta(extra))
        for t, nm in zip(out_tids, outs):
            self._names[t] = nm

    def on_release(self, tid: int) -> None:
        if tid in self._released:
            return
        self._released.add(tid)
        self.builder.release(self._names[tid], meta=self._take_meta())

    # ------------------------------------------------------------------
    # Finalization
    # ------------------------------------------------------------------
    def finish(self, release_rest: bool = False, keep=()) -> Log:
        """Return the captured Log.

        ``release_rest=True`` appends RELEASE for every tensor the program
        never dropped (except log names in ``keep``), modelling the end of
        the Python scope; by default unreleased tensors stay externally
        referenced, so replay's output condition pins them — matching the
        live eager context.
        """
        if release_rest:
            keep = set(keep)
            for tid, nm in self._names.items():
                if tid not in self._released and nm not in keep:
                    self._released.add(tid)
                    self.builder.release(nm)
        return self.builder.log
