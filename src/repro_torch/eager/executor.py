"""Op-interposition layer: DTR over real torch tensors, on the card.

The counterpart of ``repro.eager.executor`` (the repo's stand-in for the
paper's PyTorch prototype, Sec. 5):

  * every operator call is dispatched through :meth:`DTRContext.call`, which
    registers the op + its cost with the DTR runtime, stores a replay
    closure, and returns :class:`DTRArray` handles;
  * under memory pressure the runtime picks victims via ``h_DTR^eq`` (or any
    heuristic) and the context *drops the tensors*: the last reference goes,
    so the CUDA caching allocator gets the bytes back and
    ``torch.cuda.memory_allocated`` follows ``live_bytes()``;
  * accessing an evicted array triggers recursive rematerialization through
    the stored closures.

Like the prototype, the budget may be exceeded by exactly one allocation
(op outputs are computed before the eviction pass — Appendix E.1 notes the
same slack).

What differs from JAX, whose arrays are immutable:

  * every output owns exactly its own bytes: an output that shares storage
    with an input or another output (a view such as ``a[:4]``), or whose
    storage is not exactly its size, is ``.clone()``d — JAX's copy
    semantics, so the byte accounting and the logs equal the JAX package's;
  * an op that mutates an input in place would make rematerialization
    wrong, so each input's ``_version`` is compared around the call and a
    change raises;
  * ``wrap`` keeps the given dtype (JAX turns float64 into float32);
  * a plain tensor passed to ``call`` is an op attribute: its closure keeps
    it alive, outside the budget, as in JAX; a tensor taken from ``.value``
    and kept by the caller likewise stays allocated after an eviction.
"""
from __future__ import annotations

import math
import time
from typing import Callable, Sequence

import torch

from ..core.heuristics import by_name
from ..core.runtime import DTRRuntime, Operator


def resolve_device(device) -> torch.device:
    """The device asked for; a CUDA device where there is no card raises
    (the executor never carries on quietly on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("DTRContext: no CUDA card; pass device='cpu' to "
                           "run on the CPU")
    return dev


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def dtype_name(dtype: torch.dtype) -> str:
    """numpy's name of a dtype (``"float32"``, not ``"torch.float32"``), as
    the JAX package's logs write it."""
    return str(dtype).removeprefix("torch.")


def _owned(out: torch.Tensor, others: list) -> torch.Tensor:
    """``out`` itself if it owns exactly its bytes, else a copy that does."""
    if not isinstance(out, torch.Tensor):
        raise TypeError(f"an op returned {type(out).__name__}, not a tensor")
    st = out.untyped_storage()
    shared = st.nbytes() > 0 and any(
        o.untyped_storage().data_ptr() == st.data_ptr() for o in others)
    return out.clone() if shared or st.nbytes() != nbytes(out) else out


class DTRArray:
    """Handle to a (possibly evicted) tensor managed by a DTRContext."""

    __slots__ = ("ctx", "tid", "shape", "dtype")

    def __init__(self, ctx: "DTRContext", tid: int, shape, dtype):
        self.ctx = ctx
        self.tid = tid
        self.shape = tuple(shape)
        self.dtype = dtype

    @property
    def value(self) -> torch.Tensor:
        """Materialize (rematerializing if evicted) and return the tensor."""
        return self.ctx.fetch(self)

    @property
    def nbytes(self) -> int:
        return math.prod(self.shape) * self.dtype.itemsize

    def release(self) -> None:
        self.ctx.release_tid(self.tid)

    # Convenience arithmetic (sugar over ctx.call).
    def __add__(self, other):
        return self.ctx.call("add", torch.add, [self, other])[0]

    def __mul__(self, other):
        return self.ctx.call("mul", torch.mul, [self, other])[0]

    def __matmul__(self, other):
        return self.ctx.call("matmul", torch.matmul, [self, other])[0]

    def __repr__(self):
        s = self.ctx.rt.storages[self.ctx.rt.tensors[self.tid].sid]
        state = "resident" if s.resident else "evicted"
        return f"DTRArray(shape={self.shape}, dtype={self.dtype}, {state})"


class DTRContext:
    """Owns the runtime, the tensors, and the replay closures."""

    def __init__(self, budget_bytes: float, heuristic: str = "h_dtr_eq",
                 dealloc: str = "eager", use_wallclock_cost: bool = True,
                 seed: int = 0, alloc_mode: str | None = None,
                 placement: str = "best_fit", recorder=None,
                 offload=None, faults=None, recovery=None,
                 device: str | torch.device = "cuda"):
        # alloc_mode, offload, faults and recovery are the JAX package's
        # (repro.eager.DTRContext): the pool maps every resident storage
        # onto a simulated contiguous block; an enabled OffloadConfig moves
        # victims whose modeled round trip undercuts their recompute cost
        # to pinned host tensors and back on access (contents preserved);
        # faults perturb only the simulated pressure and clock.
        from ..core.simulator import make_allocator
        self.device = resolve_device(device)
        h = by_name(heuristic, seed)
        engine = None
        if offload is not None and offload.enabled:
            from ..offload import OffloadEngine, wrap_heuristic
            engine = OffloadEngine(offload)
            h = wrap_heuristic(h, engine)
        self.rt = DTRRuntime(
            budget=float(budget_bytes), heuristic=h,
            dealloc=dealloc,
            materialize_fn=self._on_perform, free_fn=self._on_free,
            allocator=make_allocator(alloc_mode, placement),
            offload=engine, offload_fn=self._on_offload,
            fetch_fn=self._on_fetch,
            faults=faults, recovery=recovery)
        self.buffers: dict[int, torch.Tensor] = {}       # tid -> on device
        self.host_buffers: dict[int, torch.Tensor] = {}  # tid -> host copy
        self.closures: dict[int, Callable] = {}          # op_id -> replay fn
        self.use_wallclock_cost = use_wallclock_cost
        self._pending_outputs: list[torch.Tensor] | None = None
        self.remat_runs = 0
        # Optional TraceRecorder: mirrors every wrap/call/release into a
        # core.graph.Log (first executions only).
        self.recorder = recorder

    # ------------------------------------------------------------------
    # Public API
    # ------------------------------------------------------------------
    def wrap(self, x, constant: bool = True, name: str = "const") -> DTRArray:
        """Lift a tensor or array into DTR management ("checkpoint()")."""
        x = torch.as_tensor(x, device=self.device)
        tid = self.rt.constant(nbytes(x), name=name)
        self.buffers[tid] = x
        if self.recorder is not None:
            self.recorder.on_constant(tid, name, nbytes(x),
                                      shape=tuple(x.shape),
                                      dtype=dtype_name(x.dtype))
        return DTRArray(self, tid, x.shape, x.dtype)

    def fetch(self, a: DTRArray) -> torch.Tensor:
        """"decheckpoint()": rematerialize if needed and return the value."""
        self.rt.get(a.tid)
        return self.buffers[a.tid]

    def call(self, name: str, fn: Callable, args: Sequence,
             n_outputs: int | None = None) -> list[DTRArray]:
        """Dispatch ``fn(*args)`` through DTR.

        ``args`` may mix DTRArrays and plain tensors/scalars; plain values
        are captured in the closure (treated as op attributes, not tensors).
        """
        dtr_args = [a for a in args if isinstance(a, DTRArray)]
        in_tids = [a.tid for a in dtr_args]

        def replay(*concrete):
            it = iter(concrete)
            full = [next(it) if isinstance(a, DTRArray) else a for a in args]
            ins = [x for x in full if isinstance(x, torch.Tensor)]
            versions = [x._version for x in ins]
            out = fn(*full)
            if any(x._version != v for x, v in zip(ins, versions)):
                raise RuntimeError(
                    f"op {name!r} changed an input in place; DTR replays "
                    f"ops, so they must be pure")
            outs: list[torch.Tensor] = []
            for o in out if isinstance(out, tuple) else (out,):
                outs.append(_owned(o, ins + outs))
            return tuple(outs)

        # Execute now with materialized inputs (also measures cost).  The
        # inputs are dropped before the runtime's eviction pass, so a victim
        # chosen there gives its bytes back at once.
        concrete_in = [self.fetch(a) for a in dtr_args]
        t0 = time.perf_counter()
        outs = replay(*concrete_in)
        del concrete_in
        cost = 1.0
        if self.use_wallclock_cost:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            cost = max(time.perf_counter() - t0, 1e-7)

        self._pending_outputs = list(outs)
        oid = self.rt._next_oid
        self.closures[oid] = replay
        out_sizes = [nbytes(o) for o in outs]
        meta = [(o.shape, o.dtype) for o in outs]
        del outs
        tids = self.rt.call(name, cost, in_tids, out_sizes)
        self._pending_outputs = None
        if self.recorder is not None:
            self.recorder.on_call(name, cost, in_tids, tids, out_sizes,
                                  shapes=[tuple(s) for s, _ in meta])
        return [DTRArray(self, tid, s, dt)
                for tid, (s, dt) in zip(tids, meta)]

    def release_tid(self, tid: int) -> None:
        """Drop one external reference (recorded when tracing)."""
        if self.recorder is not None:
            self.recorder.on_release(tid)
        self.rt.release(tid)

    def fragmentation(self):
        """Pool telemetry (``repro_torch.alloc.FragStats``); None in counter
        mode."""
        return self.rt.fragmentation()

    def live_bytes(self) -> int:
        """Bytes held in resident tensors (for budget verification)."""
        total = 0
        for tid, buf in self.buffers.items():
            t = self.rt.tensors[tid]
            if t.defined and not t.is_alias:
                total += nbytes(buf)
        return total

    def host_bytes(self) -> int:
        """Bytes currently parked in host copies."""
        return sum(nbytes(b) for b in self.host_buffers.values())

    # ------------------------------------------------------------------
    # Runtime hooks
    # ------------------------------------------------------------------
    def _on_perform(self, op: Operator, first: bool) -> None:
        if first:
            outs = self._pending_outputs
            assert outs is not None, "first perform without pending outputs"
            self._pending_outputs = None
        else:
            # Rematerialization: replay closure with input tensors (the
            # runtime guarantees inputs are defined here).
            self.remat_runs += 1
            ins = [self.buffers[tid] for tid in op.input_tids]
            outs = list(self.closures[op.op_id](*ins))
        for tid, buf in zip(op.output_tids, outs):
            if self.rt.tensors[tid].defined:
                self.buffers[tid] = buf

    def _on_free(self, storage) -> None:
        # The last reference: the caching allocator reuses the bytes.
        for tid in storage.tensor_tids:
            self.buffers.pop(tid, None)
            self.host_buffers.pop(tid, None)

    def _on_offload(self, storage, defined_tids) -> None:
        """Move the storage's defined tensors to host memory, pinned where
        the context runs on a card; strides are kept, so ops that read them
        back take the same path."""
        for tid in defined_tids:
            buf = self.buffers.pop(tid, None)
            if buf is not None:
                self.host_buffers[tid] = torch.empty_like(
                    buf, device="cpu",
                    pin_memory=self.device.type == "cuda").copy_(buf)
        for tid in storage.tensor_tids:   # undefined views hold no bytes
            self.buffers.pop(tid, None)

    def _on_fetch(self, storage, defined_tids) -> None:
        """Bring host copies back to the device (contents preserved)."""
        for tid in defined_tids:
            host = self.host_buffers.pop(tid, None)
            if host is not None:
                self.buffers[tid] = host.to(self.device)


def op(ctx: DTRContext, name: str, fn: Callable) -> Callable:
    """Decorator-style helper:  f = op(ctx, "gelu", F.gelu)."""
    def wrapped(*args):
        outs = ctx.call(name, fn, list(args))
        return outs[0] if len(outs) == 1 else tuple(outs)
    return wrapped
