"""Spans around the program's kernel ops, put in from the benchmark's own
files for the traced run.

``OpSpans`` replaces ``repro_torch.kernels.ops.<op>`` (the model layers
look the op up there at each call) with a wrapper that

- opens a profiler range ``dtrbench.<kernel>.fwd`` around the call, so
  every device kernel the call launches (the kernel, and the copies and
  transposes around it) lies inside it;
- puts an identity autograd node before and after the call, whose
  backwards open and close ``dtrbench.<kernel>.bwd``: everything the
  call put on the autograd tape runs its backward inside that range;
- records the call's shape (its least work, ``lib.work``) while
  ``recording`` is on, and counts the calls made outside a backward (a
  forward; the remat policy's recompute runs inside one).

Without the wrapper the program runs as it is: the untraced runs install
nothing.
"""
from __future__ import annotations

from collections import Counter

import torch

PREFIX = "dtrbench."


def in_backward() -> bool:
    """Whether the autograd engine is running a backward on this thread
    (a remat policy's recompute runs there)."""
    return torch._C._current_graph_task_id() != -1


class _Range:
    """A profiler range opened by one autograd node and closed by
    another."""

    def __init__(self, name: str):
        self.name, self.handle = name, None

    def open(self):
        self.handle = torch.ops.profiler._record_function_enter_new(
            self.name, None)

    def close(self):
        if self.handle is not None:
            torch.ops.profiler._record_function_exit._RecordFunction(
                self.handle)
            self.handle = None


class _Before(torch.autograd.Function):
    """Identity on the call's inputs; its backward runs once the call's
    whole backward has: it closes the range."""

    @staticmethod
    def forward(ctx, rng, *xs):
        ctx.rng = rng
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        ctx.rng.close()
        return (None, *grads)


class _After(torch.autograd.Function):
    """Identity on the call's output; its backward runs first of the
    call's: it opens the range and records the backward's work."""

    @staticmethod
    def forward(ctx, rng, note, y):
        ctx.rng, ctx.note = rng, note
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        ctx.note()
        ctx.rng.open()
        return None, None, g


class OpSpans:
    """Wrap the ops named in a configuration's ``kernels``: ``{kernel:
    {"op": name, "shape": how}}``, ``how`` one of ``attention``,
    ``expert_ffn``, ``rwkv_mix``."""

    def __init__(self, kernels: dict):
        self.kernels = kernels
        self.recording = False
        self.calls: list = []            # (kernel, "fwd"|"bwd", shape)
        self.forwards = Counter()        # calls outside a backward
        self._saved: dict = {}

    def install(self):
        from repro_torch.kernels import ops
        for kernel, spec in self.kernels.items():
            orig = getattr(ops, spec["op"])
            self._saved[spec["op"]] = orig
            setattr(ops, spec["op"], self._wrap(kernel, spec["shape"], orig))
        return self

    def uninstall(self):
        from repro_torch.kernels import ops
        for op, orig in self._saved.items():
            setattr(ops, op, orig)
        self._saved.clear()

    def _wrap(self, kernel: str, how: str, orig):
        name = PREFIX + kernel

        def call(*args, **kwargs):
            if not in_backward():
                self.forwards[kernel] += 1
            shape = measure(how, args, kwargs) if self.recording else None
            tensors = [a for a in args if isinstance(a, torch.Tensor)]
            grad = torch.is_grad_enabled() and any(t.requires_grad
                                                   for t in tensors)
            with torch.profiler.record_function(name + ".fwd"):
                if not grad:
                    out = orig(*args, **kwargs)
                else:
                    rng = _Range(name + ".bwd")
                    inner = iter(_Before.apply(rng, *tensors))
                    args = [next(inner) if isinstance(a, torch.Tensor) else a
                            for a in args]
                    out = orig(*args, **kwargs)

                    def note():
                        if self.recording:
                            self.calls.append((kernel, "bwd", shape or
                                               measure(how, args, kwargs)))
                    out = _After.apply(rng, note, out)
            if shape is not None:
                self.calls.append((kernel, "fwd", shape))
            return out
        return call


def _attention(q, k, v, *, window=0, kv_len=None, softcap=0.0):
    b, s, hq, d = q.shape
    return {"b": b, "s": s, "hq": hq, "hkv": k.shape[2], "d": d,
            "window": window, "itemsize": q.element_size()}


def _expert_ffn(buf, w):
    # The rows the call needs: the filled (kept) rows of the dispatch
    # buffer, a count left on the device until the run reads it.
    rows = torch.count_nonzero(buf.detach().abs().amax(dim=-1))
    return {"e": w.shape[0], "rows": rows, "d": w.shape[1], "f": w.shape[2],
            "itemsize": buf.element_size()}


def _rwkv_mix(r, k, v, wlog, u):
    b, s, h, d = r.shape
    return {"bh": b * h, "s": s, "d": d, "itemsize": r.element_size()}


SHAPES = {"attention": _attention, "expert_ffn": _expert_ffn,
          "rwkv_mix": _rwkv_mix}
# The range a call's own measuring runs in: the trace reader gives its
# device time to no kernel.
MEASURE = PREFIX + "measure"


def measure(how: str, args, kwargs) -> dict:
    with torch.profiler.record_function(MEASURE):
        return SHAPES[how](*args, **kwargs)


def resolve(calls: list) -> list:
    """The recorded calls with every count on the device read back, in one
    transfer."""
    pending = [s["rows"] for _, _, s in calls
               if isinstance(s.get("rows"), torch.Tensor)]
    values = iter(torch.stack(pending).tolist()) if pending else iter(())
    out = []
    for kernel, phase, s in calls:
        if isinstance(s.get("rows"), torch.Tensor):
            s = {**s, "rows": next(values)}
        out.append((kernel, phase, s))
    return out
