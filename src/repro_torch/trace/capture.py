"""Capture serve workloads and eager-executor programs as DTR Logs.

The serve and eager pieces of ``repro.trace.capture``: :class:`WorkloadTrace` +
:func:`capture_serve_trace` — a continuous-batching decode driver at the
slot level: per-request KV caches grow token by token, finished slots retire
their storages and are immediately refilled, so the captured log exercises
the interleaved dynamic lifetimes no synthetic graph produces.  Every
instruction is tagged with request/slot/position metadata.  The step model
takes its sizes from the port's ``param_defs``/``cache_defs``, so the logs
are byte-identical to the JAX package's.  :func:`capture_eager_mlp` and
:func:`capture_eager_treelstm` record programs run through the port's eager
executor; with unit costs their logs depend only on shapes and dtypes, so
they too equal the JAX package's byte for byte.
"""
from __future__ import annotations

import dataclasses
import math
import random
from collections import deque
from dataclasses import dataclass

import numpy as np

from ..core.graph import Log, LogBuilder
from ..models.params import ITEMSIZE, tree_items


@dataclass(frozen=True)
class ServeStepModel:
    """Per-slot size/cost model for one decode step of a given config."""
    weight_bytes: int            # pinned parameter storage
    hidden_bytes: int            # per-slot residual-stream activation
    kv_token_bytes: int          # per-slot KV-cache growth per position
    decode_cost: float           # per-slot per-token step cost (flops)
    attn_token_cost: float       # extra cost per resident KV position
    prefill_token_cost: float    # per prompt token (chunked prefill)


def _tree_bytes(defs) -> int:
    return sum(math.prod(info.shape) * ITEMSIZE[info.dtype]
               for _, info in tree_items(defs))


def step_model_from_config(arch: str = "qwen2-0.5b", *,
                           smoke: bool = True) -> ServeStepModel:
    """Derive the slot-level model from the real architecture config.

    Sizes come from the parameter / KV-cache definition trees the serve loop
    allocates; costs are analytic (2 FLOPs per weight per token — the
    standard decode estimate).  Everything is integer-derived, so the
    resulting traces are bit-reproducible across hosts.
    """
    from .. import configs
    from ..models import model as M
    cfg = configs.get_smoke(arch) if smoke else configs.get(arch)
    probe_slots, probe_len = 2, 16
    weight_bytes = _tree_bytes(M.param_defs(cfg))
    cache_bytes = _tree_bytes(M.cache_defs(cfg, probe_slots, probe_len))
    kv_token_bytes = max(cache_bytes // (probe_slots * probe_len), 1)
    act_bytes = 2 if cfg.param_dtype in ("bfloat16", "float16") else 4
    hidden_bytes = int(cfg.d_model) * act_bytes
    n_params = weight_bytes // max(ITEMSIZE[cfg.param_dtype], 1)
    decode_cost = 2.0 * n_params
    kv_token_elems = kv_token_bytes // act_bytes
    return ServeStepModel(
        weight_bytes=weight_bytes, hidden_bytes=hidden_bytes,
        kv_token_bytes=kv_token_bytes, decode_cost=float(decode_cost),
        attn_token_cost=2.0 * kv_token_elems,
        prefill_token_cost=float(decode_cost))


class WorkloadTrace:
    """Emit a serving workload as a Log, one op stream per (request, slot).

    Used by the pure continuous-batching driver below and by
    ``launch/serve.py --capture`` (which mirrors the steps it actually
    executed).  The KV cache is *paged*: every ``kv_chunk`` positions the
    working cache seals into an immutable chunk storage that later decode
    steps read but never replace.  Chunks of idle slots are individually
    evictable, and rematerializing one replays the decode that sealed it —
    whose own inputs (the hidden state of that step, earlier chunks) may
    themselves be evicted — producing the deep, interleaved rematerialization
    chains that static training DAGs never exhibit.
    """

    def __init__(self, model: ServeStepModel, name: str = "serve_trace",
                 meta=None, kv_chunk: int = 4) -> None:
        self.model = model
        self.kv_chunk = max(int(kv_chunk), 1)
        self.b = LogBuilder(name=name)
        self.b.log.meta = dict(
            {"source": "serve_driver", "kv_chunk": self.kv_chunk,
             "step_model": dataclasses.asdict(model)}, **(meta or {}))
        self.params = self.b.constant(model.weight_bytes, name="params")
        # slot -> {"cur": name|None, "cur_len": int, "h": name,
        #          "chunks": [names], "klen": int}
        self._slot: dict[int, dict] = {}

    def _seal_if_full(self, st: dict) -> None:
        if st["cur"] is not None and st["cur_len"] >= self.kv_chunk:
            st["chunks"].append(st["cur"])
            st["cur"] = None
            st["cur_len"] = 0

    def prefill(self, rid: int, slot: int, plen: int) -> None:
        """Chunked prefill: one op per full page + the partial working page."""
        if plen < 1:
            raise ValueError(f"prefill needs plen >= 1, got {plen}")
        m = self.model
        st = {"cur": None, "cur_len": 0, "h": None, "chunks": [],
              "klen": 0, "rid": rid}
        done = 0
        while done < plen:
            take = min(self.kv_chunk, plen - done)
            outs = self.b.call(
                [self.params] + st["chunks"],
                [m.kv_token_bytes * take, m.hidden_bytes],
                m.prefill_token_cost * take + m.attn_token_cost * done,
                "prefill",
                out_names=[f"kv.r{rid}.{done + take}",
                           f"h.r{rid}.p{done + take}"],
                meta={"rid": rid, "slot": slot, "phase": "prefill",
                      "plen": plen, "pos": done})
            if st["h"] is not None:
                self.b.release(st["h"])
            st["cur"], st["h"] = outs
            st["cur_len"] = take
            st["klen"] = done + take
            done += take
            self._seal_if_full(st)
        self._slot[slot] = st

    def decode(self, rid: int, slot: int, pos: int,
               phase: str = "decode") -> None:
        m = self.model
        st = self._slot[slot]
        ins = [self.params, st["h"]] + st["chunks"]
        if st["cur"] is not None:
            ins.append(st["cur"])
        klen = st["klen"]
        kv2, h2 = self.b.call(
            ins,
            [m.kv_token_bytes * (st["cur_len"] + 1), m.hidden_bytes],
            m.decode_cost + m.attn_token_cost * klen, "decode",
            out_names=[f"kv.r{rid}.{klen + 1}", f"h.r{rid}.{klen + 1}"],
            meta={"rid": rid, "slot": slot, "pos": pos, "phase": phase})
        if st["cur"] is not None:
            self.b.release(st["cur"])
        self.b.release(st["h"])
        st["cur"], st["h"] = kv2, h2
        st["cur_len"] += 1
        st["klen"] = klen + 1
        self._seal_if_full(st)

    def retire(self, rid: int, slot: int) -> None:
        st = self._slot.pop(slot)
        first = True
        for c in st["chunks"]:
            self.b.release(c, meta={"rid": rid, "slot": slot,
                                    "phase": "retire"} if first else None)
            first = False
        if st["cur"] is not None:
            self.b.release(st["cur"])
        if st["h"] is not None:
            self.b.release(st["h"])

    def finish(self) -> Log:
        return self.b.log


def capture_serve_trace(model: ServeStepModel, *, slots: int = 4,
                        requests: int = 12, gen: int = 16,
                        prompt_min: int = 4, prompt_max: int = 12,
                        seed: int = 0, kv_chunk: int = 4,
                        name: str | None = None) -> Log:
    """Run the slot-level continuous-batching loop and capture it.

    True continuous batching (unlike the wave-based ``launch/serve.py``
    loop): a finished slot is refilled on the next global step while its
    neighbors keep decoding, so KV lifetimes start and end at arbitrary
    interleaved positions.
    """
    rng = random.Random(seed)
    queue = deque((rid, rng.randint(prompt_min, prompt_max))
                  for rid in range(requests))
    wt = WorkloadTrace(
        model, name=name or f"serve_s{slots}_r{requests}_g{gen}",
        kv_chunk=kv_chunk,
        meta={"slots": slots, "requests": requests, "gen": gen,
              "prompt_min": prompt_min, "prompt_max": prompt_max,
              "seed": seed})
    active: dict[int, dict] = {}
    step = 0
    while queue or active:
        for s in range(slots):
            if s not in active and queue:
                rid, plen = queue.popleft()
                wt.prefill(rid, s, plen)
                active[s] = {"rid": rid, "generated": 0}
        for s in sorted(active):
            st = active[s]
            wt.decode(st["rid"], s, step)
            st["generated"] += 1
            if st["generated"] >= gen:
                wt.retire(st["rid"], s)
                del active[s]
        step += 1
    log = wt.finish()
    log.meta["steps"] = step
    return log


# ---------------------------------------------------------------------------
# Eager-executor captures (TraceRecorder through real torch tensors)
# ---------------------------------------------------------------------------

def eager_mlp(ctx, *, steps: int, din: int, dh: int, batch: int,
              seed: int = 0, lr: float = 0.05, rec=None, on_loss=None):
    """The manual-backward MLP training loop of :func:`capture_eager_mlp`,
    through ``ctx`` (a ``DTRContext``, or anything with its ``wrap`` /
    ``call`` and handles with ``release``).  ``on_loss(step, loss)`` sees
    each step's loss handle before it is released.  Returns the final
    ``(w1, w2)`` handles.

    Inputs are f32 draws from ``numpy.random.default_rng(seed)``.  Every op
    writes only its output, with no temporary the size of an activation
    (relu's backward is one ``threshold_backward``, the SGD step one
    ``add`` with ``alpha``), so the card holds no more than the live
    tensors and the output being made.
    """
    import torch

    def tag(**meta):
        if rec is not None:
            rec.tag(**meta)

    rng = np.random.default_rng(seed)
    scale = np.float32(0.05)
    w1 = ctx.wrap(rng.standard_normal((din, dh), np.float32) * scale,
                  name="w1")
    w2 = ctx.wrap(rng.standard_normal((dh, 1), np.float32) * scale,
                  name="w2")
    xb = ctx.wrap(rng.standard_normal((batch, din), np.float32), name="x")
    yb = ctx.wrap(np.ones((batch, 1), np.float32), name="y")
    for step in range(steps):
        tag(step=step, phase="fwd")
        h = ctx.call("fc1", torch.matmul, [xb, w1])[0]
        a = ctx.call("relu", torch.relu, [h])[0]
        p = ctx.call("fc2", torch.matmul, [a, w2])[0]
        e = ctx.call("err", torch.sub, [p, yb])[0]
        loss = ctx.call("mse", lambda t: torch.mean(t * t), [e])[0]
        tag(step=step, phase="bwd")
        gp = ctx.call("d_mse", lambda t: 2 * t / t.numel(), [e])[0]
        gw2 = ctx.call("d_w2", lambda a_, g: a_.T @ g, [a, gp])[0]
        ga = ctx.call("d_a", lambda g, w: g @ w.T, [gp, w2])[0]
        gh = ctx.call("d_relu", lambda g, h_:
                      torch.ops.aten.threshold_backward(g, h_, 0.0),
                      [ga, h])[0]
        gw1 = ctx.call("d_w1", lambda x_, g: x_.T @ g, [xb, gh])[0]
        w1_new = ctx.call("sgd1", lambda w, g: torch.add(w, g, alpha=-lr),
                          [w1, gw1])[0]
        w2_new = ctx.call("sgd2", lambda w, g: torch.add(w, g, alpha=-lr),
                          [w2, gw2])[0]
        if on_loss is not None:
            on_loss(step, loss)
        for t in (h, a, p, e, loss, gp, gw2, ga, gh, gw1):
            t.release()
        w1.release()          # superseded weights (step-0: pinned constants)
        w2.release()
        w1, w2 = w1_new, w2_new
    return w1, w2


def capture_eager_mlp(*, steps: int = 2, din: int = 32, dh: int = 64,
                      batch: int = 16, seed: int = 0,
                      device="cuda") -> Log:
    """Manual-backward MLP training loop through the eager DTR executor.

    Unit costs (``use_wallclock_cost=False``) keep the captured log — and
    every replay decision downstream — bit-reproducible across hosts.
    """
    from ..eager import DTRContext
    from .record import TraceRecorder
    rec = TraceRecorder(name=f"eager_mlp_s{steps}",
                        meta={"kind": "eager_mlp", "steps": steps,
                              "din": din, "dh": dh, "batch": batch})
    ctx = DTRContext(budget_bytes=float("inf"), use_wallclock_cost=False,
                     recorder=rec, device=device)
    eager_mlp(ctx, steps=steps, din=din, dh=dh, batch=batch, seed=seed,
              rec=rec)
    return rec.finish()


def capture_eager_treelstm(*, depth: int = 3, dim: int = 32,
                           device="cuda") -> Log:
    """Data-dependent recursion (the paper's dynamic headline) captured live."""
    import torch
    from ..eager import DTRContext
    from .record import TraceRecorder
    rec = TraceRecorder(name=f"eager_treelstm_d{depth}",
                        meta={"kind": "eager_treelstm", "depth": depth,
                              "dim": dim})
    ctx = DTRContext(budget_bytes=float("inf"), use_wallclock_cost=False,
                     recorder=rec, device=device)
    w = ctx.wrap(np.eye(dim, dtype=np.float32) * np.float32(0.5)
                 + np.float32(0.01), name="w")

    def cell(a, b, d):
        rec.tag(depth=d)
        s = ctx.call("add", torch.add, [a, b])[0]
        rec.tag(depth=d)
        out = ctx.call("cell", lambda s_, w_: torch.tanh(s_ @ w_), [s, w])[0]
        s.release()
        a.release()
        b.release()
        return out

    def build(d, leaf_val):
        if d == 0:
            return ctx.wrap(np.full((dim,), leaf_val, np.float32),
                            name="leaf")
        return cell(build(d - 1, leaf_val), build(d - 1, leaf_val + 0.1), d)

    build(depth, 0.05)
    return rec.finish()
