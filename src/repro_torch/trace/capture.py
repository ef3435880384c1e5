"""Capture a continuous-batching serve workload as a DTR Log.

The serve pieces of ``repro.trace.capture``: :class:`WorkloadTrace` +
:func:`capture_serve_trace` — a continuous-batching decode driver at the
slot level: per-request KV caches grow token by token, finished slots retire
their storages and are immediately refilled, so the captured log exercises
the interleaved dynamic lifetimes no synthetic graph produces.  Every
instruction is tagged with request/slot/position metadata.  The step model
takes its sizes from the port's ``param_defs``/``cache_defs``, so the logs
are byte-identical to the JAX package's.
"""
from __future__ import annotations

import dataclasses
import math
import random
from collections import deque
from dataclasses import dataclass

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
