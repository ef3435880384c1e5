"""One run of one cell: set-up, the measured window, the trace, the check.

The window drives the port's own entry point,
``repro_torch.launch.train.train_loop``, as ``python -m
repro_torch.launch.train`` runs it (no checkpoints, quiet), on weights the
benchmark draws from the seed.  The loop's ``on_step`` hook, called at
each step's start, does the rest:

- steps 0..W-1 are set-up: they warm every shape the cell uses, and the
  hook reads the program's state after step 1 (the AdamW first moment,
  which holds the first gradient as the optimizer got it) and after step
  3 (the parameters' change);
- at step W the window opens: the peak-memory counter is reset and each
  step's start is stamped;
- with ``trace``, a few profiler sessions of a few steps each run inside
  the window (``lib.trace``);
- at the first step boundary after ``seconds`` the window closes and the
  hook ends the loop.

Then the program's state is freed and the plain reference follows the
first three steps from the same seed (``reference.common``).
"""
from __future__ import annotations

import gc
import importlib
import math
import time
from dataclasses import dataclass, field
from typing import Any, Optional

import torch

from ..reference import common
from . import check, stats, trace, weights
from .spans import OpSpans, resolve

# The loop's step count: large, so that the hook ends the loop.  It is also
# the cosine schedule's length, which the three steps the reference follows
# (inside the 20-step warm-up) do not reach.
STEPS_CAP = 10 ** 9
READ_FIRST_GRAD, READ_CHANGE = 1, 3
# Set-up steps before the window: at least READ_CHANGE, so that the
# reference's three steps are read before the window opens.
WARMUP_STEPS = READ_CHANGE
TRACE_AT = (0.2, 0.45, 0.7)      # sessions start at these shares of it
TRACE_STEPS = 2                  # steps a profiler session covers
GiB = 2 ** 30


class WindowClosed(Exception):
    """Raised by the step hook to end the loop after the window."""


@dataclass
class Run:
    """What a run measured, as the metric readers see it."""
    cell: dict
    config: dict
    traffic: dict
    family: Any
    stamps: list = field(default_factory=list)        # window step starts
    step_seconds: list = field(default_factory=list)  # the loop's Timer
    clean: list = field(default_factory=list)  # steps no session touched
    counters: dict = field(default_factory=dict)      # launches in window
    forward_calls: dict = field(default_factory=dict)  # traced: per kernel
    spans: Optional[OpSpans] = None
    calls: list = field(default_factory=list)  # the session's kernel calls
    session: Optional[trace.TraceSummary] = None
    setup_s: float = 0.0
    peak_bytes: int = 0
    losses: list = field(default_factory=list)
    actions: list = field(default_factory=list)

    @property
    def tokens_per_step(self) -> int:
        return self.traffic["batch"] * self.traffic["seq"]


def model_config(config: dict, traffic: dict):
    """The program's ``ModelConfig``: its registry entry with every size
    of the configuration's file and the traffic's remat policy."""
    from repro_torch import configs
    from repro_torch.models import model as M
    base = configs.get(config["program_arch"])
    cfg = base.replace(**config["model"], remat=traffic["remat"])
    for k, v in config["model"].items():
        if getattr(cfg, k) != v:
            raise ValueError(f"{config['name']}: {k} runs as "
                             f"{getattr(cfg, k)!r}, the file says {v!r}")
    M.remat_policy(cfg)
    return cfg


def check_layout(cfg, layout) -> None:
    """The reference's leaves are the program's, name for name."""
    from repro_torch.models import model as M
    from repro_torch.models.params import tree_items
    prog = {n: (tuple(i.shape), i.dtype)
            for n, i in tree_items(M.param_defs(cfg))}
    ref = {leaf.name: (tuple(leaf.shape), "float32") for leaf in layout}
    if prog != ref:
        diff = sorted(set(prog.items()) ^ set(ref.items()))
        raise ValueError(f"{cfg.name}: the reference's leaves differ from "
                         f"the program's: {diff[:6]}")


def _counter(path: str):
    mod, attr = path.split(":")
    return getattr(importlib.import_module(mod), attr)


def read_counters(config: dict) -> dict:
    return {path: _counter(path).launches
            for spec in config["kernels"].values()
            for path in (spec["forward_counter"], spec["backward_counter"])}


def _at(tree, name: str):
    for part in name.split("."):
        tree = tree[part]
    return tree


def open_peak(on_card: bool) -> None:
    """Reset the peak-memory counter as the window opens: from here it
    counts what the program holds."""
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()


def run_cell(bench, name: str, seed: int, seconds: float, traced: bool,
             device: str, t0: float) -> dict:
    """Run the cell ``name``; returns the result line as a dict and the
    compared numbers under ``checks``."""
    from repro_torch.launch import train

    cell = bench.cell(name)
    config = bench.config(cell["config"])
    traffic = dict(bench.traffic(cell["traffic"]), lr_total=STEPS_CAP)
    family = bench.family(config)
    model = config["model"]
    cfg = model_config(config, traffic)
    layout = family.layout(model)
    check_layout(cfg, layout)
    on_card = device == "cuda"
    if on_card:
        from repro_torch.kernels import _build
        _build.build(config["kernel_sources"])
    run = Run(cell, config, traffic, family)

    flat, leaves = weights.draw(layout, seed, device)
    params = weights.nest(leaves)
    args = train.parse_args([
        "--steps", str(STEPS_CAP), "--batch", str(traffic["batch"]),
        "--seq", str(traffic["seq"]), "--remat", traffic["remat"],
        "--optimizer", traffic["optimizer"], "--lr", str(traffic["lr"]),
        "--seed", str(seed)])
    res = train.TrainResult()
    prog = common.Readings()
    spans = OpSpans(config["kernels"]).install() if traced else None
    run.spans = spans
    sessions: list = []
    state = {"open": None, "counters": None}

    def on_step(step: int):
        now = time.perf_counter()
        if step == READ_FIRST_GRAD:
            m = {leaf.name: _at(res.opt_state.inner["m"], leaf.name)
                 for leaf in layout}
            prog.first_grad = common.slice_norms(
                layout, m, 1 / (1 - common.ADAMW["b1"]))
            prog.first_grad_sample = common.slice_samples(
                layout, m, 1 / (1 - common.ADAMW["b1"]))
        if step == READ_CHANGE:
            # The start drawn again is the benchmark's, not the program's:
            # it is gone before the window's peak opens.
            flat0, start = weights.draw(layout, seed, device)
            prog.change = common.change_norms(layout, leaves, start)
            del flat0, start
        if step < WARMUP_STEPS:
            return
        if step == WARMUP_STEPS:
            open_peak(on_card)
            state["counters"] = read_counters(config)
            state["forwards"] = dict(spans.forwards) if traced else {}
            run.stamps.append(time.perf_counter())
            run.setup_s = run.stamps[0] - t0
            return
        run.stamps.append(now)
        elapsed = now - run.stamps[0]
        if traced:
            _sessions(run, spans, sessions, state, elapsed, seconds, config)
        if elapsed >= seconds and state["open"] is None:
            if on_card:
                run.peak_bytes = torch.cuda.max_memory_allocated()
            end = read_counters(config)
            run.counters = {k: end[k] - state["counters"][k] for k in end}
            if traced:
                run.forward_calls = {k: n - state["forwards"].get(k, 0)
                                     for k, n in spans.forwards.items()}
            raise WindowClosed

    try:
        train.train_loop(cfg, params, args, ckpt=None, verbose=False,
                         on_step=on_step, result=res)
        raise RuntimeError(f"the loop ended before the window closed "
                           f"({STEPS_CAP} steps)")
    except WindowClosed:
        pass
    finally:
        if spans is not None:
            spans.uninstall()
    n = len(run.stamps) - 1
    first = WARMUP_STEPS - res.start_step
    run.step_seconds = res.step_seconds[first:first + n]
    run.losses = res.losses[first:first + n]
    run.actions = res.actions[first:first + n]
    tainted = set()
    for s in sessions:
        tainted.update(range(s["first"], s["first"] + s["steps"] + 1))
    run.clean = [i not in tainted for i in range(n)]
    prog.losses = res.losses[:3]
    prog.grad_norms = res.grad_norms[:3]
    sound = all(a == "ok" for a in res.actions[:3])

    # Free the program's state before the reference runs.
    res.drop_state()
    del params, leaves, flat, res
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    if traced:
        _read_sessions(run, sessions)

    ref = common.train_readings(family, model, traffic, seed, device)
    gaps = check.compare(prog, ref)
    correct, rows = check.verdict(gaps, cell["limits"])
    if not sound:
        correct = False
        rows["first_steps_ok"] = {"value": 0, "limit": 1,
                                  "where": "the guard skipped a first step"}
    return {"run": run, "correct": correct, "checks": rows,
            "program": prog, "reference": ref}


def _sessions(run, spans, sessions, state, elapsed, seconds, config):
    """Open and close the traced run's profiler sessions at step starts."""
    k = TRACE_STEPS
    i = len(run.stamps) - 1          # the window step that starts now
    if state["open"] is not None:
        s = state["open"]
        if i - s["first"] >= k:
            s["session"].stop()
            spans.recording = False
            end = read_counters(config)
            s["launches"] = sum(end[p] - s["counters"][p] for p in end)
            state["open"] = None
        return
    due = sum(1 for f in TRACE_AT if elapsed >= f * seconds)
    if due > len(sessions) and elapsed < seconds:
        s = {"first": i, "steps": k, "session": trace.Session(),
             "counters": read_counters(config), "calls_from":
             len(spans.calls)}
        sessions.append(s)
        state["open"] = s
        spans.recording = True
        s["session"].start()


def _read_sessions(run, sessions) -> None:
    """Use the first session whose trace holds every kernel the program
    launched in it."""
    calls = resolve(run.spans.calls)
    for n, s in enumerate(sessions):
        summary = trace.summarize(s["session"].events())
        s["session"] = None
        if summary.device_events >= max(s["launches"], 1) \
                and summary.busy_s > 0:
            run.session = summary
            upto = sessions[n + 1]["calls_from"] if n + 1 < len(sessions) \
                else len(calls)
            run.calls = calls[s["calls_from"]:upto]
            return


def end_to_end(run: Run) -> dict:
    """The cell's end-to-end metrics, measured over the whole window."""
    walls = stats.walls(run.stamps)
    return {
        "train_tokens_per_s": {"value": stats.rate(run.tokens_per_step,
                                                   run.stamps),
                               "unit": "tokens/s"},
        "step_ms_p90": {"value": stats.percentile(walls, 90) * 1e3,
                        "unit": "ms"},
        "peak_mem_gib": {"value": run.peak_bytes / GiB, "unit": "GiB"},
        "setup_s": {"value": run.setup_s, "unit": "s"},
    }


def failed_steps(run: Run) -> int:
    return sum(1 for a, loss in zip(run.actions, run.losses)
               if a != "ok" or not math.isfinite(loss))
