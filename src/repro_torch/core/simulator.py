"""Budget-sweep simulation driver (the experiment harness behind Fig. 2/3).

Replays a log at a list of memory budgets (absolute bytes or fractions of the
unconstrained peak) for each heuristic, recording compute slowdown, eviction /
remat counts, and metadata accesses; detects OOM (budget below feasibility)
and thrashing (slowdown >= threshold).

``alloc_mode`` selects the memory model: ``"counter"`` (default) is the
paper's fungible byte counter; ``"pool"`` maps storages onto a simulated
address space requiring contiguous fits with window eviction
(``repro.alloc``); ``"pool_nofrag"`` keeps counter semantics bit-for-bit but
tracks block placement for fragmentation telemetry.

``alloc_mode="pool+host"`` stacks the hybrid offload tier
(``repro.offload``) on the contiguous pool: pass ``offload=OffloadConfig(...)``
with a positive ``host_budget`` and victims are either evicted (recompute
later) or offloaded to a capacity-bounded host tier over modeled transfer
channels, whichever is cheaper, with async prefetch-back.  ``offload`` also
composes with the other alloc modes; ``pool+host`` merely makes the pairing
explicit and refuses to run without an enabled config.

``index`` toggles the incremental eviction index
(``repro.core.evict_index``); ``index=False`` runs the linear-scan oracle.
Both produce identical eviction decisions (only ``meta_accesses`` may
differ); large sweeps additionally parallelize across processes with
``sweep_parallel``.
"""
from __future__ import annotations

import os
import shutil
import tempfile
from dataclasses import dataclass, field

from .graph import Log, replay
from .heuristics import Heuristic, by_name
from .runtime import DTRRuntime, OOMError, ThrashError

ALLOC_MODES = ("counter", "pool", "pool_nofrag", "pool+host")


@dataclass
class RunResult:
    budget: float
    ok: bool
    slowdown: float = 0.0
    compute: float = 0.0
    base_compute: float = 0.0
    evictions: int = 0
    remat_ops: int = 0
    ops_executed: int = 0
    meta_accesses: int = 0
    peak_memory: float = 0.0
    error: str = ""
    # Fragmentation telemetry (pool-backed runs; zeros in counter mode).
    largest_free: float = 0.0
    frag_ratio: float = 0.0
    failed_fits: int = 0
    evict_windows: int = 0
    # Offload-tier telemetry (repro.offload; zeros without a host tier).
    stall_time: float = 0.0
    offloads: int = 0
    fetches: int = 0
    prefetch_hits: int = 0
    prefetch_cancelled: int = 0
    host_peak: float = 0.0
    # (compute + transfer stalls) / base_compute; slowdown counts compute only.
    overhead: float = 0.0
    # Failure classification (repro.faults): "" for clean runs, else
    # "oom" | "thrash" (infeasible) | "fault" (injected faults fired and
    # the run still died — unlucky, not necessarily infeasible) |
    # "worker" (the sweep worker process died, no runtime to read).
    error_kind: str = ""
    # Graceful-degradation telemetry: ladder actions taken, and the full
    # structured event stream (fault injections + recoveries).
    degradations: int = 0
    events: list = field(default_factory=list)


def make_allocator(alloc_mode: str | None, placement: str = "best_fit"):
    """Build the allocator backend for ``alloc_mode`` (None/'counter' => None)."""
    if alloc_mode in (None, "counter"):
        return None
    from ..alloc import PoolAllocator
    if alloc_mode in ("pool", "pool+host"):
        return PoolAllocator(placement=placement, contiguous=True)
    if alloc_mode == "pool_nofrag":
        return PoolAllocator(placement=placement, contiguous=False)
    raise ValueError(f"unknown alloc_mode {alloc_mode!r}; "
                     f"expected one of {ALLOC_MODES}")


def _frag_fields(rt: DTRRuntime) -> dict:
    frag = rt.fragmentation()
    if frag is None:
        return {}
    return dict(largest_free=frag.largest_free, frag_ratio=frag.frag_ratio,
                failed_fits=frag.failed_fits,
                evict_windows=frag.evict_windows)


def classify_error(rt: DTRRuntime, exc: BaseException) -> str:
    """Structured error kind for a failed run.

    ``"fault"`` when injected faults actually fired before the death —
    the cell may be feasible on a luckier schedule; ``"oom"``/``"thrash"``
    otherwise (genuinely infeasible at this budget)."""
    if rt.faults is not None and rt.faults.injected > 0:
        return "fault"
    return "oom" if isinstance(exc, OOMError) else "thrash"


def result_from_runtime(rt: DTRRuntime, budget: float, ok: bool,
                        error: str = "", error_kind: str = "") -> RunResult:
    """Assemble a RunResult from a finished (or aborted) runtime.

    Single source of truth for the field mapping — ``simulate`` and the
    trace subsystem's ``run_trace`` both build their results here, so the
    two report paths cannot drift.  Failed runs are no longer a cliff:
    they carry their partial progress (ops executed, compute so far, and
    a *finite* slowdown/overhead over the work actually done) plus the
    structured ``error_kind``, so sweeps can distinguish infeasible cells
    from unlucky ones and measure how far a dying run got.
    """
    eng = rt.offload
    return RunResult(
        budget=budget, ok=ok, error=error, error_kind=error_kind,
        slowdown=rt.slowdown(), overhead=rt.overhead(),
        degradations=rt.degradations, events=list(rt.events),
        compute=rt.total_compute, base_compute=rt.base_compute,
        evictions=rt.evictions, remat_ops=rt.remat_ops,
        ops_executed=rt.ops_executed,
        meta_accesses=rt.meta_accesses + (rt.uf.accesses if rt.uf else 0),
        peak_memory=rt.peak_memory,
        stall_time=rt.stall_time, offloads=rt.offloads, fetches=rt.fetches,
        prefetch_hits=rt.prefetch_hits,
        prefetch_cancelled=rt.prefetch_cancelled,
        host_peak=eng.host.peak if eng is not None else 0.0,
        **_frag_fields(rt))


@dataclass
class SweepResult:
    log_name: str
    heuristic: str
    baseline_peak: float
    runs: list[RunResult] = field(default_factory=list)
    alloc_mode: str = "counter"

    def last_ok_before_thrash(self, thresh: float = 2.0) -> float | None:
        """Smallest budget fraction with slowdown < thresh (paper's dashed line)."""
        ok = [r for r in self.runs if r.ok and r.slowdown < thresh]
        return min((r.budget for r in ok), default=None)


def measure_baseline(log: Log) -> tuple[float, float]:
    """(peak_memory, total_cost) of an unconstrained run."""
    rt = DTRRuntime(budget=float("inf"), heuristic=by_name("h_lru"),
                    dealloc="eager")
    replay(log, rt)
    return rt.peak_memory, rt.total_compute


def resolve_budget(fraction: float, peak: float, pinned: float,
                   budget_mode: str = "peak") -> float:
    """Map a budget fraction to absolute bytes.

    ``"peak"``: fraction of the unconstrained peak (the paper's Fig. 2 axis).
    ``"activation"``: ``pinned + fraction * (peak - pinned)`` — scans the
    evictable (activation/KV) range, which is the meaningful knob for
    captured serving traces whose pinned weights dominate peak.
    """
    if budget_mode == "peak":
        return fraction * peak
    if budget_mode == "activation":
        return pinned + fraction * max(peak - pinned, 0.0)
    raise ValueError(f"unknown budget_mode {budget_mode!r}")


def simulate(
    log: Log,
    heuristic: Heuristic | str,
    budget: float,
    dealloc: str = "eager",
    ignore_small_frac: float = 0.0,
    sample_sqrt: bool = False,
    seed: int = 0,
    thrash_factor: float = 50.0,
    alloc_mode: str | None = None,
    placement: str = "best_fit",
    index: bool = True,
    offload=None,
    faults=None,
    recovery=None,
    sanitize=False,
) -> RunResult:
    h = by_name(heuristic, seed) if isinstance(heuristic, str) else heuristic
    engine = None
    if offload is not None and offload.enabled:
        from ..offload import OffloadEngine, wrap_heuristic
        engine = OffloadEngine(offload)
        h = wrap_heuristic(h, engine)
    if alloc_mode == "pool+host" and engine is None:
        raise ValueError("alloc_mode='pool+host' requires an enabled "
                         "OffloadConfig (host_budget > 0)")
    rt = DTRRuntime(budget=budget, heuristic=h, dealloc=dealloc,
                    ignore_small_frac=ignore_small_frac,
                    sample_sqrt=sample_sqrt, seed=seed,
                    compute_limit=thrash_factor * log.baseline_cost(),
                    allocator=make_allocator(alloc_mode, placement),
                    index=index, offload=engine,
                    faults=faults, recovery=recovery, sanitize=sanitize)
    try:
        replay(log, rt)
    except (OOMError, ThrashError) as e:
        return result_from_runtime(rt, budget, ok=False, error=str(e),
                                   error_kind=classify_error(rt, e))
    return result_from_runtime(rt, budget, ok=True)


def sweep(
    log: Log,
    heuristic: str,
    fractions: list[float],
    dealloc: str = "eager",
    seed: int = 0,
    alloc_mode: str | None = None,
    placement: str = "best_fit",
    index: bool = True,
    budget_mode: str = "peak",
    thrash_factor: float = 50.0,
    offload=None,
    faults=None,
    recovery=None,
) -> SweepResult:
    peak, _ = measure_baseline(log)
    pinned = log.pinned_bytes()
    out = SweepResult(log_name=log.name, heuristic=heuristic,
                      baseline_peak=peak, alloc_mode=alloc_mode or "counter")
    for f in fractions:
        # Fresh heuristic per run (h_rand carries RNG state; h_eq carries UF).
        out.runs.append(
            simulate(log, by_name(heuristic, seed),
                     budget=resolve_budget(f, peak, pinned, budget_mode),
                     dealloc=dealloc, seed=seed, alloc_mode=alloc_mode,
                     placement=placement, index=index,
                     thrash_factor=thrash_factor, offload=offload,
                     faults=faults, recovery=recovery))
        out.runs[-1].budget = f  # report as fraction
    return out


# ---------------------------------------------------------------------------
# Process-parallel sweep driver
# ---------------------------------------------------------------------------

#: Per-process parsed-log cache for sweep workers, keyed by the spill
#: file path.  Each worker parses a given log once and reuses it for every
#: grid cell it draws — instead of shipping (and re-parsing) the log's full
#: JSON-lines text inside every task payload.
_LOG_CACHE: dict[tuple[str, str], Log] = {}


def _cached_log(path: str, name: str) -> Log:
    key = (path, name)
    log = _LOG_CACHE.get(key)
    if log is None:
        with open(path, "r", encoding="utf-8") as f:
            log = Log.loads(f.read(), name=name)
        _LOG_CACHE[key] = log
    return log


def _simulate_task(payload: tuple) -> RunResult:
    """Worker: one (log, heuristic, fraction) cell.  Logs are referenced by
    spill-file path (see ``_cached_log``), so payloads stay tiny and pickle
    cheaply and deterministically on every start method."""
    (path, name, heuristic, budget, frac, dealloc, seed, alloc_mode,
     placement, index, thrash_factor, offload, faults, recovery) = payload
    log = _cached_log(path, name)
    r = simulate(log, by_name(heuristic, seed), budget=budget,
                 dealloc=dealloc, seed=seed, alloc_mode=alloc_mode,
                 placement=placement, index=index,
                 thrash_factor=thrash_factor, offload=offload,
                 faults=faults, recovery=recovery)
    r.budget = frac  # report as fraction
    return r


def _failed_cell(payload: tuple, msg: str) -> RunResult:
    """Placeholder result for a cell whose worker died (no runtime state
    to read — only the cell's identity survives)."""
    return RunResult(budget=payload[4], ok=False, error=msg,
                     error_kind="worker")


def _run_pool(payloads: list[tuple], workers: int) -> list:
    """Dispatch cells to a process pool, surviving worker deaths.

    Each cell is its own future, so one poisoned cell cannot take the
    whole grid down.  When a worker dies, every future still in flight
    raises ``BrokenProcessPool`` — innocent casualties included — so each
    such cell is retried once in an isolated single-worker pool; a cell
    that kills *that* pool too is recorded as a failed ``RunResult``
    (``error_kind="worker"``) and the rest of the sweep completes.
    """
    from concurrent.futures import ProcessPoolExecutor
    from concurrent.futures.process import BrokenProcessPool

    results: list = [None] * len(payloads)
    broken: list[int] = []
    with ProcessPoolExecutor(max_workers=workers) as pool:
        futs = [pool.submit(_simulate_task, p) for p in payloads]
        for i, fut in enumerate(futs):
            try:
                results[i] = fut.result()
            except BrokenProcessPool:
                broken.append(i)
    for i in broken:
        try:
            with ProcessPoolExecutor(max_workers=1) as solo:
                results[i] = solo.submit(_simulate_task,
                                         payloads[i]).result()
        except BrokenProcessPool:
            results[i] = _failed_cell(payloads[i], "sweep worker died")
    return results


def sweep_parallel(
    logs: list[Log] | Log,
    heuristics: list[str] | str,
    fractions: list[float],
    dealloc: str = "eager",
    seed: int = 0,
    alloc_mode: str | None = None,
    placement: str = "best_fit",
    index: bool = True,
    processes: int | None = None,
    budget_mode: str = "peak",
    thrash_factor: float = 50.0,
    offload=None,
    faults=None,
    recovery=None,
) -> list[SweepResult]:
    """Sweep the budgets × heuristics × models grid across processes.

    Every grid cell is an independent ``simulate`` call, so the grid is
    embarrassingly parallel; cells are dispatched to a process pool (one
    future per cell) and regrouped into one ``SweepResult`` per (model,
    heuristic) pair, in grid order — results are identical to nested
    serial ``sweep`` calls.  ``processes=0`` (or a single-cell grid)
    forces the serial path; pool bring-up failure (restricted
    environments) falls back to serial, and a worker dying mid-sweep
    fails only its own cell (``error_kind="worker"``) — see ``_run_pool``.
    """
    logs = [logs] if isinstance(logs, Log) else list(logs)
    heuristics = ([heuristics] if isinstance(heuristics, str)
                  else list(heuristics))
    # Keyed positionally, not by log.name: duplicate names must not collide.
    baselines = [measure_baseline(log)[0] for log in logs]
    pinned = [log.pinned_bytes() for log in logs]
    grid = [(i, h) for i in range(len(logs)) for h in heuristics]

    # Spill each log to a temp file once; payloads carry the path, workers
    # parse on first touch and cache per process (``_cached_log``).
    tmpdir = tempfile.mkdtemp(prefix="repro-sweep-")
    try:
        paths = []
        for i, log in enumerate(logs):
            path = os.path.join(tmpdir, f"log{i}.jsonl")
            with open(path, "w", encoding="utf-8") as f:
                f.write(log.dumps())
            paths.append(path)
        payloads = [
            (paths[i], logs[i].name, h,
             resolve_budget(f, baselines[i], pinned[i], budget_mode), f,
             dealloc, seed, alloc_mode, placement, index, thrash_factor,
             offload, faults, recovery)
            for i, h in grid for f in fractions]

        runs: list[RunResult] | None = None
        if processes != 0 and len(payloads) > 1:
            try:
                from concurrent.futures import ProcessPoolExecutor  # noqa: F401
            except ImportError:
                pass
            else:
                try:
                    workers = processes or min(len(payloads),
                                               os.cpu_count() or 1)
                    runs = _run_pool(payloads, workers)
                except (OSError, PermissionError):
                    # Pool bring-up failure (restricted environments):
                    # redo the whole grid serially — cells are
                    # deterministic, so results match an undisturbed
                    # parallel run.  (Worker deaths are handled inside
                    # _run_pool, per cell.)
                    runs = None
        if runs is None:
            runs = [_simulate_task(p) for p in payloads]
    finally:
        for key in [k for k in _LOG_CACHE if k[0].startswith(tmpdir)]:
            del _LOG_CACHE[key]
        shutil.rmtree(tmpdir, ignore_errors=True)

    out: list[SweepResult] = []
    it = iter(runs)
    for i, h in grid:
        sw = SweepResult(log_name=logs[i].name, heuristic=h,
                         baseline_peak=baselines[i],
                         alloc_mode=alloc_mode or "counter")
        for _ in fractions:
            sw.runs.append(next(it))
        out.append(sw)
    return out
