"""Replay captured traces through the DTR engine: verification + budget curves.

``run_trace`` replays one log at one budget and returns the ``RunResult``
*plus* the full victim sequence (storage ids in eviction order) — the
decision stream the golden-trace tests pin down.

``verify_oracle_equivalence`` replays a trace through the incremental
eviction index and the exhaustive linear-scan oracle for every separable
heuristic, asserting bit-identical decisions (victims, tie-breaks, compute,
peak) — the acceptance gate for captured serving traces.

``replay_budget_curve`` sweeps budget fractions × heuristics through
``simulator.sweep_parallel`` (the PR-2 parallel driver) and shapes the
result for ``BENCH_serving.json``.
"""
from __future__ import annotations

from dataclasses import asdict

from ..check.trace_lint import check_log
from ..core.graph import Log, replay
from ..core.heuristics import ALL_NAMES, by_name
from ..core.runtime import DTRRuntime, OOMError, ThrashError
from ..core.simulator import (RunResult, classify_error, measure_baseline,
                              resolve_budget, result_from_runtime, simulate,
                              sweep_parallel)

#: Heuristics with a key()/staleness decomposition: the eviction index and
#: the linear scan must agree bit-exactly on these (h_rand consumes RNG
#: state per score evaluation, so it is scan-only by design).
SEPARABLE = tuple(h for h in ALL_NAMES + ["h_estar"] if h != "h_rand")

DEFAULT_FRACTIONS = (0.9, 0.7, 0.5, 0.4, 0.3)


def run_trace(log: Log, heuristic: str, budget: float, *,
              dealloc: str = "eager", index: bool = True, seed: int = 0,
              thrash_factor: float = 50.0, offload=None, faults=None,
              recovery=None, lint: bool = True, sanitize=False):
    """Replay ``log`` once; returns (RunResult, victim sid sequence).

    ``offload`` (an enabled ``repro.offload.OffloadConfig``) attaches the
    hybrid host tier; the victim sequence then records *evictions* only
    (offloads preserve contents, so they are not decisions the golden
    digests pin).  ``host_budget=0`` configs are ignored — bit-exact with
    the plain replay.  ``faults`` / ``recovery`` (``repro.faults``)
    attach a replayable chaos schedule and the degradation ladder; the
    golden fault-replay tests pin the victim sequence *and* the structured
    event stream of pinned schedules.

    ``lint`` statically verifies the log before replay (memoized per log
    object, so sweeps pay it once); ``sanitize`` attaches the
    ``repro.check`` shadow sanitizer to the runtime.  Both raise through:
    a ``TraceLintError`` / ``SanitizerViolation`` is a defect, not a
    replay outcome.
    """
    if lint:
        check_log(log, dealloc=dealloc)
    h = by_name(heuristic, seed)
    engine = None
    if offload is not None and offload.enabled:
        from ..offload import OffloadEngine, wrap_heuristic
        engine = OffloadEngine(offload)
        h = wrap_heuristic(h, engine)
    rt = DTRRuntime(budget=budget, heuristic=h,
                    dealloc=dealloc, seed=seed,
                    compute_limit=thrash_factor * log.baseline_cost(),
                    index=index, offload=engine,
                    faults=faults, recovery=recovery, sanitize=sanitize)
    victims: list[int] = []
    inner = rt._evict

    def traced_evict(s):
        victims.append(s.sid)
        inner(s)

    rt._evict = traced_evict
    ok, err, kind = True, "", ""
    try:
        replay(log, rt)
    except (OOMError, ThrashError) as e:
        ok, err, kind = False, str(e), classify_error(rt, e)
    return result_from_runtime(rt, budget, ok=ok, error=err,
                               error_kind=kind), victims


#: RunResult fields that must be identical between the index and the scan
#: oracle (meta_accesses legitimately differs: that is the point of the
#: index).
PARITY_FIELDS = ("ok", "evictions", "remat_ops", "ops_executed",
                 "compute", "base_compute", "peak_memory", "slowdown",
                 "stall_time", "offloads", "fetches", "prefetch_hits",
                 "overhead", "degradations")


def verify_oracle_equivalence(log: Log, *, heuristics=SEPARABLE,
                              fractions=DEFAULT_FRACTIONS,
                              dealloc: str = "eager",
                              budget_mode: str = "activation",
                              thrash_factor: float = 50.0,
                              offload=None) -> dict:
    """Index-vs-scan bit-exactness over a fraction × heuristic grid.

    Budgets default to the activation range (``pinned + f * (peak -
    pinned)``): captured serving traces pin their weights, so total-peak
    fractions below the weight floor would make every cell trivially OOM.
    Returns ``{"ok": bool, "cells": n, "mismatches": [...]}`` where each
    mismatch names the cell and the first diverging field or victim.
    """
    peak, _ = measure_baseline(log)
    pinned = log.pinned_bytes()
    mismatches = []
    index_results: dict[tuple[str, float], RunResult] = {}
    cells = 0
    for h in heuristics:
        for f in fractions:
            cells += 1
            budget = resolve_budget(f, peak, pinned, budget_mode)
            scan_res, scan_victims = run_trace(
                log, h, budget, dealloc=dealloc, index=False,
                thrash_factor=thrash_factor, offload=offload)
            idx_res, idx_victims = run_trace(
                log, h, budget, dealloc=dealloc, index=True,
                thrash_factor=thrash_factor, offload=offload)
            idx_res.budget = f  # report as fraction (sweep convention)
            index_results[(h, f)] = idx_res
            bad = [fld for fld in PARITY_FIELDS
                   if getattr(scan_res, fld) != getattr(idx_res, fld)]
            if scan_victims != idx_victims:
                div = next((i for i, (a, b) in
                            enumerate(zip(scan_victims, idx_victims))
                            if a != b), min(len(scan_victims),
                                            len(idx_victims)))
                bad.append(f"victims@{div}")
            if bad:
                mismatches.append({"heuristic": h, "fraction": f,
                                   "fields": bad})
    return {"ok": not mismatches, "cells": cells, "mismatches": mismatches,
            "trace": log.name, "baseline_peak": peak,
            "index_results": index_results}


def _finite(x):
    """JSON-safe scalar: non-finite floats become None (strict JSON has no
    Infinity/NaN literals, and downstream plotters choke on the informal
    extensions ``json.dump`` emits by default)."""
    if isinstance(x, float) and (x != x or x in (float("inf"),
                                                 float("-inf"))):
        return None
    return x


def run_to_dict(r: RunResult) -> dict:
    """``asdict`` with non-finite floats nulled (``ok`` already encodes
    failure; an infinite slowdown/overhead carries no extra information)."""
    return {k: _finite(v) for k, v in asdict(r).items()}


def _reject_nonfinite(value: str):
    raise ValueError(
        f"non-finite literal {value!r} in report JSON; regenerate it with "
        f"repro.trace (non-finite fields are serialized as null)")


def load_report(path) -> dict | list:
    """Load a benchmark/report JSON, rejecting Infinity/NaN literals.

    The CI report-validation step loads every committed BENCH_*.json
    through this, so the informal extensions Python's encoder used to leak
    (``Infinity``) can never land in the repo again."""
    import json
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f, parse_constant=_reject_nonfinite)


def replay_budget_curve(logs, *, heuristics=("h_dtr", "h_dtr_eq", "h_lru"),
                        fractions=DEFAULT_FRACTIONS, dealloc: str = "eager",
                        index: bool = True, processes: int | None = None,
                        alloc_mode: str | None = None,
                        budget_mode: str = "activation",
                        thrash_factor: float = 50.0,
                        offload=None) -> list[dict]:
    """Budget curves for captured traces via the parallel sweep driver.

    One entry per (trace, heuristic): budget fraction -> slowdown / remat /
    peak, plus the smallest non-thrashing budget (the number serving uses to
    size per-replica memory).
    """
    logs = [logs] if isinstance(logs, Log) else list(logs)
    sweeps = sweep_parallel(logs, list(heuristics), list(fractions),
                            dealloc=dealloc, index=index,
                            alloc_mode=alloc_mode, processes=processes,
                            budget_mode=budget_mode,
                            thrash_factor=thrash_factor, offload=offload)
    out = []
    for sw in sweeps:
        out.append({
            "trace": sw.log_name,
            "heuristic": sw.heuristic,
            "baseline_peak": sw.baseline_peak,
            "min_feasible_fraction": min(
                (r.budget for r in sw.runs if r.ok), default=None),
            "last_ok_before_thrash": sw.last_ok_before_thrash(),
            "runs": [run_to_dict(r) for r in sw.runs],
        })
    return out


def static_gap_curve(log: Log, *, fractions=(0.9, 0.7, 0.5),
                     heuristics=("h_dtr", "h_dtr_eq"),
                     thrash_factor: float = 10.0,
                     budget_mode: str = "activation",
                     max_candidates: int = 512,
                     execute: bool = False) -> dict:
    """DTR-vs-static-optimal overhead cells for one captured trace.

    The Checkmate-bridge comparison both ``benchmarks.perf_static`` and
    the golden gap gate consume: per budget fraction, the LP recompute
    floor, the model-level solver ladder (heterogeneous DP vs the two
    Chen baselines on the extracted chain), the best *eval-feasible*
    static plan from the ``repro.static`` panel (judged by the exact
    evaluator, so feasibility means the replayed peak truly fits), and
    the online DTR rows at the same budgets with their gap ratios.

    ``execute=True`` additionally replays each winning plan through the
    real runtime and records the evaluator-vs-executor parity booleans
    (plans recur across cells, so executions are cached by keep-set).
    """
    from ..static import (best_static_plan, build_frontier, build_view,
                          chen_greedy, chen_sqrt, compile_plan,
                          execute_plan, extract_chain, lp_lower_bound,
                          optimal_dp)
    peak, base_cost = measure_baseline(log)
    pinned = log.pinned_bytes()
    view = build_view(log)
    chain = extract_chain(view, max_candidates=max_candidates)
    frontier = build_frontier(view, chain)
    exec_cache: dict[frozenset, dict] = {}
    cells = []
    for f in sorted(fractions, reverse=True):
        budget = resolve_budget(f, peak, pinned, budget_mode)
        lp = lp_lower_bound(view, budget)
        dp = optimal_dp(chain, budget)
        cs, cg = chen_sqrt(chain, budget), chen_greedy(chain, budget)
        best = best_static_plan(view, chain, frontier, budget)
        cell = {
            "fraction": f, "budget": budget,
            "lp": {"value": _finite(lp.value), "exact": lp.exact,
                   "solver": lp.solver, "infeasible": lp.infeasible},
            "model": {
                "dp_cost": dp.cost if dp else None,
                "dp_peak": dp.peak if dp else None,
                "dp_via": dp.meta.get("via", "dp") if dp else None,
                "chen_sqrt_cost": cs.cost, "chen_sqrt_peak": cs.peak,
                "chen_greedy_cost": cg.cost, "chen_greedy_peak": cg.peak,
                "dp_le_chen": (dp.cost <= min(cs.cost, cg.cost) + 1e-9
                               if dp else None),
                "lp_le_dp": (lp.value <= dp.cost + 1e-9
                             if dp and lp.value != float("inf") else None),
            },
            "static": None, "dtr": {},
        }
        if best is not None:
            extra = best.compute - best.ev.base_compute
            st = {"source": best.source,
                  "n_drop": len(chain) - len(best.keep),
                  "peak": best.peak, "compute": best.compute,
                  "overhead": round(best.overhead, 6),
                  "remat_ops": best.ev.remat_ops,
                  "evictions": best.ev.evictions,
                  "lp_le_extra": (lp.value <= extra + 1e-9
                                  if lp.value != float("inf") else False)}
            if execute:
                if best.keep not in exec_cache:
                    rr = execute_plan(log, compile_plan(view, chain,
                                                        best.keep))
                    exec_cache[best.keep] = {
                        "remat_match": rr.remat_ops == best.ev.remat_ops,
                        "evict_match": rr.evictions == best.ev.evictions,
                        "compute_match":
                            abs(rr.compute - best.compute) < 1e-9,
                        "peak_match": rr.peak_memory == best.peak}
                st["exec"] = exec_cache[best.keep]
            cell["static"] = st
        for h in heuristics:
            r = simulate(log, h, budget, thrash_factor=thrash_factor)
            row = {"ok": r.ok, "overhead": _finite(round(r.overhead, 6)),
                   "compute": _finite(r.compute), "peak": r.peak_memory,
                   "remat_ops": r.remat_ops,
                   "gap_vs_static": None, "extra_ge_lp": None}
            if r.ok:
                row["extra_ge_lp"] = (r.compute - r.base_compute
                                      >= lp.value - 1e-9)
                if best is not None:
                    row["gap_vs_static"] = round(r.compute / best.compute,
                                                 6)
            cell["dtr"][h] = row
        cells.append(cell)
    return {"trace": log.name, "baseline_peak": peak,
            "baseline_cost": base_cost, "pinned": pinned,
            "n_ops": view.n_ops, "n_candidates": len(chain),
            "frontier_points": len(frontier.points),
            "frontier_min_peak": frontier.min_peak(), "cells": cells}


def smallest_budget(log: Log, heuristic: str = "h_dtr_eq",
                    fractions=DEFAULT_FRACTIONS,
                    budget_mode: str = "activation") -> float | None:
    """Smallest feasible budget fraction (serving memory sizing helper)."""
    peak, _ = measure_baseline(log)
    pinned = log.pinned_bytes()
    feasible = None
    for f in sorted(fractions, reverse=True):
        r = simulate(log, heuristic,
                     resolve_budget(f, peak, pinned, budget_mode))
        if r.ok:
            feasible = f
    return feasible
