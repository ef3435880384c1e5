"""The port's DTR runtime (``repro_torch.core.runtime``) on random DAGs under
the thrash limit ``simulator.simulate`` puts on it.

Without ``compute_limit`` a budget that thrashes replays for minutes (a
draw of the random-DAG property test in ``tests/test_core_runtime.py`` ran
for 1224 s on the CPU); with ``compute_limit = THRASH_FACTOR x baseline``
it aborts with ``ThrashError`` in about a second.  One such draw is pinned, and the
property test's domain and invariants are held under the limit, with
``ThrashError`` a legal outcome beside ``OOMError``.
"""
import pytest

pytest.importorskip("torch")

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # hypothesis is optional: property tests skip, rest run
    from _hypothesis_stub import given, settings, st  # noqa: F401

from repro_torch.core import graphs, simulator  # noqa: E402
from repro_torch.core.graph import Call, Mutate, replay  # noqa: E402
from repro_torch.core.heuristics import by_name  # noqa: E402
from repro_torch.core.runtime import (  # noqa: E402
    DTRRuntime, OOMError, ThrashError)

# Remat compute may reach this multiple of the baseline before a run aborts
# with ThrashError: ``simulator.simulate``'s default ``thrash_factor``.
THRASH_FACTOR = 50.0


def bounded_runtime(log, frac):
    peak, base_cost = simulator.measure_baseline(log)
    rt = DTRRuntime(budget=frac * peak, heuristic=by_name("h_dtr_eq"),
                    compute_limit=THRASH_FACTOR * base_cost)
    return rt, peak, base_cost


def test_thrash_limit_stops_random_dag():
    """A draw that thrashes (seed 8535, 30 ops, 0.622 of peak) aborts at
    most one op past the limit, with peak memory still within budget."""
    log = graphs.random_dag(30, seed=8535)
    rt, peak, _ = bounded_runtime(log, 0.622)
    with pytest.raises(ThrashError):
        replay(log, rt)
    max_op_cost = max(i.cost for i in log.instrs
                      if isinstance(i, (Call, Mutate)))
    assert rt.compute_limit < rt.total_compute
    assert rt.total_compute <= rt.compute_limit + max_op_cost
    assert rt.peak_memory <= 0.622 * peak + 1e-6


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 10_000), n_ops=st.integers(5, 40),
       frac=st.floats(0.4, 1.0))
def test_random_dag_invariants_under_thrash_limit(seed, n_ops, frac):
    """For any DAG/budget: if the run completes, (1) peak memory within
    budget, (2) compute >= baseline, (3) kept tensors resident,
    (4) constants never evicted."""
    log = graphs.random_dag(n_ops, seed=seed)
    rt, peak, base_cost = bounded_runtime(log, frac)
    try:
        replay(log, rt)
    except (OOMError, ThrashError):
        return  # an infeasible or thrashing budget is a legal outcome
    assert rt.peak_memory <= frac * peak + 1e-6
    assert rt.total_compute >= base_cost - 1e-6
    for t in rt.tensors.values():
        if t.refs > 0:
            assert t.defined
    for s in rt.storages.values():
        if s.constant and not s.banished:
            assert s.resident
