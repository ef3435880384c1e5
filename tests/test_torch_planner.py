"""The port's trace-time DTR planner (``repro_torch.core.planner``: aten
graph -> DTR log -> plan -> selective-checkpoint policy) and its step
captures (``repro_torch.trace.capture``): every case of
``tests/test_planner.py`` but autotune, with torch; ``dtr_checkpoint``
over a stack whose layers are checkpoint regions, and the tags' copies;
the torch and JAX planners side by side on the same MLP; and the qwen2
train- and serve-step captures through the checker, both replay engines and
the sanitizer, with long attention blocked.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.ad_checkpoint import checkpoint_name  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.core import planner as jplanner  # noqa: E402
from repro.core import simulator as jsimulator  # noqa: E402
from repro_torch.check import check_log  # noqa: E402
from repro_torch.core import planner, simulator  # noqa: E402
from repro_torch.core.graph import Log  # noqa: E402
from repro_torch.core import remat  # noqa: E402
from repro_torch.core.remat import tag  # noqa: E402
from repro_torch.trace import __main__ as cli  # noqa: E402
from repro_torch.trace import capture as C  # noqa: E402
from repro_torch.trace import replay as R  # noqa: E402

D = 64
L = 6


def mlp_fwd(params, x):
    h = x
    for i, p in enumerate(params):
        a = tag(torch.nn.functional.gelu(h @ p["w1"], approximate="tanh"),
                f"act{i}")
        h = h + tag(a @ p["w2"], f"proj{i}")
    return h


def loss_fn(params, x):
    return torch.mean(mlp_fwd(params, x) ** 2)


def jmlp_fwd(params, x):
    h = x
    for i, p in enumerate(params):
        a = checkpoint_name(jax.nn.gelu(h @ p["w1"]), f"act{i}")
        h = h + checkpoint_name(a @ p["w2"], f"proj{i}")
    return h


def jloss_fn(params, x):
    return jnp.mean(jmlp_fwd(params, x) ** 2)


@pytest.fixture(scope="module")
def arrays():
    rng = np.random.default_rng(0)
    params = [{"w1": rng.standard_normal((D, 4 * D), np.float32) * 0.02,
               "w2": rng.standard_normal((4 * D, D), np.float32) * 0.02}
              for _ in range(L)]
    # Large batch => activation-dominated graph (realistic training regime).
    return params, rng.standard_normal((512, D), np.float32)


@pytest.fixture(scope="module")
def setup(arrays):
    params, x = arrays
    return ([{k: torch.from_numpy(v) for k, v in p.items()} for p in params],
            torch.from_numpy(x))


@pytest.fixture(scope="module")
def grad_fn():
    return planner.grad_of_sum(loss_fn)


@pytest.fixture(scope="module")
def traced(setup, grad_fn):
    return planner.trace_to_log(grad_fn, *setup)


def test_trace_to_log_shapes(traced):
    assert traced.log.op_count() > 10
    assert len(traced.named) == 2 * L
    assert traced.total_flops > 0
    check_log(traced.log)


def test_trace_costs_and_aliases(traced):
    """The reference's cost table at aten granularity; views alias their
    input, and a tag is the copy it is under a plan's policy (its bytes
    count, at 0.1 a element)."""
    calls = {i.outputs[0]: i for i in traced.log.instrs
             if type(i).__name__ == "Call"}
    first_mm = next(c for c in calls.values() if c.op == "mm")
    assert first_mm.cost == 2.0 * 512 * D * 4 * D
    aliased = {i.t_out for i in traced.log.instrs
               if type(i).__name__ == "Alias" and i.t_in is not None}
    sizes = {i.t: i.size for i in traced.log.instrs
             if type(i).__name__ == "Memory"}
    for name, t in traced.named.items():
        assert t not in aliased and calls[t].op == "tag", name
        width = 4 * D if name.startswith("act") else D
        assert sizes[t] == 512 * width * 4
        assert calls[t].cost == pytest.approx(0.1 * 512 * width)
    assert any(c.op == "t" and c.outputs[0] in aliased
               for c in calls.values())


def test_plan_budget_monotonicity(setup, grad_fn, traced):
    """Lower budgets must evict more named tensors."""
    big = planner.plan(grad_fn, *setup, budget_bytes=1e12)
    assert big.feasible and not big.remat_names
    peak, _ = simulator.measure_baseline(traced.log)
    mid = planner.plan(grad_fn, *setup, budget_bytes=0.6 * peak)
    low = planner.plan(grad_fn, *setup, budget_bytes=0.45 * peak)
    assert mid.feasible
    assert low.feasible
    assert len(low.save_names) <= len(mid.save_names) <= len(big.save_names)
    assert len(low.remat_names) > 0, "tight budget must force remat"
    assert low.est_slowdown >= 1.0


def test_policy_preserves_gradients(setup, grad_fn, traced):
    """Checkpointing with the DTR policy must not change numerics."""
    params, x = setup
    peak, _ = simulator.measure_baseline(traced.log)
    p = planner.plan(grad_fn, *setup, budget_bytes=0.5 * peak)
    assert p.remat_names
    ck_fwd = remat.checkpointed(mlp_fwd, p.policy())
    g_ref = grad_fn(params, x)
    g_ck = planner.grad_of_sum(
        lambda pp, xx: torch.mean(ck_fwd(pp, xx) ** 2))(params, x)
    for a, b in zip(g_ref, g_ck):
        torch.testing.assert_close(b, a, rtol=0, atol=0)


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.mm += func._opname == "mm"
        return func(*args, **(kwargs or {}))


def test_policy_actually_remats(setup):
    """Saving nothing runs more matrix products than saving everything (the
    recompute shows in the dispatched ``mm`` count)."""

    def mm_calls(policy):
        fwd = remat.checkpointed(mlp_fwd, policy)
        with _CountMM() as counter:
            planner.grad_of_sum(
                lambda pp, xx: torch.mean(fwd(pp, xx) ** 2))(*setup)
        return counter.mm

    with _CountMM() as counter:
        planner.grad_of_sum(loss_fn)(*setup)
    assert counter.mm == 6 * L - 1        # 2 forward, 4 backward (first: 3)
    m_save = mm_calls(remat.everything_saveable)
    m_none = mm_calls(remat.nothing_saveable)
    assert m_save == counter.mm
    assert m_none > m_save * 1.2, (m_save, m_none)


def test_dtr_checkpoint_end_to_end(setup):
    ck, p = planner.dtr_checkpoint(mlp_fwd, *setup, budget_bytes=4e6)
    assert p.feasible and p.remat_names
    out = ck(*setup)
    assert out.shape == setup[1].shape
    assert torch.isfinite(out).all()


def _regions_fwd(params, x):
    """``mlp_fwd`` with each layer a checkpoint region."""
    def layer(i, p, h):
        a = tag(torch.nn.functional.gelu(h @ p["w1"], approximate="tanh"),
                f"act{i}")
        return h + tag(a @ p["w2"], f"proj{i}")

    for i, p in enumerate(params):
        x = remat.region(lambda p_, h, i=i: layer(i, p_, h))(p, x)
    return x


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func._opname] = self.ops.get(func._opname, 0) + 1
        return func(*args, **(kwargs or {}))


def test_dtr_checkpoint_applies_the_plan_per_region(setup):
    """A function that marks its layers as regions runs each under the
    plan's policy: the same gradients, a tag copy per tagged tensor in the
    forward and again for each rematerialized one, and each layer's first
    product again (a region's recompute stops once it holds what the
    backward saved); the unplanned run makes no tag copy at all."""
    params, x = setup
    grads = planner.grad_of_sum(lambda pp, xx: torch.mean(
        _regions_fwd(pp, xx) ** 2))
    traced = planner.trace_to_log(grads, params, x)
    peak, _ = simulator.measure_baseline(traced.log)
    ck, p = planner.dtr_checkpoint(_regions_fwd, params, x,
                                   budget_bytes=0.6 * peak, grad_fn=grads)
    assert p.feasible and p.remat_names and len(traced.named) == 2 * L
    with _CountOps() as plain:
        want = grads(params, x)
    with _CountOps() as planned:
        got = planner.grad_of_sum(lambda pp, xx: torch.mean(
            ck(pp, xx) ** 2))(params, x)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert "tag" not in plain.ops
    assert planned.ops["tag"] == 2 * L + len(p.remat_names)
    assert planned.ops["mm"] == plain.ops["mm"] + L


def test_tag_copies_only_where_a_name_is_read():
    x = torch.ones(3)
    assert remat.tag(x, "a") is x
    with remat.tagging():
        y = remat.tag(x, "a")
    assert y is not x and torch.equal(y, x)
    assert not remat.nothing_saveable.by_name
    assert remat.save_only_these_names("a").by_name


def test_block_size_planner():
    assert planner.sqrt_block_size(16) == 4
    assert planner.plan_layer_blocks(32, 100.0, 400.0) == 8
    assert planner.plan_layer_blocks(32, 100.0, 1e9) == 1
    assert planner.plan_layer_blocks(32, 100.0, 0.0) == 1


# The two planners on the same MLP (the same draws), each at fractions of
# its own graph's unconstrained peak.  They differ (ROADMAP Queue 3): the
# jaxpr spells gelu's tanh form in ~8 primitives, each an activation-sized
# tensor, where aten has one ``gelu`` (and one ``gelu_backward``), so the
# JAX graph's peak is 2.5x the torch graph's and, at 0.6 of it, the JAX
# plan meets the budget by evicting those untagged temporaries alone.
SPLITS = {
    0.6: {"jax": [], "torch": ["act0", "act1", "act2"]},
    0.45: {"jax": ["act0", "act1", "act2", "act3"],
           "torch": ["act0", "act1", "act2", "act3", "act4"]},
}


@pytest.mark.parametrize("frac", sorted(SPLITS))
def test_torch_and_jax_planners_side_by_side(arrays, setup, grad_fn,
                                             traced, frac):
    params, x = arrays
    jparams = jax.tree.map(jnp.asarray, params)
    jgrad = jax.grad(jloss_fn)
    jtraced = jplanner.trace_to_log(jgrad, jparams, jnp.asarray(x))
    jpeak, _ = jsimulator.measure_baseline(jtraced.log)
    peak, _ = simulator.measure_baseline(traced.log)
    assert sorted(jtraced.named) == sorted(traced.named)
    jp = jplanner.plan(jgrad, jparams, jnp.asarray(x),
                       budget_bytes=frac * jpeak)
    p = planner.plan(grad_fn, *setup, budget_bytes=frac * peak)
    print(f"at {frac}: jax peak {jpeak:.0f} remat {jp.remat_names} "
          f"slowdown {jp.est_slowdown:.3f}; torch peak {peak:.0f} remat "
          f"{p.remat_names} slowdown {p.est_slowdown:.3f}")
    assert jp.feasible and p.feasible
    assert jp.remat_names == SPLITS[frac]["jax"]
    assert p.remat_names == SPLITS[frac]["torch"]
    assert all(f"proj{i}" in s for s in (jp.save_names, p.save_names)
               for i in range(L))


# ---------------------------------------------------------------------------
# Step captures
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def train_log():
    return C.capture_train_step("qwen2-0.5b", smoke=True, batch=2, seq=16)


def test_capture_train_step(train_log):
    log = train_log
    assert log.name == "train_step_qwen2-0.5b_b2x16"
    assert log.meta == {"source": "aten", "cost_model": "flops",
                        "ops": log.op_count(), "arch": "qwen2-0.5b",
                        "batch": 2, "seq": 16, "kind": "train_step"}
    check_log(log)
    golden = Log.loads(open("tests/traces/train_smoke.log").read())
    peak, cost = simulator.measure_baseline(log)
    gpeak, gcost = simulator.measure_baseline(golden)
    print(f"torch capture: {log.op_count()} ops, peak {peak:.0f} B, "
          f"baseline cost {cost:.6g}; tests/traces/train_smoke.log (JAX): "
          f"{golden.op_count()} ops, peak {gpeak:.0f} B, baseline cost "
          f"{gcost:.6g}")
    # The same parameters: the pinned bytes agree exactly.
    assert log.pinned_bytes() == pytest.approx(golden.pinned_bytes(),
                                               abs=512)
    assert 0.5 < cost / gcost < 2 and 0.5 < peak / gpeak < 2


def test_capture_train_step_replays(train_log):
    """Scan and index replay agree at 0.9 and 0.8 of the activation range,
    as ``tests/test_trace_golden.py`` replays the JAX capture
    (``tests/traces/train_smoke.log``), and the same cells are feasible in
    both logs: each layer's gradient goes into its stack as the backward
    makes it, as the reference's scan writes its slice, so the backward's
    memory falls as the JAX one's does; the sanitizer sees no violation."""
    fractions = (0.9, 0.8)
    heuristics = ("h_dtr_eq", "h_dtr_local", "h_lru", "h_size")
    rep = R.verify_oracle_equivalence(
        train_log, fractions=fractions, thrash_factor=3.0,
        heuristics=heuristics)
    assert rep["ok"], rep["mismatches"]
    golden = Log.loads(open("tests/traces/train_smoke.log").read())
    jrep = R.verify_oracle_equivalence(
        golden, fractions=fractions, thrash_factor=3.0,
        heuristics=heuristics)
    ok = {k: r.ok for k, r in rep["index_results"].items()}
    assert ok == {k: r.ok for k, r in jrep["index_results"].items()}
    assert any(ok.values()) and not all(ok.values())
    peak, _ = simulator.measure_baseline(train_log)
    pinned = train_log.pinned_bytes()
    res, _ = R.run_trace(train_log, "h_dtr_eq",
                         pinned + 0.9 * (peak - pinned), sanitize=True)
    assert res.ok and res.evictions > 0


def test_capture_serve_step():
    log = C.capture_serve_step("qwen2-0.5b", smoke=True, slots=4)
    assert log.name == "serve_step_qwen2-0.5b_s4"
    assert log.meta["kind"] == "serve_step" and log.meta["slots"] == 4
    check_log(log)
    assert log.op_count() > 100


def test_capture_cost_models():
    unit = C.capture_train_step("qwen2-0.5b", smoke=True, batch=1, seq=8,
                                cost_model="unit")
    assert unit.baseline_cost() == unit.op_count()
    # "hlo": the analytic costs rescaled to FlopCounterMode's total.
    flops = C.capture_train_step("qwen2-0.5b", smoke=True, batch=1, seq=8)
    hlo = C.capture_train_step("qwen2-0.5b", smoke=True, batch=1, seq=8,
                               cost_model="hlo")
    assert hlo.meta["cost_model"] == "hlo"
    assert hlo.meta["flop_counter"] == C.FLOP_COUNTER
    assert hlo.op_count() == flops.op_count()
    assert hlo.baseline_cost() == pytest.approx(hlo.meta["hlo_flops"],
                                                rel=1e-9)
    scale = hlo.meta["hlo_flops"] / flops.baseline_cost()
    for a, b in zip(hlo.instrs, flops.instrs):
        assert getattr(a, "cost", 0.0) == pytest.approx(
            getattr(b, "cost", 0.0) * scale, rel=1e-12)


def test_trace_cli_train_step(tmp_path, capsys):
    out = tmp_path / "t.log"
    assert cli.main(["capture", "--source", "train-step", "--smoke",
                     "--batch", "1", "--seq", "8", "--out", str(out)]) == 0
    assert "captured train_step_qwen2-0.5b_b1x8" in capsys.readouterr().out
    check_log(Log.loads(out.read_text()))


def test_capture_train_step_blocks_long_attention(monkeypatch):
    """From ``BLOCKED_ATTN_THRESHOLD`` rows on, the capture traces the
    blocked plain attention, as the JAX capture traces ``_sdpa_blocked``:
    no ``[Sq,Skv]`` logits in the log, so a lower peak over the same
    parameters."""
    from functools import partial

    from repro_torch.kernels import flash_attention as fa
    whole = C.capture_train_step("qwen2-0.5b", smoke=True, batch=1, seq=64)
    monkeypatch.setattr(fa, "BLOCKED_ATTN_THRESHOLD", 64)
    monkeypatch.setattr(fa, "flash_reference_blocked", partial(
        fa.flash_reference_blocked, q_block=16))
    blocked = C.capture_train_step("qwen2-0.5b", smoke=True, batch=1,
                                   seq=64)
    check_log(blocked)
    peak, cost = simulator.measure_baseline(blocked)
    wpeak, wcost = simulator.measure_baseline(whole)
    print(f"blocked: peak {peak:.0f} B, cost {cost:.6g}; whole: peak "
          f"{wpeak:.0f} B, cost {wcost:.6g}")
    assert peak < wpeak
    assert blocked.pinned_bytes() == whole.pinned_bytes()
