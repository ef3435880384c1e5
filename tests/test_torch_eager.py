"""The port's eager DTR executor and its copy of the engine against the JAX
package's (``repro.eager``), on the CPU.

Every scenario runs through both executors on the same numpy inputs with
unit costs (``use_wallclock_cost=False``), so the eviction decisions are
deterministic: values must agree to 1e-6 (f32 ops of the two libraries,
the same math), and ``rt.evictions``, ``remat_runs`` and the victim
sequence must be identical.  The card's own cases (``live_bytes`` against
``torch.cuda.memory_allocated``) are in ``tests/test_torch_cuda.py``.
"""
import hashlib
import json
from dataclasses import asdict
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro.eager import DTRContext as JContext  # noqa: E402
from repro.eager import op as jop  # noqa: E402
from repro.faults import FaultConfig as JFaultConfig  # noqa: E402
from repro.faults import RecoveryConfig as JRecoveryConfig  # noqa: E402
from repro.offload import OffloadConfig as JOffloadConfig  # noqa: E402
from repro.trace import TraceRecorder as JRecorder  # noqa: E402
from repro.trace.capture import (  # noqa: E402
    capture_eager_treelstm as jcapture_treelstm)
from repro_torch.core.graph import Log  # noqa: E402
from repro_torch.core.simulator import (measure_baseline,  # noqa: E402
                                        resolve_budget)
from repro_torch.eager import DTRContext, op  # noqa: E402
from repro_torch.eager import executor as X  # noqa: E402
from repro_torch.faults import FaultConfig, RecoveryConfig  # noqa: E402
from repro_torch.offload import OffloadConfig  # noqa: E402
from repro_torch.trace.capture import (capture_eager_mlp,  # noqa: E402
                                       capture_eager_treelstm)
from repro_torch.trace.record import TraceRecorder  # noqa: E402
from repro_torch.trace.replay import run_trace  # noqa: E402

TRACES = Path(__file__).resolve().parent / "traces"
TOL = dict(rtol=1e-6, atol=1e-6)

def _victims(ctx):
    """Record, in ``ctx.victims``, the sid of every storage the runtime
    evicts, in order."""
    ctx.victims = []
    inner = ctx.rt._evict

    def traced(s):
        ctx.victims.append(s.sid)
        inner(s)

    ctx.rt._evict = traced
    return ctx


JAXF = SimpleNamespace(
    lib="jax",
    ctx=lambda **kw: _victims(JContext(use_wallclock_cost=False, **kw)),
    op=jop, sin=jnp.sin, sum=jnp.sum, cos=jnp.cos, add=jnp.add,
    mul=jnp.multiply, sub=jnp.subtract, matmul=jnp.matmul, tanh=jnp.tanh,
    relu=jax.nn.relu, gelu=jax.nn.gelu, mean=jnp.mean,
    numel=lambda t: t.size)
TORCHF = SimpleNamespace(
    lib="torch",
    ctx=lambda **kw: _victims(DTRContext(use_wallclock_cost=False,
                                         device="cpu", **kw)),
    op=op, sin=torch.sin, sum=torch.sum, cos=torch.cos, add=torch.add,
    mul=torch.mul, sub=torch.sub, matmul=torch.matmul, tanh=torch.tanh,
    relu=torch.relu, gelu=lambda t: F.gelu(t, approximate="tanh"),
    mean=torch.mean, numel=lambda t: t.numel())


def _np(x):
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# The scenarios of tests/test_eager.py, on numpy inputs
# ---------------------------------------------------------------------------

def basic_chain(L):
    ctx = L.ctx(budget_bytes=float("inf"))
    x = ctx.wrap(np.arange(16, dtype=np.float32))
    y = ctx.call("sin", L.sin, [x])[0]
    z = ctx.call("sum", L.sum, [y])[0]
    return ctx, [z.value]


def eviction_and_remat(L):
    n = 64 * 1024 // 4
    ctx = L.ctx(budget_bytes=5 * 64 * 1024)
    vals = [ctx.wrap(np.linspace(0, 1, n, dtype=np.float32))]
    for i in range(20):
        vals.append(ctx.call(f"f{i}", lambda a: L.cos(a) * 1.01,
                             [vals[-1]])[0])
    out = [vals[5].value]
    return ctx, out + [v.value for v in vals]


def budget_respected(L):
    n = 32 * 1024 // 4
    budget = 6 * 32 * 1024
    ctx = L.ctx(budget_bytes=budget)
    h = ctx.wrap(np.ones(n, np.float32))
    for i in range(30):
        h = ctx.call(f"g{i}", lambda a: a * 1.0001, [h])[0]
        assert ctx.live_bytes() <= budget + 32 * 1024
    return ctx, [h.value]


def treelstm(L):
    dim = 256
    ctx = L.ctx(budget_bytes=(dim * dim + 16 * dim + 10 * dim) * 4)
    w = ctx.wrap(np.eye(dim, dtype=np.float32) * np.float32(0.5)
                 + np.float32(0.01), name="w")

    def cell(a, b):
        s = ctx.call("add", L.add, [a, b])[0]
        return ctx.call("cell", lambda s_, w_: L.tanh(s_ @ w_), [s, w])[0]

    def build(depth, leaf_val):
        if depth == 0:
            return ctx.wrap(np.full((dim,), leaf_val, np.float32),
                            name="leaf")
        return cell(build(depth - 1, leaf_val),
                    build(depth - 1, leaf_val + 0.1))

    return ctx, [build(4, 0.05).value]


def multi_output(L):
    ctx = L.ctx(budget_bytes=float("inf"))
    x = ctx.wrap(np.arange(8, dtype=np.float32))
    outs = ctx.call("split", lambda a: (a[:4], a[4:]), [x])
    assert len(outs) == 2
    return ctx, [o.value for o in outs]


def sugar(L):
    ctx = L.ctx(budget_bytes=float("inf"))
    gelu = L.op(ctx, "gelu", L.gelu)
    x = ctx.wrap(np.linspace(-2, 2, 16, dtype=np.float32).reshape(4, 4))
    z = gelu(x + x) @ x
    return ctx, [(z * x).value]


def training_loop(L):
    rng = np.random.default_rng(0)
    din, dh, n = 64, 256, 32
    ctx = L.ctx(budget_bytes=40 * n * dh * 4)
    w1 = ctx.wrap(rng.standard_normal((din, dh), np.float32) * 0.05,
                  name="w1")
    w2 = ctx.wrap(rng.standard_normal((dh, 1), np.float32) * 0.05,
                  name="w2")
    xb = ctx.wrap(rng.standard_normal((n, din), np.float32), name="x")
    yb = ctx.wrap(np.ones((n, 1), np.float32), name="y")
    losses = []
    for _ in range(4):
        h = ctx.call("fc1", L.matmul, [xb, w1])[0]
        a = ctx.call("relu", L.relu, [h])[0]
        p = ctx.call("fc2", L.matmul, [a, w2])[0]
        e = ctx.call("err", L.sub, [p, yb])[0]
        loss = ctx.call("mse", lambda t: L.mean(t * t), [e])[0]
        gp = ctx.call("d_mse", lambda t: 2 * t / L.numel(t), [e])[0]
        gw2 = ctx.call("d_w2", lambda a_, g: a_.T @ g, [a, gp])[0]
        ga = ctx.call("d_a", lambda g, w: g @ w.T, [gp, w2])[0]
        gh = ctx.call("d_relu", lambda g, h_: g * (h_ > 0), [ga, h])[0]
        gw1 = ctx.call("d_w1", lambda x_, g: x_.T @ g, [xb, gh])[0]
        w1 = ctx.call("sgd1", lambda w, g: w - 0.05 * g, [w1, gw1])[0]
        w2 = ctx.call("sgd2", lambda w, g: w - 0.05 * g, [w2, gw2])[0]
        losses.append(loss.value)
    assert float(losses[-1]) < float(losses[0])
    return ctx, losses + [w1.value, w2.value]


def pool(L):
    """tests/test_alloc.py::TestEagerPool: the pool allocator backend."""
    ctx = L.ctx(budget_bytes=6 * 4 * 64, heuristic="h_dtr_eq",
                alloc_mode="pool")
    h = ctx.wrap(np.ones(64, np.float32))
    outs = []
    for _ in range(10):
        h = ctx.call("mul", L.mul, [h, h])[0]
        outs.append(h)
    return ctx, [outs[0].value]


SCENARIOS = [basic_chain, eviction_and_remat, budget_respected, treelstm,
             multi_output, sugar, training_loop, pool]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_matches_jax(scenario):
    (jc, jvals), (tc, tvals) = scenario(JAXF), scenario(TORCHF)
    assert len(jvals) == len(tvals)
    for a, b in zip(jvals, tvals):
        assert tuple(b.shape) == tuple(a.shape)
        np.testing.assert_allclose(_np(b), _np(a), **TOL)
    assert (tc.rt.evictions, tc.remat_runs) == (jc.rt.evictions,
                                                jc.remat_runs)
    assert tc.victims == jc.victims
    assert tc.live_bytes() == jc.live_bytes()
    if scenario in (eviction_and_remat, treelstm, pool):
        assert tc.rt.evictions > 0 and tc.remat_runs > 0
    if scenario is pool:
        jf, tf = jc.fragmentation(), tc.fragmentation()
        assert asdict(tf) == asdict(jf) and tf.capacity == 6 * 4 * 64
        tc.rt.allocator.pool.check()


# ---------------------------------------------------------------------------
# Offload and faults (tests/test_offload.py, tests/test_faults.py)
# ---------------------------------------------------------------------------

def _offload_round_trip(L, cfg_cls):
    cfg = cfg_cls(host_budget=1 << 20, h2d_bandwidth=1e9, d2h_bandwidth=1e9)
    ctx = L.ctx(budget_bytes=4096, heuristic="h_dtr_eq", offload=cfg)
    base = ctx.wrap(np.random.RandomState(0).randn(16, 16)
                    .astype(np.float32))
    outs = [ctx.call("mul", L.mul, [base, float(i + 1)])[0]
            for i in range(12)]
    offloads = ctx.rt.offloads
    vals = [o.value for o in outs]
    return ctx, offloads, vals


def test_offload_round_trip_matches_jax():
    jc, joff, jvals = _offload_round_trip(JAXF, JOffloadConfig)
    tc, toff, tvals = _offload_round_trip(TORCHF, OffloadConfig)
    assert toff == joff > 0
    for a, b in zip(jvals, tvals):
        np.testing.assert_allclose(_np(b), _np(a), **TOL)
    assert (tc.rt.fetches, tc.remat_runs, tc.host_bytes()) == \
        (jc.rt.fetches, jc.remat_runs, jc.host_bytes())
    assert tc.rt.fetches > 0 and tc.remat_runs == 0
    assert all(not b.is_pinned() for b in tc.host_buffers.values())


def _fault_chain(L, faults):
    ctx = L.ctx(budget_bytes=3000, heuristic="h_dtr_eq", faults=faults)
    mul, add = L.op(ctx, "mul", L.mul), L.op(ctx, "add", L.add)
    x = ctx.wrap(np.arange(64, dtype=np.float32).reshape(8, 8))
    ys, h = [], x
    for _ in range(12):
        h = add(mul(h, x), x)
        ys.append(h)
    return ctx, [y.value for y in ys[-3:]]


@pytest.mark.parametrize("faulted", [False, True])
def test_fault_chain_matches_jax(faulted):
    """tests/test_faults.py::TestEagerNumerics: injected allocation faults
    and cost noise perturb only the simulated pressure and clock."""
    jc, jvals = _fault_chain(JAXF, JFaultConfig(
        seed=5, alloc_rate=0.4, cost_noise=0.3) if faulted else None)
    tc, tvals = _fault_chain(TORCHF, FaultConfig(
        seed=5, alloc_rate=0.4, cost_noise=0.3) if faulted else None)
    for a, b in zip(jvals, tvals):
        assert np.array_equal(_np(b), _np(a))
    assert (tc.rt.evictions, tc.remat_runs) == (jc.rt.evictions,
                                                jc.remat_runs) != (0, 0)
    if faulted:
        assert tc.rt.faults.injected == jc.rt.faults.injected > 0
        assert tc.rt.events == jc.rt.events


def _transfer_fault_chain(L, off, faults, recovery, rec):
    ctx = L.ctx(budget_bytes=3000.0, heuristic="h_dtr_eq", offload=off,
                faults=faults, recovery=recovery, recorder=rec)
    mul, add = L.op(ctx, "mul", L.mul), L.op(ctx, "add", L.add)
    x = ctx.wrap(np.arange(64, dtype=np.float32).reshape(8, 8))
    h, ys = x, []
    for _ in range(12):
        m = mul(h, x)
        h = add(m, x)
        ys.append((m, h))
    h = add(h, ys[0][1])
    for m, y in ys:
        m.release()
        y.release()
    out = _np(h.value)
    h.release()
    return ctx, rec.finish(), out


def test_transfer_faults_match_jax():
    """tests/test_faults.py::TestEagerTransferFaults: faulted H2D/D2H draws
    through the live executor, its event stream and its recorded log."""
    def cfgs(off_cls, fault_cls, rec_cls):
        return (off_cls(host_budget=float(1 << 20), h2d_bandwidth=1024.0,
                        d2h_bandwidth=1024.0, policy="offload"),
                fault_cls(seed=21, transfer_rate=0.4, spike_rate=0.4),
                rec_cls())

    jc, jlog, jout = _transfer_fault_chain(
        JAXF, *cfgs(JOffloadConfig, JFaultConfig, JRecoveryConfig),
        JRecorder("eager_fault_chain"))
    tc, tlog, tout = _transfer_fault_chain(
        TORCHF, *cfgs(OffloadConfig, FaultConfig, RecoveryConfig),
        TraceRecorder("eager_fault_chain"))
    assert np.array_equal(tout, jout)
    assert tc.rt.offloads == jc.rt.offloads > 0
    assert tc.rt.fetches == jc.rt.fetches > 0
    assert tc.rt.events == jc.rt.events
    assert {e["channel"] for e in tc.rt.events} == {"d2h", "h2d"}
    assert tlog.dumps() == jlog.dumps()


# ---------------------------------------------------------------------------
# What torch needs that JAX does not: views, in-place ops, devices, dtypes
# ---------------------------------------------------------------------------

def test_views_of_inputs_are_cloned():
    ctx = DTRContext(float("inf"), device="cpu", use_wallclock_cost=False)
    x = ctx.wrap(np.arange(8, dtype=np.float32))
    a, b = ctx.call("split", lambda t: (t[:4], t[4:]), [x])
    ident = ctx.call("identity", lambda t: t, [x])[0]
    ptrs = {ctx.buffers[h.tid].untyped_storage().data_ptr()
            for h in (x, a, b, ident)}
    assert len(ptrs) == 4
    assert ctx.live_bytes() == 32 + 16 + 16 + 32 == ctx.rt.memory
    np.testing.assert_array_equal(b.value.numpy(), np.arange(4, 8))


def test_outputs_own_exactly_their_bytes():
    """An expanded or sliced result of a fresh tensor is copied too, so
    each output's storage is its own size."""
    ctx = DTRContext(float("inf"), device="cpu", use_wallclock_cost=False)
    x = ctx.wrap(np.ones(4, np.float32))
    wide = ctx.call("expand", lambda t: (t * 2).expand(3, 4), [x])[0]
    part = ctx.call("part", lambda t: (t * 2)[:2], [x])[0]
    for h in (wide, part):
        buf = ctx.buffers[h.tid]
        assert buf.untyped_storage().nbytes() == X.nbytes(buf) == h.nbytes


def test_in_place_op_raises():
    ctx = DTRContext(float("inf"), device="cpu", use_wallclock_cost=False)
    x = ctx.wrap(np.ones(4, np.float32))
    with pytest.raises(RuntimeError, match="in place"):
        ctx.call("bad", lambda t: t.add_(1), [x])
    with pytest.raises(RuntimeError, match="in place"):
        ctx.call("bad_view", lambda t: t[:2].mul_(2), [x])


def test_no_card_raises_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        DTRContext(1e6)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        capture_eager_mlp()
    assert DTRContext(1e6, device="cpu").device.type == "cpu"


def test_wrap_keeps_dtype_and_records_numpy_names():
    """JAX turns float64 into float32 at wrap (x64 off); torch keeps it."""
    rec = TraceRecorder("dtypes")
    ctx = DTRContext(float("inf"), device="cpu", recorder=rec)
    a = ctx.wrap(np.ones(3, np.float64), name="a")
    b = ctx.wrap(torch.ones(2, dtype=torch.bfloat16), name="b")
    assert (a.dtype, a.nbytes, b.nbytes) == (torch.float64, 24, 4)
    meta = [dict(i.meta) for i in rec.finish().instrs if i.meta]
    assert [m["dtype"] for m in meta] == ["float64", "bfloat16"]


def test_offload_keeps_strides():
    """A transposed output goes to the host and back with its strides, so
    the ops that read it take the same path."""
    cfg = OffloadConfig(host_budget=1 << 20, h2d_bandwidth=1e9,
                        d2h_bandwidth=1e9, policy="offload")
    ctx = DTRContext(3 * 256, device="cpu", use_wallclock_cost=False,
                     offload=cfg)
    x = ctx.wrap(np.arange(64, dtype=np.float32).reshape(8, 8))
    t = ctx.call("t", lambda a: (a * 2).T, [x])[0]
    for i in range(4):
        ctx.call(f"m{i}", torch.mul, [x, float(i)])
    assert ctx.host_buffers[t.tid].stride() == (1, 8)
    assert t.value.stride() == (1, 8) and ctx.rt.fetches > 0
    np.testing.assert_array_equal(t.value.numpy(),
                                  (np.arange(64).reshape(8, 8) * 2).T)


# ---------------------------------------------------------------------------
# Captures and the copied engine's replay
# ---------------------------------------------------------------------------

def test_capture_eager_mlp_equals_golden_log():
    log = capture_eager_mlp(device="cpu")
    assert log.dumps() + "\n" == (TRACES / "eager_mlp.log").read_text()


def test_capture_eager_treelstm_equals_jax_capture():
    assert capture_eager_treelstm(device="cpu").dumps() == \
        jcapture_treelstm().dumps()


@pytest.mark.parametrize("name", ["eager_mlp", "treelstm"])
def test_copied_engine_replays_golden_cells(name):
    """tests/test_trace_golden.py::test_replay_matches_expected through the
    port's copy of the engine, for the two small traces."""
    log = Log.loads((TRACES / f"{name}.log").read_text())
    exp = json.loads((TRACES / "expected.json").read_text())[name]
    peak, _ = measure_baseline(log)
    pinned = log.pinned_bytes()
    assert (repr(peak), pinned) == (exp["baseline_peak"], exp["pinned"])
    for cell, want in exp["cells"].items():
        h, frac = cell.split("@")
        budget = resolve_budget(float(frac), peak, pinned, "activation")
        res, victims = run_trace(log, h, budget, index=True,
                                 thrash_factor=3.0)
        got = {
            "ok": res.ok, "evictions": res.evictions,
            "remat_ops": res.remat_ops, "ops_executed": res.ops_executed,
            "compute": repr(res.compute),
            "peak_memory": repr(res.peak_memory),
            "victims_sha1": hashlib.sha1(
                ",".join(map(str, victims)).encode()).hexdigest(),
            "n_victims": len(victims),
        }
        assert got == want, f"{name}/{cell}"
