"""Each metric's arithmetic against numbers worked by hand."""
from __future__ import annotations

from types import SimpleNamespace

import pytest

from dtrbench.lib import stats, trace, work
from dtrbench.lib.bench import Bench
from dtrbench.reference import mixtral, rwkv6

BENCH = Bench()


def test_window_rate_counts_every_step_over_the_whole_window():
    stamps = [10.0, 10.5, 11.5, 12.0]           # 3 steps in 2 s
    assert stats.rate(4096, stamps) == pytest.approx(3 * 4096 / 2.0)
    assert stats.walls(stamps) == [0.5, 1.0, 0.5]


def test_p90_over_all_steps():
    walls = [float(i) for i in range(1, 11)]    # 1..10
    # rank (10 - 1) * 0.9 = 8.1: 9 + 0.1 * (10 - 9)
    assert stats.percentile(walls, 90) == pytest.approx(9.1)
    assert stats.percentile([5.0], 90) == 5.0
    assert stats.percentile([3.0, 1.0, 2.0], 50) == 2.0


def test_causal_pairs_and_the_attention_work():
    # 4 queries, causal: 1 + 2 + 3 + 4 keys; window 2: 1 + 2 + 2 + 2.
    assert work.visible_pairs(1, 4, 4) == 10
    assert work.visible_pairs(3, 4, 4, window=2) == 3 * 7
    nbytes, flops = work.attention_fwd_work(1, 2, 1, 4, 4, 8, 2)
    assert flops == 4 * 2 * 8 * 10
    # q and o: 2 * 1*2*4*8; k and v: 2 * 1*4*1*8; bf16; LSE 4 * 1*2*4.
    assert nbytes == (128 + 64) * 2 + 32
    nbytes, flops = work.attention_bwd_work(1, 2, 1, 4, 4, 8, 2)
    assert flops == 10 * 2 * 8 * 10
    assert nbytes == (4 * 64 + 4 * 32) * 2 + 32


def test_mixtral_train_attention_bound_matches_the_kernel_table():
    # PERF.md's kernel table: q [2,32,2048,128], k/v [2,8,2048,128], bf16:
    # forward 68.7 GFLOP (0.06952 ms), backward 171.9 GFLOP (0.1738 ms).
    _, f = work.attention_fwd_work(2, 32, 8, 2048, 2048, 128, 2)
    _, b = work.attention_bwd_work(2, 32, 8, 2048, 2048, 128, 2)
    assert f / 1e9 == pytest.approx(68.75, rel=1e-3)
    assert b / 1e9 == pytest.approx(171.9, rel=1e-3)
    shape = dict(b=2, hq=32, hkv=8, s=2048, d=128, window=0, itemsize=2)
    assert work.call_bound_s("flash", "fwd", shape) * 1e3 == pytest.approx(
        0.06952, rel=1e-3)


def test_grouped_gemm_counts_kept_rows_not_the_capacity_buffer():
    # 16384 kept assignments (4 x 2048 tokens, top 2) of a 20480-row buffer.
    nbytes, flops = work.gemm_fwd_work(8, 16384, 4096, 14336, 2)
    assert flops == 2 * 16384 * 4096 * 14336
    assert nbytes == (16384 * 4096 + 8 * 4096 * 14336 + 16384 * 14336) * 2
    _, bflops = work.gemm_bwd_work(8, 16384, 4096, 14336, 2)
    assert bflops == 2 * flops
    s = work.call_bound_s("moe_gemm", "fwd", dict(e=8, rows=16384, d=4096,
                                                  f=14336, itemsize=2))
    assert s == pytest.approx(flops / 989e12)        # operations bound it


def test_wkv_bound_matches_the_kernel_table():
    # PERF.md: rwkv6 train [128,1024,64] bf16: 0.03507 ms forward (117.5
    # MB), 0.06012 ms backward (201.4 MB), bytes bound both.
    shape = dict(bh=128, s=1024, d=64, itemsize=2)
    assert work.call_bound_s("wkv", "fwd", shape) * 1e3 == pytest.approx(
        0.03507, rel=1e-3)
    assert work.call_bound_s("wkv", "bwd", shape) * 1e3 == pytest.approx(
        0.06012, rel=1e-3)


def test_model_flops_of_both_families():
    mx = BENCH.config("mixtral-8x7b-2l")["model"]
    per_token = 2 * (4096 * (32 + 16) * 128 + 32 * 128 * 4096 + 4096 * 8
                     + 2 * 3 * 4096 * 14336)
    pairs = 4 * 2048 * 2049 // 2
    want = 2 * (4 * 2048 * per_token + 4 * 32 * 128 * pairs) \
        + 4 * 2048 * 2 * 4096 * 32000
    assert mixtral.forward_flops(mx, 4, 2048) == want
    # 3 x forward: 5.62 GFLOP a token.
    assert 3 * want / (4 * 2048) / 1e9 == pytest.approx(5.62, abs=0.01)
    rw = BENCH.config("rwkv6-1.6b")["model"]
    d, f = 2048, 7168
    layer = 2 * (6 * d * d + 2 * d * 64 + 2 * d * f) + 4 * 64 * 64 * 32
    want = 24 * 4096 * layer + 4096 * 2 * d * 65536
    assert rwkv6.forward_flops(rw, 4, 1024) == want
    assert 3 * want / 4096 / 1e9 == pytest.approx(8.8, abs=0.1)


def _run(**kw):
    base = dict(stamps=[0.0, 1.0, 2.0, 3.5], step_seconds=[0.9, 0.8, 1.2],
                clean=[True, True, False], session=None, calls=[],
                counters={}, forward_calls={}, traffic=dict(batch=4, seq=1024),
                config=BENCH.config("rwkv6-1.6b"), family=rwkv6)
    base.update(kw)
    return SimpleNamespace(**base)


def test_loop_overhead_share_skips_profiled_steps():
    read = BENCH.metric("loop_overhead_share.train")
    # Clean steps: walls 1.0 and 1.0, loop steps 0.9 and 0.8.
    assert read(_run()) == pytest.approx(100 * (1 - 1.7 / 2.0))
    assert read(_run(clean=[False] * 3)) is None


def test_recompute_ratio_is_launches_over_forward_calls():
    read = BENCH.metric("recompute_ratio.train")
    key = "repro_torch.kernels.rwkv6_chunk:rwkv6_fwd"
    assert read(_run(counters={key: 96}, forward_calls={"wkv": 48})) == 2.0
    assert read(_run(counters={key: 48}, forward_calls={"wkv": 48})) == 1.0
    assert read(_run(counters={key: 0}, forward_calls={})) is None


def test_mfu_over_the_whole_window():
    read = BENCH.metric("mfu.train")
    run = _run()
    flops = 3 * rwkv6.forward_flops(run.config["model"], 4, 1024) * 3
    assert read(run) == pytest.approx(100 * flops / (3.5 * 989e12))


def test_roofline_and_idle_read_the_session_or_nothing():
    flash = BENCH.metric("flash_roofline.train")
    idle = BENCH.metric("device_idle_share.train")
    assert flash(_run()) is None and idle(_run()) is None
    shape = dict(b=1, hq=2, hkv=1, s=4, d=8, window=0, itemsize=2)
    session = trace.TraceSummary(window_s=2.0, busy_s=1.5,
                                 span_s={("flash", "fwd"): 1e-6,
                                         ("flash", "bwd"): 3e-6})
    run = _run(session=session, calls=[("flash", "fwd", shape),
                                       ("flash", "bwd", shape)])
    want = (work.call_bound_s("flash", "fwd", shape)
            + work.call_bound_s("flash", "bwd", shape)) / 4e-6
    assert flash(run) == pytest.approx(100 * want)
    assert idle(run) == pytest.approx(25.0)
    assert BENCH.metric("wkv_roofline.train")(run) is None


def _x(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 1, "tid": args.pop("tid", 1), "args": args}


def test_trace_summary_attributes_kernels_to_the_innermost_span():
    events = [
        _x("dtrbench.window", "user_annotation", 0, 100),
        _x("dtrbench.flash.fwd", "user_annotation", 10, 20),
        _x("dtrbench.measure", "user_annotation", 12, 2),
        _x("cudaLaunchKernel", "cuda_runtime", 13, 1, correlation=1),
        _x("cudaLaunchKernel", "cuda_runtime", 15, 1, correlation=2),
        _x("dtrbench.flash.bwd", "user_annotation", 40, 30, tid=2),
        _x("cudaLaunchKernel", "cuda_runtime", 45, 1, correlation=3, tid=2),
        _x("aten::item", "cpu_op", 60, 30),
        _x("cudaLaunchKernel", "cuda_runtime", 80, 1, correlation=4),
        _x("count", "kernel", 14, 2, correlation=1),
        _x("flash_fwd", "kernel", 16, 10, correlation=2),
        _x("flash_bwd", "kernel", 46, 14, correlation=3),
        _x("other", "kernel", 90, 20, correlation=4),    # past the window
    ]
    s = trace.summarize(events)
    assert s.window_s == pytest.approx(100e-6)
    assert s.busy_s == pytest.approx((2 + 10 + 14 + 10) * 1e-6)
    assert s.span_s == {("flash", "fwd"): pytest.approx(10e-6),
                        ("flash", "bwd"): pytest.approx(14e-6)}
    assert s.device_ops[0] == ["flash_bwd", pytest.approx(14e-6)]
    gaps = dict(s.idle_gaps)
    # 60..90 idle while the host sat in aten::item (inside the window's
    # range), 26..46 inside the flash forward's span, 0..14 in the window
    # range alone.
    assert gaps == {"dtrbench.window: aten::item": pytest.approx(30e-6),
                    "dtrbench.window: dtrbench.flash.fwd":
                        pytest.approx(20e-6),
                    "dtrbench.window": pytest.approx(14e-6)}
