"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs a CUDA card: it carries the ``requires_cuda`` marker
and skips inside the test where torch sees none.  Run on the card with

    PYTHONPATH=src python -m pytest -q -m requires_cuda tests/test_torch_cuda.py

This file imports neither JAX nor the JAX package, so it runs where only
the port is installed.
"""
import gc

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import moe_gemm as mg  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.moe_gemm import moe_gemm, moe_gemm_bwd  # noqa: E402
from repro_torch.kernels import rwkv6_chunk as wkv  # noqa: E402
from repro_torch.kernels.rwkv6_chunk import (  # noqa: E402
    rwkv6_bwd, rwkv6_chunk, rwkv6_fwd)
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.params import tree_map  # noqa: E402

pytestmark = pytest.mark.requires_cuda

# f32: summation order only; bf16: one rounding of the output (the JAX
# package's tolerances for its own kernel).
TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
SHAPES = [  # tests/test_kernels.py's sweep, then the port's main path
    (1, 2, 2, 128, 128, 64, True, 0), (2, 4, 2, 128, 128, 64, True, 0),
    (1, 8, 1, 256, 256, 64, True, 0), (2, 2, 2, 128, 128, 64, False, 0),
    (1, 2, 2, 256, 256, 64, True, 64), (1, 2, 2, 64, 256, 64, True, 0),
    (1, 2, 2, 96, 96, 32, True, 0), (1, 2, 2, 128, 128, 128, True, 0),
    (4, 14, 2, 1, 128, 64, True, 0),       # qwen2-0.5b decode, per-slot
    (2, 7, 1, 1, 40, 8, True, 0),          # smoke head_dim, per-slot
    (3, 4, 2, 33, 70, 256, True, 0),       # widest head
    (4, 32, 8, 1, 128, 128, True, 0),      # mixtral decode: D 128, kv_len
    (2, 8, 2, 1, 37, 128, True, 0),        # Skv 37: one ragged key tile
    (2, 8, 2, 1, 200, 64, True, 0),        # Skv 200: split over 4 tiles
    (1, 4, 1, 1, 512, 64, True, 100),      # window inside a split key range
]
# The JAX package's grouped-GEMM tolerances: f32 summation order; bf16 one
# rounding of the output.
GEMM_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
            torch.bfloat16: dict(rtol=3e-2, atol=3e-2)}
GEMM_SHAPES = [  # (e, c, d, f): tests/test_kernels.py's sweep, then ragged
    (4, 128, 256, 128), (8, 64, 128, 256), (2, 256, 512, 64),
    (1, 128, 128, 128),
    (3, 40, 200, 72),                      # no dim divides a tile
    (2, 1, 7, 5),                          # one row; 1-element loads
    (5, 33, 48, 40),                       # C just past one 32-row tile
    (4, 16, 64, 96),                       # smoke mixtral, 2 slots
    (8, 32, 1024, 512),                    # decode-shaped: C = 4 slots x 8
    (8, 8, 4096, 256),                     # C 8: one C tile, mostly padding
    (8, 33, 4096, 40),                     # C 33, F 40: ragged C and F
    (2, 640, 4096, 256),                   # prefill C, five 128-wide tiles
]
# These shapes draw w ~ N(0, 1/d), for outputs of unit scale: with N(0, 1)
# at d = 4096 the f32 outputs, of size ~64, would put the kernel's summation
# order above GEMM_TOL's f32 atol.  The other shapes draw N(0, 1).
GEMM_UNIT_W = {(8, 8, 4096, 256), (8, 33, 4096, 40), (2, 640, 4096, 256)}
# RWKV6 recurrence, kernel against plain version.  The forward: the JAX
# package's tolerances for its own kernel (f32 3e-4, bf16 inputs 4e-2), though
# both sides widen the same inputs and differ in summation order only.  The
# backward: every gradient within 1e-3 of its largest magnitude (f32 sums of
# up to S * D terms in another order; bf16 gr/gk/gv add one rounding, 2^-8
# of their own size).
WKV_TOL = {torch.float32: dict(rtol=3e-4, atol=3e-4),
           torch.bfloat16: dict(rtol=4e-2, atol=4e-2)}
WKV_GRAD_REL = {torch.float32: 1e-3, torch.bfloat16: 1e-2}
WKV_SHAPES = [  # (bh, s, d, log-decay: None = -exp(U[-4, 1.2]) or constant)
    (2, 128, 32, None), (1, 256, 64, None), (4, 64, 32, None),
    (3, 37, 64, None),                     # ragged S: no chunk divides it
    (2, 1, 32, None), (2, 9, 64, None),    # shorter than one chunk
    (2, 100, 64, -float(np.exp(4.0))),     # steepest clipped decay
    (2, 100, 32, -float(np.exp(-8.0))),    # flattest clipped decay
    (8, 256, 64, None),                    # rwkv6-1.6b heads, shorter S
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CPU runs the plain version only")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(b, hq, hkv, sq, skv, d, dtype, device):
    rng = np.random.default_rng(0)
    return [torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
            .to(device=device, dtype=dtype)
            for s in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,window", SHAPES)
def test_kernel_matches_plain(cuda, b, hq, hkv, sq, skv, d, causal, window,
                              dtype):
    q, k, v = _qkv(b, hq, hkv, sq, skv, d, dtype, cuda)
    kv_len = (torch.arange(b, dtype=torch.int32, device=cuda) * 37 % skv
              + 1) if sq == 1 else None
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal, window=window,
                          kv_len=kv_len)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    expect = ref.flash_reference(q, k, v, causal=causal, window=window,
                                 kv_len=kv_len)
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               expect.float().cpu().numpy(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,skv,d,lens", [
    (4, 14, 2, 128, 64, (1, 37, 128, 90)),   # qwen2 decode: split in two
    (4, 32, 8, 128, 128, (4, 41, 91, 128)),  # mixtral decode
    (2, 4, 1, 200, 32, (5, 130)),            # D 32, four key tiles
])
def test_kernel_ignores_keys_past_kv_len(cuda, b, hq, hkv, skv, d, lens,
                                         dtype):
    """K/V rows at or past a row's kv_len hold NaN: both variants give the
    plain version's output on the same inputs with those rows zeroed (P is
    0 there, and 0 x NaN would poison P.V)."""
    q, k, v = _qkv(b, hq, hkv, 1, skv, d, dtype, cuda)
    kv_len = torch.tensor(lens, dtype=torch.int32, device=cuda)
    past = (torch.arange(skv, device=cuda)[None, :]
            >= kv_len[:, None])[:, None, :, None]
    out = flash_attention(q, k.masked_fill(past, float("nan")),
                          v.masked_fill(past, float("nan")), kv_len=kv_len)
    torch.cuda.synchronize()
    expect = ref.flash_reference(q, k.masked_fill(past, 0),
                                 v.masked_fill(past, 0), kv_len=kv_len)
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               expect.float().cpu().numpy(), **TOL[dtype])


@pytest.mark.parametrize("case", ["non_contiguous", "k_on_cpu",
                                  "kv_len_on_cpu"])
def test_kernel_rejects(cuda, case):
    q, k, v = _qkv(2, 4, 2, 8, 8, 16, torch.float32, cuda)
    kw = {}
    if case == "non_contiguous":
        k = k.transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "k_on_cpu":
        k = k.cpu()
    else:
        kw["kv_len"] = torch.tensor([3, 8], dtype=torch.int32)
    before = flash_attention.launches
    with pytest.raises(ValueError):
        flash_attention(q, k, v, **kw)
    assert flash_attention.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,c,d,f", GEMM_SHAPES)
def test_moe_gemm_matches_plain(cuda, e, c, d, f, dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((e, c, d), dtype=np.float32)
    w = rng.standard_normal((e, d, f), dtype=np.float32)
    if (e, c, d, f) in GEMM_UNIT_W:
        w /= np.sqrt(d)
    x, w = (torch.from_numpy(t).to(device=cuda, dtype=dtype) for t in (x, w))
    before = moe_gemm.launches
    out = moe_gemm(x, w)
    torch.cuda.synchronize()
    assert moe_gemm.launches == before + 1
    assert out.dtype == dtype and out.shape == (e, c, f)
    np.testing.assert_allclose(
        out.float().cpu().numpy(),
        ref.moe_gemm_reference(x, w).float().cpu().numpy(), **GEMM_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,c,d,f", GEMM_SHAPES)
def test_moe_gemm_backward_matches_autograd(cuda, e, c, d, f, dtype):
    """Autograd through the wrapper launches the forward once and the
    backward's two products (``moe_gemm_bwd``), on the planned variant; the
    gradients against autograd through the plain version, each within the
    kernel tolerance of its largest magnitude; a second call's bits."""
    rng = np.random.default_rng(2)
    x, w, dy = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
                .to(device=cuda, dtype=dtype)
                for s in ((e, c, d), (e, d, f), (e, c, f)))
    # On wgmma the two products read the operands in place; on simt
    # dX = dY wᵀ runs as [E,C,F]@[E,F,d] and dW = xᵀ dY as [E,d,C]@[E,C,F]
    # on copies, each planned as a forward.
    planned = ["wgmma"] * 2 \
        if mg.plan_backward(e, c, d, f, dtype)["variant"] == "wgmma" \
        else [mg.plan(e, c, f, d, dtype)["variant"],
              mg.plan(e, d, c, f, dtype)["variant"]]
    xs = [t.detach().requires_grad_() for t in (x, w)]
    before = dict(moe_gemm_bwd.variant_launches)
    fwd_before = moe_gemm.launches
    got = torch.autograd.grad(moe_gemm(*xs), xs, dy)
    torch.cuda.synchronize()
    assert moe_gemm.launches == fwd_before + 1
    after = moe_gemm_bwd.variant_launches
    assert {k: after[k] - before[k] for k in after} == {
        k: planned.count(k) for k in after}
    ps = [t.detach().requires_grad_() for t in (x, w)]
    want = torch.autograd.grad(ref.moe_gemm_reference(*ps), ps, dy)
    tol = GEMM_TOL[dtype]["rtol"]
    for g, p in zip(got, want):
        assert g.dtype == dtype and g.shape == p.shape
        err = (g.float() - p.float()).abs().max().item()
        assert err <= tol * p.float().abs().max().item()
    again = moe_gemm_bwd(x, w, dy)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("case", ["non_contiguous", "w_on_cpu"])
def test_moe_gemm_rejects(cuda, case):
    x = torch.randn(2, 8, 16, device=cuda)
    w = torch.randn(2, 16, 24, device=cuda)
    if case == "non_contiguous":
        w = w.transpose(1, 2).contiguous().transpose(1, 2)
    else:
        w = w.cpu()
    before = moe_gemm.launches
    with pytest.raises(ValueError):
        moe_gemm(x, w)
    assert moe_gemm.launches == before


@pytest.mark.parametrize("dtype,variant", [(torch.bfloat16, "wgmma"),
                                           (torch.float32, "simt")])
def test_decode_shapes_launch_planned_variant(cuda, dtype, variant):
    """The serve paths' decode shapes: bf16 goes to the tensor-core
    variant of both kernels, f32 to the CUDA-core one."""
    flash_before = dict(flash_attention.variant_launches)
    gemm_before = dict(moe_gemm.variant_launches)
    for b, hq, hkv, sq, skv, d, lens in ((4, 14, 2, 1, 128, 64,
                                          (1, 37, 128, 90)),
                                         (4, 32, 8, 1, 128, 128,
                                          (4, 41, 91, 128))):
        q, k, v = _qkv(b, hq, hkv, sq, skv, d, dtype, cuda)
        flash_attention(q, k, v, kv_len=torch.tensor(
            lens, dtype=torch.int32, device=cuda))
    for e, c, d, f in ((8, 32, 4096, 14336), (8, 32, 14336, 4096)):
        moe_gemm(torch.zeros(e, c, d, dtype=dtype, device=cuda),
                 torch.zeros(e, d, f, dtype=dtype, device=cuda))
    torch.cuda.synchronize()
    assert flash_attention.variant_launches[variant] == \
        flash_before[variant] + 2
    assert moe_gemm.variant_launches[variant] == gemm_before[variant] + 2
    assert flash_attention.variant_launches == {
        **flash_before, variant: flash_before[variant] + 2}
    assert moe_gemm.variant_launches == {
        **gemm_before, variant: gemm_before[variant] + 2}


def test_build_is_cached(cuda):
    lib = _build.load("flash_attention", fa._SIGNATURES)
    assert _build.load("flash_attention", fa._SIGNATURES) is lib
    assert _build.library_path("flash_attention").exists()
    assert _build.build(["flash_attention"]) == {}   # nothing to rebuild


def test_smoke_serve_on_card_matches_cpu(cuda):
    """Same parameters and requests: the card (kernel) and the CPU (plain
    version) serve the same greedy tokens, and every decode step launched
    the kernel once per layer."""
    cfg = configs.get_smoke("qwen2-0.5b")
    args = serve.parse_args(["--arch", "qwen2-0.5b", "--smoke", "--requests",
                             "6", "--slots", "2", "--gen", "8"])
    params = M.init_params(cfg, torch.Generator().manual_seed(0))
    on_cpu = serve.serve_loop(cfg, params, args)
    before = flash_attention.launches
    on_card = serve.serve_loop(cfg, tree_map(lambda t: t.to(cuda), params),
                               args)
    assert on_card.completed == on_cpu.completed
    assert flash_attention.launches - before == on_card.steps * cfg.n_layers


def test_smoke_mixtral_on_card_matches_cpu(cuda):
    """Ring-buffer caches and MoE layers: the card (both kernels) and the
    CPU (plain versions) serve the same greedy tokens; every decode step
    launched flash attention once and the grouped GEMM three times per
    layer."""
    cfg = configs.get_smoke("mixtral-8x7b")
    args = serve.parse_args(["--arch", "mixtral-8x7b", "--smoke",
                             "--requests", "6", "--slots", "2", "--gen", "8",
                             "--max-len", "32"])
    params = M.init_params(cfg, torch.Generator().manual_seed(0))
    on_cpu = serve.serve_loop(cfg, params, args)
    flash_before, moe_before = flash_attention.launches, moe_gemm.launches
    on_card = serve.serve_loop(cfg, tree_map(lambda t: t.to(cuda), params),
                               args)
    assert on_card.completed == on_cpu.completed
    assert flash_attention.launches - flash_before == \
        on_card.steps * cfg.n_layers
    assert moe_gemm.launches - moe_before == on_card.steps * 3 * cfg.n_layers


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "qwen2-0.5b"])
def test_smoke_admission_on_card_matches_cpu(cuda, arch):
    """Under a KV budget and chaos squeezes, the card and the CPU serve the
    same tokens with the same preemptions; rwkv6 decode launches no
    kernel, qwen2's one flash call per layer and step."""
    cfg = configs.get_smoke(arch)
    args = serve.parse_args(["--arch", arch, "--smoke", "--requests", "8",
                             "--slots", "4", "--gen", "8", "--max-len", "32",
                             "--kv-budget", "0.3", "--chaos-shrink", "0.5",
                             "--chaos-period", "16"])
    params = M.init_params(cfg, torch.Generator().manual_seed(0))
    on_cpu = serve.serve_loop(cfg, params, args)
    before = flash_attention.launches
    on_card = serve.serve_loop(cfg, tree_map(lambda t: t.to(cuda), params),
                               args)
    assert on_card.completed == on_cpu.completed
    assert (on_card.counters, on_card.events) == \
        (on_cpu.counters, on_cpu.events)
    assert on_card.counters["preemptions"] > 0
    per_step = 0 if arch == "rwkv6-1.6b" else cfg.n_layers
    assert flash_attention.launches - before == on_card.steps * per_step


def test_scalar_clock_example_on_card_matches_cpu(cuda):
    from repro_torch.examples import serve as example
    cfg = configs.get_smoke("llama3_2_1b")
    params = M.init_params(cfg, torch.Generator().manual_seed(0))
    on_cpu, _ = example.serve_batch(cfg, params)
    on_card, _ = example.serve_batch(cfg, tree_map(lambda t: t.to(cuda),
                                                   params))
    assert on_card == on_cpu


def _wkv_inputs(bh, s, d, logw, dtype, device):
    rng = np.random.default_rng(2)
    r, k, v, g = (rng.standard_normal((bh, s, d), dtype=np.float32)
                  for _ in range(4))
    wl = (-np.exp(rng.uniform(-4.0, 1.2, (bh, s, d))) if logw is None
          else np.full((bh, s, d), logw)).astype(np.float32)
    u = rng.standard_normal((bh, d), dtype=np.float32) * 0.3

    def t(x, dt=torch.float32):
        return torch.from_numpy(x).to(device=device, dtype=dt)

    return ([t(x, dtype) for x in (r, k, v)] + [t(wl), t(u)], t(g))


def _check_wkv_against_plain(bh, s, d, logw, dtype, device, variant):
    args, g = _wkv_inputs(bh, s, d, logw, dtype, device)
    before = rwkv6_fwd.launches, rwkv6_bwd.launches
    ran = rwkv6_fwd.variant_launches[variant], \
        rwkv6_bwd.variant_launches[variant]
    out = rwkv6_fwd(*args)
    grads = rwkv6_bwd(*args, g)
    torch.cuda.synchronize()
    assert (rwkv6_fwd.launches, rwkv6_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    assert (rwkv6_fwd.variant_launches[variant],
            rwkv6_bwd.variant_launches[variant]) == (ran[0] + 1, ran[1] + 1)
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    np.testing.assert_allclose(
        out.cpu().numpy(), ref.rwkv6_reference(*args).cpu().numpy(),
        **WKV_TOL[dtype])
    expect = ref.rwkv6_backward_reference(*args, g)
    for name, a, b in zip(("r", "k", "v", "w_log", "u"), grads, expect):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.isfinite(a).all(), name
        err = (a.float() - b.float()).abs().max().item()
        assert err <= WKV_GRAD_REL[dtype] * b.float().abs().max().item(), \
            (name, err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,s,d,logw", WKV_SHAPES)
def test_rwkv6_kernels_match_plain(cuda, bh, s, d, logw, dtype):
    """The planned variant: f32 on ``simt``, bf16 on ``mma``."""
    _check_wkv_against_plain(bh, s, d, logw, dtype, cuda,
                             "mma" if dtype == torch.bfloat16 else "simt")


@pytest.mark.parametrize("bh,s,d,logw", WKV_SHAPES)
def test_rwkv6_simt_matches_plain_in_bf16(cuda, monkeypatch, bh, s, d,
                                          logw):
    """bf16 planned onto ``simt``, as for an unaligned input."""
    plan = wkv.plan
    monkeypatch.setattr(wkv, "plan", lambda *a, **k: plan(
        *a, **dict(k, aligned=False)))
    _check_wkv_against_plain(bh, s, d, logw, torch.bfloat16, cuda, "simt")


def test_rwkv6_train_shape_launches_mma(cuda):
    """rwkv6-1.6b's train shape [128,1024,64] in bf16: both wrappers
    launch the ``mma`` variant and nothing on ``simt``."""
    args, g = _wkv_inputs(128, 1024, 64, None, torch.bfloat16, cuda)
    before = dict(rwkv6_fwd.variant_launches), \
        dict(rwkv6_bwd.variant_launches)
    out = rwkv6_fwd(*args)
    grads = rwkv6_bwd(*args, g)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert all(torch.isfinite(x).all() for x in grads)
    assert rwkv6_fwd.variant_launches == {**before[0],
                                          "mma": before[0]["mma"] + 1}
    assert rwkv6_bwd.variant_launches == {**before[1],
                                          "mma": before[1]["mma"] + 1}


@pytest.mark.parametrize("s,logw", [(256, None), (37, None),
                                    (100, -float(np.exp(4.0)))])
def test_rwkv6_mma_backward_is_deterministic(cuda, s, logw):
    """No float atomics: two backward runs give the same bits."""
    args, g = _wkv_inputs(8, s, 64, logw, torch.bfloat16, cuda)
    first = rwkv6_bwd(*args, g)
    second = rwkv6_bwd(*args, g)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("which", ["fwd", "bwd"])
def test_rwkv6_refused_mma_launch_raises(cuda, monkeypatch, which):
    """A bf16 call planned onto ``mma`` whose launch the kernel refuses (a
    span that is no whole number of chunks, a backward span past what
    shared memory holds) raises; nothing falls back to ``simt`` or to the
    plain version, and no launch is counted."""
    plan = wkv.plan
    monkeypatch.setattr(wkv, "plan", lambda *a, **k: dict(
        plan(*a, **k), span_fwd=24, span_bwd=128))
    args, g = _wkv_inputs(2, 64, 32, None, torch.bfloat16, cuda)
    fn = rwkv6_fwd if which == "fwd" else rwkv6_bwd
    before = fn.launches, dict(fn.variant_launches)
    with pytest.raises(RuntimeError, match="mma"):
        fn(*args) if which == "fwd" else fn(*args, g)
    assert (fn.launches, fn.variant_launches) == before


@pytest.mark.parametrize("case", ["u_on_cpu", "r_bf16_k_f32", "logw_bf16",
                                  "non_contiguous", "head_dim_48"])
def test_rwkv6_rejects(cuda, case):
    d = 48 if case == "head_dim_48" else 32
    (r, k, v, wl, u), _ = _wkv_inputs(2, 16, d, None, torch.float32, cuda)
    err = ValueError
    if case == "u_on_cpu":
        u = u.cpu()
    elif case == "r_bf16_k_f32":
        r, err = r.to(torch.bfloat16), TypeError
    elif case == "logw_bf16":
        wl, err = wl.to(torch.bfloat16), TypeError
    elif case == "non_contiguous":
        k = k.transpose(0, 1).contiguous().transpose(0, 1)
    before = rwkv6_fwd.launches
    with pytest.raises(err):
        rwkv6_chunk(r, k, v, wl, u)
    assert rwkv6_fwd.launches == before


@pytest.mark.parametrize("remat,fwd_per_layer", [("none", 1), ("full", 2)])
def test_smoke_train_step_launches(cuda, remat, fwd_per_layer):
    """One smoke train step on the card: each rwkv layer launched the
    forward kernel once (twice with remat "full") and the backward once."""
    args = train.parse_args(["--arch", "rwkv6-1.6b", "--smoke", "--steps",
                             "1", "--batch", "2",
                             "--seq", "32", "--remat", remat])
    cfg = train.config_from_args(args)
    params = M.init_params(cfg, torch.Generator(cuda).manual_seed(0))

    def reset(step):
        rwkv6_fwd.launches = rwkv6_bwd.launches = 0

    res = train.train_loop(cfg, params, args, verbose=False, on_step=reset)
    assert np.isfinite(res.losses[0])
    assert (rwkv6_fwd.launches, rwkv6_bwd.launches) == \
        (fwd_per_layer * cfg.n_layers, cfg.n_layers)


# ---------------------------------------------------------------------------
# The flash backward kernels and the qwen2 train step
# ---------------------------------------------------------------------------

BWD_SHAPES = [  # chip_smoke.py phase 2's backward cases, then the smoke dim
    (2, 4, 2, 128, 128, 64, True, 0),
    (1, 14, 2, 100, 100, 64, True, 0),     # qwen2 heads; 100 keys: ragged
    (1, 14, 2, 77, 131, 64, True, 33),     # a window, Sq < Skv
    (1, 32, 8, 96, 96, 128, True, 0),      # mixtral heads, D 128
    (2, 4, 1, 64, 96, 32, False, 0),       # no mask, D 32
    (2, 7, 1, 16, 16, 8, True, 0),         # qwen2 smoke heads, D 8
    (4, 32, 8, 2048, 2048, 64, True, 0),   # llama3.2-1b's train shape, G 4
    (8, 9, 3, 1024, 1024, 64, True, 0),    # smollm-135m's: G 3, odd heads
    (2, 4, 1, 100, 100, 256, True, 0),     # gemma3 heads, D 256
    (1, 10, 1, 77, 140, 256, True, 40),    # recurrentgemma heads, a window
    (1, 32, 8, 200, 161, 128, False, 0),   # vision cross: Sq > Skv, 1 key
    #                                        in the last tile
    (2, 8, 8, 130, 130, 64, True, 0),      # musicgen heads: MHA, G 1
]
# The cases the tensor-core backward takes in bf16: ``wgmma`` at D 64 (one
# warpgroup a block), 128 and 256 (two); ``mma`` at D 64 only.
BWD_SHAPES_TC = [s for s in BWD_SHAPES if s[5] in fa.BWD_WGMMA_HEAD_DIMS]
BWD_SHAPES_D64 = [s for s in BWD_SHAPES_TC if s[5] == 64]
# bf16 forwards at head dim 256 on ``wgmma``: gemma3's heads causal in
# 128-row blocks (two consumer warpgroups), recurrentgemma's with a window
# and Sq < Skv; then decode (64-row blocks, the keys split) at gemma3's
# local ring and recurrentgemma's cache, with per-slot kv_len.
D256_FWD = [(2, 4, 1, 300, 300, 256, True, 0),
            (1, 10, 1, 200, 260, 256, True, 64)]
D256_DECODE = [(4, 4, 1, 512, (512, 300, 77, 1)),
               (4, 10, 1, 1024, (601, 734, 867, 1000))]
# The new models' attention at their full shapes: llama-3.2-vision-11b's
# cross layers (batch 2 x 2048 text rows against 1601 image rows, no mask,
# GQA 32/8 at D 128; 1601 = 25 key tiles of 64 and one of 1) and
# musicgen-large's train step (MHA 32/32 at D 64, G 1); then their decode
# shapes: one row a slot against the 1601 image rows (no kv_len: the keys
# split over blocks) and musicgen's cache with per-slot kv_len.
MODEL_TRAIN = [(2, 32, 8, 2048, 1601, 128, False, 0),
               (2, 32, 32, 2048, 2048, 64, True, 0)]
MODEL_DECODE = [(4, 32, 8, 1601, 128, False, None),
                (4, 32, 32, 256, 64, True, (33, 100, 201, 256))]
# Each gradient within this share of its largest magnitude: f32 sums the
# same products in another order; bf16 rounds dq/dk/dv once on both sides,
# and the tensor-core variants also round P and dS to bf16 as operands.
BWD_REL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _flash_bwd_case(b, hq, hkv, sq, skv, d, causal, window, dtype, device):
    q, k, v = _qkv(b, hq, hkv, sq, skv, d, dtype, device)
    rng = np.random.default_rng(1)
    do = torch.from_numpy(rng.standard_normal((b, hq, sq, d),
                                              dtype=np.float32)).to(
        device=device, dtype=dtype)
    out, lse = fa._forward(q, k, v, causal, window, None, save_lse=True)
    return q, k, v, out, lse, do


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,window", BWD_SHAPES)
def test_flash_backward_matches_plain(cuda, b, hq, hkv, sq, skv, d, causal,
                                      window, dtype):
    q, k, v, out, lse, do = _flash_bwd_case(b, hq, hkv, sq, skv, d, causal,
                                            window, dtype, cuda)
    planned = fa.plan_backward(b, hq, hkv, sq, skv, d, dtype)["variant"]
    before = dict(fa.flash_attention_bwd.variant_launches)
    grads = fa.flash_attention_bwd(q, k, v, out, lse, do, causal=causal,
                                   window=window)
    torch.cuda.synchronize()
    assert fa.flash_attention_bwd.variant_launches == dict(
        before, **{planned: before[planned] + 1})
    expect = ref.flash_backward_reference(q, k, v, out, lse, do,
                                          causal=causal, window=window)
    for name, g, e in zip("qkv", grads, expect):
        assert g.dtype == dtype and torch.isfinite(g).all(), name
        err = (g.float() - e.float()).abs().max().item()
        assert err <= BWD_REL[dtype] * e.float().abs().max().item(), \
            (name, err)


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,window", BWD_SHAPES)
def test_flash_backward_simt_matches_plain_in_bf16(cuda, monkeypatch, b, hq,
                                                   hkv, sq, skv, d, causal,
                                                   window):
    """bf16 on the CUDA-core backward (the design before ``mma``)."""
    monkeypatch.setattr(fa, "plan_backward", lambda *shape: (
        fa.backward_schedule("simt", *shape[:6])))
    before = fa.flash_attention_bwd.variant_launches["simt"]
    test_flash_backward_matches_plain(cuda, b, hq, hkv, sq, skv, d, causal,
                                      window, torch.bfloat16)
    assert fa.flash_attention_bwd.variant_launches["simt"] == before + 1


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,window", BWD_SHAPES_D64)
def test_flash_backward_mma_matches_plain_in_bf16(cuda, monkeypatch, b, hq,
                                                  hkv, sq, skv, d, causal,
                                                  window):
    """bf16 on the ``mma`` backward (the design before ``wgmma``), which
    ``chip_smoke.py`` times beside it."""
    monkeypatch.setattr(fa, "plan_backward", lambda *shape: (
        fa.backward_schedule("mma", *shape[:6])))
    before = fa.flash_attention_bwd.variant_launches["mma"]
    test_flash_backward_matches_plain(cuda, b, hq, hkv, sq, skv, d, causal,
                                      window, torch.bfloat16)
    assert fa.flash_attention_bwd.variant_launches["mma"] == before + 1


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,window", BWD_SHAPES_TC)
def test_flash_backward_wgmma_repeats_its_bits(cuda, b, hq, hkv, sq, skv, d,
                                               causal, window):
    """bf16 at D 64, 128 and 256 runs the ``wgmma`` backward, and a second
    call gives the same bits: every partial is summed in one fixed order,
    the head columns split over two warpgroups at D 128 and 256 included."""
    args = _flash_bwd_case(b, hq, hkv, sq, skv, d, causal, window,
                           torch.bfloat16, cuda)
    before = fa.flash_attention_bwd.variant_launches["wgmma"]
    one = fa.flash_attention_bwd(*args, causal=causal, window=window)
    two = fa.flash_attention_bwd(*args, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fa.flash_attention_bwd.variant_launches["wgmma"] == before + 2
    assert all(torch.equal(x, y) for x, y in zip(one, two))


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,window", D256_FWD)
def test_flash_forward_d256_wgmma_matches_plain(cuda, b, hq, hkv, sq, skv, d,
                                                causal, window):
    """bf16 D 256 forwards run ``wgmma`` (without the LSE, where the plan
    may split the keys, and with it, where it never does), match the plain
    version and repeat their bits."""
    q, k, v = _qkv(b, hq, hkv, sq, skv, d, torch.bfloat16, cuda)
    before = fa.flash_attention.variant_launches["wgmma"]
    out = flash_attention(q, k, v, causal=causal, window=window)
    out2 = flash_attention(q, k, v, causal=causal, window=window)
    with_lse, lse = fa._forward(q, k, v, causal, window, None,
                                save_lse=True)
    again, lse2 = fa._forward(q, k, v, causal, window, None, save_lse=True)
    torch.cuda.synchronize()
    assert fa.flash_attention.variant_launches["wgmma"] == before + 4
    assert torch.equal(out, out2) and torch.equal(with_lse, again)
    assert torch.equal(lse, lse2)
    want, want_lse = ref.flash_reference_lse(q, k, v, causal=causal,
                                             window=window)
    for got in (out, with_lse):
        torch.testing.assert_close(got.float(), want.float(),
                                   **TOL[torch.bfloat16])
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,hq,hkv,skv,lens", D256_DECODE)
def test_flash_decode_d256_wgmma_matches_plain(cuda, b, hq, hkv, skv, lens):
    """bf16 D 256 decode with per-slot kv_len runs ``wgmma`` with the keys
    split over blocks, matches the plain version and repeats its bits; K/V
    rows past kv_len hold NaN, which the kernel never lets into P.V."""
    q, k, v = _qkv(b, hq, hkv, 1, skv, 256, torch.bfloat16, cuda)
    kv_len = torch.tensor(lens, dtype=torch.int32, device=cuda)
    past = (torch.arange(skv, device=cuda)[None, :]
            >= kv_len[:, None])[:, None, :, None]
    p = fa.plan(b, hq, hkv, 1, skv, 256, torch.bfloat16)
    assert p["variant"] == "wgmma" and p["kv_splits"] > 1
    before = fa.flash_attention.variant_launches["wgmma"]
    kn, vn = k.masked_fill(past, float("nan")), v.masked_fill(past,
                                                              float("nan"))
    one = flash_attention(q, kn, vn, kv_len=kv_len)
    two = flash_attention(q, kn, vn, kv_len=kv_len)
    torch.cuda.synchronize()
    assert fa.flash_attention.variant_launches["wgmma"] == before + 2
    assert torch.equal(one, two) and torch.isfinite(one).all()
    want = ref.flash_reference(q, k.masked_fill(past, 0),
                               v.masked_fill(past, 0), kv_len=kv_len)
    torch.testing.assert_close(one.float(), want.float(),
                               **TOL[torch.bfloat16])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,window", MODEL_TRAIN)
def test_model_train_shapes_match_plain(cuda, b, hq, hkv, sq, skv, d, causal,
                                        window, dtype):
    """The forward with the LSE and the backward at the vision cross
    layers' and musicgen's train shapes, on their planned variants
    (``wgmma`` in bf16, ``simt`` in f32), against the plain versions, and
    a second call's bits."""
    want = "wgmma" if dtype == torch.bfloat16 else "simt"
    assert fa.plan(b, hq, hkv, sq, skv, d, dtype,
                   save_lse=True)["variant"] == want
    assert fa.plan_backward(b, hq, hkv, sq, skv, d, dtype)["variant"] == want
    q, k, v, out, lse, do = _flash_bwd_case(b, hq, hkv, sq, skv, d, causal,
                                            window, dtype, cuda)
    again, lse2 = fa._forward(q, k, v, causal, window, None, save_lse=True)
    assert torch.equal(out, again) and torch.equal(lse, lse2)
    want_out, want_lse = ref.flash_reference_lse(q, k, v, causal=causal,
                                                 window=window)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(out.float(), want_out.float(), **TOL[dtype])
    del again, lse2, want_out, want_lse
    before = fa.flash_attention_bwd.variant_launches[want]
    grads = fa.flash_attention_bwd(q, k, v, out, lse, do, causal=causal,
                                   window=window)
    two = fa.flash_attention_bwd(q, k, v, out, lse, do, causal=causal,
                                 window=window)
    torch.cuda.synchronize()
    assert fa.flash_attention_bwd.variant_launches[want] == before + 2
    assert all(torch.equal(x, y) for x, y in zip(grads, two))
    expect = ref.flash_backward_reference(q, k, v, out, lse, do,
                                          causal=causal, window=window)
    for name, g, e in zip("qkv", grads, expect):
        assert g.dtype == dtype and torch.isfinite(g).all(), name
        err = (g.float() - e.float()).abs().max().item()
        assert err <= BWD_REL[dtype] * e.float().abs().max().item(), \
            (name, err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,skv,d,causal,lens", MODEL_DECODE)
def test_model_decode_shapes_match_plain(cuda, b, hq, hkv, skv, d, causal,
                                         lens, dtype):
    """One decode row a slot: the vision cross call against every image
    row (no mask) and musicgen's per-slot cache (G 1: one live row of a
    64-row block), on the planned variant, against the plain version, and
    a second call's bits."""
    q, k, v = _qkv(b, hq, hkv, 1, skv, d, dtype, cuda)
    kv_len = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                    device=cuda)
    want = "wgmma" if dtype == torch.bfloat16 else "simt"
    assert fa.plan(b, hq, hkv, 1, skv, d, dtype)["variant"] == want
    before = fa.flash_attention.variant_launches[want]
    one = flash_attention(q, k, v, causal=causal, kv_len=kv_len)
    two = flash_attention(q, k, v, causal=causal, kv_len=kv_len)
    torch.cuda.synchronize()
    assert fa.flash_attention.variant_launches[want] == before + 2
    assert torch.equal(one, two)
    expect = ref.flash_reference(q, k, v, causal=causal, kv_len=kv_len)
    torch.testing.assert_close(one.float(), expect.float(), **TOL[dtype])


@pytest.mark.parametrize("variant,tiles", [("simt", (64, 32)),
                                           ("mma", (64, 64)),
                                           ("wgmma", (64, 32)),
                                           ("wgmma", (32, 32))])
def test_flash_backward_refuses_another_schedule(cuda, monkeypatch, variant,
                                                 tiles):
    """The kernels check the wrapper's tiles against their own: a schedule
    the Python side changed alone is refused, and nothing is counted.  The
    ``wgmma`` rows ask for the ``mma`` and the ``simt`` tiles under the
    ``wgmma`` variant number."""
    q, k, v, out, lse, do = _flash_bwd_case(1, 14, 2, 100, 100, 64, True, 0,
                                            torch.bfloat16, cuda)
    monkeypatch.setitem(fa.BWD_TILES, variant, tiles)
    monkeypatch.setattr(fa, "plan_backward", lambda *shape: (
        fa.backward_schedule(variant, *shape[:6])))
    before = fa.flash_attention_bwd.launches
    with pytest.raises(RuntimeError, match=variant):
        fa.flash_attention_bwd(q, k, v, out, lse, do, causal=True)
    assert fa.flash_attention_bwd.launches == before


@pytest.mark.parametrize("fault", ["misaligned q", "misaligned dk",
                                   "scratch too small"])
def test_flash_backward_entry_refuses(cuda, fault):
    """The C entry point of the ``wgmma`` backward refuses bases TMA cannot
    take (not 16-byte aligned) and a scratch smaller than its schedule's,
    rather than running on them."""
    q, k, v, out, lse, do = _flash_bwd_case(1, 14, 2, 100, 100, 64, True, 0,
                                            torch.bfloat16, cuda)
    p = fa.plan_backward(1, 14, 2, 100, 100, 64, torch.bfloat16)
    assert p["variant"] == "wgmma"
    grads = [torch.empty(t.numel() + 8, dtype=t.dtype, device=cuda)
             for t in (q, k, v)]
    scratch = torch.empty(p["scratch_floats"], dtype=torch.float32,
                          device=cuda)
    ptr = {"q": q.data_ptr(), "dk": grads[1].data_ptr(),
           "n": p["scratch_floats"]}
    if fault == "misaligned q":
        ptr["q"] += 8
    elif fault == "misaligned dk":
        ptr["dk"] += 2
    else:
        ptr["n"] -= 1
    lib = _build.load("flash_attention_bwd", fa._BWD_SIGNATURES)
    err = lib.flash_attention_bwd(
        ptr["q"], k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        do.data_ptr(), grads[0].data_ptr(), ptr["dk"], grads[2].data_ptr(),
        scratch.data_ptr(), ptr["n"], 1, 14, 2, 100, 100, 64, 1, 1, 0,
        fa.BWD_VARIANTS["wgmma"], p["block"], p["step"], p["dp"], 0.0,
        torch.cuda.current_stream(cuda).cuda_stream)
    torch.cuda.synchronize()
    assert err != 0
    assert "invalid argument" in lib.repro_cuda_error_string(err).decode()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,window", BWD_SHAPES)
def test_flash_forward_lse_matches_plain(cuda, b, hq, hkv, sq, skv, d,
                                         causal, window, dtype):
    """The LSE a train forward saves (f32 on both variants, never split),
    and its output, against ``ref.flash_reference_lse``."""
    q, k, v, out, lse, _ = _flash_bwd_case(b, hq, hkv, sq, skv, d, causal,
                                           window, dtype, cuda)
    want_out, want_lse = ref.flash_reference_lse(q, k, v, causal=causal,
                                                 window=window)
    assert lse.dtype == torch.float32 and lse.shape == (b, hq, sq)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(out.float(), want_out.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_is_deterministic(cuda, dtype):
    """No atomics: two calls at qwen2's train heads give the same bits."""
    args = _flash_bwd_case(2, 14, 2, 512, 512, 64, True, 0, dtype, cuda)
    one = fa.flash_attention_bwd(*args, causal=True)
    two = fa.flash_attention_bwd(*args, causal=True)
    assert all(torch.equal(a, b) for a, b in zip(one, two))


@pytest.mark.parametrize("hq,hkv", [(32, 8), (9, 3)])
def test_flash_backward_is_deterministic_at_new_gqa_ratios(cuda, hq, hkv):
    """Two bf16 calls at llama3.2-1b's (G 4) and smollm-135m's (G 3) heads
    give the same bits: the G partials are summed in head order."""
    args = _flash_bwd_case(2, hq, hkv, 512, 512, 64, True, 0,
                           torch.bfloat16, cuda)
    assert fa.plan_backward(2, hq, hkv, 512, 512, 64,
                            torch.bfloat16)["variant"] == "wgmma"
    one = fa.flash_attention_bwd(*args, causal=True)
    two = fa.flash_attention_bwd(*args, causal=True)
    assert all(torch.equal(a, b) for a, b in zip(one, two))


def test_flash_autograd_on_card(cuda):
    """Autograd through the wrapper on the card: the forward kernel once,
    the backward kernel once, the plain backward's gradients."""
    q, k, v = (t.requires_grad_() for t in _qkv(1, 14, 2, 100, 100, 64,
                                                torch.float32, cuda))
    fwd, bwd = fa.flash_attention.launches, fa.flash_attention_bwd.launches
    out = flash_attention(q, k, v, causal=True)
    do = torch.randn_like(out)
    grads = torch.autograd.grad(out, (q, k, v), do)
    assert (fa.flash_attention.launches, fa.flash_attention_bwd.launches) \
        == (fwd + 1, bwd + 1)
    xs = [t.detach().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(ref.flash_reference(*xs, causal=True), xs, do)
    for g, w in zip(grads, want):
        assert (g - w).abs().max() <= BWD_REL[torch.float32] * w.abs().max()


def test_flash_autograd_bf16_launches_wgmma_backward(cuda):
    """Autograd through the wrapper on a bf16 D-64 call: one ``wgmma``
    backward launch, gradients within ``BWD_REL`` of the plain backward's
    on the same inputs (f32 arithmetic)."""
    q, k, v = (t.requires_grad_() for t in _qkv(2, 14, 2, 256, 256, 64,
                                                torch.bfloat16, cuda))
    before = dict(fa.flash_attention_bwd.variant_launches)
    out = flash_attention(q, k, v, causal=True)
    do = torch.randn_like(out)
    grads = torch.autograd.grad(out, (q, k, v), do)
    assert fa.flash_attention_bwd.variant_launches == dict(
        before, wgmma=before["wgmma"] + 1)
    xs = [t.detach().float().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(ref.flash_reference(*xs, causal=True), xs,
                               do.float())
    for g, w in zip(grads, want):
        assert g.dtype == torch.bfloat16
        err = (g.float() - w).abs().max()
        assert err <= BWD_REL[torch.bfloat16] * w.abs().max(), err


def test_qwen2_two_layer_step_kernel_vs_plain(cuda, monkeypatch):
    """qwen2-0.5b at full width cut to 2 layers, f32: loss and every
    gradient through the flash kernels against the plain path (each leaf
    within 1e-3 in ||d|| / ||g||)."""
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models.params import tree_items
    cfg = configs.get("qwen2-0.5b").replace(n_layers=2, dtype="float32")
    params = M.init_params(cfg, torch.Generator(cuda).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (2, 256), device=cuda,
                           generator=torch.Generator(cuda).manual_seed(1))
    before = fa.flash_attention_bwd.launches
    loss, grads = loss_and_grads(cfg, params, {"tokens": tokens})
    assert fa.flash_attention_bwd.launches == before + cfg.n_layers
    monkeypatch.setattr(ops, "flash_attention", ref.flash_reference)
    p_loss, p_grads = loss_and_grads(cfg, params, {"tokens": tokens})
    assert abs(float(loss) - float(p_loss)) <= 1e-3 * abs(float(p_loss))
    for (path, g), (_, w) in zip(tree_items(grads), tree_items(p_grads)):
        rel = (torch.linalg.vector_norm(g - w)
               / torch.linalg.vector_norm(w)).item()
        assert rel <= 1e-3, (path, rel)
    del params, grads, p_grads
    gc.collect()
    torch.cuda.empty_cache()


@pytest.mark.parametrize("remat,fwd_per_layer", [
    ("none", 1), ("full", 2), ("dots", 2), ("dtr", 2)])
def test_qwen2_smoke_train_step_launches(cuda, remat, fwd_per_layer):
    """One qwen2 smoke train step on the card: each attention layer
    launched the flash forward once (twice under any remat: the group's
    forward runs again in the backward) and the backward once."""
    args = train.parse_args(["--arch", "qwen2-0.5b", "--smoke", "--steps",
                             "1", "--batch", "2", "--seq", "32", "--remat",
                             remat])
    cfg = train.config_from_args(args)
    params = M.init_params(cfg, torch.Generator(cuda).manual_seed(0))

    def reset(step):
        fa.flash_attention.launches = fa.flash_attention_bwd.launches = 0

    res = train.train_loop(cfg, params, args, verbose=False, on_step=reset)
    assert np.isfinite(res.losses[0])
    assert (fa.flash_attention.launches, fa.flash_attention_bwd.launches) \
        == (fwd_per_layer * cfg.n_layers, cfg.n_layers)


# ---------------------------------------------------------------------------
# The eager DTR executor on the card: its budget is made of real bytes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("offload", [False, True])
def test_eager_live_bytes_match_memory_allocated(cuda, offload):
    """A chain of 1 MiB tensors under a 5-tensor budget: after every call
    the caching allocator holds exactly the live tensors (1 MiB is a
    multiple of its 512 B rounding), and every value read back equals the
    same chain at an unbounded budget, bit for bit."""
    from repro_torch.eager import DTRContext
    from repro_torch.offload import OffloadConfig
    n = 1 << 18
    mib = 4 * n
    cfg = OffloadConfig(host_budget=8 * mib, h2d_bandwidth=mib,
                        d2h_bandwidth=mib) if offload else None

    def chain(budget):
        # Contexts of earlier tests die in reference cycles (runtime hooks
        # are the context's bound methods): collect them before the base.
        gc.collect()
        ctx = DTRContext(budget, use_wallclock_cost=False, offload=cfg)
        base = torch.cuda.memory_allocated()
        vals = [ctx.wrap(torch.linspace(0, 1, n, device=cuda))]
        for i in range(20):
            vals.append(ctx.call(f"f{i}", lambda a: torch.cos(a) * 1.01,
                                 [vals[-1]])[0])
            assert torch.cuda.memory_allocated() - base == \
                ctx.live_bytes() <= budget + mib
        return ctx, vals, base

    _, ref, _ = chain(float("inf"))
    ctx, vals, base = chain(5 * mib)
    assert ctx.rt.evictions > 0
    for r, v in zip(ref, vals):
        assert torch.equal(v.value, r.value)
        assert torch.cuda.memory_allocated() - base == ctx.live_bytes()
    if offload:
        assert ctx.rt.offloads > 0 and ctx.rt.fetches > 0
        assert ctx.host_bytes() <= 8 * mib
        assert all(b.is_pinned() for b in ctx.host_buffers.values())
    else:
        assert ctx.remat_runs > 0


def test_eager_context_defaults_to_the_card(cuda):
    from repro_torch.eager import DTRContext
    ctx = DTRContext(float("inf"))
    x = ctx.wrap(np.ones(4, np.float32))
    assert x.value.device.type == "cuda"


@pytest.mark.parametrize("arch", ["llama3.2-1b", "smollm-135m"])
def test_new_configs_smoke_train_step_launches(cuda, arch):
    """One smoke train step of each new config under remat dtr: the flash
    forward twice a layer and the backward once, in f32 on ``simt``."""
    args = train.parse_args(["--arch", arch, "--smoke", "--steps", "1",
                             "--batch", "2", "--seq", "32"])
    cfg = train.config_from_args(args)
    params = M.init_params(cfg, torch.Generator(cuda).manual_seed(0))

    def reset(step):
        fa.flash_attention.launches = fa.flash_attention_bwd.launches = 0

    res = train.train_loop(cfg, params, args, verbose=False, on_step=reset)
    assert np.isfinite(res.losses[0]) and res.actions == ["ok"]
    assert (fa.flash_attention.launches, fa.flash_attention_bwd.launches) \
        == (2 * cfg.n_layers, cfg.n_layers)


def _attention_layers(cfg):
    kinds = list(cfg.pattern) * cfg.n_groups + list(cfg.tail)
    return sum(kind.startswith("attn") for kind in kinds)


@pytest.mark.parametrize("arch", ["gemma3-1b", "recurrentgemma-2b"])
def test_gemma_smoke_train_step_launches(cuda, arch):
    """One smoke train step of each mixed-pattern config under remat dtr:
    the flash forward twice an attention layer (global, local and tail
    alike) and the backward once, in f32 on ``simt``; rglru layers launch
    no kernel."""
    args = train.parse_args(["--arch", arch, "--smoke", "--steps", "1",
                             "--batch", "2", "--seq", "32"])
    cfg = train.config_from_args(args)
    params = M.init_params(cfg, torch.Generator(cuda).manual_seed(0))

    def reset(step):
        fa.flash_attention.launches = fa.flash_attention_bwd.launches = 0
        fa.flash_attention_bwd.variant_launches = dict.fromkeys(
            fa.BWD_VARIANTS, 0)

    res = train.train_loop(cfg, params, args, verbose=False, on_step=reset)
    n = _attention_layers(cfg)
    assert np.isfinite(res.losses[0]) and res.actions == ["ok"]
    assert (fa.flash_attention.launches, fa.flash_attention_bwd.launches) \
        == (2 * n, n)
    assert fa.flash_attention_bwd.variant_launches["simt"] == n


@pytest.mark.parametrize("arch", ["gemma3-1b", "recurrentgemma-2b"])
def test_gemma_smoke_serve_on_card_matches_cpu(cuda, arch):
    """Ring caches of window 8 behind a 32-row max_len and the rglru
    state: the card and the CPU serve the same greedy tokens, under
    admission's preemptions, and every decode step launched flash attention
    once an attention layer."""
    cfg = configs.get_smoke(arch)
    args = serve.parse_args([
        "--arch", arch, "--smoke", "--requests", "8", "--slots", "4",
        "--gen", "8", "--max-len", "32", "--kv-budget", "0.3",
        "--chaos-shrink", "0.5", "--chaos-period", "16"])
    params = M.init_params(cfg, torch.Generator().manual_seed(0))
    on_cpu = serve.serve_loop(cfg, params, args)
    before = flash_attention.launches
    on_card = serve.serve_loop(cfg, tree_map(lambda t: t.to(cuda), params),
                               args)
    assert on_card.completed == on_cpu.completed
    assert on_card.counters == on_cpu.counters
    assert flash_attention.launches - before == \
        on_card.steps * _attention_layers(cfg)


def test_checkpoint_restores_onto_the_card(cuda, tmp_path):
    """Tensors on the card go to the host and come back to the device and
    dtype of ``like``, bf16 bit for bit."""
    from repro_torch.ckpt import restore_latest, save_checkpoint
    from repro_torch.optim import OptState
    g = torch.Generator(cuda).manual_seed(0)
    tree = {"w": torch.randn(64, 32, generator=g, device=cuda),
            "h": torch.randn(7, generator=g, device=cuda).to(torch.bfloat16),
            "opt": OptState(4, {"m": torch.randn(5, generator=g,
                                                 device=cuda)})}
    save_checkpoint(str(tmp_path), 4, tree)
    like = {"w": torch.zeros_like(tree["w"]),
            "h": torch.zeros_like(tree["h"]),
            "opt": OptState(0, {"m": torch.zeros_like(tree["opt"].inner["m"])})}
    step, got, _ = restore_latest(str(tmp_path), like)
    assert step == 4 and got["opt"].step == 4
    for a, b in ((got["w"], tree["w"]), (got["opt"].inner["m"],
                                         tree["opt"].inner["m"])):
        assert a.device == b.device and torch.equal(a, b)
    assert got["h"].dtype == torch.bfloat16 and got["h"].is_cuda
    assert torch.equal(got["h"].view(torch.int16), tree["h"].view(torch.int16))


def test_device_memory_reads_the_caching_allocator(cuda):
    """The launcher's telemetry on the card: the peak, and a largest free
    block no larger than the free bytes."""
    x = torch.empty(1 << 20, device=cuda)
    peak, frag = train.device_memory(torch.device(cuda))
    assert peak >= x.numel() * 4 and frag is not None
    assert frag.used >= x.numel() * 4 and frag.capacity > frag.used
    assert 0 < frag.largest_free <= frag.free
    assert 0.0 <= frag.frag_ratio < 1.0


# Attention-logit soft-capping: every flash variant with a cap of 2, which
# bends the N(0, 1) logits of these inputs, against its plain version at
# the uncapped tolerances (TOL, BWD_REL).
SOFTCAP = 2.0
SOFTCAP_FWD = [  # (b, hq, hkv, sq, skv, d, causal, window, variant, kv_len)
    (2, 4, 2, 100, 100, 64, True, 0, "simt", None),
    (2, 14, 2, 130, 130, 64, True, 0, "wgmma", None),
    (2, 8, 2, 130, 130, 128, True, 17, "wgmma", None),
    (1, 8, 1, 200, 200, 256, True, 0, "wgmma", None),       # two warpgroups
    (2, 8, 8, 100, 77, 128, False, 0, "wgmma", None),       # cross
    (4, 14, 2, 1, 200, 64, True, 0, "wgmma", (1, 37, 200, 90)),  # split keys
    (4, 4, 1, 1, 1024, 256, True, 0, "wgmma", (601, 750, 900, 1000)),
]
SOFTCAP_BWD = [  # (b, hq, hkv, sq, skv, d, causal, window, variant)
    (2, 4, 2, 100, 100, 64, True, 0, "simt"),
    (2, 4, 2, 130, 130, 64, True, 0, "mma"),
    (2, 4, 2, 130, 130, 64, True, 0, "wgmma"),
    (2, 8, 2, 130, 130, 128, True, 0, "wgmma"),
    (1, 4, 1, 200, 200, 256, True, 64, "wgmma"),
    (2, 8, 8, 100, 77, 128, False, 0, "wgmma"),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,window,variant,lens",
                         SOFTCAP_FWD)
def test_softcap_forward_matches_plain(cuda, b, hq, hkv, sq, skv, d, causal,
                                       window, variant, lens, dtype):
    """The capped forward (with the LSE where no key split) on ``variant``
    in bf16 (a bf16 ``simt`` case is forced there by an unaligned plan) and
    on ``simt`` in f32."""
    q, k, v = _qkv(b, hq, hkv, sq, skv, d, dtype, cuda)
    kv_len = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                    device=cuda)
    want = variant if dtype == torch.bfloat16 else "simt"
    plan = fa.plan
    if want == "simt":
        fa.plan = lambda *a, **kw: plan(*a, **dict(kw, aligned=False))
    try:
        before = fa.flash_attention.variant_launches[want]
        out, lse = fa._forward(q, k, v, causal, window, kv_len,
                               save_lse=lens is None, softcap=SOFTCAP)
        torch.cuda.synchronize()
    finally:
        fa.plan = plan
    assert fa.flash_attention.variant_launches[want] == before + 1
    exp, exp_lse = ref.flash_reference_lse(q, k, v, causal=causal,
                                           window=window, kv_len=kv_len,
                                           softcap=SOFTCAP)
    torch.testing.assert_close(out.float(), exp.float(), **TOL[dtype])
    if lse is not None:
        torch.testing.assert_close(lse, exp_lse, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,window,variant",
                         SOFTCAP_BWD)
def test_softcap_backward_matches_plain(cuda, b, hq, hkv, sq, skv, d,
                                        causal, window, variant, dtype):
    """The capped backward (dS times 1 - (S'/c)^2) on ``variant`` in bf16
    and ``simt`` in f32, from the plain forward's output and capped LSE,
    each gradient within ``BWD_REL`` of its max|.|."""
    q, k, v = _qkv(b, hq, hkv, sq, skv, d, dtype, cuda)
    do = torch.randn(q.shape, device=cuda).to(dtype)
    out, lse = ref.flash_reference_lse(q, k, v, causal=causal, window=window,
                                       softcap=SOFTCAP)
    want = variant if dtype == torch.bfloat16 else "simt"
    schedule = fa.plan_backward
    fa.plan_backward = lambda *s: fa.backward_schedule(want, *s[:6])
    try:
        before = fa.flash_attention_bwd.variant_launches[want]
        grads = fa.flash_attention_bwd(q, k, v, out, lse, do, causal=causal,
                                       window=window, softcap=SOFTCAP)
        torch.cuda.synchronize()
    finally:
        fa.plan_backward = schedule
    assert fa.flash_attention_bwd.variant_launches[want] == before + 1
    expect = ref.flash_backward_reference(q, k, v, out, lse, do,
                                          causal=causal, window=window,
                                          softcap=SOFTCAP)
    for name, g, e in zip("qkv", grads, expect):
        assert torch.isfinite(g).all(), name
        err = (g.float() - e.float()).abs().max().item()
        assert err <= BWD_REL[dtype] * e.float().abs().max().item(), \
            (name, err)


def test_softcap_model_on_card_matches_cpu(cuda):
    """gemma3-1b smoke with ``logit_softcap`` 0.5: the card (capped
    kernels) and the CPU (capped plain versions) give the same logits
    within 1e-4 and the same loss within 1e-5."""
    from repro_torch.launch.steps import loss_and_grads
    cfg = configs.get_smoke("gemma3-1b").replace(logit_softcap=0.5)
    params = M.init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 16)).astype(np.int32))
    on_card = tree_map(lambda t: t.to(cuda), params)
    want = M.forward(cfg, params, toks)
    got = M.forward(cfg, on_card, toks.to(cuda))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    loss, _ = loss_and_grads(cfg, params, {"tokens": toks})
    loss_c, _ = loss_and_grads(cfg, on_card, {"tokens": toks.to(cuda)})
    torch.testing.assert_close(loss_c.cpu(), loss, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,skv,d,lens,softcap", [
    # qwen2-0.5b's local shard of its decode_32k cache: split keys, slots
    # past the shard (kv_len 0)
    (8, 14, 2, 2048, 64, (0, 1, 700, 2048, 0, 1500, 64, 2047), 0.0),
    # gemma3-1b's global shard, D 256, capped
    (4, 4, 1, 2048, 256, (0, 1, 1000, 2048), 0.5),
    # 64 slots: 128 blocks, no split
    (64, 14, 2, 512, 64, (0, 1, 300, 512) * 16, 0.0),
])
def test_lse_decode_matches_plain_and_empty_rows_are_finite(
        cuda, b, hq, hkv, skv, d, lens, softcap, dtype):
    """``flash_attention_lse`` (a decode call whose LSE a split-KV merge
    reads; its launches count on it alone): out and LSE as
    ``flash_reference_lse``'s on the rows that see a key (LSE within
    1e-4); a row that sees none gives zeros and -inf, no NaN; a second
    call's bits equal."""
    q, k, v = _qkv(b, hq, hkv, 1, skv, d, dtype, cuda)
    kv_len = torch.tensor(lens, dtype=torch.int32, device=cuda)
    before = (fa.flash_attention.launches, fa.flash_attention_lse.launches)
    out, lse = fa.flash_attention_lse(q, k, v, kv_len=kv_len,
                                      softcap=softcap)
    again = fa.flash_attention_lse(q, k, v, kv_len=kv_len, softcap=softcap)
    torch.cuda.synchronize()
    assert (fa.flash_attention.launches,
            fa.flash_attention_lse.launches) == (before[0], before[1] + 2)
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    want, want_lse = ref.flash_reference_lse(q, k, v, kv_len=kv_len,
                                             softcap=softcap)
    seen = kv_len > 0
    np.testing.assert_allclose(out[seen].float().cpu().numpy(),
                               want[seen].float().cpu().numpy(), **TOL[dtype])
    np.testing.assert_allclose(lse[seen].cpu().numpy(),
                               want_lse[seen].cpu().numpy(), rtol=0,
                               atol=1e-4)
    assert (out[~seen] == 0).all() and torch.isneginf(lse[~seen]).all()
    assert torch.isfinite(out).all() and not torch.isnan(lse).any()


def test_split_kv_merge_on_card_matches_the_whole_call(cuda):
    """qwen2-0.5b's decode cache at 4096 rows cut into 8 shards, each
    through the kernel and merged (``ops.merge_attention``), against the
    unsplit kernel call, bf16."""
    from repro_torch.kernels import ops
    q, k, v = _qkv(8, 14, 2, 1, 4096, 64, torch.bfloat16, cuda)
    kv_len = torch.tensor((1, 600, 1500, 2048, 3000, 4096, 100, 2500),
                          dtype=torch.int32, device=cuda)
    qm, km, vm = (t.transpose(1, 2) for t in (q, k, v))
    n = 512
    parts = [ops.attention_lse(qm, km[:, r * n:(r + 1) * n],
                               vm[:, r * n:(r + 1) * n],
                               kv_len=ops.shard_kv_len(kv_len, r, n))
             for r in range(8)]
    out, _ = ops.merge_attention(torch.stack([o for o, _ in parts]),
                                 torch.stack([l_ for _, l_ in parts]))
    whole = ops.attention(qm, km, vm, kv_len=kv_len)
    torch.cuda.synchronize()
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               whole.float().cpu().numpy(),
                               **TOL[torch.bfloat16])
