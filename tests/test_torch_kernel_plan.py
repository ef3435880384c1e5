"""The kernels' launch plans and the split-kv arithmetic, on the CPU.

Each wrapper decides before a launch, from dtype, shape and alignment alone,
which kernel variant runs and with which tiles or spans (``plan``).  These tests pin
what the card will run on the main paths.  The split-kv schedule of the
``wgmma`` flash kernel, written out in plain PyTorch (``split_reference``),
is checked against the JAX package's reference, inputs made from a seed
with numpy.
"""
import math
from typing import Optional

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import moe_gemm as mg  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import rwkv6_chunk as wkv  # noqa: E402

BF16, F32 = torch.bfloat16, torch.float32
# Split partials and their combine differ from one softmax only in f32
# summation order and exp of a shifted argument.
SPLIT_TOL = dict(rtol=2e-5, atol=2e-5)


def split_reference(q, k, v, *, causal: bool = True, window: int = 0,
                    kv_len: Optional[torch.Tensor] = None, splits: int = 1,
                    block_q: int = 64, block_kv: int = 64) -> torch.Tensor:
    """The split-kv schedule of the ``wgmma`` flash kernel, in plain
    PyTorch: the function of ``ref.flash_reference``, computed as the
    kernel's blocks compute it.

    The rows of one (b, kv head) are ordered (query position, head within
    the group) and cut into tiles of ``block_q``.  Each tile's visible keys
    (``block_kv`` tiles, cut by the causal diagonal, the window and
    ``kv_len`` as the kernel cuts them) are divided into ``splits``
    chunks; a chunk gives f32 partials, the row max ``m`` (-inf where it
    sees no key), the row sum ``l`` and the unnormalised output, and the
    combine weighs each chunk by ``exp(m - max m)``.  P is rounded to v's
    dtype before P.V, as the kernel and the Pallas kernel round it.
    """
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    g = hq // hkv
    rows = g * sq
    scale = 1.0 / math.sqrt(d)
    out = torch.zeros(b, hkv, rows, d, dtype=torch.float32, device=q.device)
    for bi in range(b):
        length = skv if kv_len is None else min(max(int(kv_len[bi]), 0), skv)
        offs = length - sq
        for kh in range(hkv):
            # [g, sq, d] -> rows ordered (query position, head in group)
            qr = q[bi, kh * g:(kh + 1) * g].float().transpose(0, 1) \
                .reshape(rows, d)
            kk, vv = k[bi, kh].float(), v[bi, kh].float()
            for r0 in range(0, rows, block_q):
                r1 = min(r0 + block_q, rows)
                qpos = torch.arange(r0, r1, device=q.device) // g + offs
                kv_begin, kv_end = 0, length
                if causal:
                    kv_end = max(0, min(length, (r1 - 1) // g + offs + 1))
                    if window > 0:
                        kv_begin = max(0, r0 // g + offs - window + 1)
                t0 = kv_begin // block_kv
                t1 = -(-kv_end // block_kv) if kv_end > kv_begin else t0
                per = -(-(t1 - t0) // splits)
                parts = []
                for sp in range(splits):
                    a0 = min(t1, t0 + sp * per)
                    a1 = min(t1, a0 + per)
                    keys = torch.arange(min(a0 * block_kv, skv),
                                        min(a1 * block_kv, skv),
                                        device=q.device)
                    s = qr[r0:r1] @ kk[keys].T * scale
                    vis = keys[None, :] < length
                    if causal:
                        vis = vis & (keys[None, :] <= qpos[:, None])
                        if window > 0:
                            vis = vis & (qpos[:, None] - keys[None, :]
                                         < window)
                    s = torch.where(vis, s, -math.inf)
                    m = (s.amax(dim=1) if keys.numel()
                         else torch.full((r1 - r0,), -math.inf,
                                         device=q.device))
                    p = torch.where(torch.isinf(m)[:, None],
                                    torch.zeros_like(s),
                                    torch.exp(s - m[:, None]))
                    vk = torch.where((keys < length)[:, None], vv[keys], 0.0)
                    acc = p.to(v.dtype).float() @ vk
                    parts.append((m, p.sum(dim=1), acc))
                m_all = torch.stack([m for m, _, _ in parts])
                top = m_all.amax(dim=0)
                wts = torch.where(torch.isinf(top)[None, :],
                                  torch.zeros_like(m_all),
                                  torch.exp(m_all - top[None, :]))
                num = sum(w[:, None] * acc
                          for w, (_, _, acc) in zip(wts, parts))
                den = sum(w * l for w, (_, l, _) in zip(wts, parts))
                out[bi, kh, r0:r1] = num / den.clamp_min(1e-20)[:, None]
    out = out.reshape(b, hkv, sq, g, d).transpose(2, 3)
    return out.reshape(b, hq, sq, d).to(q.dtype)


@pytest.mark.parametrize("shape,dtype,aligned,expect", [
    # mixtral-8x7b decode, 4 slots x capacity 8: wi/wg, then wo
    ((8, 32, 4096, 14336), BF16, True, ("wgmma", 32, 128)),
    ((8, 32, 14336, 4096), BF16, True, ("wgmma", 32, 128)),
    # one 2048-token prefill request: capacity 640
    ((8, 640, 4096, 14336), BF16, True, ("wgmma", 128, 128)),
    ((8, 33, 4096, 40), BF16, True, ("wgmma", 64, 128)),   # F = 40
    ((8, 8, 4096, 512), BF16, True, ("wgmma", 32, 128)),   # C = 8
    ((8, 32, 4096, 14336), F32, True, ("simt", 32, 64)),   # f32 stays f32
    ((2, 1, 7, 5), BF16, True, ("simt", 32, 64)),          # d, F odd
    ((3, 40, 200, 72), BF16, False, ("simt", 64, 64)),     # unaligned base
])
def test_moe_gemm_plan(shape, dtype, aligned, expect):
    p = mg.plan(*shape, dtype, aligned=aligned)
    assert (p["variant"], p["block_c"], p["block_f"]) == expect
    assert p["block_d"] == (64 if p["variant"] == "wgmma" else 32)


@pytest.mark.parametrize("shape,dtype,aligned,expect", [
    # mixtral-8x7b train (batch 2 x 2048 folded: C = 1280), wi then wo
    ((8, 1280, 4096, 14336), BF16, True, ("wgmma", 128, 128)),
    ((8, 1280, 14336, 4096), BF16, True, ("wgmma", 128, 128)),
    # deepseek-v3 train (C = 80) and decode (C = 32)
    ((256, 80, 7168, 2048), BF16, True, ("wgmma", 128, 128)),
    ((256, 32, 7168, 2048), BF16, True, ("wgmma", 32, 128)),
    ((5, 33, 48, 40), BF16, True, ("wgmma", 64, 64)),      # d <= 64; C odd
    ((8, 32, 4096, 14336), F32, True, ("simt", None, None)),
    ((2, 1, 7, 5), BF16, True, ("simt", None, None)),      # d, F odd
    ((3, 40, 200, 72), BF16, False, ("simt", None, None)),  # unaligned
])
def test_moe_gemm_backward_plan(shape, dtype, aligned, expect):
    """The backward reads its operands in place on ``wgmma`` (dX blocked
    over C as the forward, dW over d), else runs ``simt`` on copies."""
    p = mg.plan_backward(*shape, dtype, aligned=aligned)
    assert (p["variant"], p.get("block_c"), p.get("block_d")) == expect


@pytest.mark.parametrize("shape,dtype,aligned,expect", [
    # qwen2-0.5b decode: 4 slots, 14/2 heads of 64, a 128-long cache
    ((4, 14, 2, 1, 128, 64), BF16, True, ("wgmma", 1, 2)),
    # mixtral-8x7b decode: 32/8 heads of 128
    ((4, 32, 8, 1, 128, 128), BF16, True, ("wgmma", 1, 2)),
    # prefill of 2048 tokens: 14 x 2048 / 2 rows per kv head, no split
    ((1, 14, 2, 2048, 2048, 64), BF16, True, ("wgmma", 224, 1)),
    ((1, 2, 2, 96, 96, 32), BF16, True, ("wgmma", 2, 2)),  # head dim 32
    ((1, 4, 1, 1, 4096, 64), BF16, True, ("wgmma", 1, 8)),  # split capped
    ((40, 8, 8, 1, 4096, 64), BF16, True, ("wgmma", 1, 1)),  # grid full
    ((4, 14, 2, 1, 128, 64), F32, True, ("simt", 1, 1)),   # f32 stays f32
    ((2, 7, 1, 1, 40, 8), BF16, True, ("simt", 1, 1)),     # smoke head dim
    # widest head: 66 rows, one 128-row block, keys split in two
    ((3, 4, 2, 33, 70, 256), BF16, True, ("wgmma", 1, 2)),
    ((4, 14, 2, 1, 128, 64), BF16, False, ("simt", 1, 1)),  # unaligned
    # 65536 row tiles: more than the grid's y axis holds
    ((1, 64, 1, 65536, 65536, 64), BF16, True, ("simt", 524288, 1)),
    # gemma3-1b's train shape (4/1 heads of 256) and decode (4 slots,
    # local ring and global cache), recurrentgemma-2b's (10/1 heads of
    # 256): bf16 D 256 on wgmma, 128-row blocks (two consumer warpgroups)
    # where a block has more than 64 rows' work, 64-row blocks with the
    # keys split at decode
    ((2, 4, 1, 2048, 2048, 256), BF16, True, ("wgmma", 64, 1)),
    ((4, 4, 1, 1, 512, 256), BF16, True, ("wgmma", 1, 8)),
    ((4, 4, 1, 1, 1024, 256), BF16, True, ("wgmma", 1, 8)),
    ((1, 10, 1, 2048, 2048, 256), BF16, True, ("wgmma", 160, 1)),
    ((4, 10, 1, 1, 1024, 256), BF16, True, ("wgmma", 1, 8)),
    ((2, 4, 1, 2048, 2048, 256), F32, True, ("simt", 1024, 1)),  # f32
    # llama-3.2-vision-11b's cross layers: 2048 text rows against 1601
    # image rows (no mask), GQA 32/8 at D 128; then one decode row a slot
    # against every image row, the keys split four ways
    ((2, 32, 8, 2048, 1601, 128), BF16, True, ("wgmma", 128, 1)),
    ((4, 32, 8, 1, 1601, 128), BF16, True, ("wgmma", 1, 4)),
    # musicgen-large, MHA (G 1) at D 64: its train shape, and decode with
    # one live row a 64-row block, 128 blocks: no split
    ((2, 32, 32, 2048, 2048, 64), BF16, True, ("wgmma", 32, 1)),
    ((4, 32, 32, 1, 1024, 64), BF16, True, ("wgmma", 1, 1)),
])
def test_flash_plan(shape, dtype, aligned, expect):
    p = fa.plan(*shape, dtype, aligned=aligned)
    assert (p["variant"], p["row_tiles"], p["kv_splits"]) == expect
    b, hq, hkv, sq, skv, d = shape
    wide = d == 256 and hq // hkv * sq > 64
    assert (p["block_q"], p["block_kv"]) == (
        ((128 if wide else 64), 64) if p["variant"] == "wgmma" else (8, 32))


@pytest.mark.parametrize("shape,dtype,aligned,expect", [
    # rwkv6-1.6b train: batch 4 x 32 heads over 1024 steps of 64; spans of
    # 128 (forward) and 64 (backward) steps
    ((128, 1024, 64), BF16, True, ("mma", 1024, 2048)),
    ((128, 1024, 64), F32, True, ("simt", 128, 128)),   # f32 stays f32
    ((128, 1024, 64), BF16, False, ("simt", 128, 128)),  # unaligned base
    ((2, 1, 32), BF16, True, ("mma", 2, 2)),            # S 1: one step
    ((3, 37, 64), BF16, True, ("mma", 3, 3)),           # ragged last chunk
    ((8, 32, 32), BF16, True, ("mma", 8, 8)),           # smoke head dim
])
def test_wkv_plan(shape, dtype, aligned, expect):
    p = wkv.plan(*shape, dtype, aligned=aligned)
    assert (p["variant"], p["blocks_fwd"], p["blocks_bwd"]) == expect
    if p["variant"] == "mma":
        assert (p["span_fwd"], p["span_bwd"]) == (128, 64)


def test_wkv_plan_scratch_at_train_shape():
    """Scratch a call at [128,1024,64]: the spans' states and decays, f32:
    17.0 MB forward, 68.2 MB backward (states and adjoints); the serial
    backward's checkpoints every 8 steps took 268 MB."""
    p = wkv.plan(128, 1024, 64, BF16)
    assert 4 * p["scratch_fwd"] == 128 * 8 * (64 * 64 + 64) * 4 == 17039360
    assert 4 * p["scratch_bwd"] == 2 * 128 * 16 * (64 * 64 + 64) * 4 \
        == 68157440
    assert 128 * (1024 // 8) * 64 * 64 * 4 == 268435456


@pytest.mark.parametrize("dtype", [BF16, F32])
def test_wkv_plan_refuses_head_dim_16(dtype):
    with pytest.raises(ValueError, match="head dim 16"):
        wkv.plan(4, 64, 16, dtype)


def _qkv(b, hq, hkv, sq, skv, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, sq, d), dtype=np.float32),
            rng.standard_normal((b, hkv, skv, d), dtype=np.float32),
            rng.standard_normal((b, hkv, skv, d), dtype=np.float32))


def _jax_rows(q, k, v, lens, causal, window):
    """The JAX reference per batch row, on k/v cut to that row's length."""
    return np.concatenate([np.asarray(jref.flash_reference(
        jnp.asarray(q[i:i + 1]), jnp.asarray(k[i:i + 1, :, :n]),
        jnp.asarray(v[i:i + 1, :, :n]), causal=causal, window=window))
        for i, n in enumerate(lens)])


@pytest.mark.parametrize("splits", [1, 2, 3, 4])
@pytest.mark.parametrize("shape,causal,window,lens,block_q,block_kv", [
    # decode with per-row kv_len 1 and full: most chunks see one tile
    ((4, 14, 2, 1, 128, 64), True, 0, (1, 37, 128, 90), 64, 16),
    # kv_len 1 against 4 tiles of 64: chunks 2-4 see no key
    ((2, 8, 2, 1, 256, 32), True, 0, (1, 256), 64, 64),
    # a window: only the tiles inside it are split
    ((1, 4, 1, 1, 256, 32), True, 64, (256,), 64, 32),
    # several query rows per batch row, window and kv_len together
    ((2, 4, 2, 9, 80, 32), True, 5, (20, 80), 8, 16),
    # prefill-shaped, causal, row tiles that start mid-group
    ((1, 6, 2, 40, 40, 32), True, 0, None, 16, 16),
    # bidirectional with padding
    ((2, 4, 2, 5, 64, 16), False, 0, (3, 64), 8, 16),
])
def test_split_kv_matches_jax_reference(shape, causal, window, lens,
                                        block_q, block_kv, splits):
    b, hq, hkv, sq, skv, d = shape
    q, k, v = _qkv(b, hq, hkv, sq, skv, d, seed=5)
    kv_len = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    out = split_reference(
        *map(torch.from_numpy, (q, k, v)), causal=causal, window=window,
        kv_len=kv_len, splits=splits, block_q=block_q, block_kv=block_kv)
    expect = _jax_rows(q, k, v, lens or (skv,) * b, causal, window)
    np.testing.assert_allclose(out.numpy(), expect, **SPLIT_TOL)


def test_split_kv_chunk_with_no_key_has_no_nan():
    """A chunk that no row can see gives m = -inf and weight 0, never NaN;
    a row that sees no key at all writes zeros, as the kernel does."""
    q, k, v = map(torch.from_numpy, _qkv(2, 2, 1, 1, 256, 16, seed=6))
    out = split_reference(
        q, k, v, kv_len=torch.tensor([1, 0], dtype=torch.int32), splits=4,
        block_kv=32)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out[0], v[0, :, :1].expand(2, 1, 16),
                               rtol=0, atol=0)
    assert (out[1] == 0).all()


def test_split_kv_main_path_plan_matches_one_block():
    """qwen2-0.5b decode as the card runs it (the plan's splits and tiles)
    equals the unsplit plain version."""
    p = fa.plan(4, 14, 2, 1, 128, 64, BF16)
    q, k, v = map(torch.from_numpy, _qkv(4, 14, 2, 1, 128, 64, seed=7))
    kv_len = torch.tensor([1, 37, 128, 90], dtype=torch.int32)
    out = split_reference(
        q, k, v, kv_len=kv_len, splits=p["kv_splits"],
        block_q=p["block_q"], block_kv=p["block_kv"])
    torch.testing.assert_close(out, ref.flash_reference(q, k, v,
                                                        kv_len=kv_len),
                               **SPLIT_TOL)


@pytest.mark.parametrize("shape,lens", [
    # gemma3-1b's global decode: 4 slots behind 1024 rows, 8 splits
    ((4, 4, 1, 1, 1024, 256), (601, 734, 867, 1000)),
    # 66 rows in one 128-row block (two consumer warpgroups), 2 splits
    ((3, 4, 2, 33, 70, 256), None),
])
def test_split_kv_d256_plan_matches_one_block(shape, lens):
    """The D 256 ``wgmma`` plans as the card runs them (64-row blocks at
    decode, 128-row blocks above 64 rows, the plan's splits) equal the
    unsplit plain version."""
    p = fa.plan(*shape, BF16)
    assert p["variant"] == "wgmma" and p["kv_splits"] > 1
    q, k, v = map(torch.from_numpy, _qkv(*shape, seed=8))
    kv_len = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    out = split_reference(
        q, k, v, kv_len=kv_len, splits=p["kv_splits"],
        block_q=p["block_q"], block_kv=p["block_kv"])
    torch.testing.assert_close(out, ref.flash_reference(q, k, v,
                                                        kv_len=kv_len),
                               **SPLIT_TOL)


def test_split_kv_cross_decode_plan_matches_one_block():
    """llama-3.2-vision's cross call at decode as the card runs it: no
    mask, 1601 keys (25 tiles of 64 and one of a single key) split four
    ways, equals the unsplit plain version."""
    shape = (4, 32, 8, 1, 1601, 128)
    p = fa.plan(*shape, BF16)
    assert p["variant"] == "wgmma" and p["kv_splits"] == 4
    q, k, v = map(torch.from_numpy, _qkv(*shape, seed=9))
    out = split_reference(q, k, v, causal=False, splits=p["kv_splits"],
                          block_q=p["block_q"], block_kv=p["block_kv"])
    torch.testing.assert_close(out, ref.flash_reference(q, k, v,
                                                        causal=False),
                               **SPLIT_TOL)


@pytest.mark.parametrize("shape,dp,warpgroups,grid_dkdv,grid_dq", [
    # vision's cross layers: 64 q heads x 26 key tiles (the last holds one
    # key), 32 query tiles
    ((2, 32, 8, 2048, 1601, 128), 128, 2, (64, 26), (64, 32)),
    # musicgen's MHA: each kv head's one query head writes the partials
    # the reduce pass sums alone
    ((2, 32, 32, 2048, 2048, 64), 64, 1, (64, 32), (64, 32)),
])
def test_flash_backward_plan_at_the_new_models(shape, dp, warpgroups,
                                               grid_dkdv, grid_dq):
    """bf16 trains both new models on the tensor-core backward: the cross
    call's Sq > Skv and musicgen's G 1 change no tile; the partials hold
    ``B * Hq * Skv * dp`` floats and the reduce grid is built on Skv."""
    b, hq, hkv, sq, skv, d = shape
    p = fa.plan_backward(*shape, BF16)
    assert (p["variant"], p["dp"], p["warpgroups"]) == ("wgmma", dp,
                                                        warpgroups)
    assert (p["grid_dkdv"], p["grid_dq"]) == (grid_dkdv, grid_dq)
    assert p["scratch_floats"] == 2 * b * hq * 2048 + 2 * b * hq * skv * dp
    assert p["grid_reduce"] == -(-b * hkv * skv * dp // (4 * 128))


@pytest.mark.parametrize("shape,dtype,variant,grid_dkdv,grid_dq,scratch", [
    # gemma3-1b: 8 heads x 32 key tiles; the lse and D rows, then 2 x
    # 16.8 MB of f32 partials
    ((2, 4, 1, 2048, 2048, 256), BF16, "wgmma", (8, 32), (8, 32),
     2 * 8 * 2048 + 2 * 8 * 2048 * 256),
    # recurrentgemma-2b: 10 heads, 2 x 21.0 MB of partials
    ((1, 10, 1, 2048, 2048, 256), BF16, "wgmma", (10, 32), (10, 32),
     2 * 10 * 2048 + 2 * 10 * 2048 * 256),
    # f32 stays on the CUDA cores, D per query row as its scratch
    ((2, 4, 1, 2048, 2048, 256), F32, "simt", (64, 2), (64, 8),
     8 * 2048),
    # D 200 is padded to 256 on simt, in bf16 too
    ((1, 2, 1, 40, 40, 200), BF16, "simt", (2, 1), (2, 2), 2 * 40),
])
def test_flash_backward_plan_at_head_dim_256(shape, dtype, variant,
                                             grid_dkdv, grid_dq, scratch):
    """bf16 D 256 trains on the tensor-core backward: 64-key and 64-row
    tiles, the dK/dV work split over the query heads, two warpgroups a
    block splitting the head columns, and each head's f32 partials in its
    scratch; f32 and other head dims on the CUDA cores, 32-key and 32-row
    tiles over the head dim padded to 256."""
    p = fa.plan_backward(*shape, dtype)
    tiles = (64, 64) if variant == "wgmma" else (32, 32)
    assert (p["variant"], (p["block"], p["step"]), p["dp"]) == (
        variant, tiles, 256)
    assert (p["grid_dkdv"], p["grid_dq"]) == (grid_dkdv, grid_dq)
    assert p["scratch_floats"] == scratch
    assert p["split_heads"] == (variant == "wgmma")
    assert p.get("warpgroups") == (2 if variant == "wgmma" else None)


@pytest.mark.parametrize("sq,skv,window", [(2048, 2048, 512),
                                           (2048, 2048, 2048),
                                           (100, 600, 512)])
def test_backward_ranges_are_exact_under_a_window(sq, skv, window):
    """gemma3's local layers (window 512) and recurrentgemma's (2048): for
    every 32-key tile the query range of ``bwd_query_range`` runs from the
    first query that sees a key of the tile to the last, and for every
    32-row tile ``bwd_key_range`` from the first visible key to the last,
    so the simt kernel walks no tile that sees nothing."""
    i = np.arange(sq)[:, None] + (skv - sq)
    j = np.arange(skv)[None, :]
    vis = (j <= i) & (i - j < window)
    for j0 in range(0, skv, 32):
        n = min(32, skv - j0)
        rows = np.nonzero(vis[:, j0:j0 + n].any(1))[0]
        lo, hi = fa.bwd_query_range(j0, n, sq, skv, True, window)
        if len(rows):
            assert (lo, hi) == (rows[0], rows[-1] + 1), j0
        else:             # keys no query sees: an empty walk
            assert hi <= lo, j0
    for i0 in range(0, sq, 32):
        n = min(32, sq - i0)
        keys = np.nonzero(vis[i0:i0 + n].any(0))[0]
        assert fa.bwd_key_range(i0, n, sq, skv, True, window) == (
            keys[0], keys[-1] + 1), i0
