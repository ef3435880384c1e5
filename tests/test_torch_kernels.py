"""The port's flash attention against the JAX package's, on the same inputs.

Inputs are made from a seed with numpy and handed to both packages.  On the
CPU the port's wrapper runs its plain version; the kernel itself runs only
on a CUDA card (``tests/test_torch_cuda.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as pallas_flash  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402

# The JAX package's tolerances for its own kernel (tests/test_kernels.py):
# f32 differs only in summation order; bf16 adds one rounding of the output.
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# tests/test_kernels.py's sweep: (b, hq, hkv, sq, skv, d, causal, window)
SHAPES = [
    (1, 2, 2, 128, 128, 64, True, 0),      # MHA causal
    (2, 4, 2, 128, 128, 64, True, 0),      # GQA
    (1, 8, 1, 256, 256, 64, True, 0),      # MQA
    (2, 2, 2, 128, 128, 64, False, 0),     # bidirectional
    (1, 2, 2, 256, 256, 64, True, 64),     # sliding window
    (1, 2, 2, 64, 256, 64, True, 0),       # kv longer than q (prefix)
    (1, 2, 2, 96, 96, 32, True, 0),        # non-multiple of block
    (1, 2, 2, 128, 128, 128, True, 0),     # wide head
]


def _qkv(b, hq, hkv, sq, skv, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, sq, d), dtype=np.float32),
            rng.standard_normal((b, hkv, skv, d), dtype=np.float32),
            rng.standard_normal((b, hkv, skv, d), dtype=np.float32))


def _torch(xs, dtype):
    return [torch.from_numpy(x).to(TDT[dtype]) for x in xs]


def _jax(xs, dtype):
    return [jnp.asarray(x).astype(JDT[dtype]) for x in xs]


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,window", SHAPES)
def test_plain_matches_jax_reference(b, hq, hkv, sq, skv, d, causal, window,
                                     dtype):
    xs = _qkv(b, hq, hkv, sq, skv, d)
    out = ref.flash_reference(*_torch(xs, dtype), causal=causal,
                              window=window)
    expect = jref.flash_reference(*_jax(xs, dtype), causal=causal,
                                  window=window)
    assert out.dtype == TDT[dtype]
    np.testing.assert_allclose(_f32(out), _f32(expect), **TOL[dtype])


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,window",
                         [SHAPES[1], SHAPES[4], SHAPES[6]])
def test_plain_matches_pallas_interpret(b, hq, hkv, sq, skv, d, causal,
                                        window):
    xs = _qkv(b, hq, hkv, sq, skv, d, seed=1)
    out = ref.flash_reference(*_torch(xs, "float32"), causal=causal,
                              window=window)
    expect = pallas_flash(*_jax(xs, "float32"), causal=causal, window=window,
                          block_q=64, block_k=64, interpret=True)
    np.testing.assert_allclose(_f32(out), _f32(expect), **TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,causal,window,lens", [
    (1, True, 0, (1, 37, 128, 90)),        # per-slot decode
    (9, True, 0, (9, 50, 17)),             # chunk of queries per row
    (9, True, 5, (20, 50, 9)),             # with a sliding window
    (4, False, 0, (1, 64, 33)),            # bidirectional, padding only
])
def test_kv_len_matches_reference_on_sliced_kv(sq, causal, window, lens,
                                               dtype):
    """Row b with kv_len L is the JAX reference on k[b,:,:L], v[b,:,:L]."""
    skv = max(lens)
    q, k, v = _qkv(len(lens), 4, 2, sq, skv, 64, seed=2)
    kv_len = torch.tensor(lens, dtype=torch.int32)
    out = ref.flash_reference(*_torch((q, k, v), dtype), causal=causal,
                              window=window, kv_len=kv_len)
    for row, n in enumerate(lens):
        part = (q[row:row + 1], k[row:row + 1, :, :n], v[row:row + 1, :, :n])
        expect = jref.flash_reference(*_jax(part, dtype), causal=causal,
                                      window=window)
        np.testing.assert_allclose(_f32(out[row:row + 1]), _f32(expect),
                                   **TOL[dtype])


def test_wrapper_takes_plain_version_for_cpu_tensors():
    q, k, v = _torch(_qkv(2, 4, 2, 16, 16, 8), "float32")
    before = flash_attention.launches
    out = flash_attention(q, k, v)
    assert flash_attention.launches == before   # no kernel launched
    torch.testing.assert_close(out, ref.flash_reference(q, k, v),
                               rtol=0, atol=0)


@pytest.mark.parametrize("case", ["head_dim_12", "head_dim_264", "dtypes",
                                  "float16", "grad", "kv_len_dtype",
                                  "causal_sq_gt_skv", "gqa", "window"])
def test_wrapper_rejects(case):
    q, k, v = _torch(_qkv(2, 4, 2, 8, 8, 16), "float32")
    kw = {}
    if case == "head_dim_12":
        q, k, v = _torch(_qkv(1, 2, 2, 8, 8, 12), "float32")
    elif case == "head_dim_264":
        q, k, v = _torch(_qkv(1, 2, 2, 8, 8, 264), "float32")
    elif case == "dtypes":
        k = k.to(torch.bfloat16)
    elif case == "float16":
        q, k, v = (t.half() for t in (q, k, v))
    elif case == "grad":
        q.requires_grad_(True)
    elif case == "kv_len_dtype":
        kw["kv_len"] = torch.tensor([3, 4], dtype=torch.int64)
    elif case == "causal_sq_gt_skv":
        q, k, v = _torch(_qkv(1, 2, 2, 16, 8, 16), "float32")
    elif case == "gqa":
        q, k, v = _torch(_qkv(1, 3, 2, 8, 8, 16), "float32")
    elif case == "window":
        kw["window"] = -1
    with pytest.raises((ValueError, TypeError, RuntimeError)):
        flash_attention(q, k, v, **kw)


def test_ops_attention_matches_jax_adapter():
    rng = np.random.default_rng(3)
    b, s, h, kv, d = 2, 40, 4, 2, 32
    q = rng.standard_normal((b, s, h, d), dtype=np.float32)
    k = rng.standard_normal((b, s, kv, d), dtype=np.float32)
    v = rng.standard_normal((b, s, kv, d), dtype=np.float32)
    out = ops.attention(*map(torch.from_numpy, (q, k, v)))
    expect = jops.attention(*map(jnp.asarray, (q, k, v)), use_kernel=False)
    assert out.shape == (b, s, h, d)
    np.testing.assert_allclose(_f32(out), _f32(expect), **TOL["float32"])


@pytest.mark.parametrize("window", [8, 33])
def test_ops_attention_window_matches_jax_adapter(window):
    rng = np.random.default_rng(4)
    b, s, h, kv, d = 2, 40, 4, 2, 32
    q = rng.standard_normal((b, s, h, d), dtype=np.float32)
    k = rng.standard_normal((b, s, kv, d), dtype=np.float32)
    v = rng.standard_normal((b, s, kv, d), dtype=np.float32)
    out = ops.attention(*map(torch.from_numpy, (q, k, v)), window=window)
    expect = jops.attention(*map(jnp.asarray, (q, k, v)), window=window,
                            use_kernel=False)
    np.testing.assert_allclose(_f32(out), _f32(expect), **TOL["float32"])
    unwindowed = ops.attention(*map(torch.from_numpy, (q, k, v)))
    assert not torch.allclose(out, unwindowed)
