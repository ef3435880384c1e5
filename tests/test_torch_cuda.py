"""The port's CUDA kernel on the card, against its plain version.

Every test here needs a CUDA card: it carries the ``requires_cuda`` marker
and skips inside the test where torch sees none.  Run on the card with

    PYTHONPATH=src python -m pytest -q -m requires_cuda tests/test_torch_cuda.py

This file imports neither JAX nor the JAX package, so it runs where only
the port is installed.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
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
    args = serve.parse_args(["--smoke", "--requests", "6", "--slots", "2",
                             "--gen", "8"])
    params = M.init_params(cfg, torch.Generator().manual_seed(0))
    on_cpu = serve.serve_loop(cfg, params, args)
    before = flash_attention.launches
    on_card = serve.serve_loop(cfg, tree_map(lambda t: t.to(cuda), params),
                               args)
    assert on_card.completed == on_cpu.completed
    assert flash_attention.launches - before == on_card.steps * cfg.n_layers
