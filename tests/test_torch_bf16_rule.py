"""The bf16 rule that ``chip_smoke.py`` holds the kernel path to (phases 4,
6, 11a and 12b), on the CPU: ``bf16_verdict`` passes a clean kernel path
over several weight draws and fails one with a single wrong tile.

Each draw compares a bf16 path with the f32 plain path, the kernel path's
distance beside the plain path's own; the rule takes the median ratio over
the draws.  Here the "kernel" is plain PyTorch: the wgmma decode kernel's
split-kv schedule written out (``split_reference``, a second order of
summation, so a second sample of bf16 rounding), and the same with one
64-key tile of one slot's kv-head group dropped; in training, the plain
backward with one 32-key tile of dK zeroed (the simt backward's key tile),
the gradients compared leaf by leaf.
The qwen2-0.5b smoke config (3 layers, d 56, 7/1 heads of 8, vocab 256),
random weights from torch seeds, a random cache of 128 rows.
"""
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.steps import loss_and_grads  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.params import TORCH_DTYPES, tree_map  # noqa: E402
from test_torch_kernel_plan import split_reference  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
try:
    import chip_smoke  # noqa: E402
finally:
    sys.path.remove(str(ROOT))

ARCH = "qwen2-0.5b"
POS = (3, 40, 90, 127)
KEY_TILE = 64        # the wgmma forward's key tile
DK_TILE = 32         # the simt backward's key tile


def test_rule_takes_the_median_of_the_draws():
    ok = chip_smoke.bf16_verdict
    clean = [(1.0, 1.0), (0.9, 1.0), (1.2, 1.0)]
    assert ok(clean)[0] and ok(clean)[1] == [1.0, 0.9, 1.2]
    assert not ok(clean[:2])[0]                   # too few draws
    outlier = [(3.0, 1.0), (1.0, 1.0), (1.1, 1.0)]
    assert ok(outlier)[0]                         # noise on one draw
    assert not ok([(3.0, 1.0), (2.5, 1.0), (1.0, 1.0)])[0]
    assert not ok([(float("nan"), 1.0)] + clean[1:])[0]
    assert not ok([(float("inf"), 1.0)] + clean[1:])[0]
    limit = chip_smoke.BF16_RATIO
    assert ok([(limit, 1.0)] * 3)[0] and not ok([(1.01 * limit, 1.0)] * 3)[0]


def _split_kernel(q, k, v, *, causal=True, window=0, kv_len=None):
    """A clean decode kernel: the split-kv schedule of the plan."""
    b, hq, hkv, sq, skv, d = (*q.shape[:2], k.shape[1], q.shape[2],
                              k.shape[2], q.shape[3])
    p = fa.plan(b, hq, hkv, sq, skv, d, q.dtype)
    return split_reference(q, k, v, causal=causal, window=window,
                           kv_len=kv_len, splits=p["kv_splits"],
                           block_q=64, block_kv=KEY_TILE).to(q.dtype)


def _dropped_tile(q, k, v, *, causal=True, window=0, kv_len=None):
    """The clean kernel with one wrong tile: slot 2 (position 90) reads its
    first kv head's keys from the second tile on, in every layer."""
    out = _split_kernel(q, k, v, causal=causal, window=window, kv_len=kv_len)
    g = q.shape[1] // k.shape[1]
    wrong = _split_kernel(q[2:3, :g], k[2:3, :1, KEY_TILE:],
                          v[2:3, :1, KEY_TILE:], causal=causal,
                          kv_len=kv_len[2:3] - KEY_TILE)
    out = out.clone()
    out[2:3, :g] = wrong
    return out


def _decode_pairs(monkeypatch, kernel):
    """(kernel, plain) distances of the bf16 decode logits from the f32
    plain path on three weight draws."""
    cfg = configs.get_smoke(ARCH)
    pos = torch.tensor(POS, dtype=torch.int32)
    pairs = []
    for seed in range(3):
        g = torch.Generator().manual_seed(seed)
        params = M.init_params(cfg, g)
        base = tree_map(lambda d: torch.randn(d.shape, generator=g),
                        M.cache_defs(cfg, len(POS), 128))
        tok = torch.randint(0, cfg.vocab, (len(POS), 1), generator=g,
                            dtype=torch.int32)

        def logits(dtype, patched):
            c = cfg.replace(dtype=dtype)
            cache = tree_map(lambda t: t.to(TORCH_DTYPES[dtype]), base)
            with monkeypatch.context() as mp:
                if patched:
                    mp.setattr(ops, "flash_attention", kernel)
                out, _ = M.decode_step(c, M.prepare_params(c, params), tok,
                                       cache, pos)
            return out.float()

        p32 = logits("float32", False)
        pairs.append((float(torch.linalg.vector_norm(
            logits("bfloat16", True) - p32)), float(torch.linalg.vector_norm(
                logits("bfloat16", False) - p32))))
    return pairs


def test_decode_rule_passes_a_clean_kernel_and_catches_one_wrong_tile(
        monkeypatch):
    clean = _decode_pairs(monkeypatch, _split_kernel)
    ok, ratios = chip_smoke.bf16_verdict(clean)
    assert ok, ratios
    faulty = _decode_pairs(monkeypatch, _dropped_tile)
    ok, ratios = chip_smoke.bf16_verdict(faulty)
    assert not ok and min(ratios) > chip_smoke.BF16_RATIO, ratios


class _WrongDkTile(torch.autograd.Function):
    """Identity on k; its gradient loses keys 0..31 of batch row 0's first
    kv head (one dK tile of the simt backward)."""

    @staticmethod
    def forward(ctx, k):
        return k.view_as(k)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        g[0, 0, :DK_TILE] = 0
        return g


def _faulty_train_kernel(q, k, v, **kw):
    return fa.flash_attention(q, _WrongDkTile.apply(k), v, **kw)


def _train_pairs(monkeypatch, kernel):
    """(kernel, plain) distances of the bf16 gradients from the f32 plain
    path's, ||g - g32|| / ||g32||, at the leaf of the largest ratio, on
    three weight draws (``chip_smoke.bf16_train_draws``'s statistic)."""
    cfg = configs.get_smoke(ARCH)
    pairs = []
    for seed in range(3):
        g = torch.Generator().manual_seed(10 + seed)
        params = M.init_params(cfg, g)
        batch = {"tokens": torch.randint(0, cfg.vocab, (2, 32), generator=g,
                                         dtype=torch.int32)}

        def grads(dtype, patched):
            with monkeypatch.context() as mp:
                if patched:
                    mp.setattr(ops, "flash_attention", kernel)
                return loss_and_grads(cfg.replace(dtype=dtype), params,
                                      batch)[1]

        g32 = grads("float32", False)
        plain = chip_smoke._leaf_dists(torch, grads("bfloat16", False), g32)
        kern = chip_smoke._leaf_dists(torch, grads("bfloat16", True), g32)
        pairs.append(chip_smoke._worst_ratio_leaf(kern, plain)[:2])
    return pairs


def test_train_rule_passes_a_clean_kernel_and_catches_one_wrong_tile(
        monkeypatch):
    clean = _train_pairs(monkeypatch, fa.flash_attention)
    assert chip_smoke.bf16_verdict(clean) == (True, [1.0, 1.0, 1.0])
    faulty = _train_pairs(monkeypatch, _faulty_train_kernel)
    ok, ratios = chip_smoke.bf16_verdict(faulty)
    assert not ok and min(ratios) > chip_smoke.BF16_RATIO, ratios
