"""The fused clip-and-AdamW pass (``kernels/fused_adamw.py``) against the
per-leaf path (``clip_by_global_norm``, then AdamW's ``update``, then
``apply_updates``).

On the CPU: ``make_train_step`` with AdamW gives, bit for bit, what the
composition it ran before the fused pass gives; the dispatch sends CPU,
mesh-shard and non-f32 leaves to the per-leaf path.  The card tests carry
the ``requires_cuda`` marker and skip inside the test where torch sees no
card.  Run them on the card with

    PYTHONPATH=src python -m pytest -q -m requires_cuda tests/test_torch_fused_adamw.py

This file imports neither JAX nor the JAX package.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.kernels import fused_adamw as fa  # noqa: E402
from repro_torch.launch.steps import (  # noqa: E402
    _microbatches, loss_and_grads, make_train_step)
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.params import tree_items, tree_map  # noqa: E402
from repro_torch.optim import (  # noqa: E402
    adafactor, adamw, apply_updates, clip_by_global_norm, cosine_schedule)

STEPS = 3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CPU runs the per-leaf path only")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _opt():
    return adamw(lr=cosine_schedule(1e-3, warmup=1, total=STEPS))


def _per_leaf_step(cfg, opt, grad_accum, max_grad_norm=1.0):
    """``make_train_step``'s body before the fused pass: microbatches summed
    in f32, ``clip_by_global_norm``, ``update``, ``apply_updates``."""
    def step(params, state, batch):
        if grad_accum > 1:
            micro = {k: _microbatches(x, grad_accum)
                     for k, x in batch.items()}
            loss_sum = grads = None
            for i in range(grad_accum):
                l, g = loss_and_grads(cfg, params,
                                      {k: x[i] for k, x in micro.items()})
                g32 = tree_map(lambda t: t.float(), g)
                loss_sum = l if loss_sum is None else loss_sum + l
                grads = g32 if grads is None else tree_map(torch.add, grads,
                                                           g32)
            loss = loss_sum / grad_accum
            grads = tree_map(lambda g: g / grad_accum, grads)
        else:
            loss, grads = loss_and_grads(cfg, params, batch)
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        updates, state = opt.update(grads, state, params)
        return apply_updates(params, updates), state, {"loss": loss,
                                                       "grad_norm": gnorm}
    return step


def _same(a, b, what):
    for (path, x), (_, y) in zip(tree_items(a), tree_items(b)):
        assert torch.equal(x, y), f"{what}.{path}"


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_train_step_equals_the_per_leaf_composition_on_cpu(grad_accum):
    cfg = configs.get_smoke("smollm-135m").replace(dtype="float32",
                                                   remat="none")
    params = M.init_params(cfg, torch.Generator().manual_seed(0))
    before = tree_map(torch.clone, params)
    old_params = tree_map(torch.clone, params)
    opt, old_opt = _opt(), _opt()
    step = make_train_step(cfg, opt, grad_accum=grad_accum)
    old_step = _per_leaf_step(cfg, old_opt, grad_accum)
    state, old_state = opt.init(params), old_opt.init(old_params)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=16, batch=4, seed=0)
    launches = fa.fused_adamw.launches
    for i in range(STEPS):
        batch = {"tokens": torch.from_numpy(data.batch_at(i)["tokens"])}
        params, state, m = step(params, state, batch)
        old_params, old_state, old_m = old_step(old_params, old_state, batch)
        assert m["action"] == "ok"
        assert torch.equal(m["loss"], old_m["loss"])
        assert torch.equal(m["grad_norm"], old_m["grad_norm"])
        assert state.step == old_state.step == i + 1
        _same(params, old_params, "p")
        _same(state.inner, old_state.inner, "state")
    assert fa.fused_adamw.launches == launches
    assert any(not torch.equal(a, b) for (_, a), (_, b)
               in zip(tree_items(before), tree_items(params)))


def _tree(kind: str):
    """A two-leaf tree of parameters and gradients, with its AdamW state, of
    which the fused pass must not take every leaf, as ``kind`` says; and
    whether its leaves lie on a card.  Card leaves are fake (this container
    has no card); a mesh shard's fake mode says ``mesh_shards``."""
    mode = FakeTensorMode()
    mode.mesh_shards = kind == "shard"
    on_card = kind != "cpu"
    dtype = torch.bfloat16 if kind == "bf16" else torch.float32
    with mode if on_card else torch.device("cpu"):
        def leaf(*shape):
            return torch.ones(shape, dtype=dtype,
                              device="cuda" if on_card else "cpu")
        params = {"w": leaf(5, 3).t() if kind == "strided" else leaf(3, 5),
                  "b": leaf(7)}
        grads = {"w": leaf(3, 5), "b": leaf(7)}
        opt = _opt()
        state = opt.init(params)
    return opt, params, grads, state, on_card


@pytest.mark.parametrize("kind", ["cpu", "shard", "bf16", "strided"])
def test_dispatch_sends_other_trees_per_leaf(kind):
    opt, params, grads, state, on_card = _tree(kind)
    assert not all(fa.takes(p, g, m, v) for p, g, m, v in zip(
        params.values(), grads.values(), state.inner["m"].values(),
        state.inner["v"].values()))
    launches, fallback = fa.fused_adamw.launches, \
        fa.fused_adamw.fallback_leaves
    assert opt.fused(grads, state, params) is None
    assert fa.fused_adamw.launches == launches
    assert fa.fused_adamw.fallback_leaves == fallback + (2 if on_card else 0)


# Every model the train launcher takes (vision it refuses; chip_smoke's
# phase 13 holds its step on the card).
LAUNCHER_ARCHS = ["qwen2-0.5b", "llama3.2-1b", "smollm-135m", "gemma3-1b",
                  "recurrentgemma-2b", "musicgen-large", "rwkv6-1.6b",
                  "deepseek-v3-671b", "mixtral-8x7b"]


@pytest.mark.parametrize("arch", LAUNCHER_ARCHS)
def test_every_leaf_of_a_launcher_model_suits_the_fused_pass(arch):
    """The pass takes a tree only whole: one leaf it cannot take sends every
    leaf per leaf.  So at the launcher's smoke config every parameter, its
    gradient and its moments are f32, contiguous and of one size: all that
    ``takes`` asks beside a card (the card's backward is the same
    autograd)."""
    from repro_torch.launch import train
    args = train.parse_args(["--arch", arch, "--smoke", "--batch", "2",
                             "--seq", "16"])
    cfg = train.config_from_args(args)
    params = M.init_params(cfg, torch.Generator().manual_seed(0))
    data = SyntheticLM(vocab=cfg.vocab, seq_len=args.seq, batch=args.batch,
                       seed=0, n_codebooks=cfg.n_codebooks)
    batch = {k: torch.from_numpy(v) for k, v in data.batch_at(0).items()}
    _, grads = loss_and_grads(cfg, params, batch)
    state = adamw().init(params)
    leaves = list(zip(tree_items(params), tree_items(grads),
                      tree_items(state.inner["m"]),
                      tree_items(state.inner["v"])))
    assert len(leaves) == len(list(tree_items(params))) > 0
    for (path, p), (g_path, g), (_, m), (_, v) in leaves:
        assert g_path == path
        for t in (p, g, m, v):
            assert t.dtype == torch.float32 and t.is_contiguous(), path
            assert t.numel() == p.numel(), path


def test_dispatch_takes_f32_card_leaves_and_adamw_only():
    with FakeTensorMode():
        ts = [torch.ones(5, 3, device="cuda") for _ in range(4)]
        shorter = torch.ones(4, 3, device="cuda")
    assert fa.takes(*ts)
    assert not fa.takes(ts[0], shorter, ts[2], ts[3])
    assert adafactor().fused is None


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

def _leaves(rng, device):
    """Parameters and gradients of every case the kernel must take: sizes
    that are no multiple of 4, one element, a misaligned view (4 bytes past
    a 16-byte base), a stacked leaf and leaves over several chunks."""
    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(device)

    def skewed(*shape):   # a view one element into its storage
        n = int(np.prod(shape))
        return t(n + 1)[1:].view(*shape)

    params = {"odd": t(37, 13), "one": t(1), "skewed": skewed(40, 25),
              "stack": t(2, 8, 64, 96), "long": t(3, 70001)}
    grads = {"odd": t(37, 13), "one": t(1), "skewed": skewed(40, 25),
             "stack": t(2, 8, 64, 96), "long": t(3, 70001)}
    return params, grads


@pytest.mark.requires_cuda
@pytest.mark.parametrize("clip", [True, False])
def test_fused_pass_is_the_per_leaf_path_bit_for_bit(cuda, clip):
    rng = np.random.default_rng(7)
    params, _ = _leaves(rng, cuda)
    ref_params = tree_map(torch.clone, params)
    ref_params["skewed"] = torch.empty(1001, device=cuda)[1:].view(40, 25)
    ref_params["skewed"].copy_(params["skewed"])
    opt, ref_opt = _opt(), _opt()
    state, ref_state = opt.init(params), ref_opt.init(ref_params)
    counts = (fa.fused_adamw.launches, fa.fused_adamw.leaves,
              fa.fused_adamw.fallback_leaves)
    for i in range(STEPS):
        _, grads = _leaves(rng, cuda)
        norm = float(clip_by_global_norm(grads, 1.0)[1])
        if not clip:   # a norm of about 557 clips; 1e-4 does not
            for g in grads.values():    # in place: the views stay skewed
                g.mul_(1e-4 / norm)
        ref_grads, ref_norm = clip_by_global_norm(grads, 1.0)
        fused = opt.fused(grads, state, params)
        assert fused is not None
        got = fused.norm(1.0)
        assert abs(float(got) / float(ref_norm) - 1) <= 1e-6
        # the scale is clip_by_global_norm's formula of the fused norm
        assert torch.equal(fused.scale,
                           torch.clamp(1.0 / (got + 1e-9), max=1.0))
        assert (float(fused.scale) < 1) == clip
        if not clip:
            assert float(fused.scale) == 1.0
        state = fused.update()
        # the per-leaf path given the fused pass's scale
        ref_grads = tree_map(lambda g: (g.float() * fused.scale).to(g.dtype),
                             grads)
        updates, ref_state = ref_opt.update(ref_grads, ref_state, ref_params)
        apply_updates(ref_params, updates)
        torch.cuda.synchronize()
        assert state.step == ref_state.step == i + 1
        _same(params, ref_params, "p")
        _same(state.inner, ref_state.inner, "state")
    assert (fa.fused_adamw.launches, fa.fused_adamw.leaves,
            fa.fused_adamw.fallback_leaves) == (
        counts[0] + 2 * STEPS, counts[1] + 5 * STEPS, counts[2])


class _Verdict:
    def __init__(self, action):
        self.action = action

    def check(self, loss, grad_norm):
        return self.action


@pytest.mark.requires_cuda
@pytest.mark.parametrize("action,grad_accum",
                         [("ok", 1), ("ok", 2), ("skip", 1), ("restore", 1)])
def test_train_step_on_the_card_fuses_and_obeys_the_guard(cuda, action,
                                                          grad_accum):
    cfg = configs.get_smoke("smollm-135m").replace(dtype="float32",
                                                   remat="none")
    params = M.init_params(cfg, torch.Generator(cuda).manual_seed(0))
    opt = _opt()
    state = opt.init(params)
    step = make_train_step(cfg, opt, grad_accum=grad_accum,
                           guard=_Verdict(action))
    n_leaves = len(list(tree_items(params)))
    data = SyntheticLM(vocab=cfg.vocab, seq_len=16, batch=4, seed=0)
    before = tree_map(torch.clone, {"p": params, "s": state.inner})
    counts = (fa.fused_adamw.launches, fa.fused_adamw.leaves,
              fa.fused_adamw.fallback_leaves)
    batch = {"tokens": torch.from_numpy(data.batch_at(0)["tokens"]).to(cuda)}
    params, state, m = step(params, state, batch)
    torch.cuda.synchronize()
    assert m["action"] == action and np.isfinite(float(m["grad_norm"]))
    if action == "ok":
        assert state.step == 1
        assert (fa.fused_adamw.launches, fa.fused_adamw.leaves,
                fa.fused_adamw.fallback_leaves) == (
            counts[0] + 2, counts[1] + n_leaves, counts[2])
        assert any(not torch.equal(a, b) for (_, a), (_, b) in zip(
            tree_items(before["p"]), tree_items(params)))
    else:
        assert state.step == 0
        assert (fa.fused_adamw.launches, fa.fused_adamw.leaves) == (
            counts[0] + 1, counts[1])
        _same({"p": params, "s": state.inner}, before, "unchanged")
