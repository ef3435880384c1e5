"""What every family's plain reference shares: the leaf record, float32
and simulated-fp8 arithmetic, the RMS norm, and the training steps that
follow the program's first three (clip, AdamW, schedule), with the
readings the comparison takes from them.

Plain PyTorch and numpy only: nothing here imports the program, and the
reference takes nothing the program made.  Its weights are drawn again
from the seed (``lib.weights``) and its batches rebuilt from the frozen
stream (``lib.data``).  Each batch row runs on its own (the loss is the
mean over rows of equal length, and every family's rows are independent:
the MoE routes within a row), so the activations of one row at a time are
live.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from ..lib import weights
from ..lib.data import SyntheticLM


@dataclass(frozen=True)
class Leaf:
    """One parameter in the program's key layout: ``stacked`` leaves carry
    the layers on dim 0 and are compared a layer at a time."""
    name: str
    shape: tuple
    mean: float = 0.0
    std: float = 0.0
    stacked: bool = False


class F32:
    """The reference's arithmetic: float32, TF32 off."""

    @staticmethod
    def mm(a, b):
        return torch.matmul(a, b)

    @staticmethod
    def act(x):
        return x


class _Round(torch.autograd.Function):
    """Round to fp8 with a per-tensor scale in the forward and pass the
    gradient straight through, rounded to e5m2 on its way back."""

    @staticmethod
    def forward(ctx, x):
        return fp8_round(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return fp8_round(g, torch.float8_e5m2)


def fp8_round(x, dtype):
    """``x`` through ``dtype`` and back, scaled so that its largest
    magnitude lands on the type's largest finite value."""
    top = torch.finfo(dtype).max
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    scale = amax / top
    return ((x.float() / scale).to(dtype).float() * scale).to(x.dtype)


class FP8:
    """The control: the reference with every operand of a product the
    program runs in bf16 rounded to e4m3 (and its gradient to e5m2), the
    step below bf16 that would tempt a later change; sums stay in f32."""

    @staticmethod
    def mm(a, b):
        return torch.matmul(_Round.apply(a), _Round.apply(b))

    @staticmethod
    def act(x):
        return _Round.apply(x)


def rms(x, scale, eps):
    """RMS norm with the ``1 + scale`` gain, in f32."""
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * (1.0 + scale)


def nll(logits, tokens):
    """Mean next-token cross entropy of one row: logits [1,S,V] f32."""
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    return -torch.gather(logp, -1, tokens[:, 1:, None])[..., 0].mean()


def slices(layout, leaves: dict):
    """``(slice name, tensor)`` of every leaf, a layer at a time for a
    stacked leaf."""
    for leaf in layout:
        t = leaves[leaf.name]
        if leaf.stacked:
            for i in range(t.shape[0]):
                yield f"{leaf.name}[{i}]", t[i]
        else:
            yield leaf.name, t


def slice_norms(layout, leaves: dict, scale: float = 1.0) -> dict:
    """Each slice's f32 norm (times ``scale``), read in one transfer."""
    names, norms = [], []
    for name, t in slices(layout, leaves):
        names.append(name)
        norms.append(torch.linalg.vector_norm(t.float()))
    return dict(zip(names, (torch.stack(norms) * scale).tolist()))


# Elements of each slice whose first gradient is kept whole, at a fixed
# stride: their difference, program against reference, is read too.
SAMPLE = 1 << 16


def sample(t) -> torch.Tensor:
    """A fixed strided sample of ``t``'s elements, f32, on the host."""
    flat = t.reshape(-1)
    return flat[::max(1, flat.numel() // SAMPLE)][:SAMPLE].float()


def slice_samples(layout, leaves: dict, scale: float = 1.0) -> dict:
    """Each slice's sample (times ``scale``), read in one transfer."""
    names, parts = [], []
    for name, t in slices(layout, leaves):
        names.append(name)
        parts.append(sample(t) * scale)
    sizes = [p.numel() for p in parts]
    return dict(zip(names, torch.cat(parts).cpu().split(sizes)))


@dataclass
class Readings:
    """What the comparison reads of three training steps: each step's loss
    and global gradient norm (before clipping), each slice's norm of the
    clipped first gradient, and each slice's norm of the parameters'
    change over the three steps."""
    losses: list = field(default_factory=list)
    grad_norms: list = field(default_factory=list)
    first_grad: dict = field(default_factory=dict)
    first_grad_sample: dict = field(default_factory=dict)
    change: dict = field(default_factory=dict)


def lr_at(step: int, peak: float, warmup: int, total: int,
          floor: float = 0.1) -> float:
    """Linear warm-up to ``peak`` over ``warmup`` steps, then a cosine to
    ``floor * peak`` at ``total``, in f32 as the launcher's schedule."""
    f32 = np.float32
    s = f32(step)
    warm = f32(peak) * s / f32(max(warmup, 1))
    t = np.clip((s - f32(warmup)) / f32(max(total - warmup, 1)),
                f32(0.0), f32(1.0))
    cos = f32(floor * peak) + f32((1 - floor) * peak * 0.5) * (
        f32(1) + np.cos(f32(np.pi) * t))
    return float(warm if s < warmup else cos)


# The launcher's AdamW, schedule and clip (launch/train.py's choices).
ADAMW = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
WARMUP = 20
MAX_GRAD_NORM = 1.0


def _adamw_slice(p, g, m, v, step: int, lr: float):
    b1, b2, eps, wd = (ADAMW[k] for k in ("b1", "b2", "eps",
                                           "weight_decay"))
    bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(step))
    bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(step))
    lr_t = float(np.float32(lr))
    m.mul_(b1).add_((1 - b1) * g)
    v.mul_(b2).add_((1 - b2) * g * g)
    u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
    u = u + wd * p
    p.add_(-lr_t * u)


def train_readings(family, model: dict, traffic: dict, seed: int, device,
                   numerics=F32, *, steps: int = 3, half_batch=False,
                   double_leaf=None) -> Readings:
    """Follow the program's first ``steps`` steps from the seed and read
    them.  ``numerics`` FP8 is the control; ``half_batch`` (rows 0..B/2
    only, the mean over them) and ``double_leaf`` (that leaf's gradient
    doubled where the backward makes it) plant faults."""
    layout = family.layout(model)
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _train(family, layout, model, traffic, seed, device,
                      numerics, steps, half_batch, double_leaf)
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = old


def _parts(t, depth: int, out: list, path=()):
    """``t`` split on its first ``depth`` dims into views, each its own
    autograd leaf (no gradient of a whole stack is made for one layer's or
    one expert's use); nested lists of them, and ``(index, view)`` of each
    appended to ``out``."""
    if depth == 0:
        t.requires_grad_(True)
        out.append((path, t))
        return t
    return [_parts(x, depth - 1, out, path + (i,))
            for i, x in enumerate(t.unbind(0))]


def _train(family, layout, model, traffic, seed, device, numerics, steps,
           half_batch, double_leaf) -> Readings:
    flat, leaves = weights.draw(layout, seed, device)
    split = getattr(family, "SPLIT", {})
    params, units = {}, []
    for leaf in layout:
        views: list = []
        params[leaf.name] = _parts(
            leaves[leaf.name], split.get(leaf.name, int(leaf.stacked)), views)
        moments = [torch.zeros_like(v) for _, v in views]
        units += [(f"{leaf.name}[{path[0]}]" if leaf.stacked else leaf.name,
                   leaf.name, view, m, torch.zeros_like(view))
                  for (path, view), m in zip(views, moments)]
    data = SyntheticLM(vocab=model["vocab"], seq_len=traffic["seq"],
                       batch=traffic["batch"], seed=seed,
                       zipf_a=traffic.get("zipf_a", 1.2))
    rows = traffic["batch"] // 2 if half_batch else traffic["batch"]
    out = Readings()
    for step in range(steps):
        tokens = torch.from_numpy(data.batch_at(step)["tokens"]).to(
            device).long()
        total = torch.zeros((), device=device)
        for b in range(rows):
            loss = family.row_loss(params, tokens[b:b + 1], model, numerics)
            (loss / rows).backward()
            total += loss.detach()
        out.losses.append(float(total / rows))
        with torch.no_grad():
            if double_leaf is not None:
                for _, name, p, _, _ in units:
                    if name == double_leaf:
                        p.grad.mul_(2)
            gn = torch.sqrt(sum(torch.sum(u[2].grad * u[2].grad)
                                for u in units))
            out.grad_norms.append(float(gn))
            scale = torch.clamp(MAX_GRAD_NORM / (gn + 1e-9), max=1.0)
            sums: dict = {}
            for sl, _, p, _, _ in units:
                p.grad.mul_(scale)
                sums[sl] = sums.get(sl, 0) + torch.sum(p.grad * p.grad)
            if step == 0:
                names = list(sums)
                out.first_grad = dict(zip(names, torch.sqrt(torch.stack(
                    [sums[n] for n in names])).tolist()))
                out.first_grad_sample = slice_samples(layout, {
                    leaf.name: _whole_grad(params[leaf.name])
                    for leaf in layout})
            lr = lr_at(step + 1, traffic["lr"], WARMUP, traffic["lr_total"])
            for _, _, p, m, v in units:
                _adamw_slice(p, p.grad, m, v, step + 1, lr)
                p.grad = None
    del units, params
    with torch.no_grad():
        _, start = weights.draw(layout, seed, device)
        out.change = change_norms(layout, leaves, start)
    del flat, leaves, start
    return out


def _whole_grad(part):
    """The gradient of a leaf split by ``_parts``, put back together."""
    if isinstance(part, list):
        return torch.stack([_whole_grad(p) for p in part])
    return part.grad


def change_norms(layout, now: dict, start: dict) -> dict:
    """Each slice's norm of ``now - start``, a leaf at a time."""
    norms = {}
    with torch.no_grad():
        for leaf in layout:
            norms.update(slice_norms(
                [leaf], {leaf.name: now[leaf.name].detach()
                         - start[leaf.name]}))
    return norms
