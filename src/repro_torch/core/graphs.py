"""Synthetic operator-graph builders used by tests and benchmarks.

Includes the formal-bounds graphs (linear feedforward of Thm 3.1, adversarial
family of Thm 3.2), Fig.-2-style model-shaped graphs (MLP/ResNet/UNet/
Transformer/LSTM/TreeLSTM) with synthesized backward passes, and random DAGs
for property tests.  All builders emit ``core.graph.Log`` programs with
framework-style RELEASE events (computed from last use), so DTR sees the same
liveness information the PyTorch prototype received from refcounting.
"""
from __future__ import annotations

import random
from typing import Callable

from .graph import Log, LogBuilder


# ---------------------------------------------------------------------------
# Theorem graphs
# ---------------------------------------------------------------------------

def linear_network(n: int, unit_cost: float = 1.0, unit_size: int = 1,
                   costs=None, sizes=None) -> Log:
    """N-op linear feedforward net + backward, per Appendix A.1.

    Forward:  t_i = f_i(t_{i-1});  t_0 is a pinned constant input.
    Backward: t̂_N = f̂_N(t_{N-1});  t̂_i = f̂_i(t_{i-1}, t̂_{i+1});
              t̂_1 = f̂_1(t̂_2).
    Releases are emitted at last use, so e.g. t_N dies right after the
    forward pass (it feeds no backward op) — matching the paper's liveness.
    The final gradient t̂_1 is kept (output condition).

    ``costs`` / ``sizes`` (length-``n`` sequences) make the chain
    heterogeneous: layer ``i`` costs ``costs[i-1]`` and its activation /
    gradient occupy ``sizes[i-1]`` bytes (the input ``t_0`` takes
    ``sizes[0]``).  This is the ground-truth family for the differential
    solver tests in ``repro.static`` — real checkpointing trade-offs are
    driven by exactly this per-layer cost/size variation.  Defaults
    reproduce the homogeneous unit chain bit-for-bit.
    """
    costs = [unit_cost] * n if costs is None else [float(c) for c in costs]
    sizes = [unit_size] * n if sizes is None else [int(s) for s in sizes]
    assert len(costs) == n and len(sizes) == n
    b = LogBuilder(name=f"linear{n}")
    t0 = b.constant(sizes[0] if n else unit_size, name="t0")
    fwd = [t0]
    for i in range(1, n + 1):
        (ti,) = b.call([fwd[-1]], [sizes[i - 1]], costs[i - 1], f"f{i}",
                       out_names=[f"t{i}"])
        fwd.append(ti)
    grads: dict[int, str] = {}
    (gN,) = b.call([fwd[n - 1]], [sizes[n - 1]], costs[n - 1], f"g{n}",
                   out_names=[f"g{n}"])
    grads[n] = gN
    for i in range(n - 1, 1, -1):
        (gi,) = b.call([fwd[i - 1], grads[i + 1]], [sizes[i - 1]],
                       costs[i - 1], f"g{i}", out_names=[f"g{i}"])
        grads[i] = gi
    (g1,) = b.call([grads[2]], [sizes[0]], costs[0], "g1", out_names=["g1"])
    grads[1] = g1
    return b.auto_release(keep=[g1])


class AdversarialDriver:
    """Interactive adversary of Theorem 3.2.

    The graph is revealed one node at a time: t0 (a pinned constant) has B
    children; at each step the adversary inspects the runtime's resident set
    and extends a path from t0 whose tensors are *all* evicted, forcing DTR
    to rematerialize the entire path.  ``run`` returns (ops_executed, n).
    """

    def __init__(self, n: int, b: int) -> None:
        assert n > b >= 2
        self.n, self.b = n, b

    def run(self, rt) -> int:
        t0 = rt.constant(1, name="t0")
        # paths[j] = list of tids along path j (excluding t0).
        paths: list[list[int]] = []
        for j in range(self.b):
            (tj,) = rt.call(f"p{j}.0", 1.0, [t0], [1])
            paths.append([tj])
        made = self.b
        while made < self.n:
            resident = rt.resident_tids()
            # Find a path whose tensors are all evicted; B paths vs B-1
            # memory slots below t0 guarantees one exists.
            target = None
            for j, p in enumerate(paths):
                if not any(t in resident for t in p):
                    target = j
                    break
            if target is None:
                # Budget exceeds pigeonhole regime; extend the path with the
                # fewest resident tensors.
                target = min(
                    range(self.b),
                    key=lambda j: sum(t in resident for t in paths[j]))
            tail = paths[target][-1]
            (t_new,) = rt.call(f"p{target}.{len(paths[target])}", 1.0,
                               [tail], [1])
            paths[target].append(t_new)
            made += 1
        return rt.ops_executed


# ---------------------------------------------------------------------------
# Backward-pass synthesis for model graphs
# ---------------------------------------------------------------------------

class _Net:
    """Tiny graph-with-autograd builder over LogBuilder.

    ``op(name, inputs, out_size, cost)`` records a forward op; ``backward``
    synthesizes reverse-mode gradient ops (one grad op per (op, input) pair,
    plus accumulation adds at fan-in), mirroring how frameworks structure the
    backward graph.  Parameter gradients and the loss are kept live at the
    end (the simulator output condition).
    """

    def __init__(self, name: str):
        self.b = LogBuilder(name=name)
        self.params: list[str] = []
        self.fwd_ops: list[tuple[str, list[str], str, int, float]] = []
        self.sizes: dict[str, int] = {}

    def param(self, size: int, name: str | None = None) -> str:
        t = self.b.constant(size, name=name)
        self.params.append(t)
        self.sizes[t] = size
        return t

    def input(self, size: int, name: str | None = None) -> str:
        t = self.b.constant(size, name=name)
        self.sizes[t] = size
        return t

    def op(self, name: str, inputs: list[str], out_size: int,
           cost: float) -> str:
        (out,) = self.b.call(inputs, [out_size], cost, name)
        self.sizes[out] = out_size
        self.fwd_ops.append((name, list(inputs), out, out_size, cost))
        return out

    def backward(self, loss: str) -> Log:
        # Seed: d(loss) = 1.
        grads: dict[str, str] = {}
        (g,) = self.b.call([loss], [self.sizes[loss]], 1.0, "grad_seed")
        grads[loss] = g
        self.sizes[g] = self.sizes[loss]
        # Reverse topological order over recorded ops.
        for name, inputs, out, out_size, cost in reversed(self.fwd_ops):
            if out not in grads:
                continue  # branch not on the loss path
            gout = grads[out]
            for inp in inputs:
                # d(inp) += vjp(op, inp)(gout); depends on the op's inputs
                # (activations) + upstream grad, like real autograd.
                (gi,) = self.b.call(
                    inputs + [gout], [self.sizes[inp]], cost,
                    f"d_{name}/{inp}")
                self.sizes[gi] = self.sizes[inp]
                if inp in grads:
                    (acc,) = self.b.call(
                        [grads[inp], gi], [self.sizes[inp]],
                        max(self.sizes[inp] * 1e-3, 0.1), f"acc_{inp}")
                    self.sizes[acc] = self.sizes[inp]
                    grads[inp] = acc
                else:
                    grads[inp] = gi
        keep = [grads[p] for p in self.params if p in grads] + [loss]
        return self.b.auto_release(keep=keep)


# ---------------------------------------------------------------------------
# Fig. 2-style model graphs (shapes chosen to echo the paper's models)
# ---------------------------------------------------------------------------

def mlp(depth: int = 16, width: int = 64, batch: int = 32) -> Log:
    """Plain MLP: matmul + pointwise per layer (activation-dominated)."""
    net = _Net(f"mlp{depth}")
    act = batch * width
    x = net.input(act)
    h = x
    for i in range(depth):
        w = net.param(width * width // 8, name=f"w{i}")
        h = net.op(f"mm{i}", [h, w], act, cost=float(width))
        h = net.op(f"relu{i}", [h], act, cost=1.0)
    loss = net.op("loss", [h], 1, cost=1.0)
    return net.backward(loss)


def resnet(blocks: int = 16, width: int = 64, batch: int = 32) -> Log:
    """Residual chain: two convs + skip add per block (ResNet-shaped)."""
    net = _Net(f"resnet{blocks}")
    act = batch * width
    h = net.input(act)
    for i in range(blocks):
        w1 = net.param(width * 9, name=f"w{i}a")
        w2 = net.param(width * 9, name=f"w{i}b")
        a = net.op(f"conv{i}a", [h, w1], act, cost=float(width))
        a = net.op(f"relu{i}a", [a], act, cost=1.0)
        a = net.op(f"conv{i}b", [a, w2], act, cost=float(width))
        h = net.op(f"add{i}", [h, a], act, cost=1.0)
        h = net.op(f"relu{i}b", [h], act, cost=1.0)
    loss = net.op("loss", [h], 1, cost=1.0)
    return net.backward(loss)


def unet(depth: int = 5, width: int = 32, batch: int = 8) -> Log:
    """U-shaped net with long skip connections (downs feed ups)."""
    net = _Net(f"unet{depth}")
    width = width * batch
    h = net.input(width * (2 ** depth))
    skips = []
    # Down path: spatial size halves, channels double => tensor size ~const,
    # mimic by keeping sizes but rising cost.
    for i in range(depth):
        w = net.param(width * 9, name=f"dw{i}")
        h = net.op(f"down{i}", [h, w], width * (2 ** (depth - i)),
                   cost=float(width * (2 ** (depth - i))))
        skips.append(h)
        h = net.op(f"pool{i}", [h], width * (2 ** (depth - i - 1)), cost=1.0)
    for i in reversed(range(depth)):
        w = net.param(width * 9, name=f"uw{i}")
        h = net.op(f"up{i}", [h, w], width * (2 ** (depth - i)),
                   cost=float(width * (2 ** (depth - i))))
        h = net.op(f"cat{i}", [h, skips[i]], width * (2 ** (depth - i + 1)),
                   cost=1.0)
    loss = net.op("loss", [h], 1, cost=1.0)
    return net.backward(loss)


def transformer(layers: int = 8, d: int = 64, seq: int = 32,
                batch: int = 8) -> Log:
    """Decoder-block stack: qkv, attention, proj, 2-matmul MLP per layer."""
    net = _Net(f"transformer{layers}")
    size = batch * d * seq
    h = net.input(size)
    for i in range(layers):
        wqkv = net.param(3 * d * d, name=f"wqkv{i}")
        wo = net.param(d * d, name=f"wo{i}")
        w1 = net.param(4 * d * d, name=f"w1_{i}")
        w2 = net.param(4 * d * d, name=f"w2_{i}")
        ln1 = net.op(f"ln1_{i}", [h], size, cost=1.0)
        qkv = net.op(f"qkv{i}", [ln1, wqkv], 3 * size, cost=float(3 * d))
        scores = net.op(f"scores{i}", [qkv], batch * seq * seq,
                        cost=float(seq))
        probs = net.op(f"softmax{i}", [scores], batch * seq * seq, cost=2.0)
        attn = net.op(f"attnv{i}", [probs, qkv], size, cost=float(seq))
        proj = net.op(f"proj{i}", [attn, wo], size, cost=float(d))
        h = net.op(f"res1_{i}", [h, proj], size, cost=1.0)
        ln2 = net.op(f"ln2_{i}", [h], size, cost=1.0)
        m1 = net.op(f"fc1_{i}", [ln2, w1], 4 * size, cost=float(4 * d))
        ge = net.op(f"gelu{i}", [m1], 4 * size, cost=2.0)
        m2 = net.op(f"fc2_{i}", [ge, w2], size, cost=float(4 * d))
        h = net.op(f"res2_{i}", [h, m2], size, cost=1.0)
    loss = net.op("loss", [h], 1, cost=1.0)
    return net.backward(loss)


def lstm(steps: int = 32, width: int = 64, batch: int = 32) -> Log:
    """Unrolled LSTM chain (dynamic-model shaped: long temporal chain)."""
    net = _Net(f"lstm{steps}")
    act = batch * width
    wx = net.param(width * width // 2, name="wx")
    wh = net.param(width * width // 2, name="wh")
    h = net.input(act, name="h0")
    c = net.input(act, name="c0")
    for i in range(steps):
        x = net.input(act, name=f"x{i}")
        gates = net.op(f"gates{i}", [x, h, wx, wh], 4 * act,
                       cost=float(8 * width))
        c = net.op(f"cell{i}", [gates, c], act, cost=2.0)
        h = net.op(f"hid{i}", [gates, c], act, cost=2.0)
    loss = net.op("loss", [h], 1, cost=1.0)
    return net.backward(loss)


def treelstm(depth: int = 5, width: int = 64, seed: int = 0,
             batch: int = 16) -> Log:
    """TreeLSTM over a (complete) binary tree — the paper's dynamic model."""
    net = _Net(f"treelstm{depth}")
    act = batch * width
    w = net.param(width * width // 2, name="w")

    def build(d: int) -> tuple[str, str]:
        if d == 0:
            leaf = net.input(act)
            h = net.op(f"leaf_h.{leaf}", [leaf, w], act, cost=float(width))
            c = net.op(f"leaf_c.{leaf}", [leaf, w], act, cost=float(width))
            return h, c
        lh, lc = build(d - 1)
        rh, rc = build(d - 1)
        g = net.op(f"tg.{d}.{net.b._fresh}", [lh, rh, w], 4 * act,
                   cost=float(4 * width))
        c = net.op(f"tc.{d}.{net.b._fresh}", [g, lc, rc], act, cost=2.0)
        h = net.op(f"th.{d}.{net.b._fresh}", [g, c], act, cost=2.0)
        return h, c

    h, _ = build(depth)
    loss = net.op("loss", [h], 1, cost=1.0)
    return net.backward(loss)


def random_dag(n_ops: int, seed: int = 0, max_fan_in: int = 3,
               max_size: int = 8) -> Log:
    """Random connected DAG + synthesized backward (property tests)."""
    rng = random.Random(seed)
    net = _Net(f"rand{n_ops}_{seed}")
    frontier = [net.input(rng.randint(1, max_size))]
    for i in range(n_ops):
        k = rng.randint(1, min(max_fan_in, len(frontier)))
        ins = rng.sample(frontier, k)
        out = net.op(f"op{i}", ins, rng.randint(1, max_size),
                     cost=float(rng.randint(1, 4)))
        frontier.append(out)
        if len(frontier) > 12:
            frontier.pop(0)
    loss = net.op("loss", [frontier[-1]], 1, cost=1.0)
    return net.backward(loss)


MODEL_GRAPHS: dict[str, Callable[[], Log]] = {
    "mlp": mlp,
    "resnet": resnet,
    "unet": unet,
    "transformer": transformer,
    "lstm": lstm,
    "treelstm": treelstm,
}
