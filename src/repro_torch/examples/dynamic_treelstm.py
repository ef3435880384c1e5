"""The paper's headline dynamic model: TreeLSTM under a restricted budget.

Data-dependent tree shapes mean NO static planner can precompute a schedule —
every example is a different computation graph.  The eager DTR executor
handles it exactly like the paper's PyTorch prototype: op interposition +
live eviction + recursive rematerialization.

Training is full backprop, done *through DTR*: every backward op is also
dispatched via the context, and the backward pass touches forward activations
that were evicted under the byte budget — triggering exactly the recursive
rematerializations the paper describes.

The counterpart of ``examples/dynamic_treelstm.py`` on real tensors, on the
card unless ``--device cpu``; the weights are drawn from an explicit
``torch.Generator`` where the reference splits a ``PRNGKey``.  After every
op it also records how far ``live_bytes()`` stands above the budget, beside
that op's largest output (the one allocation the budget may be exceeded
by).

  python -m repro_torch.examples.dynamic_treelstm
  python -m repro_torch.examples.dynamic_treelstm --device cpu
"""
from __future__ import annotations

import argparse
import random

import numpy as np
import torch

from ..eager import DTRArray, DTRContext
from ..launch.serve import resolve_device

DIM = 96


def random_tree(rng, depth):
    if depth == 0 or rng.random() < 0.25:
        return ("leaf", rng.uniform(-1, 1))
    return ("node", random_tree(rng, depth - 1), random_tree(rng, depth - 1))


def tree_size(t):
    return 1 if t[0] == "leaf" else 1 + tree_size(t[1]) + tree_size(t[2])


def tree_sum(t):
    return t[1] if t[0] == "leaf" else tree_sum(t[1]) + tree_sum(t[2])


class TreeNet:
    """h(node) = tanh(h_l @ W_l + h_r @ W_r); h(leaf) = v * w_leaf."""

    def __init__(self, ctx: DTRContext, gen: torch.Generator):
        s = 1.0 / np.sqrt(DIM)
        self.ctx = ctx

        def normal(*shape):
            return torch.randn(shape, generator=gen) * s

        self.w = {
            "leaf": ctx.wrap(normal(1, DIM), name="w_leaf"),
            "l": ctx.wrap(normal(DIM, DIM), name="w_l"),
            "r": ctx.wrap(normal(DIM, DIM), name="w_r"),
            "out": ctx.wrap(torch.ones(DIM, 1) * s, name="w_out"),
        }

    # ---- forward: records (kind, inputs, outputs) trace for backward ----
    def encode(self, tree, trace) -> DTRArray:
        ctx = self.ctx
        if tree[0] == "leaf":
            x = ctx.wrap(torch.full((1, 1), tree[1]), name="leafval")
            h = ctx.call("embed", torch.matmul, [x, self.w["leaf"]])[0]
            trace.append(("leaf", x, h))
            return h
        hl = self.encode(tree[1], trace)
        hr = self.encode(tree[2], trace)
        a = ctx.call("mm_l", torch.matmul, [hl, self.w["l"]])[0]
        b = ctx.call("mm_r", torch.matmul, [hr, self.w["r"]])[0]
        s = ctx.call("add", torch.add, [a, b])[0]
        h = ctx.call("tanh", torch.tanh, [s])[0]
        trace.append(("node", hl, hr, s, h))
        return h

    # ---- backward: every vjp op goes through DTR too ----
    def backward(self, trace, root_grad, grads):
        ctx = self.ctx
        gmap = {}  # tid -> grad DTRArray

        def add_grad(arr, g):
            if arr.tid in gmap:
                gmap[arr.tid] = ctx.call("gacc", torch.add,
                                         [gmap[arr.tid], g])[0]
            else:
                gmap[arr.tid] = g

        last_h = trace[-1][-1]
        add_grad(last_h, root_grad)
        for rec in reversed(trace):
            if rec[0] == "node":
                _, hl, hr, s, h = rec
                gh = gmap.pop(h.tid, None)
                if gh is None:
                    continue
                # d tanh: gs = gh * (1 - h^2)   (uses forward h -> remat!)
                gs = ctx.call("d_tanh", lambda g, hh: g * (1 - hh * hh),
                              [gh, h])[0]
                add_grad(hl, ctx.call("d_mm_l_x", lambda g, w: g @ w.T,
                                      [gs, self.w["l"]])[0])
                add_grad(hr, ctx.call("d_mm_r_x", lambda g, w: g @ w.T,
                                      [gs, self.w["r"]])[0])
                # weight grads use forward activations hl/hr (remat!)
                gwl = ctx.call("d_w_l", lambda hh, g: hh.T @ g, [hl, gs])[0]
                gwr = ctx.call("d_w_r", lambda hh, g: hh.T @ g, [hr, gs])[0]
                grads["l"] = (gwl if grads["l"] is None else
                              ctx.call("acc_wl", torch.add,
                                       [grads["l"], gwl])[0])
                grads["r"] = (gwr if grads["r"] is None else
                              ctx.call("acc_wr", torch.add,
                                       [grads["r"], gwr])[0])
            else:
                _, x, h = rec
                gh = gmap.pop(h.tid, None)
                if gh is None:
                    continue
                gwleaf = ctx.call("d_w_leaf", lambda xx, g: xx.T @ g,
                                  [x, gh])[0]
                grads["leaf"] = (gwleaf if grads["leaf"] is None else
                                 ctx.call("acc_wleaf", torch.add,
                                          [grads["leaf"], gwleaf])[0])


def train(device, steps: int = 60, budget: float | None = None) -> dict:
    """Train on ``steps`` random trees under ``budget`` bytes (default: the
    reference's); returns the losses, the context and the most that
    ``live_bytes()`` stood above the budget after an op, less that op's
    largest output (at most 0 when the budget held)."""
    rng = random.Random(0)
    gen = torch.Generator().manual_seed(0)
    # Budget: 3 weights + 3 weight-grads + 2 working DIM² buffers + ~64
    # activation vectors.  Trees reach ~90 nodes × 4-5 tensors each, so the
    # forward activations cannot all stay resident -> forced evictions.
    if budget is None:
        budget = (8 * DIM * DIM + 64 * DIM) * 4
    # dealloc="banish": released *constants* (old weight versions, leaf
    # values) are permanently freed — the paper notes banishing is the only
    # way to free constants (Sec. 2 Deallocation).
    ctx = DTRContext(budget_bytes=budget, dealloc="banish", device=device)
    net = TreeNet(ctx, gen)

    # Track per-step arrays so they can be released at step end (framework
    # refcounting -> eager eviction; keeps the op graph from growing across
    # steps).  Weight updates happen OUTSIDE DTR, per the paper's App. C.6
    # ("the weight update step outside of DTR immediately after backward").
    step_arrays: list[DTRArray] = []
    orig_call = ctx.call
    orig_wrap = ctx.wrap
    over = [-float("inf")]

    def tracked_call(name, fn, args, n_outputs=None):
        outs = orig_call(name, fn, args, n_outputs)
        step_arrays.extend(outs)
        over[0] = max(over[0], ctx.live_bytes() - budget
                      - max(o.nbytes for o in outs))
        return outs

    def tracked_wrap(x, constant=True, name="const"):
        arr = orig_wrap(x, constant=constant, name=name)
        if name == "leafval":
            step_arrays.append(arr)
        return arr

    ctx.call = tracked_call
    ctx.wrap = tracked_wrap

    lr = 0.015
    losses = []
    for step in range(steps):
        tree = random_tree(rng, depth=5)
        target = np.tanh(tree_sum(tree) * 0.15)
        trace = []
        h = net.encode(tree, trace)
        pred = ctx.call("out", torch.matmul, [h, net.w["out"]])[0]
        err = float(pred.value[0, 0]) - target
        losses.append(0.5 * err * err)

        # backprop (through DTR)
        grads = {"leaf": None, "l": None, "r": None}
        gh = ctx.call("d_out", lambda w: (err * w).T, [net.w["out"]])[0]
        g_wout = ctx.call("d_wout", lambda hh: err * hh.T, [h])[0]
        net.backward(trace, gh, grads)

        # SGD updates OUTSIDE DTR (concrete values -> fresh constants);
        # cuts the cross-step remat chain exactly as the paper prescribes.
        for k in ("leaf", "l", "r"):
            if grads[k] is not None:
                new_val = ctx.fetch(net.w[k]) - lr * ctx.fetch(grads[k])
                net.w[k].release()
                net.w[k] = ctx.wrap(new_val, name=f"w_{k}")
        new_out_val = ctx.fetch(net.w["out"]) - lr * ctx.fetch(g_wout)
        net.w["out"].release()
        net.w["out"] = ctx.wrap(new_out_val, name="w_out")

        # Release everything this step created (refcount -> eager eviction).
        for arr in step_arrays:
            arr.release()
        step_arrays.clear()

        if step % 8 == 0:
            print(f"step {step:3d} nodes={tree_size(tree):3d} "
                  f"loss={losses[-1]:.4f} evictions={ctx.rt.evictions} "
                  f"remat_runs={ctx.remat_runs}")
    return {"losses": losses, "ctx": ctx, "budget": budget,
            "over_budget": over[0]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; the CPU runs only "
                         "when asked for)")
    out = train(resolve_device(ap.parse_args(argv).device))
    losses, ctx = out["losses"], out["ctx"]
    first, last = np.mean(losses[:15]), np.mean(losses[-15:])
    print(f"\nloss {first:.4f} -> {last:.4f} "
          f"({'LEARNING' if last < first else 'noisy single-tree SGD'})")
    print(f"total evictions {ctx.rt.evictions}, remat runs {ctx.remat_runs}; "
          f"live bytes at most {out['over_budget']} B above the budget "
          f"{out['budget']} B, beyond each op's largest output")
    if ctx.remat_runs == 0:
        raise RuntimeError("budget never forced rematerialization")
    return out


if __name__ == "__main__":
    main()
