"""DTR as a trace-time rematerialization planner (the torch form).

The counterpart of ``repro.core.planner``: the paper's online algorithm run
once over a traced step (the "just in time" static planning of its Sec. 6,
possible because DTR's greedy heuristic costs milliseconds), and its
decisions enforced by ``torch.utils.checkpoint``.  Pipeline:

  1. ``trace_to_log``: the joint forward + backward aten graph of a function
     that calls ``torch.autograd.grad``, traced by ``make_fx`` on fake
     tensors (the counterpart of ``jax.make_jaxpr``; nothing is allocated),
     becomes a DTR op log, with tensor sizes from each node's fake value and
     the analytic FLOPs cost model of the reference at aten granularity.
  2. ``plan``: replay the log through the DTR engine under a byte budget;
     tensors tagged by ``core.remat.tag`` that were never evicted under
     pressure form the save set.
  3. ``Plan.policy``: the save set becomes a selective-checkpoint policy
     (``core.remat.save_only_these_names``), which ``dtr_checkpoint``
     applies to each ``core.remat.region`` of the function.

``make_fx`` sees dispatcher ops only: a kernel launched through ``ctypes``
is invisible to it, and a fake CUDA tensor has no memory to launch on, so a
model step is traced on the CPU, where the wrappers take the plain versions
(``trace.capture.capture_train_step``).

Also provides ``plan_layer_blocks`` / ``sqrt_block_size``: the √N segment
size of Thm 3.1 for a stack of layers.
"""
from __future__ import annotations

import math
import operator
from dataclasses import dataclass, field
from typing import Callable

import torch
from torch.fx.experimental.proxy_tensor import make_fx
from torch.utils import _pytree as pytree

from . import remat
from .graph import Log, LogBuilder, replay
from .heuristics import by_name
from .runtime import DTRRuntime, OOMError


# ---------------------------------------------------------------------------
# Cost model over aten nodes
# ---------------------------------------------------------------------------

# Ops whose outputs view their input's storage (the paper's alias
# semantics).  The tag is not one: it is a copy where it runs at all.
ALIAS_OPS = frozenset((
    "view", "_unsafe_view", "t", "transpose", "permute", "expand", "slice",
    "select", "unsqueeze", "squeeze", "detach", "alias", "unbind", "split",
    "split_with_sizes", "as_strided"))
TRANSCENDENTAL = frozenset((
    "exp", "exp2", "expm1", "log", "log1p", "log2", "tanh", "sigmoid", "erf",
    "rsqrt", "sqrt", "sin", "cos", "pow", "silu", "gelu", "_softmax",
    "_log_softmax"))
REDUCTIONS = frozenset((
    "sum", "mean", "amax", "amin", "max", "min", "prod", "argmax", "argmin",
    "cumsum", "logsumexp", "var", "std"))
# Data movement and metadata: 0.1 per output element, as the reference
# counts reshape, convert_element_type, gather, scatter, iota, pad, ...
METADATA = ALIAS_OPS | frozenset((
    "_to_copy", "clone", "copy", "copy_", "tag", "cat", "stack", "index",
    "index_select", "gather", "embedding", "scatter", "scatter_add",
    "index_put", "index_add", "where", "constant_pad_nd", "flip", "arange",
    "full", "zeros", "ones", "empty", "empty_like", "empty_strided",
    "new_zeros", "new_empty", "new_full", "ones_like", "zeros_like",
    "full_like", "scalar_tensor", "lift_fresh_copy", "slice_backward",
    "select_backward", "embedding_dense_backward", "slice_scatter",
    "select_scatter"))


def _val(x):
    return x.meta.get("val") if isinstance(x, torch.fx.Node) else None


def _elems(t) -> int:
    return t.numel() if isinstance(t, torch.Tensor) else 0


def _bytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) \
        else 0


def node_flops(node: torch.fx.Node) -> float:
    """Analytic FLOPs of one aten node: ``2 m n k`` for ``mm``/``addmm``
    (times the batch for ``bmm``/``baddbmm``), 4 per output element for
    transcendentals, the input's elements for reductions, 0.1 per output
    element for data movement and metadata, 1 per output element
    otherwise."""
    op = getattr(node.target, "_opname", str(node.target))
    out = _val(node)
    outs = out if isinstance(out, (tuple, list)) else (out,)
    out_elems = sum(_elems(t) for t in outs)
    shapes = [_val(a).shape for a in node.args
              if isinstance(_val(a), torch.Tensor)]
    if op in ("mm", "addmm", "bmm", "baddbmm"):
        a, b = shapes[-2:]
        batch = a[0] if len(a) == 3 else 1
        return 2.0 * batch * a[-2] * a[-1] * b[-1]
    if op in TRANSCENDENTAL:
        return 4.0 * out_elems
    if op in REDUCTIONS:
        return float(math.prod(shapes[0])) if shapes else float(out_elems)
    if op in METADATA:
        return 0.1 * out_elems
    return float(out_elems)


# ---------------------------------------------------------------------------
# aten graph -> DTR log
# ---------------------------------------------------------------------------

@dataclass
class TracedGraph:
    log: Log
    named: dict[str, str]            # tag name -> log tensor name (the last)
    outputs: list[str]               # log tensor names of the outputs
    total_bytes: int = 0
    total_flops: float = 0.0


def trace_to_log(fn: Callable, *example_args, name: str = "traced",
                 tagged: bool = True, **example_kwargs) -> TracedGraph:
    """Trace ``fn`` (usually a step that calls ``torch.autograd.grad``, so
    the log holds the backward's lifetimes) and convert its aten graph into
    a DTR operator log: placeholders and constants become pinned constants,
    each aten node a call whose outputs alias its first input for the view
    ops, and releases follow each tensor's last use.

    ``tagged``: trace under ``remat.tagging``, so each tag is in the log as
    the copy it is under a plan's policy; False traces ``fn`` as it runs
    outside a region that saves by name (no tags, ``named`` empty).
    ``make_fx`` traces on fake tensors: inputs may be real or fake (any
    nesting), and fake ones keep their fake mode, so a full-width model
    traces without allocating."""
    with remat.tagging(tagged):
        gm = make_fx(lambda *a: fn(*a, **example_kwargs),
                     tracing_mode="fake")(*example_args)
    b = LogBuilder(name=name)
    env: dict[torch.fx.Node, list] = {}   # node -> log names (None: no tensor)
    named: dict[str, str] = {}
    totals = {"bytes": 0, "flops": 0.0}

    def tensors_of(x) -> list[str]:
        return [env[n][0] for n in pytree.tree_leaves(x)
                if isinstance(n, torch.fx.Node) and env.get(n)
                and env[n][0] is not None]

    for node in gm.graph.nodes:
        if node.op == "placeholder":
            val = _val(node)
            env[node] = [b.constant(_bytes(val), name=f"in_{node.name}")
                         if isinstance(val, torch.Tensor) else None]
        elif node.op == "get_attr":
            val = getattr(gm, node.target)
            env[node] = [b.constant(_bytes(val), name=node.name)
                         if isinstance(val, torch.Tensor) else None]
        elif node.op == "call_function" and node.target is operator.getitem:
            parent, idx = node.args
            env[node] = [env[parent][idx]] if env.get(parent) else [None]
        elif node.op == "call_function":
            val = _val(node)
            vals = list(val) if isinstance(val, (tuple, list)) else [val]
            keep = [i for i, v in enumerate(vals)
                    if isinstance(v, torch.Tensor)]
            ins = tensors_of((node.args, node.kwargs))
            op = getattr(node.target, "_opname", str(node.target))
            if not keep:
                env[node] = [None] * len(vals)
                continue
            cost = max(node_flops(node), 1.0)
            sizes = [_bytes(vals[i]) for i in keep]
            aliases = None
            if ins and (op in ALIAS_OPS or op.endswith("_")):
                aliases = [ins[0]] * len(keep)    # views; in-place results
            outs = b.call(ins, sizes, cost, op, aliases=aliases)
            env[node] = [None] * len(vals)
            for i, t in zip(keep, outs):
                env[node][i] = t
            totals["bytes"] += sum(sizes)
            totals["flops"] += cost
            if op == "tag":
                named[node.args[1]] = outs[0]
        elif node.op == "output":
            outputs = tensors_of(node.args[0])
    log = b.auto_release(keep=outputs)
    return TracedGraph(log=log, named=named, outputs=outputs,
                       total_bytes=totals["bytes"],
                       total_flops=totals["flops"])


# ---------------------------------------------------------------------------
# Planning
# ---------------------------------------------------------------------------

@dataclass
class Plan:
    budget_bytes: float
    feasible: bool
    save_names: list[str] = field(default_factory=list)
    remat_names: list[str] = field(default_factory=list)
    est_slowdown: float = 1.0
    est_peak_bytes: float = 0.0
    evictions: int = 0

    def policy(self):
        """A selective-checkpoint policy saving exactly the planned names
        (every op's output when nothing is rematerialized)."""
        if not self.remat_names:
            return remat.everything_saveable
        if not self.save_names:
            return remat.nothing_saveable
        return remat.save_only_these_names(*self.save_names)


def plan(fn: Callable, *example_args, budget_bytes: float,
         heuristic: str = "h_dtr_eq", **example_kwargs) -> Plan:
    """Run the DTR greedy simulation over ``fn``'s graph under a budget.

    Returns the save/remat split over the tagged tensors.  ``fn`` should be
    the *differentiated* step (one that calls ``torch.autograd.grad``) so
    the simulation sees the true forward + backward lifetimes.
    """
    tg = trace_to_log(fn, *example_args, name="plan", **example_kwargs)
    rt = DTRRuntime(budget=float(budget_bytes),
                    heuristic=by_name(heuristic), dealloc="eager")
    evicted_names: set[str] = set()

    orig_evict = rt._evict

    def traced_evict(s):
        # Only *pressure* evictions of still-live tensors are remat
        # decisions; eager evictions at refcount zero are ordinary frees.
        if s.refs > 0:
            for tid in s.tensor_tids:
                evicted_names.add(rt.tensors[tid].name)
        orig_evict(s)

    rt._evict = traced_evict
    try:
        replay(tg.log, rt)
    except OOMError:
        return Plan(budget_bytes=budget_bytes, feasible=False,
                    remat_names=sorted(tg.named))
    save, remat = [], []
    for cname, log_t in tg.named.items():
        (remat if log_t in evicted_names else save).append(cname)
    return Plan(budget_bytes=budget_bytes, feasible=True,
                save_names=sorted(save), remat_names=sorted(remat),
                est_slowdown=rt.slowdown(), est_peak_bytes=rt.peak_memory,
                evictions=rt.evictions)


def grad_of_sum(fn: Callable) -> Callable:
    """The gradient of ``sum(fn(*args))`` (in f32) in the floating tensors
    of ``fn``'s first argument, as ``jax.grad`` takes it."""

    def grad_fn(first, *rest, **kwargs):
        leaves, spec = pytree.tree_flatten(first)
        with torch.enable_grad():
            xs = [x.detach().requires_grad_()
                  if isinstance(x, torch.Tensor) and x.is_floating_point()
                  else x for x in leaves]
            out = fn(pytree.tree_unflatten(xs, spec), *rest, **kwargs)
            wrt = [x for x in xs
                   if isinstance(x, torch.Tensor) and x.requires_grad]
            return torch.autograd.grad(out.sum().float(), wrt)

    return grad_fn


def dtr_checkpoint(fn: Callable, *example_args, budget_bytes: float,
                   grad_fn: Callable | None = None,
                   heuristic: str = "h_dtr_eq", **example_kwargs):
    """``fn`` under a DTR-planned policy: returns ``(planned fn, plan)``.

    ``grad_fn`` (default: :func:`grad_of_sum` of ``fn``) is traced for
    planning so the simulation sees backward lifetimes.  The policy governs
    each ``remat.region`` that ``fn`` calls (a layer or a block of them); a
    ``fn`` that calls none is one region, as ``jax.checkpoint(fn,
    policy=...)`` is, and a non-reentrant checkpoint recomputes a region
    whole at its first backward use, so one region over a stack holds as
    much as no checkpoint at all.

    Nothing enforces ``budget_bytes``: the policy saves or recomputes only
    the tagged tensors, where the engine also evicts untagged ones, so the
    step's peak follows ``est_peak_bytes`` only as far as the tags carry
    the activations (fig4's MLP at d 4096, a region a layer: within 3.3%
    of it on an H100 80GB HBM3).
    """
    with remat.counting_regions() as regions:
        p = plan(grad_fn or grad_of_sum(fn), *example_args,
                 budget_bytes=budget_bytes, heuristic=heuristic,
                 **example_kwargs)
    if regions.count:
        return remat.in_regions(fn, p.policy()), p
    return remat.checkpointed(fn, p.policy()), p


# ---------------------------------------------------------------------------
# Segment-level planning for layer stacks
# ---------------------------------------------------------------------------

def plan_layer_blocks(n_layers: int, layer_act_bytes: float,
                      budget_bytes: float) -> int:
    """Pick the remat block size for a stack of ``n_layers``.

    DTR's even-spacing behaviour (Lemma A.1) on a homogeneous chain puts
    checkpoints every L/B layers; with a byte budget this is
    ceil(n_layers * layer_act_bytes / budget) layers per block, clamped to
    [1, n_layers].  Block size √L falls out when the budget equals
    √L·layer_act_bytes — the Thm 3.1 regime.
    """
    if budget_bytes <= 0 or n_layers <= 1:
        return 1
    blocks = max(int(budget_bytes // max(layer_act_bytes, 1)), 1)
    size = math.ceil(n_layers / blocks)
    return max(1, min(size, n_layers))


def sqrt_block_size(n_layers: int) -> int:
    return max(1, int(round(math.sqrt(n_layers))))
