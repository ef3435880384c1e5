"""Logical-axis sharding rules on DTensor: the counterpart of
``repro.distributed.sharding``.

Model code annotates tensors with *logical* axes (``shard(x, "batch",
None, "embed")``); one rules table maps logical axes to the mesh's named
dims.  Changing the parallelism (data, tensor, FSDP, sequence, expert)
touches only this table or a run's overrides, never model code.

Mesh dims: ``("pod", "data", "model")`` multi-pod or ``("data", "model")``
single-pod (``launch/mesh.py``).  A spec (:data:`Spec`) is the port's
``PartitionSpec``: one entry per tensor dim, each ``None`` (replicated), a
mesh dim's name, or a tuple of names (sharded over their product, major
first).  :func:`placements` turns a spec into DTensor placements on a
``DeviceMesh``; :class:`AbstractMesh` (names and sizes, no devices) lets
specs be computed for a mesh that does not exist here, as JAX's
``AbstractMesh`` does.
"""
from __future__ import annotations

import contextlib
import sys
import threading
from typing import NamedTuple, Optional, Union

import torch

from ..models.params import TORCH_DTYPES, ParamInfo, tree_map

# Logical axis -> mesh dim (or tuple of dims, or None = replicated).
LOGICAL_RULES: dict[str, object] = {
    "batch": ("pod", "data"),   # data parallel over pod x data
    "seq": None,                # sequence replicated by default (SP flips this)
    "seq_model": "model",       # explicit sequence-parallel annotation
    "embed": None,              # activation d_model dim replicated
    "heads": "model",           # TP over attention heads
    "kv_heads": "model",
    "mlp": "model",             # TP over FFN hidden
    "vocab": "model",           # TP over vocab (embedding + logits)
    "expert": "model",          # EP: experts over model axis
    "expert_cap": ("pod", "data"),  # expert capacity dim over data
    "kv_seq": None,             # KV-cache sequence dim
    "fsdp": ("pod", "data"),    # param dim additionally sharded when FSDP on
    "lru": "model",             # RG-LRU width
    "conv": None,
}

Entry = Union[None, str, tuple]
Spec = tuple   # of Entry, one per tensor dim


class AbstractMesh(NamedTuple):
    """A mesh's dim sizes and names, without devices."""
    shape: tuple
    axis_names: tuple


def mesh_dims(mesh) -> dict:
    """``{name: size}`` of a ``DeviceMesh`` or an :class:`AbstractMesh`."""
    if isinstance(mesh, AbstractMesh):
        return dict(zip(mesh.axis_names, mesh.shape))
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


class _State(threading.local):
    def __init__(self):
        self.mesh = None
        self.overrides: dict[str, object] = {}
        self.fsdp: bool = False


_STATE = _State()


@contextlib.contextmanager
def mesh_context(mesh, overrides: Optional[dict] = None, fsdp: bool = False):
    """Activate a mesh and rule overrides for the model's ``shard`` calls."""
    prev = (_STATE.mesh, _STATE.overrides, _STATE.fsdp)
    _STATE.mesh = mesh
    _STATE.overrides = dict(overrides or {})
    _STATE.fsdp = fsdp
    try:
        yield mesh
    finally:
        _STATE.mesh, _STATE.overrides, _STATE.fsdp = prev


def current_mesh():
    return _STATE.mesh


def fsdp_enabled() -> bool:
    return _STATE.fsdp


def _resolve(axis: Optional[str], dims: dict) -> Entry:
    if axis is None:
        return None
    phys = {**LOGICAL_RULES, **_STATE.overrides}.get(axis, None)
    if phys is None:
        return None
    if isinstance(phys, (tuple, list)):
        present = tuple(a for a in phys if a in dims)
        return present if present else None
    return phys if phys in dims else None


def _fit(r: Entry, dim: Optional[int], dims: dict) -> Entry:
    """Keep only a prefix of mesh dims whose product divides ``dim``.

    GQA head counts (3, 2, 1...) and tiny batches don't divide a 16-way
    dim; the spec degrades to replication (or partial sharding for tuple
    entries) instead of failing, the divisibility rule GSPMD enforces on
    explicit shardings, and which keeps DTensor shards even."""
    if r is None or dim is None:
        return r
    kept, prod = [], 1
    for a in (r if isinstance(r, tuple) else (r,)):
        prod *= dims[a]
        if dim % prod:
            break
        kept.append(a)
    if not kept:
        return None
    return tuple(kept) if len(kept) > 1 else kept[0]


def pspec(*axes: Optional[str], mesh=None,
          shape: Optional[tuple] = None) -> Spec:
    """The spec of logical ``axes`` under the active rules.

    With ``shape``, mesh dims that don't divide the tensor dim are dropped
    (prefix-reduced for tuple entries).  Two tensor dims never map to one
    mesh dim: the later one is replicated.  No mesh: ``()``."""
    mesh = mesh if mesh is not None else _STATE.mesh
    if mesh is None:
        return ()
    dims = mesh_dims(mesh)
    resolved, used = [], set()
    for i, ax in enumerate(axes):
        r = _resolve(ax, dims)
        if shape is not None:
            r = _fit(r, shape[i] if i < len(shape) else None, dims)
        flat = entry_dims(r)
        if any(f in used for f in flat):
            r = None
        else:
            used.update(flat)
        resolved.append(r)
    return tuple(resolved)


def entry_dims(entry: Entry) -> tuple:
    """The mesh dims a spec entry names, major first (``()`` for
    ``None``)."""
    return entry if isinstance(entry, tuple) else (entry,) if entry else ()


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(i)`` on every
    mesh dim that tensor dim ``i`` names (a tuple entry names several, in
    mesh order), ``Replicate()`` on the others."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh_dims(mesh))
    out = [Replicate() for _ in names]
    for i, entry in enumerate(spec):
        for a in entry_dims(entry):
            out[names.index(a)] = Shard(i)
    return tuple(out)


def local_shape(shape: tuple, spec: Spec, mesh) -> tuple:
    """A device's shard shape of a ``shape`` tensor laid out by ``spec``
    (``_fit`` keeps every shard even)."""
    dims = mesh_dims(mesh)
    out = list(shape)
    for i, entry in enumerate(spec):
        for a in entry_dims(entry):
            out[i] //= dims[a]
    return tuple(out)


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (the dry run's state; never on the card's
    one-device path, where no DTensor is made, nor before
    ``torch.distributed.tensor`` is imported)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def shard(x, *axes: Optional[str]):
    """A logical sharding constraint: a DTensor is redistributed to the
    spec of ``axes``; a plain tensor, or any tensor without an active mesh,
    is returned as it is (on one card every placement is replicated)."""
    mesh = _STATE.mesh
    if mesh is None or isinstance(mesh, AbstractMesh):
        return x
    if not is_dtensor(x):
        return x
    want = placements(pspec(*axes, mesh=mesh, shape=tuple(x.shape)), mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def local_by_axes(fn, args, in_axes, out_axes, partial: tuple = ()):
    """``fn`` on each device's shards (``local_map``), its DTensor
    arguments first laid out by their logical axes ``in_axes`` (one tuple
    an argument) and its outputs taken as laid out by ``out_axes`` (one
    ``(axes, shape)`` an output), and as partial sums over the mesh dims
    named in ``partial``.  For computations that act on each (batch row,
    head) alone, such as attention's and the recurrences' einsums over
    both: DTensor would fold the two sharded dims into one and cannot, and
    its shape propagation fails on fake tensors.

    Gradients: an argument replicated over a mesh dim on which the outputs
    are sharded or partial gets a partial gradient there (each device's
    share of the sum over its rows, heads or slices), reduced where
    DTensor next needs it; over a mesh dim on which the outputs are
    replicated too, every device computed the same, and so the gradient is
    replicated."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map
    mesh = args[0].device_mesh
    names = list(mesh_dims(mesh))

    def layout(axes, shape):
        return list(placements(pspec(*axes, mesh=mesh, shape=tuple(shape)),
                               mesh))

    outs = [layout(a, s) for a, s in out_axes]
    for out in outs:
        for m in partial:
            if m in names:
                out[names.index(m)] = Partial()
    ins = [layout(a, x.shape) for a, x in zip(in_axes, args)]
    split = [any(not out[m].is_replicate() for out in outs)
             for m in range(len(names))]
    grads = tuple([Partial() if split[m] and p.is_replicate() else p
                   for m, p in enumerate(pl)] for pl in ins)
    return local_map(fn, out_placements=tuple(outs) if len(outs) > 1
                     else outs[0], in_placements=tuple(ins),
                     in_grad_placements=grads, device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def vocab_parallel_nll(logits, targets):
    """The mean NLL of ``targets`` under ``logits`` [..., V] (f32), a
    DTensor whose vocab dim may be sharded: the log-sum-exp by DTensor's
    reductions (a max and a sum over the shards), the target's logit by
    each device from its own vocab shard (``local_map``, a partial sum
    that is zero off the shard).  Nothing gathers the vocab, as
    Megatron's vocab-parallel cross entropy; ``loss_fn``'s formula on one
    device, the same function."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh, dim = logits.device_mesh, logits.ndim - 1
    by_vocab = [m for m, p in enumerate(logits.placements)
                if p.is_shard(dim)]
    t_pl = [Replicate() if p.is_shard(dim) else p
            for p in logits.placements]
    top = logits.detach().amax(-1, keepdim=True).redistribute(mesh, t_pl)
    lse = (logits - top).exp().sum(-1).redistribute(mesh, t_pl).log() \
        + top[..., 0]

    def picked(lg, tg):
        n = lg.shape[-1]
        off = 0
        for m in by_vocab:     # this device's first vocab row
            off = off * mesh.size(m) + mesh.get_local_rank(m)
        local = tg - off * n
        hit = (local >= 0) & (local < n)
        val = torch.gather(lg, -1, local.clamp(0, n - 1)[..., None])[..., 0]
        return val * hit

    out_pl = [Partial() if m in by_vocab else p for m, p in enumerate(t_pl)]
    target = local_map(picked, out_placements=out_pl,
                       in_placements=(list(logits.placements), t_pl),
                       device_mesh=mesh, redistribute_inputs=True)(
        logits, targets)
    # Both terms laid out as the targets (the partial sums reduced over the
    # vocab's devices): else DTensor may scatter the difference over the
    # vocab's mesh dim, and the backward then gathers the whole vocab.
    nll = lse - target.redistribute(mesh, t_pl)
    return nll.sum() / nll.numel()


# ---------------------------------------------------------------------------
# Parameter metadata
# ---------------------------------------------------------------------------

def param_pspec(info: ParamInfo, mesh=None,
                fsdp: Optional[bool] = None) -> Spec:
    """The spec of one parameter: its logical axes, and with FSDP its
    ``fsdp_dim`` over ``("pod", "data")`` where that dim has no axis."""
    mesh = mesh if mesh is not None else _STATE.mesh
    if mesh is None:
        return ()
    fsdp = _STATE.fsdp if fsdp is None else fsdp
    axes = list(info.axes) if info.axes else [None] * len(info.shape)
    if fsdp and info.fsdp_dim is not None and axes[info.fsdp_dim] is None:
        axes[info.fsdp_dim] = "fsdp"
    return pspec(*axes, mesh=mesh, shape=tuple(info.shape))


def _is_info(x) -> bool:
    return isinstance(x, ParamInfo)


def axis_resources(tree, mesh=None, fsdp: bool = False):
    """A tree of ParamInfo -> the tree of their DTensor placements."""
    mesh = mesh if mesh is not None else _STATE.mesh
    return tree_map(lambda i: placements(
        param_pspec(i, mesh=mesh, fsdp=fsdp), mesh), tree)


def shape_structs(tree, device="meta"):
    """A tree of ParamInfo -> empty tensors of their shapes and dtypes on
    ``device`` (``meta`` by default; under ``FakeTensorMode``, fake ones):
    the dry run's stand-ins, which allocate nothing."""
    return tree_map(lambda i: torch.empty(
        i.shape, dtype=TORCH_DTYPES[i.dtype], device=device), tree)
