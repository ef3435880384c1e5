"""Named tensors, checkpoint regions and selective-checkpoint policies: the
counterparts of ``jax.ad_checkpoint.checkpoint_name`` and
``jax.checkpoint_policies``, below both the model and the planner.

A policy here is a ``torch.utils.checkpoint`` selective-checkpoint policy
(``policy(ctx, op, *args, **kwargs) -> CheckpointPolicy``): it sees every
dispatcher op of the checkpointed function and saves the outputs of the ops
it names; everything else runs again in the backward.  Kernels launched
through ``ctypes`` inside an ``autograd.Function`` are invisible to it: it
sees only their allocations, which no policy here ever saves (the kernel
fills them out of band, so a cached allocation would hold nothing).

A tag costs a copy (a custom op may not return an alias of its input), so
:func:`tag` makes one only where something reads the name: inside a region
whose policy saves by name, and where :func:`tagging` is on (the planner's
trace).  Elsewhere it returns its input.
"""
from __future__ import annotations

import contextvars
import functools
from contextlib import contextmanager
from functools import partial

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)


@torch.library.custom_op("repro_torch::tag", mutates_args=())
def _tag(x: torch.Tensor, name: str) -> torch.Tensor:
    # A custom op may not return an alias of its input: a copy.
    return x.clone()


@_tag.register_fake
def _(x, name):
    return torch.empty_like(x)


_tag.register_autograd(lambda ctx, grad: (grad, None))
TAG_OP = torch.ops.repro_torch.tag.default
_TAGGING = contextvars.ContextVar("repro_torch_tagging", default=False)


@contextmanager
def tagging(on: bool = True):
    """Within, :func:`tag` makes its copy (``on``) or returns its input."""
    token = _TAGGING.set(on)
    try:
        yield
    finally:
        _TAGGING.reset(token)


def tag(x: torch.Tensor, name: str) -> torch.Tensor:
    """``x`` under ``name``: the counterpart of ``checkpoint_name``.

    Under :func:`tagging`, a dispatcher op (``repro_torch::tag``) that a
    policy and ``make_fx`` see: a copy of ``x`` (one read and one write of
    its bytes) whose gradient passes through unchanged.  Otherwise ``x``
    itself."""
    return _tag(x, name) if _TAGGING.get() else x


_ALLOCS = frozenset(("empty", "empty_like", "empty_strided", "new_empty",
                     "new_empty_strided"))
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def saving(save, by_name: bool = False):
    """The policy that saves an op's outputs where ``save(op, args)`` is
    true, never an allocation's.  ``by_name``: it reads tags, so the
    regions it governs run under :func:`tagging`."""

    def policy(ctx, op, *args, **kwargs):
        if getattr(op, "_opname", None) not in _ALLOCS and save(op, args):
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    policy.by_name = by_name
    return policy


nothing_saveable = saving(lambda op, args: False)
everything_saveable = saving(lambda op, args: True)
# Matrix products with no batch dims: mm and addmm (the projections), not
# bmm (attention's einsums in the plain version).
dots_with_no_batch_dims_saveable = saving(lambda op, args: op in _DOTS)


def save_only_these_names(*names):
    """Save the outputs of the tags named, nothing else."""
    keep = frozenset(names)
    return saving(lambda op, args: op is TAG_OP and args[1] in keep,
                  by_name=True)


def checkpointed(fn, policy):
    """``fn`` under ``torch.utils.checkpoint`` (non-reentrant) with
    ``policy``: the counterpart of ``jax.checkpoint(fn, policy=...)``.  A
    policy that saves by name runs ``fn``, and its recompute in the
    backward, under :func:`tagging`."""
    context_fn = partial(create_selective_checkpoint_contexts, policy)
    if getattr(policy, "by_name", False):
        body = fn

        def fn(*args, **kwargs):
            with tagging():
                return body(*args, **kwargs)

    return lambda *args, **kwargs: checkpoint(
        fn, *args, use_reentrant=False, context_fn=context_fn, **kwargs)


class _Regions:
    def __init__(self, policy):
        self.policy, self.count = policy, 0


_REGIONS = contextvars.ContextVar("repro_torch_regions", default=None)


def region(fn):
    """Mark ``fn`` (a layer or a block of layers) as one checkpoint region.

    Called inside :func:`in_regions`, ``fn`` runs under
    :func:`checkpointed` with that policy; anywhere else it is ``fn``.  A
    non-reentrant checkpoint recomputes its whole region at the first
    saved tensor the backward reads and holds what it recomputes until the
    region's backward ends, so one region over a whole stack holds every
    recomputed activation at once; a region per layer holds one layer's."""

    @functools.wraps(fn)
    def call(*args, **kwargs):
        state = _REGIONS.get()
        if state is None:
            return fn(*args, **kwargs)
        state.count += 1
        if state.policy is None:
            return fn(*args, **kwargs)
        token = _REGIONS.set(None)      # regions do not nest
        try:
            return checkpointed(fn, state.policy)(*args, **kwargs)
        finally:
            _REGIONS.reset(token)

    return call


@contextmanager
def counting_regions():
    """Count the :func:`region` calls within (each runs as plain ``fn``);
    yields the counter (``.count``)."""
    state = _Regions(None)
    token = _REGIONS.set(state)
    try:
        yield state
    finally:
        _REGIONS.reset(token)


def in_regions(fn, policy):
    """``fn`` with each :func:`region` it calls checkpointed under
    ``policy``."""

    @functools.wraps(fn)
    def call(*args, **kwargs):
        token = _REGIONS.set(_Regions(policy))
        try:
            return fn(*args, **kwargs)
        finally:
            _REGIONS.reset(token)

    return call
