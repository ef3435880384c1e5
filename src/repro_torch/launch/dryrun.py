"""Multi-pod dry run: trace every (arch x shape x mesh) cell on a fake
256- or 512-rank process group, as an H100 cluster would run it.

The counterpart of ``repro.launch.dryrun``, which lowers and compiles each
cell for a TPU pod under 512 forced host devices.  Here each cell:

  1. starts torch's fake process group (``FakeStore``, backend ``"fake"``)
     at world 256 (mesh (16, 16), ``("data", "model")``) or 512 ((2, 16,
     16), ``("pod", "data", "model")``), as rank 0, and destroys it after;
  2. under ``FakeTensorMode`` (nothing allocates), makes the parameters,
     the optimizer state, the batch or the KV caches DTensors with the
     port's placements (``launch/steps.py``), their local shards fake
     tensors of the mesh's host;
  3. runs the port's own step on them: the train step with gradient
     accumulation, a prefill (``forward`` to the last row's logits) or a
     decode step.  The kernels' dispatcher ops (``repro_torch::flash_fwd``
     and the rest) take DTensors (``distributed/kernel_sharding.py``) and
     the fake local shards that ``local_map`` hands the model's per-device
     code (their fake mode is marked ``mesh_shards``, which
     ``kernels._build.sharded`` reads), so the step traces the same entry
     points the card runs, never their plain versions;
  4. records, as JSON with the reference's keys: memory (the arguments'
     bytes a device, exact from the local shard shapes, and the peak a
     device from ``MemTracker``), cost (``FlopCounterMode``'s FLOPs and the
     bytes every op reads and writes, both of the logical program, over
     every microbatch), the collectives' bytes a device by kind (a
     dispatch mode over the c10d functional collectives that DTensor's
     redistributions issue) and the roofline terms on H100 peaks
     (``analysis/roofline.py``).  ``compile_s`` is the trace's wall time.

A cell "fits" under 80 GiB a device.  Usage:

  python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape decode_32k \\
      --mesh both --device cpu
  python -m repro_torch.launch.dryrun --arch mixtral-8x7b --mesh both
  python -m repro_torch.launch.dryrun --all --mesh both

``--arch`` without ``--shape`` runs every shape of that arch; the whole
sweep runs fastest as one such process an arch, side by side.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback
import weakref

import torch

from .. import configs
from ..analysis.roofline import (model_flops_decode, model_flops_prefill,
                                 model_flops_train, roofline)
from ..distributed.sharding import mesh_context, placements, pspec
from ..models import model as M
from ..models.params import TORCH_DTYPES, tree_items, tree_map
from ..optim import adafactor, adamw
from ..optim.optimizers import OptState
from .mesh import make_production_mesh
from .steps import (_opt_state_infos, batch_shardings, batch_spec,
                    cache_shardings, make_serve_step, make_train_step,
                    state_shardings)

SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}

# long_500k needs sub-quadratic context handling: run for SSM/hybrid/
# windowed archs, skip for pure full-attention archs.
LONG_OK = {"recurrentgemma-2b", "rwkv6-1.6b", "gemma3-1b", "mixtral-8x7b"}

# Arch-specific dry-run settings (the reference's).
FSDP_ARCHS = {"deepseek-v3-671b", "mixtral-8x7b", "llama-3.2-vision-11b"}
OPTIMIZER = {"deepseek-v3-671b": "adafactor"}
GRAD_ACCUM = {"deepseek-v3-671b": 8, "mixtral-8x7b": 4,
              "llama-3.2-vision-11b": 4, "musicgen-large": 2}
BF16_PARAMS = {"deepseek-v3-671b", "mixtral-8x7b", "llama-3.2-vision-11b"}

_CANONICAL = [
    "recurrentgemma-2b", "smollm-135m", "llama3.2-1b", "qwen2-0.5b",
    "gemma3-1b", "llama-3.2-vision-11b", "musicgen-large", "rwkv6-1.6b",
    "deepseek-v3-671b", "mixtral-8x7b",
]
CELLS = [(a, s) for a in _CANONICAL for s in SHAPES]

DEVICE_BYTES = 80 * 2**30        # an H100's memory: a cell "fits" below it
PEAK_TENSORS = 8                 # the storages listed at each cell's peak


def rule_overrides(shape: str) -> dict:
    """The reference's logical-rule overrides per shape."""
    if SHAPES[shape]["kind"] == "train" or shape == "prefill_32k":
        return {"seq": "model"}
    if shape == "decode_32k":
        # Context parallelism: the KV cache's sequence over the model dim.
        return {"kv_seq": "model"}
    # long_500k, batch 1: all parallelism from sharding the context.
    return {"batch": None, "kv_seq": ("pod", "data", "model")}


@contextlib.contextmanager
def fake_world(n: int):
    """Torch's fake process group of ``n`` ranks, this process rank 0, for
    the duration (destroyed on exit, so the next cell may start another)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


class _Counts(torch.utils._python_dispatch.TorchDispatchMode):
    """What one device does: the FLOPs of its local ops by
    ``FlopCounterMode``'s formulas (its registry), the bytes they read and
    write (every tensor argument and result but of views and
    allocations), the bytes of each c10d functional collective's result,
    by kind (the reference's HLO convention), and the peak of its live
    storages.  A DTensor op is left to DTensor (``NotImplemented``), which
    runs it as local ops and the collectives of its redistributions, each
    of which comes back here, as ``CommDebugMode`` does.  Ops of DTensor's
    sharding propagation, which runs each op again on fake tensors of the
    global shape to learn its output's, do not count (:func:`_marked`):
    ``MemTracker`` counts them as the device's (24 GiB of them against
    0.46 GiB of shards in qwen2-0.5b's decode cell).  Live
    storages are tracked as ``MemTracker`` tracks them, by a weak
    reference to each storage, from the step's arguments on, and the
    ``PEAK_TENSORS`` largest of them live at the peak are kept, each with
    the op that made it and its local shape.  It also notes the largest
    plain tensor that met a DTensor op."""
    KINDS = {"all_gather_into_tensor": "all-gather",
             "all_gather_into_tensor_coalesced": "all-gather",
             "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
             "reduce_scatter_tensor": "reduce-scatter",
             "reduce_scatter_tensor_coalesced": "reduce-scatter",
             "all_to_all_single": "all-to-all"}

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.registry = flop_registry
        self.flops = 0
        self.bytes_accessed = 0
        self.coll = {}
        self.live = {}
        self.now = self.peak = 0
        self.made, self.peak_tensors = {}, []
        self._rising = False
        self.implicit = (0, None, None)

    def hold(self, t, op: str = "argument") -> None:
        """Count ``t``'s storage live until it is freed."""
        st = t.untyped_storage()
        key = st._cdata
        if key in self.live:
            return
        self.live[key] = n = st.nbytes()
        self.made[key] = (op, tuple(t.shape), str(t.dtype)[6:])
        self.now += n
        if self.now > self.peak:
            self.peak, self._rising = self.now, True
        weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        if self._rising:
            # The live set only grew since the last new peak: it is the
            # peak's.
            self.peak_tensors = self.largest()
        self._rising = False
        self.now -= self.live.pop(key)
        self.made.pop(key, None)

    def _implicit(self, func, args) -> None:
        """Note the largest plain tensor that meets a DTensor op (which
        ``implicit_replication`` takes as replicated: whatever is made
        from it is made whole on every device)."""
        from torch.distributed.tensor import DTensor
        for t in torch.utils._pytree.tree_leaves(args):
            if isinstance(t, torch.Tensor) and not isinstance(t, DTensor):
                n = t.numel() * t.element_size()
                if n > self.implicit[0]:
                    self.implicit = (n, func._opname, tuple(t.shape))

    def largest(self) -> list:
        """The largest live storages: (bytes, op, shape, dtype)."""
        import heapq
        return [(n, *self.made[k]) for k, n in heapq.nlargest(
            PEAK_TENSORS, self.live.items(), key=lambda kv: kv[1])]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            if not _PROPAGATING:
                self._implicit(func, (args, kwargs))
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if _PROPAGATING:
            return out
        results = [t for t in torch.utils._pytree.tree_leaves(out)
                   if isinstance(t, torch.Tensor)]
        for t in results:
            self.hold(t, func._opname)
        if func.namespace == "_c10d_functional":
            kind = self.KINDS.get(func._opname)
            if kind is not None:
                self.coll[kind] = self.coll.get(kind, 0) + sum(
                    t.numel() * t.element_size() for t in results)
        elif func.namespace in ("aten", "repro_torch") and \
                func._opname not in _VIEWS:
            formula = self.registry.get(func._overloadpacket)
            if formula is not None:
                self.flops += formula(*args, **kwargs, out_val=out)
            inputs = [t for t in torch.utils._pytree.tree_leaves(
                (args, kwargs)) if isinstance(t, torch.Tensor)]
            self.bytes_accessed += sum(t.numel() * t.element_size()
                                       for t in inputs + results)
        return out


# Ops that move no bytes: views, metadata and allocations.
_VIEWS = frozenset((
    "view", "_unsafe_view", "reshape", "expand", "permute", "transpose",
    "t", "unsqueeze", "squeeze", "select", "slice", "alias", "as_strided",
    "detach", "split", "split_with_sizes", "unbind", "chunk", "unflatten",
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "zeros", "zeros_like", "new_zeros", "ones_like", "full", "arange",
    "lift_fresh", "_to_copy_meta", "view_as_real", "view_as_complex"))


_PROPAGATING: list = []


@contextlib.contextmanager
def _marked():
    """Within, DTensor's shape propagation sets ``_PROPAGATING`` while it
    runs an op on global-shape fake tensors."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    name = next(n for n in ("_propagate_tensor_meta_non_cached",
                            "_propagate_tensor_meta")
                if hasattr(ShardingPropagator, n))
    orig = getattr(ShardingPropagator, name)

    def marked(self, *args, **kwargs):
        _PROPAGATING.append(True)
        try:
            return orig(self, *args, **kwargs)
        finally:
            _PROPAGATING.pop()

    setattr(ShardingPropagator, name, marked)
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, orig)


def _dtensors(tree, place, mesh):
    """ParamInfo tree -> DTensors laid out by the matching placements,
    their local shards fake tensors on the card."""
    return tree_map(lambda i, pl: _input(i.shape, TORCH_DTYPES[i.dtype],
                                         mesh, pl), tree, place)


def _local_bytes(tree) -> int:
    return sum(t.to_local().numel() * t.to_local().element_size()
               for _, t in tree_items(tree))


def build_cell(arch: str, shape: str, mesh, overrides=None, remat="full",
               extra_cfg=None, grad_accum=None, fsdp=None) -> dict:
    """Trace one cell on ``mesh`` (a ``DeviceMesh`` of the fake world) and
    return its record."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import implicit_replication

    from ..distributed import kernel_sharding
    kernel_sharding.register()

    spec = SHAPES[shape]
    cfg = configs.get(arch)
    if arch in BF16_PARAMS:
        cfg = cfg.replace(param_dtype="bfloat16")
    cfg = cfg.replace(remat=remat, **(extra_cfg or {}))
    if fsdp is None:
        fsdp = arch in FSDP_ARCHS
    opt_name = OPTIMIZER.get(arch, "adamw")
    chips = mesh.size()
    rules = rule_overrides(shape)
    rules.update(overrides or {})
    ga = 1
    if spec["kind"] == "train":
        ga = grad_accum or GRAD_ACCUM.get(arch, 1)

    counts = _Counts()
    fake = FakeTensorMode(allow_non_fake_inputs=True)
    fake.mesh_shards = True           # its tensors are shards of the mesh
    with mesh_context(mesh, overrides=rules, fsdp=fsdp), fake:
        defs = M.param_defs(cfg)
        p_pl, o_pl = state_shardings(cfg, mesh, opt_name, fsdp=fsdp)
        params = _dtensors(defs, p_pl, mesh)
        args = [params]
        if spec["kind"] == "train":
            infos = _opt_state_infos(opt_name, defs)
            opt_state = OptState(0, _dtensors(infos, o_pl.inner, mesh))
            batch = _batch(cfg, spec, mesh)
            opt = adafactor() if opt_name == "adafactor" else adamw(lr=3e-4)
            step = make_train_step(cfg, opt, grad_accum=ga)
            args += [opt_state.inner, batch]
            mf = model_flops_train(cfg, spec["batch"] * spec["seq"])

            def run():
                step(params, opt_state, batch)
        elif spec["kind"] == "prefill":
            batch = _batch(cfg, spec, mesh)
            args.append(batch)
            mf = model_flops_prefill(cfg, spec["batch"] * spec["seq"])

            def run():
                with torch.no_grad():
                    logits = M.forward(cfg, params, batch["tokens"],
                                       batch.get("img_embed"))
                    return logits[:, -1].float()
        else:
            b = spec["batch"]
            cdefs = M.cache_defs(cfg, b, spec["seq"])
            cache = _dtensors(
                cdefs, cache_shardings(cfg, mesh, b, spec["seq"]), mesh)
            tok_shape = (b, 1, cfg.n_codebooks) if cfg.n_codebooks \
                else (b, 1)
            tok = _input(tok_shape, torch.int32, mesh, placements(
                pspec("batch", mesh=mesh) if b > 1 else (), mesh))
            pos = DTensor.from_local(
                torch.zeros((), dtype=torch.int32, device=mesh.device_type),
                mesh, [Replicate()] * mesh.ndim, run_check=False)
            img = None
            if cfg.cross_attn_dim:
                img = _input((b, cfg.cross_attn_tokens, cfg.cross_attn_dim),
                             torch.bfloat16, mesh, placements(
                                 pspec("batch", mesh=mesh) if b > 1 else (),
                                 mesh))
            serve = make_serve_step(cfg)
            args += [cache, {"tok": tok, "pos": pos,
                             **({"img": img} if img is not None else {})}]
            mf = model_flops_decode(cfg, b)

            def run():
                with torch.no_grad():
                    return serve(params, cache, tok, pos, img_embed=img)

        arg_bytes = sum(_local_bytes(a) for a in args)
        for a in args:
            for _, t in tree_items(a):
                counts.hold(t.to_local())
        t0 = time.time()
        with implicit_replication(), _marked(), counts:
            run()
        trace_s = time.time() - t0
        peak_bytes = counts.peak
        if counts._rising:
            counts.peak_tensors = counts.largest()

    cost = {"flops": float(counts.flops),
            "bytes accessed": float(counts.bytes_accessed),
            "transcendentals": 0.0}
    coll_total = float(sum(counts.coll.values()))
    rt = roofline(cost, coll_total, chips, model_flops=mf, per_device=True)
    return {
        "arch": arch, "shape": shape,
        "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)), "chips": chips,
        "remat": remat, "fsdp": fsdp, "optimizer": opt_name,
        "grad_accum": ga,
        "rule_overrides": {k: str(v) for k, v in rules.items()},
        "compile_s": trace_s,
        "memory": {
            "argument_bytes": arg_bytes,
            "peak_bytes_per_device": max(peak_bytes, arg_bytes),
            "fits": max(peak_bytes, arg_bytes) < DEVICE_BYTES,
        },
        "cost": cost,
        "collectives": {"total_bytes": coll_total,
                        "by_kind": {k: float(v)
                                    for k, v in sorted(counts.coll.items())}},
        "roofline": rt.as_dict(),
        "implicit_replication": dict(zip(("max_bytes", "op", "shape"),
                                         counts.implicit)),
        "peak_tensors": [
            {"bytes": n, "op": op, "local_shape": list(shp), "dtype": dt}
            for n, op, shp, dt in counts.peak_tensors],
    }


def _input(shape, dtype, mesh, pl):
    """A fake input DTensor of ``shape`` laid out by placements ``pl``."""
    from torch.distributed.tensor import DTensor
    local = list(shape)
    for m, p in enumerate(pl):
        if p.is_shard():
            local[p.dim] //= mesh.size(m)
    return DTensor.from_local(
        torch.zeros(local, dtype=dtype, device=mesh.device_type), mesh, pl,
        run_check=False, shape=torch.Size(shape),
        stride=torch.empty(shape, device="meta").stride())


def _batch(cfg, spec, mesh) -> dict:
    specs = batch_spec(cfg, spec["batch"], spec["seq"])
    return {k: _input(shape, dtype, mesh, pl) for (k, (shape, dtype)), pl
            in zip(specs.items(), batch_shardings(cfg, mesh, specs).values())}


def run_cell(arch, shape, multi, **kw) -> dict:
    """``build_cell`` on the production mesh inside its own fake world.
    The mesh lies on the host (DTensor's shape propagation runs there),
    and so do its fake local shards (``DTensor.from_local`` moves a shard
    to its mesh's device)."""
    with fake_world(512 if multi else 256):
        mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
        return build_cell(arch, shape, mesh, **kw)


def main(argv=None):
    from .serve import resolve_device
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--remat", default="full")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--overrides", default=None,
                    help="JSON dict of logical-rule overrides")
    ap.add_argument("--device", default=None,
                    help="where the trace runs: cuda (default) or cpu, "
                         "which runs only when asked for; nothing runs on "
                         "a card, whose fake tensors the shards are")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    os.makedirs(args.out, exist_ok=True)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    cells = CELLS if args.all else [
        (args.arch, s) for s in ([args.shape] if args.shape else SHAPES)]
    overrides = json.loads(args.overrides) if args.overrides else None

    failures = []
    for arch, shape in cells:
        if shape == "long_500k" and arch not in LONG_OK:
            print(f"SKIP {arch} x {shape} (full-attention arch)")
            continue
        for multi in meshes:
            tag = f"{arch}_{shape}_{'multi' if multi else 'single'}"
            t0 = time.time()
            try:
                res = run_cell(arch, shape, multi, overrides=overrides,
                               remat=args.remat)
                with open(os.path.join(args.out, tag + ".json"), "w") as f:
                    json.dump(res, f, indent=1, allow_nan=False)
                r, m = res["roofline"], res["memory"]
                print(f"OK   {tag}: trace={res['compile_s']:.1f}s "
                      f"mem/dev={m['peak_bytes_per_device'] / 2**30:.2f}GiB "
                      f"args/dev={m['argument_bytes'] / 2**30:.2f}GiB "
                      f"flops={res['cost']['flops']:.4g} "
                      f"coll={res['collectives']['by_kind']} "
                      f"compute={r['compute_s'] * 1e3:.2f}ms "
                      f"memory={r['memory_s'] * 1e3:.2f}ms "
                      f"collective={r['collective_s'] * 1e3:.2f}ms "
                      f"dom={r['dominant']}", flush=True)
                for t in res["peak_tensors"]:
                    print(f"     {t['bytes'] / 2**30:9.3f} GiB {t['op']} "
                          f"{t['local_shape']} {t['dtype']}")
            except Exception as e:
                failures.append((tag, repr(e)))
                print(f"FAIL {tag} ({time.time() - t0:.0f}s): {e!r}",
                      flush=True)
                traceback.print_exc(limit=-8)
    if failures:
        print(f"\n{len(failures)} failures:")
        for t, e in failures:
            print(" ", t, e[:300])
        raise SystemExit(1)
    print("\nall cells OK")


if __name__ == "__main__":
    main()
