"""The port's sharding rules, collectives and mesh flags against the JAX
package's.

- ``param_pspec`` of every leaf of every registry arch (and its cache
  leaves) against the reference's on ``jax.sharding.AbstractMesh`` (16,
  16) and (2, 16, 16), with FSDP on and off, under each of the dry run's
  rule overrides: equal specs.  No device is needed on either side.
- ``state_shardings``' ZeRO-1 optimizer leaves (AdamW and Adafactor)
  against the reference's ``NamedSharding`` specs, as placements.
- ``compressed_psum`` on a 4-rank gloo group (a spawned subprocess, 120 s
  limit) against the reference's under ``jax.vmap(..., axis_name="d")``,
  and ``make_compressed_allreduce`` over the data dim of a (2, 2) mesh
  against the reference's per model column: within 1e-6 of max|x| (the
  same int8 arithmetic; only f32 rounding differs).
- The train launchers with ``--mesh host --fsdp --seq-shard`` on the same
  smoke weights for 2 steps: the JAX launcher's losses (read where its
  loop records them) against the port's, within 1e-5 relative (the train
  tests' tolerance).
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh as JAbstractMesh  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.distributed import collectives as jcoll  # noqa: E402
from repro.distributed import monitor as jmonitor  # noqa: E402
from repro.distributed import sharding as JS  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.distributed import sharding as S  # noqa: E402
from repro_torch.launch import steps, train  # noqa: E402
from repro_torch.launch.dryrun import SHAPES, rule_overrides  # noqa: E402
from repro_torch.launch.mesh import launch_mesh  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.params import tree_items  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
OVERRIDES = [{}] + [rule_overrides(s) for s in SHAPES]
COLL_TOL = 1e-6


def _jinfo_items(tree):
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JS.ParamInfo))[0]
    return {".".join(str(k.key) for k in path): info
            for path, info in leaves}


def _specs_equal(defs, jdefs, mesh, jmesh, overrides, fsdp):
    """Every leaf's spec, port against reference; returns the count."""
    jinfos = _jinfo_items(jdefs)
    infos = dict(tree_items(defs))
    assert infos.keys() == jinfos.keys()
    with S.mesh_context(None, overrides=overrides), \
            JS.mesh_context(None, overrides=overrides):
        for path, info in infos.items():
            want = tuple(JS.param_pspec(jinfos[path], mesh=jmesh, fsdp=fsdp))
            got = S.param_pspec(info, mesh=mesh, fsdp=fsdp)
            assert got == want, (path, got, want)
    return len(infos)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_param_specs_equal_reference(arch, mesh):
    shape, names = MESHES[mesh]
    m, jm = S.AbstractMesh(shape, names), JAbstractMesh(shape, names)
    cfg, jcfg = configs.get(arch), jconfigs.get(arch)
    n = 0
    for overrides in OVERRIDES:
        for fsdp in (False, True):
            n += _specs_equal(M.param_defs(cfg), JM.param_defs(jcfg), m, jm,
                              overrides, fsdp)
        n += _specs_equal(M.cache_defs(cfg, 128, 4096),
                          JM.cache_defs(jcfg, 128, 4096), m, jm, overrides,
                          False)
    assert n > 0


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", ["llama3.2-1b", "mixtral-8x7b",
                                  "deepseek-v3-671b"])
def test_zero1_optimizer_placements_equal_reference(arch, opt):
    """ZeRO-1: each optimizer leaf takes its parameter's ``fsdp_dim``
    sharding even without FSDP; as placements on the (2, 16, 16) mesh."""
    shape, names = MESHES["multi"]
    m, jm = S.AbstractMesh(shape, names), JAbstractMesh(shape, names)
    for fsdp in (False, True):
        p_pl, o_pl = steps.state_shardings(configs.get(arch), m, opt,
                                           fsdp=fsdp)
        jp, jo = jsteps.state_shardings(jconfigs.get(arch), jm, opt,
                                        fsdp=fsdp)
        for got_tree, want_tree in ((p_pl, jp), (o_pl.inner, jo.inner)):
            want = {".".join(str(k.key) for k in path): sh
                    for path, sh in jax.tree_util.tree_flatten_with_path(
                        want_tree)[0]}
            got = dict(tree_items(got_tree))
            assert got.keys() == want.keys()
            for path, pl in got.items():
                assert pl == S.placements(tuple(want[path].spec), m), path


def test_placements_of_tuple_entries():
    """``("pod", "data")`` shards one tensor dim over both mesh dims, in
    mesh order; unnamed mesh dims replicate."""
    from torch.distributed.tensor import Replicate, Shard
    m = S.AbstractMesh(*MESHES["multi"])
    assert S.placements((("pod", "data"), None, "model"), m) == (
        Shard(0), Shard(0), Shard(2))
    assert S.placements((None, "data"), m) == (Replicate(), Shard(1),
                                               Replicate())
    assert S.local_shape((256, 4096, 64), (("pod", "data"), None, "model"),
                         m) == (8, 4096, 4)


def test_shard_is_a_no_op_without_a_dtensor():
    """On plain tensors (one card) ``shard`` returns its input, with or
    without a mesh."""
    x = torch.ones(4, 8)
    assert S.shard(x, "batch", "embed") is x
    with S.mesh_context(S.AbstractMesh(*MESHES["single"])):
        assert S.shard(x, "batch", "embed") is x


_COLL = textwrap.dedent('''
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp
    sys.path.insert(0, {src!r})
    from repro_torch.distributed.collectives import (
        compressed_psum, make_compressed_allreduce)

    def run(rank, port, path):
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{{port}}",
                                rank=rank, world_size=4)
        data = np.load(path)
        grads = {{"a": torch.from_numpy(data["a"][rank]),
                  "b": {{"c": torch.from_numpy(data["c"][rank])}}}}
        summed = compressed_psum(grads)
        from torch.distributed.device_mesh import init_device_mesh
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        mean = make_compressed_allreduce(mesh, ("pod", "data"))(grads)
        np.savez(f"{{path}}.{{rank}}.npz", a=summed["a"].numpy(),
                 c=summed["b"]["c"].numpy(), ma=mean["a"].numpy(),
                 mc=mean["b"]["c"].numpy())
        dist.destroy_process_group()

    if __name__ == "__main__":
        mp.spawn(run, args=(int(sys.argv[1]), sys.argv[2]), nprocs=4)
''')


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_compressed_psum_matches_reference(tmp_path):
    rng = np.random.default_rng(0)
    a = rng.standard_normal((4, 6, 5)).astype(np.float32)
    c = (rng.standard_normal((4, 7)) * 3).astype(np.float32)
    path = str(tmp_path / "grads.npz")
    np.savez(path, a=a, c=c)
    script = tmp_path / "coll.py"
    script.write_text(_COLL.format(src=os.path.join(REPO, "src")))
    out = subprocess.run([sys.executable, str(script), str(_free_port()),
                          path], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    # The reference: every leaf psum'd over the 4 shards under vmap.
    want = jax.vmap(lambda g: jcoll.compressed_psum(g, ("d",)),
                    axis_name="d")({"a": jnp.asarray(a),
                                    "b": {"c": jnp.asarray(c)}})
    # make_compressed_allreduce: the data dim of (2, 2), one group per model
    # column (ranks {0, 2} and {1, 3}), summed and halved.
    cols = [jax.vmap(lambda g: jcoll.compressed_psum(g, ("d",)),
                     axis_name="d")({"a": jnp.asarray(a[[j, j + 2]]),
                                     "b": {"c": jnp.asarray(c[[j, j + 2]])}})
            for j in (0, 1)]
    for rank in range(4):
        got = np.load(f"{path}.{rank}.npz")
        for key, w in (("a", want["a"][rank]), ("c", want["b"]["c"][rank])):
            w = np.asarray(w)
            assert np.abs(got[key] - w).max() <= COLL_TOL * np.abs(w).max()
        col = cols[rank % 2]
        for key, w in (("ma", col["a"][rank // 2]),
                       ("mc", col["b"]["c"][rank // 2])):
            w = np.asarray(w) / 2
            assert np.abs(got[key] - w).max() <= COLL_TOL * np.abs(w).max()


ARGV = ["--arch", "qwen2-0.5b", "--smoke", "--mesh", "host", "--fsdp",
        "--seq-shard", "--steps", "2", "--batch", "2", "--seq", "16",
        "--remat", "none"]


def test_launcher_fsdp_seq_shard_losses_match_jax_launcher(tmp_path,
                                                           monkeypatch):
    """Both launchers with ``--mesh host --fsdp --seq-shard``: the JAX
    launcher's ``main`` (its loop's losses read where it records them),
    and the port's loop under the same mesh flags on the same weights
    (the reference's ``init_params`` at its key, carried across)."""
    argv = ARGV + ["--ckpt-dir", str(tmp_path / "jax")]
    jlosses = []
    record = jmonitor.StragglerMonitor.record

    def recording(self, step, seconds, loss, gn):
        jlosses.append(loss)
        return record(self, step, seconds, loss, gn)

    monkeypatch.setattr(jtrain.StragglerMonitor, "record", recording)
    jtrain.main(argv)
    jcfg = jconfigs.get_smoke("qwen2-0.5b").replace(remat="none",
                                                    dtype="float32")
    jparams = jax.tree.map(np.asarray, JM.init_params(
        jcfg, jax.random.PRNGKey(0)))
    args = train.parse_args(argv + ["--device", "cpu", "--ckpt-dir",
                                    str(tmp_path / "port")])
    cfg = train.config_from_args(args)
    with launch_mesh(args.mesh, "cpu", fsdp=args.fsdp,
                     seq_shard=args.seq_shard) as mesh:
        assert S.fsdp_enabled() and S.current_mesh() is mesh
        assert S.pspec("batch", "seq", "embed", shape=(2, 16, 48)) == (
            "data", "model", None)
        res = train.train_loop(cfg, params_from_jax(jparams, cfg, "cpu"),
                               args, verbose=False)
    assert len(jlosses) == len(res.losses) == 2
    np.testing.assert_allclose(res.losses, jlosses, rtol=1e-5)
