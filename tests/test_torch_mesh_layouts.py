"""The mesh layouts of the dry run compute what one device computes.

The dry run only traces shapes; here the same DTensor branches run on real
numbers, on a 4-rank gloo group (a spawned subprocess, 300 s limit) with a
(2, 2) ``("data", "model")`` mesh and the train shapes' rule (the residual
stream's sequence over ``model``), against the plain single-device path on
the same f32 inputs:

- deepseek-v3 and rwkv6 smoke models whole (no flash call, whose op needs
  the card): logits, loss, every gradient leaf and an Adafactor update
  (the MoE over experts, MLA's latent projections by rows, the decode-free
  MLA attention by rows and heads, rwkv6's token shift, recurrence and
  receptance by rows);
- blocks that reach no flash call: mixtral's MoE with 3 experts (F split
  over the model dim), recurrentgemma's RG-LRU block (its conv and gates),
  and llama's projections with one kv head, repeated over the model dim
  (against the plain projections' kv heads repeated).

Values within 1e-5 of their max, gradients within 5e-4 and Adafactor's
update within 3e-3 (summation orders differ over the shards; the update
divides by the root of small second moments).  Measured on a CPU: values
<= 2.4e-6, gradients <= 1.19e-4 and the update <= 7.1e-4 (rwkv6 for all
three), so each limit holds about 4x its reading.  GQA over repeated kv
heads is the original attention: checked on the CPU's plain attention.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = ["deepseek-v3-671b", "rwkv6-1.6b", "mixtral-8x7b moe",
         "recurrentgemma-2b rglru", "llama3.2-1b kv heads"]
TOL = {"logits": 1e-5, "loss": 1e-5, "out": 1e-5, "grads": 5e-4,
       "update": 3e-3}

_SCRIPT = textwrap.dedent('''
    import json, sys
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp
    sys.path.insert(0, {src!r})


    def run(rank, port, out):
        dist.init_process_group("gloo", rank=rank, world_size=4,
                                init_method=f"tcp://localhost:{{port}}")
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import distribute_tensor
        from torch.distributed.tensor.experimental import (
            implicit_replication)
        from repro_torch import configs
        from repro_torch.distributed.sharding import (
            mesh_context, param_pspec, placements, pspec)
        from repro_torch.launch.steps import (
            batch_shardings, batch_spec, loss_and_grads, state_shardings)
        from repro_torch.models import layers as L, model as M, moe as MOE
        from repro_torch.models.params import tree_items, tree_map
        from repro_torch.optim import adafactor
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        rules = {{"seq": "model"}}

        def gen(seed):
            return torch.Generator().manual_seed(seed)

        def rel(a, b):
            a = a.full_tensor() if hasattr(a, "full_tensor") else a
            return float((a - b).abs().max()
                         / b.abs().max().clamp(min=1e-30))

        def leaves(tree):
            return [t for _, t in tree_items(tree)]

        def laid_out(tree, defs):
            return tree_map(lambda t, i: distribute_tensor(
                t.detach(), mesh, placements(param_pspec(i, mesh=mesh),
                                             mesh)), tree, defs)

        res = {{}}
        for arch in ("deepseek-v3-671b", "rwkv6-1.6b"):
            cfg = configs.get_smoke(arch).replace(remat="full")
            params = M.init_params(cfg, gen(1))
            tokens = torch.randint(0, cfg.vocab, (4, 32), generator=gen(2))
            opt = adafactor()
            want = M.forward(cfg, params, tokens)
            wl, wg = loss_and_grads(cfg, params, {{"tokens": tokens}})
            state = opt.init(params)
            wu, _ = opt.update(wg, opt.init(params), params)
            with mesh_context(mesh, overrides=rules), \\
                    implicit_replication():
                dp = laid_out(params, M.param_defs(cfg))
                tok = distribute_tensor(tokens, mesh, batch_shardings(
                    cfg, mesh, batch_spec(cfg, 4, 32))["tokens"])
                _, o_pl = state_shardings(cfg, mesh, "adafactor")
                ds = type(state)(state.step, tree_map(
                    lambda t, pl: distribute_tensor(t, mesh, pl),
                    state.inner, o_pl.inner))
                got = M.forward(cfg, dp, tok)
                gl, gg = loss_and_grads(cfg, dp, {{"tokens": tok}})
                gu, _ = opt.update(gg, ds, dp)
            res[arch] = {{
                "logits": rel(got, want), "loss": rel(gl, wl),
                "grads": max(map(rel, leaves(gg), leaves(wg))),
                "update": max(map(rel, leaves(gu), leaves(wu)))}}

        def qkv(c, p, h):
            reps = L.kv_repeats(c.n_heads, c.n_kv_heads)
            return torch.cat([t.flatten(2) for t in L._qkv(c, p, h, h,
                                                           reps)], -1)

        def qkv_repeated(c, p, h):
            q, k, v = L._qkv(c, p, h, h)
            return torch.cat([q.flatten(2)] + [t.repeat_interleave(
                2, 2).flatten(2) for t in (k, v)], -1)

        blocks = {{
            "mixtral-8x7b moe": (
                configs.get_smoke("mixtral-8x7b").replace(n_experts=3),
                MOE.moe_defs, MOE.moe_apply, MOE.moe_apply),
            "recurrentgemma-2b rglru": (
                configs.get_smoke("recurrentgemma-2b"),
                lambda c: M._block_defs(c, "rglru", False),
                *[lambda c, p, h: M.block_apply(
                    c, "rglru", p, h, positions=None,
                    moe_layer=False)[0]] * 2),
            "llama3.2-1b kv heads": (
                configs.get_smoke("llama3.2-1b").replace(n_kv_heads=1),
                L.attention_defs, qkv, qkv_repeated)}}
        x = torch.randn(4, 32, 64, generator=gen(3))
        for name, (cfg, defs_fn, meshed, plain) in blocks.items():
            defs = defs_fn(cfg)
            p = tree_map(lambda i: (torch.randn(i.shape, generator=gen(4))
                                    * 0.1).requires_grad_(), defs)
            want = plain(cfg, p, x)
            wg = torch.autograd.grad((want * want).sum(), leaves(p),
                                     allow_unused=True)
            with mesh_context(mesh, overrides=rules), \\
                    implicit_replication():
                dp = tree_map(lambda t: t.requires_grad_(),
                              laid_out(p, defs))
                dx = distribute_tensor(x, mesh, placements(
                    pspec("batch", None, None, mesh=mesh), mesh))
                got = meshed(cfg, dp, dx)
                gg = torch.autograd.grad((got * got).sum(), leaves(dp),
                                         allow_unused=True)
            res[name] = {{"out": rel(got, want), "grads": max(
                rel(a, b) for a, b in zip(gg, wg) if b is not None)}}
        if rank == 0:
            with open(out, "w") as f:
                json.dump(res, f)
        dist.destroy_process_group()


    if __name__ == "__main__":
        mp.spawn(run, args=(int(sys.argv[1]), sys.argv[2]), nprocs=4)
''')


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def errors(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    script = tmp / "layouts.py"
    script.write_text(_SCRIPT.format(src=os.path.join(REPO, "src")))
    out = tmp / "errors.json"
    res = subprocess.run([sys.executable, str(script), str(_free_port()),
                          str(out)], capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(out.read_text())


@pytest.mark.parametrize("case", CASES)
def test_mesh_layout_computes_the_single_device_result(errors, case):
    for what, err in errors[case].items():
        assert err <= TOL[what], (what, err)


def test_repeated_kv_heads_are_the_same_attention():
    """Each kv head repeated ``r`` times in a row: query head i reads copy
    i // (H / (KV r)), which is the original head i // (H / KV)."""
    from repro_torch.kernels import ops
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 16, 8, 32, generator=g)
    k, v = (torch.randn(2, 16, 2, 32, generator=g) for _ in range(2))
    want = ops.attention(q, k, v)
    for reps in (2, 4):
        got = ops.attention(q, k.repeat_interleave(reps, 2),
                            v.repeat_interleave(reps, 2))
        assert torch.equal(got, want)
