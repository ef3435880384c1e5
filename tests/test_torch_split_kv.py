"""Context-parallel decode attention on the CPU: a KV cache cut into
shards along its sequence, each shard attended alone with its rows'
log-sum-exp, and the shards merged by it (``kernels/ops.py``).

The merge (``merge_attention``) is the function the mesh path runs on
DTensors (``split_kv_attention``); here it takes the shards stacked on a
plain dim, each computed with the local ``kv_len`` a device of the mesh
gives it (``shard_kv_len``).  Held against the whole plain call
(``ops.attention`` with ``kv_len``) and against the JAX package's decode
attention (``_sdpa`` under ``decode_mask``, or the ring's ``abs_pos >= 0``
mask) on the same numpy inputs, f32, within 2e-5: the merge differs from
one softmax only in f32 summation order and exp of shifted arguments.
Shards whose keys all lie past a slot's position, a ring that has wrapped
and the soft cap are among the cases.  The kernel's convention for a row
with no visible key (zeros, LSE -inf) is merged beside the plain
version's (mean(V), LSE -1e30 + log L) to the same result.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models import layers as jlayers  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)


def _inputs(b, h, kv, length, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, 1, h, d), dtype=np.float32),
            rng.standard_normal((b, length, kv, d), dtype=np.float32),
            rng.standard_normal((b, length, kv, d), dtype=np.float32))


def _split(q, k, v, kv_len, shards, softcap):
    """Each shard's (out, lse) as a device of an N-way ``kv_seq`` mesh dim
    computes it, stacked on dim 0."""
    n = k.shape[1] // shards
    outs, lses = [], []
    for r in range(shards):
        o, lse = ops.attention_lse(
            q, k[:, r * n:(r + 1) * n], v[:, r * n:(r + 1) * n],
            kv_len=ops.shard_kv_len(kv_len, r, n), softcap=softcap)
        outs.append(o)
        lses.append(lse)
    return torch.stack(outs), torch.stack(lses)


def _jax_decode(q, k, v, pos, length, softcap, ring):
    """The JAX package's decode attention: ``_sdpa`` under the decode mask
    of per-slot positions ``pos`` (a ring: its ``abs_pos >= 0``)."""
    cfg = types.SimpleNamespace(head_dim=q.shape[-1], logit_softcap=softcap)
    pos = jnp.asarray(pos)
    if ring:
        abs_pos = pos[:, None] - jnp.mod(
            pos[:, None] - jnp.arange(length)[None, :], length)
        mask = (abs_pos >= 0)[:, None, None, None, :]
    else:
        mask = jlayers.decode_mask(pos, length)
    return np.asarray(jlayers._sdpa(cfg, jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), mask))


@pytest.mark.parametrize("softcap", [0.0, 0.5])
@pytest.mark.parametrize("b,h,kv,length,d,shards,pos,ring", [
    # qwen2's GQA (7 heads on 1), 4 shards of 16 rows: the slot at 3
    # leaves shards 1-3 empty, the one at 63 sees them all
    (4, 7, 1, 64, 8, 4, (3, 20, 63, 40), False),
    # 2 kv heads of 16, 8 shards of 4 rows, a slot at row 0
    (3, 4, 2, 32, 16, 8, (0, 13, 31), False),
    # a ring of 16 rows in 4 shards, three slots past it (wrapped)
    (3, 2, 1, 16, 24, 4, (2, 17, 40), True),
])
def test_merged_shards_are_the_whole_decode_attention(b, h, kv, length, d,
                                                      shards, pos, ring,
                                                      softcap):
    q, k, v = _inputs(b, h, kv, length, d, seed=length + shards)
    pos_t = torch.tensor(pos, dtype=torch.int32)
    kv_len = (pos_t + 1).clamp(max=length).to(torch.int32)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    o, lse = _split(tq, tk, tv, kv_len, shards, softcap)
    empty = ops.shard_kv_len(kv_len, shards - 1, length // shards) == 0
    assert empty.any()                     # some slot leaves a shard empty
    got, got_lse = ops.merge_attention(o, lse)
    whole, whole_lse = fa.flash_attention_lse(
        tq.transpose(1, 2), tk.transpose(1, 2), tv.transpose(1, 2),
        kv_len=kv_len, softcap=softcap)
    torch.testing.assert_close(got, ops.attention(tq, tk, tv, kv_len=kv_len,
                                                  softcap=softcap), **TOL)
    torch.testing.assert_close(got_lse, whole_lse.transpose(1, 2), **TOL)
    np.testing.assert_allclose(
        got.numpy(), _jax_decode(q, k, v, pos, length, softcap, ring),
        **TOL)


def test_an_empty_shard_weighs_exactly_zero():
    """A shard with no visible key, as the kernel gives it (zeros, LSE
    -inf) or as the plain version does (mean(V), -1e30 + log L), weighs
    exactly 0 in the merge of the others; a row that no shard saw is
    finite (0 from the kernel's shards)."""
    g = torch.Generator().manual_seed(3)
    o = torch.randn(3, 2, 1, 4, 8, generator=g)
    lse = torch.randn(3, 2, 1, 4, generator=g)
    want = ops.merge_attention(o, lse)
    for empty_o, empty_lse in ((torch.zeros(2, 1, 4, 8), -torch.inf),
                               (o.mean(0), -1e30 + np.log(16.0))):
        empty_lse = torch.full((1, 2, 1, 4), empty_lse)
        assert (torch.exp(empty_lse - lse.amax(0)) == 0).all()
        got = ops.merge_attention(torch.cat([o, empty_o[None]]),
                                  torch.cat([lse, empty_lse]))
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    out, row_lse = ops.merge_attention(torch.zeros(4, 2, 1, 4, 8),
                                       torch.full((4, 2, 1, 4), -torch.inf))
    assert torch.equal(out, torch.zeros(2, 1, 4, 8))
    assert torch.isneginf(row_lse).all()


def test_shard_kv_len():
    """Device r of N over L rows sees clamp(kv_len - r L / N, 0, L / N)."""
    kv_len = torch.tensor([0, 1, 5, 8, 13, 16], dtype=torch.int32)
    got = torch.stack([ops.shard_kv_len(kv_len, r, 4) for r in range(4)])
    assert got.dtype == torch.int32
    assert got.tolist() == [[0, 1, 4, 4, 4, 4], [0, 0, 1, 4, 4, 4],
                            [0, 0, 0, 0, 4, 4], [0, 0, 0, 0, 1, 4]]
    assert got.sum(0).tolist() == kv_len.tolist()
