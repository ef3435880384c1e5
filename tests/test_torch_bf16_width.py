"""The port's bf16 decode step at qwen2-0.5b's full width, against JAX.

Random layers amplify a one-ulp difference from layer to layer, so two
correct bf16 implementations of the same step part by much more than one
rounding of the logits.  The bound that still means something is JAX's own:
the port's bf16 logits must lie nearer JAX's bf16 logits than JAX's bf16
logits lie to its f32 logits.  (``chip_smoke.py`` phase 4 holds one layer's
outputs, kernel against plain, to the kernels' own tolerances on the card.)

Full width (d 896, 14/2 heads of 64, d_ff 4864, vocab 151,936), with the
depth cut to 4 of 24 layers so the test stays near 11 s and 2.6 GB of
host memory.
Weights are ``repro.models.init_params`` of ``PRNGKey(0)``, carried across
by ``params_from_jax``; one decode step for 4 slots against an N(0, 1)
cache of 128 positions at positions (3, 40, 90, 127), made with numpy.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.params import TORCH_DTYPES, tree_map  # noqa: E402

ARCH = "qwen2-0.5b"
LAYERS = 4
SLOTS, MAX_LEN = 4, 128
# f32: the same operations summed in another order, through 4 layers and
# the vocabulary projection (chip_smoke.py's PARITY_F32).
F32_TOL = 1e-3


def test_bf16_decode_step_inside_jax_bf16_distance():
    jcfg = jconfigs.get(ARCH).replace(n_layers=LAYERS)
    cfg = configs.get(ARCH).replace(n_layers=LAYERS)
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.vocab) \
        == (896, 14, 2, 4864, 151936)
    rng = np.random.default_rng(0)
    cache = jax.tree.map(lambda d: rng.standard_normal(d.shape, np.float32),
                         JM.cache_defs(jcfg, SLOTS, MAX_LEN),
                         is_leaf=lambda d: hasattr(d, "shape"))
    tok = rng.integers(0, cfg.vocab, (SLOTS, 1), dtype=np.int32)
    pos = np.array([3, 40, 90, 127], np.int32)

    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    jax_logits = {}
    for dtype in ("float32", "bfloat16"):
        c = jcfg.replace(dtype=dtype)
        jc = jax.tree.map(lambda x: jnp.asarray(x, jnp.dtype(dtype)), cache)
        logits, _ = jax.jit(lambda p, t, k, q: JM.decode_step(c, p, t, k, q))(
            jparams, jnp.asarray(tok), jc, jnp.asarray(pos))
        jax_logits[dtype] = np.asarray(logits, np.float32)
    host = jax.tree.map(np.asarray, jparams)
    del jparams
    params = params_from_jax(host, cfg, "cpu")
    del host

    port_logits = {}
    for dtype in ("float32", "bfloat16"):
        c = cfg.replace(dtype=dtype)
        tc = tree_map(lambda x: torch.from_numpy(x).to(TORCH_DTYPES[dtype]),
                      cache)
        with torch.inference_mode():
            logits, _ = M.decode_step(c, M.prepare_params(c, params),
                                      torch.from_numpy(tok), tc,
                                      torch.from_numpy(pos))
        port_logits[dtype] = logits.float().numpy()

    j32, j16 = jax_logits["float32"], jax_logits["bfloat16"]
    p32, p16 = port_logits["float32"], port_logits["bfloat16"]
    assert p16.shape == (SLOTS, 1, cfg.vocab) and np.isfinite(p16).all()
    scale = np.abs(j32).max()
    assert np.abs(p32 - j32).max() <= F32_TOL * scale
    jax_noise = np.abs(j16 - j32).max()
    dist = np.abs(p16 - j16).max()
    print(f"max|logits| {float(scale)!r}; port bf16 vs JAX bf16 "
          f"{float(dist)!r}; JAX bf16 vs JAX f32 {float(jax_noise)!r}")
    assert 0 < dist < jax_noise, (dist, jax_noise, scale)
