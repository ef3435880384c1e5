"""The port's analysis package and autotune against the JAX package's:
the HLO parsers are copies (``COPIES`` in ``test_torch_isolation.py``) and
give the same numbers on the same text; the roofline carries the H100's
constants, so each term equals the reference's scaled by the ratio of the
constants; autotune picks the same fraction on ``tests/test_planner.py``'s
MLP; the capture's ``cost_model="hlo"`` rescales to
``FlopCounterMode``'s count, exactly 2·M·N·K on a product."""
from importlib import import_module

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.analysis import hlo as jhlo  # noqa: E402
from repro.analysis import hlo_cost as jhlo_cost  # noqa: E402
from repro.configs import get as jget  # noqa: E402
from repro.core.autotune import autotune as jautotune  # noqa: E402
from repro_torch import analysis  # noqa: E402
from repro_torch.analysis import hlo, hlo_cost  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.core import planner  # noqa: E402
from repro_torch.core.autotune import autotune  # noqa: E402
from repro_torch.trace import capture as C  # noqa: E402
from test_torch_planner import D, L, jloss_fn, loss_fn  # noqa: E402

# The packages export the function ``roofline`` under the module's name.
roof = import_module("repro_torch.analysis.roofline")
jroof = import_module("repro.analysis.roofline")

COSTS = [({"flops": 197e12, "bytes accessed": 819e9}, 0.0, 1, 197e12, True),
         ({"flops": 3.1e15, "bytes accessed": 2.2e12}, 4.5e9, 4, 1e15,
          True),
         ({"flops": 7.0e11, "bytes accessed": 9.0e12}, 1e10, 8, 0.0, False),
         ({}, 0.0, 1, 0.0, True)]
RATIO = {"compute_s": jroof.PEAK_FLOPS / roof.PEAK_FLOPS,
         "memory_s": jroof.HBM_BW / roof.HBM_BW,
         "collective_s": jroof.ICI_BW / roof.NVLINK_BW}


def test_h100_constants_and_no_tpu_number():
    assert (roof.PEAK_FLOPS, roof.HBM_BW, roof.NVLINK_BW) == \
        (989e12, 3.35e12, 50e9)
    text = open(roof.__file__).read()
    for tpu in ("197e12", "819e9", "ICI", "TPU", "v5e"):
        assert tpu not in text
    assert analysis.__all__ == ["collective_bytes", "parse_collectives",
                                "xla_cost_dict", "RooflineTerms", "roofline"]


@pytest.mark.parametrize("cost,coll,chips,model_flops,per_device", COSTS)
def test_roofline_terms_scale_with_the_constants(cost, coll, chips,
                                                 model_flops, per_device):
    port = roof.roofline(cost, coll, chips, model_flops=model_flops,
                         per_device=per_device)
    ref = jroof.roofline(cost, coll, chips, model_flops=model_flops,
                         per_device=per_device)
    for term, ratio in RATIO.items():
        assert getattr(port, term) == pytest.approx(
            getattr(ref, term) * ratio, rel=1e-12, abs=0.0)
    for same in ("flops", "bytes_accessed", "collective_bytes", "chips",
                 "model_flops", "useful_flops_frac"):
        assert getattr(port, same) == getattr(ref, same)
    assert set(port.as_dict()) == set(ref.as_dict())
    if port.step_time_s > 0:
        assert port.roofline_frac == pytest.approx(
            model_flops / (port.step_time_s * chips * roof.PEAK_FLOPS))


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mixtral-8x7b",
                                  "deepseek-v3-671b"])
def test_model_flops_exactly_equal(arch):
    cfg, jcfg = get(arch), jget(arch)
    assert roof.model_flops_train(cfg, 8192) == \
        jroof.model_flops_train(jcfg, 8192)
    assert roof.model_flops_decode(cfg, 4) == \
        jroof.model_flops_decode(jcfg, 4)
    assert roof.model_flops_prefill(cfg, 2048) == \
        jroof.model_flops_prefill(jcfg, 2048)


def test_hlo_parsers_agree_on_compiled_text():
    a = jax.ShapeDtypeStruct((64, 128), np.float32)
    b = jax.ShapeDtypeStruct((128, 32), np.float32)
    txt = jax.jit(lambda x, y: jnp.tanh(x @ y).sum()).lower(
        a, b).compile().as_text()
    port, ref = hlo_cost.analyze(txt), jhlo_cost.analyze(txt)
    assert (port.flops, port.bytes_accessed) == (ref.flops,
                                                 ref.bytes_accessed)
    assert port.flops >= 2 * 64 * 32 * 128
    assert hlo.collective_bytes(txt) == jhlo.collective_bytes(txt) == 0


def test_autotune_picks_feasible_budget_as_jax():
    """``tests/test_planner.py::test_autotune_picks_feasible_budget`` with
    the port, on the same numpy-drawn MLP; the same fraction as JAX's."""
    rng = np.random.default_rng(0)
    params = [{"w1": rng.standard_normal((D, 4 * D), np.float32) * 0.02,
               "w2": rng.standard_normal((4 * D, D), np.float32) * 0.02}
              for _ in range(L)]
    x = rng.standard_normal((512, D), np.float32)
    fracs = (0.9, 0.6, 0.45)
    tuned = autotune(planner.grad_of_sum(loss_fn),
                     [{k: torch.from_numpy(v) for k, v in p.items()}
                      for p in params], torch.from_numpy(x), fracs=fracs)
    assert tuned.plan.feasible
    assert tuned.est_step_s > 0
    assert 0.4 < tuned.budget_frac <= 0.9
    assert tuned.est_step_s == max(tuned.est_compute_s, tuned.est_memory_s)
    jtuned = jautotune(jax.grad(jloss_fn),
                       jax.tree.map(jnp.asarray, params), jnp.asarray(x),
                       fracs=fracs)
    assert tuned.budget_frac == jtuned.budget_frac


@pytest.mark.parametrize("m,k,n", [(64, 128, 32), (96, 40, 200)])
def test_hlo_cost_model_counts_2mnk(m, k, n):
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        a, b = torch.empty(m, k), torch.empty(k, n)
    log = C.capture_fn(lambda x, y: x @ y, a, b, cost_model="hlo")
    assert log.meta["cost_model"] == "hlo"
    assert log.meta["flop_counter"] == \
        "torch.utils.flop_counter.FlopCounterMode"
    assert log.meta["hlo_flops"] == 2 * m * n * k
    assert log.baseline_cost() == pytest.approx(2 * m * n * k, rel=1e-12)


def test_hlo_cost_model_falls_back_without_products():
    log = C.capture_fn(lambda x: torch.tanh(x) * 2, torch.ones(8, 8),
                       cost_model="hlo")
    assert log.meta["cost_model"] == "flops"
    assert "hlo_flops" not in log.meta


def test_hlo_cost_model_on_an_mlp_step():
    """fig4's tagged MLP step (``chip_smoke.py`` phase 11c at card width):
    6 L - 1 matrix products of 2·B·d·4d FLOPs each (the first layer's
    input takes no gradient), and the analytic costs rescaled onto them."""
    d, layers, batch = 32, 3, 64
    rng = np.random.default_rng(1)
    params = [{k: torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
               for k, s in (("w1", (d, 4 * d)), ("w2", (4 * d, d)))}
              for _ in range(layers)]
    x = torch.from_numpy(rng.standard_normal((batch, d), dtype=np.float32))
    grad_fn = planner.grad_of_sum(
        lambda pp, xx: torch.mean(mlp_step(pp, xx) ** 2))
    flops = C.capture_fn(grad_fn, params, x)
    hlo = C.capture_fn(grad_fn, params, x, cost_model="hlo")
    expect = 2 * batch * d * 4 * d * (6 * layers - 1)
    assert C.counted_flops(grad_fn, params, x) == expect
    assert hlo.meta["hlo_flops"] == expect
    assert hlo.baseline_cost() == pytest.approx(expect, rel=1e-9)
    assert flops.baseline_cost() > expect     # elementwise work counted too


def mlp_step(params, x):
    for p in params:
        x = x + torch.nn.functional.gelu(x @ p["w1"],
                                         approximate="tanh") @ p["w2"]
    return x
