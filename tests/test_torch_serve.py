"""The port's serve loop and trace capture against the JAX package's.

Greedy tokens step by step on the same parameters and requests, the
``--capture`` log byte for byte, the golden serve traces re-captured, and
the slot-level step model.
"""
import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.launch.steps import make_serve_step as jmake_serve_step  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.trace import capture as jcapture  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core.graph import Log  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.steps import make_serve_step  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.trace import capture  # noqa: E402

TRACES = Path(__file__).resolve().parent / "traces"
ARCH = "qwen2-0.5b"
FLAGS = ["--arch", ARCH, "--smoke", "--requests", "6", "--slots", "2",
         "--gen", "8"]
MIXTRAL = "mixtral-8x7b"
MIXTRAL_FLAGS = ["--arch", MIXTRAL, "--smoke", "--requests", "6",
                 "--slots", "2", "--gen", "8", "--max-len", "32"]


class _RecordingJit:
    """Stands in for ``jax`` inside ``repro.launch.serve``: every jitted
    serve step's next tokens are recorded, host-side, after the call."""

    def __init__(self, record):
        self._record = record

    def __getattr__(self, name):
        return getattr(jax, name)

    def jit(self, fn, **kw):
        step = jax.jit(fn, **kw)

        def run(*args):
            out = step(*args)
            self._record.append(np.asarray(out[0]))
            return out
        return run


def _recording(make, record):
    def make_step(cfg):
        step = make(cfg)

        def run(*args):
            out = step(*args)
            record.append(out[0].cpu().numpy())
            return out
        return run
    return make_step


def test_serve_tokens_match_jax(monkeypatch, capsys):
    """Same params, same requests: the same next token in every slot at
    every step, and the same completed requests."""
    jax_steps, port_steps = [], []
    monkeypatch.setattr(jserve, "jax", _RecordingJit(jax_steps))
    jserve.main(FLAGS)
    printed = {int(rid): [int(t) for t in toks.split(",")]
               for rid, toks in re.findall(r"req(\d+): \[([^\]]*)\]",
                                           capsys.readouterr().out)}

    cfg = configs.get_smoke(ARCH)
    jparams = JM.init_params(jconfigs.get_smoke(ARCH), jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    monkeypatch.setattr(serve, "make_serve_step",
                        _recording(make_serve_step, port_steps))
    res = serve.serve_loop(cfg, params, serve.parse_args(FLAGS))

    assert len(res.completed) == 6 and res.steps == len(jax_steps)
    assert len(port_steps) == len(jax_steps)
    for mine, theirs in zip(port_steps, jax_steps):
        np.testing.assert_array_equal(mine, theirs)
    assert len(printed) == 4
    for rid, toks in printed.items():
        assert res.completed[rid][:10] == toks
    assert all(len(t) == 8 for t in res.completed.values())


@pytest.fixture(scope="module")
def jax_mixtral_serve(tmp_path_factory):
    """The JAX serve of the smoke mixtral, run once: every step's next
    tokens and the ``--capture`` log."""
    steps = []
    log = tmp_path_factory.mktemp("jax") / "serve.log"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jserve, "jax", _RecordingJit(steps))
        jserve.main(MIXTRAL_FLAGS + ["--capture", str(log)])
    return steps, log.read_bytes()


@pytest.fixture(scope="module")
def port_mixtral_serve(tmp_path_factory):
    """The port's serve of the same, on the JAX parameters carried across:
    every step's next tokens, the result and the ``--capture`` log."""
    steps = []
    log = tmp_path_factory.mktemp("port") / "serve.log"
    cfg = configs.get_smoke(MIXTRAL)
    jparams = JM.init_params(jconfigs.get_smoke(MIXTRAL),
                             jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(serve, "make_serve_step",
                   _recording(make_serve_step, steps))
        res = serve.serve_loop(cfg, params, serve.parse_args(
            MIXTRAL_FLAGS + ["--capture", str(log)]))
    return steps, res, log.read_bytes()


def test_mixtral_serve_tokens_match_jax(jax_mixtral_serve,
                                        port_mixtral_serve):
    """Sliding-window ring caches and MoE layers: the same next token in
    every slot at every step (51 steps, past the ring's wrap)."""
    jax_steps, _ = jax_mixtral_serve
    port_steps, res, _ = port_mixtral_serve
    assert len(res.completed) == 6 and res.steps == len(jax_steps) == 51
    assert len(port_steps) == len(jax_steps)
    for mine, theirs in zip(port_steps, jax_steps):
        np.testing.assert_array_equal(mine, theirs)
    assert all(len(t) == 8 for t in res.completed.values())


def test_mixtral_capture_matches_jax_byte_for_byte(jax_mixtral_serve,
                                                   port_mixtral_serve):
    _, theirs = jax_mixtral_serve
    _, res, mine = port_mixtral_serve
    assert mine == theirs
    assert Log.loads(mine.decode()).op_count() == res.log.op_count() == 93


def test_serve_step_matches_jax():
    cfg = configs.get_smoke(ARCH)
    jcfg = jconfigs.get_smoke(ARCH)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(1))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    rng = np.random.default_rng(0)
    tok = rng.integers(0, cfg.vocab, (3, 1), dtype=np.int32)
    pos = np.array([0, 3, 9], np.int32)
    nxt, _ = make_serve_step(cfg)(params, M.init_cache(cfg, 3, 8, "cpu"),
                                  torch.from_numpy(tok), torch.from_numpy(pos))
    jnxt, _ = jmake_serve_step(jcfg)(jparams, JM.init_cache(jcfg, 3, 8),
                                     tok, pos)
    assert nxt.dtype == torch.int32 and nxt.shape == (3, 1)
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt))


def test_capture_matches_jax_byte_for_byte(tmp_path, capsys):
    mine, theirs = tmp_path / "port.log", tmp_path / "jax.log"
    serve.main(FLAGS + ["--device", "cpu", "--capture", str(mine)])
    jserve.main(FLAGS + ["--capture", str(theirs)])
    assert "captured trace" in capsys.readouterr().out
    assert mine.read_bytes() == theirs.read_bytes()
    log = Log.loads(mine.read_text())
    assert log.op_count() > 0 and log.meta["source"] == "launch.serve"


@pytest.mark.parametrize("name,slots,requests", [
    ("serve_smoke_s2", 2, 6), ("serve_smoke_s4", 4, 10)])
def test_golden_serve_traces_recapture(name, slots, requests):
    """tests/traces/make_golden.py's serve captures, from the port."""
    model = capture.step_model_from_config(ARCH, smoke=True)
    log = capture.capture_serve_trace(model, slots=slots, requests=requests,
                                      gen=8, seed=0, name=name)
    assert log.dumps() + "\n" == (TRACES / f"{name}.log").read_text()


@pytest.mark.parametrize("smoke", [True, False])
def test_mixtral_step_model_matches_jax(smoke):
    """The router leaf is f32 whatever param_dtype is; the ring caches are
    window-long."""
    mine = capture.step_model_from_config(MIXTRAL, smoke=smoke)
    theirs = jcapture.step_model_from_config(MIXTRAL, smoke=smoke)
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)


@pytest.mark.parametrize("smoke", [True, False])
def test_step_model_matches_jax(smoke):
    mine = capture.step_model_from_config(ARCH, smoke=smoke)
    theirs = jcapture.step_model_from_config(ARCH, smoke=smoke)
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    if not smoke:
        assert mine.weight_bytes == 1976131072
        assert mine.kv_token_bytes == 12288


def test_device_is_cuda_unless_asked():
    if torch.cuda.is_available():
        assert serve.resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="--device cpu"):
            serve.resolve_device(None)
        with pytest.raises(RuntimeError, match="CUDA"):
            serve.main(["--smoke", "--requests", "1"])
    assert serve.resolve_device("cpu").type == "cpu"


def test_serve_stops_at_max_len():
    """A request that reaches --max-len retires before --gen tokens."""
    cfg = configs.get_smoke(ARCH)
    params = M.init_params(cfg, torch.Generator().manual_seed(0))
    args = serve.parse_args(["--arch", ARCH, "--smoke", "--requests", "3",
                             "--slots", "2", "--gen", "50", "--max-len", "16"])
    res = serve.serve_loop(cfg, params, args)
    assert sorted(res.completed) == [0, 1, 2]
    for toks in res.completed.values():
        assert 0 < len(toks) < 50
        assert all(0 <= t < cfg.vocab for t in toks)
