"""The rest of the port's serve surface against the JAX package's, on the
CPU at smoke size with parameters drawn with numpy:

* decode on one shared position clock (a scalar ``pos``): qwen2's dense
  cache and mixtral's ring cache, every step from 0 to ``max_len``
  inclusive (at ``max_len`` the JAX dense write clamps to the last row),
  logits within 1e-5 of their largest magnitude and greedy tokens equal;
* ``repro_torch.examples.serve`` against ``examples/serve.py`` (imported by
  path): the same next tokens at every step and the same printed requests;
* ``python -m repro_torch.trace report --traces`` on two golden serve logs:
  JSON equal to the JAX report's;
* the ``random-dag`` capture source: the JAX package's log.
"""
import contextlib
import importlib.util
import io
import json
from functools import partial
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import graphs as jgraphs  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.trace import __main__ as jtrace  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.examples import serve as example  # noqa: E402
from repro_torch.launch.steps import make_serve_step  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.params import tree_items, tree_map  # noqa: E402
from repro_torch.trace import __main__ as trace_cli  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TRACES = ROOT / "tests" / "traces"
REL = 1e-5
MAX_LEN, SLOTS = 16, 3


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def numpy_params(cfg, seed=0):
    """Parameters for both packages, drawn with numpy leaf by leaf in
    sorted key order (the JAX init's scale rule: ``0.02`` means
    ``1/sqrt(fan-in)``, zero-scale leaves are zeros), as f32 arrays."""
    rng = np.random.default_rng(seed)

    def one(info):
        if info.init_scale == 0.0:
            return np.zeros(info.shape, np.float32)
        scale = info.init_scale if info.init_scale != 0.02 \
            else 1.0 / np.sqrt(max(info.shape[-1], 1))
        return (rng.standard_normal(info.shape) * scale).astype(np.float32)

    return tree_map(one, M.param_defs(cfg))


def _close(mine, theirs, what):
    mine = np.asarray(mine, np.float32)
    theirs = np.asarray(theirs, np.float32)
    assert mine.shape == theirs.shape, what
    scale = float(np.abs(theirs).max())
    err = float(np.abs(mine - theirs).max())
    assert err <= REL * scale, f"{what}: max|d| {err} > {REL} x {scale}"


@pytest.mark.parametrize("arch,ring", [("qwen2-0.5b", False),
                                       ("mixtral-8x7b", True)])
def test_scalar_clock_decode_matches_jax(arch, ring):
    cfg, jcfg = configs.get_smoke(arch), jconfigs.get_smoke(arch)
    assert (0 < cfg.window < MAX_LEN) == ring
    drawn = numpy_params(cfg)
    params = params_from_jax(drawn, cfg, "cpu")
    jparams = jax.tree.map(jnp.asarray, drawn)
    cache = M.init_cache(cfg, SLOTS, MAX_LEN, "cpu")
    jcache = JM.init_cache(jcfg, SLOTS, MAX_LEN)
    jstep = jax.jit(partial(JM.decode_step, jcfg))
    step = make_serve_step(cfg)
    rng = np.random.default_rng(1)
    with torch.inference_mode():
        for pos in range(MAX_LEN + 1):
            tok = rng.integers(0, cfg.vocab, (SLOTS, 1)).astype(np.int32)
            expect, jcache = jstep(jparams, jnp.asarray(tok), jcache,
                                   jnp.int32(pos))
            logits, _ = M.decode_step(cfg, M.prepare_params(cfg, params),
                                      torch.from_numpy(tok),
                                      tree_map(torch.clone, cache),
                                      torch.tensor(pos, dtype=torch.int32))
            nxt, cache = step(params, cache, torch.from_numpy(tok), pos)
            _close(logits, expect, f"logits at pos {pos}")
            np.testing.assert_array_equal(
                nxt.numpy(), np.asarray(jnp.argmax(expect[:, -1:], -1)))
    mine, theirs = dict(tree_items(cache)), dict(tree_items(jcache))
    assert mine.keys() == theirs.keys()
    for k in mine:
        _close(mine[k], theirs[k], k)


def test_scalar_clock_past_max_len_overwrites_last_row():
    """The dense cache at pos == max_len: the write lands in row L-1, as
    JAX's dynamic_update_slice clamps it; the per-slot write drops it."""
    cfg = configs.get_smoke("qwen2-0.5b")
    params = M.prepare_params(cfg, params_from_jax(numpy_params(cfg), cfg,
                                                   "cpu"))
    tok = torch.ones(SLOTS, 1, dtype=torch.int32)
    cache = M.init_cache(cfg, SLOTS, MAX_LEN, "cpu")
    k = cache["groups"]["slot0"]["attn"]["k"]
    with torch.inference_mode():
        M.decode_step(cfg, params, tok, cache,
                      torch.full((SLOTS,), MAX_LEN, dtype=torch.int32))
        assert not k.any()
        M.decode_step(cfg, params, tok, cache,
                      torch.tensor(MAX_LEN, dtype=torch.int32))
        assert k[:, :, -1].abs().sum() > 0 and not k[:, :, :-1].any()


class _RecordingJit:
    """Stands in for ``jax`` inside the JAX example: every jitted serve
    step's next tokens are recorded, host-side, after the call."""

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


def test_example_serve_matches_jax(monkeypatch, capsys):
    spec = importlib.util.spec_from_file_location(
        "jax_example_serve", ROOT / "examples" / "serve.py")
    jexample = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jexample)
    cfg = configs.get_smoke("llama3_2_1b")
    drawn = numpy_params(cfg)
    steps = []
    monkeypatch.setattr(jexample, "jax", _RecordingJit(steps))
    monkeypatch.setattr(JM, "init_params", lambda jcfg, key: jax.tree.map(
        jnp.asarray, drawn))
    jexample.main()
    theirs = [ln for ln in capsys.readouterr().out.splitlines()
              if ln.startswith("req")]

    out_tokens, _ = example.serve_batch(cfg,
                                        params_from_jax(drawn, cfg, "cpu"))
    maxp = max(example.PROMPT_LENS)
    assert len(steps) == maxp + example.GEN_LEN - 1
    for i, toks in enumerate(out_tokens):
        assert toks == [int(s[i, 0]) for s in steps[maxp - 1:]]
    mine = [f"req{i} (prompt {n} toks) -> {out_tokens[i][:12]}..."
            for i, n in enumerate(example.PROMPT_LENS)]
    assert mine == theirs


def test_trace_report_matches_jax(tmp_path, capsys):
    traces = [str(TRACES / "serve_smoke_s2.log"),
              str(TRACES / "serve_smoke_s4.log")]
    argv = ["report", "--traces", *traces, "--fractions", "0.9", "0.5"]
    assert trace_cli.main(argv + ["--out", str(tmp_path / "port.json")]) == 0
    assert jtrace.main(argv + ["--out", str(tmp_path / "jax.json")]) == 0
    mine = json.loads((tmp_path / "port.json").read_text())
    assert mine == json.loads((tmp_path / "jax.json").read_text())
    assert mine["equivalence_failures"] == 0 and len(mine["curves"]) == 6
    assert "equivalence OK" in capsys.readouterr().out


def test_random_dag_source_matches_jax(tmp_path):
    out = tmp_path / "dag.log"
    with contextlib.redirect_stdout(io.StringIO()):
        assert trace_cli.main(["capture", "--source", "random-dag",
                               "--out", str(out)]) == 0
    assert out.read_text() == jgraphs.random_dag(120, seed=0).dumps() + "\n"
