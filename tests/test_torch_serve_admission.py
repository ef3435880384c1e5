"""The port's serve launcher against the JAX package's, every flag.

Both drivers serve the same flags on the same parameters (drawn with
numpy): 8 requests over 4 slots, 8 tokens each, ``--max-len 32``,
``--kv-budget 0.3``, ``--capture`` and ``--offload-sweep``; qwen2 smoke under
chaos squeezes (``--chaos-shrink 0.5 --chaos-period 16``), rwkv6 smoke
without.  Each must give the same next token in every slot at every step,
the same admission counters and event list, a byte-identical captured log
and the same printed lines (the ``admission:`` line, the requests, the
offload sweep), the timing line aside.  Then the flags themselves: the
reference's defaults, the refused mesh, ``--offload-sweep`` without
``--capture``, and no silent CPU fallback.
"""
import argparse
import contextlib
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.launch import admission as jadmission  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.steps import make_serve_step  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.params import tree_map  # noqa: E402

BASE = ["--smoke", "--requests", "8", "--slots", "4", "--gen", "8",
        "--max-len", "32", "--kv-budget", "0.3", "--offload-sweep"]
RUNS = {
    "qwen2-0.5b": BASE + ["--chaos-shrink", "0.5", "--chaos-period", "16"],
    "rwkv6-1.6b": BASE,
}


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


@pytest.fixture(scope="module", params=sorted(RUNS))
def served(request, tmp_path_factory):
    """Both drivers on one arch's flags: (JAX, port) each as a dict of the
    steps' tokens, the printed lines, the counters, the events and the
    captured log."""
    arch = request.param
    tmp = tmp_path_factory.mktemp(arch)
    flags = ["--arch", arch] + RUNS[arch]
    jax_run, port_run = {"steps": []}, {"steps": []}
    controllers = []
    cfg = configs.get_smoke(arch)
    drawn = numpy_params(cfg)

    class Recorded(jadmission.AdmissionController):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            controllers.append(self)

    # Each driver captures to serve.log in a directory of its own, so that
    # the printed lines name the same path.
    for side in ("jax", "port"):
        (tmp / side).mkdir()
    flags += ["--capture", "serve.log"]
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        mp.chdir(tmp / "jax")
        mp.setattr(jserve, "jax", _RecordingJit(jax_run["steps"]))
        mp.setattr(jadmission, "AdmissionController", Recorded)
        # The JAX driver serves the numpy-drawn parameters.
        mp.setattr(JM, "init_params", lambda jcfg, key: jax.tree.map(
            lambda x: jnp.asarray(x, jcfg.param_dtype), drawn))
        jserve.main(flags)
    jax_run["lines"] = out.getvalue().splitlines()
    (ctl,) = controllers
    jax_run.update(counters=ctl.counters(), events=ctl.events,
                   log=(tmp / "jax" / "serve.log").read_bytes())

    params = params_from_jax(drawn, cfg, "cpu")
    args = serve.parse_args(flags)
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        mp.chdir(tmp / "port")
        mp.setattr(serve, "make_serve_step",
                   _recording(make_serve_step, port_run["steps"]))
        res = serve.serve_loop(cfg, params, args)
        serve.report(args, res, torch.device("cpu"))
    port_run["lines"] = out.getvalue().splitlines()
    port_run.update(counters=res.counters, events=res.events,
                    log=(tmp / "port" / "serve.log").read_bytes(),
                    result=res)
    return arch, jax_run, port_run


def test_tokens_match_jax_every_step(served):
    """Preempted slots restart clean (an rwkv state included): the same
    next token in every slot at every step, and every request served."""
    _, theirs, mine = served
    assert len(mine["steps"]) == len(theirs["steps"]) > 0
    for a, b in zip(mine["steps"], theirs["steps"]):
        np.testing.assert_array_equal(a, b)
    res = mine["result"]
    assert sorted(res.completed) == list(range(8))
    assert all(len(t) == 8 for t in res.completed.values())


def test_admission_counters_match_jax(served):
    arch, theirs, mine = served
    assert mine["counters"] == theirs["counters"]
    c = mine["counters"]
    assert c["completed"] == 8 and c["rejected"] == 0
    assert c["preemptions"] > 0 and c["requeued"] == c["preemptions"]


def test_admission_events_match_jax(served):
    arch, theirs, mine = served
    assert mine["events"] == theirs["events"]
    kinds = {e["kind"] for e in mine["events"]}
    assert "preempt_requeue" in kinds
    if arch == "qwen2-0.5b":   # the chaos squeezes, and their end
        assert {"budget_shrink", "budget_restore"} <= kinds


def test_capture_matches_jax_byte_for_byte(served):
    _, theirs, mine = served
    assert mine["log"] == theirs["log"]
    assert mine["result"].log.op_count() > 0


def test_printed_lines_match_jax(served):
    """``admission:``, the requests, the capture and every offload-sweep
    line; the first line's timing aside."""
    _, theirs, mine = served
    assert mine["lines"][0].split(",")[:2] == theirs["lines"][0].split(",")[:2]
    assert mine["lines"][1:] == theirs["lines"][1:]
    assert mine["lines"][1].startswith("admission: admitted=")
    sweep = [ln for ln in mine["lines"] if ln.startswith("  dev=")]
    assert len(sweep) == 6
    assert any("FAIL" in ln for ln in sweep)
    assert any("overhead=" in ln for ln in sweep)


# ---------------------------------------------------------------------------
# The flags
# ---------------------------------------------------------------------------

class _Parser(Exception):
    pass


def _reference_parser(monkeypatch) -> argparse.ArgumentParser:
    """The parser ``repro.launch.serve.main`` builds, caught as it parses."""
    def grab(self, args=None, namespace=None):
        raise _Parser(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(_Parser) as caught:
        jserve.main([])
    monkeypatch.undo()
    return caught.value.args[0]


def test_serve_launcher_defaults_match_reference(monkeypatch):
    ref = {a.dest: a.default for a in _reference_parser(monkeypatch)._actions
           if a.dest != "help"}
    port = vars(serve.parse_args([]))
    assert ref.keys() <= port.keys()          # every reference flag is taken
    assert {k: port[k] for k in ref} == ref
    assert port["arch"] == "llama3.2-1b" and port["device"] is None


def test_serve_help_shows_defaults(monkeypatch, capsys):
    ref = _reference_parser(monkeypatch)
    with pytest.raises(SystemExit):
        serve.parse_args(["--help"])
    text = " ".join(capsys.readouterr().out.split())
    for a in ref._actions:
        if a.dest != "help":
            assert f"(default: {a.default})" in text, a.dest


@pytest.mark.parametrize("mesh", ["production", "multipod"])
def test_serve_refuses_mesh(mesh):
    """On one process the production meshes fail with the reference's own
    assertion (its launcher's on a host with too few devices)."""
    n, shape = (256, r"\(16, 16\)") if mesh == "production" \
        else (512, r"\(2, 16, 16\)")
    assert serve.parse_args(["--mesh", mesh]).mesh == mesh
    with pytest.raises(AssertionError,
                       match=rf"need {n} devices for mesh {shape}, have 1"):
        serve.main(["--arch", "qwen2-0.5b", "--smoke", "--device", "cpu",
                    "--mesh", mesh, "--requests", "1", "--gen", "2"])


def test_offload_sweep_needs_capture(capsys):
    with pytest.raises(SystemExit) as e:
        serve.parse_args(["--offload-sweep"])
    assert e.value.code == 2
    assert "--offload-sweep needs --capture" in capsys.readouterr().err


def test_serve_needs_a_card_unless_told_cpu():
    argv = ["--arch", "rwkv6-1.6b", "--smoke", "--requests", "1"]
    if torch.cuda.is_available():
        assert serve.resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="--device cpu"):
            serve.main(argv)
    res = serve.main(argv + ["--device", "cpu", "--gen", "2",
                             "--max-len", "16"])
    assert len(res.completed) == 1 and res.counters is None
