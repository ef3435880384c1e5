"""The port's dry run held to the reference's own dry run on the CPU.

Each side runs in a subprocess, as ``tests/test_dryrun.py`` runs the
reference: the reference compiles nine cheap single-pod cells (XLA's CPU
backend, 256 forced host devices), the port traces them on its fake
256-rank process group (``--device cpu``).  The two run side by side.  For
each cell the port's peak a device is at most twice the reference's (XLA's
buffer assignment, arguments + temp) and under an H100's 80 GiB, and its
FLOPs a device at most 1.5 times the reference's (loop-weighted, from the
compiled HLO).  On the four context-parallel cells (``decode_32k`` and
``long_500k``, whose KV cache's sequence is sharded) its collective bytes
a device are at most 4 times the reference's (its HLO's collectives'
result bytes), and each device's flash call reads only its own keys.
llama3.2-1b ``train_4k`` counts at most 0.6 of its single-pod FLOPs a
device on the multi-pod mesh, which has twice the devices.

Two faults that torch 2.11's DTensor raised on the card's host are held on
smoke configs and a (2, 2) fake mesh, by what their repair guarantees
(the card's torch is not the one here):
- ``constant_pad_nd`` never meets a DTensor (its 2.11 strategy is one
  placement long on any mesh: ``IndexError`` in the redistribute planner);
  rwkv6's token shift and the RG-LRU's conv pad each device's shard;
- the MoE dispatch, its grouped GEMMs and its combine never run as DTensor
  ops (2.11 viewed a transposed local shard: ``ValueError``), and every
  grouped GEMM gets contiguous operands.
"""
import json
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GIB = 2**30

# The cells whose KV cache's sequence is sharded over the mesh (each
# device attends its own keys, merged by log-sum-exp) and whose MoE rows
# are replicated over FSDP's dims (mixtral ``long_500k``).
CONTEXT = [("qwen2-0.5b", "decode_32k"), ("llama3.2-1b", "decode_32k"),
           ("gemma3-1b", "long_500k"), ("mixtral-8x7b", "long_500k")]
CELLS = [("mixtral-8x7b", "prefill_32k"), ("mixtral-8x7b", "decode_32k"),
         ("deepseek-v3-671b", "decode_32k"), ("llama3.2-1b", "prefill_32k"),
         ("llama-3.2-vision-11b", "prefill_32k")] + CONTEXT
TRAIN = ("llama3.2-1b", "train_4k")

REFERENCE = """
import json, sys
from repro.launch import dryrun as d      # forces 512 host devices first
from repro.launch.mesh import make_production_mesh
out = {}
for arch, shape in json.loads(sys.argv[1]):
    r = d.build_cell(arch, shape, make_production_mesh(multi_pod=False))
    out[arch + " " + shape] = [r["memory"]["peak_bytes_per_device"],
                               r["cost"]["flops"],
                               r["collectives"]["total_bytes"]]
print(json.dumps(out))
"""

PORT = """
import json, sys
from torch.distributed.tensor import DTensor
from repro_torch.launch import dryrun as d
keys = []
base = d._Counts.__torch_dispatch__


def record(self, func, types, args=(), kwargs=None):
    if func._opname == "flash_fwd" and not d._PROPAGATING and not any(
            issubclass(t, DTensor) for t in types):
        keys.append(args[1].shape[2])
    return base(self, func, types, args, kwargs)


d._Counts.__torch_dispatch__ = record
out = {}
for arch, shape, multi in json.loads(sys.argv[1]):
    keys.clear()
    r = d.run_cell(arch, shape, multi)
    out[arch + " " + shape + (" multi" if multi else "")] = [
        r["memory"]["peak_bytes_per_device"], r["cost"]["flops"],
        r["collectives"]["total_bytes"], max(keys, default=0)]
print(json.dumps(out))
"""


# -- the two torch 2.11 faults, on smoke configs and a (2, 2) fake mesh -----

SMOKE = """
import json, sys
import torch
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor
from repro_torch import configs
from repro_torch.launch import dryrun as d

d.configs.get = configs.get_smoke
d.SHAPES = {"train_4k": dict(kind="train", seq=64, batch=4),
            "prefill_32k": dict(kind="prefill", seq=64, batch=4),
            "decode_32k": dict(kind="decode", seq=64, batch=4)}
seen, gemm_dense = set(), []
base = d._Counts.__torch_dispatch__


def record(self, func, types, args=(), kwargs=None):
    if any(issubclass(t, DTensor) for t in types):
        seen.add(func._opname)
    elif func._opname.startswith("moe_gemm") and not d._PROPAGATING:
        gemm_dense.append(all(t.is_contiguous() for t in args
                              if isinstance(t, torch.Tensor)))
    return base(self, func, types, args, kwargs)


d._Counts.__torch_dispatch__ = record
out = {}
for arch, shape in json.loads(sys.argv[1]):
    seen.clear()
    gemm_dense.clear()
    with d.fake_world(4):
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        d.build_cell(arch, shape, mesh,
                     grad_accum=2 if shape == "train_4k" else None)
    out[arch + " " + shape] = {"dtensor_ops": sorted(seen),
                               "gemm_dense": list(gemm_dense)}
print(json.dumps(out))
"""

PAD_CELLS = [("rwkv6-1.6b", "train_4k"),
             ("recurrentgemma-2b", "prefill_32k")]
MOE_CELLS = [("mixtral-8x7b", "decode_32k"),
             ("deepseek-v3-671b", "decode_32k"),
             ("deepseek-v3-671b", "train_4k")]
MOE_OPS = {"scatter", "scatter_", "scatter_add", "gather", "masked_fill",
           "searchsorted", "moe_gemm_fwd", "moe_gemm_bwd"}


def _start(code, arg):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    return subprocess.Popen([sys.executable, "-c", code, json.dumps(arg)],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _result(proc, timeout=600):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, out[-2000:] + err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def procs():
    """Every subprocess of the file, started at once: the reference's
    cells, the port's, its train cell on both meshes and the smoke
    cells."""
    started = {"ref": _start(REFERENCE, CELLS),
               "port": _start(PORT, [[a, s, False] for a, s in CELLS]),
               "train": _start(PORT, [[*TRAIN, False], [*TRAIN, True]]),
               "smoke": _start(SMOKE, PAD_CELLS + MOE_CELLS)}
    yield started
    for p in started.values():
        if p.poll() is None:
            p.kill()
            p.communicate()


@pytest.fixture(scope="module")
def runs(procs):
    return (_result(procs["ref"]),
            {**_result(procs["port"]), **_result(procs["train"])})


@pytest.fixture(scope="module")
def smoke(procs):
    return _result(procs["smoke"])


@pytest.mark.parametrize("arch,shape", CELLS)
def test_peak_within_twice_the_reference(runs, arch, shape):
    ref, port = runs
    peak, want = port[f"{arch} {shape}"][0], ref[f"{arch} {shape}"][0]
    assert peak < 80 * GIB
    assert peak <= 2 * want, (peak / GIB, want / GIB)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_flops_within_one_and_a_half_the_reference(runs, arch, shape):
    ref, port = runs
    flops, want = port[f"{arch} {shape}"][1], ref[f"{arch} {shape}"][1]
    assert flops <= 1.5 * want, (flops / 1e12, want / 1e12)


@pytest.mark.parametrize("arch,shape", CONTEXT)
def test_collective_bytes_within_four_times_the_reference(runs, arch,
                                                          shape):
    """The sharded cache is not gathered: each device moves at most 4x the
    bytes the reference's partitioner moves (a few MB; the gathered cache
    was 10^3-10^6 times them)."""
    ref, port = runs
    got, want = port[f"{arch} {shape}"][2], ref[f"{arch} {shape}"][2]
    assert got <= 4 * want, (got / 1e6, want / 1e6)


# The most keys a device's flash call may read: its shard of the longest
# cache, 32768 rows over the model dim's 16 (decode_32k), 524288 (gemma3's
# global layers) or mixtral's ring of 4096 over all 256 devices
# (long_500k).
LOCAL_KEYS = {"qwen2-0.5b decode_32k": 2048, "llama3.2-1b decode_32k": 2048,
              "gemma3-1b long_500k": 2048, "mixtral-8x7b long_500k": 16}


@pytest.mark.parametrize("arch,shape", CONTEXT)
def test_each_device_attends_only_its_keys(runs, arch, shape):
    """No flash call reads a gathered cache: the longest key range any
    device's call gets is its own shard of the cache."""
    _, port = runs
    assert port[f"{arch} {shape}"][3] == LOCAL_KEYS[f"{arch} {shape}"]


def test_multi_pod_train_flops_fall(runs):
    """Twice the devices: at most 0.6 of the single pod's FLOPs a device
    (the data dim doubles; nothing may be computed whole per pod)."""
    _, port = runs
    single, multi = port[" ".join(TRAIN)][1], port[" ".join(TRAIN) +
                                                    " multi"][1]
    assert multi <= 0.6 * single, multi / single


@pytest.mark.parametrize("arch,shape", PAD_CELLS)
def test_no_pad_meets_a_dtensor(smoke, arch, shape):
    ops = smoke[f"{arch} {shape}"]["dtensor_ops"]
    assert ops and "constant_pad_nd" not in ops


@pytest.mark.parametrize("arch,shape", MOE_CELLS)
def test_moe_buffers_stay_local_and_dense(smoke, arch, shape):
    cell = smoke[f"{arch} {shape}"]
    assert not MOE_OPS & set(cell["dtensor_ops"]), cell["dtensor_ops"]
    calls = 3 if shape != "train_4k" else 3 + 3
    assert len(cell["gemm_dense"]) >= calls and all(cell["gemm_dense"])
