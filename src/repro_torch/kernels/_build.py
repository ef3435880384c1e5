"""Build the CUDA kernels under ``csrc/`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own with
``nvcc`` into ``build/repro_torch/<name>-<hash>.so`` at the repository root
(the hash covers the source, the ``csrc/`` headers it includes and the
flags, so an edited source or header rebuilds).
Nothing is built at import: the first wrapper call on a CUDA tensor builds
its kernel, and :func:`build` starts several builds at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# After the source: the TMA kernels look up cuTensorMapEncodeTiled with dlsym.
LINK_FLAGS = ("-ldl",)
_INCLUDE = re.compile(r'^\s*#include\s+"([^"]+)"', re.M)

_LOADED: dict[str, ctypes.CDLL] = {}


def plain(tensors) -> bool:
    """Whether a wrapper call takes the kernel's plain version: every
    tensor a CPU tensor, none a shard of the mesh (:func:`sharded`).  A
    DTensor (the dry run's sharded state, whose fake shards lie on the
    mesh's host) goes to the kernel's dispatcher op, as a CUDA tensor
    does."""
    return all(t.device.type == "cpu" for t in tensors) and not any(
        sharded(t) for t in tensors)


def sharded(t) -> bool:
    """Whether ``t`` is a shard of the mesh: a DTensor, whose device is the
    mesh's and whose op's sharding strategy, not the wrapper, places it,
    or a fake tensor whose ``FakeTensorMode`` carries ``mesh_shards =
    True``: a fake local shard of a mesh traced on its host, which goes to
    the kernels' dispatcher ops, whose fake implementations give the
    results' shapes, as the card's shards would go to the kernels.  Any
    other fake CPU tensor (a ``make_fx`` capture's) takes the plain
    version.  (No DTensor exists before ``torch.distributed.tensor`` is
    imported.)"""
    mod = sys.modules.get("torch.distributed.tensor")
    if mod is not None and isinstance(t, mod.DTensor):
        return True
    return getattr(getattr(t, "fake_mode", None), "mesh_shards", False)


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH): the CUDA kernels cannot be built")
    return found


def sources(name: str) -> list[Path]:
    """``csrc/<name>.cu`` and every header it includes with quotes,
    transitively."""
    found, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop()
        if path in found:
            continue
        found.append(path)
        todo += [path.parent / inc
                 for inc in _INCLUDE.findall(path.read_text())]
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for path in sources(name):
        h.update(path.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names) -> dict[str, str]:
    """Compile every named kernel that is not built yet, all in parallel.

    Returns each newly built kernel's compiler output (register and shared
    memory use from ``-Xptxas -v``).  Raises if any build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu"),
             *LINK_FLAGS],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n"
                          f"{logs[name]}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The kernel library ``name``, built on first use.

    ``signatures`` maps each C function to ``(argtypes, restype)``; every
    pointer and the stream must be ``c_void_p``, or ctypes cuts them to 32
    bits.
    """
    lib = _LOADED.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        signatures = dict(signatures, repro_cuda_error_string=(
            [ctypes.c_int], ctypes.c_char_p))
        for fn, (argtypes, restype) in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _LOADED[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
