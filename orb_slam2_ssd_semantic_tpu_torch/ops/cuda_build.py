"""Build and load the port's CUDA kernels (route: nvcc -> shared library
with a plain C interface -> ctypes).

Each `csrc/<name>.cu` compiles on first use into
`build/torch_kernels/lib<name>.so` at the repository root, for Hopper
(`sm_90a`). Nothing here runs at import time, so the CPU-only tests can
import every module. `build_all()` starts one nvcc per source at once.
`register()` takes a kernel from outside the package (a measurement's)
through the same build and launch; `KERNELS` lists only the port's own.
`captured` counts, by kernel, the launches made while the current stream
was capturing a CUDA graph: those kernels run at every replay of the
graph, which calls no wrapper, so a replay's launches are read from a
trace of the card, not from a counter. `conditional` counts those made
inside the body of a conditional node (`mapping/graph_cond.py`), which a
replay runs only where the node's predicate holds (a counter on the card
says how often each body ran).
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
_P, _I = ctypes.c_void_p, ctypes.c_int
# Each kernel's C launch function, `int <name>(...)`, by its argument types;
# it returns cudaGetLastError() after the launch.
SIGNATURES = {
    # desc_q, desc_t, centers, uv_t, radius, radius_stride, valid_q, valid_t,
    # Q, T, max_dist, split_len, part, best, second, idx, key_min, stream
    "window_match": [_P] * 5 + [_I] + [_P] * 2 + [_I] * 4 + [_P] * 6,
    # a, lda, b, n, x, stream
    "spd_solve": [_P, _I, _P, _I, _P, _P],
    # a, batch, n, w, v, stream
    "sym_eig": [_P, _I, _I, _P, _P, _P],
    # op (0 begin an if-node and its body's capture, 1 end it), stream, pred, body stream
    "graph_cond": [_I, _P, _P, _P],
}
KERNELS = tuple(SIGNATURES)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_libs: dict = {}
_registered: dict = {}  # name -> source path, kernels from outside the package


def register(name: str, source, argtypes) -> None:
    """Make `source`, a .cu outside `csrc/` with a C launch function
    `int <name>(...)` of `argtypes`, buildable and launchable by `name`."""
    _registered[name] = Path(source)
    SIGNATURES[name] = list(argtypes)


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the toolkit is")
    return found


def _paths(name: str):
    return _registered.get(name, CSRC / f"{name}.cu"), BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    src, lib = _paths(name)
    return not lib.exists() or lib.stat().st_mtime < src.stat().st_mtime


def _start(name: str) -> subprocess.Popen:
    src, lib = _paths(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _finish(name: str, proc: subprocess.Popen) -> str:
    out, _ = proc.communicate()
    src, lib = _paths(name)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{out}")
    os.replace(tmp, lib)
    return out


def build_all(force: bool = False, extra: tuple = ()) -> dict:
    """Compile every kernel source of the port, and the registered kernels
    named in `extra`, in parallel; returns {name: nvcc log}."""
    procs = {n: _start(n) for n in (*KERNELS, *extra) if force or _stale(n)}
    return {n: _finish(n, p) for n, p in procs.items()}


def load(name: str) -> ctypes.CDLL:
    """The kernel library `name`, compiled first if missing or stale, with
    its launch function's C signature set."""
    if name not in _libs:
        if _stale(name):
            _finish(name, _start(name))
        lib = ctypes.CDLL(str(_paths(name)[1]))
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = SIGNATURES[name], ctypes.c_int
        lib.kernel_error_string.argtypes, lib.kernel_error_string.restype = [_I], ctypes.c_char_p
        _libs[name] = lib
    return _libs[name]


@dataclasses.dataclass(frozen=True)
class Prepared:
    """One launch of kernel `name`: its C arguments (device pointers and
    sizes as ints) and the tensors they point into, kept alive with them."""
    name: str
    args: tuple
    tensors: tuple


def launch(p: Prepared) -> None:
    """Call the kernel's C launch function; raise with CUDA's message when
    it returns an error code. A launch into a graph being captured also
    adds one to `captured[p.name]`."""
    lib = load(p.name)
    rc = getattr(lib, p.name)(*p.args)
    if rc != 0:
        msg = lib.kernel_error_string(rc).decode()
        raise RuntimeError(f"{p.name}: CUDA error {rc}: {msg}")
    if torch.cuda.is_current_stream_capturing():
        captured[p.name] = captured.get(p.name, 0) + 1


captured: dict = {}
conditional: dict = {}
