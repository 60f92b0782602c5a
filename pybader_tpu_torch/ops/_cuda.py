"""Build, load and count the hand-written CUDA kernels (``csrc/*.cu``).

The kernels compile at first use with ``nvcc`` (one process per source,
all started together, then one link) into a shared library with a plain C
interface, loaded with ctypes.  The library is named by a hash
of the sources and the flags, under ``pybader_tpu_torch/_build/``, so a
source edit rebuilds and a stale binary is never loaded.  Importing this
module builds and loads nothing: CPU-only hosts (the test suite) never
call :func:`library`.

Each kernel's Python wrapper (in the op module that owns it) checks its
arguments, allocates the outputs with ``torch.empty``, calls the C entry on
PyTorch's current stream, raises if the entry returns an error, and adds
one to :data:`launches` under its own name.  There is no fallback: on a
CUDA tensor a wrapper launches its kernel or raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from collections import Counter

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("stencil.cu", "flood.cu", "reduce.cu", "edges.cu", "neargrid.cu",
           "block_walk.cu", "chase.cu")
HEADERS = ("common.cuh", "grad.cuh", "qwalk.cuh", "jump.cuh", "walk.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # exact f64: no contraction of a*b+c into one rounding (stencil.cu)
    "-fmad=false",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Kernel launches by wrapper name, counted where each wrapper launches.
launches: Counter = Counter()

# C entry points: name -> argtypes (pointers and the stream as void*).
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ENTRIES = {
    "pb_ongrid_step_codes": (_P, _P, _P, _I, _I, _I, _I, _P),
    "pb_resolve_roots": (_P, _P, _I, _I, _I, _P, _I, _P, _I, _P),
    "pb_min_pair": (_P, _P, _P, _P, _L, _I, _I, _P),
    "pb_remap": (_P, _P, _P, _L, _I, _I, _P),
    "pb_charge_volume": (_P, _P, _P, _P, _P, _L, _I, _I, _P),
    "pb_charge_volume_scratch": (_L, _I, _I, _P),
    "pb_surface_min_d2": (_P, _P, _P, _P, _P, *(_I,) * 9, _I, _I, _P),
    "pb_edge_find": (_P, _P, _P, _I, _I, _I, _I, _P),
    "pb_edge_check": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "pb_neargrid_rows": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "pb_neargrid_walk": (_P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _I,
                         _P),
    "pb_stop_bitmap": (_P, _P, _L, _I, _P),
    "pb_neargrid_walk_occupancy": (_I, _P),
    "pb_neargrid_qrows": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "pb_neargrid_walk_q": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _L, _I, _I, _I,
                           _I, _I, _P),
    "pb_block_walk": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _L, _I, _I,
                      _I, _I, _I, _P),
    "pb_nginit_codes": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "pb_chase": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "pb_neargrid_walk_shard": (_P, _P, _P, _P, _P, _P, _P, _P, _L, *(_I,) * 8,
                               _I, _P),
}

_lib = None
build_seconds = None  # wall time of the build this process ran, if any


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.isfile(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            "of pybader_tpu_torch build from source at first use")
    return path


def _lib_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"libpybader_cuda-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernels if this source revision has no library yet;
    returns the library path.  Each source compiles in its own nvcc
    process, all at once; nvcc's output (ptxas register and spill report
    included) goes to ``_build/build.log``."""
    global build_seconds
    path = _lib_path()
    if os.path.isfile(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    log = []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as obj_dir:
        objs = [os.path.join(obj_dir, s + ".o") for s in SOURCES]
        cmds = [[nvcc, *NVCC_FLAGS, "-I", CSRC, "-c",
                 os.path.join(CSRC, s), "-o", o]
                for s, o in zip(SOURCES, objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for c in cmds]
        failed = []
        for c, p in zip(cmds, procs):
            out = p.communicate()[0]
            log.append(" ".join(c) + "\n" + out)
            if p.returncode != 0:
                failed.append(f"{c[-3]} (exit {p.returncode}):\n{out[-4000:]}")
        if not failed:
            link = [nvcc, "-shared", "-o", tmp, *objs]
            proc = subprocess.run(link, capture_output=True, text=True)
            log.append(" ".join(link) + "\n" + proc.stdout + proc.stderr)
            if proc.returncode != 0:
                failed.append(f"link (exit {proc.returncode}):\n"
                              f"{proc.stderr[-4000:]}")
    with open(os.path.join(BUILD_DIR, "build.log"), "w") as f:
        f.write("\n".join(log))
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, path)  # atomic when several processes build at once
    build_seconds = time.perf_counter() - t0
    return path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        for name, argtypes in _ENTRIES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


class KernelError(RuntimeError):
    """A C entry point returned a non-zero code (``code``): a
    ``cudaError_t``, or -1 where an entry documents its own failure."""

    def __init__(self, entry: str, code: int):
        super().__init__(f"{entry} failed with code {code}")
        self.code = code


def call(entry: str, *args) -> None:
    """Call a C entry point and raise :class:`KernelError` on failure."""
    err = getattr(library(), entry)(*args)
    if err != 0:
        raise KernelError(entry, err)


def stream(t) -> int:
    """PyTorch's current stream on ``t``'s device, as a raw handle."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check(t, dtype, name: str, shape=None, per_voxel: int = 1) -> None:
    """Validate a kernel argument: CUDA, dtype, contiguous, shape, and
    fewer than 2**31 voxels (``per_voxel`` elements a voxel)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if t.numel() // per_voxel >= 1 << 31:
        raise ValueError(f"{name}: {t.numel() // per_voxel} voxels; int32 "
                         f"voxel indices need fewer than 2**31")


def on_cuda(t) -> bool:
    """Dispatch rule of every kernel-backed op: True for a CUDA tensor
    (launch the kernel), False for a CPU tensor (plain PyTorch version)."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}: expected cuda or cpu")
