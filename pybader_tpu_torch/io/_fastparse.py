"""ctypes bindings for the native float-block parser (native/fastparse.cpp)
and the CHGCAR block reader (_chgcar.cpp beside this file).

Builds each shared library lazily on first use (g++ -O3) into a
content-hash-keyed path, so the binary is never shared across hosts or
stale source revisions (an -march=native build from another CPU would
SIGILL straight through the callers' ``except Exception`` fallbacks).
Falls back cleanly: callers catch any exception raised by a load and use
the numpy parse path (pybader_tpu_torch/utils.py:parse_float_block, and
``vasp.read``'s Python block reader).  ``parse_floats`` and
``format_floats`` are copies of :mod:`pybader_tpu.io._fastparse`'s; both
packages build the same native/fastparse.cpp.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, os.pardir, os.pardir, "native", "fastparse.cpp")
_CHGCAR_SRC = os.path.join(_HERE, "_chgcar.cpp")
_lib = None
_chgcar_lib = None


def _lib_path(src: str, stem: str) -> str:
    """Build-product path keyed on the source content hash.

    The package dir is preferred (persists across runs); a per-user temp
    dir is the fallback for read-only installs.
    """
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    name = f"lib{stem}-{digest}.so"
    if os.access(_HERE, os.W_OK):
        return os.path.join(_HERE, name)
    cache = os.path.join(
        tempfile.gettempdir(), f"pybader_tpu_torch-{os.getuid()}")
    os.makedirs(cache, exist_ok=True)
    return os.path.join(cache, name)


def _build(src: str, lib_path: str):
    # -march=native is safe: the output path is host-local and never
    # committed, so a binary can't migrate to a CPU it wasn't built for
    tmp = lib_path + f".tmp{os.getpid()}"
    cmd = [
        "g++", "-O3", "-march=native", "-shared", "-fPIC", "-pthread",
        "-o", tmp, src,
    ]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, lib_path)  # atomic when several processes build at once


def _open(src: str, stem: str) -> ctypes.CDLL:
    """The library built from ``src``, built first where it is not yet."""
    src = os.path.abspath(src)
    if not os.path.isfile(src):
        raise FileNotFoundError(src)
    lib_path = _lib_path(src, stem)
    if not os.path.isfile(lib_path):
        _build(src, lib_path)
    return ctypes.CDLL(lib_path)


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = _open(_SRC, "fastparse")
    lib.fp_parse.restype = ctypes.c_long
    lib.fp_parse.argtypes = [
        ctypes.c_char_p, ctypes.c_long,
        ctypes.POINTER(ctypes.c_double), ctypes.c_long, ctypes.c_int,
    ]
    lib.fp_format.restype = ctypes.c_long
    lib.fp_format.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_long, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_long,
        ctypes.c_char_p, ctypes.c_long, ctypes.c_int,
    ]
    _lib = lib
    return lib


def format_floats(values: np.ndarray, cols: int, mode: int, prec: int,
                  n_threads: int | None = None, row_len: int = 0) -> str:
    """Format doubles into density-text rows (native fast path).

    ``mode``: 0 = python exponent form, 1 = sign-column padded, 2 =
    fortran standard form — byte-exact vs utils.python_format /
    fortran_format (asserted in tests/test_native_format.py).
    ``row_len`` > 0 formats logical rows of that many values independently
    (each ends its own line — the cube writer's per-z-row layout).
    """
    lib = _load()
    if n_threads is None:
        n_threads = min(os.cpu_count() or 1, 16)
    vals = np.ascontiguousarray(values, dtype=np.float64).reshape(-1)
    cap = vals.size * (prec + 12) + 64
    buf = ctypes.create_string_buffer(cap)
    got = lib.fp_format(
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), vals.size,
        cols, mode, prec, row_len, buf, cap, n_threads,
    )
    if got < -1:  # buffer estimate too small (huge exponents): retry
        cap = -got + 64
        buf = ctypes.create_string_buffer(cap)
        got = lib.fp_format(
            vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            vals.size, cols, mode, prec, row_len, buf, cap, n_threads,
        )
    if got < 0:
        raise ValueError("fp_format failed")
    return buf.raw[:got].decode("ascii")


def parse_floats(text: str, count: int, n_threads: int | None = None
                 ) -> np.ndarray:
    """Parse the first ``count`` whitespace-separated floats from text."""
    lib = _load()
    if n_threads is None:
        n_threads = min(os.cpu_count() or 1, 16)
    buf = text.encode() if isinstance(text, str) else bytes(text)
    out = np.empty(count, dtype=np.float64)
    got = lib.fp_parse(
        buf, len(buf),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        count, n_threads,
    )
    if got < count:
        raise ValueError(f"expected {count} floats, parsed {got}")
    return out


def load_chgcar() -> ctypes.CDLL:
    """The CHGCAR block reader's library (_chgcar.cpp), built on first use;
    raises where it cannot be built or loaded."""
    global _chgcar_lib
    if _chgcar_lib is not None:
        return _chgcar_lib
    lib = _open(_CHGCAR_SRC, "chgcar")
    lib.chg_read_block.restype = ctypes.c_long
    lib.chg_read_block.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_long, ctypes.c_long,
        ctypes.c_long, ctypes.c_double, ctypes.POINTER(ctypes.c_double),
        ctypes.c_int, ctypes.POINTER(ctypes.c_long),
    ]
    _chgcar_lib = lib
    return lib


def read_chgcar_block(lib: ctypes.CDLL, path: str, offset: int, shape,
                      out: np.ndarray | None, volume: float = 1.0,
                      threads: int | None = None) -> int:
    """Read the density block of ``path`` whose text starts at byte
    ``offset``, a grid of ``shape`` (nx, ny, nz) in the file's x-fastest
    order, into ``out`` (C-contiguous float64 of ``shape``), x-major, each
    value over ``volume``; with ``out`` None the block is only skipped.
    Returns the byte offset past the line of the block's last value.  The
    parse runs on one thread a CPU this process may use, at most 16, and
    at most ``threads``."""
    n_threads = min(len(os.sched_getaffinity(0)), 16)
    if threads:
        n_threads = min(n_threads, int(threads))
    nx, ny, nz = (int(s) for s in shape)
    if out is not None and (out.shape != (nx, ny, nz)
                            or out.dtype != np.float64
                            or not out.flags.c_contiguous
                            or not out.flags.writeable):
        raise ValueError("out must be a writable C-contiguous float64 "
                         f"array of shape {(nx, ny, nz)}")
    info = (ctypes.c_long * 2)()
    end = lib.chg_read_block(
        os.fsencode(path), offset, nx, ny, nz, float(volume),
        None if out is None else
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        n_threads, info)
    if end == -2:
        raise ValueError(f"{path}: the density block at byte {offset} ends "
                         f"after {info[0]} of {nx * ny * nz} values")
    if end == -3:
        raise ValueError(f"{path}: no number at byte {info[1]} of the "
                         f"density block at byte {offset}")
    if end < 0:
        raise OSError(f"{path}: cannot open or map the file")
    return end
