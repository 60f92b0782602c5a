"""Reduce a ``torch.profiler`` trace of the window's analyses to the
device's layers.

The harness marks each analysis with a ``bench.analysis`` range and each
stage of ``Bader.__call__`` (``interface._stage``) with ``bench.stage:<name>``.
On the device's side every operation is one of:

- a host copy (``memcpy_htod``, ``memcpy_dtoh``);
- a hand-written kernel: a ``__global__`` function of the program's
  ``csrc/*.cu`` and ``*.cuh``, named by parsing those sources;
- glue: every other kernel, fill and device-to-device copy (PyTorch's).

Kernels are named for the breakdown by the op whose cost file lists them
(``costs/<op>.py`` ``KERNELS``), else by their ``__global__`` name.
"""
from __future__ import annotations

import glob
import os
import re

_GLOBAL = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?"
    r"([A-Za-z_]\w*)\s*[(<]")
# names of the library kernels PyTorch launches; a kernel in neither class
# is reported by name (and counted as glue)
_LIBRARY = ("at::", "c10::", "cub::", "thrust::", "cutlass", "cublas",
            "cudnn", "fft", "nvjet", "triton", "gemm", "elementwise",
            "reduce_kernel", "Memset", "Memcpy")


def csrc_globals(package_dir: str) -> set:
    """The ``__global__`` function names of ``<package>/csrc``."""
    names = set()
    for path in sorted(glob.glob(os.path.join(package_dir, "csrc", "*.cu"))
                       + glob.glob(os.path.join(package_dir, "csrc", "*.cuh"))):
        with open(path) as f:
            names.update(_GLOBAL.findall(f.read()))
    return names


def kernel_matcher(names):
    """A function from a profiler kernel name (demangled) to its
    ``__global__`` name, or None for another kernel."""
    if not names:
        return lambda name: None
    pat = re.compile(
        r"^(?:void\s+)?(?:pb::)?(?:\(anonymous namespace\)::)?("
        + "|".join(sorted(map(re.escape, names), key=len, reverse=True))
        + r")(?:<|\(|$)")

    def match(name):
        m = pat.match(name)
        return m.group(1) if m else None
    return match


def _kind(ev):
    """'htod', 'dtoh', 'kernel', 'glue' (fills, device copies) or None for
    a device event that runs no operation (an annotation)."""
    act = ev.activity_type() if hasattr(ev, "activity_type") else None
    name = ev.name()
    if act is not None and act not in ("kernel", "gpu_memcpy", "gpu_memset"):
        return None
    # the device-side copies of the host's ranges (``record_function``)
    if (hasattr(ev, "is_user_annotation") and ev.is_user_annotation()) \
            or name.startswith("bench."):
        return None
    if name.startswith("Memcpy"):
        return "htod" if "HtoD" in name else "dtoh" if "DtoH" in name \
            else "glue"
    if name.startswith("Memset"):
        return "glue"
    return "kernel"


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce_events(events, match, op_of_kernel):
    """Sums over the traced window (seconds).  ``events``: the profiler's
    kineto events; ``match``: :func:`kernel_matcher`; ``op_of_kernel``:
    ``__global__`` name -> op name.  returns a dict: ``n`` analyses,
    ``window_s`` (the analyses' spans), ``busy_s`` (inside them),
    ``copy_s``, ``kernel_s``, ``glue_s``, ``ops`` {name: seconds},
    ``idle`` {stage: seconds}, ``unplaced`` kernel names."""
    analyses, stages, device = [], [], []
    for ev in events:
        dev = str(ev.device_type()).split(".")[-1]
        name = ev.name()
        s = ev.start_ns() * 1e-9
        e = s + ev.duration_ns() * 1e-9
        if dev == "CPU":
            if name == "bench.analysis":
                analyses.append((s, e))
            elif name.startswith("bench.stage:"):
                stages.append((s, e, name[len("bench.stage:"):]))
            continue
        kind = _kind(ev)
        if kind is not None:
            device.append((s, e, kind, name))
    if not analyses:
        raise RuntimeError("the trace holds no analysis")
    spans = _union(analyses)
    out = {"n": len(analyses), "window_s": sum(e - s for s, e in spans),
           "copy_s": 0.0, "kernel_s": 0.0, "glue_s": 0.0, "ops": {},
           "idle": {}, "unplaced": set()}
    inside = []
    for s, e, kind, name in device:
        for w0, w1 in spans:
            a, b = max(s, w0), min(e, w1)
            if b <= a:
                continue
            inside.append((a, b))
            dt = b - a
            if kind in ("htod", "dtoh"):
                out["copy_s"] += dt
                label = f"memcpy_{kind}"
            elif kind == "kernel" and match(name) is not None:
                out["kernel_s"] += dt
                label = op_of_kernel.get(match(name), match(name))
            else:
                out["glue_s"] += dt
                label = "glue"
                if kind == "kernel" and not any(m in name for m in _LIBRARY):
                    out["unplaced"].add(name)
            out["ops"][label] = out["ops"].get(label, 0.0) + dt
    busy = _union(inside)
    out["busy_s"] = sum(e - s for s, e in busy)
    gaps = []
    for w0, w1 in spans:
        t = w0
        for s, e in busy:
            if e <= w0 or s >= w1:
                continue
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if w1 > t:
            gaps.append((t, w1))
    for g0, g1 in gaps:
        # the innermost stage the host was in when the device went idle
        around = [(s, n) for s, e, n in stages if s <= g0 < e]
        stage = max(around)[1] if around else "between stages"
        out["idle"][stage] = out["idle"].get(stage, 0.0) + (g1 - g0)
    out["unplaced"] = sorted(out["unplaced"])
    return out
