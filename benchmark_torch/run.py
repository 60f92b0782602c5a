"""The benchmark of pybader_tpu_torch: seconds per Bader analysis on the card.

    python benchmark_torch/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with an NVIDIA GPU.  The cell is
an entry of ``BENCHMARK.json``'s ``workloads``: it names a configuration
(``configs/<name>.json``, the analysis profile) and a traffic mix
(``traffic/<name>.json``, read by ``densities.py``, the one generator).
Every metric is a reader, ``metrics/<name>.py``; every hand-written op's
bound is a cost file, ``costs/<op>.py``.  See README.md.

A run: the mix's densities made from the seed on the card and copied to
the host (or written as CHGCARs, where the mix reads files), one warm
analysis of each grid shape (set-up), then a closed loop for
``--seconds``: a fresh ``Bader(density, lattice, atoms, file_info,
**profile)`` on host numpy arrays (or ``Bader.from_file``) and its call on
``device='cuda'``, the densities in turn, every upload and download inside
the call, results written as ``*-atoms.dat`` / ``*-volumes.dat`` to a
temporary directory.
After the window the analyses of a density drawn from the seed (the window
runs until it has come) are held to the plain reference (``reference.py``, ``compare.py``).  ``--trace 1``
runs the window under ``torch.profiler`` and reports the per-layer
metrics, then replays each density once, unprofiled, to price every
hand-written launch.

The last line of standard output is the result as JSON; the last lines of
standard error are the compared numbers beside their limits.  No CUDA
device, or fewer than the cell asks for: exit 2, no result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from collections import Counter  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
STAGE_PREFIX = "bench.stage:"


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def cell_spec(bench: dict, workload: str):
    """The cell's entry, configuration, traffic and metric entries."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; cells: "
                         f"{sorted(cells)}")
    cell = cells[workload]
    config = read_json(HERE, "configs", cell["config"] + ".json")
    traffic = read_json(HERE, "traffic", cell["traffic"] + ".json")

    def ours(metrics):
        return [m for m in metrics
                if workload in m.get("workloads", [workload])]
    return cell, config, traffic, ours(bench["end_to_end"]), \
        ours(bench["per_layer"])


def load_costs():
    """Every cost file: op name -> module (``WRAPPER``, ``KERNELS``,
    ``cost``)."""
    out = {}
    for fn in sorted(os.listdir(os.path.join(HERE, "costs"))):
        if fn.endswith(".py"):
            op = fn[:-3]
            out[op] = load_module(os.path.join(HERE, "costs", fn),
                                  f"bench_cost_{op}")
    return out


def resolve(target: str):
    """'package.module:function' -> (module, attribute name)."""
    mod_name, attr = target.split(":")
    return importlib.import_module(mod_name), attr


@contextlib.contextmanager
def patched(obj, attr, value):
    old = getattr(obj, attr)
    setattr(obj, attr, value)
    try:
        yield
    finally:
        setattr(obj, attr, old)


class Analyst:
    """Runs analyses of the mix's densities the way a user's loop does."""

    def __init__(self, inputs, config, traffic, device, out_dir):
        from pybader_tpu_torch import interface
        from pybader_tpu_torch.ops import _cuda

        self.interface, self.cuda = interface, _cuda
        self.inputs = inputs
        self.lattice = config["lattice"]
        self.kwargs = dict(config["profile"])
        self.kwargs["refine_mode"] = tuple(self.kwargs["refine_mode"])
        self.kwargs.update(traffic.get("call", {}))
        self.kwargs.update(output=config["output"],
                           prefix=out_dir + os.sep, device=device)
        self.out_dir = out_dir

    def __call__(self, index):
        """One analysis of input ``index``; returns the Bader object."""
        rec = self.inputs[index]
        if rec["path"] is not None:
            b = self.interface.Bader.from_file(rec["path"], file_type="VASP",
                                               **self.kwargs)
        else:
            file_info = {"filename": "CHGCAR", "prefix": "",
                         "file_type": "VASP", "voxel_offset": [0.0, 0.0, 0.0]}
            b = self.interface.Bader(dict(rec["density"]), self.lattice,
                                     rec["atoms"], file_info, **self.kwargs)
        b()
        return b

    def results(self, b) -> dict:
        """What one analysis produced, as ``reference.analyse`` names it,
        with the results text as written."""
        keys = ("bader_volumes", "bader_atoms", "bader_distance",
                "atoms_volumes", "bader_charge", "bader_volume",
                "atoms_charge", "atoms_volume", "atoms_surface_distance",
                "vacuum_charge", "vacuum_volume", "bader_spin", "atoms_spin")
        r = {k: getattr(b, k) for k in keys if hasattr(b, k)}
        r["bader_maxima"] = b.bader_maxima_fractional
        base = os.path.join(self.out_dir, "CHGCAR")
        with open(base + "-atoms.dat") as f:
            r["text_atoms"] = f.read()
        if not b.speed_flag:
            with open(base + "-volumes.dat") as f:
                r["text_volumes"] = f.read()
        return r


def traced_stage(original):
    """``interface._stage`` with a profiler range around each stage."""
    from torch.profiler import record_function

    @contextlib.contextmanager
    def stage(name, *args, **kwargs):
        with record_function(STAGE_PREFIX + name):
            with original(name, *args, **kwargs) as tick:
                yield tick
    return stage


def price(analyst, indices, costs):
    """One unprofiled analysis of each density in ``indices`` with every
    hand-written launch priced by its cost file, before it runs, on its
    own inputs.  returns ({index: summed bound seconds}, {index: launches
    Counter}).  A launch with no cost file raises, naming its op."""
    from peaks import bound_s

    sums, calls = Counter(), Counter()
    stack = contextlib.ExitStack()
    for op, mod in costs.items():
        module, attr = resolve(mod.WRAPPER)
        original = getattr(module, attr)

        def wrapped(*a, _op=op, _mod=mod, _orig=original, **k):
            sums[_op] += bound_s(_mod.cost(*a, **k))
            calls[_op] += 1
            return _orig(*a, **k)
        stack.enter_context(patched(module, attr, wrapped))
    bounds, launched = {}, {}
    with stack:
        for i in indices:
            sums.clear()
            calls.clear()
            before = Counter(analyst.cuda.launches)
            analyst(i)
            launched[i] = Counter(analyst.cuda.launches) - before
            missing = sorted(set(launched[i]) - set(costs))
            if missing:
                raise RuntimeError(
                    "no cost file for hand-written op(s) " + ", ".join(missing)
                    + ": add benchmark_torch/costs/<op>.py")
            if calls != launched[i]:
                raise RuntimeError(f"the cost files priced {dict(calls)} but "
                                   f"the program launched {dict(launched[i])}")
            bounds[i] = sum(sums.values())
    return bounds, launched


def checked_density(seed: int, count: int) -> int:
    """The density of a run's mix that ``correct`` checks."""
    import numpy as np
    return int(np.random.default_rng([seed % 2 ** 64, 1]).integers(count))


def warm_indices(inputs) -> list:
    """The first input of each grid shape: set-up analyses these once."""
    first = {}
    for i, rec in enumerate(inputs):
        first.setdefault(rec["shape"], i)
    return sorted(first.values())


def reference_input(rec, lattice):
    """What the reference analyses for input ``rec``: the host grids, or a
    plain read of its file."""
    import densities
    if rec["path"] is None:
        return rec["density"], lattice, rec["atoms"]
    return densities.read_chgcar(rec["path"])


def run_cell(config, traffic, seed, seconds, trace, e2e, per_layer,
             device="cuda", t_start=None):
    """One run of a cell; returns (result dict, compared numbers, limits,
    notes for standard error)."""
    import numpy as np
    import torch

    import compare
    import densities
    import reference

    t_start = T_START if t_start is None else t_start
    notes = []
    from pybader_tpu_torch.ops import _cuda
    if device == "cuda":
        _cuda.library()  # builds the kernels in the checkout's first run
        if _cuda.build_seconds is not None:
            notes.append(f"build_s {_cuda.build_seconds}")
    out_dir = tempfile.mkdtemp(prefix="bench-")
    sink = open(os.devnull, "w")
    try:
        t_made = time.perf_counter()
        inputs = densities.make_inputs(
            traffic, np.asarray(config["lattice"]), seed, device,
            file_dir=os.path.join(out_dir, "in"))
        notes.append(f"densities_s {time.perf_counter() - t_made}")
        if device == "cuda":
            torch.cuda.empty_cache()
        if traffic.get("call", {}).get("vacuum_tol") is not None:
            tol = traffic["call"]["vacuum_tol"]
            share = [float((rec["density"]["charge"] <= tol).mean())
                     for rec in inputs if rec["density"] is not None]
            notes.append(f"vacuum_share {share}")
        analyst = Analyst(inputs, config, traffic, device, out_dir)
        with contextlib.redirect_stdout(sink):
            for i in warm_indices(inputs):
                analyst(i)
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.perf_counter() - t_start
        # the density whose analyses are held to the reference, drawn from
        # the seed; the window runs until it has been analysed
        checked = checked_density(seed, len(inputs))
        prof, kept, times, launches, stages, order = None, [], [], [], [], []
        if trace:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if device == "cuda":
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
        stage_patch = patched(analyst.interface, "_stage",
                              traced_stage(analyst.interface._stage)) \
            if trace else contextlib.nullcontext()
        with contextlib.redirect_stdout(sink), stage_patch, \
                (prof if prof is not None else contextlib.nullcontext()):
            from torch.profiler import record_function
            w0 = time.perf_counter()
            while time.perf_counter() - w0 < seconds or checked not in order:
                i = len(order) % len(inputs)
                before = Counter(_cuda.launches)
                t0 = time.perf_counter()
                with record_function("bench.analysis") if trace else \
                        contextlib.nullcontext():
                    b = analyst(i)
                times.append(time.perf_counter() - t0)
                order.append(i)
                launches.append(Counter(_cuda.launches) - before)
                stages.append(dict(b.stage_seconds))
                if i == checked:
                    kept.append(analyst.results(b))
                del b
            window_s = time.perf_counter() - w0
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        notes.append(f"analyses {len(times)} times_s {times}")
        ctx = {"n": len(times), "window_s": window_s, "setup_s": setup_s,
               "peak_bytes": peak, "stages": stages}
        dev_info = {"platform": "gpu" if device == "cuda" else device,
                    "kind": torch.cuda.get_device_name(0)
                    if device == "cuda" else device,
                    "count": 1, "memory_peak_bytes": int(peak)}
        breakdown = None
        if trace:
            import devtrace
            costs = load_costs()
            op_of = {k: op for op, mod in costs.items() for k in mod.KERNELS}
            names = devtrace.csrc_globals(
                os.path.dirname(os.path.abspath(_cuda.CSRC)))
            red = devtrace.reduce_events(
                prof.profiler.kineto_results.events(),
                devtrace.kernel_matcher(names), op_of)
            del prof
            if red["unplaced"]:
                notes.append(f"unplaced kernels {red['unplaced']}")
            seen = sorted(set(order))
            with contextlib.redirect_stdout(sink):
                bounds, priced = price(analyst, seen, costs)
            for i, got in zip(order, launches):
                if got != priced[i]:
                    raise RuntimeError(
                        f"density {i}: the profiled analysis launched "
                        f"{dict(got)}, the priced one {dict(priced[i])}")
            ctx["trace"] = red
            ctx["bound_s"] = sum(bounds[i] for i in order)
            dev_info["busy_s"] = red["busy_s"]
            dev_info["window_s"] = red["window_s"]
            n = red["n"]
            breakdown = {
                "device_ops": sorted(([k, v / n] for k, v in red["ops"].items()),
                                     key=lambda kv: -kv[1])[:10],
                "idle_gaps": sorted(([k, v / n] for k, v in red["idle"].items()),
                                    key=lambda kv: -kv[1])[:10]}
        metrics = {}
        for m in (per_layer if trace else e2e):
            reader = load_module(os.path.join(HERE, "metrics", m["name"] + ".py"),
                                 "bench_metric_" + m["name"].replace(".", "_"))
            value = reader.read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        # the program's state goes before the reference runs
        del analyst
        if device == "cuda":
            torch.cuda.empty_cache()
        profile_keys = dict(config["profile"])
        profile_keys.update(traffic.get("call", {}))
        t_ref = time.perf_counter()
        fields, lattice, atoms = reference_input(inputs[checked],
                                                 config["lattice"])
        want = reference.analyse(fields, lattice, atoms, profile_keys,
                                 device=device)
        readings = [compare.numbers(got, want) for got in kept]
        notes.append(f"reference_s {time.perf_counter() - t_ref}")
        values = compare.worst(readings)
        lim = compare.limits()
        failed = sum(not compare.within(r, lim) for r in readings)
        result = {"correct": compare.within(values, lim) and bool(readings),
                  "attempted": len(times), "failed": failed,
                  "metrics": metrics, "device": dev_info}
        if breakdown is not None:
            result["breakdown"] = breakdown
        notes.append(f"checked density {checked}: {len(readings)} analyses")
        return result, values, lim, notes
    finally:
        sink.close()
        shutil.rmtree(out_dir, ignore_errors=True)


def json_number(v):
    return v if v == v and abs(v) != float("inf") else str(v)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench = read_json(ROOT, "BENCHMARK.json")
    cell, config, traffic, e2e, per_layer = cell_spec(bench, args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"run.py: the cell needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    for path in (ROOT, HERE):
        if path not in sys.path:
            sys.path.insert(0, path)
    result, values, lim, notes = run_cell(
        config, traffic, args.seed, args.seconds, args.trace, e2e, per_layer)
    result["checks"] = {k: {"value": json_number(v),
                            "limit": lim.get(k)} for k, v in values.items()}
    for line in notes:
        print(line, file=sys.stderr)
    for k, v in values.items():
        print(f"check {k} {v} limit {lim.get(k)}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
