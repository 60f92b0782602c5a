"""The port's spans and counters (``pybader_tpu_torch.trace``): nesting,
counters, no-ops outside an analysis, the profiler ranges, and a
``Bader(..., device='cpu')`` call on the committed CHGCAR fixture whose
spans agree with ``stage_seconds`` and with the refinement's own stats."""
import contextlib
import io
import os
import pickle
from collections import Counter, defaultdict

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pybader_tpu_torch import pipeline, trace
from pybader_tpu_torch.interface import SPEED_CONFIG, Bader
from pybader_tpu_torch.io import vasp

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "fixtures", "CHGCAR_fixture")
COUNTERS = ("edges", "changed", "cap_fires", "risky")


def test_spans_nest_with_parent_ids():
    spans = []
    with trace.recording(spans):
        with trace.span("a"):
            with trace.span("b"):
                with trace.span("c"):
                    pass
            with trace.span("d"):
                pass
        with trace.span("e"):
            pass
    assert [s.name for s in spans] == ["a", "b", "c", "d", "e"]
    assert [s.id for s in spans] == [0, 1, 2, 3, 4]
    assert [s.parent for s in spans] == [None, 0, 1, 0, None]
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns


def test_counters_attach_to_the_innermost_span():
    spans = []
    with trace.recording(spans):
        with trace.span("outer", bytes=5) as outer:
            trace.count("edges", 2)
            with trace.span("inner"):
                trace.count("edges", 3)
                trace.count("edges", 4)
                trace.count("changed", 1)
            trace.count("edges", 10)
    assert outer is spans[0]
    assert spans[0].counters == {"bytes": 5, "edges": 12}
    assert spans[1].counters == {"edges": 7, "changed": 1}


def test_span_and_count_are_no_ops_outside_an_analysis(monkeypatch):
    monkeypatch.setattr(trace, "profiled", defaultdict(Counter))
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("loose", bytes=1) as s:
            trace.count("edges", 1)
    assert s is None
    assert trace._active is None
    assert not trace.profiled
    # a recording restores the state it found
    spans = []
    with trace.recording(spans), trace.span("a"):
        pass
    assert trace._active is None and len(spans) == 1


def test_profiler_ranges_only_under_a_profiler(monkeypatch):
    monkeypatch.setattr(trace, "profiled", defaultdict(Counter))
    spans = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.recording(spans):
            with trace.span("analysis"):
                with trace.span("upload.x", bytes=8):
                    pass
    names = [e.name for e in prof.events()]
    assert "pb.analysis" in names and "pb.upload.x" in names
    assert trace.profiled["upload.x"]["bytes"] == 8
    assert trace.profiled["analysis"]["count"] == 1

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) without a profiler")
    monkeypatch.setattr(trace, "record_function", refuse)
    monkeypatch.setattr(trace, "profiled", defaultdict(Counter))
    with trace.recording([]), trace.span("analysis"), trace.span("host.x"):
        pass
    assert not trace.profiled


@pytest.mark.parametrize("dtype", [torch.int8, torch.int32, torch.float64])
def test_moved_counts_the_bus_in_the_copied_dtype(dtype):
    t = torch.zeros((3, 4, 5), dtype=dtype)
    size = 60 * t.element_size()
    assert trace.moved(t, "cuda") == size
    assert trace.moved(t, torch.device("cuda", 0)) == size
    assert trace.moved(t, "cpu") == 0
    assert trace.moved(t, torch.device("cpu")) == 0
    # Bader._dev casts on the host and counts the tensor it copies: an
    # upload to int32 moves int32 bytes whatever the host array's dtype
    # ('meta' stands in for a card: its copies count, and move no data)
    b = Bader.__new__(Bader)
    b.device = "meta"
    spans = []
    with trace.recording(spans):
        up = b._dev(t.numpy(), torch.int32, "x")
        again = b._dev(up, torch.float64, "y")
    assert up.dtype == torch.int32 and up.device.type == "meta"
    assert again.dtype == torch.float64
    assert [(s.name, s.counters) for s in spans] == [
        ("upload.x", {"bytes": 60 * 4, "pinned": 0}),
        ("upload.y", {"bytes": 0, "pinned": 0})]


def test_a_span_entered_directly_times_outside_a_recording():
    with trace.Span("stage.x") as s:
        pass
    assert s.id is None and s.parent is None and s.counters == {}
    assert s.seconds >= 0
    spans = []
    with trace.recording(spans), trace.span("analysis"):
        with trace.Span("stage.y") as inner:
            pass
    assert spans == [spans[0], inner] and inner.parent == 0
    assert trace._active is None


def _quiet_call(b):
    with contextlib.redirect_stdout(io.StringIO()):
        b()
    return b


@pytest.fixture(scope="module", params=["full", "hybrid"])
def traced(request, tmp_path_factory):
    """A default-profile call on the fixture (full trajectories, or the
    hybrid forced), and the refinement stats of the same steps run
    directly."""
    mp = pytest.MonkeyPatch()
    mp.setenv("PYBADER_TPU_FULL_TRAJECTORIES",
              "1" if request.param == "full" else "0")
    try:
        out = tmp_path_factory.mktemp("dat")
        with contextlib.redirect_stdout(io.StringIO()):
            density, lattice, atoms, info = vasp.read(FIXTURE)
        b = _quiet_call(Bader(density, lattice, atoms, info, device="cpu",
                              output="dat", prefix=str(out) + os.sep))
        rho = torch.as_tensor(density["charge"])
        weights = tuple(b.distance_weights)
        carry, stats, refine = {}, {}, {}
        labels, _ = pipeline.partition_neargrid(
            rho, None, weights, b.T_grad, carry_out=carry, stats=stats)
        pipeline.refine_labels(
            "neargrid", ("changed", 2), rho, labels, weights, b.T_grad,
            verbose=False, carry_in=carry or None, stats=refine)
        iterations = stats.get("iterations", []) + \
            refine.get("iterations", [])
    finally:
        mp.undo()
    return b, iterations


def test_stage_spans_match_stage_seconds(traced):
    b, _ = traced
    stages = {s.name[len("stage."):]: s.seconds for s in b.spans
              if s.name.startswith("stage.")}
    # stage_seconds is read from the stage spans: one clock
    assert stages == b.stage_seconds
    assert list(stages) == list(b.stage_seconds)


def test_iteration_counters_match_refine_stats(traced):
    b, iterations = traced
    got = [tuple(s.counters[k] for k in COUNTERS) for s in b.spans
           if s.name == "refine.iteration"]
    assert got == [tuple(it[:4]) for it in iterations]
    assert len(got) >= 1


def test_copies_read_zero_bytes_on_the_cpu(traced):
    b, _ = traced
    copies = [s for s in b.spans
              if s.name.startswith(("upload.", "download."))]
    names = {s.name for s in copies}
    # the density crosses once; the refined labels and the reference (the
    # density's array) stay on the device
    assert {"upload.density", "download.bader_volumes",
            "download.atoms_volumes"} <= names
    assert not {"upload.reference", "download.refined"} & names
    # and none goes through the pinned ring (hostcopy), which takes only
    # copies between the host and a CUDA device, nor lands in a buffer of
    # its pool (a download's ``warm``)
    assert all(s.counters == {"bytes": 0, "pinned": 0}
               | ({"warm": 0} if s.name.startswith("download.") else {})
               for s in copies
               if s.name.split(".", 1)[1] not in ("first_member", "rank",
                                                  "max_pos"))
    assert all(s.counters.get("bytes") == 0 for s in copies)


def test_call_spans_are_few_closed_and_rooted(traced):
    b, _ = traced
    spans = b.spans
    assert len(spans) <= 100
    assert [s.name for s in spans[:2]] == ["init", "analysis"]
    assert [s.id for s in spans] == list(range(len(spans)))
    assert [s.name for s in spans if s.parent is None] == ["init",
                                                           "analysis"]
    for s in spans:
        assert s.end_ns is not None
        if s.parent is not None:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    # host_ms sums the host spans: none may sit inside another
    for s in spans:
        if s.name.startswith("host."):
            p = s.parent
            while p is not None:
                assert not spans[p].name.startswith("host."), s.name
                p = spans[p].parent
    kinds = Counter(s.name.split(".")[0] for s in spans)
    # the host's work in a call is the .dat files': two texts, two writes
    assert kinds["host"] == 4 and kinds["stage"] == 6


def test_second_call_keeps_init_and_replaces_the_rest(tmp_path):
    with contextlib.redirect_stdout(io.StringIO()):
        b = Bader(*vasp.read(FIXTURE), device="cpu", output="dat",
                  prefix=str(tmp_path) + os.sep)
    init = b.spans[0]
    first = [s.name for s in _quiet_call(b).spans]
    second = [s.name for s in _quiet_call(b).spans]
    assert b.spans[0] is init
    assert second == first
    assert [s.id for s in b.spans] == list(range(len(b.spans)))


def _block_bytes(fn):
    """The bytes of the fixture's density block: from the line after the
    grid line to the end of the file."""
    with open(fn, "rb") as f:
        lines = f.readlines()
    grid = next(i for i, line in enumerate(lines)
                if line.split() == [b"24", b"28", b"32"])
    return sum(len(line) for line in lines[grid + 1:])


def test_from_file_spans_lead_with_the_read(tmp_path):
    with contextlib.redirect_stdout(io.StringIO()):
        b = Bader.from_file(FIXTURE, device="cpu", output="dat",
                            prefix=str(tmp_path) + os.sep)
    assert [s.name for s in b.spans] == ["read.charge", "init"]
    read = b.spans[0]
    # the native path parsed the whole block
    size = _block_bytes(FIXTURE)
    assert read.counters["bytes"] == read.counters["direct"] == size
    assert [s.parent for s in b.spans] == [None, None]
    assert read.end_ns <= b.spans[1].start_ns
    for _ in range(2):
        names = [s.name for s in _quiet_call(b).spans]
        assert names[:3] == ["read.charge", "init", "analysis"]
        assert b.spans[0] is read
        assert [s.id for s in b.spans] == list(range(len(b.spans)))


def test_profiled_from_file_sums_its_read_once(monkeypatch, tmp_path):
    monkeypatch.setattr(trace, "profiled", defaultdict(Counter))
    kwargs = dict(device="cpu", output="dat", prefix=str(tmp_path) + os.sep)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with contextlib.redirect_stdout(io.StringIO()):
            b = Bader.from_file(FIXTURE, **kwargs)
        _quiet_call(b)
    assert "pb.read.charge" in {e.name for e in prof.events()}
    got = trace.profiled
    size = _block_bytes(FIXTURE)
    assert got["read.charge"]["count"] == got["init"]["count"] == 1
    assert got["read.charge"]["bytes"] == got["read.charge"]["direct"] == size
    assert np.isclose(got["read.charge"]["ns"] * 1e-9, b.spans[0].seconds)


def test_spans_are_not_pickled(traced):
    b, _ = traced
    assert "spans" not in b.__getstate__()
    assert hasattr(b, "spans")


def test_profiled_call_sums_its_spans(monkeypatch, tmp_path):
    monkeypatch.setattr(trace, "profiled", defaultdict(Counter))
    monkeypatch.setenv("PYBADER_TPU_FULL_TRAJECTORIES", "0")
    with contextlib.redirect_stdout(io.StringIO()):
        density, lattice, atoms, info = vasp.read(FIXTURE)
    kwargs = dict(device="cpu", output="dat", prefix=str(tmp_path) + os.sep)
    # outside the profiler: nothing summed
    _quiet_call(Bader(density, lattice, atoms, info, **kwargs))
    assert not trace.profiled
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        b = Bader(density, lattice, atoms, info, **kwargs)
        _quiet_call(b)
    names = {e.name for e in prof.events()}
    assert {"pb.init", "pb.analysis", "pb.refine.iteration",
            "pb.stage.Refining volume edges"} <= names
    got = trace.profiled
    assert got["analysis"]["count"] == 1 and got["init"]["count"] == 1
    edges = sum(s.counters["edges"] for s in b.spans
                if s.name == "refine.iteration")
    assert got["refine.iteration"]["edges"] == edges > 0
    assert got["host.results"]["count"] == 2
    assert np.isclose(got["analysis"]["ns"] * 1e-9, b.spans[1].seconds)


# (profile, the reference another array than the density, vacuum_tol)
RESIDENT_CASES = [("default", False, None), ("default", True, None),
                  ("speed", False, None), ("speed", True, None),
                  ("default", False, 0.2), ("speed", True, 0.2)]


@pytest.fixture(scope="module", params=RESIDENT_CASES,
                ids=["-".join(map(str, c)) for c in RESIDENT_CASES])
def resident(request, tmp_path_factory):
    """A call on the fixture whose copies count their tensors' bytes as if
    they crossed to a card (on the CPU they cross nothing), and the
    grid's voxel count."""
    profile, other, vac = request.param
    mp = pytest.MonkeyPatch()
    mp.setattr(trace, "moved", lambda t, device: t.numel() * t.element_size())
    try:
        out = tmp_path_factory.mktemp("resident")
        kwargs = dict(SPEED_CONFIG if profile == "speed" else {},
                      device="cpu", output="dat", prefix=str(out) + os.sep,
                      vacuum_tol=vac)
        with contextlib.redirect_stdout(io.StringIO()):
            b = Bader(*vasp.read(FIXTURE), **kwargs)
        if other:
            b.reference = b.density.copy()
        _quiet_call(b)
    finally:
        mp.undo()
    return b, request.param, b.density.size


def test_a_call_uploads_each_input_grid_once(resident):
    b, (_, other, _), n = resident
    grids = [s for s in b.spans
             if s.name.startswith("upload.") and s.counters["bytes"] >= n]
    # no label grid goes up: every full-grid upload is an f64 input
    assert all(s.counters["bytes"] == 8 * n for s in grids)
    want = ["upload.density"] + (["upload.reference"] if other else [])
    assert sorted(s.name for s in grids) == sorted(want)


def test_each_result_grid_downloads_once_when_final(resident):
    b, (profile, _, _), n = resident
    grids = Counter(s.name for s in b.spans
                    if s.name.startswith("download.")
                    and s.counters["bytes"] >= n)
    want = ["atoms_volumes"] if profile == "speed" \
        else ["bader_volumes", "atoms_volumes"]
    assert grids == Counter("download." + w for w in want)
    # each crosses in its dtype_calc dtype, cast on the device (int8 here)
    for s in b.spans:
        if s.name in grids:
            grid = getattr(b, s.name[len("download."):])
            assert grid.dtype == np.int8
            assert s.counters["bytes"] == grid.nbytes == n


def test_no_host_cast_scan_or_copy_in_a_call(resident):
    b, (profile, _, vac), _ = resident
    names = Counter(s.name for s in b.spans)
    assert not {"host.astype", "host.copyto", "host.vacuum_scan",
                "host.vacuum_where", "download.vacuum_mask",
                "download.refined", "upload.vacuum"} & set(names)
    texts = 1 if profile == "speed" else 2
    assert {k: v for k, v in names.items() if k.startswith("host.")} == \
        {"host.results": texts, "host.write": texts}
    if vac is not None:
        assert b.vacuum_volume > 0 and (b.atoms_volumes == -1).any()


def test_resident_spans_count_the_tensor_not_moved(resident):
    b, (profile, other, vac), n = resident
    held = [s for s in b.spans if s.name.startswith("resident.")]
    size = {"resident.density": 8 * n, "resident.reference": 8 * n,
            "resident.bader_volumes": 4 * n, "resident.atoms_volumes": 4 * n}
    want = {"resident.bader_volumes", "resident.atoms_volumes"}
    if other:
        want.add("resident.reference")
    # the density, where it is no reference, serves the sums alone: the
    # speed profile's one sum takes it at its upload
    if not (other and profile == "speed" and vac is None):
        want.add("resident.density")
    assert {s.name for s in held} == want
    for s in held:
        assert s.counters == {"bytes": size[s.name]}, s.name
    # default: the refinement, the basin sums and the relabel take the
    # partition's labels, the surface and the atom sums the relabel's;
    # speed: the relabel, then the refinement, surface and sums
    labels = Counter(s.name for s in held if s.name.endswith("_volumes"))
    assert labels == ({"resident.bader_volumes": 1,
                       "resident.atoms_volumes": 3} if profile == "speed"
                      else {"resident.bader_volumes": 3,
                            "resident.atoms_volumes": 2})
    if vac is not None and not other:
        # the partition takes the density that the vacuum stage uploaded
        first = next(s for s in b.spans if s.name.startswith("stage."))
        assert any(s.name == "resident.density" and s.id < first.id
                   for s in held)


@pytest.mark.parametrize("device, waits", [("cuda", 1), ("cuda:0", 1),
                                           ("cpu", 0), (None, 0)])
def test_a_stage_on_cuda_ends_by_waiting_for_the_device(monkeypatch, device,
                                                        waits):
    from pybader_tpu_torch import interface

    seen = []
    monkeypatch.setattr(torch.cuda, "synchronize", seen.append)
    with contextlib.redirect_stdout(io.StringIO()):
        with interface._stage("x", device=device):
            assert seen == []
    assert seen == [device] * waits


class NoTorchUnpickler(pickle.Unpickler):
    """Refuses every torch class, so a pickled tensor cannot load."""

    def find_class(self, module, name):
        if module == "torch" or module.startswith("torch."):
            raise AssertionError(f"pickle holds {module}.{name}")
        return super().find_class(module, name)


def test_a_call_pickles_no_tensor_and_no_per_call_state(tmp_path):
    with contextlib.redirect_stdout(io.StringIO()):
        b = Bader(*vasp.read(FIXTURE), device="cpu", output="pickle",
                  prefix=str(tmp_path) + os.sep)
    _quiet_call(b)
    assert "_resident" not in b.__dict__ and b._resident is None
    with open(tmp_path / "bader.p", "rb") as f:
        back = NoTorchUnpickler(f).load()
    assert "_resident" not in back.__dict__
    for key in ("bader_volumes", "atoms_volumes"):
        assert type(getattr(back, key)) is np.ndarray
        np.testing.assert_array_equal(getattr(back, key), getattr(b, key))
    # state held in the middle of a call is never pickled
    b._resident = {"density": torch.zeros(3, dtype=torch.float64)}
    assert "_resident" not in b.__getstate__()
    back = NoTorchUnpickler(io.BytesIO(pickle.dumps(b))).load()
    assert "_resident" not in back.__dict__


def test_a_failed_call_drops_its_grids(tmp_path):
    with contextlib.redirect_stdout(io.StringIO()):
        b = Bader(*vasp.read(FIXTURE), device="cpu", output="dat",
                  prefix=str(tmp_path) + os.sep)
    seen = {}

    def fail():
        seen.update(b._resident)
        raise RuntimeError("stop")
    b.min_surface_distance = fail
    with pytest.raises(RuntimeError, match="stop"), \
            contextlib.redirect_stdout(io.StringIO()):
        b()
    assert {"density", "atoms_volumes"} <= set(seen)
    assert "bader_volumes" not in seen  # freed at the relabel
    assert "_resident" not in b.__dict__


@pytest.mark.parametrize("profile", ["default", "speed"])
def test_sums_spans_count_their_labels(tmp_path, profile):
    """A spin call sums the density and the spin once a sums stage, each in
    its own ``sums.<what>`` span counting the labels it sums over; the
    spin's upload stays outside its span."""
    with contextlib.redirect_stdout(io.StringIO()):
        density, lattice, atoms, info = vasp.read(FIXTURE)
    density["spin"] = density["charge"] - density["charge"].mean()
    kwargs = dict(SPEED_CONFIG if profile == "speed" else {},
                  spin_flag=True, device="cpu", output="dat",
                  prefix=str(tmp_path) + os.sep)
    b = _quiet_call(Bader(density, lattice, atoms, info, **kwargs))
    spans = b.spans
    sums = [s for s in spans if s.name.startswith("sums.")]
    stages = [spans[s.parent].name for s in sums]
    n_atoms, n_max = len(b.atoms), len(b.bader_maxima)
    want = [("sums.density", n_atoms), ("sums.spin", n_atoms)]
    if profile == "default":
        want = [("sums.density", n_max), ("sums.spin", n_max)] + want
    assert [(s.name, s.counters["labels"]) for s in sums] == want
    assert all(name.startswith("stage.Integrating") for name in stages)
    upload = next(s for s in spans if s.name == "upload.spin")
    assert spans[upload.parent].name.startswith("stage.Integrating")
    assert b.atoms_spin.shape == (n_atoms,)


@pytest.mark.parametrize("vac", [None, 0.2, 1e-12])
def test_vacuum_mask_span_counts_the_vacuum(tmp_path, vac):
    with contextlib.redirect_stdout(io.StringIO()):
        density, lattice, atoms, info = vasp.read(FIXTURE)
    b = _quiet_call(Bader(density, lattice, atoms, info, vacuum_tol=vac,
                          device="cpu", output="dat",
                          prefix=str(tmp_path) + os.sep))
    masks = [s for s in b.spans if s.name == "vacuum.mask"]
    if vac is None:
        assert masks == []
        return
    assert len(masks) == 1
    voxels = int((density["charge"] <= vac).sum())
    assert masks[0].counters == {"voxels": voxels}
    assert (voxels > 0) == (vac == 0.2)
    assert b.spans[masks[0].parent].name == "analysis"
    assert np.isclose(b.vacuum_volume, voxels * b.voxel_volume)


@pytest.mark.parametrize("profile", ["default", "speed"])
def test_per_atom_spans_count_maxima_and_atoms(tmp_path, profile):
    """A call assigns the maxima to atoms once, in an ``atoms.assign`` span
    that counts both, and measures the surface once, in a
    ``surface.distance`` span that counts the atoms; each nests in its
    stage and holds its result's download, not the inputs' uploads."""
    with contextlib.redirect_stdout(io.StringIO()):
        density, lattice, atoms, info = vasp.read(FIXTURE)
    kwargs = dict(SPEED_CONFIG if profile == "speed" else {},
                  device="cpu", output="dat", prefix=str(tmp_path) + os.sep)
    b = _quiet_call(Bader(density, lattice, atoms, info, **kwargs))
    spans = b.spans
    n_atoms, n_max = len(b.atoms), len(b.bader_maxima)
    assign = [s for s in spans if s.name == "atoms.assign"]
    surface = [s for s in spans if s.name == "surface.distance"]
    assert [s.counters for s in assign] == [{"maxima": n_max,
                                             "atoms": n_atoms}]
    assert [s.counters for s in surface] == [{"atoms": n_atoms}]
    assert spans[assign[0].parent].name == "stage.Assigning maxima to atoms"
    assert spans[surface[0].parent].name == \
        "stage.Calculating min. surface distance"
    inner = {s.name for s in spans if s.parent in (assign[0].id,
                                                   surface[0].id)}
    assert inner == {"download.bader_atoms", "download.bader_distance",
                     "download.surface_distance"}
    assert b.bader_atoms.shape == (n_max,)
    assert b.atoms_surface_distance.shape == (n_atoms,)
