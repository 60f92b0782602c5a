"""The pinned staging ring (``pybader_tpu_torch.hostcopy``): the chunk
loops on plain host slots (bit-identical round trips, ragged last chunks,
Fortran-order sources, host-side casts, one ring shared by threads), the
choice of the ring from the tensor alone, the pool of download buffers
(a released buffer reused, never one that a view still holds, by size, at
most ``POOL_BUFFERS`` kept, shared by threads), a ``Bader`` call on the
CPU whose large copies are routed through a host ring (same results,
spans and ``bytes``; ``pinned`` on the grids alone; a second call's label
grids ``warm``), and, marked ``cuda``, the ring and the pool on the card
against PyTorch's plain copies.  This file imports no JAX: run
its card tests with ``python -m pytest --noconftest -m cuda
tests/test_torch_hostcopy.py`` on a machine with an NVIDIA GPU."""
import contextlib
import io
import os
import sys
import threading
from math import prod

import numpy as np
import pytest
import torch

from pybader_tpu_torch import hostcopy, trace
from pybader_tpu_torch.interface import SPEED_CONFIG, Bader
from pybader_tpu_torch.io import vasp

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "fixtures", "CHGCAR_fixture")
GRIDS = ("density", "bader_volumes", "atoms_volumes")


def host_ring(slot_bytes, slots=2):
    return hostcopy.Ring(hostcopy.Slot(torch.empty(slot_bytes,
                                                   dtype=torch.uint8))
                         for _ in range(slots))


def own(a, ring):
    """Whether ``a`` is writable, C-contiguous and in memory of its own,
    none of it a slot of ``ring``."""
    return a.flags.writeable and a.flags.c_contiguous and not any(
        np.shares_memory(a, slot.buf.numpy()) for slot in ring.slots)


def bits(a):
    """The array's bytes, so that -0.0, NaN and inf compare too."""
    return np.ascontiguousarray(a).view(np.uint8)


def source(shape, dtype, order="C", seed=0):
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind == "f":
        a = rng.normal(size=shape).astype(dtype)
        flat = a.reshape(-1)
        flat[:4] = [-0.0, np.nan, np.inf, -np.inf]
    else:
        info = np.iinfo(dtype)
        a = rng.integers(info.min, info.max, size=shape, endpoint=True,
                         dtype=dtype)
    return np.asarray(a, order=order)


# (shape, host dtype, device dtype, order, slot bytes): a 400x400x512-like
# grid whose last chunk is ragged, int8 and int16 label grids, a
# Fortran-order density and host-side casts
CASES = [
    ((50, 50, 64), np.float64, torch.float64, "C", 7 * 50 * 64 * 8),
    ((50, 50, 64), np.int16, torch.int16, "C", 3 * 50 * 64 * 2 + 5),
    ((24, 28, 32), np.int8, torch.int8, "C", 5 * 28 * 32),
    ((24, 28, 32), np.float64, torch.float64, "F", 4 * 28 * 32 * 8),
    ((24, 28, 32), np.float32, torch.float64, "F", 3 * 28 * 32 * 8),
    ((24, 28, 32), np.int32, torch.int8, "C", 28 * 32),
    ((7,), np.float64, torch.float64, "C", 16),
]


@pytest.mark.parametrize("slots", [2, 3])
@pytest.mark.parametrize("shape, host, dtype, order, slot_bytes", CASES)
def test_staged_round_trip_is_bit_identical(shape, host, dtype, order,
                                            slot_bytes, slots):
    a = source(shape, host, order)
    ring = host_ring(slot_bytes, slots)
    t = torch.as_tensor(a)
    up = hostcopy.upload(t, dtype, "cpu", ring)
    want = t.to(dtype)
    assert up.dtype == dtype and up.is_contiguous()
    assert np.array_equal(bits(up.numpy()), bits(want.numpy()))
    down = hostcopy.download(up, ring)
    assert isinstance(down, np.ndarray) and own(down, ring)
    assert down.dtype == want.numpy().dtype and down.shape == shape
    assert np.array_equal(bits(down), bits(want.numpy()))
    # every case crosses in more than one chunk of whole planes
    assert shape[0] > slot_bytes // (prod(shape[1:]) * up.element_size())


def test_a_plane_larger_than_a_slot_is_refused():
    t = torch.zeros((4, 10, 10), dtype=torch.float64)
    with pytest.raises(ValueError, match="does not fit a slot"):
        hostcopy.upload(t, torch.float64, "cpu", host_ring(799))


def test_staged_takes_host_and_cuda_grids_of_one_slot():
    slot = hostcopy.SLOT_BYTES
    # torch.empty touches no page: these cost no memory
    at = torch.empty((slot // 4, 4), dtype=torch.uint8)
    under = torch.empty((slot // 4 - 1, 4), dtype=torch.uint8)
    assert hostcopy.staged(at, "cuda")
    assert hostcopy.staged(at, torch.device("cuda", 0))
    assert not hostcopy.staged(under, "cuda")
    # the size is the cast tensor's: an upload cast to f64 crosses 8x
    assert hostcopy.staged(under, "cuda", torch.float64)
    # only between the host and a CUDA device
    for device in ("cpu", "meta", torch.device("cpu")):
        assert not hostcopy.staged(at, device)
    # a plane larger than a slot, and tensors with no planes
    assert not hostcopy.staged(torch.empty((1, slot + 1), dtype=torch.uint8),
                               "cuda")
    assert not hostcopy.staged(torch.empty(()), "cuda")
    assert not hostcopy.staged(torch.empty((slot, 0)), "cuda")
    assert hostcopy.staged(torch.empty(slot, dtype=torch.uint8), "cuda")


def test_threads_share_one_ring(monkeypatch):
    """More threads than cores, each round-tripping its own grid through
    one ring of two small slots: the ring's lock keeps every chunk whole."""
    ring = host_ring(3 * 28 * 32 * 8)
    grids = [source((24, 28, 32), np.float64, seed=s) for s in range(16)]
    bad, errors = [], []

    def work(a):
        try:
            for _ in range(20):
                up = hostcopy.upload(torch.as_tensor(a), torch.float64,
                                     "cpu", ring)
                if not np.array_equal(bits(hostcopy.download(up, ring)),
                                      bits(a)):
                    bad.append(1)
        except Exception as e:  # noqa: BLE001 (raised in the test thread)
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(a,)) for a in grids]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert not errors and not bad


# ------------------------------------------------------------------ the pool

def pooled(src, ring, pool):
    """``download`` of ``src`` in a span, and the span's ``warm`` bytes."""
    spans = []
    with trace.recording(spans), trace.span("download.grid", warm=0):
        out = hostcopy.download(src, ring, pool)
    return out, spans[0].counters["warm"]


def address(a):
    return a.__array_interface__["data"][0]


# (shape, dtype, slot bytes): an int8 and an int16 label grid, several
# chunks each, the last ragged
POOL_CASES = [((24, 28, 32), np.int8, 5 * 28 * 32),
              ((50, 50, 64), np.int16, 3 * 50 * 64 * 2 + 5)]


@pytest.mark.parametrize("shape, dtype, slot_bytes", POOL_CASES)
def test_a_released_buffer_is_reused(shape, dtype, slot_bytes):
    ring, pool = host_ring(slot_bytes), hostcopy.Pool()
    first, warm = pooled(torch.as_tensor(source(shape, dtype, seed=1)),
                         ring, pool)
    assert warm == 0 and pool.free == []
    where = address(first)
    del first  # by reference count: the buffer is back at once
    assert [address(b) for b in pool.free] == [where]
    want = source(shape, dtype, seed=2)
    second, warm = pooled(torch.as_tensor(want), ring, pool)
    assert warm == want.nbytes and address(second) == where
    assert pool.free == [] and own(second, ring)
    assert second.dtype == want.dtype and second.shape == shape
    assert np.array_equal(second, want)
    # a return while the pool's lock is held, as a finalizer may run in
    # the middle of a take, does not wait on it
    with pool.lock:
        del second
    assert [address(b) for b in pool.free] == [where]


VIEWS = {"slice": lambda a: a[1:3, ::2],
         "transpose": lambda a: a.T,
         "reshape": lambda a: a.reshape(-1),
         "torch": torch.from_numpy}


@pytest.mark.parametrize("view", sorted(VIEWS))
@pytest.mark.parametrize("shape, dtype, slot_bytes", POOL_CASES)
def test_a_live_view_keeps_its_buffer(shape, dtype, slot_bytes, view):
    ring, pool = host_ring(slot_bytes), hostcopy.Pool()
    first, _ = pooled(torch.as_tensor(source(shape, dtype, seed=1)), ring,
                      pool)
    held = VIEWS[view](first)
    want = np.array(held)  # a copy of the view's values
    del first
    assert pool.free == []  # the view holds the loan
    other = source(shape, dtype, seed=2)
    second, warm = pooled(torch.as_tensor(other), ring, pool)
    assert warm == 0 and np.array_equal(second, other)
    assert not np.shares_memory(second, np.asarray(held))
    assert np.array_equal(np.asarray(held), want)
    del held  # the last view: the buffer comes back
    third, warm = pooled(torch.as_tensor(other), ring, pool)
    assert warm == other.nbytes and np.array_equal(third, other)


def test_another_size_misses():
    ring, pool = host_ring(5 * 28 * 32), hostcopy.Pool()
    first, _ = pooled(torch.as_tensor(source((24, 28, 32), np.int8)), ring,
                      pool)
    where = address(first)
    del first
    # the same bytes in another shape would fit; only the size decides
    want = source((25, 28, 32), np.int8)
    second, warm = pooled(torch.as_tensor(want), ring, pool)
    assert warm == 0 and np.array_equal(second, want)
    assert [address(b) for b in pool.free] == [where]
    same, warm = pooled(torch.as_tensor(source((12, 56, 32), np.int8)),
                        ring, pool)
    assert warm == same.nbytes and address(same) == where


@pytest.mark.parametrize("size", [0, 1, hostcopy.POOL_BUFFERS])
def test_the_pool_keeps_at_most_its_size(size):
    ring, pool = host_ring(5 * 28 * 32), hostcopy.Pool(size)
    assert hostcopy.Pool().size == hostcopy.POOL_BUFFERS
    src = torch.as_tensor(source((24, 28, 32), np.int8))
    held = [hostcopy.download(src, ring, pool)
            for _ in range(hostcopy.POOL_BUFFERS + 2)]
    order = [address(a) for a in held]
    assert len(set(order)) == len(order) and pool.free == []
    while held:
        held.pop(0)  # returned in this order
    assert [address(b) for b in pool.free] == order[len(order) - size:]


def test_threads_share_one_pool():
    """More threads than cores, each holding its last two downloads from
    one ring and one pool while the others return theirs: no buffer is
    lent twice, so no held result changes."""
    ring, pool = host_ring(5 * 28 * 32), hostcopy.Pool()
    grids = [source((24, 28, 32), np.int8, seed=s) for s in range(16)]
    bad, errors = [], []

    def work(a):
        try:
            held = []
            for _ in range(30):
                held = held[-1:] + [hostcopy.download(torch.as_tensor(a),
                                                      ring, pool)]
                if not all(np.array_equal(h, a) for h in held):
                    bad.append(1)
        except Exception as e:  # noqa: BLE001 (raised in the test thread)
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(a,)) for a in grids]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert not errors and not bad
    assert len(pool.free) <= hostcopy.POOL_BUFFERS


def _call(out, profile, vac):
    out.mkdir()
    kwargs = dict(SPEED_CONFIG if profile == "speed" else {}, device="cpu",
                  output="dat", prefix=str(out) + os.sep, vacuum_tol=vac)
    with contextlib.redirect_stdout(io.StringIO()):
        b = Bader(*vasp.read(FIXTURE), **kwargs)
        b()
    texts = {}
    for name in sorted(os.listdir(out)):
        with open(os.path.join(out, name)) as f:
            texts[name] = f.read()
    return b, texts


RESULTS = ("bader_volumes", "atoms_volumes", "bader_atoms", "bader_distance",
           "bader_charge", "bader_volume", "atoms_charge", "atoms_volume",
           "atoms_surface_distance", "_bader_maxima")


@pytest.mark.parametrize("profile, vac", [("default", None),
                                          ("speed", None),
                                          ("default", 0.2)])
def test_a_call_through_a_ring_is_the_plain_call(monkeypatch, tmp_path,
                                                 profile, vac):
    """The fixture's call with its large copies routed through a ring of
    host slots (the CPU stands in for the card; the fixture's grids are
    24 planes, so chunks of 1 f64 and 9 int8 planes, the last ragged):
    the same results, text, span names and ``bytes``, and ``pinned`` equal
    to ``bytes`` on the density and the label grids alone."""
    slot = 8192
    monkeypatch.setattr(trace, "moved",
                        lambda t, device: t.numel() * t.element_size())
    plain, plain_texts = _call(tmp_path / "plain", profile, vac)
    ring = host_ring(slot)
    used = []

    def staged(t, device, dtype=None):
        n = t.numel() * (t.element_size() if dtype is None
                         else torch.empty((), dtype=dtype).element_size())
        return t.dim() > 0 and n >= slot

    def take(device):
        used.append(device)
        return ring

    monkeypatch.setattr(hostcopy, "staged", staged)
    monkeypatch.setattr(hostcopy, "ring_for", take)
    b, texts = _call(tmp_path / "ring", profile, vac)
    assert used and texts == plain_texts
    for key in RESULTS:
        if hasattr(plain, key):
            got, want = getattr(b, key), getattr(plain, key)
            assert type(got) is type(want) and np.array_equal(
                bits(np.asarray(got)), bits(np.asarray(want))), key
    for key in ("bader_volumes", "atoms_volumes"):
        if hasattr(b, key):
            assert own(getattr(b, key), ring)
    # the span count and each copy's bytes are the plain call's
    assert [s.name for s in b.spans] == [s.name for s in plain.spans]
    copies = [(s, p) for s, p in zip(b.spans, plain.spans)
              if s.name.startswith(("upload.", "download."))]
    grids = set()
    for s, p in copies:
        assert s.counters["bytes"] == p.counters["bytes"], s.name
        assert p.counters.get("pinned", 0) == 0
        what = s.name.split(".", 1)[1]
        if what in GRIDS:
            grids.add(what)
            assert s.counters["pinned"] == s.counters["bytes"] >= slot
        else:
            assert s.counters.get("pinned", 0) == 0 and \
                s.counters["bytes"] < slot, s.name
    want = {"density", "atoms_volumes"} | (
        set() if profile == "speed" else {"bader_volumes"})
    assert grids == want


@pytest.mark.parametrize("profile, vac", [("default", None),
                                          ("speed", None),
                                          ("default", 0.2)])
def test_a_second_call_lands_in_the_first_calls_buffers(monkeypatch,
                                                        tmp_path, profile,
                                                        vac):
    """Two calls through a ring of host slots and a pool of their own, the
    first object dropped in between: the second call's label grids land
    in the buffers the first call's gave back (``warm`` equal to
    ``pinned``), with the first call's values, where the first call's
    read ``warm`` 0; the second read of the file lands in the buffer of
    the first's density, which came back with them."""
    slot = 8192
    monkeypatch.setattr(trace, "moved",
                        lambda t, device: t.numel() * t.element_size())
    plain, plain_texts = _call(tmp_path / "plain", profile, vac)
    ring, pool = host_ring(slot), hostcopy.Pool()
    monkeypatch.setattr(hostcopy, "staged",
                        lambda t, device, dtype=None: t.dim() > 0
                        and t.numel() * t.element_size() >= slot)
    monkeypatch.setattr(hostcopy, "ring_for", lambda device: ring)
    monkeypatch.setattr(hostcopy, "_pool", pool)
    labels = [k for k in ("bader_volumes", "atoms_volumes")
              if hasattr(plain, k)]
    warm, density = [], []
    for run in ("first", "second"):
        b, texts = _call(tmp_path / run, profile, vac)
        assert texts == plain_texts
        spans = {s.name: s.counters for s in b.spans
                 if s.name.startswith("download.")}
        warm.append([spans["download." + k]["warm"] for k in labels])
        for k in labels:
            assert spans["download." + k]["pinned"] >= slot
            assert np.array_equal(getattr(b, k), getattr(plain, k)), k
        held = {address(getattr(b, k)) for k in labels}
        density.append(address(b.density))
        del b
        assert {address(buf) for buf in pool.free} == held | {density[-1]}
    assert density[1] == density[0]
    assert warm[0] == [0] * len(labels)
    assert warm[1] == [getattr(plain, k).nbytes for k in labels]


def test_pinned_reads_zero_for_small_copies_and_off_the_card():
    # a grid of one slot (np.zeros touches no page) on the CPU and on
    # 'meta', which stands in for a card in copy counts, and a small array
    grid = np.zeros((hostcopy.SLOT_BYTES // (8 * 128 * 128), 128, 128))
    assert grid.nbytes == hostcopy.SLOT_BYTES
    b = Bader.__new__(Bader)
    spans = []
    with trace.recording(spans):
        b.device = "cpu"
        b._dev(grid, torch.float64, "density")
        b.device = "meta"
        b._dev(grid, torch.float64, "density")
        b._dev(np.zeros((3, 3)), torch.float64, "lattice")
    assert [s.counters["pinned"] for s in spans] == [0, 0, 0]
    assert [s.counters["bytes"] for s in spans] == [0, grid.nbytes, 72]


# ----------------------------------------------------------------- the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the pinned ring and its DMA)")
    return torch.device("cuda", torch.cuda.current_device())


# (shape, host dtype, device dtype, order): whole slots and a ragged last
# chunk (a 400x400x512 grid's planes at a third of its depth), the label
# grids' dtypes, a Fortran-order density and a host-side cast
CARD_CASES = [
    ((400, 400, 168), np.float64, torch.float64, "C"),
    ((400, 400, 512), np.int16, torch.int16, "C"),
    ((336, 336, 320), np.int8, torch.int8, "C"),
    ((192, 200, 208), np.float64, torch.float64, "F"),
    ((192, 200, 208), np.float32, torch.float64, "C"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape, host, dtype, order", CARD_CASES)
def test_ring_equals_plain_copies_on_the_card(card, shape, host, dtype,
                                              order):
    a = source(shape, host, order)
    t = torch.as_tensor(a)
    assert hostcopy.staged(t, card, dtype)
    want = t.to(device=card, dtype=dtype)
    got = hostcopy.upload(t, dtype, card)
    assert got.device == card and got.is_contiguous()
    view = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    assert torch.equal(got.view(view[got.element_size()]),
                       want.view(view[want.element_size()]))
    down = hostcopy.download(want)
    assert own(down, hostcopy.ring_for(card))
    assert np.array_equal(bits(down), bits(want.cpu().numpy()))
    assert hostcopy.staged(want, "cpu")
    assert not hostcopy.staged(want[:1, :1], "cpu")


@pytest.mark.cuda
def test_the_pool_lends_warm_buffers_on_the_card(card):
    """A download from the card after the last one of its size was dropped
    lands in that buffer, counted ``warm``, with the card's values; one
    whose earlier result is still held takes another buffer."""
    ring, pool = hostcopy.ring_for(card), hostcopy.Pool()
    shape = (336, 336, 320)
    src = [torch.randint(-128, 128, shape, dtype=torch.int8, device=card)
           for _ in range(2)]
    want = [t.cpu().numpy() for t in src]
    first, warm = pooled(src[0], ring, pool)
    assert warm == 0 and np.array_equal(first, want[0])
    held = first[::2]
    del first
    second, warm = pooled(src[1], ring, pool)
    assert warm == 0 and np.array_equal(second, want[1])
    assert np.array_equal(held, want[0][::2])
    where = address(second)
    del second
    third, warm = pooled(src[0], ring, pool)
    assert warm == third.nbytes and address(third) == where
    assert np.array_equal(third, want[0]) and own(third, ring)


def blob_density(shape, device, centers=6, seed=0):
    """A smooth periodic density: separable gaussian blobs over a
    background, made on the card, and its atoms (fractional)."""
    rng = np.random.default_rng(seed)
    frac = rng.uniform(0.1, 0.9, size=(centers, 3))
    rho = torch.full(shape, 0.05, dtype=torch.float64, device=device)
    for c in frac:
        prof = []
        for n, x in zip(shape, c):
            d = (torch.arange(n, device=device, dtype=torch.float64) / n
                 - x + 0.5) % 1.0 - 0.5
            prof.append(torch.exp(-0.5 * (d / 0.12) ** 2))
        rho += prof[0][:, None, None] * prof[1][None, :, None] \
            * prof[2][None, None, :]
    return rho.cpu().numpy(), frac


@pytest.mark.cuda
def test_a_call_on_the_card_stages_its_grids(card, tmp_path, monkeypatch):
    """A default call at 336x336x320 (its int8 label grids above one
    slot): equal to the same call with plain copies, ``pinned`` equal to
    ``bytes`` on the density and both label grids, and a second call makes
    no new pinned allocation."""
    shape = (336, 336, 320)
    rho, frac = blob_density(shape, card)
    lattice = np.diag([20.0, 20.0, 20.0])
    atoms = frac @ lattice

    def call(out):
        out.mkdir()
        info = {"filename": "CHGCAR", "prefix": "", "file_type": "VASP",
                "voxel_offset": [0.0, 0.0, 0.0]}
        with contextlib.redirect_stdout(io.StringIO()):
            b = Bader({"charge": rho}, lattice, atoms, info, device="cuda",
                      output="dat", prefix=str(out) + os.sep)
            b()
        texts = [open(os.path.join(out, n)).read()
                 for n in sorted(os.listdir(out))]
        return b, texts

    b, texts = call(tmp_path / "ring")
    stats = getattr(torch.cuda, "host_memory_stats", None)
    before = stats() if stats is not None else None
    r = hostcopy.ring_for(card)
    again, again_texts = call(tmp_path / "again")
    assert hostcopy.ring_for(card) is r
    if before is not None:
        after = stats()
        assert after["num_host_alloc"] == before["num_host_alloc"]
    spans = {s.name: s.counters for s in b.spans
             if s.name.startswith(("upload.", "download."))}
    for name in ("upload.density", "download.bader_volumes",
                 "download.atoms_volumes"):
        assert spans[name]["pinned"] == spans[name]["bytes"] \
            >= hostcopy.SLOT_BYTES, name
    for name, c in spans.items():
        if name.split(".", 1)[1] not in GRIDS:
            assert c.get("pinned", 0) == 0, name
    monkeypatch.setattr(hostcopy, "staged", lambda *a, **k: False)
    plain, plain_texts = call(tmp_path / "plain")
    assert all(s.counters.get("pinned", 0) == 0 for s in plain.spans)
    assert texts == plain_texts == again_texts
    for key in RESULTS:
        want = np.asarray(getattr(plain, key))
        for got in (b, again):
            assert np.array_equal(bits(np.asarray(getattr(got, key))),
                                  bits(want)), key
