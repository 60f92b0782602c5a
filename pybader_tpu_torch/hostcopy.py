"""Copies of the large grids between the host and a CUDA device through a
ring of page-locked (pinned) host slots, and the warm host buffers that
the downloads land in.

A copy from a pageable numpy array goes through the driver's own small
pinned buffers, one thread at a time, and a copy into a fresh pageable
array also faults in every page of it in that thread.  Here a grid crosses
in chunks of whole planes (indices of axis 0) through a few pinned slots
of one fixed size: the host side of each chunk is a PyTorch CPU
``copy_``, spread over its intra-op threads (which also casts an upload),
and the DMA of one chunk runs while the host copies the next.  Each slot
holds a CUDA event recorded after its DMA, and the host waits on it before
the slot is used again.

The ring is allocated lazily, once per process and device, on the first
copy it takes, and pinned host memory stays ``SLOTS * SLOT_BYTES``
whatever the caller keeps.  A download lands in a host buffer of the
grid's exact size that a process-wide :class:`Pool` lends: one that an
earlier result gave back when its caller dropped it, its pages already
faulted in (first touch of fresh pages is the slowest part of a download),
else a new one.  The result is a writable numpy array of the grid's dtype
and shape whose base is the loan (:class:`Lease`); the buffer goes back to
the pool once the caller has dropped the array and every view of it, and
the pool keeps at most ``POOL_BUFFERS`` free; a CHGCAR's density grid
is read into one too (:func:`empty`).  A copy smaller than one
slot, one whose planes do not fit a slot, and any copy that is not between
the host and a CUDA device take PyTorch's plain ``.to()`` / ``.cpu()``
(:func:`staged` decides, from the tensor alone).  The chunk loops take
their :class:`Ring` and :class:`Pool` as arguments, so that tests can
drive them with plain host slots and pools of their own.
"""
from __future__ import annotations

import threading
import weakref
from math import prod

import numpy as np
import torch

from pybader_tpu_torch import trace

# Slot size and count, from the rates of 8-64 MiB slots, 2-3 of them, on
# an H100 host (PERF.md, section 5): two 32 MiB slots upload a 384^3 f64
# grid fastest; no size moves a download, whose time is the host's copy
# out of the slots.
SLOT_BYTES = 32 << 20
SLOTS = 2
# Free host buffers the process keeps: a call's two label grids, of at
# most two sizes, and a density read from a file.
POOL_BUFFERS = 4


class Slot:
    """A host buffer of bytes and the event recorded after its last DMA
    (None for a slot that no device copies: the tests' plain slots)."""

    __slots__ = ("buf", "event")

    def __init__(self, buf: torch.Tensor, event=None):
        self.buf, self.event = buf, event

    def view(self, dtype, shape) -> torch.Tensor:
        """The slot's first bytes as a contiguous tensor of ``shape``."""
        n = prod(shape) * _itemsize(dtype)
        return self.buf[:n].view(dtype).view(shape)

    def wait(self):
        """Block the host until the slot's last DMA is done."""
        if self.event is not None:
            self.event.synchronize()

    def record(self, stream):
        """Mark the end of the DMA just queued on ``stream``."""
        if self.event is not None:
            self.event.record(stream)


class Ring:
    """Slots of one size, used in turn, and the lock that gives one copy at
    a time the whole ring."""

    def __init__(self, slots):
        self.slots = list(slots)
        self.slot_bytes = self.slots[0].buf.numel()
        self.lock = threading.Lock()


_rings: dict = {}  # CUDA device index -> its Ring, made at first use
_rings_lock = threading.Lock()


class Pool:
    """Free host buffers (uint8 numpy arrays) of whole grids, by byte size:
    :func:`download` takes one of its grid's size and lends it; the buffer
    comes back (:meth:`give`) when the loan dies.  At most ``size`` are
    kept, the least recently returned dropped first.  A return runs from a
    finalizer, at any point of any thread, :meth:`take` included: so both
    hold a reentrant lock, and :meth:`take` removes its buffer by identity,
    whatever a return did to the list meanwhile."""

    def __init__(self, size=POOL_BUFFERS):
        self.size = size
        self.free = []  # the least recently returned first
        self.lock = threading.RLock()

    def take(self, nbytes: int):
        """The most recently returned free buffer of ``nbytes``, now the
        caller's, or None."""
        with self.lock:
            buf = next((b for b in reversed(self.free) if b.nbytes == nbytes),
                       None)
            if buf is not None:
                self.free = [b for b in self.free if b is not buf]
            return buf

    def give(self, buf: np.ndarray):
        """Return ``buf``, which no array uses any more."""
        with self.lock:
            self.free.append(buf)
            del self.free[:max(len(self.free) - self.size, 0)]


_pool = Pool()  # the process's download buffers


class Lease:
    """A buffer lent by a :class:`Pool`, seen as a ``dtype`` grid of
    ``shape``: the base of the array :func:`download` returns.  numpy stops
    collapsing a view's base at an object that is not an array, so every
    view derived from that array (slice, transpose, reshape,
    ``torch.from_numpy``) holds the lease, and the buffer goes back to the
    pool when the last of them is gone."""

    __slots__ = ("buf", "__array_interface__", "__weakref__")

    def __init__(self, buf: np.ndarray, dtype, shape):
        self.buf = buf
        self.__array_interface__ = {
            "version": 3, "shape": tuple(shape), "typestr": dtype.str,
            "data": (buf.ctypes.data, False)}  # address, writable


def _lend(pool: Pool, nbytes: int, dtype, shape) -> np.ndarray:
    """A writable ``dtype`` array of ``shape`` in a buffer of ``nbytes``
    from ``pool`` (a new one where it has none), whose buffer goes back to
    ``pool`` when the array and its views are gone; the reused bytes count
    as ``warm`` in the innermost open span."""
    buf = pool.take(nbytes)
    if buf is None:
        buf = np.empty(nbytes, dtype=np.uint8)
    else:
        trace.count("warm", nbytes)
    lease = Lease(buf, dtype, shape)
    weakref.finalize(lease, pool.give, buf).atexit = False
    return np.asarray(lease)


def empty(shape, dtype) -> np.ndarray:
    """A writable numpy array of ``shape`` and ``dtype`` in a host buffer
    lent by the process's pool, as a download's (:func:`_lend`): where a
    grid of its size was given back, its pages are already faulted in.
    What a reader fills with a grid that the caller keeps, then drops."""
    dtype, shape = np.dtype(dtype), tuple(int(s) for s in shape)
    return _lend(_pool, prod(shape) * dtype.itemsize, dtype, shape)


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _device(device) -> torch.device:
    """``device`` with its index (the current device's where none is
    named)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def ring_for(device) -> Ring:
    """The process's ring for CUDA ``device``: ``SLOTS`` pinned slots of
    ``SLOT_BYTES``, allocated on the first call."""
    dev = _device(device)
    with _rings_lock:
        r = _rings.get(dev.index)
        if r is None:
            r = _rings[dev.index] = Ring(
                Slot(torch.empty(SLOT_BYTES, dtype=torch.uint8,
                                 pin_memory=True), torch.cuda.Event())
                for _ in range(SLOTS))
        return r


def _planes(shape, dtype, slot_bytes: int) -> int:
    """Planes (indices of axis 0) of a ``shape`` grid of ``dtype`` that a
    slot of ``slot_bytes`` holds."""
    step = slot_bytes // max(prod(shape[1:]) * _itemsize(dtype), 1)
    if step == 0:
        raise ValueError(f"a plane of a {tuple(shape)} grid of {dtype} "
                         f"does not fit a slot of {slot_bytes} bytes")
    return step


def staged(t: torch.Tensor, device, dtype=None) -> bool:
    """Whether the copy of ``t`` to ``device``, as ``dtype`` (by default
    its own), goes through the ring: between the host and a CUDA device,
    at least one slot in size, a plane no larger than a slot."""
    if {t.device.type, torch.device(device).type} != {"cpu", "cuda"} \
            or t.dim() == 0:
        return False
    plane = prod(t.shape[1:]) * _itemsize(t.dtype if dtype is None
                                          else dtype)
    return 0 < plane <= SLOT_BYTES <= t.shape[0] * plane


def _stream(device):
    return torch.cuda.current_stream(device) \
        if device.type == "cuda" else None


def _chunks(shape, dtype, ring: Ring):
    """(first plane, slot, the slot's bytes as that chunk) for each chunk
    of whole planes of a ``shape`` grid of ``dtype``, the slots in turn."""
    step = _planes(shape, dtype, ring.slot_bytes)
    for j, i in enumerate(range(0, shape[0], step)):
        slot = ring.slots[j % len(ring.slots)]
        yield i, slot, slot.view(dtype, (min(step, shape[0] - i),)
                                 + tuple(shape[1:]))


def upload(src: torch.Tensor, dtype, device, ring: Ring | None = None):
    """Host tensor ``src`` (any strides, any dtype) as a new contiguous
    ``dtype`` tensor on ``device``, through ``ring`` (by default the
    device's, :func:`ring_for`).  Each chunk is cast into its slot on the
    host.  Returns without waiting for the device: what is queued after it
    on the device's current stream follows the copies."""
    dev = _device(device)
    r = ring_for(dev) if ring is None else ring
    out = torch.empty(src.shape, dtype=dtype, device=dev)
    stream = _stream(dev)
    with r.lock:
        for i, slot, part in _chunks(src.shape, dtype, r):
            slot.wait()  # its last DMA has read it
            part.copy_(src[i:i + len(part)])
            out[i:i + len(part)].copy_(part, non_blocking=True)
            slot.record(stream)
    return out


def download(src: torch.Tensor, ring: Ring | None = None,
             pool: Pool | None = None) -> np.ndarray:
    """Device tensor ``src`` as a numpy array of its own, in a buffer lent
    by ``pool`` (by default the process's; :func:`_lend`), through ``ring``
    (by default its device's, :func:`ring_for`): the DMA of one chunk into
    its slot runs while the host copies the one before out of its slot."""
    r = ring_for(src.device) if ring is None else ring
    out = _lend(_pool if pool is None else pool,
                src.numel() * src.element_size(),
                torch.empty((), dtype=src.dtype).numpy().dtype, src.shape)
    host = torch.from_numpy(out)
    stream = _stream(src.device)

    def drain(i, slot, part):
        slot.wait()
        host[i:i + len(part)].copy_(part)

    with r.lock:
        back = None  # the chunk whose DMA runs while the next is queued
        for chunk in _chunks(src.shape, src.dtype, r):
            i, slot, part = chunk
            slot.wait()  # no earlier DMA still reads or writes it
            part.copy_(src[i:i + len(part)], non_blocking=True)
            slot.record(stream)
            if back is not None:
                drain(*back)
            back = chunk
        if back is not None:
            drain(*back)
    return out
