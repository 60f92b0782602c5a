"""Spans and counters of one analysis.

``span(name, **counters)`` times a step of a :class:`~pybader_tpu_torch.
interface.Bader` call on the host clock (``perf_counter_ns``) and ``count
(key, n)`` adds to a counter of the innermost open span.  A span records
its name, start, end, the index of its parent in the list and its
counters.  They are kept only while :func:`recording` is active, which
``Bader`` does for its ``__init__`` and ``__call__``, leaving the list on the
object as ``Bader.spans``; anywhere else (pipeline functions called
directly) both are no-ops that cost one global read.

While ``torch.profiler`` runs, each span also opens a ``record_function``
range named ``pb.<name>``, so that the spans share the device trace's
clock, and each recording's finished spans are summed by name into
:data:`profiled`, the totals a reader of that profile puts beside the
trace.  The profiler is the only switch: no span adds a device
synchronisation or a host read, and counters take only sizes and the ints
the code already holds.

A :class:`Span` entered directly, as ``interface._stage`` does, also
times its step outside a recording: ``Bader.stage_seconds`` is read from
its stage's span.

Names: ``stage.<name>`` (a stage of ``Bader.__call__``),
``upload.<what>`` and ``download.<what>`` (counter ``bytes``, what crosses
between host and device: :func:`moved`, summed over the shards on a mesh;
in ``Bader``'s, counter ``pinned``, the bytes of it that crossed through
:mod:`~pybader_tpu_torch.hostcopy`'s pinned ring, 0 for a plain copy and
on a mesh, and on a download ``warm``, the bytes of it that landed in a
host buffer the pool reused, 0 on a miss or a plain copy),
``resident.<what>`` (counter ``bytes``, the size of a grid, whole or
sharded, that a stage took from those the call holds in place of a copy),
``host.<what>`` (numpy work: in a call, on one device or a mesh,
only ``results``, ``write``, ``pickle`` and ``export``;
``vacuum_scan``, ``vacuum_where`` and ``copyto`` only in stages called on
their own, as ``bader-read`` calls them), ``sums.<what>``
(the per-label sums of the ``density`` or the ``spin`` and their two small
downloads; counter ``labels``, the basins or atoms summed over),
``vacuum.mask`` (the vacuum mask and its reads; counter ``voxels``, the
vacuum voxels), ``atoms.assign`` (the maxima's nearest atoms and the
two downloads of the assignment; counters ``maxima`` and ``atoms``),
``surface.distance`` (each atom's distance to its volume's surface and
its download; counter ``atoms``), ``init``, ``analysis`` (the root),
``partition.*`` and ``refine.*`` (:mod:`pybader_tpu_torch.pipeline`),
and in front of ``init`` where ``Bader.from_file`` read the file,
``read.<key>`` (each density block of a CHGCAR, ``charge`` and ``spin``,
from its text to the x-major grid over the cell volume:
:func:`pybader_tpu_torch.io.vasp.read`; counters ``bytes``, the block's
text, and ``direct``, the bytes of it that the native reader parsed
straight into the grid, 0 on the Python fallback: the direct path's
engagement is ``direct / bytes``; and ``warm``, the grid's bytes where
it landed in a host buffer that :mod:`~pybader_tpu_torch.hostcopy`'s
pool reused, 0 on a miss and on the fallback).
"""
from __future__ import annotations

from collections import Counter, defaultdict
from contextlib import contextmanager, nullcontext
from time import perf_counter_ns

import torch
from torch.autograd import _profiler_enabled
from torch.profiler import record_function

# The recording in progress, else None.
_active = None

# Span name -> Counter of ``count`` (spans finished), ``ns`` (their summed
# duration) and their summed counters, over every recording that ended
# while a profiler ran: what the benchmark's span metrics read, until its
# harness hands them each analysis's ``Bader.spans`` (ROADMAP item 18).
profiled: defaultdict = defaultdict(Counter)


class Span:
    """One timed step: ``name``, ``id`` (its index in the list),
    ``parent`` (the enclosing span's id, or None), ``start_ns``, ``end_ns``
    and ``counters``.  Outside a recording it is timed and kept nowhere
    (``id`` None)."""

    __slots__ = ("name", "id", "parent", "start_ns", "end_ns", "counters",
                 "_rec", "_range")

    def __init__(self, name, counters=None):
        self.name = name
        self.counters = {} if counters is None else counters
        self.id = self.parent = self.end_ns = self._range = None

    def __enter__(self):
        rec = self._rec = _active
        if rec is not None:
            stack, spans = rec.stack, rec.spans
            self.parent = stack[-1].id if stack else None
            self.id = len(spans)
            spans.append(self)
            stack.append(self)
        if _profiler_enabled():
            self._range = record_function("pb." + self.name)
            self._range.__enter__()
        self.start_ns = perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.end_ns = perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
            self._range = None
        if self._rec is not None:
            self._rec.stack.pop()
        return False

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


# The span outside a recording.
_NULL = nullcontext()


class _Recording:
    __slots__ = ("spans", "stack")

    def __init__(self, spans):
        self.spans, self.stack = spans, []


def span(name: str, **counters):
    """A context manager timing ``name`` in the active recording (entered
    at once, it gives the :class:`Span`); a no-op outside one."""
    if _active is None:
        return _NULL
    return Span(name, counters)


def count(key: str, n: int) -> None:
    """Add ``n`` to counter ``key`` of the innermost open span."""
    rec = _active
    if rec is not None and rec.stack:
        c = rec.stack[-1].counters
        c[key] = c.get(key, 0) + n


@contextmanager
def recording(spans: list):
    """Record the spans opened inside into ``spans`` (appended; a span's
    id is its index there).  While a profiler runs, the spans recorded are
    also summed into :data:`profiled` when the recording ends."""
    global _active
    prev, first = _active, len(spans)
    _active = _Recording(spans)
    try:
        yield
    finally:
        _active = prev
        if _profiler_enabled():
            for s in spans[first:]:
                if s.end_ns is not None:
                    t = profiled[s.name]
                    t["count"] += 1
                    t["ns"] += s.end_ns - s.start_ns
                    t.update(s.counters)


def moved(tensor: torch.Tensor, device) -> int:
    """Bytes that ``tensor.to(device)`` (``device`` a name or a
    ``torch.device``) copies between host and device: 0 where both are on
    the host or both on devices, else the tensor's size.  Count the tensor
    as it is handed to the copy: an upload that casts is cast on the host
    first (``Bader._dev``), so its bytes are the cast tensor's."""
    to_host = device.startswith("cpu") if isinstance(device, str) \
        else device.type == "cpu"
    if tensor.is_cpu == to_host:
        return 0
    return tensor.numel() * tensor.element_size()
