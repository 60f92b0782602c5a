"""Rates of the host<->device copies of the benchmark's grids on the card:
the plain copies (PyTorch's ``.to()`` from pageable numpy, ``.cpu()`` into
fresh pages), each half of the pinned ring measured alone (the DMA between
a pinned buffer and the device; the host's threaded ``copy_`` into warm
pinned memory and out of it into fresh or warm numpy pages), the ring
itself (``pybader_tpu_torch.hostcopy``) at several slot sizes and counts,
its downloads into fresh pages (``download.ring``, a pool that keeps
nothing), and the process ring's download into the buffer that the run
before gave back to a pool (``download.ring_into_reused``), checked bit
for bit against the plain copies.

    python3 tools/hostcopy_rates.py [--reps 5] [--rings 16x2,32x2]
        [--out PATH]

Each line of standard output is one JSON record: ``what``, the grid, the
bytes, the median seconds and GB/s (1e9 bytes) over ``--reps``, with the
card's name and power limit in the first line.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from pybader_tpu_torch import hostcopy  # noqa: E402

# the benchmark's grids: (name, shape, host dtype, device dtype)
UPLOADS = [("f64_384", (384, 384, 384), np.float64),
           ("f64_256", (256, 256, 256), np.float64),
           ("f64_hexslab", (400, 400, 512), np.float64)]
DOWNLOADS = [("int8_384", (384, 384, 384), torch.int8),
             ("int8_256", (256, 256, 256), torch.int8),
             ("int16_hexslab", (400, 400, 512), torch.int16)]
RINGS = "8x3,16x2,16x3,32x2,32x3,64x2"  # slot MiB x slots


def card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def timed(fn, reps):
    """Median host seconds of ``fn()`` ending in a device sync, and each
    run's."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
        del r
    return statistics.median(out), out


def pinned_ring(mib, slots):
    return hostcopy.Ring(hostcopy.Slot(
        torch.empty(mib << 20, dtype=torch.uint8, pin_memory=True),
        torch.cuda.Event()) for _ in range(slots))


def emit(records, out, **rec):
    if "seconds" in rec and rec.get("bytes"):
        rec["gb_per_s"] = rec["bytes"] / rec["seconds"] / 1e9
    records.append(rec)
    print(json.dumps(rec), flush=True)
    with open(out, "a") as f:
        f.write(json.dumps(rec) + "\n")


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    view = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return torch.equal(a.view(view[a.element_size()]),
                       b.view(view[b.element_size()]))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--rings", default=RINGS,
                    help="rings to time, as slot MiB x slots, comma-separated")
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "hostcopy_rates.jsonl"))
    args = ap.parse_args(argv)
    rings = [tuple(map(int, r.split("x"))) for r in args.rings.split(",")]
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    open(args.out, "w").close()
    dev = torch.device("cuda", 0)
    recs, reps = [], args.reps
    emit(recs, args.out, what="card", card=card(),
         device=torch.cuda.get_device_name(0), torch=torch.__version__,
         cuda=torch.version.cuda, threads=torch.get_num_threads(),
         cpus=os.cpu_count())
    rng = np.random.default_rng(0)

    for name, shape, host in UPLOADS:
        a = rng.normal(size=shape).astype(host)
        n = a.nbytes
        t = torch.as_tensor(a)
        want = t.to(dev)
        s, runs = timed(lambda: torch.as_tensor(a).to(dev), reps)
        emit(recs, args.out, what="upload.plain", grid=name, bytes=n,
             seconds=s, runs=runs)
        # each half alone: the DMA from pinned memory, the host's copy into
        # warm pinned memory in 32 MiB chunks
        pin = torch.empty(shape, dtype=t.dtype, pin_memory=True)
        pin.copy_(t)
        s, runs = timed(lambda: want.copy_(pin, non_blocking=True), reps)
        emit(recs, args.out, what="upload.dma_pinned", grid=name, bytes=n,
             seconds=s, runs=runs)
        slot = torch.empty(32 << 20, dtype=torch.uint8, pin_memory=True)
        step = (32 << 20) // (a[0].nbytes)

        def host_in():
            for i in range(0, shape[0], step):
                k = min(step, shape[0] - i)
                slot[:k * a[0].nbytes].view(t.dtype).view(
                    (k,) + shape[1:]).copy_(t[i:i + step])
        s, runs = timed(host_in, reps)
        emit(recs, args.out, what="upload.host_copy_into_pinned", grid=name,
             bytes=n, seconds=s, runs=runs)
        del pin, slot
        for mib, slots in rings:
            ring = pinned_ring(mib, slots)
            got = hostcopy.upload(t, torch.float64, dev, ring)
            torch.cuda.synchronize()
            ok = bits_equal(got, want)
            del got
            s, runs = timed(lambda: hostcopy.upload(t, torch.float64, dev,
                                                    ring), reps)
            emit(recs, args.out, what="upload.ring", grid=name, bytes=n,
                 slot_mib=mib, slots=slots, seconds=s, runs=runs, equal=ok)
            del ring
        del a, t, want
        torch.cuda.empty_cache()

    for name, shape, dtype in DOWNLOADS:
        info = torch.iinfo(dtype)
        src = torch.randint(info.min, info.max + 1, shape, dtype=dtype,
                            device=dev)
        n = src.numel() * src.element_size()
        want = src.cpu().numpy()
        s, runs = timed(lambda: src.cpu().numpy(), reps)
        emit(recs, args.out, what="download.plain", grid=name, bytes=n,
             seconds=s, runs=runs)
        pin = torch.empty(shape, dtype=dtype, pin_memory=True)
        s, runs = timed(lambda: pin.copy_(src, non_blocking=True), reps)
        emit(recs, args.out, what="download.dma_pinned", grid=name, bytes=n,
             seconds=s, runs=runs)

        def host_out():
            out = np.empty(shape, dtype=want.dtype)
            torch.from_numpy(out).copy_(pin)
            return out
        s, runs = timed(host_out, reps)
        emit(recs, args.out, what="download.host_copy_into_fresh", grid=name,
             bytes=n, seconds=s, runs=runs)
        warm = np.empty(shape, dtype=want.dtype)
        s, runs = timed(lambda: torch.from_numpy(warm).copy_(pin), reps)
        emit(recs, args.out, what="download.host_copy_into_warm", grid=name,
             bytes=n, seconds=s, runs=runs)
        del pin, warm
        # each run drops its result, whose buffer the next run reuses
        ring, pool = hostcopy.ring_for(dev), hostcopy.Pool()
        ok = np.array_equal(hostcopy.download(src, ring, pool), want)
        s, runs = timed(lambda: hostcopy.download(src, ring, pool), reps)
        emit(recs, args.out, what="download.ring_into_reused", grid=name,
             bytes=n, slot_mib=hostcopy.SLOT_BYTES >> 20,
             slots=hostcopy.SLOTS, seconds=s, runs=runs, equal=ok)
        del pool
        fresh = hostcopy.Pool(0)  # keeps nothing: every run's pages fresh
        for mib, slots in rings:
            ring = pinned_ring(mib, slots)
            ok = np.array_equal(hostcopy.download(src, ring, fresh), want)
            s, runs = timed(lambda: hostcopy.download(src, ring, fresh),
                            reps)
            emit(recs, args.out, what="download.ring", grid=name, bytes=n,
                 slot_mib=mib, slots=slots, seconds=s, runs=runs, equal=ok)
            del ring
        del src, want
        torch.cuda.empty_cache()
    bad = [r for r in recs if r.get("equal") is False]
    if bad:
        raise SystemExit(f"the ring differs from the plain copy: {bad}")


if __name__ == "__main__":
    main()
