"""The one generator of the benchmark's traffic: periodic blob densities.

A traffic mix is a JSON file under ``traffic/`` whose keys this module
reads (see README.md).  Each density is the recipe of ``chip_smoke.py``'s
``blob_field``, with the seed as an argument: ``blobs`` impulses of
uniform height in ``heights`` at places drawn from ``(seed, index)``
(along c only inside ``band``, a pair of fractions, where one is given),
blurred with the FFT filter ``exp(-k2 * narrow) + wide_weight * exp(-k2 *
wide)`` (k in cycles a voxel), shifted to a minimum of 1e-9 and, where
``electrons`` is given, scaled so that it integrates to that many
electrons over the cell, as a CHGCAR reader returns it (rho * V / V).
The atoms are the impulses' places in cartesian coordinates.

Further keys, each optional:

- ``shapes``: a list of grid shapes; density ``i`` takes ``shapes[i %
  len(shapes)]`` (a campaign of mixed grids).  Without it, ``shape``.
- ``spin``: a spin density beside the charge, made at the same places
  with the recipe's keys that ``spin`` overrides (signed ``heights``, as a
  rule), not shifted and not scaled.
- ``entry``: ``"arrays"`` (the default: the timed call receives the host
  arrays, as a reader returns them) or ``"file"``: set-up writes each
  density as a CHGCAR (``write_chgcar``) and the timed call reads it with
  ``Bader.from_file``; the reference then reads it with ``read_chgcar``.

Every seed gives the same shapes and impulse counts; only the places and
heights move.
"""
from __future__ import annotations

import os

import numpy as np
import torch


def shape_of(traffic, index: int):
    shapes = traffic.get("shapes") or [traffic["shape"]]
    return tuple(int(s) for s in shapes[index % len(shapes)])


def blurred(shape, idx, heights, recipe, device):
    """The impulses ``heights`` at ``idx`` blurred with the recipe's FFT
    filter, on ``device``."""
    rho = torch.zeros(shape, dtype=torch.float64, device=device)
    rho[tuple(torch.as_tensor(i, device=device) for i in idx)] = \
        torch.as_tensor(heights, device=device)
    k2 = sum(torch.fft.fftfreq(s, dtype=torch.float64, device=device).reshape(
        [-1 if i == d else 1 for i in range(3)]) ** 2
        for d, s in enumerate(shape))
    filt = torch.exp(-k2 * float(recipe["narrow"])) + \
        float(recipe["wide_weight"]) * torch.exp(-k2 * float(recipe["wide"]))
    return torch.fft.ifftn(torch.fft.fftn(rho) * filt).real


def blob_density(shape, lattice, traffic, seed: int, index: int, device):
    """One density of the mix ``traffic`` (a dict), on ``device``; returns
    ({"charge": f64 grid tensor[, "spin": ...]}, atoms (blobs, 3)
    cartesian numpy)."""
    rng = np.random.default_rng([seed % 2 ** 64, index])
    n = int(traffic["blobs"])
    band = traffic.get("band")
    idx = []
    for axis, s in enumerate(shape):
        lo, hi = (0, s) if band is None or axis != 2 else \
            (int(band[0] * s), int(band[1] * s))
        idx.append(rng.integers(lo, hi, size=n))
    heights = rng.uniform(*traffic["heights"], size=n)
    rho = blurred(shape, idx, heights, traffic, device)
    rho = rho - rho.min() + 1e-9
    if traffic.get("electrons") is not None:
        voxel_volume = abs(np.linalg.det(lattice)) / float(np.prod(shape))
        rho = rho * (float(traffic["electrons"])
                     / (float(rho.sum()) * voxel_volume))
    out = {"charge": rho.contiguous()}
    if traffic.get("spin") is not None:
        recipe = dict(traffic, **traffic["spin"])
        spin_heights = np.random.default_rng(
            [seed % 2 ** 64, index, 1]).uniform(*recipe["heights"], size=n)
        out["spin"] = blurred(shape, idx, spin_heights, recipe,
                              device).contiguous()
    centers = np.stack(idx, axis=1) / np.asarray(shape)
    return out, centers @ np.asarray(lattice)


def make_input(traffic, lattice, seed: int, index: int, device):
    """Density ``index`` of the mix as host f64 numpy grids (made on
    ``device``): ({"charge": ...[, "spin": ...]}, atoms)."""
    fields, atoms = blob_density(shape_of(traffic, index), lattice, traffic,
                                 seed, index, device)
    return {k: v.cpu().numpy() for k, v in fields.items()}, atoms


def make_inputs(traffic, lattice, seed: int, device, file_dir=None):
    """The mix's ``count`` inputs as the timed calls receive them: dicts
    with ``density`` (the host grids), ``atoms``, ``shape`` and ``path``
    (the CHGCAR under ``file_dir`` where the mix's ``entry`` is "file",
    and then no ``density``; else None)."""
    out = []
    for i in range(int(traffic["count"])):
        density, atoms = make_input(traffic, lattice, seed, i, device)
        rec = {"density": density, "atoms": atoms, "path": None,
               "shape": shape_of(traffic, i)}
        if traffic.get("entry", "arrays") == "file":
            rec["path"] = os.path.join(file_dir, str(i), "CHGCAR")
            os.makedirs(os.path.dirname(rec["path"]), exist_ok=True)
            write_chgcar(rec["path"], density, lattice, atoms)
            rec["density"] = None
        elif traffic.get("entry", "arrays") != "arrays":
            raise ValueError(f"unknown entry {traffic['entry']!r}")
        out.append(rec)
    return out


# ------------------------------------------------------------ CHGCAR files
_DIGITS = 11  # VASP's own: ' 0.12345678901E+01', here ' 1.23456789012E+00'


def format_block(values) -> bytes:
    """``values`` (1-D f64) as VASP writes a density block: five a line,
    each ``' % .11E'`` (the sign column blank for a positive value), with
    a two-digit exponent.  Vectorised: one decimal rounding a value."""
    v = np.asarray(values, dtype=np.float64)
    a = np.abs(v)
    e = np.zeros(v.shape, dtype=np.int64)
    nz = a > 0
    e[nz] = np.floor(np.log10(a[nz])).astype(np.int64)
    mant = np.rint(a / 10.0 ** e.astype(np.float64) * 10 ** _DIGITS
                   ).astype(np.int64)
    carry = mant >= 10 ** (_DIGITS + 1)
    mant[carry] //= 10
    e[carry] += 1
    low = nz & (mant < 10 ** _DIGITS)
    mant[low] *= 10
    e[low] -= 1
    if np.abs(e).max(initial=0) > 99:
        raise ValueError("a value needs a three-digit exponent")
    width = _DIGITS + 8
    chars = np.empty((v.size, width), dtype=np.uint8)
    chars[:, 0] = ord(" ")
    chars[:, 1] = np.where(v < 0, ord("-"), ord(" "))
    for k in range(_DIGITS + 1):  # the digits, last first
        col = 2 + (_DIGITS + 1 - k) if k < _DIGITS else 2
        chars[:, col] = ord("0") + mant % 10
        mant //= 10
    chars[:, 3] = ord(".")
    chars[:, width - 4] = ord("E")
    chars[:, width - 3] = np.where(e < 0, ord("-"), ord("+"))
    chars[:, width - 2] = ord("0") + np.abs(e) // 10
    chars[:, width - 1] = ord("0") + np.abs(e) % 10
    lines = []
    full = (v.size // 5) * 5
    body = chars[:full].reshape(-1, 5 * width)
    body = np.concatenate([body, np.full((len(body), 1), ord("\n"),
                                         dtype=np.uint8)], axis=1)
    lines.append(body.tobytes())
    if full < v.size:
        lines.append(chars[full:].tobytes() + b"\n")
    return b"".join(lines)


def write_chgcar(path, density, lattice, atoms):
    """A CHGCAR of ``density`` ({"charge"[, "spin"]}, as a reader returns
    them: the file holds rho * V), ``lattice`` and cartesian ``atoms``."""
    lattice = np.asarray(lattice, dtype=np.float64)
    volume = float(np.dot(lattice[0], np.cross(lattice[1], lattice[2])))
    frac = np.asarray(atoms, dtype=np.float64) @ np.linalg.inv(lattice)
    shape = density["charge"].shape
    head = ["benchmark density", "   1.00000000000000"]
    head += ["  " + " ".join(f"{x:.17f}" for x in row) for row in lattice]
    head += ["   X", f"   {len(frac)}", "Direct"]
    head += [" " + " ".join(f"{x:.17f}" for x in row) for row in frac]
    grid = " " + " ".join(f"{s:5d}" for s in shape) + "\n"
    with open(path, "wb") as f:
        f.write(("\n".join(head) + "\n\n" + grid).encode())
        for key in ("charge", "spin"):
            if key in density:
                if key == "spin":
                    f.write(grid.encode())
                grid_zfast = np.swapaxes(density[key] * volume, 0, -1)
                f.write(format_block(grid_zfast.reshape(-1)))


def read_chgcar(path):
    """A plain read of a CHGCAR as pybader reads it: (density dict, lattice,
    cartesian atoms wrapped into the cell), values over the cell volume."""
    with open(path) as f:
        text = f.read()
    lines = text.split("\n")
    scale = float(lines[1].split()[0])
    lattice = np.array([[float(x) for x in lines[2 + i].split()]
                        for i in range(3)]) * scale
    counts = [int(x) for x in lines[6].split()]
    n = sum(counts)
    frac = np.array([[float(x) for x in lines[8 + i].split()[:3]]
                     for i in range(n)]).reshape(n, 3) % 1
    grid_line = lines[9 + n]
    shape = tuple(int(x) for x in grid_line.split())
    size = int(np.prod(shape))
    rest = "\n".join(lines[10 + n:]).split(grid_line.strip())
    volume = np.dot(lattice[0], np.cross(lattice[1], lattice[2]))
    density = {}
    for key, block in zip(("charge", "spin"), rest):
        vals = np.array(block.split()[:size], dtype=np.float64)
        density[key] = np.ascontiguousarray(
            np.swapaxes(vals.reshape(shape[::-1]), 0, -1)) / volume
    return density, lattice, frac @ lattice
