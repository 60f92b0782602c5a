"""VASP CHGCAR / .vasp density reader and writer.

Format parity with :mod:`pybader_tpu.io.vasp` and the reference pybader
reader (io/vasp.py:15-164): densities are stored x-major (the file is
x-fastest), values are divided by the cell volume (file stores rho * V),
atoms are
wrapped into the cell and returned cartesian.  The spin block is located by
scanning forward for a repeat of the grid-dimensions line (more robust than
the reference's mid-file seek heuristic); augmentation charges are ignored.

Each density block goes from the file's bytes to its x-major grid, over
the cell volume, in one native pass on every core
(:func:`~pybader_tpu_torch.io._fastparse.read_chgcar_block`), which
places each value by its index in the file, so lines may vary in width.
Where that library cannot be built or loaded, the block is read as the
JAX package reads it: the native or numpy float parse of lines of the
first line's width, then the axis swap and the division.
"""
from __future__ import annotations

import os
from time import time

import numpy as np

from pybader_tpu_torch import hostcopy, trace
from pybader_tpu_torch.io import _fastparse
from pybader_tpu_torch.utils import (fortran_format, parse_float_block,
                               python_format, tqdm_wrap)

__extensions__ = ["chgcar", ".vasp"]
__args__ = ["charge_flag", "spin_flag", "buffer_size", "threads"]


def _read_block(f, grid_pts, threads=None):
    """Parse one density block of grid_pts values starting at f's position."""
    pos = f.tell()
    first = f.readline()
    vals_per_line = len(first.split())
    line_len = len(first)
    f.seek(pos)
    full_lines = grid_pts // vals_per_line
    rem = grid_pts % vals_per_line
    buf = f.read(full_lines * line_len)
    vals = parse_float_block(buf, full_lines * vals_per_line, threads)
    if rem:
        tail = np.array(f.readline().split()[:rem], dtype=np.float64)
        vals = np.concatenate([vals, tail])
    return vals


def _skip_block(f, grid_pts):
    pos = f.tell()
    first = f.readline()
    vals_per_line = len(first.split())
    line_len = len(first)
    f.seek(pos)
    full_lines = grid_pts // vals_per_line
    f.seek(full_lines * line_len, 1)
    if grid_pts % vals_per_line:
        f.readline()


def _read_density(f, fn, key, grid, volume, threads, lib):
    """The density block at f's position as the x-major grid over the cell
    ``volume``, read in a ``read.<key>`` span that counts the block's text
    ``bytes``, the ``direct`` bytes of them that the native reader parsed
    (all of them, or 0 where ``lib`` is None: the Python path) and the
    grid's bytes that landed ``warm`` in a pooled host buffer."""
    with trace.span("read." + key, warm=0):
        start = f.tell()
        if lib is not None:
            vals = hostcopy.empty(grid, np.float64)
            f.seek(_fastparse.read_chgcar_block(lib, fn, start, grid, vals,
                                                volume, threads))
        else:
            vals = _read_block(f, int(np.prod(grid)), threads)
            vals = np.ascontiguousarray(
                np.swapaxes(vals.reshape(grid[::-1]), 0, -1))
            vals /= volume
        trace.count("bytes", f.tell() - start)
        trace.count("direct", f.tell() - start if lib is not None else 0)
    return vals


def read(fn, charge_flag=True, spin_flag=False, buffer_size=64,
         threads=None):
    """Read charge and/or spin density from a CHGCAR-style file.

    ``threads`` caps the native reader's host threads (CLI -j flag).
    returns (density dict, lattice 3x3, atoms cartesian, file_info).
    """
    t0 = time()
    density = {}
    prefix, filename = os.path.split(fn)
    prefix = os.path.join(prefix, "")
    try:
        lib = _fastparse.load_chgcar()
    except Exception:  # no compiler or no build: the Python block reader
        lib = None
    with open(fn, "rb") as f:
        def line():
            return f.readline().decode("latin-1")

        print(f"  Reading {f.name} as CHGCAR format.")
        _ = line()  # comment
        scale = np.array(line().split(), dtype=np.float64)
        lattice = np.zeros((3, 3), dtype=np.float64)
        for i in range(3):
            lattice[i] = line().split()
        species_line = line().split()
        try:
            atom_nums = np.array(species_line, dtype=np.int64)
            atom_types = None
        except ValueError:
            atom_types = species_line
            atom_nums = np.array(line().split(), dtype=np.int64)
        atom_sum = int(atom_nums.sum())
        coord_system = line().lstrip().lower()
        atoms = np.zeros((atom_sum, 3), dtype=np.float64)
        for i in range(atom_sum):
            atoms[i] = line().split()[:3]
        if scale.shape[0] == 1:
            lattice *= scale[0]
        else:
            lattice *= scale[:, None]
        if coord_system[:1] == "d":
            atoms %= 1
        else:
            atoms = np.dot(atoms, np.linalg.inv(lattice))
            atoms %= 1
        lattice_vol = np.dot(lattice[0], np.cross(lattice[1], lattice[2]))
        _ = line()  # blank separator
        grid_str = line()
        grid = np.array(grid_str.split(), dtype=np.int64)
        grid_pts = int(np.prod(grid))
        print(f"  {' x '.join(grid.astype(str))} grid size.")
        if charge_flag:
            density["charge"] = _read_density(f, fn, "charge", grid,
                                              lattice_vol, threads, lib)
        elif lib is not None:
            f.seek(_fastparse.read_chgcar_block(lib, fn, f.tell(), grid,
                                                None, threads=threads))
        else:
            _skip_block(f, grid_pts)
        if spin_flag:
            found = False
            while True:
                text = line()
                if not text:
                    break
                if text.split() == grid_str.split():
                    found = True
                    break
            if not found:
                print(f"  No spin density in {fn}")
                spin_flag = False
            else:
                density["spin"] = _read_density(f, fn, "spin", grid,
                                                lattice_vol, threads, lib)
        print(f"  File {f.name} closed. ", end="")
    atoms = np.dot(atoms, lattice)
    print(f"Time taken: {time() - t0:0.3f}s", end="\n\n")
    file_info = {
        "filename": filename,
        "prefix": prefix,
        "file_type": "VASP",
        "buffer_size": buffer_size,
        "write_function": write,
        "element_nums": atom_nums,
        "charge_flag": charge_flag,
        "spin_flag": spin_flag,
        "voxel_offset": np.zeros(3),
    }
    if atom_types is not None:
        file_info["elements"] = atom_types
    return density, lattice, atoms, file_info


def _write_block(f, arr3d, output_format, chunk_lines=4096, desc=""):
    """Write one density block, 5 values per line, z-fastest order."""
    flat = np.swapaxes(arr3d, 0, -1).reshape(-1)
    lines = flat.shape[0] // 5
    rem = flat.shape[0] % 5
    body = flat[: lines * 5].reshape(lines, 5)
    for lo in tqdm_wrap(range(0, lines, chunk_lines), desc=desc):
        f.write(output_format(body[lo:lo + chunk_lines], 11))
    if rem:
        f.write(output_format(flat[-rem:].reshape(1, rem), 11))


def write(fn, atoms, lattice, density, file_info, prefix="", suffix="-CHGCAR"):
    """Write a VASP-style charge (+spin) density file.

    Output format levels via file_info['fortran_format']: 0 python
    exponent form, 1 python form with sign-column padding, 2 fortran
    standard form (reference io/vasp.py:167-258 behaviour).
    """
    fn = prefix + fn + suffix
    ff = file_info.get("fortran_format", 0)
    if ff == 2:
        output_format = fortran_format
    elif ff == 1:
        def output_format(a, p):
            return python_format(a, p, " ")
    else:
        output_format = python_format
    lattice_vol = np.dot(lattice[0], np.cross(lattice[1], lattice[2]))
    shape = None
    for key in density:
        shape = density[key].shape

    lattice_width = np.max(np.log10(np.abs(lattice[lattice != 0]))) + 9
    lattice_width = max([int(lattice_width), 9]) + 1
    lattice_prec = 17 - lattice_width
    with np.errstate(divide="ignore"):
        nz_atoms = np.abs(atoms[atoms != 0])
        atoms_width = (
            int(np.max(np.log10(nz_atoms))) + 9 if nz_atoms.size else 9
        )
    atoms_width = max([atoms_width, 9]) + 1
    atoms_prec = 17 - atoms_width

    with open(fn, "w") as f:
        f.write(file_info.get("comment", "pybader_tpu density\n"))
        f.write(f"{1:0< 10.7f}\n")
        for x, y, z in lattice:
            f.write(f" {x:> {10}.{lattice_prec}f}")
            f.write(f" {y:> {10}.{lattice_prec}f}")
            f.write(f" {z:> {10}.{lattice_prec}f}\n")
        if file_info.get("elements", None) is not None:
            f.write("  ".join(str(e) for e in file_info["elements"]) + "\n")
        f.write(
            "  ".join(np.asarray(file_info["element_nums"]).astype(str)) + "\n"
        )
        f.write("Cartesian\n")
        for x, y, z in atoms:
            f.write(f" {x:> {10}.{atoms_prec}f}")
            f.write(f" {y:> {10}.{atoms_prec}f}")
            f.write(f" {z:> {10}.{atoms_prec}f}\n")
        f.write("\n")
        x, y, z = shape
        if file_info.get("charge_flag", True) and "charge" in density:
            f.write(f" {x:>5} {y:>5} {z:>5}\n")
            _write_block(f, density["charge"] * lattice_vol, output_format,
                         desc=f"{fn}:")
        if file_info.get("spin_flag", False) and "spin" in density:
            f.write(f" {x:>5} {y:>5} {z:>5}\n")
            _write_block(f, density["spin"] * lattice_vol, output_format,
                         desc=f"{fn}:")
