"""Gaussian / CP2K cube density reader and writer.

A copy of :mod:`pybader_tpu.io.cube`.  Format parity with the reference
pybader reader (io/cube.py):
units converted bohr -> Angstrom and e/bohr^3 -> e/Angstrom^3, half-voxel
offset, multi-``nval`` (molecular orbital) handling via the ``orbitals``
kwarg: iterable -> sum of selected orbitals, int > 0 -> that orbital,
int < 0 -> raw 4-D array [nval, nx, ny, nz], 0 -> sum of all (or first
value when the atom-count indicator is positive).
"""
from __future__ import annotations

import os
from time import time

import numpy as np

from pybader_tpu_torch.utils import fortran_format, parse_float_block, python_format

__extensions__ = [".cube"]
__args__ = ["orbitals"]

bohr_to_ang = 0.52917721067
ang_to_bohr = 1 / bohr_to_ang


def read(fn, orbitals=0):
    """Read a cube file -> (density, lattice, atoms, file_info)."""
    t0 = time()
    density = {}
    prefix, filename = os.path.split(fn)
    prefix = os.path.join(prefix, "")
    with open(fn, "r") as f:
        print(f"  Reading {f.name} as cube format.")
        _ = f.readline()
        _ = f.readline()
        line = f.readline().split()
        atom_sum = int(line[0])
        if len(line) > 4:
            nval = int(line[4])
        else:
            nval = 1
        grid = np.zeros(3, dtype=np.int64)
        lattice = np.zeros((3, 3), dtype=np.float64)
        for i in range(3):
            line = f.readline().split()
            grid[i] = int(line[0])
            lattice[i] = line[1:4]
            lattice[i] *= grid[i]
        print(f"  {' x '.join(grid.astype(str))} grid size.")
        atom_types = np.zeros(abs(atom_sum), dtype=np.int64)
        atoms = np.zeros((abs(atom_sum), 3), dtype=np.float64)
        for i in range(abs(atom_sum)):
            line = f.readline().split()
            atom_types[i] = int(line[0])
            atoms[i] = line[-3:]
        # wrap atoms into the cell
        atoms = np.dot(atoms, np.linalg.inv(lattice))
        atoms %= 1
        atoms = np.dot(atoms, lattice)
        dset_ids = None
        if atom_sum < 0:
            line = f.readline().split()
            dset_ids = np.zeros(int(line.pop(0)), dtype=np.int64)
            count = 0
            while count < dset_ids.shape[0]:
                for m in line:
                    dset_ids[count] = int(m)
                    count += 1
                if count < dset_ids.shape[0]:
                    line = f.readline().split()
            nval = dset_ids.shape[0]
        nx, ny, nz = (int(v) for v in grid)
        total = nx * ny * nz * nval
        vals = parse_float_block(f.read(), total)
        print(f"  File {f.name} closed. ", end="")
    charge = vals.reshape(nx, ny, nz * nval)
    if nval > 1:
        charge = charge.reshape(nx, ny, nz, nval)
        ids = list(dset_ids) if dset_ids is not None else list(range(1, nval + 1))
        if hasattr(orbitals, "__iter__"):
            sel = [ids.index(int(m)) for m in orbitals]
            density["charge"] = charge[..., sel].sum(axis=-1)
        elif orbitals < 0:
            density["charge"] = np.moveaxis(charge, -1, 0)
        elif orbitals > 0:
            density["charge"] = np.ascontiguousarray(
                charge[..., ids.index(int(orbitals))]
            )
        elif atom_sum > 0:
            density["charge"] = np.ascontiguousarray(charge[..., 0])
        else:
            density["charge"] = charge.sum(axis=-1)
    else:
        density["charge"] = charge
    print(f"Time taken: {time() - t0:0.3f}s", end="\n\n")
    lattice = lattice * bohr_to_ang
    atoms = atoms * bohr_to_ang
    density["charge"] = density["charge"] * ang_to_bohr**3
    file_info = {
        "filename": filename,
        "prefix": prefix,
        "file_type": "cube",
        "write_function": write,
        "elements": atom_types,
        "voxel_offset": np.array([0.5, 0.5, 0.5]),
    }
    return density, lattice, atoms, file_info


def write(fn, atoms, lattice, density, file_info, prefix=None, suffix=".cube"):
    """Write a cube-style charge density (Angstrom -> bohr on output)."""
    if prefix is not None:
        fn = prefix + fn
    fn += suffix
    ff = file_info.get("fortran_format", 0)
    if ff == 2:
        output_format = fortran_format
    elif ff == 1:
        def output_format(a, p):
            return python_format(a, p, " ")
    else:
        output_format = python_format
    charge = density["charge"] * bohr_to_ang**3
    atoms_b = atoms * ang_to_bohr
    lattice_b = lattice * ang_to_bohr / np.asarray(charge.shape)[:, None]

    nzl = np.abs(lattice_b[lattice_b != 0])
    lattice_width = max(int(np.max(np.log10(nzl))) + 9, 9) + 1 if nzl.size else 10
    lattice_prec = 17 - lattice_width
    nza = np.abs(atoms_b[atoms_b != 0])
    atoms_width = max(int(np.max(np.log10(nza))) + 9, 9) + 1 if nza.size else 10
    atoms_prec = 17 - atoms_width

    buffer_size = charge.shape[2] // 6
    buffer_rem = charge.shape[2] % 6
    with open(fn, "w") as f:
        f.write("Cube file written by pybader_tpu\n")
        f.write(file_info.get("comment", "density\n"))
        f.write(f"{atoms_b.shape[0]:>5}{'  0.0000000' * 3}\n")
        for i, lat in enumerate(lattice_b):
            x, y, z = lat
            f.write(f"{charge.shape[i]:>5}")
            f.write(f" {x:> {10}.{lattice_prec}f}")
            f.write(f" {y:> {10}.{lattice_prec}f}")
            f.write(f" {z:> {10}.{lattice_prec}f}\n")
        for i, atom in enumerate(atoms_b):
            x, y, z = atom
            f.write(f"{file_info['elements'][i]:>5}")
            f.write("  0.0000000")
            f.write(f" {x:> {10}.{atoms_prec}f}")
            f.write(f" {y:> {10}.{atoms_prec}f}")
            f.write(f" {z:> {10}.{atoms_prec}f}\n")
        nz = charge.shape[2]
        mode = {0: 0, 1: 1, 2: 2}[ff if ff in (0, 1, 2) else 0]
        for i in range(charge.shape[0]):
            # fast path: format a whole x-plane natively, every z-row an
            # independent line group (row_len) — per-row Python formatting
            # costs ~0.5 ms/row and dominates large cube exports otherwise
            try:
                from pybader_tpu_torch.io._fastparse import format_floats

                f.write(format_floats(
                    np.ascontiguousarray(charge[i]), 6, mode, 5,
                    row_len=nz))
                continue
            except Exception:
                pass
            for j in range(charge.shape[1]):
                row = charge[i, j]
                out = output_format(
                    row[: buffer_size * 6].reshape(buffer_size, 6), 5
                )
                if buffer_rem:
                    out += output_format(
                        row[-buffer_rem:].reshape(1, buffer_rem), 5
                    )
                f.write(out)
