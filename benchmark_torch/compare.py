"""The comparison that decides a run's ``correct``: one timed analysis's
results against the plain reference's, as numbers each held to a limit of
``limits.json``.

- ``volumes_mismatch``, ``atom_volumes_mismatch``: voxels whose Bader
  volume (the partition after refinement) or atom volume differs.
- ``maxima_mismatch``, ``atoms_mismatch``: maxima (fractional places) and
  maxima-to-atom assignments that differ, plus any difference in count.
- ``charge_err``, ``volume_err``: the largest difference of a per-basin,
  per-atom or vacuum charge (or spin, where the analysis sums one)
  (volume), over the largest such reference value.
- ``distance_err``: the largest difference, in Angstrom, of a maximum's
  distance to its atom or of an atom's surface distance (one number: where
  every maximum sits on its atom the first reads 0 at any precision).
- ``text_err``: the largest difference of a number printed in the results
  files, in units of its last printed digit; any other difference in the
  text (a word, a column, a line) reads as infinite.

A number whose arrays differ in shape reads as infinite.
"""
from __future__ import annotations

import json
import os
import re

import numpy as np

LIMITS_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "limits.json")
_NUMBER = re.compile(r"^[-+]?\d+(?:\.(\d+))?$")


def limits() -> dict:
    with open(LIMITS_FILE) as f:
        return json.load(f)


def mismatch(a, b) -> float:
    """Elements (rows, for 2-D arrays) that differ, plus the difference in
    count; infinite where the trailing shapes differ."""
    a, b = np.asarray(a), np.asarray(b)
    if a.shape[1:] != b.shape[1:]:
        return float("inf")
    m = min(len(a), len(b))
    diff = a[:m] != b[:m]
    if diff.ndim > 1:
        diff = diff.reshape(m, -1).any(1)
    return float(diff.sum() + abs(len(a) - len(b)))


def rel_err(pairs) -> float:
    """max |got - want| over max |want|, over the (got, want) pairs."""
    scale, worst = 0.0, 0.0
    for got, want in pairs:
        if got is None:
            return float("inf")
        got, want = np.atleast_1d(got), np.atleast_1d(want)
        if got.shape != want.shape:
            return float("inf")
        if want.size:
            scale = max(scale, float(np.abs(want).max()))
            worst = max(worst, float(np.abs(got - want).max()))
    return worst / scale if scale else worst


def abs_err(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        return float("inf")
    return float(np.abs(got - want).max()) if want.size else 0.0


def text_err(got: str, want: str) -> float:
    """Largest difference of a printed number in units of its last digit;
    infinite where anything but the digits differs."""
    a, b = got.split(), want.split()
    if len(a) != len(b):
        return float("inf")
    worst = 0.0
    for x, y in zip(a, b):
        if x == y:
            continue
        mx, my = _NUMBER.match(x), _NUMBER.match(y)
        if not (mx and my) or len(mx.group(1) or "") != len(my.group(1) or ""):
            return float("inf")
        unit = 10.0 ** -len(mx.group(1) or "")
        worst = max(worst, round(abs(float(x) - float(y)) / unit, 6))
    return worst


def numbers(got: dict, want: dict) -> dict:
    """The compared numbers of one analysis (``got``, the program's
    results) against the reference's (``want``), keys as in
    ``reference.analyse``."""
    out = {}
    if "bader_volumes" in want:
        vols = got.get("bader_volumes")
        out["volumes_mismatch"] = float("inf") if vols is None else mismatch(
            vols.ravel(), want["bader_volumes"].ravel())
    out["atom_volumes_mismatch"] = mismatch(got["atoms_volumes"].ravel(),
                                            want["atoms_volumes"].ravel())
    out["maxima_mismatch"] = mismatch(got["bader_maxima"], want["bader_maxima"])
    out["atoms_mismatch"] = mismatch(got["bader_atoms"], want["bader_atoms"])
    charges = [(got["atoms_charge"], want["atoms_charge"]),
               (got["vacuum_charge"], want["vacuum_charge"])]
    volumes = [(got["atoms_volume"], want["atoms_volume"]),
               (got["vacuum_volume"], want["vacuum_volume"])]
    if "bader_charge" in want:
        charges.append((got.get("bader_charge"), want["bader_charge"]))
        volumes.append((got.get("bader_volume"), want["bader_volume"]))
    for key in ("atoms_spin", "bader_spin"):
        if key in want:
            charges.append((got.get(key), want[key]))
    out["charge_err"] = rel_err(charges)
    out["volume_err"] = rel_err(volumes)
    out["distance_err"] = max(
        abs_err(got["bader_distance"], want["bader_distance"]),
        abs_err(got["atoms_surface_distance"], want["atoms_surface_distance"]))
    text = text_err(got["text_atoms"], want["text_atoms"])
    if "text_volumes" in want:
        text = max(text, text_err(got.get("text_volumes", ""),
                                  want["text_volumes"]))
    out["text_err"] = text
    return out


def worst(readings) -> dict:
    """Per number, the largest over several analyses' readings."""
    out = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, v), v)
    return out


def within(values: dict, lim: dict) -> bool:
    """Every number at or under its limit (a number with no limit fails)."""
    return all(k in lim and v <= lim[k] for k, v in values.items())
