"""Plain PyTorch reference of one Bader analysis, the yardstick of the
benchmark's ``correct``.

A straightforward implementation of pybader's analysis as the port's
``Bader.__call__`` runs it on one device, in plain ``torch`` operations on
any device: no kernels, no carry between calls, no padded buckets.  It
imports nothing of the program under test and takes nothing it made; it is
a frozen copy of the plain semantics the port's CPU parity tests hold to the
JAX package, so a later change to the program cannot move it.

``analyse(density, lattice, atoms, profile, dtype=torch.float64)`` returns
every result a timed analysis produces.  ``dtype=torch.float32`` computes
the same analysis one precision lower: the benchmark's control.

Semantics (pybader v0.3.12 profiles, the port's ``pipeline.py``):
- ongrid ascent: each voxel steps to the first of its 26 neighbours (in
  OFFSETS order) whose ``(rho_n - rho_p) * w + rho_p`` strictly exceeds
  every earlier candidate and ``rho_p``; maxima step to themselves.
- labels: the maxima a voxel's chain of steps reaches, numbered in
  discovery order (ascending first member in flat order).
- neargrid: trajectories along the transformed central-difference
  gradient with the rounded remainder ``dr``, falling back to the ongrid
  step on a flat gradient or a revisit of the last five positions; lanes
  still walking at the step cap end on their ongrid root.  Grids of at
  most 2^24 voxels walk every voxel; larger grids take the ongrid
  partition and refine its edges ('changed', 3 per 128 voxels of extent),
  chained into the profile's own refinement.
- refinement: walk the edge voxels, take the label of the end point,
  then re-examine the neighbourhoods of the voxels that changed.
- atoms: each maximum goes to its nearest atom over the 27 periodic
  images; the surface distance is each atom's nearest edge voxel of its
  own volume.
"""
from __future__ import annotations

import numpy as np
import pandas as pd
import torch

OFFSETS = tuple((ix, iy, iz) for ix in (-1, 0, 1) for iy in (-1, 0, 1)
                for iz in (-1, 0, 1))
SELF = 13
ONGRID, MAX = 1, 2
HYBRID_THRESHOLD = 1 << 24
ITERS_PER_128 = 3
INT32_MAX = 2 ** 31 - 1


# ------------------------------------------------------------- geometry
def voxel_lattice(lattice, shape):
    return np.divide(lattice, np.asarray(shape, dtype=np.float64)[:, None])


def lattice_volume(lattice):
    return float(abs(np.dot(lattice[0], np.cross(lattice[1], lattice[2]))))


def distance_weights(lattice, shape):
    """1 / |step| for each offset, 0 for the null step."""
    vl = voxel_lattice(lattice, shape)
    w = np.zeros(len(OFFSETS))
    for k, (ix, iy, iz) in enumerate(OFFSETS):
        v = ix * vl[0] + iy * vl[1] + iz * vl[2]
        n = np.sqrt(np.dot(v, v))
        w[k] = 0.0 if n == 0.0 else 1.0 / n
    return w


def t_grad(lattice, shape):
    inv_l = np.linalg.inv(voxel_lattice(lattice, shape))
    return np.matmul(inv_l.T, inv_l)


def initial_cap(shape):
    return 2 * sum(shape) + 64


def refine_cap(shape):
    return 192 if max(shape) <= 384 else 96 + max(shape) // 2


# ------------------------------------------------------------ partition
def step_codes(rho, weights, vacuum=None):
    """uint8 ascent codes (13: a maximum); vacuum voxels never move."""
    best_val = rho
    best_k = torch.full(rho.shape, SELF, dtype=torch.uint8, device=rho.device)
    for k, (ox, oy, oz) in enumerate(OFFSETS):
        if k == SELF:
            continue
        rolled = torch.roll(rho, shifts=(-ox, -oy, -oz), dims=(0, 1, 2))
        val = (rolled - rho) * float(weights[k]) + rho
        upd = val > best_val
        best_val = torch.where(upd, val, best_val)
        best_k = torch.where(upd, torch.tensor(k, dtype=torch.uint8,
                                               device=rho.device), best_k)
    if vacuum is not None:
        best_k = torch.where(vacuum, torch.tensor(SELF, dtype=torch.uint8,
                                                  device=rho.device), best_k)
    return best_k


def parents(codes):
    """Flat int64 index of each voxel's ascent step (periodic)."""
    nx, ny, nz = codes.shape
    dev = codes.device
    c = codes.long()
    x = torch.arange(nx, device=dev).view(-1, 1, 1)
    y = torch.arange(ny, device=dev).view(1, -1, 1)
    z = torch.arange(nz, device=dev).view(1, 1, -1)
    px = torch.remainder(x + c // 9 - 1, nx)
    py = torch.remainder(y + (c // 3) % 3 - 1, ny)
    pz = torch.remainder(z + c % 3 - 1, nz)
    return ((px * ny + py) * nz + pz).reshape(-1)


def roots(parent):
    """Fixed point of each chain, by pointer doubling."""
    p = parent
    while True:
        p2 = p[p]
        if torch.equal(p2, p):
            return p
        p = p2


def renumber(labels_mo, is_max, n_max):
    """Labels numbered by ascending maximum -> discovery order (ascending
    first member); returns (labels int32 grid, maxima (M, 3) voxel
    indices)."""
    _, ny, nz = labels_mo.shape
    lab = labels_mo.reshape(-1).long()
    valid = (lab >= 0) & (lab < n_max)
    iota = torch.arange(lab.numel(), device=lab.device)
    first = []
    for keep in (valid, valid & is_max.reshape(-1)):
        m = torch.full((n_max,), INT32_MAX, dtype=torch.int64,
                       device=lab.device)
        m.scatter_reduce_(0, lab[keep], iota[keep], "amin")
        first.append(m)
    order = np.argsort(first[0].cpu().numpy(), kind="stable")
    rank = torch.as_tensor(np.argsort(order, kind="stable"),
                           device=lab.device)
    out = torch.where(lab >= 0, rank[lab.clamp(0, n_max - 1)], lab)
    max_flat = first[1].cpu().numpy()[order]
    maxima = np.stack([max_flat // (ny * nz), (max_flat // nz) % ny,
                       max_flat % nz], axis=1).astype(np.int64)
    return out.to(torch.int32).reshape(labels_mo.shape), maxima


def partition_ongrid(rho, vacuum, weights):
    codes = step_codes(rho, weights, vacuum)
    root = roots(parents(codes))
    is_max = (codes == SELF).reshape(-1)
    if vacuum is not None:
        is_max &= ~vacuum.reshape(-1)
    rank = torch.cumsum(is_max, 0) - 1
    labels = torch.where(is_max[root], rank[root], -1).reshape(rho.shape)
    n_max = max(int(is_max.sum()), 1)
    return renumber(labels, is_max.reshape(rho.shape), n_max)


def label_from_roots(end, vacuum, shape):
    """Labels from each voxel's end point: the count of maxima below it
    (-1 past the last), renumbered; vacuum -1."""
    iota = torch.arange(end.numel(), device=end.device)
    is_max = end == iota
    if vacuum is not None:
        is_max &= ~vacuum.reshape(-1)
    n_max = int(is_max.sum())
    lab = (torch.cumsum(is_max, 0) - is_max.long())[end]
    lab = torch.where(lab < n_max, lab, -1)
    if vacuum is not None:
        lab = torch.where(vacuum.reshape(-1), -1, lab)
    lab = lab.reshape(shape)
    if n_max == 0:
        return lab.to(torch.int32), np.zeros((0, 3), dtype=np.int64)
    return renumber(lab, is_max.reshape(shape), n_max)


# ----------------------------------------------------------------- walk
def rows(rho, codes, tg, strict):
    """Per voxel: the inf-normalised transformed gradient (N, 3), the
    ongrid parent and the flags (ONGRID: max |gd| < 1e-14; MAX: the parent
    is the voxel itself)."""
    t = [[float(v) for v in r] for r in tg]
    n = rho.numel()
    gd = [torch.zeros(n, dtype=rho.dtype, device=rho.device)
          for _ in range(3)]
    for j in range(3):
        up = torch.roll(rho, -1, j)
        dn = torch.roll(rho, 1, j)
        flat = ((up < rho) & (dn < rho)) if strict else \
            ((up <= rho) & (dn <= rho))
        g = torch.where(flat, 0.0, (up - dn) * 0.5).reshape(-1)
        for i in range(3):
            gd[i] = gd[i] + t[i][j] * g
    mg = torch.maximum(torch.maximum(gd[0].abs(), gd[1].abs()), gd[2].abs())
    denom = torch.where(mg > 0, mg, 1.0)
    grad = torch.stack([g / denom for g in gd], 1)
    parent = parents(codes)
    iota = torch.arange(n, device=rho.device)
    flags = torch.where(mg < 1e-14, ONGRID, 0) | \
        torch.where(parent == iota, MAX, 0)
    return grad, parent, flags


def _round_away(x):
    return torch.trunc(x + torch.where(x > 0, 0.5, -0.5)).long()


def walk(grad, parent, flags, starts, shape, cap, stop=None, stats=None):
    """One trajectory from each start (-1: a padding lane, done at voxel
    0).  A lane ends on a maximum or a ``stop`` voxel; one still walking
    after ``cap`` steps reports done False.  ``stats`` receives
    ``lane_steps`` and ``rows_touched`` (distinct voxels read)."""
    nx, ny, nz = shape
    dev = grad.device
    dims = torch.tensor([nx, ny, nz], device=dev)
    starts = starts.reshape(-1).long()
    out_pos = starts.clamp(min=0)
    out_done = starts < 0
    lane = torch.nonzero(~out_done).reshape(-1)
    pos = out_pos[lane]
    k = lane.numel()
    prev = torch.full((k,), -1, dtype=torch.long, device=dev)
    hist = torch.full((k, 3), -1, dtype=torch.long, device=dev)
    dr = torch.zeros((k, 3), dtype=grad.dtype, device=dev)
    touched = None if stats is None else torch.zeros(
        grad.shape[0], dtype=torch.bool, device=dev)
    lane_steps = 0
    for step in range(cap + 1):
        if touched is not None:
            touched[pos] = True
        term = (flags[pos] & MAX) != 0
        if stop is not None:
            term |= stop[pos]
        if bool(term.any()):
            out_pos[lane[term]] = pos[term]
            out_done[lane[term]] = True
            keep = ~term
            lane, pos, prev = lane[keep], pos[keep], prev[keep]
            hist, dr = hist[keep], dr[keep]
        if step == cap or lane.numel() == 0:
            break
        lane_steps += lane.numel()
        g = grad[pos]
        xyz = torch.stack([pos // (ny * nz), (pos // nz) % ny, pos % nz], 1)
        int_grad = _round_away(g)
        dr_new = (dr + g) - int_grad
        int_dr = _round_away(dr_new)
        t = torch.remainder(xyz + int_grad + int_dr, dims)
        nxt = (t[:, 0] * ny + t[:, 1]) * nz + t[:, 2]
        ongrid = (flags[pos] & ONGRID) != 0
        nxt = torch.where(ongrid, parent[pos], nxt)
        revisit = (nxt == pos) | (nxt == prev) | (nxt[:, None] == hist).any(1)
        nxt = torch.where(revisit, parent[pos], nxt)
        dr = torch.where((ongrid | revisit)[:, None], 0.0, dr_new - int_dr)
        hist = torch.cat([prev[:, None], hist[:, :2]], 1)
        prev, pos = pos, nxt
    out_pos[lane] = pos
    if stats is not None:
        stats["lane_steps"] = lane_steps
        stats["rows_touched"] = int(touched.sum())
    return out_pos, out_done


# ---------------------------------------------------------------- edges
def box(a, combine, axes=(0, 1, 2)):
    """Periodic 3-wide reduction along each axis: the 3x3x3 box."""
    for axis in axes:
        a = combine(combine(a, torch.roll(a, 1, axis)), torch.roll(a, -1, axis))
    return a


def is_edge(labels):
    """Some non-vacuum neighbour carries another label."""
    vac = labels == -1
    lmax = box(torch.where(vac, -INT32_MAX, labels), torch.maximum)
    lmin = box(torch.where(vac, INT32_MAX, labels), torch.minimum)
    return lmax != lmin


def edge_find(labels, is_max):
    """int8 known grid: -2 edge, -1 beside one, 2 interior, 0 vacuum."""
    nonvac = labels != -1
    edge = nonvac & is_edge(labels) & ~is_max
    near = box(edge, torch.logical_or) & ~edge
    known = torch.where(nonvac, 2, 0)
    known = torch.where(near, -1, known)
    return torch.where(edge, -2, known).to(torch.int8)


def edge_check(known, labels, is_max):
    """Re-examine the neighbourhoods of the changed voxels (-2)."""
    cand = box(known == -2, torch.logical_or) & (labels != -1)
    edge = is_edge(labels)
    new_edge = cand & edge & ~is_max
    out = torch.where(cand & ~edge, -1, known).to(torch.int8)
    out = torch.where(new_edge, -2, out).to(torch.int8)
    near_new = box(new_edge, torch.logical_or) & (out >= 0)
    return torch.where(near_new, -1, out).to(torch.int8)


def local_max(rho, labels):
    rmax = box(torch.where(labels == -1, float("-inf"), rho), torch.maximum)
    return rmax == rho


def refine(rho, labels, weights, tg, iters):
    """'changed' neargrid refinement of ``labels`` (int32 grid), at most
    ``iters`` iterations, stopping when nothing changes."""
    shape = tuple(rho.shape)
    labels = labels.to(torch.int32).clone()
    vac = labels == -1
    codes = step_codes(rho, weights, vac)
    is_max = (codes == SELF) & ~vac
    known = edge_find(labels, is_max)
    grad, parent, flags = rows(rho, codes, tg, True)
    root = None
    lab = labels.view(-1)
    for it in range(iters):
        starts = torch.nonzero(known.reshape(-1) == -2).reshape(-1)
        if starts.numel() == 0:
            break
        pos, done = walk(grad, parent, flags, starts, shape,
                         refine_cap(shape), known.reshape(-1) == 2)
        if not bool(done.all()):
            root = roots(parent) if root is None else root
            pos = torch.where(done, pos, root[pos])
        new = lab[pos]
        changed = new != lab[starts]
        lab[starts] = new
        known.view(-1)[starts] = torch.where(changed, -2, -1).to(torch.int8)
        if not bool(changed.any()) or it + 1 == iters:
            break
        known = edge_check(known, labels, is_max)
    return labels


def partition_neargrid(rho, vacuum, weights, tg, refine_iters):
    """Every voxel's trajectory up to 2^24 voxels; above, the ongrid
    partition refined for its budget plus the profile's ``refine_iters``
    (the port chains the two).  returns (labels, maxima, iterations of
    the profile's refinement still to run)."""
    shape = tuple(rho.shape)
    if rho.numel() > HYBRID_THRESHOLD:
        labels, maxima = partition_ongrid(rho, vacuum, weights)
        budget = ITERS_PER_128 * max(1, -(-max(shape) // 128))
        return refine(rho, labels, weights, tg, budget + refine_iters), \
            maxima, 0
    codes = step_codes(rho, weights, vacuum)
    grad, parent, flags = rows(rho, codes, tg, False)
    starts = torch.arange(rho.numel(), device=rho.device)
    pos, done = walk(grad, parent, flags, starts, shape, initial_cap(shape))
    del grad, flags
    if not bool(done.all()):
        pos = torch.where(done, pos, roots(parent)[pos])
    labels, maxima = label_from_roots(pos, vacuum, shape)
    return labels, maxima, refine_iters


# ---------------------------------------------------------------- atoms
def image_shifts(lattice):
    combos = torch.tensor(
        [(x, y, z) for x in (-1, 0, 1) for y in (-1, 0, 1) for z in (-1, 0, 1)],
        dtype=lattice.dtype, device=lattice.device)
    return combos @ lattice


def assign_to_atoms(maxima_cart, atoms, lattice):
    """Nearest atom (27 images, ties to the lowest index) and distance."""
    delta = (maxima_cart[:, None, None, :]
             - (atoms[None, :, None, :] + image_shifts(lattice)[None, None]))
    d2 = torch.amin(torch.sum(delta * delta, dim=-1), dim=-1)
    atom = torch.argmin(d2, dim=-1)
    return atom, torch.sqrt(torch.gather(d2, 1, atom[:, None])[:, 0])


def frac32(i, n):
    """i / n as the port computes it: f32, a multiply by 1/n in f32."""
    return i.to(torch.float32) * (torch.tensor(1.0, dtype=torch.float32) / n)


def surface_distance(labels, edge_mask, lattice, atoms, n_atoms, chunk=1 << 21):
    """Distance from each atom to the nearest edge voxel of its own volume
    over 27 images; 0 where it has none."""
    nx, ny, nz = labels.shape
    shifts = image_shifts(lattice)
    lab_flat = labels.reshape(-1)
    idx_all = torch.nonzero(edge_mask.reshape(-1)).reshape(-1)
    out = torch.full((n_atoms + 1,), float("inf"), dtype=lattice.dtype,
                     device=labels.device)
    for lo in range(0, idx_all.numel(), chunk):
        idx = idx_all[lo:lo + chunk]
        frac = torch.stack([frac32(idx // (ny * nz), nx),
                            frac32((idx // nz) % ny, ny),
                            frac32(idx % nz, nz)], -1).to(lattice.dtype)
        pc = frac @ lattice
        lab = lab_flat[idx].long()
        own = atoms[lab.clamp(0, n_atoms - 1)]
        delta = pc[:, None, :] - (own[:, None, :] + shifts[None])
        d2 = torch.amin(torch.sum(delta * delta, dim=-1), dim=-1)
        seg = torch.where((lab >= 0) & (lab < n_atoms), lab, n_atoms)
        out.scatter_reduce_(0, seg, d2, "amin")
    d2 = out[:n_atoms]
    return torch.where(torch.isfinite(d2), torch.sqrt(d2), 0.0)


def sums(density, labels, n, voxel_vol):
    """Per label in [0, n): (charge, volume), each times the voxel
    volume."""
    lab = labels.reshape(-1).long()
    keep = (lab >= 0) & (lab < n)
    charge = torch.zeros(n, dtype=density.dtype, device=density.device)
    charge.index_add_(0, lab[keep], density.reshape(-1)[keep])
    count = torch.bincount(lab[keep], minlength=n)
    return (charge * voxel_vol).cpu().numpy(), \
        (count.to(density.dtype) * voxel_vol).cpu().numpy()


def small_dtype(count):
    """The smallest signed integer type for labels -1 .. count - 1 (as
    pybader stores them)."""
    for name, limit in (("int8", 127), ("int16", 32767), ("int32", INT32_MAX)):
        if count <= limit:
            return name
    return "int64"


# -------------------------------------------------------------- results
def results_text(r, volume_flag):
    """The fixed-width table pybader writes to ``*-atoms.dat`` (and, with
    ``volume_flag``, ``*-volumes.dat``)."""
    n_atoms = r["atoms_frac"].shape[0]
    cols = {k: pd.Series(r["atoms_frac"][:, i]) for i, k in enumerate("abc")}
    cols["Charge"] = pd.Series(r["atoms_charge"])
    if "atoms_spin" in r:
        cols["Spin"] = pd.Series(r["atoms_spin"])
    cols["Volume"] = pd.Series(r["atoms_volume"])
    cols["Distance"] = pd.Series(r["atoms_surface_distance"])
    if "bader_charge" in r:
        extra = {"a": r["bader_maxima"][:, 0], "b": r["bader_maxima"][:, 1],
                 "c": r["bader_maxima"][:, 2], "Charge": r["bader_charge"],
                 "Spin": r.get("bader_spin"), "Volume": r["bader_volume"],
                 "Distance": r["bader_distance"]}
        for k in cols:
            cols[k] = pd.concat([cols[k], pd.Series(extra[k])],
                                ignore_index=False)
    df = pd.DataFrame(cols)
    if volume_flag:
        df = df[n_atoms:]
        if r["bader_volume_tol"] is not None:
            df = df[df["Charge"] > r["bader_volume_tol"]]
    else:
        df = df[:n_atoms]
    lines = [" " + line + "\n" for line in df.to_string(
        float_format="{:.6f}".format, justify="center").split("\n")]
    lines.insert(1, "-" * len(lines[0]) + "\n")
    lines.append("-" * len(lines[0]) + "\n")
    tot = df["Charge"].sum()
    width = int(np.log10(np.abs(tot)) + 8) if tot else 8
    footer = ""
    if r["vacuum_tol"] is not None:
        vac = [r["vacuum_charge"], r["vacuum_volume"]]
        with np.errstate(divide="ignore"):
            logs = np.log10(np.abs([v for v in vac if v != 0] or [1]))
        width = max(width, int(np.max(logs)) + 8)
        footer = (f" Vacuum Charge:{r['vacuum_charge']:>{width + 6}.4f}\n"
                  f" Vacuum Volume:{r['vacuum_volume']:>{width + 6}.4f}\n")
    footer += f" Number of Electrons:{tot:>{width}.4f}"
    return "".join(lines) + footer


# ------------------------------------------------------------- analysis
def analyse(fields, lattice, atoms, profile, device="cpu",
            dtype=torch.float64):
    """One Bader analysis of the host grids ``fields`` ({"charge"[,
    "spin"]}, f64 numpy; the charge is analysed, or the spin where there
    is no charge).

    ``profile``: the configuration's keys (``method``, ``refine_mode``,
    ``vacuum_tol``, ``bader_volume_tol``, ``speed_flag``, and
    ``spin_flag``: the spin's sums too).  returns a dict of numpy results
    and the two result texts (``text_atoms``, and ``text_volumes`` unless
    ``speed_flag``)."""
    density = fields["charge"] if fields.get("charge") is not None \
        else fields["spin"]
    spin = fields.get("spin") if profile.get("spin_flag") else None
    shape = density.shape
    lattice = np.asarray(lattice, dtype=np.float64)
    atoms = np.asarray(atoms, dtype=np.float64)
    voxel_vol = lattice_volume(lattice) / float(np.prod(shape))
    weights = distance_weights(lattice, shape)
    tg = t_grad(lattice, shape)
    if dtype != torch.float64:
        weights = weights.astype(np.float32)
        tg = tg.astype(np.float32)
    rho = torch.as_tensor(density, device=device).to(dtype)
    if spin is not None:
        spin = torch.as_tensor(spin, device=device).to(dtype)
    mode, iters = profile["refine_mode"]
    if mode != "changed" or profile["refine_method"] != "neargrid":
        raise ValueError(f"unsupported refinement {profile['refine_mode']}")
    r = {"vacuum_tol": profile["vacuum_tol"],
         "bader_volume_tol": profile["bader_volume_tol"],
         "vacuum_charge": 0.0, "vacuum_volume": 0.0,
         "atoms_frac": atoms @ np.linalg.inv(lattice)}
    vacuum = None
    if profile["vacuum_tol"] is not None:
        vacuum = rho <= profile["vacuum_tol"]
        r["vacuum_charge"] = float(torch.where(vacuum, rho, 0.0).sum()) \
            * voxel_vol
        r["vacuum_volume"] = int(vacuum.sum()) * voxel_vol
    if profile["method"] == "neargrid":
        labels, maxima, left = partition_neargrid(rho, vacuum, weights, tg,
                                                  iters)
    elif profile["method"] == "ongrid":
        labels, maxima = partition_ongrid(rho, vacuum, weights)
        left = iters
    else:
        raise ValueError(f"unknown method {profile['method']}")
    if not profile["speed_flag"] and left:
        labels = refine(rho, labels, weights, tg, left)
    r["bader_maxima"] = maxima / np.asarray(shape, dtype=np.float64)
    n_max = maxima.shape[0]
    maxima_cart = torch.as_tensor(r["bader_maxima"] @ lattice, device=device)
    atoms_t = torch.as_tensor(atoms, device=device)
    lat_t = torch.as_tensor(lattice, device=device)
    if dtype != torch.float64:
        maxima_cart, atoms_t, lat_t = (
            t.to(dtype) for t in (maxima_cart, atoms_t, lat_t))
    if not profile["speed_flag"]:
        r["bader_volumes"] = labels.cpu().numpy().astype(small_dtype(n_max))
        r["bader_charge"], r["bader_volume"] = sums(rho, labels, n_max,
                                                    voxel_vol)
        if spin is not None:
            r["bader_spin"] = sums(spin, labels, n_max, voxel_vol)[0]
    atom, dist = assign_to_atoms(maxima_cart, atoms_t, lat_t)
    r["bader_atoms"] = atom.cpu().numpy()
    r["bader_distance"] = dist.cpu().numpy()
    atom_labels = torch.where(labels >= 0, atom.to(torch.int32)[
        labels.long().clamp(min=0)], labels)
    n_atoms = atoms.shape[0]
    if profile["speed_flag"] and iters:
        atom_labels = refine(rho, atom_labels, weights, tg, iters)
    r["atoms_volumes"] = atom_labels.cpu().numpy().astype(
        small_dtype(n_atoms))
    edge = edge_find(atom_labels, local_max(rho, atom_labels)) == -2
    r["atoms_surface_distance"] = surface_distance(
        atom_labels, edge, lat_t, atoms_t, n_atoms).cpu().numpy()
    r["atoms_charge"], r["atoms_volume"] = sums(rho, atom_labels, n_atoms,
                                                voxel_vol)
    if spin is not None:
        r["atoms_spin"] = sums(spin, atom_labels, n_atoms, voxel_vol)[0]
    r["text_atoms"] = results_text(r, False)
    if not profile["speed_flag"]:
        r["text_volumes"] = results_text(r, True)
    return r
