"""Parity: the port's per-label reductions, remaps and surface distance.

Each plain version runs on the same seeded inputs as the JAX XLA sweep it
ports and, where the JAX package has one, the Pallas kernel in interpret
mode (as tests/test_pallas_reduce.py runs it).  Tolerances: minima, remaps
and counts exact; charge sums rtol 1e-12 against the f64 XLA path (another
summation order) and 1e-7 against the split-f32 kernel; surface distances
rtol 1e-12 against the f64 compaction path and 1e-5 against the f32 kernel.
Label counts above 256 (the TPU kernels' limit) are covered against XLA.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pybader_tpu.ops import atoms as ja
from pybader_tpu.ops import pallas_reduce as pr
from pybader_tpu.ops import reductions as jr
from pybader_tpu_torch.ops import atoms as ta
from pybader_tpu_torch.ops import reductions as tr

torch.set_num_threads(1)


def labels_and_mask(n, k, seed, p_mask=0.01):
    rng = np.random.default_rng(seed)
    lab = rng.integers(-1, k, size=n).astype(np.int32)
    mask = rng.random(n) < p_mask
    return lab, mask


@pytest.mark.parametrize("n,k", [(13007, 23), (40000, 61)])
def test_min_pair_matches_pallas_and_xla(n, k):
    lab, mask = labels_and_mask(n, k, n)
    mn, mm = tr.min_pair(torch.from_numpy(lab), torch.from_numpy(mask), k)
    pmn, pmm = pr.min_pair(jnp.asarray(lab), jnp.asarray(mask), k,
                           interpret=True)
    xmn, xmm = jr.masked_min_pair(jnp.arange(n, dtype=jnp.int32),
                                  jnp.asarray(lab), jnp.asarray(mask), k)
    for got, want in ((mn, pmn), (mm, pmm), (mn, xmn), (mm, xmm)):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_min_pair_many_labels_matches_xla():
    n, k = 20000, 300
    lab, mask = labels_and_mask(n, k, 1, p_mask=0.05)
    mn, mm = tr.min_pair(torch.from_numpy(lab), torch.from_numpy(mask), k)
    xmn, xmm = jr.masked_min_pair(jnp.arange(n, dtype=jnp.int32),
                                  jnp.asarray(lab), jnp.asarray(mask), k)
    np.testing.assert_array_equal(mn.numpy(), np.asarray(xmn))
    np.testing.assert_array_equal(mm.numpy(), np.asarray(xmm))


def min_pair_case(case, n=13000, k=23):
    """Labels and mask of one min_pair case, made with numpy (seed 5):
    basin-like sorted runs, a change at every voxel, runs at a ragged
    length, or runs with labels -1, K and K + 5 among them; 1 % masked."""
    rng = np.random.default_rng(5)
    if case == "ragged":
        n = 13001
    lengths = rng.integers(1, 200, size=n)
    lab = np.repeat(rng.integers(0, k, size=n), lengths)[:n]
    if case == "every_voxel":
        lab = np.arange(n) % k
    if case == "outside":
        lab = np.where(rng.random(n) < 0.05,
                       rng.choice([-1, k, k + 5], size=n), lab)
    return lab.astype(np.int32), rng.random(n) < 0.01, k


@pytest.mark.parametrize("case", ["runs", "every_voxel", "ragged", "offsets",
                                  "outside"])
def test_min_pair_cases_match_pallas_and_xla(case):
    """The run-start kernel's hard inputs, through the plain version;
    "offsets" hands it label and mask views at storage offsets 1 and 3."""
    lab, mask, k = min_pair_case(case)
    lab_t, mask_t = torch.from_numpy(lab), torch.from_numpy(mask)
    if case == "offsets":
        lab_t = offset_view(lab)
        buf = torch.zeros(mask.size + 3, dtype=torch.bool)
        buf[3:] = mask_t
        mask_t = buf[3:]
        assert (lab_t.storage_offset(), mask_t.storage_offset()) == (1, 3)
    mn, mm = tr.min_pair(lab_t, mask_t, k)
    pmn, pmm = pr.min_pair(jnp.asarray(lab), jnp.asarray(mask), k,
                           interpret=True)
    xmn, xmm = jr.masked_min_pair(jnp.arange(lab.size, dtype=jnp.int32),
                                  jnp.asarray(lab), jnp.asarray(mask), k)
    for got, want in ((mn, pmn), (mm, pmm), (mn, xmn), (mm, xmm)):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (mm.numpy() < np.iinfo(np.int32).max).sum() >= 5


def offset_view(a: np.ndarray) -> torch.Tensor:
    """``a`` as a contiguous tensor view at storage offset 1."""
    buf = torch.empty(a.size + 1, dtype=torch.int32)
    buf[1:] = torch.from_numpy(a.reshape(-1))
    return buf[1:].view(a.shape)


# lengths that are multiples of 4 and ragged ones (30001, 13 * 14 * 15)
@pytest.mark.parametrize("shape,k", [((30000,), 37), ((12, 14, 16), 9),
                                     ((30001,), 37), ((13, 14, 15), 9)])
def test_remap_matches_pallas_and_xla(shape, k):
    rng = np.random.default_rng(7)
    lab = rng.integers(-1, k, size=shape).astype(np.int32)
    table = rng.permutation(k).astype(np.int32)
    got = tr.remap_labels(torch.from_numpy(lab), torch.from_numpy(table), k)
    assert tuple(got.shape) == shape and got.dtype == torch.int32
    want_p = pr.remap(jnp.asarray(lab), jnp.asarray(table), k,
                      interpret=True)
    want_x = jr.remap_sweep(jnp.asarray(lab), jnp.asarray(table), k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_p))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_x))
    assert (got.numpy()[lab < 0] == -1).all()
    view = offset_view(lab)
    assert view.storage_offset() == 1 and view.is_contiguous()
    got_v = tr.remap_labels(view, torch.from_numpy(table), k)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_x))


@pytest.mark.parametrize("offset", [0, 1, 2, 3, 5])
def test_remap_output_shares_the_input_phase(offset):
    """The kernel's output is allocated at the input's offset within 16
    bytes, so both move in 16-byte vectors after the same head."""
    buf = torch.arange(101, dtype=torch.int32)
    lab = buf[offset:offset + 90].view(9, 10)
    out = tr.aligned_like(lab)
    assert out.shape == lab.shape and out.dtype == lab.dtype
    assert out.is_contiguous()
    assert out.data_ptr() % 16 == lab.data_ptr() % 16


def test_remap_many_labels_matches_xla():
    rng = np.random.default_rng(8)
    k = 300
    lab = rng.integers(-1, k, size=20000).astype(np.int32)
    table = rng.permutation(k).astype(np.int32)
    got = tr.remap_labels(torch.from_numpy(lab), torch.from_numpy(table), k)
    want = jr.remap_sweep(jnp.asarray(lab), jnp.asarray(table), k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_relabel_matches_jax():
    rng = np.random.default_rng(9)
    lab = rng.integers(-1, 40, size=(10, 12, 14)).astype(np.int32)
    swap = rng.integers(0, 7, size=40).astype(np.int64)
    got = tr.relabel(torch.from_numpy(lab), torch.from_numpy(swap))
    want = jr.relabel(jnp.asarray(lab), jnp.asarray(swap, dtype=jnp.int32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n,k", [(13007, 23), (1 << 16, 8), (8191, 40)])
def test_charge_volume_matches_xla_and_pallas(n, k):
    rng = np.random.default_rng(n + k)
    lab = rng.integers(-1, k, size=n).astype(np.int32)
    rho = rng.uniform(0.1, 5.0, size=n)
    c, v = tr.charge_volume_sum(torch.from_numpy(rho), torch.from_numpy(lab),
                                0.7, k)
    xc, xv = jr._charge_volume_sum_xla(jnp.asarray(rho), jnp.asarray(lab),
                                       0.7, k)
    pc, pv = pr.charge_volume(jnp.asarray(rho), jnp.asarray(lab), 0.7, k,
                              interpret=True)
    np.testing.assert_allclose(c.numpy(), np.asarray(xc), rtol=1e-12)
    np.testing.assert_array_equal(v.numpy(), np.asarray(xv))
    np.testing.assert_allclose(c.numpy(), np.asarray(pc), rtol=1e-7)
    np.testing.assert_array_equal(v.numpy(), np.asarray(pv))


def test_charge_volume_many_labels_and_empty():
    rng = np.random.default_rng(3)
    n, k = 30000, 400
    lab = rng.integers(-1, k - 50, size=n).astype(np.int32)  # 50 empty
    rho = rng.uniform(0.1, 5.0, size=n)
    c, v = tr.charge_volume_sum(torch.from_numpy(rho), torch.from_numpy(lab),
                                1.3, k)
    xc, xv = jr.charge_volume_sum(jnp.asarray(rho), jnp.asarray(lab), 1.3, k)
    np.testing.assert_allclose(c.numpy(), np.asarray(xc), rtol=1e-12)
    np.testing.assert_array_equal(v.numpy(), np.asarray(xv))
    assert (c.numpy()[k - 50:] == 0).all() and (v.numpy()[k - 50:] == 0).all()


def charge_volume_case(case):
    """(density, labels, k) where the kernel's scalar head and tail and its
    label filter run: labels below -1 and at or past k, a single label,
    a length that is not a multiple of 4 (the label vector's width), and
    contiguous views at storage offsets 1 (labels) and 3 (density)."""
    rng = np.random.default_rng(21)
    n, k = {"out_of_range": (9000, 17), "k1": (7001, 1),
            "ragged": (4 * 2501 + 3, 23), "offset": (6006, 19)}[case]
    lo, hi = (-3, k + 5) if case == "out_of_range" else (-1, k)
    # runs of one label, as a basin's extent along z gives them
    lab = np.repeat(rng.integers(lo, hi, size=n // 7 + 1), 7)[:n]
    lab = lab.astype(np.int32)
    rho = rng.uniform(0.1, 5.0, size=n)
    lab_t, rho_t = torch.from_numpy(lab), torch.from_numpy(rho)
    if case == "offset":
        lab_t = offset_view(lab)
        buf = torch.empty(n + 3, dtype=torch.float64)
        buf[3:] = rho_t
        rho_t = buf[3:]
        assert rho_t.storage_offset() == 3 and rho_t.is_contiguous()
    return rho_t, lab_t, k


@pytest.mark.parametrize("case", ["out_of_range", "k1", "ragged",
                                  "offset"])
def test_charge_volume_edge_cases_match_xla_and_pallas(case):
    rho, lab, k = charge_volume_case(case)
    c, v = tr.charge_volume_sum(rho, lab, 0.7, k)
    rho_j, lab_j = jnp.asarray(rho.numpy()), jnp.asarray(lab.numpy())
    xc, xv = jr._charge_volume_sum_xla(rho_j, lab_j, 0.7, k)
    pc, pv = pr.charge_volume(rho_j, lab_j, 0.7, k, interpret=True)
    np.testing.assert_allclose(c.numpy(), np.asarray(xc), rtol=1e-12)
    np.testing.assert_array_equal(v.numpy(), np.asarray(xv))
    np.testing.assert_allclose(c.numpy(), np.asarray(pc), rtol=1e-7)
    np.testing.assert_array_equal(v.numpy(), np.asarray(pv))
    labels = lab.numpy()
    keep = (labels >= 0) & (labels < k)
    np.testing.assert_allclose(v.numpy().sum(), 0.7 * keep.sum(),
                               rtol=1e-12)
    if case == "out_of_range":
        assert (labels < -1).any() and (labels >= k).any()


def test_vacuum_mask_matches_jax():
    rng = np.random.default_rng(5)
    ref = rng.uniform(0.0, 1.0, size=(9, 10, 11))
    den = rng.uniform(0.0, 2.0, size=(9, 10, 11))
    mask, vc, vv = tr.vacuum_mask(torch.from_numpy(ref), 0.3,
                                  torch.from_numpy(den), 0.25)
    jm, jvc, jvv = jr.vacuum_mask(jnp.asarray(ref), 0.3, jnp.asarray(den),
                                  0.25)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jm))
    np.testing.assert_allclose(vc, float(jvc), rtol=1e-12)
    assert vv == float(jvv)


def _surface_inputs(seed, shape, n_atoms, p_edge=0.2):
    rng = np.random.default_rng(seed)
    lattice = np.array([[6.0, 0.3, 0.0], [0.0, 5.5, 0.2], [0.1, 0.0, 5.0]])
    labels = rng.integers(-1, n_atoms, size=shape).astype(np.int32)
    mask = rng.random(shape) < p_edge
    atoms_cart = rng.random((n_atoms, 3)) @ lattice
    return labels, mask, lattice, atoms_cart


def _port_distance(labels, mask, lattice, atoms_cart, n_atoms):
    return ta.surface_distance_masked(
        torch.from_numpy(labels), torch.from_numpy(mask),
        torch.from_numpy(lattice), torch.from_numpy(atoms_cart),
        n_atoms).numpy()


@pytest.mark.parametrize("shape,n_atoms", [((12, 10, 16), 5),
                                           ((14, 13, 12), 300)])
def test_surface_distance_matches_f64_compaction_path(shape, n_atoms):
    labels, mask, lattice, atoms_cart = _surface_inputs(7, shape, n_atoms)
    got = _port_distance(labels, mask, lattice, atoms_cart, n_atoms)
    # the JAX CPU route: edge compaction + surface_distance_from_edges
    want = np.asarray(ja.surface_distance_masked(
        jnp.asarray(labels), jnp.asarray(mask), lattice, atoms_cart,
        n_atoms))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0.0)


def test_surface_distance_matches_f32_kernel():
    labels, mask, lattice, atoms_cart = _surface_inputs(7, (12, 10, 16), 5)
    got = _port_distance(labels, mask, lattice, atoms_cart, 5)
    d2 = pr.surface_min_d2(jnp.asarray(labels), jnp.asarray(mask),
                           jnp.asarray(lattice), jnp.asarray(atoms_cart),
                           (12, 10, 16), 5, interpret=True)
    want = np.asarray(jnp.where(jnp.isfinite(d2), jnp.sqrt(d2), 0.0))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-6)


def test_surface_distance_atom_without_edges_is_zero():
    shape = (8, 8, 16)
    labels = np.zeros(shape, np.int32)
    labels[4:] = 1
    mask = labels == 0  # only atom 0 has edge voxels
    lattice = np.diag([4.0, 4.0, 4.0])
    atoms_cart = np.array([[1.1, 1.1, 1.1], [3.0, 3.0, 3.0]])
    d2 = ta.surface_min_d2(torch.from_numpy(labels), torch.from_numpy(mask),
                           torch.from_numpy(lattice),
                           torch.from_numpy(atoms_cart), 2)
    assert np.isfinite(float(d2[0])) and np.isinf(float(d2[1]))
    got = _port_distance(labels, mask, lattice, atoms_cart, 2)
    assert got[1] == 0.0 and got[0] > 0.0


@pytest.mark.parametrize("n_atoms", [64, 65])
def test_surface_distance_many_atoms_and_outside_labels_match_jax(n_atoms):
    # many atoms, with labels -1 and n_atoms (both outside [0, n_atoms))
    # among the edge voxels: both are skipped
    shape = (10, 12, 21)
    labels, mask, lattice, atoms_cart = _surface_inputs(9, shape, n_atoms,
                                                        p_edge=0.5)
    rng = np.random.default_rng(10)
    labels[rng.random(shape) < 0.1] = n_atoms
    assert ((labels == -1) & mask).any() and ((labels == n_atoms) & mask).any()
    got = _port_distance(labels, mask, lattice, atoms_cart, n_atoms)
    want = np.asarray(ja.surface_distance_masked(
        jnp.asarray(labels), jnp.asarray(mask), lattice, atoms_cart,
        n_atoms))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0.0)
    assert (got > 0).sum() > n_atoms // 2


def test_surface_distance_of_a_shard_matches_jax():
    # a mesh shard's voxels sit at a nonzero origin of the whole grid and
    # take their positions from it (x / nx of the grid, in float32 as JAX
    # computes it): the shard's edges alone, through the whole grid in JAX
    shape, (ox, oy) = (12, 14, 10), (6, 7)
    labels, mask, lattice, atoms_cart = _surface_inputs(11, shape, 7)
    local = (slice(ox, None), slice(oy, None))
    outside = np.ones(shape, bool)
    outside[local] = False
    want = np.asarray(ja.surface_distance_masked(
        jnp.asarray(labels), jnp.asarray(mask & ~outside), lattice,
        atoms_cart, 7))
    d2 = ta.surface_min_d2(
        torch.from_numpy(np.ascontiguousarray(labels[local])),
        torch.from_numpy(np.ascontiguousarray(mask[local])),
        torch.from_numpy(lattice), torch.from_numpy(atoms_cart), 7,
        origin=(ox, oy, 0), shape=shape).numpy()
    got = np.where(np.isfinite(d2), np.sqrt(d2), 0.0)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0.0)
    assert np.isfinite(d2).sum() >= 5


@pytest.mark.parametrize("name", ["min_pair", "remap_labels",
                                  "charge_volume", "surface_min_d2"])
def test_kernel_wrappers_reject_cpu_tensors(name):
    lab = torch.zeros((4, 4, 4), dtype=torch.int32)
    mask = torch.zeros((4, 4, 4), dtype=torch.bool)
    calls = {
        "min_pair": lambda: tr.min_pair_cuda(lab, mask, 2),
        "remap_labels": lambda: tr.remap_labels_cuda(
            lab, torch.zeros(2, dtype=torch.int32), 2),
        "charge_volume": lambda: tr.charge_volume_cuda(
            torch.zeros((4, 4, 4), dtype=torch.float64), lab, 2),
        "surface_min_d2": lambda: ta.surface_min_d2_cuda(
            lab, mask, torch.eye(3, dtype=torch.float64),
            torch.zeros((2, 3), dtype=torch.float64), 2),
    }
    with pytest.raises(ValueError, match="CUDA tensor"):
        calls[name]()
