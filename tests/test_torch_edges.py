"""Parity: the port's edge classification with ``is_max`` against the JAX
XLA stencils (``_edge_find_xla`` / ``_edge_check_xla``) and the Pallas
kernels in interpret mode, with and without vacuum.  The ``known`` grids
must be identical."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pybader_tpu import grid as jgrid
from pybader_tpu import pipeline as jpipe
from pybader_tpu.ops import edges as jedges
from pybader_tpu.ops import pallas_edges
from pybader_tpu.ops.stencil import ongrid_step_codes
from pybader_tpu_torch.ops import edges as tedges
from tests.oracle import gaussian_density

torch.set_num_threads(1)

LAT = np.diag([8.0, 9.0, 10.0])


def setup(shape, seed, vac_q=None):
    """Density, ongrid labels and the stencil's is_max, as refinement has
    them (vacuum forced to the self step and excluded from is_max)."""
    rng = np.random.default_rng(seed)
    rho = gaussian_density(
        shape, LAT, rng.random((6, 3)), 0.5 + rng.random(6),
        1 + 2 * rng.random(6)) + 1e-9
    w = tuple(jgrid.distance_weights(LAT, shape))
    vac = None if vac_q is None else rho <= np.quantile(rho, vac_q)
    labels, _ = jpipe.partition_ongrid(rho, vac, w)
    bk = np.asarray(ongrid_step_codes(jnp.asarray(rho), w))
    is_max = bk == 13
    if vac is not None:
        is_max &= ~vac
    return rho, np.array(labels), is_max


def perturbed(known, labels, seed):
    """One refinement iteration's known dance: some edges drop to -1
    (unchanged) and some edge voxels take another basin's label."""
    rng = np.random.default_rng(seed)
    ed = known == -2
    kn = np.where((rng.random(known.shape) < 0.5) & ed, -1,
                  known).astype(np.int8)
    lab = labels.copy()
    sel = (rng.random(known.shape) < 0.1) & ed
    lab[sel] = (lab[sel] + 1) % int(lab.max() + 1)
    return kn, lab


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("vac_q", [None, 0.25])
def test_edge_find_is_max_matches_xla(vac_q):
    rho, labels, is_max = setup((16, 14, 12), 0, vac_q)
    want = np.asarray(jedges._edge_find_xla(
        jnp.asarray(rho), jnp.asarray(labels), jnp.asarray(is_max)))
    got = tedges.edge_find(t(rho), t(labels), t(is_max)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got == -2).any() and (got == -1).any()
    if vac_q is not None:
        assert (got == 0).any()


@pytest.mark.parametrize("vac_q", [None, 0.3])
def test_edge_check_matches_xla(vac_q):
    rho, labels, is_max = setup((16, 14, 12), 1, vac_q)
    known = np.asarray(jedges._edge_find_xla(
        jnp.asarray(rho), jnp.asarray(labels), jnp.asarray(is_max)))
    kn, lab = perturbed(known, labels, 2)
    want = np.asarray(jedges._edge_check_xla(
        jnp.asarray(kn), jnp.asarray(rho), jnp.asarray(lab),
        jnp.asarray(is_max)))
    got = tedges.edge_check(t(kn), t(lab), t(is_max)).numpy()
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, kn)


def test_edge_find_matches_pallas_interpret():
    rho, labels, is_max = setup((8, 32, 128), 3, 0.25)
    want = np.asarray(pallas_edges.edge_find(
        jnp.asarray(labels), jnp.asarray(is_max), interpret=True))
    got = tedges.edge_find(t(rho), t(labels), t(is_max)).numpy()
    np.testing.assert_array_equal(got, want)


def test_edge_check_matches_pallas_interpret():
    rho, labels, is_max = setup((8, 32, 128), 4, 0.3)
    known = tedges.edge_find(t(rho), t(labels), t(is_max)).numpy()
    kn, lab = perturbed(known, labels, 5)
    want = np.asarray(pallas_edges.edge_check(
        jnp.asarray(kn), jnp.asarray(lab), jnp.asarray(is_max),
        interpret=True))
    got = tedges.edge_check(t(kn), t(lab), t(is_max)).numpy()
    np.testing.assert_array_equal(got, want)


def test_edge_find_without_is_max_matches_xla():
    """The surface-distance stage's route: is_max from the density."""
    rho, labels, _ = setup((16, 14, 12), 6, 0.2)
    want = np.asarray(jedges._edge_find_xla(jnp.asarray(rho),
                                            jnp.asarray(labels)))
    got = tedges.edge_find(t(rho), t(labels)).numpy()
    np.testing.assert_array_equal(got, want)


def test_kernel_wrappers_reject_cpu_tensors():
    rho, labels, is_max = setup((16, 14, 12), 0)
    known = tedges.edge_find(t(rho), t(labels), t(is_max))
    with pytest.raises(ValueError, match="CUDA tensor"):
        tedges.edge_find_cuda(t(labels), t(is_max))
    with pytest.raises(ValueError, match="CUDA tensor"):
        tedges.edge_check_cuda(known, t(labels), t(is_max))


def sparse_known(known, seed):
    """known with six changed edges only, four of them on a periodic
    boundary face; every other edge becomes -1."""
    nx, ny, nz = known.shape
    kn = np.where(known == -2, -1, known).astype(np.int8)
    rng = np.random.default_rng(seed)
    x, y, z = (int(v) for v in rng.integers(1, (nx - 1, ny - 1, nz - 1)))
    for p in [(0, y, z), (x, ny - 1, z), (x, y, 0), (nx - 1, 0, nz - 1),
              (x, y, z), (x // 2, y // 2, z // 2)]:
        kn[p] = -2
    return kn


@pytest.mark.parametrize("case", ["sparse", "x2", "y2"])
def test_edge_check_hard_cases_match_xla_and_pallas(case):
    """The cases a tiled kernel can get wrong: a few -2 voxels, some on a
    periodic face (tiles with no -2 in reach keep known), and an axis of
    extent 2, where the 2-voxel halo wraps onto the grid itself."""
    shape = {"sparse": (8, 32, 128), "x2": (2, 32, 128),
             "y2": (8, 2, 128)}[case]
    rho, labels, is_max = setup(shape, 7, 0.2)
    known = tedges.edge_find(t(rho), t(labels), t(is_max)).numpy()
    if case == "sparse":
        kn, lab = sparse_known(known, 8), labels
    else:
        kn, lab = perturbed(known, labels, 9)
    got = tedges.edge_check(t(kn), t(lab), t(is_max)).numpy()
    want = np.asarray(jedges._edge_check_xla(
        jnp.asarray(kn), jnp.asarray(rho), jnp.asarray(lab),
        jnp.asarray(is_max)))
    np.testing.assert_array_equal(got, want)
    want = np.asarray(pallas_edges.edge_check(
        jnp.asarray(kn), jnp.asarray(lab), jnp.asarray(is_max),
        interpret=True))
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, kn)
    if case == "sparse":
        # far from the six edges known stays as it was
        assert (got == kn).mean() > 0.9


@pytest.mark.parametrize("case", ["sparse", "perturbed"])
def test_check_reads_is_all_edge_check_reads(case):
    """Labels and is_max outside ``check_reads``' masks do not change
    edge_check's output, and the masks hold what the definition says."""
    rho, labels, is_max = setup((8, 12, 16), 11, 0.2)
    known = tedges.edge_find(t(rho), t(labels), t(is_max)).numpy()
    kn, lab = ((sparse_known(known, 12), labels) if case == "sparse"
               else perturbed(known, labels, 13))
    lab_read, max_read = (m.numpy() for m in tedges.check_reads(t(kn),
                                                                t(lab)))
    want = tedges.edge_check(t(kn), t(lab), t(is_max)).numpy()
    rng = np.random.default_rng(14)
    scrambled = np.where(lab_read, lab, rng.integers(
        -1, lab.max() + 2, lab.shape)).astype(np.int32)
    flipped = np.where(max_read, is_max, rng.random(is_max.shape) < 0.5)
    got = tedges.edge_check(t(kn), t(scrambled), t(flipped)).numpy()
    np.testing.assert_array_equal(got, want)
    # brute force: Chebyshev distance on the periodic grid
    pts = np.argwhere(kn == -2)
    idx = np.indices(kn.shape).reshape(3, -1).T
    ext = np.asarray(kn.shape)
    d = np.abs(idx[:, None, :] - pts[None, :, :])
    dist = np.minimum(d, ext - d).max(axis=2).min(axis=1).reshape(kn.shape)
    cand = (dist <= 1) & (lab != -1)
    near_cand = tedges._box_reduce(t(cand), torch.logical_or).numpy()
    np.testing.assert_array_equal(lab_read, (dist <= 1) | near_cand)
    assert lab_read.sum() < lab.size and (dist <= 2)[lab_read].all()
    np.testing.assert_array_equal(
        max_read, cand & tedges._is_edge(t(lab)).numpy())


def test_check_tiles_active_marks_reach_of_two():
    known = np.full((16, 16, 64), 2, np.int8)
    known[0, 0, 0] = -2
    active = tedges.check_tiles_active(t(known)).numpy()
    assert active.shape == (2, 2, 2)
    # a -2 at the origin reaches 2 voxels across every periodic face
    assert active.all()
    known = np.full((16, 16, 64), 2, np.int8)
    known[4, 4, 16] = -2
    active = tedges.check_tiles_active(t(known)).numpy()
    assert active.sum() == 1 and active[0, 0, 0]


def find_case(case):
    """labels, is_max and the density of edge_find's hard inputs: axes of
    extent 2, a grid that is no multiple of the 8x8x32 tile, one label
    with vacuum blocks (its tiles hold one label: the skipped case), a
    many-label noise grid and 25 % vacuum."""
    if case in ("x2", "y2", "ragged", "vacuum25"):
        shape = {"x2": (2, 32, 128), "y2": (8, 2, 128),
                 "ragged": (14, 19, 45), "vacuum25": (8, 32, 128)}[case]
        return setup(shape, 15, 0.25 if case == "vacuum25" else None)
    rng = np.random.default_rng(16)
    if case == "noise":
        rho = rng.random((10, 12, 40))
        w = tuple(jgrid.distance_weights(LAT, rho.shape))
        labels, _ = jpipe.partition_ongrid(rho, None, w)
        is_max = np.asarray(ongrid_step_codes(jnp.asarray(rho), w)) == 13
        return rho, np.array(labels), is_max
    # one label, vacuum in two blocks; every voxel its own maximum or not
    shape = (16, 24, 96)
    labels = np.zeros(shape, np.int32)
    labels[2:6, 3:11, 10:40] = -1
    labels[9:16, 17:24, 70:96] = -1
    rho = rng.random(shape)
    return rho, labels, rng.random(shape) < 0.1


@pytest.mark.parametrize("case", ["x2", "y2", "ragged", "uniform", "noise",
                                  "vacuum25"])
def test_edge_find_hard_cases_match_xla_and_pallas(case):
    rho, labels, is_max = find_case(case)
    got = tedges.edge_find(t(rho), t(labels), t(is_max)).numpy()
    want = np.asarray(jedges._edge_find_xla(
        jnp.asarray(rho), jnp.asarray(labels), jnp.asarray(is_max)))
    np.testing.assert_array_equal(got, want)
    want = np.asarray(pallas_edges.edge_find(
        jnp.asarray(labels), jnp.asarray(is_max), interpret=True))
    np.testing.assert_array_equal(got, want)
    if case == "uniform":
        assert not (got < 0).any() and (got == 0).any()
    else:
        assert (got == -2).any()


@pytest.mark.parametrize("case", ["x2", "ragged", "uniform", "noise",
                                  "vacuum25"])
def test_find_tiles_active_matches_brute_force(case):
    """A tile is active where some z-row of the tile grown by 1 has 3x3
    neighbour rows whose labels over the tile's z-range grown by 2
    (periodic) hold two non-vacuum values; an inactive tile has no -2 or
    -1 inside."""
    _, labels, is_max = find_case(case)
    active = tedges.find_tiles_active(t(labels)).numpy()
    ext = np.asarray(labels.shape)
    tiles = -(-ext // np.asarray(tedges.CHECK_TILE))
    assert active.shape == tuple(tiles)
    known = tedges.edge_find_plain(t(labels), t(is_max)).numpy()
    for tile in np.ndindex(*tiles):
        lo = np.asarray(tile) * tedges.CHECK_TILE
        hi = np.minimum(lo + tedges.CHECK_TILE, ext)
        zs = np.arange(lo[2] - 2, hi[2] + 2) % ext[2]
        want = False
        for x in range(lo[0] - 1, hi[0] + 1):
            for y in range(lo[1] - 1, hi[1] + 1):
                idx = np.ix_(np.arange(x - 1, x + 2) % ext[0],
                             np.arange(y - 1, y + 2) % ext[1], zs)
                want |= len(set(np.unique(labels[idx])) - {-1}) > 1
        assert active[tile] == want, tile
        if not want:
            inner = known[tuple(slice(a, b) for a, b in zip(lo, hi))]
            assert (inner >= 0).all()
    if case == "uniform":
        assert not active.any()
    elif case == "noise":
        assert active.all()


@pytest.mark.parametrize("case", ["ragged", "vacuum25"])
def test_find_reads_is_all_edge_find_reads(case):
    """is_max outside ``find_reads`` does not change edge_find's output,
    and the mask holds the non-vacuum voxels with another label in their
    box."""
    rho, labels, is_max = find_case(case)
    read = tedges.find_reads(t(labels)).numpy()
    want = tedges.edge_find(t(rho), t(labels), t(is_max)).numpy()
    rng = np.random.default_rng(17)
    flipped = np.where(read, is_max, rng.random(is_max.shape) < 0.5)
    got = tedges.edge_find(t(rho), t(labels), t(flipped)).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < read.sum() < read.size
    np.testing.assert_array_equal(
        read, (labels != -1) & tedges._is_edge(t(labels)).numpy())
