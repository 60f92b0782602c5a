"""Parity: the port's ongrid partition against the JAX package and the
clean-room serial oracle (labels and maxima identical), with and without
vacuum and on a many-basin noise field; past 4096 maxima the port matches
the JAX roots-compaction numbering; refinement skips unknown methods and
zero iterations."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pybader_tpu import grid as jgrid
from pybader_tpu import pipeline as jpipe
from pybader_tpu_torch import pipeline as tpipe
from tests.oracle import gaussian_density, ongrid_oracle, ongrid_oracle_fast

torch.set_num_threads(1)

LATTICE = np.array([[6.0, 0.0, 0.3], [0.2, 5.0, 0.0], [0.0, 0.1, 7.0]])
SHAPE = (16, 14, 12)


def make_density(seed, shape=SHAPE, n_blobs=4):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0.1, 0.9, size=(n_blobs, 3))
    widths = rng.uniform(0.6, 1.2, size=n_blobs)
    amps = rng.uniform(0.5, 2.0, size=n_blobs)
    return gaussian_density(shape, LATTICE, centers, widths, amps) + 1e-6


def both(rho, vac=None):
    w = tuple(jgrid.distance_weights(LATTICE, rho.shape))
    jl, jm = jpipe.partition_ongrid(rho, vac, w)
    tl, tm = tpipe.partition_ongrid(
        torch.from_numpy(rho), None if vac is None else torch.from_numpy(vac),
        w)
    assert tl.dtype == torch.int32 and tm.dtype == np.int64
    return tl.numpy(), tm, np.asarray(jl), np.asarray(jm), w


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_partition_matches_jax_and_oracle(seed):
    rho = make_density(seed)
    tl, tm, jl, jm, w = both(rho)
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(tm, jm)
    ol, om = ongrid_oracle(rho, w)
    np.testing.assert_array_equal(tl, ol)
    np.testing.assert_array_equal(tm, np.array(om))


def test_partition_with_vacuum_matches_jax_and_oracle():
    rho = make_density(3)
    vac = rho <= np.quantile(rho, 0.3)
    tl, tm, jl, jm, w = both(rho, vac)
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(tm, jm)
    ol, om = ongrid_oracle(rho, w, vacuum=vac)
    np.testing.assert_array_equal(tl, ol)
    assert (tl[vac] == -1).all() and (tl[~vac] >= 0).all()
    assert len(tm) == len(om)


def noise_field(shape=(20, 20, 20)):
    return np.random.default_rng(11).random(shape)


def test_partition_many_basins_matches_jax_and_oracle():
    rho = noise_field()
    tl, tm, jl, jm, w = both(rho)
    assert len(tm) > 256  # past the TPU kernels' label limit
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(tm, jm)
    ol, om = ongrid_oracle_fast(rho, w)
    np.testing.assert_array_equal(tl, ol)
    np.testing.assert_array_equal(tm, np.array(om))


@pytest.mark.parametrize("vacuum_q", [None, 0.2])
def test_both_numbering_paths_agree(vacuum_q):
    """Past 4096 maxima the JAX partition numbers basins by roots
    compaction (pointer.label_volumes) instead of the per-label renumber;
    the port renumbers at every label count and gives the same labels."""
    rho = np.random.default_rng(12).random((64, 48, 48))
    vac = None if vacuum_q is None else rho <= np.quantile(rho, vacuum_q)
    w = tuple(jgrid.distance_weights(LATTICE, rho.shape))
    jl, jm = jpipe._partition_ongrid_tpu(
        jnp.asarray(rho), None if vac is None else jnp.asarray(vac), w)
    tl, tm = tpipe.partition_ongrid(
        torch.from_numpy(rho), None if vac is None else torch.from_numpy(vac),
        w)
    assert len(jm) > 4096
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tm, jm)


@pytest.mark.parametrize("method,mode", [
    ("neargrid", ("changed", 0)),
    ("ongrid", ("changed", 2)),
])
def test_refine_labels_skips_unknown_method_and_zero_iters(method, mode):
    labels = np.zeros((4, 4, 4), np.int32)
    out, changed = tpipe.refine_labels(method, mode, None, labels, None, None)
    assert out is labels and changed == 0
