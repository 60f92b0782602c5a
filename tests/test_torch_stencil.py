"""Parity: the port's ascent stencil against the JAX exact-f64 stencil.

The same numpy densities go through ``pybader_tpu.ops.stencil`` (exact f64
XLA path, as on the CPU) and the port's plain PyTorch version; step codes
and decoded parents must be identical, ties included.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pybader_tpu import grid as jgrid
from pybader_tpu import pipeline as jpipe
from pybader_tpu.ops import stencil as js
from pybader_tpu_torch import pipeline as tpipe
from pybader_tpu_torch.ops import stencil as ts
from tests.oracle import gaussian_density

torch.set_num_threads(1)

LATTICE = np.array([[6.0, 0.0, 0.3], [0.2, 5.0, 0.0], [0.0, 0.1, 7.0]])
SHAPE = (16, 14, 12)


def make_density(seed, shape=SHAPE, n_blobs=4):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0.1, 0.9, size=(n_blobs, 3))
    widths = rng.uniform(0.6, 1.2, size=n_blobs)
    amps = rng.uniform(0.5, 2.0, size=n_blobs)
    return gaussian_density(shape, LATTICE, centers, widths, amps) + 1e-6


def _codes_both(rho):
    w = tuple(jgrid.distance_weights(LATTICE, rho.shape))
    want = np.asarray(js.ongrid_step_codes(jnp.asarray(rho), w))
    got = ts.ongrid_step_codes(torch.from_numpy(rho), w).numpy()
    return got, want


@pytest.mark.parametrize("seed", [0, 1])
def test_step_codes_match_jax(seed):
    got, want = _codes_both(make_density(seed))
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert (got == 13).sum() >= 1


def test_step_codes_tie_heavy_density():
    # quantised to 1/8: most candidates tie, so the strict-> scan order
    # (OFFSETS) decides every code
    rho = np.round(make_density(2) * 8.0) / 8.0
    got, want = _codes_both(rho)
    np.testing.assert_array_equal(got, want)
    assert (got == 13).sum() > 10  # plateaus: many self steps


def test_parent_from_step_codes_matches_jax():
    got, _ = _codes_both(make_density(3))
    want = np.asarray(js.parent_from_step_codes(jnp.asarray(got)))
    par = ts.parent_from_step_codes(torch.from_numpy(got)).numpy()
    assert par.dtype == np.int32
    np.testing.assert_array_equal(par, want)


def test_vacuum_forced_to_self_step():
    rho = make_density(4)
    vac = rho <= np.quantile(rho, 0.3)
    w = tuple(jgrid.distance_weights(LATTICE, SHAPE))
    _, want = jpipe._parent_and_codes(jnp.asarray(rho), jnp.asarray(vac), w,
                                      exact_stencil=True)
    got = tpipe.step_codes(torch.from_numpy(rho), torch.from_numpy(vac), w)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy()[vac] == 13).all()


def test_kernel_wrapper_rejects_cpu_tensor():
    rho = torch.from_numpy(make_density(0))
    w = tuple(jgrid.distance_weights(LATTICE, SHAPE))
    with pytest.raises(ValueError, match="CUDA tensor"):
        ts.ongrid_step_codes_cuda(rho, w)


@pytest.mark.parametrize("shape", [(9, 13, 37), (1, 5, 33), (2, 2, 40)])
def test_step_codes_ragged_shapes_match_jax(shape):
    # shapes the kernel's 8x32 column tiles and 64-plane marches cut
    # raggedly; an axis of 1 or 2 wraps onto the voxel itself
    got, want = _codes_both(make_density(6, shape))
    np.testing.assert_array_equal(got, want)


def test_step_codes_negative_density_matches_jax():
    rho = make_density(7)
    rho = rho - rho.mean()
    assert (rho < 0).mean() > 0.3
    got, want = _codes_both(rho)
    np.testing.assert_array_equal(got, want)


def _hard_density(kind):
    rng = np.random.default_rng(8)
    if kind == "tie-heavy":
        return np.round(make_density(2) * 4.0) / 4.0
    if kind == "negative":
        return np.round(make_density(3) * 8.0) / 8.0 - 1.0
    rho = make_density(4)  # +inf, -inf and a plateau of each
    rho[rng.random(SHAPE) < 0.05] = np.inf
    rho[rng.random(SHAPE) < 0.05] = -np.inf
    rho[2:4, 2:4, 2:4] = np.inf
    rho[8:10, 8:10, 8:10] = -np.inf
    return rho


@pytest.mark.parametrize("kind", ["tie-heavy", "negative", "infinite"])
def test_step_codes_hard_densities_match_jax(kind):
    # ties at 1/4 and 1/8, a quantised negative field, and +-inf (whose
    # differences give NaN, which fails every strict test)
    with np.errstate(invalid="ignore"):
        got, want = _codes_both(_hard_density(kind))
    np.testing.assert_array_equal(got, want)
    assert (got != 13).any()
