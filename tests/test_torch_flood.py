"""Parity: roots and labels of the port against the JAX pointer doubling
and scan flood.

``pybader_tpu.ops.pointer.resolve_roots`` gives the roots and
``scanflood.labels_scanflood`` the ascending-maximum labels that the
port's pointer jumping (plain version here) must reproduce exactly, on
smooth and on many-basin noise fields.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pybader_tpu import grid as jgrid
from pybader_tpu.ops import pointer as jp
from pybader_tpu.ops import scanflood
from pybader_tpu.ops import stencil as js
from pybader_tpu_torch.ops import pointer as tp
from tests.oracle import gaussian_density

torch.set_num_threads(1)

LATTICE = np.array([[6.0, 0.0, 0.3], [0.2, 5.0, 0.0], [0.0, 0.1, 7.0]])
SHAPE = (16, 14, 12)


def codes_for(seed, vacuum_q=None, noise=False):
    """Step codes of a 5-blob density, or of white noise (hundreds of
    one-voxel-deep basins), with vacuum below a quantile forced to 13."""
    rng = np.random.default_rng(seed)
    if noise:
        rho = rng.random(SHAPE)
    else:
        rho = gaussian_density(SHAPE, LATTICE, rng.uniform(0.1, 0.9, (5, 3)),
                               rng.uniform(0.6, 1.2, 5),
                               rng.uniform(0.5, 2.0, 5))
    w = tuple(jgrid.distance_weights(LATTICE, SHAPE))
    bk = np.array(js.ongrid_step_codes(jnp.asarray(rho), w))
    vac = None
    if vacuum_q is not None:
        vac = rho <= np.quantile(rho, vacuum_q)
        bk = np.where(vac, np.uint8(13), bk)
    return bk, vac


def assert_labels_match_scanflood(bk, vac):
    want, n_want = scanflood.labels_scanflood(
        jnp.asarray(bk), None if vac is None else jnp.asarray(vac))
    got, n_got = tp.labels_flood(
        torch.from_numpy(bk), None if vac is None else torch.from_numpy(vac))
    assert n_got == n_want
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if vac is not None:
        assert (got.numpy()[vac] == -1).all()
    return n_got


@pytest.mark.parametrize("seed", [0, 1])
def test_roots_match_jax_pointer_doubling(seed):
    bk, _ = codes_for(seed)
    parent = np.array(js.parent_from_step_codes(jnp.asarray(bk)))
    want = np.asarray(jp.resolve_roots(jnp.asarray(parent)))
    got = tp.resolve_roots(torch.from_numpy(parent)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("vacuum_q", [None, 0.35])
def test_labels_match_scanflood(vacuum_q):
    assert_labels_match_scanflood(*codes_for(5, vacuum_q))


@pytest.mark.parametrize("vacuum_q", [None, 0.35])
def test_labels_many_basins_match_scanflood(vacuum_q):
    assert assert_labels_match_scanflood(*codes_for(7, vacuum_q,
                                                    noise=True)) > 64


def test_roots_of_a_long_ramp_match_jax():
    """Chains that cross the grid along x: every voxel's root is on the
    last plane, as in the tiled kernel's worst case (a chain through
    every tile)."""
    nx, ny, nz = 40, 6, 8
    idx = np.arange(nx * ny * nz, dtype=np.int32).reshape(nx, ny, nz)
    parent = np.where(idx < (nx - 1) * ny * nz, idx + ny * nz,
                      idx).astype(np.int32)
    want = np.asarray(jp.resolve_roots(jnp.asarray(parent)))
    st = {}
    got = tp.resolve_roots(torch.from_numpy(parent)).numpy()
    tp.resolve_roots_plain(torch.from_numpy(parent), st)
    np.testing.assert_array_equal(got, want)
    assert (got // (ny * nz) == nx - 1).all()
    assert st["passes"] == 7  # ceil(log2(39)) doublings and a check


@pytest.mark.parametrize("shape", [(30001,), (101, 97)])
def test_roots_of_a_flat_parent_match_jax(shape):
    """A parent that is not 3-D (the kernel takes it as one flat row),
    of a length no tile divides: steps of 0-7 voxels forward."""
    rng = np.random.default_rng(3)
    n = int(np.prod(shape))
    step = rng.integers(0, 8, n)
    step[rng.random(n) < 1 / 64] = 0
    parent = np.minimum(np.arange(n) + step, n - 1).astype(np.int32)
    parent = parent.reshape(shape)
    want = np.asarray(jp.resolve_roots(jnp.asarray(parent)))
    got = tp.resolve_roots(torch.from_numpy(parent)).numpy()
    assert got.shape == shape
    np.testing.assert_array_equal(got, want)


def test_root_kernel_wrapper_rejects_cpu_tensor():
    bk, _ = codes_for(0)
    parent = torch.from_numpy(
        np.array(js.parent_from_step_codes(jnp.asarray(bk))))
    with pytest.raises(ValueError, match="CUDA tensor"):
        tp.resolve_roots_cuda(parent)
