"""Parity: the port's value chase (``ops/chase.py``, Pallas kernel 9)
against the JAX package's Pallas chase, which runs in TPU interpret mode on
the CPU, and against the two floods that reach the same fixed point.

Tolerance: none.  Labels, maxima counts and roots are integers, fixed by the
step-code graph alone, so they must be identical.  The fields are a
16x16x128 random grid and a 16x8x128 random grid with a vacuum (the
smallest the Pallas kernel tiles, ``block_target=8``); a random field gives
many short basins, so both the flood and the pointer semantics see many
chains that cross the kernel's blocks.
"""
from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from pybader_tpu import grid as jgrid
from pybader_tpu.ops import pallas_chase, scanflood
from pybader_tpu.ops.pointer import resolve_roots as jax_resolve_roots
from pybader_tpu.ops.stencil import ongrid_step_codes, parent_from_step_codes
from pybader_tpu.parallel import chase as jchase
from pybader_tpu_torch.ops import chase as tchase
from pybader_tpu_torch.ops import pointer

torch.set_num_threads(1)

LATTICE = np.diag([8.0, 8.0, 30.0])
FIELDS = {"random": ((16, 16, 128), None), "vacuum": ((16, 8, 128), 0.3)}


@pytest.fixture
def interpret(monkeypatch):
    """Run the Pallas chase in TPU interpret mode (the JAX package is left
    as it is: only this test's view of ``pl.pallas_call`` changes)."""
    monkeypatch.setattr(pallas_chase.pl, "pallas_call", partial(
        pl.pallas_call, interpret=pltpu.InterpretParams()))


def field(name, seed=0):
    """(codes uint8 numpy with vacuum forced to 13, vacuum bool or None)
    of a random density: the JAX exact stencil's codes."""
    shape, vac_q = FIELDS[name]
    rho = np.random.default_rng(seed).random(shape)
    w = tuple(jgrid.distance_weights(LATTICE, shape))
    bk = np.array(ongrid_step_codes(jnp.asarray(rho), w))
    vac = None
    if vac_q is not None:
        vac = rho <= np.quantile(rho, vac_q)
        bk = np.where(vac, 13, bk).astype(np.uint8)
    return bk, vac


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_labels_oneshot_matches_pallas(interpret, name):
    bk, vac = field(name)
    jvac = None if vac is None else jnp.asarray(vac)
    want, n_want = pallas_chase.labels_oneshot(jnp.asarray(bk), jvac,
                                               block_target=8)
    tvac = None if vac is None else torch.from_numpy(vac)
    got, n_got = tchase.labels_oneshot(torch.from_numpy(bk), tvac)
    assert n_got == n_want > 100
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the same labels as both floods
    scan, n_scan = scanflood.labels_scanflood(jnp.asarray(bk), jvac)
    assert int(n_scan) == n_got
    np.testing.assert_array_equal(got.numpy(), np.asarray(scan))
    flood, n_flood = pointer.labels_flood(torch.from_numpy(bk), tvac)
    assert n_flood == n_got
    assert torch.equal(got, flood)


@pytest.mark.parametrize("name", sorted(FIELDS))
def test_resolve_roots_matches_pallas(interpret, name):
    bk, _ = field(name, seed=1)
    parent = parent_from_step_codes(jnp.asarray(bk))
    want = np.asarray(pallas_chase.resolve_roots_pallas(
        parent, jnp.asarray(bk), block_target=8))
    np.testing.assert_array_equal(want, np.asarray(jax_resolve_roots(parent)))
    tparent = torch.from_numpy(np.array(parent))
    codes = tchase.step_code_from_parent(tparent)
    np.testing.assert_array_equal(codes.numpy(), bk)
    for got in (tchase.resolve_roots_chase(tparent, torch.from_numpy(bk)),
                tchase.resolve_roots_chase(tparent),
                pointer.resolve_roots(tparent)):
        np.testing.assert_array_equal(got.numpy(), want)


def test_step_code_from_parent_matches_jax():
    bk, _ = field("random", seed=2)
    parent = parent_from_step_codes(jnp.asarray(bk))
    want = np.asarray(pallas_chase.step_code_from_parent(parent))
    got = tchase.step_code_from_parent(torch.from_numpy(np.array(parent)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("axes", [(0,), (0, 1)])
def test_chase_plain_padded_matches_local_fixed_point(axes):
    """The mesh round's chase: a shard padded with a frozen ring (code 13)
    whose values are a neighbour's, chased to its local fixed point."""
    bk, _ = field("random", seed=3)
    bk = bk[:8]
    rng = np.random.default_rng(4)
    vals = rng.integers(0, 1 << 20, size=bk.shape).astype(np.int32)
    for axis in axes:
        bk = np.moveaxis(bk, axis, 0)
        vals = np.moveaxis(vals, axis, 0)
        ring = np.full((1,) + bk.shape[1:], 13, np.uint8)
        bk = np.concatenate([ring, bk, ring])
        vals = np.concatenate([rng.integers(0, 1 << 20, size=ring.shape),
                               vals, rng.integers(0, 1 << 20,
                                                  size=ring.shape)])
        bk = np.ascontiguousarray(np.moveaxis(bk, 0, axis))
        vals = np.ascontiguousarray(np.moveaxis(vals, 0, axis)).astype(
            np.int32)
    want = np.asarray(jchase._local_fixed_point(jnp.asarray(vals),
                                                jnp.asarray(bk)))
    for fn in (tchase.chase_plain, tchase.chase):
        got, n = fn(torch.from_numpy(vals), torch.from_numpy(bk))
        np.testing.assert_array_equal(got.numpy(), want)
        assert n == int((want != vals).sum()) > 0
