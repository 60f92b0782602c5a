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


def _pinned_blocks(n, bk):
    """The port's and JAX's pinned padded shard blocks of ``bk`` on an
    n-shard virtual mesh (the port's layout: shards in C order over the
    sharded axes, a frozen ring of code 13 along them)."""
    from pybader_tpu_torch.parallel import make_mesh
    from pybader_tpu_torch.parallel import mesh as tmesh
    from pybader_tpu_torch.parallel.chase import pin_codes

    lay = tmesh.Layout(make_mesh(n, device="cpu"), bk.shape)
    ours = pin_codes(tmesh.shard(lay, torch.from_numpy(bk)))
    theirs = [np.asarray(jchase._pin_codes(jnp.asarray(b.numpy()), lay.spec))
              for b in tmesh.shard(lay, torch.from_numpy(bk)).blocks]
    return lay, ours, theirs


@pytest.mark.parametrize("n", [2, 4, 8])
def test_chase_roots_plain_on_pinned_shard_blocks(n):
    """The roots of a mesh round: on every pinned padded shard block of the
    n-device virtual mesh, JAX's _local_fixed_point seeded with each
    voxel's own flat index reaches the roots' plain twin."""
    bk, _ = field("random", seed=5)
    lay, ours, theirs = _pinned_blocks(n, bk)
    assert lay.pads
    for block, jblock in zip(ours, theirs):
        np.testing.assert_array_equal(block.numpy(), jblock)
        seed = np.arange(block.numel(), dtype=np.int32).reshape(block.shape)
        want = np.asarray(jchase._local_fixed_point(jnp.asarray(seed),
                                                    jnp.asarray(jblock)))
        got = tchase.chase_roots(block)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        assert (got.numpy() != seed).any()


@pytest.mark.parametrize("pads", [(0, 0), (1, 0), (0, 1), (1, 1)])
def test_chase_gather_plain_matches_chase_plain(pads):
    """values[root], cropped by the pads as it is written, with the change
    count of the interior: the roll-select chase's fixed point and count."""
    bk, vac = field("vacuum", seed=6)
    bk = torch.from_numpy(bk)
    vals = torch.from_numpy(np.random.default_rng(7).integers(
        0, 1 << 20, size=bk.shape).astype(np.int32))
    want, _ = tchase.chase_plain(vals, bk)
    px, py = pads
    crop = (slice(px, bk.shape[0] - px), slice(py, bk.shape[1] - py))
    got, n = tchase.chase_gather(vals, tchase.chase_roots(bk), pads)
    assert got.is_contiguous() and n.dtype == torch.int32
    assert torch.equal(got, want[crop])
    assert int(n) == int((want[crop] != vals[crop]).sum()) > 0
    if pads == (0, 0):
        assert tchase.chase_plain(vals, bk)[1] == int(n)


def test_chase_part_wrappers_reject_cpu_tensors():
    bk, _ = field("random")
    bk = torch.from_numpy(bk)
    with pytest.raises(ValueError, match="CUDA"):
        tchase.chase_roots_cuda(bk)
    with pytest.raises(ValueError, match="CUDA"):
        tchase.chase_gather_cuda(torch.zeros(bk.shape, dtype=torch.int32),
                                 torch.zeros(bk.shape, dtype=torch.int32))
