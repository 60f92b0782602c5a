"""Parity: the port's quantised walk rows and q walkers against the JAX
package.

Tolerance: none.  The q-rows are integer words and must equal
``precompute_qrows`` word for word; the walks run in f32 with every op
rounded on its own in both packages, so the whole walk state (positions,
the revisit window, done, f32 ``dr`` and ``err`` bit for bit, risky) must
be identical.  The walkers are fed JAX's own q-rows; JAX bakes the stop set
into the sign bit, the port reads it from ``known == 2``.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pybader_tpu import grid as jgrid
from pybader_tpu import pipeline as jpipe
from pybader_tpu.ops import edges as jedges
from pybader_tpu.ops import neargrid as jng
from pybader_tpu_torch.ops import neargrid as tng
from tests import test_block_walk as big
from tests.test_torch_pipeline import LATTICE, SHAPE, make_density

torch.set_num_threads(1)


def setup(rho, lattice, strict_grad=True):
    """JAX's q-rows (no stop bits) and the known grid of refinement's first
    scan on the ongrid labels."""
    shape = rho.shape
    w = tuple(jgrid.distance_weights(lattice, shape))
    tg = jgrid.t_grad(lattice, shape)
    _, bk = jpipe._parent_and_codes(jnp.asarray(rho), None, w)
    q = np.array(jng.precompute_qrows(jnp.asarray(rho), bk, jnp.asarray(tg),
                                      strict_grad))
    labels, _ = jpipe.partition_ongrid(rho, None, w)
    known = np.array(jedges.edge_find(jnp.asarray(rho), labels))
    return q, known, np.asarray(bk), tg


def fields(kind):
    if kind == "small":
        return make_density(2), LATTICE
    return big.make_density(0), big.LATTICE


def assert_state_equal(jax_state, port_state):
    for i, (a, b) in enumerate(zip(jax_state, port_state)):
        a, b = np.asarray(a), b.numpy()
        if a.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        np.testing.assert_array_equal(b, a, err_msg=f"state field {i}")


@pytest.mark.parametrize("kind", ["small", "big"])
@pytest.mark.parametrize("strict_grad", [False, True])
def test_qrows_match_jax(kind, strict_grad):
    rho, lattice = fields(kind)
    q, _, bk, tg = setup(rho, lattice, strict_grad)
    tq = tng.neargrid_qrows(torch.from_numpy(rho), torch.from_numpy(bk), tg,
                            strict_grad)
    assert tq.dtype == torch.int32
    np.testing.assert_array_equal(tq.numpy(), q)
    assert ((q[:, 1] >> 25) & 31 == 13).any()


@pytest.mark.parametrize("screened", [False, True])
@pytest.mark.parametrize("cap", [192, 3])
def test_q_walker_matches_jax_walk_drain(screened, cap):
    """Every edge voxel of the 32x32x128 field walks JAX's q-rows with the
    known == 2 stop set; a cap of 3 leaves many lanes walking."""
    rho, lattice = fields("big")
    q, known, _, tg = setup(rho, lattice)
    shape = rho.shape
    starts = np.flatnonzero(known.reshape(-1) == -2).astype(np.int32)
    padded = jng.pad_starts(starts)
    baked = jng.update_stop_q(jnp.asarray(q),
                              jnp.asarray(known.reshape(-1) == 2))
    want = jng.walk_drain(jnp.asarray(padded), None, None, None,
                          jnp.asarray(tg), shape, strict_grad=True,
                          max_steps=cap, fields=baked, screened=screened)
    got = tng.walk_q(torch.from_numpy(q), torch.from_numpy(padded), shape,
                     cap, torch.from_numpy(known), screened=screened)
    assert_state_equal(want, got)
    if cap == 3:
        assert (~got[1]).sum() > 0
    if screened and cap == 192:
        assert got[2].sum() > 0  # the screen fires on this field


@pytest.mark.parametrize("screened", [False, True])
def test_q_walker_resumes_from_jax_state(screened):
    """The port walker picks up JAX's state after a few steps and reaches
    JAX's state after the rest, every field bit for bit."""
    rho, lattice = fields("big")
    q, known, _, _ = setup(rho, lattice)
    shape = rho.shape
    starts = np.flatnonzero(known.reshape(-1) == -2).astype(np.int32)
    baked = jng.update_stop_q(jnp.asarray(q),
                              jnp.asarray(known.reshape(-1) == 2))
    seg = jng._walk_segment_qs if screened else jng._walk_segment_q
    state = jng._init_state(jnp.asarray(jng.pad_starts(starts)), jnp.float32,
                            screened=screened)
    mid = seg(state, baked, shape, 5)
    end = seg(mid, baked, shape, 40)
    got = tng.neargrid_walk_q(
        torch.from_numpy(q),
        tuple(torch.from_numpy(np.array(a)) for a in mid), shape, 40,
        torch.from_numpy(known))
    assert_state_equal(end, got)
    assert (~got[4]).sum() < (~np.asarray(mid[4])).sum()


@pytest.mark.parametrize("screened", [False, True])
def test_q_walker_on_done_and_padding_lanes_matches_jax(screened):
    """A walk whose lanes have all ended (in an earlier walk, or as
    padding) moves nothing, as JAX's segment does not."""
    rho, lattice = fields("big")
    q, known, _, _ = setup(rho, lattice)
    shape = rho.shape
    starts = np.flatnonzero(known.reshape(-1) == -2).astype(np.int32)
    baked = jng.update_stop_q(jnp.asarray(q),
                              jnp.asarray(known.reshape(-1) == 2))
    seg = jng._walk_segment_qs if screened else jng._walk_segment_q
    state = jng._init_state(jnp.asarray(jng.pad_starts(starts)), jnp.float32,
                            screened=screened)
    ended = seg(state, baked, shape, 2000)
    assert np.asarray(ended[4]).all()
    assert (np.asarray(jng.pad_starts(starts)) < 0).any()
    want = seg(ended, baked, shape, 40)
    got = tng.neargrid_walk_q(
        torch.from_numpy(q),
        tuple(torch.from_numpy(np.array(a)) for a in ended), shape, 40,
        torch.from_numpy(known))
    assert_state_equal(want, got)
    assert_state_equal(ended, got)


@pytest.mark.parametrize("screened", [False, True])
def test_q_walker_counts_match_its_walks(screened):
    """The plain walker's counts, which the chip tools' bounds and shares
    rest on: a lane's steps are the least cap whose walk leaves it where
    the uncapped walk does."""
    rho, lattice = fields("small")
    q, known, _, _ = setup(rho, lattice)
    shape = rho.shape
    starts = torch.from_numpy(np.flatnonzero(
        known.reshape(-1) == -2).astype(np.int32))
    state = tng.init_state(tng.pad_starts(starts, 64), screened)
    q, known = torch.from_numpy(q), torch.from_numpy(known)
    st = {}
    final = tng.neargrid_walk_q_plain(q, state, shape, 500, known, st)
    assert bool(final[4].all())
    taken = torch.full((state[0].numel(),), -1)
    for cap in range(st["longest"] + 1):
        out = tng.neargrid_walk_q_plain(q, state, shape, cap, known)
        same = torch.ones_like(taken, dtype=torch.bool)
        for a, b in zip(out, final):
            same &= (a == b).reshape(a.shape[0], -1).all(1)
        taken = torch.where((taken < 0) & same, cap, taken)
    assert bool((taken >= 0).all())
    warps = torch.zeros(-(-taken.numel() // 32) * 32, dtype=torch.long)
    warps[:taken.numel()] = taken
    assert st["lane_steps"] == int(taken.sum())
    assert st["longest"] == int(taken.max())
    assert st["stepped"] == int((taken > 0).sum())
    assert st["warp_steps"] == 32 * int(warps.view(-1, 32).amax(1).sum())
    assert st["lane_steps"] < st["warp_steps"]


def test_screened_walk_matches_jax():
    """walk_screened, risky re-walks on the exact rows included, equals
    JAX's walk_drain_screened (JAX's own exact rows, converted)."""
    rho, lattice = fields("big")
    q, known, _, tg = setup(rho, lattice)
    shape = rho.shape
    w = tuple(jgrid.distance_weights(lattice, shape))
    parent, _ = jpipe._parent_and_codes(jnp.asarray(rho), None, w)
    rows = np.array(jng.precompute_rows(jnp.asarray(rho), parent,
                                        jnp.asarray(tg), True))
    stop = jnp.asarray(known.reshape(-1) == 2)
    starts = np.flatnonzero(known.reshape(-1) == -2).astype(np.int32)
    padded = jng.pad_starts(starts)
    js = {}
    jpos, jdone = jng.walk_drain_screened(
        jnp.asarray(padded), jnp.asarray(tg), shape,
        jng.update_stop_q(jnp.asarray(q), stop),
        lambda: jng.update_stop(jnp.asarray(rows), stop), strict_grad=True,
        max_steps=192, stats=js)
    ts = {}
    tpos, tdone = tng.walk_screened(
        torch.from_numpy(q), lambda: tng.rows_from_jax_rows(rows),
        torch.from_numpy(padded), shape, 192, torch.from_numpy(known),
        stats=ts)
    assert ts["risky"] == js["risky"] > 0
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))


def test_screened_walk_with_blown_up_eps_equals_exact(monkeypatch):
    """With the error bound blown up every lane is risky, and the merge of
    the exact re-walks must give the exact walk."""
    rho, lattice = fields("small")
    q, known, bk, tg = setup(rho, lattice)
    rows = tng.neargrid_rows(torch.from_numpy(rho), torch.from_numpy(bk), tg,
                             True)
    rng = np.random.default_rng(9)
    movable = np.flatnonzero((known.reshape(-1) != 2)
                             & (bk.reshape(-1) != 13))
    starts = rng.choice(movable, size=2000, replace=False).astype(np.int32)
    padded = tng.pad_starts(torch.from_numpy(starts))
    known_t = torch.from_numpy(known)
    monkeypatch.setattr(tng, "QS_EPS", 10.0)
    stats = {}
    pos, done = tng.walk_screened(torch.from_numpy(q), lambda: rows, padded,
                                  rho.shape, 192, known_t, stats=stats)
    assert stats["risky"] >= len(starts) - 1
    epos, edone = tng.neargrid_walk(rows, padded, rho.shape, 192, known_t)
    assert torch.equal(pos, epos) and torch.equal(done, edone)


def test_padding_lanes_are_born_done():
    """-1 starts end at voxel 0, done, in the exact and the q walker."""
    rho, lattice = fields("small")
    q, known, bk, tg = setup(rho, lattice)
    rows = tng.neargrid_rows(torch.from_numpy(rho), torch.from_numpy(bk), tg,
                             True)
    starts = torch.tensor([5, -1, 7, -1], dtype=torch.int32)
    pos, done = tng.neargrid_walk(rows, starts, rho.shape, 192)
    qpos, qdone = tng.walk_q(torch.from_numpy(q), starts, rho.shape, 192)
    for p, d in ((pos, done), (qpos, qdone)):
        assert p[1] == p[3] == 0 and d[1] and d[3]


def test_bucket_ladder_and_padding_match_jax(monkeypatch):
    sizes = [1, 4095, 4097, 6000, 100000, (1 << 22) + 1, 7275187,
             (1 << 23) + 5]
    for fine in (True, False):
        monkeypatch.setattr(jng, "_FINE_BUCKETS", fine)
        for n in sizes:
            assert tng.bucket_size(n, fine_buckets=fine) == \
                jng._bucket_size(n, 4096), (n, fine)
    for n in (1, 3000, 4097, 70000):
        idx = np.arange(n, dtype=np.int32)
        np.testing.assert_array_equal(
            tng.pad_starts(torch.from_numpy(idx)).numpy(),
            jng.pad_starts(idx))


def test_q_kernel_wrappers_reject_cpu_tensors():
    rho, lattice = fields("small")
    q, _, bk, tg = setup(rho, lattice)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tng.neargrid_qrows_cuda(torch.from_numpy(rho), torch.from_numpy(bk),
                                tg, True)
    state = tng.init_state(torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA tensor"):
        tng.neargrid_walk_q_cuda(torch.from_numpy(q), state, SHAPE, 8)
