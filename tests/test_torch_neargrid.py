"""Parity: the port's walk rows, trajectory walker and neargrid partition
against the JAX package.

Rows: XLA's CPU backend contracts some of the gradient multiply-adds of
``precompute_rows`` into FMAs, not in one consistent pattern, while the
port builds them unfused; so the gradient columns are held to an absolute
1e-15 (4 ulp at 1.0, the largest normalised component) and flags and
parents must be identical.  The walker is exact on whatever rows it gets,
so it is held bit for bit to ``_walk_segment_packed`` on JAX's own rows
(converted with ``rows_from_jax_rows``).  Labels, maxima and step-cap fires
of the partition must be identical.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pybader_tpu import grid as jgrid
from pybader_tpu import pipeline as jpipe
from pybader_tpu.ops import edges as jedges
from pybader_tpu.ops import neargrid as jng
from pybader_tpu_torch import pipeline as tpipe
from pybader_tpu_torch.ops import neargrid as tng
from tests.oracle import neargrid_trajectory
from tests.test_torch_pipeline import LATTICE, SHAPE, make_density

torch.set_num_threads(1)

W = tuple(jgrid.distance_weights(LATTICE, SHAPE))
TG = jgrid.t_grad(LATTICE, SHAPE)
N = int(np.prod(SHAPE))


def jax_rows(rho, strict_grad, vac=None):
    parent, bk = jpipe._parent_and_codes(
        jnp.asarray(rho), None if vac is None else jnp.asarray(vac), W)
    rows = jng.precompute_rows(jnp.asarray(rho), parent, jnp.asarray(TG),
                               strict_grad)
    return rows, np.asarray(bk)


def port_rows(rho, strict_grad, vac=None):
    bk = tpipe.step_codes(torch.from_numpy(rho),
                          None if vac is None else torch.from_numpy(vac), W)
    return tng.neargrid_rows(torch.from_numpy(rho), bk, TG, strict_grad)


def edge_known(rho):
    """The known grid of refinement's first scan on the ongrid labels."""
    labels, _ = jpipe.partition_ongrid(rho, None, W)
    return np.array(jedges.edge_find(jnp.asarray(rho), labels))


@pytest.mark.parametrize("strict_grad", [False, True])
def test_rows_match_jax(strict_grad):
    rho = make_density(0)
    jr, _ = jax_rows(rho, strict_grad)
    jr = np.asarray(jr)
    tr = port_rows(rho, strict_grad)
    conv = tng.rows_from_jax_rows(jr)
    words = tr.view(torch.int32)[:, 6:]
    np.testing.assert_array_equal(words.numpy(),
                                  conv.view(torch.int32)[:, 6:].numpy())
    assert (words[:, 1] & tng.MAX).sum() >= 1
    np.testing.assert_allclose(tr[:, :3].numpy(), jr[:, :3], rtol=0,
                               atol=1e-15)


@pytest.mark.parametrize("shape", [(9, 13, 7), (1, 5, 11), (2, 2, 12),
                                   (7, 2, 5)])
@pytest.mark.parametrize("strict_grad", [False, True])
def test_rows_match_jax_on_ragged_grids(shape, strict_grad):
    """Ragged grids and axes of 1 and 2 (a neighbour wraps onto the voxel
    itself or onto the other one), t_grad a numpy array as the pipeline
    passes it."""
    rho = make_density(11, shape)
    w = tuple(jgrid.distance_weights(LATTICE, shape))
    tg = jgrid.t_grad(LATTICE, shape)
    parent, _ = jpipe._parent_and_codes(jnp.asarray(rho), None, w)
    jr = np.asarray(jng.precompute_rows(jnp.asarray(rho), parent,
                                        jnp.asarray(tg), strict_grad))
    bk = tpipe.step_codes(torch.from_numpy(rho), None, w)
    tr = tng.neargrid_rows_plain(torch.from_numpy(rho), bk, tg, strict_grad)
    words = tr.view(torch.int32)[:, 6:]
    np.testing.assert_array_equal(
        words.numpy(), tng.rows_from_jax_rows(jr).view(torch.int32)[:, 6:]
        .numpy())
    assert (words[:, 1] & tng.MAX).sum() >= 1
    np.testing.assert_allclose(tr[:, :3].numpy(), jr[:, :3], rtol=0,
                               atol=1e-15)


def test_rows_with_vacuum_flag_vacuum_as_maxima():
    rho = make_density(1)
    vac = rho <= np.quantile(rho, 0.3)
    jr, _ = jax_rows(rho, False, vac)
    tr = port_rows(rho, False, vac)
    conv = tng.rows_from_jax_rows(np.asarray(jr))
    assert torch.equal(tr.view(torch.int32)[:, 6:],
                       conv.view(torch.int32)[:, 6:])
    assert ((tr.view(torch.int32)[:, 7] & tng.MAX)[
        torch.from_numpy(vac.reshape(-1))] != 0).all()


@pytest.mark.parametrize("stop,cap", [
    (False, tng.initial_cap(SHAPE)), (True, tng.refine_cap(SHAPE)),
    (False, 3), (True, 2),
])
def test_walker_on_jax_rows_is_bit_exact(stop, cap):
    """Every voxel walks on JAX's rows, with and without a stop set, and
    with a cap small enough that many lanes hit it."""
    rho = make_density(2)
    jr, _ = jax_rows(rho, strict_grad=stop)
    rows = tng.rows_from_jax_rows(np.asarray(jr))
    starts = np.arange(N, dtype=np.int32)
    known = None
    if stop:
        known = edge_known(rho)
        jr = jng.update_stop(jr, jnp.asarray(known.reshape(-1) == 2))
    state = jng._init_state(jnp.asarray(starts), jnp.float64)
    jpos, _, _, _, jdone = jng._walk_segment_packed(state, jr, SHAPE, cap)
    pos, done = tng.neargrid_walk(
        rows, torch.from_numpy(starts), SHAPE, cap,
        None if known is None else torch.from_numpy(known))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
    if cap < 5:
        assert (~done).sum() > 0


def numpy_bitmap(known: np.ndarray) -> np.ndarray:
    """known == 2 bit-packed with numpy: bit b of uint32 word w is flat
    voxel 32 w + b, the last word padded with 0."""
    b = np.packbits(known.reshape(-1) == 2, bitorder="little")
    return np.concatenate([b, np.zeros(-b.size % 4, np.uint8)]).view("<u4")


# 105, 2688 (= 84 * 32), 1 and 33 voxels
@pytest.mark.parametrize("shape", [(3, 5, 7), SHAPE, (1, 1, 1), (1, 3, 11)])
def test_stop_bitmap_matches_numpy_packbits(shape):
    known = np.random.default_rng(11).integers(
        -2, 3, size=shape).astype(np.int8)
    got = tng.stop_bitmap_plain(torch.from_numpy(known))
    assert got.dtype == torch.int32 and got.numel() == -(-known.size // 32)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  numpy_bitmap(known))


def test_stop_bitmap_matches_jax_stop_bits():
    """The bitmap holds JAX's stop set: the bits update_stop bakes into
    its rows for refinement's first known grid."""
    rho = make_density(2)
    jr, _ = jax_rows(rho, strict_grad=True)
    known = edge_known(rho)
    jr = jng.update_stop(jr, jnp.asarray(known.reshape(-1) == 2))
    stop = (np.asarray(jr)[:, 3].astype(np.int64) & (1 << 30)) != 0
    assert stop.any()
    bits = tng.stop_bitmap_plain(torch.from_numpy(known)).numpy().view(
        np.uint32)
    i = np.arange(N)
    got = (bits[i // 32] >> (i % 32).astype(np.uint32)) & 1
    np.testing.assert_array_equal(got.astype(bool), stop)


@pytest.mark.parametrize("stop", [False, True])
def test_walker_warp_steps_match_jax_count(stop):
    """``warp_steps`` against a numpy count of per-lane walk lengths read
    off JAX's walker: a lane that ends after L steps is done at every cap
    from L on, so L is the number of caps below the cap where it is not
    done.  Lanes are shuffled, with padding lanes and a last group of 25."""
    rho = make_density(2)
    jr, _ = jax_rows(rho, strict_grad=stop)
    rows = tng.rows_from_jax_rows(np.asarray(jr))
    rng = np.random.default_rng(12)
    starts = rng.permutation(N)[:N - 7].astype(np.int32)
    starts[::11] = -1
    known = None
    cap = tng.initial_cap(SHAPE)
    if stop:
        known = edge_known(rho)
        jr = jng.update_stop(jr, jnp.asarray(known.reshape(-1) == 2))
        cap = tng.refine_cap(SHAPE)
    state = jng._init_state(jnp.asarray(starts), jnp.float64)
    length = np.zeros(starts.size, np.int64)
    for c in range(cap):
        done = np.asarray(jng._walk_segment_packed(state, jr, SHAPE, c)[4])
        if done.all():
            break
        length += ~done
    groups = np.zeros(-(-starts.size // 32) * 32, np.int64)
    groups[:starts.size] = length
    st = {}
    tng.neargrid_walk_plain(
        rows, torch.from_numpy(starts), SHAPE, cap,
        None if known is None else torch.from_numpy(known), stats=st)
    assert st["lane_steps"] == int(length.sum())
    assert st["warp_steps"] == 32 * int(groups.reshape(-1, 32).max(1).sum())
    assert st["lane_steps"] < st["warp_steps"]


@pytest.mark.parametrize("strict_grad", [False, True])
def test_walker_matches_oracle_trajectory(strict_grad):
    rho = make_density(3)
    rows = port_rows(rho, strict_grad)
    known = edge_known(rho) if strict_grad else None
    rng = np.random.default_rng(42)
    if strict_grad:
        starts = np.flatnonzero(known.reshape(-1) == -2)[:64]
    else:
        starts = rng.choice(N, size=64, replace=False)
    starts = starts.astype(np.int32)
    pos, done = tng.neargrid_walk(
        rows, torch.from_numpy(starts), SHAPE, tng.initial_cap(SHAPE),
        None if known is None else torch.from_numpy(known))
    assert done.all()
    stop = None if known is None else known == 2
    for s, p in zip(starts, pos.numpy()):
        want = neargrid_trajectory(rho, W, TG, np.unravel_index(s, SHAPE),
                                   stop_mask=stop, strict_grad=strict_grad)
        assert np.unravel_index(p, SHAPE) == want, s


def random_vacuum(seed, frac=0.1):
    """An arbitrary vacuum mask: unlike a density threshold, it puts
    vacuum on the slopes, so some trajectories end on a vacuum voxel."""
    return np.random.default_rng(seed).random(SHAPE) < frac


def both_partitions(rho, vac, full, carry=None):
    jl, jm = jpipe.partition_neargrid(rho, vac, W, TG,
                                      full_trajectories=full)
    tl, tm = tpipe.partition_neargrid(
        torch.from_numpy(rho), None if vac is None else torch.from_numpy(vac),
        W, TG, full_trajectories=full, carry_out=carry)
    assert tl.dtype == torch.int32 and tm.dtype == np.int64
    return tl.numpy(), tm, np.asarray(jl), np.asarray(jm)


@pytest.mark.parametrize("vacuum", [None, "density", "random"])
def test_full_trajectory_partition_matches_jax(vacuum):
    rho = make_density(4)
    vac = {None: None, "density": rho <= np.quantile(rho, 0.3),
           "random": random_vacuum(4)}[vacuum]
    tl, tm, jl, jm = both_partitions(rho, vac, True)
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(tm, jm)
    if vac is not None:
        assert (tl[vac] == -1).all()
    if vacuum == "random":
        # trajectories that end on a vacuum voxel take the label of the
        # next maximum above it (JAX's searchsorted), not -1
        rows = port_rows(rho, False, vac)
        pos, _ = tng.neargrid_walk(rows, torch.arange(N, dtype=torch.int32),
                                   SHAPE, tng.initial_cap(SHAPE))
        v = vac.reshape(-1)
        corner = ~v & v[pos.numpy()]
        assert corner.any()
        assert (tl.reshape(-1)[corner] >= 0).any()


def test_full_trajectory_cap_fires_resolve_like_jax(monkeypatch):
    """A cap small enough to fire on most lanes: stragglers resolve
    through their ongrid roots in both packages."""
    rho = make_density(5)
    monkeypatch.setattr(tng, "initial_cap", lambda shape: 2)
    real_walk = jng.walk_drain_screened

    def capped(*args, **kwargs):
        kwargs["max_steps"] = 2
        return real_walk(*args, **kwargs)

    monkeypatch.setattr(jng, "walk_drain_screened", capped)
    stats = {}
    tl, _ = tpipe.partition_neargrid(torch.from_numpy(rho), None, W, TG,
                                     full_trajectories=True, stats=stats)
    jl, _ = jpipe.partition_neargrid(rho, None, W, TG,
                                     full_trajectories=True)
    assert stats["cap_fires"] > 0
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


@pytest.mark.parametrize("vacuum", [None, "density"])
def test_hybrid_partition_matches_jax(vacuum):
    """A density-threshold vacuum, as the interface makes: with an
    arbitrary mask the JAX ongrid init itself differs between its CPU path
    (searchsorted labels for chains that end in vacuum) and its TPU path
    (-1, which the port follows)."""
    rho = make_density(6)
    vac = None if vacuum is None else rho <= np.quantile(rho, 0.3)
    carry = {}
    tl, tm, jl, jm = both_partitions(rho, vac, False, carry)
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(tm, jm)
    assert carry


def test_full_trajectories_env_override(monkeypatch):
    """=0 forces the hybrid (which fills carry_out), =1 full trajectories;
    an explicit argument wins over the variable."""
    rho = torch.from_numpy(make_density(7))
    monkeypatch.setenv("PYBADER_TPU_FULL_TRAJECTORIES", "0")
    carry = {}
    tpipe.partition_neargrid(rho, None, W, TG, carry_out=carry)
    assert carry
    monkeypatch.setenv("PYBADER_TPU_FULL_TRAJECTORIES", "1")
    carry = {}
    tpipe.partition_neargrid(rho, None, W, TG, carry_out=carry)
    assert not carry
    tpipe.partition_neargrid(rho, None, W, TG, full_trajectories=False,
                             carry_out=carry)
    assert carry


def test_internal_iters_env_matches_jax(monkeypatch):
    monkeypatch.setenv("PYBADER_TPU_INTERNAL_ITERS", "1")
    rho = make_density(8)
    stats = {}
    tl, _ = tpipe.partition_neargrid(torch.from_numpy(rho), None, W, TG,
                                     full_trajectories=False, stats=stats)
    jl, _ = jpipe.partition_neargrid(rho, None, W, TG,
                                     full_trajectories=False)
    assert len(stats["iterations"]) == 1
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert tpipe.hybrid_internal_budget((384,) * 3) == (
        jpipe._hybrid_internal_budget((384,) * 3))


def test_kernel_wrappers_reject_cpu_tensors():
    rho = make_density(0)
    bk = tpipe.step_codes(torch.from_numpy(rho), None, W)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tng.neargrid_rows_cuda(torch.from_numpy(rho), bk, TG, False)
    rows = port_rows(rho, False)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tng.neargrid_walk_cuda(rows, torch.zeros(4, dtype=torch.int32),
                               SHAPE, 8)


def test_stop_bitmap_kernel_rejects_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA tensor"):
        tng.stop_bitmap_cuda(torch.zeros(SHAPE, dtype=torch.int8))
