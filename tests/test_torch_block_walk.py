"""Parity: the port's block phase (the TPU's in-VMEM block walker) against
the JAX package, whose Pallas kernel runs in interpret mode on the CPU.

Tolerance: none.  Which lanes step in a round follows from integer rules
(the stable sort by block, 1024-lane tiles, each tile's median lane), and
the steps are f32 with every op rounded on its own in both packages, so
every state word (f32 ``dr`` and ``err`` bit for bit) and the round count
must be identical.  The field is the conforming 32x32x128 grid of
``tests/test_block_walk.py``, and a 16x16x128 grid of one block (every
periodic wrap keeps a lane inside its block); the JAX module reads its
switches at import, so the tests set ``_ENABLED`` and ``_MIN_LANES`` on it;
the port's walks take the phase as an argument (``block_steps``), and the
tests set ``_MIN_LANES`` on it.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pybader_tpu import grid as jgrid
from pybader_tpu.ops import block_walk as jbw
from pybader_tpu.ops import neargrid as jng
from pybader_tpu.ops.stencil import ongrid_step_codes
from pybader_tpu_torch.ops import block_walk as tbw
from pybader_tpu_torch.ops import neargrid as tng
from tests.test_block_walk import LATTICE, SHAPE, _fixture
from tests.test_torch_qrows import assert_state_equal

ONE_BLOCK = (16, 16, 128)

torch.set_num_threads(1)


def fixture(seed=0):
    """JAX's q-rows with a random stop set baked in, the same rows without
    it and the stop set as a known grid, and 3000 padded starts."""
    q_baked, padded, tg = _fixture(seed)
    q = np.array(q_baked)
    known = np.where(q[:, 1] < 0, 2, 0).astype(np.int8).reshape(SHAPE)
    q[:, 1] &= 0x7FFFFFFF
    return q_baked, torch.from_numpy(q), torch.from_numpy(known), \
        np.asarray(padded), tg


def grid_fixture(shape, seed):
    """:func:`fixture` on any grid of whole blocks: six periodic blobs
    from ``default_rng(seed)`` through JAX's ``precompute_qrows``, a stop
    set of a fifteenth of the voxels baked in (and as a known grid), and
    3000 starts off it, padded."""
    rng = np.random.default_rng(seed)
    frac = [np.arange(n) / n for n in shape]
    rho = np.full(shape, 0.02)
    for _ in range(6):
        c, wdt, amp = rng.random(3), 0.08 + 0.12 * rng.random(), \
            0.5 + rng.random()
        d = [np.minimum(np.abs(f - ci), 1 - np.abs(f - ci))
             for f, ci in zip(frac, c)]
        rho += amp * np.exp(-(d[0][:, None, None] ** 2
                              + d[1][None, :, None] ** 2
                              + d[2][None, None, :] ** 2) / wdt ** 2)
    tg = jgrid.t_grad(LATTICE, shape)
    bk = ongrid_step_codes(jnp.asarray(rho),
                           tuple(jgrid.distance_weights(LATTICE, shape)))
    qrows = jng.precompute_qrows(jnp.asarray(rho), bk, jnp.asarray(tg),
                                 strict_grad=True)
    n = rho.size
    stop = np.zeros(n, dtype=bool)
    stop[rng.choice(n, size=n // 15, replace=False)] = True
    starts = rng.choice(n, size=3000, replace=False).astype(np.int32)
    stop[starts] = False
    q = np.array(qrows)  # update_stop_q donates its rows
    q_baked = jng.update_stop_q(qrows, jnp.asarray(stop))
    known = np.where(stop, 2, 0).astype(np.int8).reshape(shape)
    return q_baked, torch.from_numpy(q), torch.from_numpy(known), \
        np.asarray(jng.pad_starts(starts)), tg


def enable(monkeypatch, min_lanes=256):
    monkeypatch.setattr(jbw, "_ENABLED", True)
    monkeypatch.setattr(jbw, "_MIN_LANES", min_lanes)
    monkeypatch.setattr(tbw, "_MIN_LANES", min_lanes)


@pytest.mark.parametrize("screened", [False, True])
def test_prep_round_matches_jax(screened):
    """Lane order, tile blocks and live flags of a round, on a state with
    done lanes (the padding) and lanes spread over all blocks."""
    q_baked, _, _, padded, _ = fixture(3)
    state = jng._init_state(jnp.asarray(padded), jnp.float32,
                            screened=screened)
    k0 = padded.size
    meta, _, order = jbw._prep_round(state, jnp.arange(k0, dtype=jnp.int32),
                                     SHAPE, k0 // jbw._TILE, screened)
    meta = np.asarray(meta)
    got_order, blocks, live = tbw.prep_round(
        tng.init_state(torch.from_numpy(padded), screened), SHAPE)
    np.testing.assert_array_equal(got_order.numpy(), np.asarray(order))
    np.testing.assert_array_equal(blocks.numpy(), meta & ((1 << 30) - 1))
    np.testing.assert_array_equal(live.numpy(), (meta >> 30) != 0)
    assert live.any() and not live.all()


@pytest.mark.parametrize("screened", [False, True])
@pytest.mark.parametrize("max_rounds", [1, 12])
def test_block_phase_matches_jax(screened, max_rounds):
    """One round, and a whole phase (min_alive low enough that rounds
    repeat until the slow rule or the round cap ends them)."""
    q_baked, q, known, padded, _ = fixture(0)
    state = jng._init_state(jnp.asarray(padded), jnp.float32,
                            screened=screened)
    want, rounds = jbw.block_phase(state, q_baked, SHAPE, screened=screened,
                                   max_rounds=max_rounds, min_alive=64)
    stats = {}
    got = tbw.block_phase(q, tng.init_state(torch.from_numpy(padded),
                                            screened),
                          SHAPE, known, max_rounds=max_rounds, min_alive=64,
                          stats=stats)
    assert_state_equal(want, got)
    assert len(stats["block_rounds"][0]) == rounds
    moved = got[0].numpy() != np.clip(padded, 0, None)
    assert moved.any() and (~got[4]).sum() > 0


@pytest.mark.parametrize("screened", [False, True])
@pytest.mark.parametrize("max_rounds", [1, 12])
def test_one_block_grid_phase_matches_jax(screened, max_rounds):
    """On a grid of one block every tile has block 0 and every periodic
    wrap keeps a lane inside it: the block test reads the wrapped
    coordinates, so a lane leaves a round only by stopping or by its step
    budget; one round, and a whole phase."""
    q_baked, q, known, padded, _ = grid_fixture(ONE_BLOCK, 4)
    state = jng._init_state(jnp.asarray(padded), jnp.float32,
                            screened=screened)
    want, rounds = jbw.block_phase(state, q_baked, ONE_BLOCK,
                                   screened=screened, max_rounds=max_rounds,
                                   min_alive=64)
    stats = {}
    got = tbw.block_phase(q, tng.init_state(torch.from_numpy(padded),
                                            screened),
                          ONE_BLOCK, known, max_rounds=max_rounds,
                          min_alive=64, stats=stats)
    assert_state_equal(want, got)
    assert len(stats["block_rounds"][0]) == rounds
    _, blocks, live = tbw.prep_round(
        tng.init_state(torch.from_numpy(padded), screened), ONE_BLOCK)
    assert not blocks.any() and live.sum() == -(-3000 // tbw.TILE)
    assert (~got[4]).sum() < 3000


@pytest.mark.parametrize("shape", [SHAPE, ONE_BLOCK])
@pytest.mark.parametrize("screened", [False, True])
def test_phase_handed_to_capped_q_walker_matches_jax(monkeypatch, shape,
                                                     screened):
    """The block phase hands its lanes to the q walker with a cap of 3:
    the walker takes up the lanes the rounds left, with the whole budget,
    as JAX's walk_drain does."""
    q_baked, q, known, padded, tg = grid_fixture(shape, 5)
    enable(monkeypatch)
    want = jng.walk_drain(jnp.asarray(padded), None, None, None,
                          jnp.asarray(tg), shape, strict_grad=True,
                          max_steps=3, fields=q_baked, screened=screened)
    stats = {}
    got = tng.walk_q(q, torch.from_numpy(padded), shape, 3, known,
                     screened=screened, stats=stats, block_steps=tbw.STEPS)
    assert_state_equal(want, got)
    assert stats["block_rounds"] and (~got[1]).sum() > 0


@pytest.mark.parametrize("steps", [1, 5])
def test_block_steps_env_matches_jax(steps):
    q_baked, q, known, padded, _ = fixture(1)
    state = jng._init_state(jnp.asarray(padded), jnp.float32, screened=True)
    want, _ = jbw.block_phase(state, q_baked, SHAPE, screened=True,
                              steps=steps, max_rounds=3, min_alive=64)
    got = tbw.block_phase(q, tng.init_state(torch.from_numpy(padded), True),
                          SHAPE, known, steps, max_rounds=3, min_alive=64)
    assert_state_equal(want, got)


@pytest.mark.parametrize("screened", [False, True])
def test_walk_with_phase_equals_walk_without(monkeypatch, screened):
    """Without a cap that fires, the block phase changes no result."""
    _, q, known, padded, _ = fixture(0)
    starts = torch.from_numpy(padded)
    off = tng.walk_q(q, starts, SHAPE, 2000, known, screened=screened)
    enable(monkeypatch)
    stats = {}
    on = tng.walk_q(q, starts, SHAPE, 2000, known, screened=screened,
                    stats=stats, block_steps=tbw.STEPS)
    assert stats["block_rounds"]
    for a, b in zip(off, on):
        assert torch.equal(a, b)


@pytest.mark.parametrize("screened", [False, True])
def test_capped_walk_with_phase_matches_jax(monkeypatch, screened):
    """A cap of 2 fires on many lanes; block steps do not count toward it,
    so the end points differ from the walk without the phase, as JAX's."""
    q_baked, q, known, padded, tg = fixture(0)
    enable(monkeypatch)
    want = jng.walk_drain(jnp.asarray(padded), None, None, None,
                          jnp.asarray(tg), SHAPE, strict_grad=True,
                          max_steps=2, fields=q_baked, screened=screened)
    got = tng.walk_q(q, torch.from_numpy(padded), SHAPE, 2, known,
                     screened=screened, block_steps=tbw.STEPS)
    assert_state_equal(want, got)
    plain = tng.walk_q(q, torch.from_numpy(padded), SHAPE, 2, known,
                       screened=screened)
    assert (~got[1]).sum() > 0
    assert not torch.equal(plain[0], got[0])


def test_phase_off_below_min_lanes_or_off_grid(monkeypatch):
    enable(monkeypatch, min_lanes=1 << 17)
    assert tbw.enabled(SHAPE, 1 << 17, True)
    assert not tbw.enabled(SHAPE, (1 << 17) - 1, True)
    assert not tbw.enabled((24, 20, 18), 1 << 20, True)
    assert not tbw.enabled(SHAPE, 1 << 20, False)
    for shape in [(32, 32, 128), (24, 20, 18), (16, 48, 256)]:
        assert tbw.conforms(shape) == jbw.conforms(shape)


def test_phase_skips_a_lane_count_off_the_tile():
    _, q, known, padded, _ = fixture(0)
    state = tng.init_state(torch.from_numpy(padded[:1000]))
    stats = {}
    out = tbw.block_phase(q, state, SHAPE, known, stats=stats)
    assert out is state and not stats


def test_block_round_wrapper_rejects_cpu_tensors():
    _, q, known, padded, _ = fixture(0)
    state = tng.init_state(torch.from_numpy(padded))
    order, blocks, live = tbw.prep_round(state, SHAPE)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tbw.block_round_cuda(q, state, blocks, live, SHAPE, 24, known)


def stop_call(kernel, wrapper, q, state, **kw):
    """One call of a q-walk kernel's wrapper or its dispatcher (``wrapper``
    False) with the keywords ``kw``."""
    if kernel == "block_round":
        order, blocks, live = tbw.prep_round(state, SHAPE)
        fn = tbw.block_round_cuda if wrapper else tbw.block_round
        return fn(q, state, blocks, live, SHAPE, 24, **kw)
    fn = tng.neargrid_walk_q_cuda if wrapper else tng.neargrid_walk_q
    return fn(q, state, SHAPE, 8, **kw)


@pytest.mark.parametrize("kernel", ["block_round", "walk_q"])
def test_stop_bitmap_keyword_rejects_cpu_tensors(kernel):
    """The kernels' stop keyword (the bitmap built once a walk, in place
    of known) must be a CUDA tensor; the wrappers check it before anything
    else."""
    _, q, known, padded, _ = fixture(0)
    state = tng.init_state(torch.from_numpy(padded))
    with pytest.raises(ValueError, match=r"stop \(a bitmap\): expected a "
                       r"CUDA tensor"):
        stop_call(kernel, True, q, state, stop=tng.stop_bitmap(known))


@pytest.mark.parametrize("kernel", ["block_round", "walk_q"])
def test_stop_bitmap_keyword_goes_to_the_kernel(kernel):
    """The dispatchers send a stop bitmap to the kernel's wrapper, which
    refuses CPU tensors, never to the plain version, which does not read
    it and would walk without a stop set."""
    _, q, known, padded, _ = fixture(0)
    state = tng.init_state(torch.from_numpy(padded))
    with pytest.raises(ValueError, match=r"stop \(a bitmap\): expected a "
                       r"CUDA tensor"):
        stop_call(kernel, False, q, state, stop=tng.stop_bitmap(known))


@pytest.mark.parametrize("kernel", ["block_round", "walk_q"])
def test_stop_bitmap_keyword_refuses_known_beside_it(kernel):
    """The kernel reads the bitmap alone, so a known grid given beside it
    (which could have changed since the bitmap was built) is refused."""
    _, q, known, padded, _ = fixture(0)
    state = tng.init_state(torch.from_numpy(padded))
    with pytest.raises(ValueError, match="not both"):
        stop_call(kernel, True, q, state, known=known,
                  stop=tng.stop_bitmap(known))
