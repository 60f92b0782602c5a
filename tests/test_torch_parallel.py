"""Parity: the port's multi-device path (``pybader_tpu_torch.parallel``,
``mesh=`` of the pipeline, ``Bader.mesh``) on virtual CPU meshes against the
JAX package's mesh path on its 8 virtual CPU devices (``tests/conftest.py``)
and against the single-device path.

``make_mesh(n, device="cpu")`` puts n shards on the CPU; the port holds one
tensor a distinct shard (an axis the spec leaves unsharded is replicated in
JAX and held once here).  Tolerances: labels, maxima, step counts and
changed counts are integers and must be identical; walk positions and done
flags are identical; charges and volumes sum per shard in another order
than one device does (rtol 1e-12); surface distances take the minimum of
the same f64 values (rtol 1e-10, atol 1e-12, the JAX tests' bound).  The
mirrored tests are those of ``tests/test_sharded.py`` and
``__graft_entry__.dryrun_multichip``.
"""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pybader_tpu import grid as g
from pybader_tpu import pipeline as jpipe
from pybader_tpu.interface import Bader as JaxBader
from pybader_tpu.ops import edges as jedges
from pybader_tpu.ops.reductions import compact_indices
from pybader_tpu.ops.stencil import ongrid_step_codes as jax_codes
from pybader_tpu.ops.stencil import parent_from_step_codes as jax_parent
from pybader_tpu.parallel import make_mesh as jax_mesh
from pybader_tpu.parallel import sharded_partition as jax_partition
from pybader_tpu.parallel import sharded_step as jax_step
from pybader_tpu.parallel import analysis as janalysis
from pybader_tpu.parallel.chase import grid_spec_2d as jax_spec_2d
from pybader_tpu.parallel.sharded import choose_grid_spec as jax_choose
from pybader_tpu.parallel.walk import walk_sharded as jax_walk
from pybader_tpu_torch import pipeline
from pybader_tpu_torch.interface import Bader
from pybader_tpu_torch.ops import edges, neargrid, reductions
from pybader_tpu_torch.ops.atoms import assign_to_atoms, surface_distance_masked
from pybader_tpu_torch.parallel import analysis, mesh as tmesh, sharded
from pybader_tpu_torch.parallel import make_mesh, sharded_partition, \
    sharded_step
from pybader_tpu_torch.parallel.walk import gather, hand_off, walk_sharded
from tests.test_ongrid import LATTICE, SHAPE, make_density
from tests.test_torch_interface import FIXTURE

torch.set_num_threads(1)

W = tuple(g.distance_weights(LATTICE, SHAPE))
TG = g.t_grad(LATTICE, SHAPE)


def t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


def test_virtual_meshes_match_jax():
    """Mesh shapes, grid specs (with the transposed assignment and the
    replicated fallback) and shard layout, for 1-8 shards."""
    assert len(jax.devices()) == 8
    for n in range(1, 9):
        jm, tm = jax_mesh(n), make_mesh(n, device="cpu")
        assert tm.devices.shape == jm.devices.shape
        assert tm.axis_names == tuple(jm.axis_names)
        for shape in (SHAPE, (14, 16, 12), (7, 5, 12), (15, 16, 8),
                      (24, 28, 32)):
            assert tmesh.grid_spec_2d(tm, shape) == tuple(
                jax_spec_2d(jm, shape)), (n, shape)
            assert tmesh.choose_grid_spec(tm, shape) == tuple(
                jax_choose(jm, shape)), (n, shape)
    # the test grid on 8 devices: a 2x4 mesh with y left unsharded
    lay = tmesh.Layout(make_mesh(8, device="cpu"), SHAPE)
    assert lay.spec == ("x", None, None)
    assert lay.counts == (2, 1) and lay.local_shape == (8, 14, 12)


def test_shard_halo_take_put_round_trip():
    mesh = make_mesh(4, device="cpu")
    full = torch.arange(np.prod(SHAPE), dtype=torch.int32).reshape(SHAPE)
    sh = tmesh.shard(tmesh.Layout(mesh, SHAPE), full)
    assert torch.equal(sh.join(), full)
    for width in (1, 2):
        for s, p in enumerate(tmesh.halo(sh, width)):
            ox, oy, _ = sh.layout.origin(s)
            lx, ly, _ = sh.layout.local_shape
            xs = torch.arange(ox - width, ox + lx + width) % SHAPE[0]
            ys = torch.arange(oy - width, oy + ly + width) % SHAPE[1]
            assert torch.equal(p, full[xs][:, ys])
            assert torch.equal(tmesh.crop(p, sh.layout, width),
                               sh.blocks[s])
    flat = torch.randperm(full.numel())[:50].to(torch.int32)
    assert torch.equal(tmesh.take(sh, flat), full.view(-1)[flat.long()])
    tmesh.put(sh, flat, -flat)
    assert torch.equal(sh.join().view(-1)[flat.long()], -flat)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_sharded_partition_matches_jax(n):
    rho = make_density(0)
    want, maxima = jax_partition(jax_mesh(n), rho, None, W)
    got, maxima_t = sharded_partition(make_mesh(n, device="cpu"), rho, None,
                                      W)
    np.testing.assert_array_equal(got.join().numpy(), np.asarray(want))
    np.testing.assert_array_equal(maxima_t, maxima)
    one, maxima_1 = pipeline.partition_ongrid(t(rho), None, W)
    assert torch.equal(got.join(), one)
    np.testing.assert_array_equal(maxima_1, maxima)


@pytest.mark.parametrize("n", [4, 8])
def test_sharded_partition_with_vacuum(n):
    rho = make_density(1)
    vac = rho <= np.quantile(rho, 0.3)
    want, maxima = jax_partition(jax_mesh(n), rho, vac, W)
    got, maxima_t = pipeline.partition_ongrid(
        t(rho), t(vac), W, mesh=make_mesh(n, device="cpu"))
    np.testing.assert_array_equal(got.join().numpy(), np.asarray(want))
    np.testing.assert_array_equal(maxima_t, maxima)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_sharded_refinement_matches_jax(n):
    rho = make_density(0)
    jm, tm = jax_mesh(n), make_mesh(n, device="cpu")
    jl, _ = jpipe.partition_ongrid(rho, None, W, mesh=jm)
    jstats, tstats = {}, {}
    want, ch_want = jpipe.refine_labels("neargrid", ("changed", 2), rho, jl,
                                        W, TG, verbose=False, mesh=jm,
                                        stats=jstats)
    tl, _ = pipeline.partition_ongrid(t(rho), None, W, mesh=tm)
    got, ch = pipeline.refine_labels("neargrid", ("changed", 2), t(rho), tl,
                                     W, TG, verbose=False, mesh=tm,
                                     stats=tstats)
    assert ch == ch_want > 0
    np.testing.assert_array_equal(got.join().numpy(), np.asarray(want))
    assert [s[:4] for s in tstats["iterations"]] == \
        [tuple(s[:4]) for s in jstats["iterations"]]
    # the single-device refinement without carry gives the same
    one, ch_1 = pipeline.refine_labels("neargrid", ("changed", 2), t(rho),
                                       tl.join(), W, TG, verbose=False)
    assert ch_1 == ch and torch.equal(got.join(), one)


def test_sharded_refinement_with_vacuum():
    rho = make_density(5)
    vac = rho <= np.quantile(rho, 0.25)
    jm, tm = jax_mesh(8), make_mesh(8, device="cpu")
    jl, _ = jpipe.partition_ongrid(rho, vac, W, mesh=jm)
    want, ch_want = jpipe.refine_labels("neargrid", ("changed", -1), rho, jl,
                                        W, TG, verbose=False, mesh=jm)
    tl, _ = pipeline.partition_ongrid(t(rho), t(vac), W, mesh=tm)
    got, ch = pipeline.refine_labels("neargrid", ("changed", -1), t(rho), tl,
                                     W, TG, verbose=False, mesh=tm)
    assert ch == ch_want > 0
    np.testing.assert_array_equal(got.join().numpy(), np.asarray(want))


@pytest.mark.parametrize("mode", ["changed", "all"])
def test_refinement_step_cap_and_modes(mode):
    """A tight step cap makes lanes resolve through the mesh chase's roots;
    both modes equal the single-device refinement."""
    rho = make_density(7)
    tm = make_mesh(4, device="cpu")
    tl, _ = pipeline.partition_ongrid(t(rho), None, W, mesh=tm)
    ts, os_ = {}, {}
    got, ch = pipeline.refine_labels("neargrid", (mode, 3), t(rho), tl, W,
                                     TG, verbose=False, mesh=tm, step_cap=2,
                                     stats=ts)
    one, ch_1 = pipeline.refine_labels("neargrid", (mode, 3), t(rho),
                                       tl.join(), W, TG, verbose=False,
                                       step_cap=2, stats=os_)
    assert ch == ch_1 and torch.equal(got.join(), one)
    assert [s[:4] for s in ts["iterations"]] == \
        [s[:4] for s in os_["iterations"]]
    assert ts["iterations"][0][2] > 0  # the cap fired


def _walk_fields(seed=7):
    rho = make_density(seed)
    labels, _ = jpipe.partition_ongrid(rho, None, W)
    bk = jax_codes(jnp.asarray(rho), W)
    known = jedges.edge_find(jnp.asarray(rho), labels, bk == jnp.uint8(13))
    return rho, np.array(bk), np.array(known)


@pytest.mark.parametrize("n", [4, 8])
def test_walk_sharded_matches_walker_and_jax(n):
    rho, bk, known = _walk_fields()
    edge = (known == -2).reshape(-1)
    assert edge.sum() > 0
    starts = np.array(compact_indices(jnp.asarray(edge), 4096))
    rows = neargrid.neargrid_rows(t(rho), t(bk), TG, True)
    pos_1, done_1 = neargrid.neargrid_walk(rows, t(starts), SHAPE, 192,
                                           t(known))
    tm = make_mesh(n, device="cpu")
    pos, done = walk_sharded(tm, t(starts), t(rho), t(bk), t(known == 2),
                             TG, strict_grad=True, max_steps=192)
    assert torch.equal(pos, pos_1) and torch.equal(done, done_1)
    jpos, jdone = jax_walk(jax_mesh(n), starts, rho,
                           jax_parent(jnp.asarray(bk)), known == 2, TG,
                           strict_grad=True, max_steps=192)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))


@pytest.mark.parametrize("cap", [3, 192])
def test_walk_shard_kernel_plain_twin(cap):
    """One shard's resumable walk against the whole grid's walker: lanes
    end done, at the cap, or off the shard; resumed by the owner, they end
    where the single-device walk ends them."""
    rho, bk, known = _walk_fields(0)
    tm = make_mesh(4, device="cpu")
    lay = tmesh.Layout(tm, SHAPE)
    rows_sh = tmesh.shard(lay, t(rho)), tmesh.shard(lay, t(bk))
    from pybader_tpu_torch.parallel.walk import shard_rows
    rows = shard_rows(*rows_sh, TG, True)
    full = neargrid.neargrid_rows(t(rho), t(bk), TG, True)
    for s in range(len(lay.ids)):
        gi = lay.global_index(s).view(-1).long()
        assert torch.equal(rows[s], full[gi])  # interior rows are the grid's
    stop = tmesh.shard(lay, t(known == 2))
    starts = lay.global_index(0).view(-1)[~stop.blocks[0].view(-1)]
    assert starts.numel() > 100
    state = neargrid.shard_state(starts)
    new, status = neargrid.neargrid_walk_shard(
        rows[0], stop.blocks[0], state, lay.origin(0)[:2], lay.local_shape,
        SHAPE, cap)
    assert set(status.unique().tolist()) <= {0, 1, 2}
    assert (status == 0).any()
    assert torch.equal(state[0], starts)  # the input state is kept
    off = lay.owner(new[0]) != 0
    assert torch.equal(off, status == 0)
    pos_1, done_1 = neargrid.neargrid_walk(full, starts, SHAPE, cap,
                                           t(known))
    fin = status != 0
    assert torch.equal(new[0][fin], pos_1[fin])
    assert torch.equal(status[fin] == 1, done_1[fin])
    assert (new[4] <= cap).all()


@pytest.mark.parametrize("cap", [3, 192])
def test_walk_shard_stop_bitmap_matches_bool_walk_and_jax(cap):
    """The shard walk reading each shard's stop set as a bitmap equals the
    walk of the bool grid on every shard's lanes, leaves its input state as
    it was, and walk_sharded (bitmaps built once a call) equals the
    single-device walker and JAX's walk_sharded."""
    from pybader_tpu_torch.parallel.walk import shard_rows

    rho, bk, known = _walk_fields()
    tm = make_mesh(4, device="cpu")
    lay = tmesh.Layout(tm, SHAPE)
    rows = shard_rows(tmesh.shard(lay, t(rho)), tmesh.shard(lay, t(bk)), TG,
                      True)
    stop = tmesh.shard(lay, t(known == 2))
    edge = torch.as_tensor(np.flatnonzero(known == -2), dtype=torch.int32)
    status_seen = set()
    for s in range(len(lay.ids)):
        bits = neargrid.stop_bitmap(stop.blocks[s], 1)
        assert torch.equal(bits, neargrid.stop_bitmap_plain(
            stop.blocks[s].to(torch.int8) * 2))
        state = neargrid.shard_state(edge[lay.owner(edge) == s])
        kept = tuple(a.clone() for a in state)
        args = (state, lay.origin(s)[:2], lay.local_shape, SHAPE, cap)
        new_b, status_b = neargrid.neargrid_walk_shard(rows[s], bits, *args)
        new_g, status_g = neargrid.neargrid_walk_shard(rows[s],
                                                       stop.blocks[s], *args)
        assert torch.equal(status_b, status_g)
        for a, b in zip(new_b, new_g):
            assert torch.equal(a, b)
        for a, b in zip(state, kept):
            assert torch.equal(a, b)  # the input state is left unchanged
        status_seen |= set(status_b.tolist())
    assert {0, 1} <= status_seen and (cap != 3 or 2 in status_seen)
    starts = np.array(compact_indices(jnp.asarray((known == -2).reshape(-1)),
                                      4096))
    pos, done = walk_sharded(tm, t(starts), t(rho), t(bk), t(known == 2), TG,
                             strict_grad=True, max_steps=cap)
    full = neargrid.neargrid_rows(t(rho), t(bk), TG, True)
    pos_1, done_1 = neargrid.neargrid_walk(full, t(starts), SHAPE, cap,
                                           t(known))
    assert torch.equal(pos, pos_1) and torch.equal(done, done_1)
    jpos, jdone = jax_walk(jax_mesh(4), starts, rho,
                           jax_parent(jnp.asarray(bk)), known == 2, TG,
                           strict_grad=True, max_steps=cap)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))


def test_walk_shard_lane_off_the_grid_ends_off_shard():
    """A lane whose position lies off the grid ends at once with status 0
    and its state unchanged, as a lane off the shard does (the kernel
    tests the position on the card; the wrapper reads nothing back)."""
    from pybader_tpu_torch.parallel.walk import shard_rows

    rho, bk, known = _walk_fields()
    lay = tmesh.Layout(make_mesh(4, device="cpu"), SHAPE)
    rows = shard_rows(tmesh.shard(lay, t(rho)), tmesh.shard(lay, t(bk)), TG,
                      True)
    n = int(np.prod(SHAPE))
    state = neargrid.shard_state(torch.tensor([-1, n, n + 7, -n],
                                              dtype=torch.int32))
    new, status = neargrid.neargrid_walk_shard(
        rows[0], None, state, lay.origin(0)[:2], lay.local_shape, SHAPE, 192)
    assert status.tolist() == [0, 0, 0, 0]
    for a, b in zip(new, state):
        assert torch.equal(a, b)


def _plain_round_loop(lay, values, bk):
    """The mesh chase as a loop of rounds of the roll-select chase: each
    padded shard block chased to its local fixed point, then cropped.
    returns (values, rounds)."""
    from pybader_tpu_torch.ops.chase import chase_plain
    from pybader_tpu_torch.parallel.chase import pin_codes

    vals = tmesh.shard(lay, values, torch.int32)
    pinned = pin_codes(tmesh.shard(lay, bk, torch.uint8))
    rounds = 0
    while True:
        rounds += 1
        blocks, changed = [], 0
        for padded, codes in zip(tmesh.halo(vals, 1), pinned):
            out, n = chase_plain(padded.contiguous(), codes)
            blocks.append(tmesh.crop(out, lay, 1))
            changed += n
        vals = tmesh.Sharded(lay, blocks)
        if not changed:
            return vals, rounds


@pytest.mark.parametrize("n", [2, 4, 8])
def test_sharded_chase_matches_plain_round_loop(n):
    """Roots once a call and one gather a round: the same values in the
    same number of rounds as the round loop of the roll-select chase, for
    the flood seed and for the one-step parents."""
    from pybader_tpu_torch.parallel.chase import sharded_chase

    lay = tmesh.Layout(make_mesh(n, device="cpu"), SHAPE)
    bk = sharded.step_codes(tmesh.shard(lay, t(make_density(3))), W)
    seed, _, _ = sharded._seed_local(bk, None)
    parent = tmesh.Sharded(lay, [lay.parent(b, s)
                                 for s, b in enumerate(bk.blocks)])
    for values in (seed, parent):
        want, rounds = _plain_round_loop(lay, values, bk)
        stats = {}
        got = sharded_chase(lay.mesh, values, bk, stats=stats)
        assert torch.equal(got.join(), want.join())
        assert stats["rounds"] == rounds >= 2


@pytest.mark.parametrize("n", [2, 4, 8])
def test_hand_off_routes_lanes_to_owners(n):
    """hand_off sends each lane, its whole state with it, to the shard that
    owns its position; gather joins what a shard was handed twice."""
    lay = tmesh.Layout(make_mesh(n, device="cpu"), SHAPE)
    gen = torch.Generator().manual_seed(n)
    k = 300
    state = list(neargrid.shard_state(torch.randint(
        0, int(np.prod(SHAPE)), (k,), generator=gen, dtype=torch.int32)))
    state[3] = torch.rand((k, 3), generator=gen, dtype=torch.float64)
    state[4] = torch.arange(k, dtype=torch.int32)
    lane = torch.arange(k)
    into = [[] for _ in lay.ids]
    for part in (slice(0, 120), slice(120, k)):
        hand_off(lay, lane[part], tuple(a[part] for a in state), into)
    seen = []
    for s, parts in enumerate(into):
        if parts:
            ln, st = gather(parts)
            assert (lay.owner(st[0]) == s).all()
            for a, b in zip(st, state):
                assert torch.equal(a, b[ln])
            seen.append(ln)
    assert len(seen) == len(lay.ids)
    assert torch.equal(torch.cat(seen).sort().values, lane)


def test_edges_straddling_a_shard_boundary_need_two_voxel_halos():
    """Labels that change between x = 8 and 9 on shards of 8 x-planes: the
    edge at x = 8 decides x = 7's near-edge state, one shard over.  The
    mesh's edge_find and edge_check (2-voxel halos) equal the whole grid's,
    and a 1-voxel halo would not."""
    labels = np.zeros(SHAPE, np.int32)
    labels[9:13, :7] = 1
    labels[2:5, 10:] = 2
    is_max = np.zeros(SHAPE, bool)
    for n in (4, 8):
        lay = tmesh.Layout(make_mesh(n, device="cpu"), SHAPE)
        assert lay.local_shape[0] == 8
        lab = tmesh.shard(lay, t(labels))
        mx = tmesh.shard(lay, t(is_max))
        want = edges.edge_find(None, t(labels), t(is_max))
        assert (want[7, :7] == -1).all()
        known = sharded.edges_find(lab, mx)
        assert torch.equal(known.join(), want)
        one_halo = [tmesh.crop(edges.edge_find(None, a, b), lay, 1)
                    for a, b in zip(tmesh.halo(lab, 1), tmesh.halo(mx, 1))]
        assert not torch.equal(tmesh.Sharded(lay, one_halo).join(), want)
        moved = labels.copy()
        moved[9, :7] = 0
        kn = want.clone()
        kn[9, :7] = -2
        want_c = edges.edge_check(kn, t(moved), t(is_max))
        got_c = sharded.edges_check(tmesh.shard(lay, kn),
                                    tmesh.shard(lay, t(moved)), mx)
        assert torch.equal(got_c.join(), want_c)


def test_sharded_step_matches_jax():
    rho = make_density(2)
    _, maxima = pipeline.partition_ongrid(t(rho), None, W)
    roots, n_max, charge = sharded_step(make_mesh(8, device="cpu"), rho, W)
    jroots, jn, jcharge = jax_step(jax_mesh(8), rho, W)
    assert n_max == int(jn) == len(maxima)
    np.testing.assert_array_equal(roots.join().numpy(), np.asarray(jroots))
    np.testing.assert_allclose(charge.numpy(), np.asarray(jcharge),
                               rtol=1e-12)
    np.testing.assert_allclose(float(charge.sum()), rho.sum(), rtol=1e-12)


def test_sharded_analysis_stages_match():
    rho = make_density(5)
    labels, maxima = pipeline.partition_ongrid(t(rho), None, W)
    n_max = len(maxima)
    rng = np.random.default_rng(9)
    atoms_cart = rng.random((max(n_max // 2, 2), 3)) @ LATTICE
    n_atoms = len(atoms_cart)
    lat = t(LATTICE)
    mx_cart = (np.asarray(maxima) / np.asarray(SHAPE)) @ LATTICE
    atom_of_max, _ = assign_to_atoms(t(mx_cart), t(atoms_cart), lat)
    vols_1 = reductions.relabel(labels, atom_of_max)
    c1, v1 = reductions.charge_volume_sum(t(rho), vols_1, 0.123, n_atoms)
    known = edges.edge_find(t(rho), vols_1)
    d1 = surface_distance_masked(vols_1, known == -2, lat, t(atoms_cart),
                                 n_atoms)
    jvols = np.asarray(vols_1)
    for n in (4, 8):
        mesh, jm = make_mesh(n, device="cpu"), jax_mesh(n)
        vols_n = analysis.sharded_relabel(mesh, labels, atom_of_max)
        assert torch.equal(vols_n.join(), vols_1)
        cn, vn = analysis.sharded_charge_volume_sum(mesh, rho, vols_1, 0.123,
                                                    n_atoms)
        jc, jv = janalysis.sharded_charge_volume_sum(jm, rho, jvols, 0.123,
                                                     n_atoms)
        for got in (c1, np.asarray(jc)):
            np.testing.assert_allclose(cn.numpy(), np.asarray(got),
                                       rtol=1e-12)
        for got in (v1, np.asarray(jv)):
            np.testing.assert_allclose(vn.numpy(), np.asarray(got),
                                       rtol=1e-12)
        dn = analysis.sharded_min_surface_distance(
            mesh, rho, vols_1, LATTICE, atoms_cart, n_atoms)
        jd = janalysis.sharded_min_surface_distance(
            jm, rho, jvols, LATTICE, atoms_cart, n_atoms)
        for got in (d1, np.asarray(jd)):
            np.testing.assert_allclose(dn.numpy(), np.asarray(got),
                                       rtol=1e-10, atol=1e-12)


def test_dryrun_multichip_flow():
    """``__graft_entry__.dryrun_multichip`` on 8 shards, cut to 32^3 with 12
    blobs and vacuum at the 20th percentile: partition, sums, one
    refinement iteration, relabel and surface distance, each against the
    single-device path."""
    from __graft_entry__ import _synthetic_density

    shape = (32, 32, 32)
    lattice = np.diag([12.0, 12.0, 12.0])
    rho = _synthetic_density(shape, n_blobs=12, seed=3)
    w = tuple(g.distance_weights(lattice, shape))
    tg = g.t_grad(lattice, shape)
    vac = rho <= np.quantile(rho, 0.2)
    mesh = make_mesh(8, device="cpu")
    labels_1, maxima_1 = pipeline.partition_ongrid(t(rho), t(vac), w)
    labels_n, maxima_n = sharded_partition(mesh, rho, vac, w)
    assert torch.equal(labels_n.join(), labels_1)
    np.testing.assert_array_equal(maxima_n, maxima_1)
    n_max = len(maxima_n)
    assert n_max >= 8
    c1, v1 = reductions.charge_volume_sum(t(rho), labels_1, 1.0, n_max)
    cn, vn = analysis.sharded_charge_volume_sum(mesh, rho, labels_n, 1.0,
                                                n_max)
    np.testing.assert_allclose(cn.numpy(), c1.numpy(), rtol=1e-12)
    np.testing.assert_allclose(vn.numpy(), v1.numpy(), rtol=1e-12)
    ref_1, ch_1 = pipeline.refine_labels("neargrid", ("changed", 1), t(rho),
                                         labels_1, w, tg, verbose=False)
    ref_n, ch_n = pipeline.refine_labels("neargrid", ("changed", 1), t(rho),
                                         labels_n, w, tg, verbose=False,
                                         mesh=mesh)
    assert ch_n == ch_1 > 0
    assert torch.equal(ref_n.join(), ref_1)
    rng = np.random.default_rng(7)
    atoms_cart = rng.uniform(0, 1, size=(max(4, n_max // 3), 3)) @ lattice
    lat = t(lattice)
    mx_cart = (np.asarray(maxima_n) / np.asarray(shape)) @ lattice
    atom_of_max, _ = assign_to_atoms(t(mx_cart), t(atoms_cart), lat)
    vol_1 = reductions.relabel(ref_1, atom_of_max)
    vol_n = analysis.sharded_relabel(mesh, ref_n, atom_of_max)
    assert torch.equal(vol_n.join(), vol_1)
    known_1 = edges.edge_find(t(rho), vol_1)
    d_1 = surface_distance_masked(vol_1, known_1 == -2, lat, t(atoms_cart),
                                  len(atoms_cart))
    d_n = analysis.sharded_min_surface_distance(
        mesh, rho, vol_n.join(), lattice, atoms_cart, len(atoms_cart))
    np.testing.assert_allclose(d_n.numpy(), d_1.numpy(), rtol=1e-10,
                               atol=1e-12)


SPEED_VACUUM_SPIN = dict(method="ongrid", refine_mode=("changed", 3),
                         speed_flag=True, vacuum_tol=0.2, spin_flag=True)


@pytest.mark.parametrize("n, config", [(8, {}), (4, SPEED_VACUUM_SPIN)],
                         ids=["default", "speed-vacuum-spin"])
def test_bader_mesh_matches_jax_mesh_bader(tmp_path, monkeypatch, n, config):
    """``Bader.mesh`` on the fixture with ``output='dat'``: the default
    profile (on a mesh both packages run the hybrid: ongrid, the internal
    refinement, then a fresh ('changed', 2)), and the speed profile with a
    vacuum and spin (the atom map refined on the mesh).  Volume maps,
    maxima and the dat text equal JAX's mesh Bader; charges, volumes and
    distances within 1e-10."""
    jb = JaxBader.from_file(FIXTURE, **config)
    tb = Bader.from_dict(jb.as_dict, device="cpu")
    jb.mesh, tb.mesh = jax_mesh(n), make_mesh(n, device="cpu")
    for b, sub in ((jb, "jax"), (tb, "port")):
        (tmp_path / sub).mkdir()
        monkeypatch.chdir(tmp_path / sub)
        b(output="dat")
    for key in ("bader_volumes", "atoms_volumes", "bader_atoms",
                "bader_maxima_fractional"):
        if hasattr(jb, key):
            np.testing.assert_array_equal(getattr(tb, key),
                                          getattr(jb, key))
    for key in ("bader_charge", "bader_volume", "bader_spin", "atoms_charge",
                "atoms_volume", "atoms_spin", "atoms_surface_distance",
                "vacuum_charge", "vacuum_volume"):
        if hasattr(jb, key):
            np.testing.assert_allclose(getattr(tb, key), getattr(jb, key),
                                       rtol=0, atol=1e-10)
    dats = sorted(p.name for p in (tmp_path / "jax").glob("*.dat"))
    assert dats == sorted(p.name for p in (tmp_path / "port").glob("*.dat"))
    assert len(dats) == (1 if config else 2)
    for name in dats:
        assert (tmp_path / "port" / name).read_text() == \
            (tmp_path / "jax" / name).read_text()


@pytest.mark.parametrize("config", [{}, SPEED_VACUUM_SPIN],
                         ids=["default", "speed-vacuum-spin"])
def test_bader_mesh_call_holds_its_grids_sharded(tmp_path, monkeypatch,
                                                 config):
    """A ``Bader`` call on a 4-shard mesh (the speed profile with a vacuum
    and a spin grid) shards each input array from the host once, every
    later ``shard`` of it passing the held grid through; it records no
    ``host.astype``, ``host.copyto`` or ``host.vacuum_scan`` span, and
    joins each result label grid to the host once, when final, in its
    ``dtype_calc`` dtype."""
    import sys

    from pybader_tpu_torch import trace
    from pybader_tpu_torch.io import vasp

    density, lattice, atoms, info = vasp.read(FIXTURE)
    if config:
        density["spin"] = density["charge"] - density["charge"].mean()
    b = Bader(density, lattice, atoms, info, device="cpu", **config)
    b.mesh = make_mesh(4, device="cpu")
    real_shard, real_join = tmesh.shard, tmesh.Sharded.join
    whole, joined = [], []

    def shard(layout, full, dtype=None):
        if not isinstance(full, tmesh.Sharded):
            whole.append(full)
        return real_shard(layout, full, dtype)

    def join(grid, device="cpu"):
        joined.append(grid.dtype)
        return real_join(grid, device)

    for mod in list(sys.modules.values()):
        if mod is not None and mod.__name__.startswith("pybader_tpu_torch") \
                and getattr(mod, "shard", None) is real_shard:
            monkeypatch.setattr(mod, "shard", shard)
    monkeypatch.setattr(tmesh.Sharded, "join", join)
    # copies count what crosses to a card, as a CUDA mesh's would
    monkeypatch.setattr(trace, "moved",
                        lambda t, device: t.numel() * t.element_size())
    monkeypatch.chdir(tmp_path)
    b(output="dat")
    inputs = [b.density] + ([b.spin] if config else [])
    assert len(whole) == len(inputs)
    assert all(any(w is x for x in inputs) for w in whole)
    names = [s.name for s in b.spans]
    assert not {"host.astype", "host.copyto", "host.vacuum_scan",
                "host.vacuum_where", "upload.vacuum",
                "download.vacuum_mask", "download.refined"} & set(names)
    texts = 1 if config else 2
    assert sorted(n for n in names if n.startswith("host.")) == \
        ["host.results"] * texts + ["host.write"] * texts
    results = ["atoms_volumes"] if config else ["bader_volumes",
                                                 "atoms_volumes"]
    n = b.density.size
    grids = [s for s in b.spans if s.name.startswith(("upload.",
                                                      "download."))
             and s.counters["bytes"] >= n]
    assert sorted(s.name for s in grids) == sorted(
        ["download." + r for r in results]
        + ["upload." + i for i in ("density", "spin")[:len(inputs)]])
    assert len(joined) == len(results)
    for r, dtype in zip(results, joined):
        grid = getattr(b, r)
        assert grid.dtype == np.int8 and dtype == torch.int8
        span = next(s for s in grids if s.name == "download." + r)
        assert span.counters == {"bytes": grid.nbytes, "pinned": 0,
                                 "warm": 0}
    if config:
        assert b.vacuum_volume > 0 and (b.atoms_volumes == -1).any()
        assert b.atoms_spin.shape == (len(b.atoms),)
    held = {s.name for s in b.spans if s.name.startswith("resident.")}
    assert {"resident.atoms_volumes", "resident.density"} <= held


def test_pickling_drops_the_mesh(tmp_path):
    tb = Bader.from_dict(JaxBader.from_file(FIXTURE).as_dict, device="cpu",
                         method="ongrid", refine_method="ongrid")
    tb.mesh = make_mesh(4, device="cpu")
    tb(output=None)
    back = pickle.loads(pickle.dumps(tb))
    assert "mesh" not in back.__dict__ and back.mesh is None
    assert "_refine_carry" not in back.__dict__
    np.testing.assert_array_equal(back.atoms_charge, tb.atoms_charge)
