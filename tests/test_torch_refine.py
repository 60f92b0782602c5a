"""Parity: the port's neargrid edge refinement against the JAX package and
the clean-room serial oracle.

Labels and the per-iteration (edges walked, changed, step-cap fires) must
equal JAX's ``refine_labels`` stats for 'changed' and 'all' at 1, 2 and
converged (-1) iterations, with and without vacuum; labels must equal
``oracle.refine_oracle``.  The hybrid's internal refinement chained into a
user refinement through the carry must equal JAX's chain and one
continuous 'changed' call, also under the environment variants
(``PYBADER_TPU_QROWS``, ``_INTERNAL_CAP``, ``_BLOCK_WALK``,
``_HYBRID_INIT``): labels, maxima and the per-iteration stats, the risky
counts included wherever both packages walk quantised rows.  Tolerance:
none, everything compared is integer.
"""
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pybader_tpu import grid as jgrid
from pybader_tpu import pipeline as jpipe
from pybader_tpu_torch import pipeline as tpipe
from pybader_tpu_torch.ops import neargrid as tng
from tests.oracle import refine_oracle
from tests.test_torch_pipeline import LATTICE, SHAPE, make_density

torch.set_num_threads(1)

W = tuple(jgrid.distance_weights(LATTICE, SHAPE))
TG = jgrid.t_grad(LATTICE, SHAPE)


def ongrid_labels(rho, vac=None):
    labels, _ = jpipe.partition_ongrid(rho, vac, W)
    return np.array(labels)


def counts(stats):
    return [it[:3] for it in stats["iterations"]]


def both_refine(rho, labels, mode, iters, **jax_kw):
    js, ts = {}, {}
    jl, jc = jpipe.refine_labels("neargrid", (mode, iters), rho,
                                 jnp.asarray(labels), W, TG, verbose=False,
                                 stats=js, **jax_kw)
    tl, tc = tpipe.refine_labels("neargrid", (mode, iters),
                                 torch.from_numpy(rho),
                                 torch.from_numpy(labels), W, TG,
                                 verbose=False, stats=ts)
    assert tc == jc
    assert counts(ts) == counts(js)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    return tl.numpy(), tc, ts


@pytest.mark.parametrize("mode", ["changed", "all"])
@pytest.mark.parametrize("iters", [1, 2, -1])
def test_refine_matches_jax_and_oracle(mode, iters):
    seed = {1: 0, 2: 6, -1: 9}[iters]
    rho = make_density(seed)
    labels = ongrid_labels(rho)
    tl, tc, ts = both_refine(rho, labels, mode, iters)
    assert tc > 0
    if iters > 0:
        assert len(ts["iterations"]) <= iters
    ol, oc = refine_oracle(rho, W, TG, labels, mode, iters)
    np.testing.assert_array_equal(tl, ol)
    assert tc == oc


@pytest.mark.parametrize("mode", ["changed", "all"])
def test_refine_with_vacuum_matches_jax_and_oracle(mode):
    rho = make_density(2)
    vac = rho <= np.quantile(rho, 0.25)
    labels = ongrid_labels(rho, vac)
    tl, tc, _ = both_refine(rho, labels, mode, 2)
    ol, oc = refine_oracle(rho, W, TG, labels, mode, 2,
                           skip_vacuum_edges=True)
    np.testing.assert_array_equal(tl, ol)
    assert (tl[vac] == -1).all()


def test_refine_cap_fires_match_jax(monkeypatch):
    """A step cap of 3: stragglers resolve through their ongrid roots in
    both packages, with the same cap-fire counts."""
    monkeypatch.setattr(tng, "refine_cap", lambda shape: 3)
    rho = make_density(1)
    _, _, ts = both_refine(rho, ongrid_labels(rho), "changed", 2,
                           step_cap=3)
    assert ts["iterations"][0][2] > 0


def test_hybrid_carry_chain_matches_jax_and_continuous():
    """partition_neargrid's hybrid internal ('changed', 3) chained into a
    user ('changed', 2) through the carry == JAX's chain == one
    ('changed', 5) call on the ongrid labels (this density changes
    voxels in four iterations, so the carry is not converged)."""
    rho = make_density(9)
    rho_t = torch.from_numpy(rho)
    carry_j, carry_t = {}, {}
    jl, _ = jpipe.partition_neargrid(rho, None, W, TG,
                                     full_trajectories=False,
                                     carry_out=carry_j)
    jl, jc = jpipe.refine_labels("neargrid", ("changed", 2), rho, jl, W, TG,
                                 verbose=False, carry_in=carry_j)
    tl, _ = tpipe.partition_neargrid(rho_t, None, W, TG,
                                     full_trajectories=False,
                                     carry_out=carry_t)
    assert set(carry_t) == {"known", "bk", "is_max", "rows", "qrows"}
    tl, tc = tpipe.refine_labels("neargrid", ("changed", 2), rho_t, tl, W,
                                 TG, verbose=False, carry_in=carry_t)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert tc == jc
    one, _ = tpipe.refine_labels("neargrid", ("changed", 5), rho_t,
                                 torch.from_numpy(ongrid_labels(rho)), W, TG,
                                 verbose=False)
    np.testing.assert_array_equal(tl.numpy(), one.numpy())


def test_converged_carry_short_circuits():
    rho = torch.from_numpy(make_density(6))
    labels = torch.from_numpy(ongrid_labels(rho.numpy()))
    carry = {}
    lab, changed = tpipe.refine_labels("neargrid", ("changed", -1), rho,
                                       labels, W, TG, verbose=False,
                                       carry_out=carry)
    assert changed > 0 and carry == {"converged": True}
    lab2, changed2 = tpipe.refine_labels("neargrid", ("changed", 2), rho,
                                         lab, W, TG, verbose=False,
                                         carry_in=carry)
    assert changed2 == 0 and lab2 is lab


def test_refine_leaves_its_input_untouched():
    rho = torch.from_numpy(make_density(7))
    labels = torch.from_numpy(ongrid_labels(rho.numpy()))
    before = labels.clone()
    out, changed = tpipe.refine_labels("neargrid", ("changed", 2), rho,
                                       labels, W, TG, verbose=False)
    assert changed > 0 and not torch.equal(out, before)
    assert torch.equal(labels, before)


def both_hybrids(rho, lattice=None, vac=None, fields=4):
    """partition_neargrid's hybrid chained into a user ('changed', 2)
    through the carry, in both packages, under the caller's environment:
    labels, maxima and both calls' per-iteration stats must be equal (the
    first ``fields`` of each tuple)."""
    shape = rho.shape
    w, tg = W, TG
    if lattice is not None:
        w = tuple(jgrid.distance_weights(lattice, shape))
        tg = jgrid.t_grad(lattice, shape)
    out = []
    for pipe, arr in ((jpipe, np.asarray), (tpipe, torch.from_numpy)):
        s1, s2, carry = {}, {}, {}
        labels, maxima = pipe.partition_neargrid(
            arr(rho), None if vac is None else arr(vac), w, tg,
            full_trajectories=False, carry_out=carry, stats=s1)
        labels, changed = pipe.refine_labels(
            "neargrid", ("changed", 2), arr(rho), labels, w, tg,
            verbose=False, carry_in=carry, stats=s2)
        out.append((np.asarray(labels), np.asarray(maxima), changed,
                    [it[:fields] for it in s1["iterations"] + s2.get(
                        "iterations", [])]))
    (jl, jm, jc, js), (tl, tm, tc, ts) = out
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(tm, jm)
    assert tc == jc and ts == js
    return ts


@pytest.mark.parametrize("qrows,cpu_gate", [
    ("internal", "1"), ("all", "1"), ("internal", "0"), ("off", "0")])
def test_hybrid_qrow_modes_match_jax(monkeypatch, qrows, cpu_gate):
    """Unscreened q-rows for the internal iterations (internal) or for
    both calls (all); without PYBADER_TPU_QROWS_CPU=1 both packages walk
    exact rows on the CPU instead."""
    monkeypatch.setenv("PYBADER_TPU_QROWS", qrows)
    monkeypatch.setenv("PYBADER_TPU_QROWS_CPU", cpu_gate)
    rho = make_density(9)
    vac = rho <= np.quantile(rho, 0.2)
    ts = both_hybrids(rho, vac=vac)
    assert ts[0][1] > 0


@pytest.mark.parametrize("qrows", ["screened", "internal"])
def test_internal_cap_matches_jax(monkeypatch, qrows):
    """PYBADER_TPU_INTERNAL_CAP=2 caps the internal walks only; capped
    lanes resolve through their ongrid roots in both packages."""
    monkeypatch.setenv("PYBADER_TPU_INTERNAL_CAP", "2")
    monkeypatch.setenv("PYBADER_TPU_QROWS", qrows)
    monkeypatch.setenv("PYBADER_TPU_QROWS_CPU", "1")
    ts = both_hybrids(make_density(9), fields=4 if qrows == "internal" else 3)
    assert ts[0][2] > 0


def enable_block_walk(monkeypatch, min_lanes):
    from pybader_tpu.ops import block_walk as jbw
    from pybader_tpu_torch.ops import block_walk as tbw

    monkeypatch.setattr(jbw, "_ENABLED", True)
    monkeypatch.setattr(jbw, "_MIN_LANES", min_lanes)
    monkeypatch.setenv("PYBADER_TPU_BLOCK_WALK", "1")
    monkeypatch.setattr(tbw, "_MIN_LANES", min_lanes)


@pytest.mark.parametrize("env", [
    {}, {"PYBADER_TPU_INTERNAL_CAP": "3"},
    {"PYBADER_TPU_INTERNAL_CAP": "3", "PYBADER_TPU_QROWS": "all",
     "PYBADER_TPU_QROWS_CPU": "1"},
    {"PYBADER_TPU_HYBRID_INIT": "nginit", "PYBADER_TPU_QROWS": "internal",
     "PYBADER_TPU_QROWS_CPU": "1"}])
def test_hybrid_with_block_walk_matches_jax(monkeypatch, env):
    """PYBADER_TPU_BLOCK_WALK=1 on a grid of whole 16x16x128 blocks: every
    walk runs the block phase (the lane minimum lowered to 1024), screened
    walks included, so the risky counts are compared too.  With a cap that
    fires, labels follow the block rounds exactly."""
    from tests import test_block_walk as big

    enable_block_walk(monkeypatch, 1024)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    ts = both_hybrids(big.make_density(0), big.LATTICE)
    if "PYBADER_TPU_INTERNAL_CAP" in env:
        assert ts[0][2] > 0


@pytest.mark.parametrize("cap,vacuum", [(0, False), (2, False), (2, True)])
def test_full_trajectories_with_block_walk_match_jax(monkeypatch, cap,
                                                     vacuum):
    """The full-trajectory partition's screened q walk with the block
    phase, in one 2^17-lane batch (the non-vacuum starts, padded); with a
    cap of 2 most lanes are capped after their block rounds."""
    from pybader_tpu.ops import neargrid as jng
    from tests import test_block_walk as big

    enable_block_walk(monkeypatch, 1 << 17)
    if cap:
        monkeypatch.setattr(tng, "initial_cap", lambda shape: cap)
        real = jng.walk_drain_screened

        def capped(*args, **kwargs):
            kwargs["max_steps"] = cap
            return real(*args, **kwargs)

        monkeypatch.setattr(jng, "walk_drain_screened", capped)
    rho = big.make_density(0)
    shape = rho.shape
    w = tuple(jgrid.distance_weights(big.LATTICE, shape))
    tg = jgrid.t_grad(big.LATTICE, shape)
    vac = rho <= np.quantile(rho, 0.05) if vacuum else None
    jl, jm = jpipe.partition_neargrid(rho, vac, w, tg,
                                      full_trajectories=True)
    stats = {}
    tl, tm = tpipe.partition_neargrid(
        torch.from_numpy(rho), None if vac is None else torch.from_numpy(vac),
        w, tg, full_trajectories=True, stats=stats)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tm, np.asarray(jm))
    assert (stats["cap_fires"] > 0) == bool(cap)
    assert stats["block_rounds"]


# (environment, the Variants fields it sets): every setting the tests of
# the port set, with the options the pipeline and the ops read from it
VARIANT_TABLE = [
    ({}, {}),
    ({"PYBADER_TPU_FULL_TRAJECTORIES": "0"}, {"full_trajectories": False}),
    ({"PYBADER_TPU_FULL_TRAJECTORIES": "OFF"}, {"full_trajectories": False}),
    ({"PYBADER_TPU_FULL_TRAJECTORIES": "1"}, {"full_trajectories": True}),
    ({"PYBADER_TPU_INTERNAL_ITERS": "1"}, {"internal_iters": 1}),
    ({"PYBADER_TPU_INTERNAL_ITERS": "-1"}, {"internal_iters": -1}),
    ({"PYBADER_TPU_INTERNAL_CAP": "2"}, {"internal_cap": 2}),
    ({"PYBADER_TPU_INTERNAL_CAP": "0"}, {}),
    ({"PYBADER_TPU_HYBRID_INIT": "nginit"}, {"hybrid_init": "nginit"}),
    ({"PYBADER_TPU_QROWS": "screened"}, {}),
    ({"PYBADER_TPU_QROWS": "internal", "PYBADER_TPU_QROWS_CPU": "1"},
     {"internal_rows": "q", "profile_rows": "exact", "qrows_cpu": True}),
    ({"PYBADER_TPU_QROWS": "internal", "PYBADER_TPU_QROWS_CPU": "0"},
     {"internal_rows": "q", "profile_rows": "exact"}),
    ({"PYBADER_TPU_QROWS": "all"}, {"internal_rows": "q",
                                    "profile_rows": "q"}),
    ({"PYBADER_TPU_QROWS": "off"}, {"internal_rows": "exact",
                                    "profile_rows": "exact"}),
    ({"PYBADER_TPU_BLOCK_WALK": "1"}, {"block_steps": 24}),
    ({"PYBADER_TPU_BLOCK_WALK": "1", "PYBADER_TPU_BLOCK_STEPS": "5"},
     {"block_steps": 5}),
    ({"PYBADER_TPU_BLOCK_WALK": "0", "PYBADER_TPU_BLOCK_STEPS": "5"}, {}),
    ({"PYBADER_TPU_FINE_BUCKETS": "0"}, {"fine_buckets": False}),
]


def clear_variants(monkeypatch):
    for k in list(os.environ):
        if k.startswith("PYBADER_TPU_"):
            monkeypatch.delenv(k)


@pytest.mark.parametrize("env,fields", VARIANT_TABLE,
                         ids=[",".join(f"{k[12:]}={v}" for k, v in e.items())
                              or "unset" for e, _ in VARIANT_TABLE])
def test_read_variants_table(monkeypatch, env, fields):
    """The one reader of the variants' environment gives the options the
    port's reads gave: unset, screened rows for both kinds of walk (which
    :func:`tpipe._row_format` makes exact without the block phase), no
    block phase, the fine buckets, the path chosen by size."""
    clear_variants(monkeypatch)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    want = tpipe.Variants(**fields)
    assert tpipe.read_variants() == want
    assert tpipe.Variants() == tpipe.Variants(
        full_trajectories=None, hybrid_init="ongrid", internal_iters=None,
        internal_cap=None, internal_rows="qs", profile_rows="qs",
        qrows_cpu=False, block_steps=None, fine_buckets=True)
    rho = torch.zeros(2)
    # the row format each refinement walks on the CPU
    kinds = {q: tpipe._row_format(q, rho, want)
             for q in (None, want.internal_rows)}
    block = want.block_steps is not None
    for q, kind in kinds.items():
        rows = want.profile_rows if q is None else q
        assert kind == {"qs": "qs" if block else "exact",
                        "q": "q" if want.qrows_cpu else "exact",
                        "exact": "exact"}[rows]


def test_default_refinement_walks_its_edges_unpadded(monkeypatch):
    """With no variant set, the hybrid's internal walks and the profile's
    hand ``neargrid_walk`` exactly their edges (no padding lane, no
    chunk), and the labels and per-iteration counts equal JAX's."""
    clear_variants(monkeypatch)
    real = tng.neargrid_walk
    seen = []

    def walk(rows, starts, *args, **kwargs):
        seen.append(starts.clone())
        return real(rows, starts, *args, **kwargs)

    monkeypatch.setattr(tng, "neargrid_walk", walk)
    ts = both_hybrids(make_density(9), fields=3)
    assert [s.numel() for s in seen] == [it[0] for it in ts]
    assert len(seen) >= 3 and all(bool((s >= 0).all()) for s in seen)
