"""Parity: the port's neargrid edge refinement against the JAX package and
the clean-room serial oracle.

Labels and the per-iteration (edges walked, changed, step-cap fires) must
equal JAX's ``refine_labels`` stats for 'changed' and 'all' at 1, 2 and
converged (-1) iterations, with and without vacuum; labels must equal
``oracle.refine_oracle``.  The hybrid's internal refinement chained into a
user refinement through the carry must equal JAX's chain and one
continuous 'changed' call.
"""
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
    assert set(carry_t) == {"known", "bk", "is_max", "rows"}
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
