"""Parity: the port's nginit codes and the hybrid's nginit init
(``PYBADER_TPU_HYBRID_INIT=nginit``) against the JAX package.

Tolerance: none.  The codes are integers; the f64 gradient they come from
is built unfused in JAX's order, and the codes must be identical on these
fields.  Labels, maxima and the internal refinement's per-iteration stats
(edges, changed, cap fires, risky lanes) must be identical too; under the
default row mode the port walks exact rows where JAX runs its screened
walk (identical results), so the risky count, the cost of JAX's screen, is
compared only under ``PYBADER_TPU_QROWS=internal``.  The vacuum is a
density threshold, as the interface makes it.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pybader_tpu import grid as jgrid
from pybader_tpu import pipeline as jpipe
from pybader_tpu.ops.stencil import neargrid_init_codes, ongrid_step_codes
from pybader_tpu_torch import pipeline as tpipe
from pybader_tpu_torch.ops import stencil as tstencil
from tests.test_hybrid_parity import LATTICE, _density

torch.set_num_threads(1)


def consts(shape):
    return tuple(jgrid.distance_weights(LATTICE, shape)), \
        jgrid.t_grad(LATTICE, shape)


@pytest.mark.parametrize("shape,seed", [((24, 28, 32), 0), ((24, 28, 32), 3),
                                        ((32, 32, 32), 1)])
def test_nginit_codes_match_jax(shape, seed):
    rho = _density(shape, seed)
    w, tg = consts(shape)
    bk = ongrid_step_codes(jnp.asarray(rho), w)
    want = np.asarray(neargrid_init_codes(jnp.asarray(rho), bk,
                                          jnp.asarray(tg)))
    got = tstencil.neargrid_init_codes(
        torch.from_numpy(rho), torch.from_numpy(np.asarray(bk)), tg)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != np.asarray(bk)).any()


@pytest.mark.parametrize("vacuum", [False, True])
def test_partition_nginit_matches_jax(vacuum):
    shape = (24, 28, 32)
    rho = _density(shape, 2)
    w, tg = consts(shape)
    vac = rho <= np.quantile(rho, 0.25) if vacuum else None
    jl, jm = jpipe._partition_nginit(
        jnp.asarray(rho), None if vac is None else jnp.asarray(vac), w, tg)
    tl, tm = tpipe.partition_nginit(
        torch.from_numpy(rho), None if vac is None else torch.from_numpy(vac),
        w, tg)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tm, np.asarray(jm))


@pytest.mark.parametrize("qrows", ["screened", "internal"])
@pytest.mark.parametrize("vacuum", [False, True])
def test_nginit_hybrid_matches_jax(monkeypatch, vacuum, qrows):
    """partition_neargrid's nginit hybrid, its one internal iteration
    chained into a user ('changed', 2) through the carry."""
    monkeypatch.setenv("PYBADER_TPU_HYBRID_INIT", "nginit")
    monkeypatch.setenv("PYBADER_TPU_QROWS", qrows)
    monkeypatch.setenv("PYBADER_TPU_QROWS_CPU", "1")
    fields = 4 if qrows == "internal" else 3
    shape = (32, 32, 32)
    rho = _density(shape, 3)
    w, tg = consts(shape)
    vac = rho <= np.quantile(rho, 0.25) if vacuum else None
    js, ts, carry_j, carry_t = {}, {}, {}, {}
    jl, jm = jpipe.partition_neargrid(rho, vac, w, tg,
                                      full_trajectories=False,
                                      carry_out=carry_j, stats=js)
    tl, tm = tpipe.partition_neargrid(
        torch.from_numpy(rho), None if vac is None else torch.from_numpy(vac),
        w, tg, full_trajectories=False, carry_out=carry_t, stats=ts)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tm, np.asarray(jm))
    assert [i[:fields] for i in ts["iterations"]] == \
        [i[:fields] for i in js["iterations"]]
    assert len(ts["iterations"]) == 1 and ts["iterations"][0][1] > 0
    jl, jc = jpipe.refine_labels("neargrid", ("changed", 2), rho, jl, w, tg,
                                 verbose=False, carry_in=carry_j)
    tl, tc = tpipe.refine_labels("neargrid", ("changed", 2),
                                 torch.from_numpy(rho), tl, w, tg,
                                 verbose=False, carry_in=carry_t)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert tc == jc


def test_nginit_codes_wrapper_rejects_cpu_tensors():
    shape = (24, 28, 32)
    rho = torch.from_numpy(_density(shape, 0))
    w, tg = consts(shape)
    bk = tstencil.ongrid_step_codes(rho, w)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tstencil.neargrid_init_codes_cuda(rho, bk, tg)
