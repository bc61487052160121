"""The port's plain float64 PDHG solver against the JAX package's
``core/lp.py::_pdhg_kernel`` on the padded heterogeneous stack the
reference's own fused tests use (tolerance 1e-9: the same float64
iteration, summed in another order)."""
import jax
import numpy as np
import pytest
import torch
from harness import make_instance, padded_stack

from repro.core import lp as LP
from repro_torch.core import jdcr as TJ
from repro_torch.core import lp as TLP

HETERO = [(0, 40, 3), (1, 50, 4), (2, 35, 3)]
ITERS = 300
TOL = 1e-9


def _window(data, b):
    return LP.PDHGData(*(v[b] for v in data))


def _tinst(inst):
    return TJ.JDCRInstance(**{k: getattr(inst, k)
                              for k in inst.__dataclass_fields__})


def test_reference_lp_matches_jax_pdhg_kernel():
    insts, stacked = padded_stack(HETERO)
    data = TLP.pdhg_data_from_numpy(stacked.data, device="cpu")
    x, A = TLP._pdhg_kernel(data, ITERS)
    assert x.dtype == A.dtype == torch.float64
    for b in range(len(insts)):
        with jax.enable_x64():
            x_r, A_r = LP._pdhg_kernel(_window(stacked.data, b), ITERS)
        assert np.abs(x[b].numpy() - np.asarray(x_r)).max() <= TOL
        assert np.abs(A[b].numpy() - np.asarray(A_r)).max() <= TOL
        # padded base stations never route
        assert (A[b, insts[b].N:] == 0).all()


def test_batched_solve_equals_per_window_solves():
    """Padding is inert: each window of the padded batch solves exactly
    as it does alone (1e-12: only the einsum summation order differs)."""
    insts, stacked = padded_stack(HETERO)
    data = TLP.pdhg_data_from_numpy(stacked.data, device="cpu")
    res = TLP.solve_lp_pdhg_batched(data, iters=ITERS)
    for (xb, Ab), inst in zip(stacked.unstack(res.x, res.A), insts):
        x1, A1 = TLP._pdhg_kernel(TLP.pdhg_data(_tinst(inst), device="cpu"),
                                  ITERS)
        assert np.abs(xb - x1[0].numpy()).max() <= 1e-12
        assert np.abs(Ab - A1[0].numpy()).max() <= 1e-12
    np.testing.assert_allclose(
        res.objs, np.einsum("bnuh,buh->b", res.A, stacked.data.prec_u),
        rtol=1e-12)


@pytest.mark.parametrize("backend", ["reference", "fused"])
def test_solve_lp_pdhg_api(backend):
    inst = _tinst(make_instance(seed=6, n_users=30))
    res = TLP.solve_lp_pdhg(inst, iters=ITERS, backend=backend, device="cpu")
    assert res.x.shape == (inst.N, inst.M, inst.H + 1)
    assert res.A.shape == (inst.N, inst.U, inst.H)
    assert res.primal_res < 0.05 and res.obj > 0
    assert res.converged == (res.primal_res <= res.tol)
    assert res.primal_res == TLP.pdhg_primal_residual(inst, res.x, res.A)
    assert res.primal_res == LP.pdhg_primal_residual(inst, res.x, res.A)


def test_unknown_backend_raises():
    inst = _tinst(make_instance(seed=6, n_users=10))
    with pytest.raises(ValueError, match="unknown LP backend"):
        TLP._lp_solve_kernel(TLP.pdhg_data(inst, device="cpu"), 2, "pallas")
