"""The port's deterministic reductions and feasibility checks against the
JAX package's: ``tree_sum`` and ``objective_sel`` bit-identical (no
tolerance), feasibility residuals within 1e-12 (plain float sums)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from harness import make_instance

from repro.core import jdcr as J
from repro.core import lp as LP
from repro_torch.core import jdcr as TJ
from repro_torch.core import lp as TLP


@pytest.mark.parametrize("n", [1, 2, 3, 7, 17, 64, 150, 600])
def test_tree_sum_bit_identical_to_numpy_and_jax(n):
    rng = np.random.default_rng(n)
    v = rng.standard_normal((5, n, 3))
    for axis in (1, -2):
        ref = J.tree_sum(v, axis)
        with jax.enable_x64():
            ref_j = np.asarray(J.tree_sum(jnp.asarray(v), axis))
        got_np = TJ.tree_sum(v, axis)
        got_t = TJ.tree_sum(torch.from_numpy(v), axis).numpy()
        for got in (got_np, got_t, ref_j):
            assert np.array_equal(got, ref)
    # trailing zero padding changes no bit
    padded = np.concatenate([v, np.zeros((5, 37, 3))], axis=1)
    assert np.array_equal(
        TJ.tree_sum(torch.from_numpy(padded), 1).numpy(), J.tree_sum(v, 1))


def test_tree_sum_empty_axis():
    assert TJ.tree_sum(torch.zeros((3, 0)), -1).shape == (3,)
    assert TJ.tree_sum(np.zeros((3, 0)), -1).shape == (3,)


def test_objective_sel_bit_identical():
    rng = np.random.default_rng(1)
    prec_u = rng.random((50, 3))
    A = (rng.random((4, 6, 50, 3)) < 0.2).astype(np.float64)    # (B,N,U,H)
    got = TJ.objective_sel(torch.from_numpy(prec_u), torch.from_numpy(A))
    for b in range(4):
        assert float(got[b]) == float(J.objective_sel(prec_u, A[b]))


def test_check_feasible_matches_reference():
    inst = make_instance(seed=3, n_users=30)
    rng = np.random.default_rng(2)
    x = rng.random((inst.N, inst.M, inst.H + 1))
    A = rng.random((inst.N, inst.U, inst.H))
    ref = J.check_feasible(inst, x, A)
    tinst = TJ.JDCRInstance(**{k: getattr(inst, k)
                               for k in inst.__dataclass_fields__})
    got = TJ.check_feasible(tinst, x, A)
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k] == ref[k], k


def test_check_feasible_device_matches_reference():
    """Batched over padded windows; residuals per window within 1e-12."""
    from repro.mec.scenario import stack_instances

    insts = [make_instance(seed=s, n_users=u, n_bs=n)
             for s, u, n in ((0, 40, 3), (1, 50, 4))]
    stacked = stack_instances(insts)
    rng = np.random.default_rng(4)
    B, N, U, H = stacked.data.T.shape
    M = stacked.data.sizes.shape[1]
    x = (rng.random((B, N, M, H + 1)) < 0.4).astype(np.float64)
    A = (rng.random((B, N, U, H)) < 0.1).astype(np.float64)
    data = TLP.pdhg_data_from_numpy(stacked.data, device="cpu")
    got = TJ.check_feasible_device(data, torch.from_numpy(x),
                                   torch.from_numpy(A))
    for b in range(B):
        d = LP.PDHGData(*(v[b] for v in stacked.data))
        with jax.enable_x64():
            ref = J.check_feasible_device(d, jnp.asarray(x[b]),
                                          jnp.asarray(A[b]))
        for k, v in ref.items():
            assert abs(float(got[k][b]) - float(v)) <= 1e-12, (k, b)
