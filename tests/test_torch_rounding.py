"""The port's Alg. 1 rounding, Sec. V-D repair, best-of-trials argmax and
Eq. 40 metrics against the JAX package's, on the same fractional
solutions and uniforms: decisions (0/1 arrays, winning trials, per-trial
objectives) bit-identical, metrics within 1e-12 (float reductions)."""
import jax
import numpy as np
import pytest
import torch
from harness import make_instance, padded_stack, tiny_instance

from repro.core import cocar as CC
from repro.core import lp as LP
from repro.core.rounding import repair, round_from_uniforms
from repro.mec import metrics as MET
from repro_torch.core import cocar as TCC
from repro_torch.core import lp as TLP
from repro_torch.core import rounding as TR
from repro_torch.mec import metrics as TMET

HETERO = [(0, 40, 3), (1, 50, 4), (2, 35, 3)]
ITERS, S, BO = 300, 2, 3
MET_TOL = 1e-12


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float64))


def _one(inst):
    """A reference instance as the port's batch-of-one PDHGData."""
    return TLP.pdhg_data_from_numpy(
        {k: v[None] for k, v in LP.pdhg_data(inst)._asdict().items()},
        device="cpu")


def test_round_from_uniforms_bit_identical():
    inst = make_instance(n_users=30)
    x_f, A_f, _ = LP.solve_lp_scipy(inst)
    rng = np.random.default_rng(3)
    u_cat = rng.random((5, inst.N, inst.M))
    u_phi = rng.random((5, inst.N, inst.U, inst.H))
    xh, Ah = round_from_uniforms(np.asarray(x_f), np.asarray(A_f),
                                 inst.onehot_mu(), u_cat, u_phi)
    xd, Ad = TR.round_from_uniforms(_t(x_f)[None], _t(A_f)[None],
                                    _t(inst.onehot_mu())[None],
                                    _t(u_cat)[None], _t(u_phi)[None])
    assert np.array_equal(xd[0].numpy(), xh)
    assert np.array_equal(Ad[0].numpy(), Ah)


def _route(inst, entries):
    A = np.zeros((inst.N, inst.U, inst.H))
    for n, u, h in entries:
        A[n, u, h] = 1.0
    return A


def _cache(inst, levels):
    x = np.zeros((inst.N, inst.M, inst.H + 1))
    for (n, m), h in levels.items():
        x[n, m, h] = 1.0
    return x


REPAIR_CASES = {
    # slack fits the next-smaller submodel: downgrade h2 -> h1
    "downgrade": (dict(R=32.0), {(0, 0): 2, (0, 1): 2},
                  [(0, 0, 1), (0, 1, 1)]),
    # no smaller submodel fits: evict to h0, drop the orphaned user
    "evict_h0": (dict(R=25.0), {(0, 0): 2, (0, 1): 2},
                 [(0, 0, 1), (0, 1, 1)]),
    # a chain of evictions until the budget fits
    "chain": (dict(R=21.0), {(0, 0): 2, (0, 1): 2}, [(0, 0, 1), (0, 1, 1)]),
    # duplicate routes with an exact precision tie: keep the smaller BS
    "dedupe_tie": (dict(n_bs=2, m_u=(0,), R=100.0),
                   {(0, 0): 2, (1, 0): 2, (0, 1): 0, (1, 1): 0},
                   [(0, 0, 1), (1, 0, 1)]),
    # infeasible everywhere: kicked out and never re-routed
    "infeasible": (dict(ddl=1e-6, R=100.0), {(0, 0): 2, (0, 1): 2},
                   [(0, 0, 1), (0, 1, 1)]),
    # unserved user re-routed to a cached feasible replica
    "reroute": (dict(n_bs=2, m_u=(0,), R=100.0),
                {(0, 0): 0, (1, 0): 2, (0, 1): 0, (1, 1): 0}, []),
}


@pytest.mark.parametrize("case", sorted(REPAIR_CASES))
def test_repair_edge_cases_bit_identical(case):
    kw, levels, routes = REPAIR_CASES[case]
    inst = tiny_instance(**kw)
    x, A = _cache(inst, levels), _route(inst, routes)
    xh, Ah = repair(inst, x, A)
    xd, Ad = TR.repair_device(_one(inst), _t(x)[None, None],
                              _t(A)[None, None])
    assert np.array_equal(xd[0, 0].numpy(), xh)
    assert np.array_equal(Ad[0, 0].numpy(), Ah)
    # the metrics of a repaired solution (enforcement is an identity)
    ref = MET.window_metrics(inst, xh, Ah)
    got = TMET.window_metrics_device(_one(inst), xd[:, :1], Ad[:, :1])
    for k in got:
        assert abs(float(got[k][0, 0]) - float(ref[k])) <= MET_TOL, k


def test_decisions_from_reference_fractionals_bit_identical():
    """Given the JAX pipeline's own fractional LP solution and uniforms,
    round → repair → argmax → metrics in the port reproduce its decisions
    bit for bit on the padded heterogeneous stack."""
    insts, stacked = padded_stack(HETERO)
    B = len(insts)
    N, U, H = stacked.data.T.shape[1:]
    M = stacked.data.sizes.shape[1]
    rng = np.random.default_rng(7)
    u_cat = rng.random((B, S * BO, N, M))
    u_phi = rng.random((B, S * BO, N, U, H))
    with jax.enable_x64():
        ref = CC._pipeline_jitted("reference", False)(
            stacked.data, u_cat, u_phi, ITERS, S)
    ref = jax.tree.map(np.asarray, ref)
    data = TLP.pdhg_data_from_numpy(stacked.data, device="cpu")
    got = TCC._decide(data, _t(ref["x_frac"]), _t(ref["A_frac"]),
                      _t(u_cat), _t(u_phi), S)
    assert np.array_equal(got["x"].numpy(), ref["x"])
    assert np.array_equal(got["A"].numpy(), ref["A"])
    assert np.array_equal(got["best_t"].numpy(), ref["best_t"])
    assert np.array_equal(got["trial_objs"].numpy(), ref["trial_objs"])
    for k, v in ref["metrics"].items():
        assert np.abs(got["metrics"][k].numpy() - v).max() <= MET_TOL, k
