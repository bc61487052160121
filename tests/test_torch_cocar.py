"""The whole slice: the port's ``cocar_grid`` (LP → rounding → repair →
best-of-trials → metrics) against the JAX package's fused pipeline
``cocar._pipeline_jitted``, fed the same numpy uniforms.  Decisions and
winning trials bit-identical for both LP backends (``assert_same_offline``);
metrics within 1e-9 (the reference's own cross-engine bound); the fused
backend's fractional solution certified against the reference's by the
threshold-shift certificate at this size, and shown to be outgrown at a
larger one by the JAX package's own fused pipeline as well."""
import jax
import numpy as np
import pytest
from harness import (assert_obj_close, assert_same_offline, make_instance,
                     padded_stack, threshold_shift_certificate)

from repro.core import cocar as CC
from repro.experiments import sweep as SW
from repro.mec.scenario import stack_instances
from repro_torch.core import cocar as TCC
from repro_torch.core import jdcr as TJ
from repro_torch.experiments import sweep as TSW
from repro_torch.mec import scenario as TSC

HETERO = [(0, 40, 3), (1, 50, 4), (2, 35, 3)]
ITERS, S, BO = 300, 2, 3
JAX_BACKEND = {"reference": "reference", "fused": "pallas"}


def _tinst(inst):
    return TJ.JDCRInstance(**{k: getattr(inst, k)
                              for k in inst.__dataclass_fields__})


def _uniforms(stacked, seed=7, best_of=BO):
    B = len(stacked)
    N, U, H = stacked.data.T.shape[1:]
    M = stacked.data.sizes.shape[1]
    rng = np.random.default_rng(seed)
    return (rng.random((B, S * best_of, N, M)),
            rng.random((B, S * best_of, N, U, H)))


def _jax_pipeline(stacked, u_cat, u_phi, backend, iters=ITERS):
    with jax.enable_x64():
        out = CC._pipeline_jitted(backend, False)(stacked.data, u_cat, u_phi,
                                                  iters, S)
    return jax.tree.map(np.asarray, out)


@pytest.mark.parametrize("lp_backend", ["reference", "fused"])
def test_cocar_grid_matches_jax_pipeline(lp_backend):
    insts, stacked = padded_stack(HETERO)
    u_cat, u_phi = _uniforms(stacked)
    ref_out = _jax_pipeline(stacked, u_cat, u_phi, JAX_BACKEND[lp_backend])
    ref = CC._unstack_device(stacked, ref_out, S)
    tst = TSC.stack_instances([_tinst(i) for i in insts], device="cpu")
    got = TCC._unstack_device(tst, TCC.offline_pipeline_device(
        tst, u_cat, u_phi, ITERS, S, lp_backend), S)
    assert_same_offline(got, ref)
    for per_g, per_r in zip(got, ref):
        for (_, _, ig), (_, _, ir) in zip(per_g, per_r):
            np.testing.assert_array_equal(ig["trial_objs"], ir["trial_objs"])
            assert ig["obj"] == ir["obj"]
            # lp_obj sums the fractional A: 1e-9 in float64; through the
            # float32 sweep, float32 noise (relative 1e-6)
            atol = 1e-9 if lp_backend == "reference" \
                else 1e-6 * abs(ir["lp_obj"])
            assert_obj_close(ig["lp_obj"], ir["lp_obj"], atol=atol)
            for k, v in ir["metrics"].items():
                assert_obj_close(ig["metrics"][k], v, msg=k)


def test_fused_backend_certified_against_jax_reference():
    """The port's fused fractional solution moves no rounding threshold
    across its uniform (per-comparison margin > shift, headroom > 10)."""
    insts, stacked = padded_stack(HETERO)
    u_cat, u_phi = _uniforms(stacked)
    ref = _jax_pipeline(stacked, u_cat, u_phi, "reference")
    tst = TSC.stack_instances([_tinst(i) for i in insts], device="cpu")
    got = TCC.offline_pipeline_device(tst, u_cat, u_phi, pdhg_iters=ITERS,
                                      n_seeds=S, lp_backend="fused")
    for i, inst in enumerate(insts):
        N, U = inst.N, inst.U
        cert = threshold_shift_certificate(
            ref["x_frac"][i, :N], ref["A_frac"][i, :N, :U],
            got["x_frac"][i, :N], got["A_frac"][i, :N, :U],
            inst.onehot_mu(), u_cat[i, :, :N], u_phi[i, :, :N, :U])
        assert cert["certified"] and cert["headroom"] > 10.0, (i, cert)
        np.testing.assert_array_equal(got["x"][i], ref["x"][i])
        np.testing.assert_array_equal(got["A"][i], ref["A"][i])


def _certificate(ref, got, inst, u_cat, u_phi):
    N, U = inst.N, inst.U
    return threshold_shift_certificate(
        ref["x_frac"][0, :N], ref["A_frac"][0, :N, :U],
        got["x_frac"][0, :N], got["A_frac"][0, :N, :U],
        inst.onehot_mu(), u_cat[0, :, :N], u_phi[0, :, :N, :U])


def test_certificate_outgrown_by_jax_fused_pipeline_too():
    """Where the certificate stops holding, it stops for the JAX package's
    own mixed-precision pipeline as well: one window at the paper's widths
    (5 stations, 8 models) with 100 users, 1000 iterations, 2 seeds × 8
    trials — the smallest size found where the JAX fused pipeline's
    certificate against its float64 reference fails.  There the port's
    fused solution stays within the schedule's 2e-5 of the JAX fused one,
    and all three pipelines make identical decisions: the certificate is a
    sufficient condition, and the float32 sweep's gap outgrows the margins
    of this many uniforms whichever engine runs it."""
    iters, best_of = 1000, 8
    inst = make_instance(seed=0, n_users=100, n_bs=5, n_models=8)
    stacked = stack_instances([inst])
    u_cat, u_phi = _uniforms(stacked, best_of=best_of)
    ref, jfused = (_jax_pipeline(stacked, u_cat, u_phi, b, iters)
                   for b in ("reference", "pallas"))
    tst = TSC.stack_instances([_tinst(inst)], device="cpu")
    got = TCC.offline_pipeline_device(tst, u_cat, u_phi, iters, S, "fused")
    assert not _certificate(ref, jfused, inst, u_cat, u_phi)["certified"]
    assert not _certificate(ref, got, inst, u_cat, u_phi)["certified"]
    for k in ("x_frac", "A_frac"):
        assert np.abs(got[k] - jfused[k]).max() <= 2e-5, k
    for k in ("x", "A", "best_t"):
        np.testing.assert_array_equal(got[k], ref[k])
        np.testing.assert_array_equal(jfused[k], ref[k])


def test_run_sweep_rows_and_table():
    """The port's sweep emits the reference's row layout and table format
    (one row per variant × seed, in grid order)."""
    axes = {"zipf": (0.4, 0.8)}
    rows = TSW.run_sweep(base=TSC.MECConfig(n_users=20), axes=axes,
                         pdhg_iters=ITERS, best_of=2, n_seeds=2,
                         device="cpu")
    assert len(rows) == 4
    assert [(r["zipf"], r["rounding_seed"]) for r in rows] == \
        [(0.4, 0), (0.4, 1), (0.8, 0), (0.8, 1)]
    for r in rows:
        assert 0.0 <= r["hit_rate"] <= 1.0 and r["users"] == 20.0
    assert TSW.format_table(rows) == SW.format_table(rows)
    assert TSW.format_table([]) == SW.format_table([])


def test_offline_uniforms_seeded_and_shaped():
    insts, _ = padded_stack(HETERO)
    tst = TSC.stack_instances([_tinst(i) for i in insts], device="cpu")
    a = TCC.offline_uniforms(tst, 3, S, BO)
    b = TCC.offline_uniforms(tst, 3, S, BO)
    assert a[0].shape == (3, S * BO, 4, 4)
    assert a[1].shape == (3, S * BO, 4, 50, 3)
    for u, v in zip(a, b):
        assert np.array_equal(u.numpy(), v.numpy())
        assert 0.0 <= float(u.min()) and float(u.max()) < 1.0
