"""The port's fused mixed-precision PDHG path (plain PyTorch phase, the
CPU realization of the CUDA kernel) against the JAX package's
``kernels/pdhg_fused.py``.

Tolerances are those of the reference's own tests/test_pdhg_fused.py:
1e-12 where every iteration runs in float64 (the same step, another FMA
and summation order), 2e-5 through a float32 sweep (float32 ulp noise).
"""
import jax
import numpy as np
import pytest
import torch
from harness import make_instance, padded_stack

from repro.core import lp as LP
from repro.kernels import pdhg_fused as PF
from repro.mec.scenario import stack_instances
from repro_torch.core import lp as TLP
from repro_torch.kernels import pdhg_fused as TPF

HETERO = [(0, 40, 3), (1, 50, 4), (2, 35, 3)]


def _window(data, b):
    return LP.PDHGData(*(v[b] for v in data))


def _gap(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


@pytest.mark.parametrize("dtype,tol", [("float64", 1e-12),
                                       ("float32", 2e-5)])
def test_plain_phase_matches_scan_phase(dtype, tol):
    """One precision phase from the cold start: every state tensor of
    the batched plain phase against ``PF._scan_phase`` per window."""
    insts, stacked = padded_stack(HETERO)
    data = TLP.pdhg_data_from_numpy(stacked.data, device="cpu")
    tdt = getattr(torch, dtype)
    _, state = TPF._init_state(data, tdt)
    got = TPF.plain_phase(data, state, 40, tdt)
    for b in range(len(insts)):
        d = _window(stacked.data, b)
        with jax.enable_x64():
            _, st = PF._init_state(d, getattr(jax.numpy, dtype))
            ref = PF._scan_phase(d, st, 40, getattr(jax.numpy, dtype))
            ref = [np.asarray(v) for v in ref]
        for name, g, r in zip(TPF._STATE, got, ref):
            assert g.dtype == tdt
            assert _gap(g[b].numpy(), r) <= tol, (name, b)


def test_plain_phase_matches_pallas_interpret():
    """The same phase against the Pallas kernel in interpret mode (block
    8 with a remainder block), float64."""
    inst = make_instance(seed=4, n_users=30)
    d = LP.pdhg_data(inst)
    data = TLP.pdhg_data_from_numpy({k: v[None] for k, v in
                                     d._asdict().items()}, device="cpu")
    _, state = TPF._init_state(data, torch.float64)
    got = TPF.plain_phase(data, state, 12, torch.float64)
    with jax.enable_x64():
        _, st = PF._init_state(d, jax.numpy.float64)
        ref = PF._pallas_phase(d, st, 12, jax.numpy.float64, block=8,
                               interpret=True)
        ref = [np.asarray(v) for v in ref]
    for name, g, r in zip(TPF._STATE, got, ref):
        assert _gap(g[0].numpy(), r) <= 1e-12, name


@pytest.mark.parametrize("iters,polish", [(37, 5), (6, 2), (16, 16),
                                          (300, 64)])
def test_pdhg_fused_schedule_matches_reference(iters, polish):
    """The whole mixed schedule (the block/remainder run lengths of the
    reference's test_pallas_block_remainder_and_short_runs, plus the
    default polish tail), batched over the padded stack."""
    insts, stacked = padded_stack(HETERO)
    data = TLP.pdhg_data_from_numpy(stacked.data, device="cpu")
    x, A = TPF.pdhg_fused(data, iters, polish=polish)
    assert x.dtype == A.dtype == torch.float64
    tol = 1e-12 if polish >= iters else 2e-5
    for b in range(len(insts)):
        with jax.enable_x64():
            x_r, A_r = PF.pdhg_fused(_window(stacked.data, b), iters,
                                     polish=polish, engine="scan")
        assert _gap(x[b].numpy(), x_r) <= tol, (iters, polish, b)
        assert _gap(A[b].numpy(), A_r) <= tol, (iters, polish, b)


def test_fused_f64_close_to_reference_lp():
    """With polish == iters the fused path is the reference algorithm with
    reordered ops (the reference's own 1e-10 bound)."""
    inst = make_instance(seed=2, n_users=60)
    d = LP.pdhg_data(inst)
    data = TLP.pdhg_data_from_numpy({k: v[None] for k, v in
                                     d._asdict().items()}, device="cpu")
    x_f, A_f = TPF.pdhg_fused(data, 400, polish=400)
    x_r, A_r = TLP._pdhg_kernel(data, 400)
    assert _gap(x_f, x_r) < 1e-10 and _gap(A_f, A_r) < 1e-10
    gap = TPF.fused_vs_reference_gap(data, 600)
    with jax.enable_x64():
        ref_gap = PF.fused_vs_reference_gap(d, 600)
    assert 0.0 <= gap < 1e-3
    assert abs(gap - ref_gap) <= 2e-5


@pytest.mark.parametrize("seed,n_users,n_bs,pad_bs,pad_users",
                         [(0, 12, 2, 1, 5), (3, 20, 4, 3, 8)])
def test_fused_padding_is_exactly_inert(seed, n_users, n_bs, pad_bs,
                                        pad_users):
    """Padded base-station rows and padded user columns of A stay exactly
    0.0 through both precision phases."""
    inst = make_instance(seed=seed, n_users=n_users, n_bs=n_bs)
    stacked = stack_instances([inst], pad_to=(n_bs + pad_bs,
                                              n_users + pad_users))
    data = TLP.pdhg_data_from_numpy(stacked.data, device="cpu")
    x, A = TPF.pdhg_fused(data, 48, polish=8)
    assert (A[0, inst.N:] == 0.0).all()
    assert (A[0, :, inst.U:] == 0.0).all()
    assert torch.isfinite(x).all() and (x >= 0).all() and (x <= 1).all()


def test_cuda_phase_refuses_cpu_tensors():
    """The kernel wrapper never runs the plain phase in its place."""
    inst = make_instance(seed=1, n_users=10)
    d = LP.pdhg_data(inst)
    data = TLP.pdhg_data_from_numpy({k: v[None] for k, v in
                                     d._asdict().items()}, device="cpu")
    _, state = TPF._init_state(data, torch.float32)
    before = TPF.cuda_phase.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        TPF.cuda_phase(data, state, 4, torch.float32)
    assert TPF.cuda_phase.launches == before
    for engine in ("cuda", "pallas"):    # the kernel runs only as "auto"
        with pytest.raises(ValueError, match="unknown engine"):
            TPF.pdhg_fused(data, 8, engine=engine)
    # "plain" is the CPU's "auto"
    for a, b in zip(TPF.pdhg_fused(data, 8, polish=4, engine="plain"),
                    TPF.pdhg_fused(data, 8, polish=4)):
        assert torch.equal(a, b)
