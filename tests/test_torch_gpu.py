"""The CUDA PDHG kernel on the card: built from the repository's sources,
held against its plain PyTorch phase on the same CUDA tensors, and driven
through the whole offline pipeline.  Marked ``gpu``; each test skips
without a card (decided in the fixture, at run time).

Tolerances: 1e-12 where every iteration runs in float64, 2e-5 through a
float32 phase (the bounds of the JAX package's tests/test_pdhg_fused.py);
decisions bit-identical.  float32 matmuls run without TF32.
"""
import numpy as np
import pytest
import torch
from harness import hetero_insts

from repro_torch.core import cocar as TCC
from repro_torch.core import jdcr as TJ
from repro_torch.kernels import pdhg_fused as TPF
from repro_torch.mec import scenario as TSC

pytestmark = pytest.mark.gpu

HETERO = [(0, 40, 3), (1, 50, 4), (2, 35, 3)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _tinsts(spec):
    return [TJ.JDCRInstance(**{k: getattr(i, k)
                               for k in i.__dataclass_fields__})
            for i in hetero_insts(spec)]


def _stack(spec, device):
    return TSC.stack_instances(_tinsts(spec), device=device).data


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 2e-5)])
@pytest.mark.parametrize("iters", [1, 8, 37])
def test_kernel_phase_matches_plain_phase(cuda, dtype, tol, iters):
    data = _stack(HETERO, cuda)
    _, state = TPF._init_state(data, dtype)
    g = torch.Generator(device=cuda).manual_seed(0)
    state = tuple(v + 0.1 * torch.rand(v.shape, generator=g, dtype=dtype,
                                       device=cuda) for v in state)
    got = TPF.cuda_phase(data, state, iters, dtype)
    ref = TPF.plain_phase(data, state, iters, dtype)
    torch.cuda.synchronize()
    for name, a, b in zip(TPF._STATE, got, ref):
        assert float((a - b).abs().max()) <= tol, name


@pytest.mark.parametrize("iters,polish", [(37, 5), (6, 2), (16, 16)])
def test_kernel_schedule_matches_plain(cuda, iters, polish):
    """The block/remainder run lengths of the JAX package's
    test_pallas_block_remainder_and_short_runs."""
    data = _stack(HETERO, cuda)
    tol = 1e-12 if polish >= iters else 2e-5
    got = TPF.pdhg_fused(data, iters, polish=polish)
    ref = TPF.pdhg_fused(data, iters, polish=polish, engine="plain")
    for a, b in zip(got, ref):
        assert float((a - b).abs().max()) <= tol


def test_pipeline_through_kernel_matches_reference(cuda):
    """cocar_grid on the card: the fused backend (the kernel, counted)
    makes the float64 reference's decisions."""
    insts = _tinsts(HETERO)
    TPF.cuda_phase.launches = 0
    fused = TCC.cocar_grid(insts, pdhg_iters=300, best_of=3, n_seeds=2,
                           lp_backend="fused", device=cuda)
    assert TPF.cuda_phase.launches == 2          # float32 sweep + polish
    ref = TCC.cocar_grid(insts, pdhg_iters=300, best_of=3, n_seeds=2,
                         lp_backend="reference", device=cuda)
    for per_f, per_r in zip(fused, ref):
        for (xf, Af, i_f), (xr, Ar, i_r) in zip(per_f, per_r):
            np.testing.assert_array_equal(xf, xr)
            np.testing.assert_array_equal(Af, Ar)
            assert i_f["best_t"] == i_r["best_t"]


def test_kernel_rejects_bad_operands(cuda):
    data = _stack([(1, 10, 3)], cuda)
    _, state = TPF._init_state(data, torch.float32)
    bad = (state[0][..., :2],) + state[1:]
    with pytest.raises(ValueError, match="operand x"):
        TPF.cuda_phase(data, bad, 4, torch.float32)
    with pytest.raises(ValueError, match="float32 or float64"):
        TPF.cuda_phase(data, state, 4, torch.float16)
