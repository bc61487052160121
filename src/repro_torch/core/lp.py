"""PDHG solver for problem P1-LR (paper Sec. V-A) on tensors.

Matrix-free Chambolle–Pock with diagonal (Pock–Chambolle) step sizes: the
operator K is never materialized, every constraint family is applied
functionally.  All solver functions take a *batched* :class:`PDHGData` —
every field carries a leading window axis B (``stack_instances`` builds
one) — and run on the device the tensors live on.

Two interchangeable backends (``LP_BACKENDS``):

  * ``"reference"`` — ``_pdhg_kernel``, the plain float64 iteration;
  * ``"fused"`` — ``repro_torch.kernels.pdhg_fused``: the same algorithm in
    the fused (N, H, U) layout as a mixed-precision schedule (float32
    sweep, float64 polish), a hand-written CUDA kernel on the card and
    its plain PyTorch version on the CPU.

Both return float64 x (B,N,M,H+1) and A (B,N,U,H).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.jdcr import JDCRInstance, check_feasible
from repro_torch.device import resolve_device

#: Scaled primal-residual tolerance behind ``PDHGResult.converged``.
PDHG_TOL = 1e-2

#: LP solver backends: the plain f64 reference and the fused kernel path.
LP_BACKENDS = ("reference", "fused")


class PDHGData(NamedTuple):
    """Everything the PDHG iteration needs about a batch of windows, as
    float64 tensors with a leading window axis B.  Per-window shapes:

      sizes      (M, H+1)   submodel memory footprints r_h
      prec       (M, H+1)   catalog precision p_h (slot 0 = 0); read by
                            the repair stage's eviction benefits
      prec_u     (U, H)     objective coefficients p_h per user
      T          (N, U, H)  end-to-end latency T̂ (paper Eq. 15)
      L          (N, U, H)  model-load latency (paper Eq. 16)
      onehot_mu  (U, M)     one-hot of each user's requested model type
      R          (N,)       memory capacity
      ddl        (U,)       latency budgets
      s_u        (U,)       initiation times (load-latency budgets)
      bs_mask    (N,)       1 for real base stations, 0 for padding
      home_onehot (U, N)    one-hot of each user's home BS (zero row for
                            padded users)
    """
    sizes: torch.Tensor
    prec: torch.Tensor
    prec_u: torch.Tensor
    T: torch.Tensor
    L: torch.Tensor
    onehot_mu: torch.Tensor
    R: torch.Tensor
    ddl: torch.Tensor
    s_u: torch.Tensor
    bs_mask: torch.Tensor
    home_onehot: torch.Tensor


def pdhg_fields(inst: JDCRInstance) -> dict:
    """The solver-facing arrays of one window, as float64 NumPy."""
    home_onehot = np.zeros((inst.U, inst.N))
    home_onehot[np.arange(inst.U), inst.home] = 1.0
    return dict(
        sizes=np.asarray(inst.sizes, dtype=np.float64),
        prec=np.asarray(inst.prec, dtype=np.float64),
        prec_u=np.asarray(inst.prec[inst.m_u, 1:], dtype=np.float64),
        T=np.asarray(inst.e2e_latency(), dtype=np.float64),
        L=np.asarray(inst.load_latency(), dtype=np.float64),
        onehot_mu=inst.onehot_mu(),
        R=np.asarray(inst.R, dtype=np.float64),
        ddl=np.asarray(inst.ddl, dtype=np.float64),
        s_u=np.asarray(inst.s_u, dtype=np.float64),
        bs_mask=np.ones(inst.N),
        home_onehot=home_onehot)


def pdhg_data_from_numpy(fields, device="cuda") -> PDHGData:
    """Carry PDHGData fields given as NumPy arrays into the port: any
    object with the field names as attributes (the JAX package's
    ``PDHGData``) or a dict.  Returns float64 tensors on ``device``, with
    the caller's axes unchanged."""
    dev = resolve_device(device)

    def get(k):
        return fields[k] if isinstance(fields, dict) else getattr(fields, k)

    return PDHGData(**{
        k: torch.tensor(np.asarray(get(k), dtype=np.float64), device=dev)
        for k in PDHGData._fields})


def pdhg_data(inst: JDCRInstance, device="cuda") -> PDHGData:
    """One window as a batch of one."""
    return pdhg_data_from_numpy(
        {k: v[None] for k, v in pdhg_fields(inst).items()}, device)


# ---------------------------------------------------------------------------
# the plain float64 reference iteration
# ---------------------------------------------------------------------------

def _pdhg_kernel(data: PDHGData, iters: int):
    """The batched PDHG solve in float64, step for step the JAX package's
    ``core/lp.py::_pdhg_kernel``.  Duals: the one-hot equality (B,N,M) is
    free, every inequality dual is projected to >= 0."""
    sizes, prec_u, T, L, onehot_mu, R, ddl, s_u, bs_mask = (
        data.sizes, data.prec_u, data.T, data.L, data.onehot_mu,
        data.R, data.ddl, data.s_u, data.bs_mask)
    B, N, U, H = T.shape
    M = sizes.shape[1]
    f64 = dict(dtype=torch.float64, device=T.device)

    def K(x, A):
        y_eq = x.sum(-1) - 1.0                                        # (B,N,M)
        y_mem = torch.einsum("bnmh,bmh->bn", x, sizes) - R            # (B,N)
        y_route = A.sum((1, 3)) - 1.0                                 # (B,U)
        y_lat = torch.einsum("bnuh,bnuh->bu", A, T) - ddl             # (B,U)
        y_load = torch.einsum("bnuh,bnuh->bu", A, L) - s_u            # (B,U)
        xa = torch.einsum("bnmh,bum->bnuh", x[..., 1:], onehot_mu)    # (B,N,U,H)
        return y_eq, y_mem, y_route, y_lat, y_load, A - xa

    def KT(y):
        y_eq, y_mem, y_route, y_lat, y_load, y_ax = y
        gx = torch.zeros((B, N, M, H + 1), **f64)
        gx = gx + y_eq[..., None]
        gx = gx + y_mem[:, :, None, None] * sizes[:, None]
        gx_sub = -torch.einsum("bnuh,bum->bnmh", y_ax, onehot_mu)     # (B,N,M,H)
        gx = torch.cat([gx[..., :1], gx[..., 1:] + gx_sub], -1)
        gA = y_route[:, None, :, None] + y_ax \
            + y_lat[:, None, :, None] * T + y_load[:, None, :, None] * L
        return gx, gA

    # row sums (per dual)
    r_eq = torch.full((B, N, M), float(H + 1), **f64)
    r_mem = torch.ones((B, N), **f64) * sizes.sum((1, 2))[:, None]
    r_route = torch.ones((B, U), **f64) * (bs_mask.sum(-1) * H)[:, None]
    r_lat = T.sum((1, 3))
    r_load = L.sum((1, 3))
    r_ax = torch.full((B, N, U, H), 2.0, **f64)
    sig = tuple(1.0 / r.clamp_min(1e-9)
                for r in (r_eq, r_mem, r_route, r_lat, r_load, r_ax))
    # column sums (per primal)
    cx = torch.ones((B, N, M, H + 1), **f64) + sizes[:, None]
    users_of_m = onehot_mu.sum(1)                                     # (B,M)
    cx = torch.cat([cx[..., :1], cx[..., 1:] + users_of_m[:, None, :, None]],
                   -1)
    cA = torch.ones((B, N, U, H), **f64) + T + L + 1.0
    tau_x = 1.0 / cx.clamp_min(1e-9)
    # masked rows get a zero step: A stays exactly 0 at padded stations
    tau_A = bs_mask[:, :, None, None] / cA.clamp_min(1e-9)

    x = torch.full((B, N, M, H + 1), 1.0 / (H + 1), **f64)
    A = torch.zeros((B, N, U, H), **f64)
    y = tuple(torch.zeros_like(v) for v in K(x, A))
    for _ in range(int(iters)):
        gx, gA = KT(y)
        x_new = (x - tau_x * gx).clamp(0.0, 1.0)
        A_new = (A - tau_A * (gA - prec_u[:, None])).clamp(0.0, 1.0)
        xb = 2 * x_new - x
        Ab = 2 * A_new - A
        y_new = tuple(yy + s * kk for yy, s, kk in zip(y, sig, K(xb, Ab)))
        y = (y_new[0],) + tuple(v.clamp_min(0.0) for v in y_new[1:])
        x, A = x_new, A_new
    return x, A


def _lp_solve_kernel(data: PDHGData, iters: int, backend: str = "reference"):
    """Batched (x, A) solve dispatching on ``backend``.  Both return
    float64 x (B,N,M,H+1) / A (B,N,U,H); "fused" lands within float32
    noise of the reference (see ``repro_torch.kernels.pdhg_fused``)."""
    if backend == "reference":
        return _pdhg_kernel(data, iters)
    if backend == "fused":
        from repro_torch.kernels.pdhg_fused import pdhg_fused
        return pdhg_fused(data, iters)
    raise ValueError(f"unknown LP backend {backend!r}; one of {LP_BACKENDS}")


@dataclass
class PDHGResult:
    x: np.ndarray
    A: np.ndarray
    obj: float
    iters: int
    primal_res: float
    converged: bool = False
    tol: float = 0.0


@dataclass
class BatchedPDHGResult:
    """Padded batch solution as NumPy: x (B,N,M,H+1), A (B,N,U,H),
    objs (B,).  Slice heterogeneous stacks back with
    ``StackedWindows.unstack``."""
    x: np.ndarray
    A: np.ndarray
    objs: np.ndarray
    iters: int


def pdhg_primal_residual(inst: JDCRInstance, x, A) -> float:
    """Scaled primal feasibility residual of a fractional NumPy (x, A):
    the max over memory / max(R), route, A <= x and the one-submodel
    equality."""
    res = check_feasible(inst, x, A, atol=np.inf)
    primal = max(res["memory"] / max(inst.R.max(), 1e-9), res["route"],
                 res["A_le_x"], res["one_submodel"])
    return float(max(primal, 0.0))


def solve_lp_pdhg(inst: JDCRInstance, iters: int = 4000,
                  tol: float = PDHG_TOL, backend: str = "reference",
                  device="cuda") -> PDHGResult:
    """One-window PDHG solve on ``device``; the result carries a
    ``converged`` flag (final scaled primal residual vs ``tol``)."""
    x, A = _lp_solve_kernel(pdhg_data(inst, device), iters, backend)
    x = x[0].cpu().numpy()
    A = A[0].cpu().numpy()
    primal = pdhg_primal_residual(inst, x, A)
    return PDHGResult(x=x, A=A, obj=inst.objective(A), iters=iters,
                      primal_res=primal, converged=bool(primal <= tol), tol=float(tol))


def solve_lp_pdhg_batched(data: PDHGData, iters: int = 4000,
                          backend: str = "reference") -> BatchedPDHGResult:
    """Solve a whole stack of windows (the batched ``data`` from
    ``stack_instances``) on the device its tensors live on.  Objectives
    are exact: padded users carry zero ``prec_u`` and padded base
    stations hold A == 0 throughout."""
    x, A = _lp_solve_kernel(data, iters, backend)
    objs = torch.einsum("bnuh,buh->b", A, data.prec_u)
    return BatchedPDHGResult(x=x.cpu().numpy(), A=A.cpu().numpy(),
                             objs=objs.cpu().numpy(), iters=iters)
