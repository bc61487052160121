"""Fused mixed-precision PDHG solve of the P1-LR window LP.

The counterpart of the JAX package's ``kernels/pdhg_fused.py``: the same
Chambolle–Pock iteration as ``repro_torch.core.lp._pdhg_kernel``,
restructured into the fused (N, H, U) layout with ``tau_A`` folded into
the operator tensors (``_constants``), run as a mixed-precision schedule:
``iters - polish`` float32 iterations, then ``polish`` float64 iterations
on the carried state (``pdhg_fused``).  The float64 tail pins saturated
coordinates back to the exact 0/1 of the reference; the remaining
fractional gap grows with size and iteration count (about 1e-4 at 600
users and 4000 iterations).  Decisions downstream matched the
reference's on every grid checked, but the threshold-shift certificate
proves it only where that gap stays below the rounding margins (see
PERF.md).

Each precision phase has two realizations of one step (``_fused_step``):

  * ``plain_phase`` — a Python loop of PyTorch ops, the counterpart of the
    JAX ``_scan_phase``; it runs for tensors on the CPU;
  * ``cuda_phase`` — the hand-written CUDA kernel ``csrc/pdhg_fused.cu``
    (the counterpart of the JAX ``_pallas_phase``), one thread block per
    window with the whole iteration loop inside; it runs for CUDA tensors.

Padding is inert: ``tau_A`` carries the ``bs_mask`` row mask and a
per-user column mask, so padded base-station rows and padded user columns
of ``A`` stay exactly 0.0 through both phases.
"""
from __future__ import annotations

import ctypes

import torch

#: float64 polish-tail length (iterations) of the mixed-precision schedule.
POLISH_TAIL = 64

#: Largest catalog the CUDA kernel takes (its per-model partial sums live
#: in registers); mirrors ``kMaxModels`` in ``csrc/pdhg_fused.cu``.
MAX_MODELS = 16


def _constants(data, dtype):
    """Step-size / operator tensors in the fused layout, batched over
    windows and cast to ``dtype`` before any arithmetic (as the JAX
    package does), so the float32 phase computes its step sizes in float32.

    Shapes: T, L, tau_A, tau_prec, tAT, tAL (B, N, H, U); tau_x
    (B, N, M, H+1); sig_eq (B, N, M); sig_mem (B, N); sig_route, sig_lat,
    sig_load (B, U)."""
    sizes = data.sizes.to(dtype)                           # (B, M, H+1)
    onehot_mu = data.onehot_mu.to(dtype)                   # (B, U, M)
    R = data.R.to(dtype)
    ddl = data.ddl.to(dtype)
    s_u = data.s_u.to(dtype)
    bs_mask = data.bs_mask.to(dtype)
    T = data.T.to(dtype).transpose(2, 3).contiguous()      # (B, N, H, U)
    L = data.L.to(dtype).transpose(2, 3).contiguous()
    prec_hu = data.prec_u.to(dtype).transpose(1, 2)        # (B, H, U)
    B, N, H, U = T.shape
    M = sizes.shape[1]
    like = dict(dtype=dtype, device=T.device)

    u_mask = onehot_mu.sum(-1)                             # 0.0 on padded users

    # Pock–Chambolle diagonal step sizes (alpha = 1), exactly the
    # reference's row/column sums
    sig_eq = torch.full((B, N, M), 1.0, **like) / torch.full(
        (B, N, M), float(H + 1), **like).clamp_min(1e-9)
    sig_mem = 1.0 / (torch.ones((B, N), **like)
                     * sizes.sum((1, 2))[:, None]).clamp_min(1e-9)
    sig_route = 1.0 / (torch.ones((B, U), **like)
                       * bs_mask.sum(-1)[:, None] * H).clamp_min(1e-9)
    sig_lat = 1.0 / T.sum((1, 2)).clamp_min(1e-9)
    sig_load = 1.0 / L.sum((1, 2)).clamp_min(1e-9)

    cx = torch.ones((B, N, M, H + 1), **like) + sizes[:, None]
    cx = torch.cat([cx[..., :1],
                    cx[..., 1:] + onehot_mu.sum(1)[:, None, :, None]], -1)
    tau_x = 1.0 / cx.clamp_min(1e-9)
    # row mask (padded BSs) AND column mask (padded users): masked entries
    # get a zero step, so A stays exactly 0.0 there for the whole solve
    tau_A = (bs_mask[:, :, None, None] * u_mask[:, None, None, :]) \
        / (2.0 + T + L).clamp_min(1e-9)
    tau_prec = tau_A * prec_hu[:, None]                    # objective gradient
    tAT = tau_A * T                                        # folded prox tensors
    tAL = tau_A * L
    return dict(sizes=sizes, onehot_mu=onehot_mu, R=R, ddl=ddl, s_u=s_u,
                T=T, L=L, sig_eq=sig_eq, sig_mem=sig_mem,
                sig_route=sig_route, sig_lat=sig_lat, sig_load=sig_load,
                sig_ax=0.5, tau_x=tau_x, tau_A=tau_A, tau_prec=tau_prec,
                tAT=tAT, tAL=tAL, dims=(B, N, M, H, U))


def _apply_K(c, x, A):
    """The forward operator K in the fused layout: per-family residuals
    of (x (B,N,M,H+1), A (B,N,H,U))."""
    y_eq = x.sum(-1) - 1.0                                       # (B, N, M)
    y_mem = (x * c["sizes"][:, None]).sum((-2, -1)) - c["R"]     # (B, N)
    y_route = A.sum((1, 2)) - 1.0                                # (B, U)
    y_lat = (A * c["T"]).sum((1, 2)) - c["ddl"]
    y_load = (A * c["L"]).sum((1, 2)) - c["s_u"]
    # one-hot contraction over M: exactly one term per output, so equal
    # to the gather x[:, :, m_u, 1:]
    xa = torch.einsum("bnhm,bum->bnhu", x[..., 1:].transpose(-1, -2),
                      c["onehot_mu"])                            # (B, N, H, U)
    return y_eq, y_mem, y_route, y_lat, y_load, A - xa


def _init_state(data, dtype):
    """The reference's cold start: x = 1/(H+1), A = 0, every dual 0."""
    c = _constants(data, dtype)
    B, N, M, H, U = c["dims"]
    x = torch.full((B, N, M, H + 1), 1.0 / (H + 1), dtype=dtype,
                   device=data.T.device)
    A = torch.zeros((B, N, H, U), dtype=dtype, device=data.T.device)
    y = tuple(torch.zeros_like(v) for v in _apply_K(c, x, A))
    return c, (x, A) + y


def _fused_step(c, state):
    """One PDHG iteration (prox-primal → over-relax → dual ascent) on the
    fused state ``(x, A, y_eq, y_mem, y_route, y_lat, y_load, y_ax)`` —
    the arithmetic the CUDA kernel performs per iteration."""
    x, A, y_eq, y_mem, y_route, y_lat, y_load, y_ax = state

    # K^T y for x: one broadcast sum + the one-hot contraction over users
    gx = y_eq[..., None] + y_mem[:, :, None, None] * c["sizes"][:, None]
    gx_sub = torch.einsum("bnhu,bum->bnhm", y_ax, c["onehot_mu"])
    gx = torch.cat([gx[..., :1], gx[..., 1:] + (-gx_sub.transpose(-1, -2))],
                   -1)
    x_new = (x - c["tau_x"] * gx).clamp(0.0, 1.0)
    # routing prox with tau_A folded into the operator tensors; tau_prec
    # carries the (negated) objective gradient
    A_new = (A - c["tau_A"] * (y_route[:, None, None, :] + y_ax)
             - c["tAT"] * y_lat[:, None, None, :]
             - c["tAL"] * y_load[:, None, None, :]
             + c["tau_prec"]).clamp(0.0, 1.0)
    xb = 2 * x_new - x                                           # over-relax
    Ab = 2 * A_new - A
    k_eq, k_mem, k_route, k_lat, k_load, k_ax = _apply_K(c, xb, Ab)
    return (x_new, A_new,
            y_eq + c["sig_eq"] * k_eq,
            (y_mem + c["sig_mem"] * k_mem).clamp_min(0.0),
            (y_route + c["sig_route"] * k_route).clamp_min(0.0),
            (y_lat + c["sig_lat"] * k_lat).clamp_min(0.0),
            (y_load + c["sig_load"] * k_load).clamp_min(0.0),
            (y_ax + c["sig_ax"] * k_ax).clamp_min(0.0))


def _cast_state(state, dtype):
    return tuple(v.to(dtype) for v in state)


def _finalize(state):
    """Fused state → the reference's float64 (x (B,N,M,H+1), A (B,N,U,H))."""
    x, A = state[0], state[1]
    return x.to(torch.float64), A.to(torch.float64).transpose(2, 3)


# ---------------------------------------------------------------------------
# the two realizations of a precision phase
# ---------------------------------------------------------------------------

def plain_phase(data, state, iters, dtype):
    """``iters`` fused steps in ``dtype`` as a loop of PyTorch ops — the
    plain version of the CUDA kernel, on whatever device ``data`` is."""
    c = _constants(data, dtype)
    state = _cast_state(state, dtype)
    for _ in range(int(iters)):
        state = _fused_step(c, state)
    return state


#: state order of the kernel's arguments (matches ``Params`` in the .cu)
_STATE = ("x", "A", "y_eq", "y_mem", "y_route", "y_lat", "y_load", "y_ax")
#: constant order of the kernel's arguments after ``m_idx``
_CONSTS = ("sizes", "R", "ddl", "s_u", "T", "L", "sig_eq", "sig_mem",
           "sig_route", "sig_lat", "sig_load", "tau_x", "tau_A", "tau_prec",
           "tAT", "tAL")


def _kernel_operands(data, state, dtype):
    """The kernel's operands, validated: fresh contiguous state tensors
    (advanced in place, so they become the phase's outputs), the per-user
    model index (-1 on padded users) and the constants."""
    c = _constants(data, dtype)
    B, N, M, H, U = c["dims"]
    if M > MAX_MODELS:
        raise ValueError(f"the CUDA PDHG kernel takes at most {MAX_MODELS} "
                         f"model types, got M={M}")
    shapes = dict(x=(B, N, M, H + 1), A=(B, N, H, U), y_eq=(B, N, M),
                  y_mem=(B, N), y_route=(B, U), y_lat=(B, U), y_load=(B, U),
                  y_ax=(B, N, H, U), sizes=(B, M, H + 1), R=(B, N),
                  ddl=(B, U), s_u=(B, U), T=(B, N, H, U), L=(B, N, H, U),
                  sig_eq=(B, N, M), sig_mem=(B, N), sig_route=(B, U),
                  sig_lat=(B, U), sig_load=(B, U), tau_x=(B, N, M, H + 1),
                  tau_A=(B, N, H, U), tau_prec=(B, N, H, U),
                  tAT=(B, N, H, U), tAL=(B, N, H, U))
    st = {k: v.to(dtype=dtype, copy=True).contiguous()
          for k, v in zip(_STATE, state)}
    consts = {k: c[k].contiguous() for k in _CONSTS}
    onehot = c["onehot_mu"]
    m_idx = torch.where(onehot.sum(-1) > 0, onehot.argmax(-1),
                        -1).to(torch.int32).contiguous()         # (B, U)
    device = data.T.device
    for k, v in {**st, **consts}.items():
        if tuple(v.shape) != shapes[k] or v.dtype != dtype \
                or v.device != device or not v.is_contiguous():
            raise ValueError(f"pdhg kernel operand {k}: got "
                             f"{tuple(v.shape)} {v.dtype} on {v.device}, "
                             f"want {shapes[k]} {dtype} on {device}")
    return st, m_idx, consts, (B, N, M, H, U)


def _kernel_fn(dtype):
    """The kernel's C entry point for ``dtype``, built at first use."""
    from repro_torch.kernels import _build

    lib = _build.load("pdhg_fused")
    fn = lib.pdhg_fused_f32 if dtype == torch.float32 else lib.pdhg_fused_f64
    fn.argtypes = [ctypes.c_void_p] * (len(_STATE) + 1 + len(_CONSTS)) \
        + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def cuda_phase(data, state, iters, dtype):
    """``iters`` fused steps in ``dtype`` by the CUDA kernel
    (``csrc/pdhg_fused.cu``), one launch.  Takes CUDA tensors only;
    counts its launches in ``cuda_phase.launches``."""
    if data.T.device.type != "cuda":
        raise ValueError("cuda_phase takes CUDA tensors; tensors on the CPU "
                         "run plain_phase")
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"cuda_phase runs float32 or float64, not {dtype}")
    iters = int(iters)
    st, m_idx, consts, (B, N, M, H, U) = _kernel_operands(data, state, dtype)
    if iters <= 0:
        return tuple(st[k] for k in _STATE)
    fn = _kernel_fn(dtype)
    ptrs = [st[k].data_ptr() for k in _STATE] + [m_idx.data_ptr()] \
        + [consts[k].data_ptr() for k in _CONSTS]
    with torch.cuda.device(data.T.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*ptrs, B, N, M, H, U, iters, stream)
    if err != 0:
        raise RuntimeError(f"pdhg_fused kernel launch failed: CUDA error {err}")
    cuda_phase.launches += 1
    return tuple(st[k] for k in _STATE)


cuda_phase.launches = 0


def _phase(data, state, iters, dtype):
    """The CPU runs the plain phase; a CUDA device runs the kernel."""
    if data.T.device.type == "cuda":
        return cuda_phase(data, state, iters, dtype)
    if data.T.device.type == "cpu":
        return plain_phase(data, state, iters, dtype)
    raise ValueError(f"no PDHG phase for device {data.T.device}")


# ---------------------------------------------------------------------------
# public entry point
# ---------------------------------------------------------------------------

#: engines of ``pdhg_fused``: how a precision phase is realized
ENGINES = {"auto": _phase, "plain": plain_phase}


def pdhg_fused(data, iters: int, polish: int = POLISH_TAIL,
               engine: str = "auto"):
    """The fused mixed-precision PDHG solve of a batch of (padded)
    windows: ``iters - polish`` float32 iterations, then ``polish``
    float64 iterations of the same step.  Returns float64
    ``(x (B,N,M,H+1), A (B,N,U,H))`` in the reference layout.

    ``engine``: ``"auto"`` runs the CUDA kernel for CUDA tensors and the
    plain phase on the CPU; ``"plain"`` forces the plain PyTorch phase
    (the kernel's yardstick on the card)."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; one of {tuple(ENGINES)}")
    phase = ENGINES[engine]
    iters = int(iters)
    polish = max(0, min(int(polish), iters))
    sweep = iters - polish
    if sweep:
        _, state = _init_state(data, torch.float32)
        state = phase(data, state, sweep, torch.float32)
    else:
        _, state = _init_state(data, torch.float64)
    state = phase(data, state, polish, torch.float64)
    return _finalize(state)


def fused_vs_reference_gap(data, iters: int, polish: int = POLISH_TAIL):
    """Max abs fractional gap between the fused solve and the float64
    reference on the same batch."""
    from repro_torch.core.lp import _pdhg_kernel

    x_r, A_r = _pdhg_kernel(data, iters)
    x_f, A_f = pdhg_fused(data, iters, polish=polish)
    return float(torch.maximum((x_f - x_r).abs().max(),
                               (A_f - A_r).abs().max()))
