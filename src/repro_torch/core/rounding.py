"""CoCaR randomized rounding (paper Alg. 1) + feasibility repair (Sec. V-D)
on tensors, batched over windows and trials.

Rounding is a deterministic function of pre-drawn uniforms:

  * caching: inverse-CDF multinoulli per (BS, model type) with
    probabilities x†[n,m,:] against ``u_cat``,
  * routing: Bernoulli φ̃ with success probability A†/x† against
    ``u_phi``; Ã = x̃ · φ̃.

Repair turns a rounded draw into a feasible integral solution: route
dedupe, memory eviction (a bounded masked loop), latency/load kick-out,
and route re-repair.  Decision-critical sums go through ``tree_sum`` and
comparisons select (never multiply) precision values, so given the same
fractional solution and uniforms the port makes the JAX package's
decisions bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.core.jdcr import tree_sum
from repro_torch.device import resolve_device

_EPS = 1e-9


def draw_rounding_uniforms(generator: torch.Generator, n_trials, N, M, U, H,
                           batch=None, device="cuda"):
    """All the randomness of ``n_trials`` Alg. 1 draws as float64 uniforms
    from ``generator`` (which must live on ``device``): ``u_cat (T, N, M)``
    and ``u_phi (T, N, U, H)``, with a leading ``batch`` axis when given.
    This is the port's own stream; it does not reproduce ``jax.random``."""
    dev = resolve_device(device)
    lead = (n_trials,) if batch is None else (batch, n_trials)
    u_cat = torch.rand(lead + (N, M), generator=generator,
                       dtype=torch.float64, device=dev)
    u_phi = torch.rand(lead + (N, U, H), generator=generator,
                       dtype=torch.float64, device=dev)
    return u_cat, u_phi


def round_from_uniforms(x_frac, A_frac, onehot_mu, u_cat, u_phi):
    """Alg. 1 for a batch of windows: ``x_frac (B,N,M,H+1)``,
    ``A_frac (B,N,U,H)``, ``onehot_mu (B,U,M)``, ``u_cat (B,T,N,M)``,
    ``u_phi (B,T,N,U,H)``.  Returns 0/1-valued float64
    ``x̃ (B,T,N,M,H+1)`` and ``Ã (B,T,N,U,H)``."""
    Hp1 = x_frac.shape[-1]
    probs = x_frac.clamp(0.0, 1.0)
    den = tree_sum(probs, -1).clamp_min(1e-12)
    probs = (probs / den[..., None])[:, None]                   # (B,1,N,M,H+1)
    # inverse CDF: smallest k with u < Σ_{j<=k} p_j; partial sums are
    # accumulated left to right, as in the JAX package
    cum = probs[..., 0]
    cat = torch.zeros(u_cat.shape, dtype=torch.int32, device=u_cat.device)
    for k in range(Hp1 - 1):
        cat = cat + (u_cat >= cum).to(torch.int32)
        if k < Hp1 - 2:
            cum = cum + probs[..., k + 1]
    x_int = (cat[..., None] == torch.arange(Hp1, device=cat.device)).double()
    # Bernoulli routing: P[φ=1] = A†/x† at the user's model row
    xa = torch.einsum("bnmh,bum->bnuh", x_frac[..., 1:], onehot_mu)
    phi_p = torch.where(xa > 1e-12, A_frac / xa.clamp_min(1e-12), 0.0)
    phi_p = phi_p.clamp(0.0, 1.0)[:, None]
    x_sel = torch.einsum("btnmh,bum->btnuh", x_int[..., 1:], onehot_mu)
    A_int = torch.where((x_sel > 0) & (u_phi < phi_p), 1.0, 0.0).double()
    return x_int, A_int


def _dedupe_device(prec_u, A):
    """At most one route per user — highest precision; exact ties go to the
    smallest (n, h) in row-major order.  ``prec_u (..., U, H)`` broadcasts
    against ``A (..., N, U, H)``."""
    N, U, H = A.shape[-3:]
    lead = A.shape[:-3]
    score = torch.where(A > 0, prec_u.unsqueeze(-3).expand(A.shape),
                        -torch.inf)
    flat = score.movedim(-2, -3).reshape(lead + (U, N * H))
    k = flat.argmax(-1)
    served = (flat > -torch.inf).any(-1)
    keep = (torch.arange(N * H, device=A.device) == k[..., None]) \
        & served[..., None]
    return keep.reshape(lead + (U, N, H)).movedim(-3, -2).double()


def _take(v, idx):
    """``v[..., idx[...]]`` along the last axis, broadcasting ``v``'s
    leading axes against ``idx``'s."""
    v = v.expand(idx.shape[:-1] + v.shape[-1:])
    return v.gather(-1, idx)


def _mem_repair_bs(sizes, prec, onehot_mu, R, x, A):
    """The per-BS eviction loop, batched over (window, trial, BS): ``x
    (B,T,N,M,H+1)``, ``A (B,T,N,U,H)``; ``sizes``/``prec (B,M,H+1)``,
    ``onehot_mu (B,U,M)``, ``R (B,N)``.

    Each pass evicts at every station still over capacity (shrinks the
    least-beneficial cached submodel, redirecting its users); finished
    rows are masked to exact no-ops.  Each eviction strictly lowers some
    cached level, so M·H passes reach the fixpoint — the bound of the JAX
    package's ``lax.while_loop``."""
    B, T, N, M, Hp1 = x.shape
    H = Hp1 - 1
    dev = x.device
    hh = torch.arange(Hp1, device=dev)
    col = torch.arange(H, device=dev)
    sz = sizes[:, None, None]                                     # (B,1,1,M,H+1)
    pr = prec[:, None, None]
    R_n = R[:, None]                                              # (B,1,N)
    oh = onehot_mu[:, None, None]                                 # (B,1,1,U,M)
    for _ in range(M * H):
        used = tree_sum(tree_sum(torch.where(x > 0, sz, 0.0), -1), -1)
        cached = x.argmax(-1)                                     # (B,T,N,M)
        act = (used > R_n + _EPS) & (cached > 0).any(-1)          # (B,T,N)
        if not bool(act.any()):
            break
        # exact routed-user count per (m, h) times the catalog precision
        cnt = torch.einsum("bum,btnuh->btnmh", onehot_mu, (A > 0).double())
        hm1 = (cached - 1).clamp_min(0)
        benefit = _take(pr, cached[..., None])[..., 0] \
            * cnt.gather(-1, hm1[..., None])[..., 0]              # (B,T,N,M)
        m_e = torch.where(cached > 0, benefit, torch.inf).argmin(-1)
        h = cached.gather(-1, m_e[..., None])[..., 0]             # (B,T,N)
        sz_row = sz.expand(B, T, N, M, Hp1).gather(
            -2, m_e[..., None, None].expand(B, T, N, 1, Hp1))[..., 0, :]
        slack = R_n - (used - sz_row.gather(-1, h[..., None])[..., 0])
        fits = (hh >= 1) & (hh < h[..., None]) \
            & (sz_row <= slack[..., None] + _EPS)
        new_h = torch.where(fits, hh, 0).amax(-1)                 # (B,T,N)
        new_row = (hh == new_h[..., None]).to(x.dtype)
        sel = act[..., None] & (torch.arange(M, device=dev) == m_e[..., None])
        x = torch.where(sel[..., None], new_row[..., None, :], x)
        hs = h.clamp_min(1)
        mu_e = _take(oh, m_e[..., None, None].expand(B, T, N, oh.shape[-2], 1))
        A_h = A.gather(-1, (hs - 1)[..., None, None].expand(B, T, N, A.shape[-2], 1))
        moved = act[..., None] & (mu_e[..., 0] > 0) & (A_h[..., 0] > 0)
        A = torch.where(moved[..., None] & (col == (hs - 1)[..., None, None]),
                        0.0, A)
        A = torch.where((moved & (new_h > 0)[..., None])[..., None]
                        & (col == (new_h.clamp_min(1) - 1)[..., None, None]),
                        1.0, A)
    return x, A


def repair_device(data, x, A):
    """Sec. V-D repair for a batch of padded windows × trials: ``data`` is
    a batched PDHGData, ``x (B,T,N,M,H+1)`` and ``A (B,T,N,U,H)`` the
    rounded draws.  Padded base stations (``bs_mask`` 0) and padded users
    (zero ``onehot_mu`` row) are excluded from the re-route step; every
    other stage is inert for them."""
    sizes, prec, prec_u, T, L, onehot_mu, R, ddl, s_u, bs_mask = (
        data.sizes, data.prec, data.prec_u, data.T, data.L,
        data.onehot_mu, data.R, data.ddl, data.s_u, data.bs_mask)
    B, Tr, N, U, H = A.shape

    A = _dedupe_device(prec_u[:, None], A)
    x, A = _mem_repair_bs(sizes, prec, onehot_mu, R, x, A)

    # routes must point at cached submodels
    x_sel = torch.einsum("btnmh,bum->btnuh", x[..., 1:], onehot_mu)
    A = torch.where(x_sel > 0, A, 0.0)

    # latency & load kick-out
    Tb, Lb = T[:, None], L[:, None]                               # (B,1,N,U,H)
    lat_u = tree_sum(tree_sum(torch.where(A > 0, Tb, 0.0), -1), -2)
    load_u = tree_sum(tree_sum(torch.where(A > 0, Lb, 0.0), -1), -2)
    bad = (lat_u > ddl[:, None] + _EPS) | (load_u > s_u[:, None] + _EPS)
    A = torch.where(bad[..., None, :, None], 0.0, A)

    # route re-repair: unserved users go to the best feasible cached replica
    user_mask = tree_sum(onehot_mu, -1) > 0                       # (B,U)
    m_u = onehot_mu.argmax(-1)                                    # (B,U)
    cached_h = x.argmax(-1)                                       # (B,T,N,M)
    h_sel = cached_h.gather(-1, m_u[:, None, None].expand(B, Tr, N, U))
    hm1 = (h_sel - 1).clamp_min(0)                                # (B,T,N,U)
    T_g = _take(Tb, hm1[..., None])[..., 0]
    L_g = _take(Lb, hm1[..., None])[..., 0]
    prec_g = _take(prec_u[:, None, None], hm1[..., None])[..., 0]
    feas = (h_sel > 0) & (T_g <= ddl[:, None, None] + _EPS) \
        & (L_g <= s_u[:, None, None] + _EPS) & (bs_mask[:, None, :, None] > 0)
    score = torch.where(feas, prec_g, -torch.inf)
    n_best = score.argmax(-2)                                     # (B,T,U)
    unserved = ~(A > 0).any(-1).any(-2)                           # (B,T,U)
    assign = unserved & feas.any(-2) & user_mask[:, None]
    h_best = h_sel.gather(-2, n_best[..., None, :])[..., 0, :]   # (B,T,U)
    hit_n = torch.arange(N, device=A.device)[:, None] == n_best[..., None, :]
    hit_h = torch.arange(H, device=A.device) == (h_best - 1)[..., None]
    A = torch.where(assign[..., None, :, None] & hit_n[..., None]
                    & hit_h[..., None, :, :], 1.0, A)
    return x, A
