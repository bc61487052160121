"""JDCR problem instance (paper Sec. IV): joint dynamic-model caching and
request routing within one observation window.

Array conventions (rectangular: every model type has the same number of
submodels H; the empty submodel h0 is slot 0 of the caching variable only):

  x      (N, M, H+1)   caching one-hot over {h0, h1..hH}   (paper x_{n,h})
  A      (N, U, H)     routing to real submodels h1..hH    (paper A_{n,u,h})
  sizes  (M, H+1)      r_h bytes-like units (slot 0 = 0)
  prec   (M, H+1)      p_h (slot 0 = 0)
  flops  (M, H+1)      c_h per data unit (slot 0 = 0)
  loadD  (M, H+1, H+1) D_m(h', h) switching latency, rows = previous state

Instances are NumPy (built on the host from numpy's RNG, bit-equal to the
JAX package's); the device pipeline works on tensors.  Also home of the
deterministic reductions (``tree_sum``, ``objective_sel``) that make
threshold and argmax decisions reproducible bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


def tree_sum(v, axis=-1):
    """Balanced-tree reduction over one axis, for NumPy arrays and torch
    tensors alike, invariant to trailing zero padding.

    Both branches fold the same explicit sequence of pairwise adds (no
    library reduction, whose association is backend-defined): the axis is
    zero-padded to the next power of two and folded in halves.  Any two
    arrays with equal elements therefore reduce to the same float, and a
    padded batch row reduces to the value of its unpadded original.
    """
    is_np = isinstance(v, np.ndarray)
    v = np.moveaxis(v, axis, -1) if is_np else v.movedim(axis, -1)
    n = v.shape[-1]
    p = 1
    while p < n:
        p *= 2
    if p != n:      # zero-pad to the power of two (an empty axis sums to 0)
        pad = (v.shape[:-1] + (p - n,))
        zeros = np.zeros(pad, v.dtype) if is_np else v.new_zeros(pad)
        v = np.concatenate([v, zeros], -1) if is_np else torch.cat([v, zeros], -1)
    while p > 1:
        p //= 2
        v = v[..., :p] + v[..., p:2 * p]
    return v[..., 0]


def objective_sel(prec_u, A):
    """Total routed precision Σ A·p over the last three axes (N, U, H), as
    a tree of adds over selected (not multiplied) precision values — the
    trial-argmax key of the ``best_of`` selection.  ``A`` must be 0/1;
    ``prec_u (..., U, H)`` broadcasts against ``A (..., N, U, H)``."""
    v = torch.where(A > 0, prec_u.unsqueeze(-3), 0.0)
    return tree_sum(tree_sum(tree_sum(v, -1), -1), -1)


@dataclass
class JDCRInstance:
    # catalog
    sizes: np.ndarray      # (M, H+1)
    prec: np.ndarray       # (M, H+1)
    flops: np.ndarray      # (M, H+1)
    loadD: np.ndarray      # (M, H+1, H+1)
    # infrastructure
    R: np.ndarray          # (N,) memory capacity
    C: np.ndarray          # (N,) compute capacity (flops/s)
    phi: np.ndarray        # (N,) wireless rate (data units/s)
    wired: np.ndarray      # (N, N) wired rate
    lam: np.ndarray        # (N, N) propagation latency home->target (s)
    # requests (one observation window)
    m_u: np.ndarray        # (U,) requested model type
    d_u: np.ndarray        # (U,) data size
    ddl: np.ndarray        # (U,) latency budget
    s_u: np.ndarray        # (U,) initiation time in window
    home: np.ndarray       # (U,) home BS
    # previous window caching state
    x_prev: np.ndarray     # (N, M, H+1) one-hot

    @property
    def N(self):
        return len(self.R)

    @property
    def M(self):
        return self.sizes.shape[0]

    @property
    def H(self):
        return self.sizes.shape[1] - 1

    @property
    def U(self):
        return len(self.m_u)

    def onehot_mu(self) -> np.ndarray:
        """(U, M) one-hot of each user's requested model type."""
        onehot = np.zeros((self.U, self.M))
        onehot[np.arange(self.U), self.m_u] = 1.0
        return onehot

    def comm_latency(self) -> np.ndarray:
        """(U, N): T^off term for routing user u to BS n (excl. inference)."""
        up = self.d_u / self.phi[self.home]                       # (U,)
        wired = self.d_u[:, None] / self.wired[self.home, :]      # (U, N)
        wired[self.wired[self.home, :] <= 0] = 0.0
        lam = self.lam[self.home, :]                              # (U, N)
        return up[:, None] + wired + lam

    def e2e_latency(self) -> np.ndarray:
        """(N, U, H): T̂_{n,u,h} = comm + inference (paper Eq. 15)."""
        comm = self.comm_latency()                                # (U, N)
        infer = (self.flops[self.m_u, 1:][None, :, :]
                 * self.d_u[None, :, None] / self.C[:, None, None])
        return comm.T[:, :, None] + infer                         # (N,U,H)

    def load_latency(self) -> np.ndarray:
        """(N, U, H): model-m_u load time at BS n (paper Eq. 16), set by
        the previous window's caching state."""
        T = np.einsum("nmp,mph->nmh", self.x_prev, self.loadD)
        return T[:, self.m_u, 1:]                                 # (N,U,H)

    def objective(self, A) -> float:
        return float(np.sum(A * self.prec[self.m_u, 1:][None]))


def check_feasible(inst: JDCRInstance, x, A, atol=1e-6):
    """Constraint residuals for integer/fractional NumPy (x, A)."""
    res = {}
    res["one_submodel"] = np.max(np.abs(x.sum(-1) - 1.0))
    res["memory"] = np.max(np.sum(x * inst.sizes[None], axis=(1, 2)) - inst.R)
    res["route"] = np.max(A.sum(axis=(0, 2)) - 1.0)
    xa = x[:, inst.m_u, 1:]                                       # (N,U,H)
    res["A_le_x"] = np.max(A - xa)
    res["latency"] = np.max((A * inst.e2e_latency()).sum(axis=(0, 2)) - inst.ddl)
    res["load"] = np.max((A * inst.load_latency()).sum(axis=(0, 2)) - inst.s_u)
    res["ok"] = all(v <= atol for k, v in res.items() if k != "ok")
    return res


def check_feasible_device(data, x, A):
    """``check_feasible`` on tensors for a batch of padded windows:
    ``data`` is a batched PDHGData (leading axis B), ``x (B, N, M, H+1)``
    and ``A (B, N, U, H)``.  Padded base stations and users are masked out.
    Returns a dict of (B,) residuals (the keys of ``check_feasible``
    without ``ok``)."""
    inf = torch.inf
    bs = data.bs_mask > 0                                         # (B, N)
    um = tree_sum(data.onehot_mu, -1) > 0                         # (B, U)
    mem = tree_sum(tree_sum(torch.where(x > 0, data.sizes[:, None], 0.0),
                            -1), -1)                              # (B, N)
    xa = torch.einsum("bnmh,bum->bnuh", x[..., 1:], data.onehot_mu)
    lat = tree_sum(tree_sum(torch.where(A > 0, data.T, 0.0), -1), -2)
    load = tree_sum(tree_sum(torch.where(A > 0, data.L, 0.0), -1), -2)
    routes = tree_sum(tree_sum(A, -1), -2)                        # (B, U)

    def masked_max(v, mask, fill):
        return torch.where(mask, v, fill).flatten(1).amax(-1)

    return {
        "one_submodel": masked_max((tree_sum(x, -1) - 1.0).abs(),
                                   bs[:, :, None], 0.0),
        "memory": masked_max(mem - data.R, bs, -inf),
        "route": masked_max(routes - 1.0, um, -inf),
        "A_le_x": (A - xa).flatten(1).amax(-1),
        "latency": masked_max(lat - data.ddl, um, -inf),
        "load": masked_max(load - data.s_u, um, -inf),
    }
