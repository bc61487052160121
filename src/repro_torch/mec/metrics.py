"""Evaluation metrics (paper Sec. VII-B) on tensors.

A routed request counts as a hit only if its end-to-end latency fits
ddl_u and its model finished loading before s_u.  ``window_metrics_device``
evaluates *repaired* solutions, where the JAX package's execution-time
enforcement is an identity (repair already dedupes routes, pins them to
cached submodels and kicks out latency/load violators); enforcement itself
belongs to the policy-grid slice.  Decision-critical sums go through
``tree_sum`` and comparisons select precision values, so the numbers
match the JAX package's to float rounding.
"""
from __future__ import annotations

import torch

from repro_torch.core.jdcr import objective_sel, tree_sum

#: Eq. 40 QoE decay rate.
QOE_ALPHA = 0.9


def _qoe_per_user(prec_sel, lat, theta, served):
    """Eq. 40 per served user: p · max(0, 1 − (latency − θ_u) · α), with
    θ_u the user's minimum achievable latency."""
    decay = (1.0 - (lat - theta) * QOE_ALPHA).clamp_min(0.0)
    return torch.where(served, prec_sel * decay, 0.0)


def qoe(prec, latency, theta, alpha=0.9):
    """Paper Eq. 40 for one request."""
    return prec * max(0.0, 1.0 - (latency - theta) * alpha)


def window_metrics_device(data, x, A):
    """Window metrics of repaired solutions for a batch of padded windows:
    ``data`` is a batched PDHGData, ``x (B,S,N,M,H+1)`` and
    ``A (B,S,N,U,H)`` one solution per (window, seed).  Padded base
    stations and users are masked out of every aggregate.  Returns a dict
    of (B, S) float64 tensors."""
    user_mask = tree_sum(data.onehot_mu, -1) > 0                  # (B,U)
    bs_mask = data.bs_mask > 0                                    # (B,N)
    users = tree_sum(user_mask.double(), -1)[:, None]             # (B,1)
    served = (A > 0).any(-1).any(-2) & user_mask[:, None]         # (B,S,U)
    precision = objective_sel(data.prec_u[:, None], A)            # (B,S)
    used = tree_sum(tree_sum(torch.where(x > 0, data.sizes[:, None, None],
                                         0.0), -1), -1)           # (B,S,N)
    util = torch.where(bs_mask[:, None],
                       used / data.R.clamp_min(1e-12)[:, None], 0.0)
    n_bs = tree_sum(bs_mask.double(), -1)[:, None]
    lat_u = tree_sum(tree_sum(torch.where(A > 0, data.T[:, None], 0.0),
                              -1), -2)                            # (B,S,U)
    theta = torch.where(bs_mask[:, :, None, None], data.T,
                        torch.inf).amin((1, 3))                   # (B,U)
    prec_sel = tree_sum(tree_sum(
        torch.where(A > 0, data.prec_u[:, None, None], 0.0), -1), -2)
    qoe_u = _qoe_per_user(prec_sel, lat_u, theta[:, None], served)
    hits = tree_sum(served.double(), -1)
    return {
        "precision_sum": precision,
        "hits": hits,
        "users": users.expand_as(hits),
        "avg_precision": precision / users.clamp_min(1.0),
        "hit_rate": hits / users.clamp_min(1.0),
        "avg_qoe": tree_sum(qoe_u, -1) / users.clamp_min(1.0),
        "mem_util": tree_sum(util, -1) / n_bs.clamp_min(1.0),
    }
