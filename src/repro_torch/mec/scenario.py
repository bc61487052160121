"""MEC scenario: topology + request traces + window-by-window instances
(paper Sec. VII-A settings by default).

Instances come from numpy's RNG exactly as in the JAX package, so the two
packages build bit-equal windows from one config.  ``config_grid``
expands a base :class:`MECConfig` into a cross-product of variants, and
``stack_instances`` pads a heterogeneous list of windows into one batched
:class:`~repro_torch.core.lp.PDHGData` of tensors on the requested device.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field, replace

import numpy as np
import torch

from repro_torch.core.jdcr import JDCRInstance
from repro_torch.core.lp import PDHGData, pdhg_data_from_numpy, pdhg_fields
from repro_torch.mec.catalog import Catalog, make_catalog


@dataclass
class MECConfig:
    n_bs: int = 5
    n_users: int = 600
    n_models: int = 8
    window_s: float = 3.0
    n_windows: int = 10
    zipf: float = 0.8
    mem_capacity_mb: float = 500.0
    compute_gflops: float = 70.0
    wireless_mbps: float = 20.0        # user -> home BS
    wired_mbps: float = 100.0          # BS <-> BS
    cloud_mbps: float = 800.0          # cloud -> BS (online downloads)
    hop_latency_s: float = 0.01
    er_prob: float = 0.5
    data_mb: float = 0.144
    ddl_s: float = 0.3
    popularity_change_every: int = 0   # in windows; 0 = static popularity
    seed: int = 0


def _er_connected(n, p, rng):
    """Erdős–Rényi graph, re-drawn until connected; returns (adj, hops)."""
    while True:
        adj = rng.random((n, n)) < p
        adj = np.triu(adj, 1)
        adj = adj | adj.T
        hops = np.full((n, n), np.inf)
        for s in range(n):
            hops[s, s] = 0
            frontier = [s]
            d = 0
            while frontier:
                d += 1
                nxt = []
                for v in frontier:
                    for w in np.nonzero(adj[v])[0]:
                        if hops[s, w] == np.inf:
                            hops[s, w] = d
                            nxt.append(w)
                frontier = nxt
        if np.isfinite(hops).all():
            return adj, hops.astype(int)


def zipf_popularity(n, a, rng):
    p = np.ones(n) if a <= 0 else 1.0 / np.arange(1, n + 1) ** a
    p = p / p.sum()
    return p[rng.permutation(n)]


class Scenario:
    """Holds the static topology and generates per-window JDCR instances."""

    def __init__(self, cfg: MECConfig, catalog: Catalog = None):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        self.rng = rng
        N, M = cfg.n_bs, cfg.n_models
        cat = catalog or make_catalog("paper", n_models=M,
                                      seed=cfg.seed + 7)
        if cat.n_models != M:
            raise ValueError(f"catalog has {cat.n_models} models, "
                             f"config wants n_models={M}")
        self.catalog = cat
        self.sizes, self.prec = cat.sizes, cat.prec
        self.flops_req, self.loadD = cat.flops, cat.loadD
        # flops per data unit (paper c_h): Table II is GFLOP per request of
        # size d_u, so c_h = GFLOP / d_u per MB
        self.flops = self.flops_req / cfg.data_mb
        self.adj, self.hops = _er_connected(N, cfg.er_prob, rng)
        mbps = 1.0 / 8.0                                    # Mb -> MB
        self.phi = np.full(N, cfg.wireless_mbps * mbps)     # MB/s
        self.wired = np.where(np.eye(N, dtype=bool), np.inf,
                              cfg.wired_mbps * mbps)
        # propagation: round trip = 2 wireless legs + 2 * hops wired legs
        self.lam = cfg.hop_latency_s * (2.0 + 2.0 * self.hops)
        self.R = np.full(N, cfg.mem_capacity_mb)
        self.C = np.full(N, cfg.compute_gflops)
        self.pop = zipf_popularity(M, cfg.zipf, rng)

    def empty_cache(self):
        x = np.zeros((self.cfg.n_bs, self.cfg.n_models,
                      self.sizes.shape[1]))
        x[:, :, 0] = 1.0
        return x

    def maybe_reshuffle_popularity(self, window: int):
        ce = self.cfg.popularity_change_every
        if ce and window > 0 and window % ce == 0:
            self.pop = self.pop[self.rng.permutation(len(self.pop))]

    def draw_requests(self, n_users=None):
        cfg = self.cfg
        U = n_users or cfg.n_users
        m_u = self.rng.choice(cfg.n_models, size=U, p=self.pop)
        home = self.rng.integers(0, cfg.n_bs, size=U)
        s_u = self.rng.uniform(0.0, cfg.window_s, size=U)
        return m_u, home, s_u

    def instance(self, window: int, x_prev, n_users=None) -> JDCRInstance:
        cfg = self.cfg
        self.maybe_reshuffle_popularity(window)
        m_u, home, s_u = self.draw_requests(n_users)
        U = len(m_u)
        wired = np.where(np.isinf(self.wired), 1e12, self.wired)
        return JDCRInstance(
            sizes=self.sizes, prec=self.prec, flops=self.flops,
            loadD=self.loadD, R=self.R, C=self.C, phi=self.phi,
            wired=wired, lam=self.lam,
            m_u=m_u, d_u=np.full(U, cfg.data_mb),
            ddl=np.full(U, cfg.ddl_s), s_u=s_u, home=home,
            x_prev=np.asarray(x_prev, dtype=np.float64))


# ---------------------------------------------------------------------------
# batching: config grids and stacked instances
# ---------------------------------------------------------------------------

def config_grid(base: MECConfig, axes: dict) -> list:
    """Cross-product of MECConfig variants, in itertools.product order of
    ``axes`` (insertion-ordered)."""
    names = list(axes)
    return [replace(base, **dict(zip(names, combo)))
            for combo in itertools.product(*(axes[k] for k in names))]


@dataclass
class StackedWindows:
    """A padded stack of JDCR windows: ``data`` is a PDHGData of tensors
    with a leading batch axis (padded to the max N and U in the stack);
    ``n_bs[i]``/``n_users[i]`` are element i's true sizes."""
    data: PDHGData
    n_bs: np.ndarray             # (B,)
    n_users: np.ndarray          # (B,)
    insts: list = field(default_factory=list)

    def __len__(self):
        return len(self.n_bs)

    def unstack(self, x, A):
        """Slice padded batch solutions (B,N,M,H+1), (B,N,U,H) — tensors
        or arrays — back into per-instance NumPy (x_i, A_i) at their true
        shapes."""
        x, A = (torch.as_tensor(v).cpu().numpy() for v in (x, A))
        return [(x[i, :N_i], A[i, :N_i, :U_i])
                for i, (N_i, U_i) in enumerate(zip(self.n_bs, self.n_users))]


def stack_instances(insts: list, pad_to: tuple = None,
                    device="cuda") -> StackedWindows:
    """Pad + stack JDCR windows into one batched PDHGData on ``device``.

    All instances must share the catalog shape (M, H); N and U may differ.
    Padded base stations get ``bs_mask`` 0, padded users a zero
    ``onehot_mu`` row and zero precision, so every pad is inert.
    ``pad_to=(N_pad, U_pad)`` pads to an explicit shape instead of the
    stack's own max.
    """
    if not insts:
        raise ValueError("stack_instances needs at least one instance")
    M, H = insts[0].M, insts[0].H
    for inst in insts:
        if (inst.M, inst.H) != (M, H):
            raise ValueError(
                f"heterogeneous catalog shapes: ({inst.M},{inst.H}) vs "
                f"({M},{H}); stack only varies N/U")
    N_max = max(inst.N for inst in insts)
    U_max = max(inst.U for inst in insts)
    if pad_to is not None:
        pN, pU = int(pad_to[0]), int(pad_to[1])
        if pN < N_max or pU < U_max:
            raise ValueError(
                f"pad_to {pad_to} smaller than the stack's own max "
                f"({N_max}, {U_max})")
        N_max, U_max = pN, pU

    fields = {k: [] for k in PDHGData._fields}
    for inst in insts:
        d = pdhg_fields(inst)
        dn, du = N_max - inst.N, U_max - inst.U
        fields["sizes"].append(d["sizes"])
        fields["prec"].append(d["prec"])
        fields["prec_u"].append(np.pad(d["prec_u"], ((0, du), (0, 0))))
        fields["T"].append(np.pad(d["T"], ((0, dn), (0, du), (0, 0))))
        fields["L"].append(np.pad(d["L"], ((0, dn), (0, du), (0, 0))))
        fields["onehot_mu"].append(np.pad(d["onehot_mu"], ((0, du), (0, 0))))
        fields["R"].append(np.pad(d["R"], (0, dn)))
        fields["ddl"].append(np.pad(d["ddl"], (0, du)))
        fields["s_u"].append(np.pad(d["s_u"], (0, du)))
        fields["bs_mask"].append(np.pad(d["bs_mask"], (0, dn)))
        fields["home_onehot"].append(np.pad(d["home_onehot"],
                                            ((0, du), (0, dn))))
    data = pdhg_data_from_numpy({k: np.stack(v) for k, v in fields.items()},
                                device)
    return StackedWindows(
        data=data,
        n_bs=np.array([inst.N for inst in insts]),
        n_users=np.array([inst.U for inst in insts]),
        insts=list(insts))
