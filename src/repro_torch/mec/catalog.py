"""Dynamic-DNN catalog: submodel attributes (r_h, p_h, c_h, D_m).

Only the ``paper`` source is ported: the paper's own ViT measurements
(Tables II & III), model type 0 exactly ViT, types 1..M-1 deterministic
size-jittered variants.  The ``zoo`` and ``measured`` sources derive their
numbers from the model zoo, which is a later slice of the port.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.configs.vit_edge import VIT_LOAD_S, VIT_SUBMODELS


@dataclass(frozen=True)
class Catalog:
    """The model catalog the JDCR instances share.  Index 0 of the
    submodel axis is "not cached" (zero size/precision); index j >= 1 is
    submodel h_j."""
    sizes: np.ndarray            # (M, H+1) MB
    prec: np.ndarray             # (M, H+1) delivered precision
    flops: np.ndarray            # (M, H+1) GFLOP per request
    loadD: np.ndarray            # (M, H+1, H+1) switch seconds [from, to]
    source: str = "paper"
    names: tuple = ()

    @property
    def n_models(self) -> int:
        return self.sizes.shape[0]

    @property
    def H(self) -> int:
        return self.sizes.shape[1] - 1

    def load_seconds(self, m: int, lvl_from: int, lvl_to: int) -> float:
        """D_m for one transition, catalog-level indexed (0 = empty)."""
        return float(self.loadD[m, lvl_from, lvl_to])


def paper_catalog(n_models: int = 8, seed: int = 7) -> Catalog:
    """The paper's measured ViT tables, jittered into ``n_models`` types
    (the same numpy draws as the JAX package, so the arrays are equal)."""
    H = len(VIT_SUBMODELS)
    rng = np.random.default_rng(seed)
    factors = np.concatenate([[1.0], rng.uniform(0.5, 1.4, n_models - 1)])

    sizes = np.zeros((n_models, H + 1))
    prec = np.zeros((n_models, H + 1))
    flops = np.zeros((n_models, H + 1))
    loadD = np.zeros((n_models, H + 1, H + 1))
    base_load = np.asarray(VIT_LOAD_S)                     # (H+1, H)

    for m, f in enumerate(factors):
        for j, sub in enumerate(VIT_SUBMODELS):
            sizes[m, j + 1] = sub["memory_mb"] * f
            flops[m, j + 1] = sub["gflops"] * f
            dp = rng.uniform(-0.015, 0.015) if m else 0.0
            prec[m, j + 1] = min(sub["precision"] + dp, 0.999)
        loadD[m, :, 1:] = base_load * f
        loadD[m, 1:, 0] = 0.0
    return Catalog(sizes=sizes, prec=prec, flops=flops, loadD=loadD,
                   source="paper", names=("vit",) + ("",) * (n_models - 1))


def make_catalog(source: str = "paper", **kw) -> Catalog:
    """Build a named catalog — only ``make_catalog("paper", n_models=8)``
    in this slice of the port."""
    if source != "paper":
        raise NotImplementedError(
            f"catalog source {source!r} is not ported yet: the 'zoo' and "
            "'measured' catalogs wait for the model-zoo slice (ROADMAP.md, "
            "Queue 1 item 9, 'Serving')")
    return paper_catalog(**kw)
