"""Scenario-grid sweep of the offline CoCaR pipeline.

Fans a cross-product of :class:`MECConfig` variants (topology size, Zipf
skew, memory capacity, deadline — the axes of the paper's Sec. VII
comparisons) into one JDCR window each and runs LP → randomized rounding →
repair → metrics for all of them, crossed with ``n_seeds`` rounding seeds,
as one batched pipeline on the card (``repro_torch.core.cocar.cocar_grid``).
The result is one flat table: a row per (variant, seed) with the swept
axis values, the LP objective and the post-repair window metrics.

    PYTHONPATH=src python -m repro_torch.experiments.sweep
    PYTHONPATH=src python -m repro_torch.experiments.sweep --lp-backend fused --n-users 600

(``--n-users 600`` is the paper's Sec. VII-A load; the default 40 is the
JAX package's CI size.)
"""
from __future__ import annotations

import argparse

from repro_torch.core.cocar import cocar_grid
from repro_torch.core.lp import LP_BACKENDS
from repro_torch.mec.scenario import MECConfig, Scenario, config_grid

#: Default sweep: 2^4 = 16 variants over the four axes the paper varies.
#: n_bs values sit close together on purpose — heterogeneous topologies are
#: padded to the max N, so a tight spread keeps the padding waste low.
DEFAULT_AXES = {
    "n_bs": (5, 6),
    "zipf": (0.4, 0.8),
    "mem_capacity_mb": (300.0, 500.0),
    "ddl_s": (0.25, 0.35),
}


def sweep_instances(base: MECConfig = None, axes: dict = None,
                    window: int = 0):
    """``(cfgs, insts)``: the grid's configs and one window per config,
    each drawn from the config's own seeded scenario on an empty cache."""
    base = base or MECConfig(n_users=40)
    axes = axes or DEFAULT_AXES
    cfgs = config_grid(base, axes)
    scenarios = [Scenario(c) for c in cfgs]
    return cfgs, [sc.instance(window, sc.empty_cache()) for sc in scenarios]


def run_sweep(base: MECConfig = None, axes: dict = None, window: int = 0,
              pdhg_iters: int = 4000, best_of: int = 8, seed: int = 0,
              n_seeds: int = 1, lp_backend: str = "reference",
              device="cuda"):
    """One CoCaR window per (grid variant × rounding seed), the whole grid
    as one batched pipeline on ``device``.

    Returns a list of row dicts (variant-major, seed-minor, in grid
    order); with ``n_seeds > 1`` each row carries its ``rounding_seed``.
    """
    axes = axes or DEFAULT_AXES
    cfgs, insts = sweep_instances(base, axes, window)
    grid = cocar_grid(insts, seed=seed, pdhg_iters=pdhg_iters,
                      best_of=best_of, n_seeds=n_seeds,
                      lp_backend=lp_backend, device=device)
    rows = []
    for cfg, per_seed in zip(cfgs, grid):
        for s, (_x, _A, info) in enumerate(per_seed):
            row = {k: getattr(cfg, k) for k in axes}
            if n_seeds > 1:
                row["rounding_seed"] = s
            row["lp_obj"] = info["lp_obj"]
            row.update(info["metrics"])
            rows.append(row)
    return rows


def format_table(rows) -> str:
    """Fixed-width text rendering of a sweep table."""
    if not rows:
        return "(empty sweep)"
    cols = list(rows[0])
    widths = {c: max(len(c), 9) for c in cols}
    fmt = "  ".join(f"{{:>{widths[c]}}}" for c in cols)
    lines = [fmt.format(*cols)]
    for r in rows:
        lines.append(fmt.format(*(
            f"{v:.3f}" if isinstance(v, float) else str(v)
            for v in (r[c] for c in cols))))
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(description="offline CoCaR scenario-grid "
                                 "sweep on PyTorch")
    ap.add_argument("--lp-backend", choices=LP_BACKENDS, default="reference",
                    help="LP solver: the plain float64 reference or the "
                         "fused CUDA kernel")
    ap.add_argument("--n-users", type=int, default=40,
                    help="users per window (600 = the paper's Sec. VII-A)")
    ap.add_argument("--seeds", type=int, default=1,
                    help="rounding seeds per variant")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch path)")
    args = ap.parse_args(argv)
    rows = run_sweep(base=MECConfig(n_users=args.n_users),
                     n_seeds=args.seeds, lp_backend=args.lp_backend,
                     device=args.device)
    print(format_table(rows))
    return rows


if __name__ == "__main__":
    main()
