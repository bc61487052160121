"""CoCaR — the offline algorithm (paper Alg. 1 + Sec. V-D) over a grid of
windows, as one batched device pipeline.

``offline_pipeline_device`` takes a padded stack of windows through
LP (PDHG) → randomized rounding → repair → best-of-trials argmax → Eq. 40
window metrics, batched over (windows × rounding seeds × trials), on the
device the stack lives on.  ``cocar_grid`` is the user-facing entry point:
``results[b][s] = (x, A, info)`` at true (unpadded) shapes, the layout of
the JAX package's ``cocar_grid``.
"""
from __future__ import annotations

import torch

from repro_torch.core import lp as LP
from repro_torch.core.jdcr import objective_sel
from repro_torch.core.rounding import (draw_rounding_uniforms, repair_device,
                                       round_from_uniforms)
from repro_torch.mec import metrics as MET
from repro_torch.mec.scenario import StackedWindows, stack_instances


def _decide(data, x_f, A_f, u_cat, u_phi, n_seeds: int):
    """Round → repair → best trial per seed → metrics, from the fractional
    solution ``x_f (B,N,M,H+1)`` / ``A_f (B,N,U,H)``.  ``u_cat
    (B, S·T, N, M)`` / ``u_phi (B, S·T, N, U, H)`` carry ``n_seeds``
    independent rounding seeds of T trials each."""
    x_r, A_r = round_from_uniforms(x_f, A_f, data.onehot_mu, u_cat, u_phi)
    x_p, A_p = repair_device(data, x_r, A_r)
    objs = objective_sel(data.prec_u[:, None], A_p)               # (B, S·T)
    B = objs.shape[0]
    objs = objs.reshape(B, n_seeds, -1)                           # (B, S, T)
    best_t = objs.argmax(-1)                                      # (B, S)
    idx = torch.arange(n_seeds, device=objs.device) * objs.shape[-1] + best_t
    rows = torch.arange(B, device=objs.device)[:, None]
    x_b, A_b = x_p[rows, idx], A_p[rows, idx]                     # (B, S, ...)
    return {"x": x_b, "A": A_b, "trial_objs": objs, "best_t": best_t,
            "metrics": MET.window_metrics_device(data, x_b, A_b)}


def _pipeline_kernel(data, u_cat, u_phi, iters: int, n_seeds: int,
                     backend: str = "reference"):
    """A batch of padded windows through LP → round → repair → argmax →
    metrics.  ``backend`` picks the LP solver (``LP.LP_BACKENDS``)."""
    x_f, A_f = LP._lp_solve_kernel(data, iters, backend)
    out = _decide(data, x_f, A_f, u_cat, u_phi, n_seeds)
    out.update(x_frac=x_f, A_frac=A_f,
               lp_obj=torch.einsum("bnuh,buh->b", A_f, data.prec_u))
    return out


def offline_uniforms(stacked: StackedWindows, seed: int, n_seeds: int,
                     best_of: int):
    """The rounding randomness of the grid: one draw at the padded stack
    shape, ``(B, S·T, ...)``, from a generator seeded with ``seed`` on the
    stack's device."""
    B, N, U, H = stacked.data.T.shape
    M = stacked.data.sizes.shape[1]
    dev = stacked.data.T.device
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    return draw_rounding_uniforms(gen, n_seeds * max(best_of, 1), N, M, U, H,
                                  batch=B, device=dev)


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.cpu().numpy()


def offline_pipeline_device(stacked: StackedWindows, u_cat, u_phi,
                            pdhg_iters: int = 4000, n_seeds: int = 1,
                            lp_backend: str = "reference"):
    """The whole offline grid on the stack's device.  ``u_cat``/``u_phi``
    are tensors or NumPy arrays of ``offline_uniforms``' shapes.

    Returns a dict of padded NumPy arrays: ``x_frac (B,N,M,H+1)`` /
    ``A_frac``, best-per-seed integral ``x (B,S,...)`` / ``A``,
    ``trial_objs (B,S,T)``, ``best_t (B,S)``, ``metrics`` (dict of (B,S))
    and ``lp_obj (B,)``.
    """
    dev = stacked.data.T.device
    u_cat = torch.as_tensor(u_cat, dtype=torch.float64, device=dev)
    u_phi = torch.as_tensor(u_phi, dtype=torch.float64, device=dev)
    out = _pipeline_kernel(stacked.data, u_cat, u_phi, int(pdhg_iters),
                           int(n_seeds), backend=lp_backend)
    return _numpy(out)


def _unstack_device(stacked: StackedWindows, out, n_seeds: int):
    """Slice padded pipeline outputs into ``results[b][s] = (x, A, info)``."""
    results = []
    for i, inst in enumerate(stacked.insts):
        per_seed = []
        for s in range(n_seeds):
            info = {"lp_obj": float(out["lp_obj"][i]),
                    "obj": float(out["trial_objs"][i, s,
                                                   out["best_t"][i, s]]),
                    "best_t": int(out["best_t"][i, s]),
                    "trial_objs": out["trial_objs"][i, s],
                    "metrics": {k: float(v[i, s])
                                for k, v in out["metrics"].items()}}
            per_seed.append((out["x"][i, s, :inst.N],
                             out["A"][i, s, :inst.N, :inst.U], info))
        results.append(per_seed)
    return results


def cocar_grid(insts, seed: int = 0, pdhg_iters: int = 4000,
               best_of: int = 8, n_seeds: int = 1,
               lp_backend: str = "reference", device="cuda"):
    """CoCaR over a grid of independent windows × rounding seeds on
    ``device``: the instances are padded into one stack and run through
    the batched pipeline.  Returns ``results[b][s] = (x, A, info)`` with
    ``info = {lp_obj, obj, best_t, trial_objs, metrics}``."""
    stacked = stack_instances(list(insts), device=device)
    uniforms = offline_uniforms(stacked, seed, n_seeds, best_of)
    out = offline_pipeline_device(stacked, *uniforms, pdhg_iters=pdhg_iters,
                                  n_seeds=n_seeds, lp_backend=lp_backend)
    return _unstack_device(stacked, out, n_seeds)

