#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
card.

  1. prints the card's name and power limit;
  2. builds the hand-written CUDA kernel from this checkout's sources
     (``nvcc`` for sm_90a) and prints its ``-Xptxas -v`` report;
  3. holds the kernel against its plain PyTorch version on the card, in
     float64 (tolerance 1e-12) and float32 (2e-5), at one U=1000 window
     and at the padded 16-window sweep stack (N=6, U=600);
  4. drives the port's main path — the offline CoCaR sweep at the paper's
     Sec. VII-A width (16 variants, 600 users, 4000 PDHG iterations,
     best_of=8, 2 rounding seeds) — with the fused LP backend (the kernel)
     and with the plain float64 reference; checks identical cache/routing
     decisions, winning trials and per-trial objectives, and feasibility;
     prints the table and the threshold-shift certificate at this width
     for the kernel and for the plain schedule (a measurement: the mixed
     schedule's fractional gap outgrows the rounding margins at this
     width, whichever realizes it: tests/test_torch_cocar.py shows the
     JAX package's own fused pipeline outgrowing them already at 100
     users);
  5. prints the kernel's launches on the main path, its time and the
     plain version's (medians of 5 and 3 timed calls after a warm-up, with
     their ranges) and the bound worked out from the shapes;
  6. prints one ``{"kernels": [...]}`` line, then, last,
     ``{"ok": true, "device": {...}}``.

Any failed phase raises, so the script exits non-zero without the last
line; so it does without a CUDA card or outside a checkout of the
repository.  float32 matmuls run without TF32 throughout.

    python3 chip_smoke.py
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: H100 SXM peaks at its 700 W limit (NVIDIA data sheet): HBM3 bandwidth,
#: and dense arithmetic outside the tensor cores, per type.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}

F64_TOL, F32_TOL = 1e-12, 2e-5
PHASE_ITERS = (1, 37)
SCHEDULES = ((37, 5), (6, 2), (16, 16))      # (iters, polish)
ITERS, BEST_OF, N_SEEDS = 4000, 8, 2


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def threshold_shift_certificate(x_ref, A_ref, x_new, A_new, onehot_mu,
                                u_cat, u_phi):
    """Per-comparison certificate that two fractional solutions round to
    identical decisions under the given uniforms: every uniform's distance
    to its reference threshold exceeds that threshold's shift (a copy of
    tests/harness.py::threshold_shift_certificate).  Returns
    ``{"certified": bool, "headroom": min margin/shift ratio}``."""
    from repro_torch.core.jdcr import tree_sum

    def thresholds(x_frac, A_frac):
        probs = np.clip(x_frac, 0.0, 1.0)
        probs = probs / np.maximum(tree_sum(probs, -1), 1e-12)[..., None]
        cums = np.cumsum(probs[..., :-1], axis=-1)
        xa = np.einsum("nmh,um->nuh", x_frac[..., :, :, 1:], onehot_mu)
        phi = np.where(xa > 1e-12, A_frac / np.maximum(xa, 1e-12), 0.0)
        return cums, np.clip(phi, 0.0, 1.0)

    cums_r, phi_r = thresholds(x_ref, A_ref)
    cums_p, phi_p = thresholds(x_new, A_new)
    user_mask = onehot_mu.sum(-1) > 0
    m_cat = np.abs(u_cat[..., None] - cums_r)
    s_cat = np.broadcast_to(np.abs(cums_r - cums_p), m_cat.shape)
    m_phi = np.where(user_mask[None, :, None], np.abs(u_phi - phi_r), np.inf)
    s_phi = np.broadcast_to(np.abs(phi_r - phi_p), m_phi.shape)
    ok, head = True, float("inf")
    for m, s in ((m_cat, s_cat), (m_phi, s_phi)):
        ok &= bool(((s < m) | (s == 0.0)).all())
        if (s > 0.0).any():
            with np.errstate(divide="ignore"):
                head = min(head, float(np.where(
                    s > 0.0, m / np.maximum(s, 1e-300), np.inf).min()))
    return {"certified": ok, "headroom": head}


def certify(stacked, x_ref, A_ref, x_new, A_new, u_cat, u_phi):
    """``(windows certified, min headroom)`` of the certificate over a
    padded stack (padded fractional solutions, uniforms as tensors)."""
    u_cat, u_phi = u_cat.cpu().numpy(), u_phi.cpu().numpy()
    certs = [threshold_shift_certificate(
        x_ref[i, :N], A_ref[i, :N, :U], x_new[i, :N], A_new[i, :N, :U],
        inst.onehot_mu(), u_cat[i, :, :N], u_phi[i, :, :N, :U])
        for i, (inst, N, U) in enumerate(zip(stacked.insts, stacked.n_bs,
                                             stacked.n_users))]
    return (sum(c["certified"] for c in certs),
            min(c["headroom"] for c in certs))


def fused_vs_reference(stacked, seed, iters, n_seeds, best_of):
    """Both LP backends through the whole pipeline on the same uniforms:
    requires identical decisions, winning trials and per-trial objectives;
    returns the two outputs and the uniforms."""
    from repro_torch.core import cocar as CC

    u_cat, u_phi = CC.offline_uniforms(stacked, seed, n_seeds, best_of)
    f, r = (CC.offline_pipeline_device(stacked, u_cat, u_phi, iters,
                                       n_seeds, backend)
            for backend in ("fused", "reference"))
    for k in ("x", "A", "best_t", "trial_objs"):
        check(np.array_equal(f[k], r[k]), f"{k} differs between backends")
    return f, r, (u_cat, u_phi)


def iter_flops(stacked) -> int:
    """Arithmetic operations of one fused PDHG iteration on the stack's
    real (unpadded) entries, counted from the kernel's step: 22 per routing
    entry (n,h,u), 12 per cache entry (n,m,h), 12 per user, 3 per (n,m),
    4 per station."""
    M = stacked.data.sizes.shape[1]
    H = stacked.data.T.shape[-1]
    return int(sum(22 * N * H * U + 12 * N * M * (H + 1) + 12 * U
                   + 3 * N * M + 4 * N
                   for N, U in zip(stacked.n_bs, stacked.n_users)))


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 3
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 2
    from repro_torch.core import cocar as CC
    from repro_torch.core.jdcr import check_feasible_device
    from repro_torch.experiments.sweep import (format_table, run_sweep,
                                               sweep_instances)
    from repro_torch.kernels import _build
    from repro_torch.kernels import pdhg_fused as PF
    from repro_torch.mec.scenario import MECConfig, Scenario, stack_instances

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    card = card_line()
    print(card, flush=True)

    # -- 1. build -----------------------------------------------------------
    t0 = time.perf_counter()
    lib = _build.build("pdhg_fused")
    print(f"built {lib.relative_to(ROOT)} for sm_90a in "
          f"{time.perf_counter() - t0:.1f} s; ptxas report:")
    print(_build.ptxas_report("pdhg_fused").strip(), flush=True)

    # -- 2. kernel vs its plain version -------------------------------------
    sc = Scenario(MECConfig(n_users=1000, seed=2))
    _, grid_insts = sweep_instances(MECConfig())
    grid = stack_instances(grid_insts, device=dev)
    stacks = {"U1000 window (N=5, U=1000)":
              stack_instances([sc.instance(0, sc.empty_cache())], device=dev),
              "16-window sweep stack (N=6, U=600)": grid}
    max_err = 0.0
    gen = torch.Generator(device=dev).manual_seed(0)
    for label, st in stacks.items():
        for dtype, tol in ((torch.float64, F64_TOL), (torch.float32, F32_TOL)):
            for iters in PHASE_ITERS:
                _, s0 = PF._init_state(st.data, dtype)
                s0 = tuple(v + 0.1 * torch.rand(v.shape, generator=gen,
                                                dtype=dtype, device=dev)
                           for v in s0)
                got = PF.cuda_phase(st.data, s0, iters, dtype)
                ref = PF.plain_phase(st.data, s0, iters, dtype)
                torch.cuda.synchronize()
                err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
                max_err = max(max_err, err)
                print(f"kernel vs plain, {label}, {dtype}, {iters} it: "
                      f"max |err| {err:.3e} (tol {tol:g})")
                check(err <= tol, f"kernel disagrees with plain ({label})")
        for iters, polish in SCHEDULES:
            tol = F64_TOL if polish >= iters else F32_TOL
            got = PF.pdhg_fused(st.data, iters, polish=polish)
            ref = PF.pdhg_fused(st.data, iters, polish=polish, engine="plain")
            err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
            max_err = max(max_err, err)
            print(f"kernel vs plain, {label}, schedule {iters - polish} f32 + "
                  f"{polish} f64 it: max |err| {err:.3e} (tol {tol:g})")
            check(err <= tol, f"kernel schedule disagrees ({label})")

    # -- 3. the main path through the kernel --------------------------------
    base = MECConfig()
    kw = dict(base=base, pdhg_iters=ITERS, best_of=BEST_OF, n_seeds=N_SEEDS,
              device=dev)
    PF.cuda_phase.launches = 0
    t0 = time.perf_counter()
    rows = run_sweep(lp_backend="fused", **kw)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    launches = PF.cuda_phase.launches
    print(f"\nmain path: run_sweep(lp_backend='fused') over "
          f"{len(rows) // N_SEEDS} variants x {N_SEEDS} seeds, "
          f"{base.n_users} users, {ITERS} iterations, best_of={BEST_OF}: "
          f"{sweep_s:.3f} s, pdhg_fused kernel launches {launches}")
    check(launches > 0, "the main path never launched the kernel")
    print(format_table(rows), flush=True)
    t0 = time.perf_counter()
    rows_ref = run_sweep(lp_backend="reference", **kw)
    torch.cuda.synchronize()
    print(f"run_sweep(lp_backend='reference'): "
          f"{time.perf_counter() - t0:.3f} s")
    for r, q in zip(rows, rows_ref, strict=True):
        for k in r:
            if k == "lp_obj":    # the fractional objective: float32 noise
                check(abs(r[k] - q[k]) <= 1e-6 * abs(q[k]), "lp_obj differs")
            else:
                check(r[k] == q[k], f"sweep column {k} differs")

    # where the main path's time goes: its stages once more, one by one
    stages = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[name] = (time.perf_counter() - t) * 1e3
        return out

    _, insts = timed("build windows (numpy)", lambda: sweep_instances(base))
    st = timed("stack onto the card", lambda: stack_instances(insts, device=dev))
    u = timed("draw uniforms", lambda: CC.offline_uniforms(st, 0, N_SEEDS,
                                                           BEST_OF))
    xa = timed("LP (kernel)", lambda: PF.pdhg_fused(st.data, ITERS))
    out = timed("round+repair+argmax+metrics",
                lambda: CC._decide(st.data, *xa, *u, N_SEEDS))
    timed("results to the host", lambda: CC._numpy(out))
    print("main path stages (host clock, synchronized): " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in stages.items()))

    # decisions on the padded stack: every trial, feasibility, the table
    f, r, (u_cat, u_phi) = fused_vs_reference(grid, 0, ITERS, N_SEEDS,
                                              BEST_OF)
    for s in range(N_SEEDS):
        res = check_feasible_device(
            grid.data, torch.from_numpy(f["x"][:, s]).to(dev),
            torch.from_numpy(f["A"][:, s]).to(dev))
        worst = max(float(v.max()) for v in res.values())
        check(worst <= 1e-6, f"infeasible decision (residual {worst})")
    for k, v in f["metrics"].items():
        check(np.isfinite(v).all() and v.shape == (len(grid), N_SEEDS), k)
        col = np.array([row[k] for row in rows]).reshape(len(grid), N_SEEDS)
        check(np.array_equal(col, v), f"run_sweep's {k} is not the pipeline's")
    print(f"fused == reference: identical x, A, best_t and all {BEST_OF} "
          f"trial objectives on {len(grid)} windows x {N_SEEDS} seeds; "
          "feasible")

    # the certificate at full width, for the kernel and for the plain
    # version of the same mixed-precision schedule: reported, not required
    ok, head = certify(grid, r["x_frac"], r["A_frac"], f["x_frac"],
                       f["A_frac"], u_cat, u_phi)
    x_p, A_p = (v.cpu().numpy()
                for v in PF.pdhg_fused(grid.data, ITERS, engine="plain"))
    ok_p, head_p = certify(grid, r["x_frac"], r["A_frac"], x_p, A_p, u_cat,
                           u_phi)
    gap = max(np.abs(f["x_frac"] - r["x_frac"]).max(),
              np.abs(f["A_frac"] - r["A_frac"]).max())
    gap_p = max(np.abs(x_p - r["x_frac"]).max(),
                np.abs(A_p - r["A_frac"]).max())
    print(f"threshold-shift certificate at full width (fractional gap to "
          f"the float64 reference): kernel {gap:.3e}, {ok}/{len(grid)} "
          f"windows certified, min headroom {head:.3g}x; plain schedule "
          f"{gap_p:.3e}, {ok_p}/{len(grid)}, min headroom {head_p:.3g}x")

    # -- 4. time and bound of the kernel at the main path's shapes ----------
    data = grid.data

    def events_ms(fn, reps):
        """Per-call CUDA-event times of ``reps`` calls after one warm-up
        call: ``(median, min, max)`` in ms."""
        fn()
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times)), min(times), max(times)

    sweep = ITERS - PF.POLISH_TAIL
    kernel_t = events_ms(lambda: PF.pdhg_fused(data, ITERS), 5)
    plain_t = events_ms(lambda: PF.pdhg_fused(data, ITERS, engine="plain"),
                        3)
    kernel_ms, plain_ms = kernel_t[0], plain_t[0]
    flops = iter_flops(grid)
    nbytes = 0
    per_it = {}
    for dtype, n in ((torch.float32, sweep), (torch.float64, PF.POLISH_TAIL)):
        _, s0 = PF._init_state(data, dtype)
        per_it[dtype] = (
            events_ms(lambda: PF.cuda_phase(data, s0, n, dtype), 3)[0] / n,
            events_ms(lambda: PF.plain_phase(data, s0, 100, dtype), 3)[0]
            / 100)
        st_ops, m_idx, consts, _ = PF._kernel_operands(data, s0, dtype)
        nbytes += 2 * sum(v.nbytes for v in st_ops.values()) + m_idx.nbytes \
            + sum(v.nbytes for v in consts.values())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (flops * sweep / PEAK_FLOPS["float32"]
             + flops * PF.POLISH_TAIL / PEAK_FLOPS["float64"]) * 1e3
    bound_ms = max(t_bytes, t_ops)
    print(f"\npdhg_fused LP solve, 16 windows x (N=6, M=8, H=3, U=600), "
          f"{sweep} float32 + {PF.POLISH_TAIL} float64 iterations, on {card}:")
    print(f"  median of 5 / 3 calls after a warm-up: kernel {kernel_ms:.4f} "
          f"ms (range {kernel_t[1]:.4f}-{kernel_t[2]:.4f}), plain PyTorch "
          f"{plain_ms:.4f} ms (range {plain_t[1]:.4f}-{plain_t[2]:.4f}), "
          f"plain/kernel {plain_ms / kernel_ms:.2f}x; "
          f"bound {bound_ms:.5f} ms ({t_ops:.5f} ms by {flops} operations "
          f"per iteration, {t_bytes:.5f} ms by {nbytes} bytes)")
    for dtype, (k_it, p_it) in per_it.items():
        print(f"  per iteration, {dtype}: kernel {k_it * 1e3:.3f} us, "
              f"plain {p_it * 1e3:.3f} us")
    print(f"  launches on the main path: {launches}")

    print(json.dumps({"kernels": [{
        "name": "pdhg_fused", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/pdhg_fused.cu",
        "replaces": "src/repro/kernels/pdhg_fused.py:262",
        "launches": launches, "max_abs_err": max_err, "ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
