"""Device time per launch of the port's K2 (pyramid), K4+K6 (FAST), K9
(feature block), K5 (per-cell top-k), K12 (rank-12 prune update), K13
(triangulation), K10 (gate), K11 (EKF update), K14 (IMU propagation), K1
(LK) and P1 (window extract) kernels, alone on the card, by torch.profiler.

    python tools/kernel_probe.py [--frames 60] [--only K1]

K2: both cameras of a 480x752 pair at 1 to 4 levels (the step from one
level count to the next is what the band blocks spend on that level), one
image at an address that is not 16-byte aligned (the staging's byte-load
path) and one camera.  K4+K6: the latest frame's call of the run below.
K9: the latest ``feature_block_rows`` call of each shape (the lost
features' and the prune's).  K5: the run's latest call.  K12: the run's latest prune call, through the row-indexed
entry and through the dense entry on the same masked stack, and the same
call on a 70-slot window (D = 441).  K13: the run's latest call of its row entry
``triangulate_rows`` (the fused passes) at B = 16 and at its largest B
(N = 20), as recorded and with every selected row to triangulate, and the
same rows through ``triangulate`` (the separate passes).  Each of these
with the SM clock cycles of its phases.  The compact-window LK
(frontend.lk_compact_windows, the configuration of ``profile_main.py
--config compact``): the latest LK call of each shape that
``run_sequence`` makes under it on the same frames, through
``pyramidal_lk`` (K1's compact entry, one launch, with the SM cycles of
its levels' phases) and through its witness route (P1's window extract
and K1's level entry per level).
K10: the gate calls that ``run_sequence`` makes on
the first ``--frames`` frames of the bench world (recorded through
``kernels.observer``, the latest call of each shape), each launched again
40 times in a row, beside the same calls with every block forced to the
bounds' pass side (no gamma) and forced undecided (gamma on every block).
K11: the latest ``apply_update`` call of that run, its true rows repeated
(each copy scaled a little differently) to 4 to 282 rows, and past T2 to
the QR tier, beside ``torch.linalg.solve(S, HP)`` at the same rows, with
the SM clock cycles of each of the kernel's phases.  K14: a 141 and a 441
covariance (20 and 70 window slots) with 1, 11 and 64 valid IMU samples of
the 64-slot slice, float32, with the SM clock cycles of its four phases
(the state chain, Phi_i and Q_i, the fold, the covariance pass).  K1: the
latest ``pyramidal_lk`` call of each shape in the run (the temporal,
stereo forward and backward calls) with the SM clock cycles of block 0's
phases (each level's template, its Gauss-Newton steps and their count),
and each 2-level call again with its level 0 alone (n_levels 1): the
difference is level 1's.  ``--only K1`` runs the recording run and K1's
probes alone.
Prints one line per case: the device time of each kernel the call launched
(us per launch, and its launches per call where that is not one) and the
wall time per call by CUDA events.  Needs a CUDA
device; prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

CUDA = torch.profiler.ProfilerActivity.CUDA


def probe(label: str, fn, n: int = 40) -> None:
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    kernels = [f"{e.key.split('(')[0].split('::')[-1][:40]} {e.self_device_time_total / e.count:.2f}"
               + (f" x{e.count / n:g}" if e.count != n else "")
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    print(f"{label}: device us/launch [{'; '.join(kernels)}]; wall {a.elapsed_time(b) / n * 1e3:.1f} "
          f"us/call", flush=True)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--frames", type=int, default=60)
    parser.add_argument("--only", choices=["K1"], default=None,
                        help="the recording run and this kernel's probes alone")
    args = parser.parse_args(argv)

    from uav_airvision_tpu_torch import device, kernels
    from uav_airvision_tpu_torch.models import vio
    from uav_airvision_tpu_torch.models.msckf import propagation, update
    from uav_airvision_tpu_torch.ops import pyramid
    from uav_airvision_tpu_torch.profile_main import render

    dev = device.get_device("cuda")
    kernels.lib()
    ptxas = kernels.build_info.get("ptxas", "").splitlines()
    for k, line in enumerate(ptxas):  # K11's and K1's (side 15) registers and spills
        if "Compiling entry" in line and ("update_kernel" in line or "lk_kernelILi15E" in line):
            for x in ptxas[k:k + 4]:
                print(f"[ptxas] {x.strip()}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip() if smi.returncode == 0 else "nvidia-smi failed")

    config, pb, cam0, cam1 = render(args.frames)
    img0, img1 = (torch.as_tensor(x[-1], device=dev) for x in (cam0, cam1))
    odd = torch.empty(img0.numel() + 1, dtype=torch.uint8, device=dev)[1:].view(img0.shape)
    odd.copy_(img0)
    for levels in range(4 if args.only is None else 0):
        probe(f"K2 pair, {levels + 1} level(s)",
              lambda: pyramid.build_pyramid_pair(img0, img1, levels))
    if args.only is None:
        probe("K2 pair, cam0 at an odd address", lambda: pyramid.build_pyramid_pair(odd, img1, 3))
        probe("K2 one camera", lambda: pyramid.build_pyramid_padded(img0, 3))

    calls, ekf, lk_calls, fast_calls, k9_calls, k5_k12, k13 = {}, [], {}, {}, {}, {}, {}

    def record(name, a):
        # the single path is the fleet's B = 1 step: its batched kernels'
        # calls carry a leading axis of 1, dropped here (the same launch)
        pos = {"detect_fast": (0, 2, 3), "dense_grid_topk": (0,), "pyramidal_lk": (2, 3, 4)}
        if name in pos and a[pos[name][0]].dim() == 3 and a[pos[name][0]].shape[0] == 1:
            a = tuple(x[0] if i in pos[name] and x is not None else x for i, x in enumerate(a))
        if name == "triangulate_rows":
            k13[a[6].shape[0]] = a
        elif name in ("dense_grid_topk", "apply_update_rank12", "apply_update_rank12_rows"):
            k5_k12[name] = a
        elif name == "detect_fast":
            fast_calls[tuple(a[0].shape)] = a
        elif name == "feature_block_rows":
            k9_calls[(a[7].shape[0], a[4].shape[1] if a[13] is None else a[13].shape[0])] = a
        elif name == "gating_test_batch":
            calls[tuple(a[0].shape)] = a
        elif name == "apply_update":
            ekf[:] = [a]
        elif name == "pyramidal_lk":
            lk_calls[(a[2].shape[0], a[9])] = a

    kernels.observer = record
    frames = vio.frames_from_prebatch(pb, cam0, cam1, dev)
    vio.run_sequence(config, frames, pb.gyro_bias, pb.acc_mean)
    torch.cuda.synchronize()
    kernels.observer = None
    if args.only == "K1":
        probe_lk(lk_calls)
        return
    probe_fast_k9(fast_calls, k9_calls)
    probe_topk_rank12(k5_k12, config, dev)
    probe_triangulate(k13)
    probe_compact(config, frames, pb)
    for shape, a in sorted(calls.items()):
        H, r, rows, cov, s2, table, dof = a
        thresh = table[torch.clamp(dof, 0, table.shape[0] - 1).long()]
        rtr0 = (r * r).sum(-1)
        rtr = rtr0.clamp(min=1e-30)
        tr = ((H @ cov) * H).sum((1, 2))
        scales = {"as recorded": torch.ones_like(rtr),
                  "all pass": torch.sqrt(1e-3 * thresh * s2 / rtr),
                  "all undecided": torch.sqrt(thresh * torch.sqrt(s2 * (s2 + tr)) / rtr)}
        for label, sc in scales.items():
            rs = torch.where(rtr0[:, None] > 0, r * sc[:, None], r)
            probe(f"K10 {shape}, max rows {int(rows.max())}, {label}",
                  lambda: update.gating_test_batch(H, rs, rows, cov, s2, table, dof))
    state, params, H0, r0, rows0 = ekf[0]
    D = H0.shape[1]
    for rows in (4, 8, 16, rows0, 32, 64, 144, 282, 3 * D + 11):
        idx = torch.arange(rows, device=dev)
        scale = (1.0 + 0.05 * (idx // rows0)).to(H0.dtype)
        H = torch.zeros_like(H0)
        r = torch.zeros_like(r0)
        H[:rows] = H0[idx % rows0] * scale[:, None]
        r[:rows] = r0[idx % rows0] * scale
        tier = update.update_tier(H.shape[0], D, rows)
        probe(f"K11 apply_update, {rows} rows ({tier})",
              lambda: update.apply_update(state, params, H, r, rows))
        clocks = torch.zeros(7, dtype=torch.int64, device=dev)
        update._ekf_update_kernel(state.cov, H, r, params.obs_noise, rows, state, clocks)
        c = clocks.tolist()
        print(f"  K11 phases, SM clock cycles: staging/QR {c[1] - c[0]}, H P {c[2] - c[1]}, "
              f"S {c[3] - c[2]}, factorisation and solve {c[4] - c[3]}, delta and P_new "
              f"{c[5] - c[4]}, injection {c[6] - c[5]}; total {c[6] - c[0]}", flush=True)
        if tier != "QR":
            S = H[:rows] @ state.cov @ H[:rows].T + params.obs_noise * torch.eye(
                rows, device=dev, dtype=H.dtype)
            HP = H[:rows] @ state.cov
            probe(f"torch.linalg.solve(S, HP), {rows} rows", lambda: torch.linalg.solve(S, HP))
    probe_propagate(config, dev)
    probe_lk(lk_calls)
    for shape, a in calls.items():
        if shape[1] <= 32:
            H, cov, s2 = a[0], a[3], a[4]
            S = H @ cov @ H.transpose(1, 2) + s2 * torch.eye(shape[1], device=dev)
            probe(f"torch.linalg.cholesky_ex of the {shape} gate's S",
                  lambda: torch.linalg.cholesky_ex(S))


def probe_lk(lk_calls) -> None:
    """K1 (``lk_kernel``) on the run's latest call of each shape: device us
    a launch, the SM clock cycles of block 0's phases (the mean of 40
    launches), and each 2-level call's level 0 alone."""
    from uav_airvision_tpu_torch.ops import lk

    for (F, levels), a in sorted(lk_calls.items()):
        probe(f"K1 pyramidal_lk, {F} points x {levels} level(s)", lambda: lk.pyramidal_lk(*a))
        clocks = torch.zeros(1 + 3 * levels, dtype=torch.int64, device=a[2].device)
        runs = []
        for _ in range(40):
            lk.pyramidal_lk(*a, clocks=clocks)
            runs.append(clocks.tolist())
        c = [sum(r[k] for r in runs) / len(runs) for k in range(len(clocks))]
        start = c[0]
        parts = []
        for k in range(levels):
            ready, done, steps = c[1 + 3 * k], c[2 + 3 * k], c[3 + 3 * k]
            parts.append(f"level {levels - 1 - k}: template {ready - start:.0f}, Gauss-Newton "
                         f"{done - ready:.0f} ({steps:g} steps)")
            start = done
        print("  K1 lk_kernel, block 0's SM clock cycles, coarse to fine: " + "; ".join(parts)
              + f"; total {start - c[0]:.0f}", flush=True)
        if levels == 2:
            one = (*a[:9], 1, a[10])
            probe(f"K1 pyramidal_lk, {F} points, level 0 alone", lambda: lk.pyramidal_lk(*one))


def probe_fast_k9(fast_calls, k9_calls) -> None:
    """K4+K6 on the run's latest frame and K9's row-indexed entry on the
    run's latest call of each shape, each with the SM clock cycles of its
    phases."""
    from uav_airvision_tpu_torch.models.msckf import update
    from uav_airvision_tpu_torch.ops import fast

    for shape, (img, thr, pts, valid) in sorted(fast_calls.items()):
        n = 0 if pts is None else pts.shape[0]
        probe(f"K4+K6 detect_fast {shape}, {n} mask points",
              lambda: fast.detect_fast(img, thr, pts, valid))
        clocks = torch.zeros(6, dtype=torch.int64, device=img.device)
        fast._fast_kernel(img, thr, pts, valid, clocks)
        c = clocks.tolist()
        print(f"  K4+K6 phases of the middle block, SM clock cycles: staging {c[1] - c[0]}, "
              f"mask {c[2] - c[1]}, candidates {c[3] - c[2]}, scores {c[4] - c[3]}, NMS and "
              f"stores {c[5] - c[4]}; total {c[5] - c[0]}", flush=True)
    for (B, N), a in sorted(k9_calls.items()):
        cq, cp, cqn, cpn, obs, mask, pos, sel, proc, g, Rc, tc, D, rm = a
        probe(f"K9 feature_block_rows B={B} x N={N}, {int(proc.sum())} blocks computed",
              lambda: update.feature_block_rows(*a[:13], rm=rm))
        # block 0's phases, with every block computed
        clocks = torch.zeros(6, dtype=torch.int64, device=obs.device)
        update._feature_block_kernel(cq, cp, cqn, cpn, obs, mask, pos, g, Rc, tc, sel=sel,
                                     proc=torch.ones_like(proc), rm=rm, clocks=clocks)
        c = clocks.tolist()
        print(f"  K9 phases of block 0 (feature {int(sel[0])}, "
              f"{int((mask[sel[0]] if rm is None else mask[sel[0]][rm]).sum())} views), SM "
              f"clock cycles: staging and ranks {c[1] - c[0]}, Jacobians {c[2] - c[1]}, "
              f"reflections {c[3] - c[2]}, w_j {c[4] - c[3]}, rows {c[5] - c[4]}; total "
              f"{c[5] - c[0]}", flush=True)


def probe_topk_rank12(recorded, config, dev) -> None:
    """K5 on the run's latest call; K12 on the run's latest prune call through the row-indexed entry and
    through the dense entry on the same masked stack, and the same call on a
    70-slot window (D = 441, a random SPD covariance); each with the SM
    clock cycles of its phases."""
    from uav_airvision_tpu_torch.models.msckf import update
    from uav_airvision_tpu_torch.ops import gridops

    def phases(label, c):
        print(f"  {label} phases, SM clock cycles: "
              f"{', '.join(str(c[j] - c[j - 1]) for j in range(1, len(c)) if c[j])}; total "
              f"{max(c) - c[0]}", flush=True)

    score, gr, gc, k = recorded["dense_grid_topk"]
    probe(f"K5 dense_grid_topk {tuple(score.shape)}, {gr}x{gc} cells, k = {k}",
          lambda: gridops.dense_grid_topk(score, gr, gc, k))
    clocks = torch.zeros(8, dtype=torch.int64, device=dev)
    gridops._grid_topk_kernel(score, gr, gc, k, clocks)
    phases("K5 (the first cell's first block)", clocks.tolist())
    rows = recorded.get("apply_update_rank12_rows")
    if rows is not None:
        state, params, H12, r_blk, include, cols = rows
        B = torch.where(include[:, None, None], H12, 0.0).reshape(-1, 12)
        r = torch.where(include[:, None], r_blk, 0.0).reshape(-1)
        print(f"K12's latest prune call: {int(include.sum())} of {include.shape[0]} features "
              f"included")
    else:
        state, params, B, r, cols = recorded["apply_update_rank12"]
    for label, st in (("as recorded", state), ("D = 441", _wide(state, config, 70))):
        D = st.cov.shape[0]
        if rows is not None:
            a = (st, params, H12, r_blk, include, cols)
            probe(f"K12 apply_update_rank12_rows {tuple(H12.shape)}, {label} (D = {D})",
                  lambda: update.apply_update_rank12_rows(*a))
            clocks = torch.zeros(8, dtype=torch.int64, device=dev)
            update._rank12_kernel(st.cov, H12, r_blk, cols, params.obs_noise, st, clocks,
                                  include=include)
            phases("K12 rows (block 1)", clocks.tolist())
        probe(f"K12 apply_update_rank12 {tuple(B.shape)}, {label} (D = {D})",
              lambda: update.apply_update_rank12(st, params, B, r, cols))
        clocks = torch.zeros(8, dtype=torch.int64, device=dev)
        update._rank12_kernel(st.cov, B, r, cols, params.obs_noise, st, clocks)
        phases("K12 dense (block 1)", clocks.tolist())


def probe_triangulate(recorded) -> None:
    """K13 on the run's latest row-entry call at B = 16 and at its largest
    B: the row entry (fused passes) as recorded and with every row to
    triangulate (sel_ok all set, none initialized, no motion check), and
    the old entry (separate passes) on the same gathered rows, each with
    the SM clock cycles of block 0's first warp (row sel[0]) in each
    phase."""
    import dataclasses

    from uav_airvision_tpu_torch.models.msckf import triangulation as tri

    def phases(c):
        print(f"  K13 phases of its first row ({c[8]} steps), SM clock cycles: anchor and "
              f"views {c[1] - c[0]}, initial guess and its pass {c[2] - c[1]}, normal-equation "
              f"passes {c[3]}, solves {c[4]}, trial passes {c[5]}, loop {c[6] - c[2]}, finish "
              f"{c[7] - c[6]}; total {c[7] - c[0]}", flush=True)

    for B in sorted({16, max(recorded)} & set(recorded)):
        a = recorded[B]
        cq, cp, obs, mask, position, initialized, sel, sel_ok, R, t, cfg = a
        every = (cq, cp, obs, mask, position, torch.zeros_like(initialized), sel,
                 torch.ones_like(sel_ok), R, t,
                 dataclasses.replace(cfg, translation_threshold=-1.0))
        for label, args in (("as recorded", a), ("every row", every)):
            need = args[7] & ~args[5][sel]
            probe(f"K13 triangulate_rows B={B} x N={mask.shape[1]}, {label} ({int(need.sum())} "
                  f"to triangulate)", lambda: tri.triangulate_rows(*args))
        clocks = torch.zeros(9, dtype=torch.int64, device=obs.device)
        tri._triangulate_rows_kernel(*every, clocks=clocks)
        phases(clocks.tolist())
        old = (cq, cp, obs[sel], mask[sel], R, t, cfg, torch.ones_like(sel_ok))
        probe(f"K13 triangulate (separate passes) B={B}, the same rows, every row active",
              lambda: tri.triangulate(*old))
        clocks = torch.zeros(9, dtype=torch.int64, device=obs.device)
        tri._triangulate_kernel(*old, clocks=clocks)
        phases(clocks.tolist())


def probe_compact(config, frames, pb) -> None:
    """The compact-window LK on the latest call of each shape that
    run_sequence makes under frontend.lk_compact_windows (with the
    triangulation motion check, as profile_main.py --config compact runs):
    K1's compact entry (one launch; the SM cycles of block 0's phases) and
    its witness route, P1's extract and K1's level entry per level."""
    from uav_airvision_tpu_torch.models import vio
    from uav_airvision_tpu_torch.ops import lk
    from uav_airvision_tpu_torch.profile_main import variant

    recorded, orig = {}, lk.pyramidal_lk

    def spy(prev_pyr, curr_pyr, prev_pts, *a, **kw):
        n_levels = kw.get("n_levels") or min(prev_pyr.n_levels, curr_pyr.n_levels)
        one = (prev_pts[0], a[0][0], a[1][0], *a[2:]) if prev_pts.dim() == 3 else (prev_pts, *a)
        recorded[(one[0].shape[0], n_levels)] = ((prev_pyr, curr_pyr, *one), kw)
        return orig(prev_pyr, curr_pyr, prev_pts, *a, **kw)

    lk.pyramidal_lk = spy
    try:
        vio.run_sequence(variant(config, "compact"), frames, pb.gyro_bias, pb.acc_mean)
        torch.cuda.synchronize()
    finally:
        lk.pyramidal_lk = orig
    for (F, levels), (a, kw) in sorted(recorded.items()):
        probe(f"compact LK pyramidal_lk, {F} points x {levels} level(s), side {kw['win']}",
              lambda: lk.pyramidal_lk(*a, **kw))
        kw = {k: v for k, v in kw.items() if k != "compact_windows"}
        kw["n_levels"] = levels
        probe(f"  its witness route (P1 + K1's level entry a level, the host's des)",
              lambda: lk.pyramidal_lk_compact_levels(*a, **kw))
        clocks = torch.zeros(1 + 3 * levels, dtype=torch.int64, device=a[2].device)
        lk.pyramidal_lk_compact(*a, **kw, clocks=clocks)
        c = clocks.tolist()
        print("  K1 compact entry, block 0's SM clock cycles, coarse to fine: " + "; ".join(
            f"level {levels - 1 - k}: template {c[1 + 3 * k] - c[3 * k]}, window wait "
            f"{c[2 + 3 * k] - c[1 + 3 * k]}, Gauss-Newton {c[3 + 3 * k] - c[2 + 3 * k]}"
            for k in range(levels)) + f"; total {c[-1] - c[0]}", flush=True)


def _wide(state, config, N):
    """A state of an N-slot window (its first slots the recorded window's
    poses) with a random SPD covariance of 21 + 6N rows."""
    import dataclasses

    import numpy as np

    from uav_airvision_tpu_torch.models.msckf.state import init_state, make_params

    dev = state.cov.device
    cfg = dataclasses.replace(config, capacity=dataclasses.replace(
        config.capacity, max_cam_states=N))
    wide = init_state(cfg, make_params(config, dev), np.zeros(3), np.array([0.0, 0.0, 9.81]))
    n = state.cams.q.shape[0]
    cams = wide.cams._replace(q=wide.cams.q.clone(), p=wide.cams.p.clone(), count=state.cams.count)
    cams.q[:n], cams.p[:n] = state.cams.q, state.cams.p
    D = 21 + 6 * N
    A = torch.as_tensor(np.random.default_rng(12).normal(0, 0.05, (D, D)), device=dev)
    cov = A @ A.T / D + 1e-3 * torch.eye(D, device=dev, dtype=A.dtype)
    return state._replace(cams=cams, cov=cov.to(state.cov.dtype).contiguous())


def probe_propagate(config, dev) -> None:
    """K14 on a random SPD covariance and IMU slice (float32): device us a
    launch and the SM clock cycles of its phases."""
    import dataclasses

    import numpy as np

    from uav_airvision_tpu_torch.models.msckf import propagation
    from uav_airvision_tpu_torch.models.msckf.state import init_state, make_params

    rng = np.random.default_rng(14)
    params = make_params(config, dev)
    I = config.capacity.max_imu_per_frame
    for N in (20, 70):
        cfg = dataclasses.replace(config, capacity=dataclasses.replace(
            config.capacity, max_cam_states=N))
        state = init_state(cfg, params, np.zeros(3), np.array([0.0, 0.0, 9.81]))
        D = 21 + 6 * N
        A = torch.as_tensor(rng.normal(0, 0.05, (D, D)), device=dev)
        state = state._replace(cov=(A @ A.T / D + 1e-3 * torch.eye(D, device=dev, dtype=A.dtype))
                               .to(state.cov.dtype))
        dt = state.cov.dtype
        w = torch.as_tensor(rng.normal(0, 0.3, (I, 3)), device=dev).to(dt)
        a = torch.as_tensor(rng.normal([0, 0, 9.81], 0.5, (I, 3)), device=dev).to(dt)
        for n in (1, 11, 64):
            live = torch.arange(I, device=dev) < n
            t = torch.where(live, 0.005 * torch.arange(1, I + 1, device=dev, dtype=dt), 0.0)
            args = (state, params, t, w, a, live)
            probe(f"K14 propagate, D = {D}, {n} valid IMU samples", lambda: propagation.propagate(*args))
            clocks = torch.zeros(10, dtype=torch.int64, device=dev)
            propagation.propagate(*args, clocks=clocks)
            c = clocks.tolist()
            steps = "/".join(str(c[k] - c[k - 1]) for k in range(2, 7))
            print(f"  K14 phases, SM clock cycles: inputs {c[1] - c[0]}, state chain {c[6] - c[1]} "
                  f"(steps: integrators/products/rotations/sums/constraints {steps}), Phi_i and "
                  f"Q_i {c[7] - c[6]}, fold {c[8] - c[7]}, first 21 rows and columns "
                  f"{c[9] - c[8]}; total {c[9] - c[0]}", flush=True)

if __name__ == "__main__":
    main()
