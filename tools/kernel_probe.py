"""Device time per launch of the port's K2 (pyramid), K10 (gate) and K11 (EKF
update) kernels, alone on the card, by torch.profiler.

    python tools/kernel_probe.py [--frames 60]

K2: both cameras of a 480x752 pair at 1 to 4 levels (the step from one
level count to the next is what the band blocks spend on that level), one
image at an address that is not 16-byte aligned (the staging's byte-load
path) and one camera.  K10: the gate calls that ``run_sequence`` makes on
the first ``--frames`` frames of the bench world (recorded through
``kernels.observer``, the latest call of each shape), each launched again
40 times in a row, beside the same calls with every block forced to the
bounds' pass side (no gamma) and forced undecided (gamma on every block).
K11: the latest ``apply_update`` call of that run, its true rows repeated
(each copy scaled a little differently) to 4 to 282 rows, and past T2 to
the QR tier, beside ``torch.linalg.solve(S, HP)`` at the same rows, with
the SM clock cycles of each of the kernel's phases.
Prints one line per case: the device time of each kernel the call launched
(us per launch) and the wall time per call by CUDA events.  Needs a CUDA
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
    args = parser.parse_args(argv)

    from uav_airvision_tpu_torch import device, kernels
    from uav_airvision_tpu_torch.models import vio
    from uav_airvision_tpu_torch.models.msckf import update
    from uav_airvision_tpu_torch.ops import pyramid
    from uav_airvision_tpu_torch.profile_main import render

    dev = device.get_device("cuda")
    kernels.lib()
    ptxas = kernels.build_info.get("ptxas", "").splitlines()
    for k, line in enumerate(ptxas):  # K11's registers and spills
        if "Compiling entry" in line and "update_kernel" in line:
            for x in ptxas[k:k + 4]:
                print(f"[ptxas] {x.strip()}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip() if smi.returncode == 0 else "nvidia-smi failed")

    config, pb, cam0, cam1 = render(args.frames)
    img0, img1 = (torch.as_tensor(x[-1], device=dev) for x in (cam0, cam1))
    odd = torch.empty(img0.numel() + 1, dtype=torch.uint8, device=dev)[1:].view(img0.shape)
    odd.copy_(img0)
    for levels in range(4):
        probe(f"K2 pair, {levels + 1} level(s)",
              lambda: pyramid.build_pyramid_pair(img0, img1, levels))
    probe("K2 pair, cam0 at an odd address", lambda: pyramid.build_pyramid_pair(odd, img1, 3))
    probe("K2 one camera", lambda: pyramid.build_pyramid_padded(img0, 3))

    calls, ekf = {}, []

    def record(name, a):
        if name == "gating_test_batch":
            calls[tuple(a[0].shape)] = a
        elif name == "apply_update":
            ekf[:] = [a]

    kernels.observer = record
    frames = vio.frames_from_prebatch(pb, cam0, cam1, dev)
    vio.run_sequence(config, frames, pb.gyro_bias, pb.acc_mean)
    torch.cuda.synchronize()
    kernels.observer = None
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
    for shape, a in calls.items():
        if shape[1] <= 32:
            H, cov, s2 = a[0], a[3], a[4]
            S = H @ cov @ H.transpose(1, 2) + s2 * torch.eye(shape[1], device=dev)
            probe(f"torch.linalg.cholesky_ex of the {shape} gate's S",
                  lambda: torch.linalg.cholesky_ex(S))


if __name__ == "__main__":
    main()
