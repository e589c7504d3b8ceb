"""Device time per launch of the port's K2 (pyramid) and K10 (gate) kernels,
alone on the card, by torch.profiler.

    python tools/kernel_probe.py [--frames 60]

K2: both cameras of a 480x752 pair at 1 to 4 levels (the step from one
level count to the next is what the band blocks spend on that level), one
image at an address that is not 16-byte aligned (the staging's byte-load
path) and one camera.  K10: the gate calls that ``run_sequence`` makes on
the first ``--frames`` frames of the bench world (recorded through
``kernels.observer``, the latest call of each shape), each launched again
40 times in a row, beside the same calls with every block forced to the
bounds' pass side (no gamma) and forced undecided (gamma on every block).
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

    calls = {}
    kernels.observer = lambda name, a: calls.__setitem__(tuple(a[0].shape), a) \
        if name == "gating_test_batch" else None
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
    for shape, a in calls.items():
        if shape[1] <= 32:
            H, cov, s2 = a[0], a[3], a[4]
            S = H @ cov @ H.transpose(1, 2) + s2 * torch.eye(shape[1], device=dev)
            probe(f"torch.linalg.cholesky_ex of the {shape} gate's S",
                  lambda: torch.linalg.cholesky_ex(S))


if __name__ == "__main__":
    main()
