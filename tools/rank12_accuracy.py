"""K12's distance from float64 on the bench world's recorded prune calls.

    python tools/rank12_accuracy.py [--frames 200] [--save FILE | --load FILE] [--root DIR]
    JAX_PLATFORMS=cpu python tools/rank12_accuracy.py --jax [--frames 60]

On the card: renders the bench world as chip_smoke.py does (euroc_config,
seed 5), runs ``run_sequence`` over it and records every rank-12 prune
update (``apply_update_rank12_rows``; ``apply_update_rank12`` on a tree that
lacks the row entry).  ``--save`` writes the calls to FILE, ``--load``
reads them from FILE instead of running.  ``--root`` imports the port from
another checkout (a ``git archive`` of an older commit), so that its
kernel runs on the same calls.  For each call, field by field (the IMU's q,
bg, v, ba, p, the extrinsics, the window's q and p, the covariance), the
distance of the kernel's and of the float32 plain version's new state
from the float64 plain version's, relative to the field's largest entry.
Prints the calls on which the kernel is past max(1.25 x the plain
version's distance, 1e-4) in some field, the largest distances over all
calls with their field, and the kernel's device us at the most frequent
shape (torch.profiler).

``--jax`` (the CPU): the port's plain path over the first ``--frames``
frames of the same world rendered without OpenCV, recording the prune
calls; on each, the JAX package's float32 ``apply_update_rank12`` and the
port's float32 plain version held against the JAX package's float64 run,
field by field as above.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FIELDS = ("q", "bg", "v", "ba", "p", "R_imu_cam0", "t_cam0_imu", "cams.q", "cams.p", "cov")
BAR_FACTOR, BAR_FLOOR = 1.25, 1e-4


def fields(state):
    i, c = state.imu, state.cams
    vals = (i.q, i.bg, i.v, i.ba, i.p, i.R_imu_cam0, i.t_cam0_imu, c.q, c.p, state.cov)
    return dict(zip(FIELDS, vals))


def distances(got, want):
    """{field: |got - want|max / |want|max} in float64 numpy."""
    import numpy as np

    g, w = fields(got), fields(want)
    out = {}
    for k in FIELDS:
        a, b = np.asarray(g[k], np.float64), np.asarray(w[k], np.float64)
        out[k] = float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-30)
    return out


def summarise(label, per_call):
    """per_call: [(tag, kernel distances, plain distances)]."""
    worst_k = max((max(d.values()), t, max(d, key=d.get)) for t, d, _ in per_call)
    worst_p = max((max(p.values()), t, max(p, key=p.get)) for t, _, p in per_call)
    bad = [(t, f, d[f], p[f]) for t, d, p in per_call for f in FIELDS
           if d[f] > max(BAR_FACTOR * p[f], BAR_FLOOR)]
    print(f"{label}: {len(per_call)} calls; largest distance from float64, field by field: "
          f"kernel {worst_k[0]:.4e} ({worst_k[2]}, call {worst_k[1]}), float32 plain "
          f"{worst_p[0]:.4e} ({worst_p[2]}, call {worst_p[1]}); past max({BAR_FACTOR} x plain, "
          f"{BAR_FLOOR:g}) on {len({b[0] for b in bad})} calls", flush=True)
    for t, f, d, p in bad[:20]:
        print(f"  call {t} {f}: kernel {d:.4e}, float32 plain {p:.4e}")


def card(args):
    import torch

    if args.root:
        sys.path.insert(0, str(Path(args.root).resolve()))
    sys.path.insert(1, str(ROOT))
    from uav_airvision_tpu_torch import device, kernels
    from uav_airvision_tpu_torch.models.msckf import update as upd

    dev = device.get_device("cuda")
    print(f"port from {Path(kernels.__file__).resolve().parent.parent}", flush=True)
    if args.load:
        calls = torch.load(args.load, weights_only=False)
    else:
        from uav_airvision_tpu_torch.models import vio
        from uav_airvision_tpu_torch.profile_main import render

        config, pb, cam0, cam1 = render(args.frames)
        frames = vio.frames_from_prebatch(pb, cam0, cam1, dev)
        calls = []

        def record(name, a):
            if name == "apply_update_rank12_rows":
                calls.append(a)
            elif name == "apply_update_rank12":  # the masked stack: include every row
                state, params, B, r, cols = a
                calls.append((state, params, B[:, None, :], r[:, None],
                              torch.ones(B.shape[0], dtype=torch.bool, device=B.device), cols))

        kernels.observer = record
        vio.run_sequence(config, frames, pb.gyro_bias, pb.acc_mean)
        torch.cuda.synchronize()
        kernels.observer = None
        if args.save:  # each tensor on its own storage (the states' fields share one)
            torch.save(torch.utils._pytree.tree_map(
                lambda x: x.clone() if torch.is_tensor(x) else x, calls), args.save)

    rows = hasattr(upd, "apply_update_rank12_rows")

    def kernel(state, params, H12, r_blk, include, cols):
        if rows:
            return upd.apply_update_rank12_rows(state, params, H12, r_blk, include, cols)
        K, R = r_blk.shape
        B = torch.where(include[:, None, None], H12, 0.0).reshape(K * R, 12)
        r = torch.where(include[:, None], r_blk, 0.0).reshape(K * R)
        return upd.apply_update_rank12(state, params, B, r, cols)

    def plain(state, params, H12, r_blk, include, cols):
        K, R = r_blk.shape
        B = torch.where(include[:, None, None], H12, 0.0).reshape(K * R, 12)
        r = torch.where(include[:, None], r_blk, 0.0).reshape(K * R)
        return upd.apply_update_rank12_plain(state, params, B, r, cols)

    def f64(tree):
        return torch.utils._pytree.tree_map(
            lambda x: x.double() if torch.is_tensor(x) and x.is_floating_point() else x, tree)

    per_call, shapes = [], {}
    for k, (state, params, H12, r_blk, include, cols) in enumerate(calls):
        got, _ = kernel(state, params, H12, r_blk, include, cols)
        p32, _ = plain(state, params, H12, r_blk, include, cols)
        ref, _ = plain(f64(state), f64(params), H12.double(), r_blk.double(), include, cols)
        cpu = [torch.utils._pytree.tree_map(lambda x: x.cpu() if torch.is_tensor(x) else x, s)
               for s in (got, p32, ref)]
        per_call.append((k, distances(cpu[0], cpu[2]), distances(cpu[1], cpu[2])))
        shapes.setdefault(tuple(H12.shape), []).append(k)
    summarise(f"K12 ({'apply_update_rank12_rows' if rows else 'apply_update_rank12'})",
              per_call)
    shape = max(shapes, key=lambda s: len(shapes[s]))
    a = calls[shapes[shape][-1]]
    kernel(*a)
    torch.cuda.synchronize()
    cuda = torch.profiler.ProfilerActivity.CUDA
    with torch.profiler.profile(activities=[cuda]) as prof:
        for _ in range(40):
            kernel(*a)
        torch.cuda.synchronize()
    us = [e.self_device_time_total / e.count for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA and "rank12_kernel" in e.key]
    print(f"K12 at {shape} ({len(shapes[shape])} calls, the latest): device "
          f"{us[0] if us else float('nan'):.2f} us a launch", flush=True)


def jax_cpu(args):
    sys.modules["cv2"] = None  # render as a machine without OpenCV does
    sys.path.insert(0, str(ROOT))
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np
    import torch

    torch.set_num_threads(min(4, os.cpu_count() or 1))
    from uav_airvision_tpu.models.msckf import state as jstate
    from uav_airvision_tpu.models.msckf import update as jupd
    from uav_airvision_tpu_torch.models import vio
    from uav_airvision_tpu_torch.models.msckf import update as upd
    from uav_airvision_tpu_torch.profile_main import render

    config, pb, cam0, cam1 = render(args.frames)
    frames = vio.frames_from_prebatch(pb, cam0, cam1, "cpu")
    calls, orig = [], upd.apply_update_rank12_rows

    def spy(*a):
        calls.append(a)
        return orig(*a)

    from uav_airvision_tpu_torch.models.msckf import step

    step.apply_update_rank12_rows = spy
    try:
        vio.run_sequence(config, frames, pb.gyro_bias, pb.acc_mean)
    finally:
        step.apply_update_rank12_rows = orig
    types = {c.__name__: c for c in (jstate.FilterState, jstate.ImuState, jstate.CamWindow,
                                     jstate.FeatureTable, jstate.MsckfParams)}

    def to_jax(tree, dtype):
        if isinstance(tree, tuple) and hasattr(tree, "_fields"):
            return types[type(tree).__name__](*(to_jax(x, dtype) for x in tree))
        x = np.asarray(tree.numpy())
        return jnp.asarray(x.astype(dtype) if x.dtype.kind == "f" else x)

    fn = jax.jit(jupd.apply_update_rank12)
    per_call = []
    for k, (state, params, H12, r_blk, include, cols) in enumerate(calls):
        K, R = r_blk.shape
        B = torch.where(include[:, None, None], H12, 0.0).reshape(K * R, 12)
        r = torch.where(include[:, None], r_blk, 0.0).reshape(K * R)
        out = {}
        for dt in (np.float32, np.float64):
            st, _ = fn(to_jax(state, dt), to_jax(params, dt), jnp.asarray(B.numpy().astype(dt)),
                       jnp.asarray(r.numpy().astype(dt)), jnp.asarray(cols.numpy()))
            out[dt] = st
        p32, _ = upd.apply_update_rank12_plain(state, params, B, r, cols)
        per_call.append((k, distances(out[np.float32], out[np.float64]),
                         distances(p32, out[np.float64])))
    print(f"{len(calls)} prune calls over the first {args.frames} frames on the CPU (cv2-free "
          f"rendering); 'kernel' below is the JAX package's float32 apply_update_rank12, "
          f"'plain' the port's float32 plain version, both against JAX's float64 run")
    summarise("JAX float32 / port plain float32 vs JAX float64", per_call)
    for k, d, p in per_call[:12]:
        f = max(d, key=d.get)
        print(f"  call {k}: JAX float32 {d[f]:.4e} ({f}), port plain float32 "
              f"{max(p.values()):.4e} ({max(p, key=p.get)})")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--frames", type=int, default=200)
    parser.add_argument("--save")
    parser.add_argument("--load")
    parser.add_argument("--root", help="a checkout whose port runs the kernel")
    parser.add_argument("--jax", action="store_true", help="the CPU comparison with JAX")
    args = parser.parse_args(argv)
    if args.jax:
        jax_cpu(args)
    else:
        card(args)


if __name__ == "__main__":
    main()
