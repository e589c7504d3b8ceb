"""The PyTorch port stands alone: it imports nothing of JAX or of the JAX
package, nor OpenCV, PIL, matplotlib or PyQt5 when a module is imported,
its own copies of the JAX-free modules (config, simulated world, IMU
prebatching, trajectory writer, metrics, transforms, dataset readers, data
publisher) behave as the JAX package's do, its entry points default to
the card, and each kernel wrapper runs its plain version, bit for bit, on
CPU tensors.
"""

import ast
import dataclasses
import re
import sys
import time
from pathlib import Path
from queue import Queue

import numpy as np
import pytest
import torch

from uav_airvision_tpu import config as jconfig
from uav_airvision_tpu.evaluation import metrics as jmetrics
from uav_airvision_tpu.simulation.world import StereoWorld as JStereoWorld
from uav_airvision_tpu.streaming import dataset as jdataset
from uav_airvision_tpu.streaming import publisher as jpublisher
from uav_airvision_tpu.streaming.prebatch import prebatch_imu as j_prebatch_imu
from uav_airvision_tpu.utils import trajectory as jtrajectory
from uav_airvision_tpu.utils import transforms as jtransforms
from uav_airvision_tpu_torch import config as tconfig
from uav_airvision_tpu_torch import device, kernels
from uav_airvision_tpu_torch.evaluation import metrics as tmetrics
from uav_airvision_tpu_torch.models import vio
from uav_airvision_tpu_torch.models.msckf import propagation as tprop
from uav_airvision_tpu_torch.models.msckf import triangulation as ttri
from uav_airvision_tpu_torch.models.msckf import update as tupd
from uav_airvision_tpu_torch.ops import camera as tcam
from uav_airvision_tpu_torch.ops import extract as textract
from uav_airvision_tpu_torch.ops import gridops as tgrid
from uav_airvision_tpu_torch.ops import lk as tlk
from uav_airvision_tpu_torch.ops import pyramid as tpyr
from uav_airvision_tpu_torch.simulation import euroc_writer as twriter
from uav_airvision_tpu_torch.simulation.world import StereoWorld as TStereoWorld
from uav_airvision_tpu_torch.streaming import dataset as tdataset
from uav_airvision_tpu_torch.streaming import publisher as tpublisher
from uav_airvision_tpu_torch.streaming.prebatch import prebatch_imu as t_prebatch_imu
from uav_airvision_tpu_torch.utils import trajectory as ttrajectory
from uav_airvision_tpu_torch.utils import transforms as ttransforms
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted((ROOT / "uav_airvision_tpu_torch").rglob("*.py"))
                         + [ROOT / "chip_smoke.py"], ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    """No module of the port, and not chip_smoke.py, imports jax or the JAX
    package (uav_airvision_tpu), not even a JAX-free module of it."""
    for name in _imported_modules(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "uav_airvision_tpu"), f"{path.name} imports {name}"


OPTIONAL = ("cv2", "PIL", "matplotlib", "PyQt5", "pyqtgraph")


def _import_time_imports(path: Path):
    """Modules a file imports when it is imported: its module-level
    statements and the bodies of its classes, not its functions'."""
    def walk(nodes):
        for node in nodes:
            if isinstance(node, ast.Import):
                yield from (a.name for a in node.names)
            elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                yield node.module
            elif not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                yield from walk(ast.iter_child_nodes(node))

    yield from walk(ast.parse(path.read_text(), filename=str(path)).body)


@pytest.mark.parametrize("path", sorted((ROOT / "uav_airvision_tpu_torch").rglob("*.py"))
                         + [ROOT / "chip_smoke.py"], ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_optional_package_at_import(path):
    """The card's machine has no OpenCV, PIL, matplotlib or PyQt5: no module
    of the port, and not chip_smoke.py, imports one when it is imported (the
    viewer and the plots import theirs inside the functions that use them)."""
    for name in _import_time_imports(path):
        assert name.split(".")[0] not in OPTIONAL, f"{path.name} imports {name} at import"


def _relative_imports(path: Path):
    """(line, dotted module) of every relative import of a module, resolved
    against its package, and for ``from . import x`` each name x."""
    pkg = path.relative_to(ROOT).with_suffix("").parts[:-1]
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.ImportFrom) and node.level > 0:
            base = pkg[:len(pkg) - (node.level - 1)]
            if node.module:
                yield node.lineno, (*base, *node.module.split(".")), ()
            else:
                yield node.lineno, base, tuple(a.name for a in node.names)


@pytest.mark.parametrize("path", sorted((ROOT / "uav_airvision_tpu_torch").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_relative_imports_resolve(path):
    """Every relative import of a port module names a module the port has
    (a bare ``except`` once hid an import of a module the port lacks), and
    ``from . import x`` a submodule or a name of the package's __init__."""
    for line, parts, names in _relative_imports(path):
        target = ROOT.joinpath(*parts)
        module = target.with_suffix(".py")
        assert module.is_file() or (target / "__init__.py").is_file(), (
            f"{path.name}:{line} imports {'.'.join(parts)}, which the port does not have")
        for name in names:
            init = (target / "__init__.py")
            defined = name in {n.id for n in ast.walk(ast.parse(init.read_text()))
                               if isinstance(n, ast.Name)} if init.is_file() else False
            assert ((target / f"{name}.py").is_file() or (target / name / "__init__.py").is_file()
                    or defined), f"{path.name}:{line} imports {name} from {'.'.join(parts)}"


@pytest.mark.parametrize("make", [lambda m: m.euroc_config(),
                                  lambda m: m.long_horizon_config(),
                                  lambda m: m.euroc_config(dtype="float64")],
                         ids=["euroc", "long_horizon", "euroc_f64"])
def test_config_copy_equals_jax(make):
    got, want = make(tconfig), make(jconfig)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.capacity.state_dim == want.capacity.state_dim
    assert tconfig.Config.from_json(want.to_json()) == got


def test_world_and_prebatch_copies_equal_jax():
    """The port's StereoWorld renders the same bytes from the same seed, and
    gives the same IMU stream, ground truth and prebatched frames."""
    tw, jw = TStereoWorld(tconfig.euroc_config()), JStereoWorld(jconfig.euroc_config())
    dur = 3 / 20.0
    t_imu, j_imu = tw.imu_stream(dur), jw.imu_stream(dur)
    for a, b in zip(t_imu, j_imu):
        np.testing.assert_array_equal(a, b)
    fts = tw.frame_times(dur)
    np.testing.assert_array_equal(fts, jw.frame_times(dur))
    np.testing.assert_array_equal(tw.groundtruth(fts), jw.groundtruth(fts))
    trng, jrng = np.random.default_rng(5), np.random.default_rng(5)
    for t in fts:
        for a, b in zip(tw.render_frame(t, trng), jw.render_frame(t, jrng)):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    cap = tconfig.euroc_config().capacity
    tpb = t_prebatch_imu(fts, *t_imu, cap.max_imu_per_frame, cap.imu_init_msgs)
    jpb = j_prebatch_imu(fts, *j_imu, cap.max_imu_per_frame, cap.imu_init_msgs)
    for field in dataclasses.fields(jpb):
        np.testing.assert_array_equal(np.asarray(getattr(tpb, field.name)),
                                      np.asarray(getattr(jpb, field.name)), err_msg=field.name)


def test_metrics_and_trajectory_copies_equal_jax(tmp_path):
    rng = np.random.default_rng(3)
    gt_t = np.arange(0.0, 5.0, 0.05)
    gt_p = np.cumsum(rng.normal(0, 0.02, (len(gt_t), 3)), 0)
    est_t = gt_t[::2] + 0.001
    est_p = gt_p[::2] + rng.normal(0, 0.01, (len(est_t), 3))
    for fn in ("ate", "rte"):
        assert getattr(tmetrics, fn)(est_t, est_p, gt_t, gt_p) == \
            getattr(jmetrics, fn)(est_t, est_p, gt_t, gt_p)
    q = rng.normal(0, 1, (len(est_t), 4))
    act = rng.uniform(size=len(est_t)) < 0.9
    paths = []
    for mod, name in ((ttrajectory, "port"), (jtrajectory, "jax")):
        w = mod.TrajectoryWriter(path=str(tmp_path / f"{name}.txt"))
        w.write_batch(est_t, est_p, q / np.linalg.norm(q, axis=1, keepdims=True), act)
        paths.append(Path(w.path))
    assert paths[0].read_bytes() == paths[1].read_bytes()


def test_transforms_copy_equals_jax():
    rng = np.random.default_rng(4)

    def iso(mod):
        q, _ = np.linalg.qr(rng.normal(size=(2, 3, 3)))
        return q, rng.normal(size=(2, 3))

    (Ra, ta), (Rb, tb) = iso(None), iso(None)
    pts = rng.normal(size=(2, 3))
    for fn, args in (("inverse", ((Ra, ta),)), ("compose", ((Ra, ta), (Rb, tb))),
                     ("matrix", ((Ra, ta),))):
        got = getattr(ttransforms, fn)(*(ttransforms.Isometry(*a) for a in args))
        want = getattr(jtransforms, fn)(*(jtransforms.Isometry(*a) for a in args))
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=0, atol=1e-15)
    np.testing.assert_allclose(
        ttransforms.apply(ttransforms.Isometry(Ra, ta), pts).numpy(),
        np.asarray(jtransforms.apply(jtransforms.Isometry(Ra, ta), pts)), rtol=0, atol=1e-15)
    eye_t, eye_j = ttransforms.identity(batch_shape=(2,)), jtransforms.identity(batch_shape=(2,))
    np.testing.assert_array_equal(np.asarray(eye_t.R), np.asarray(eye_j.R))
    m = ttransforms.matrix(ttransforms.Isometry(Ra, ta))
    back = ttransforms.from_matrix(m)
    np.testing.assert_array_equal(np.asarray(back.R), Ra)
    assert ttransforms.Isometry._fields == jtransforms.Isometry._fields


def _fake_euroc(root: Path):
    """A EuRoC directory tree with 12 IMU rows, 4 stereo pairs (empty .png
    files: nothing is decoded) and 5 ground-truth rows."""
    t0 = 1_403_715_273_262_142_976
    for cam in ("cam0", "cam1"):
        (root / "mav0" / cam / "data").mkdir(parents=True)
        for k in range(4):
            (root / "mav0" / cam / "data" / f"{t0 + 50_000_000 * (k + 1)}.png").touch()
    rng = np.random.default_rng(2)
    (root / "mav0" / "imu0").mkdir()
    rows = np.column_stack([t0 + 5_000_000 * np.arange(12) + 20_000_000, rng.normal(size=(12, 6))])
    np.savetxt(root / "mav0" / "imu0" / "data.csv", rows, delimiter=",", header="t,w,a",
               fmt=["%d"] + ["%.9f"] * 6)
    (root / "mav0" / "state_groundtruth_estimate0").mkdir()
    gt = np.column_stack([t0 + 50_000_000 * np.arange(5), rng.normal(size=(5, 16))])
    np.savetxt(root / "mav0" / "state_groundtruth_estimate0" / "data.csv", gt, delimiter=",",
               header="t", fmt=["%d"] + ["%.9f"] * 16)


def test_dataset_copy_equals_jax(tmp_path, monkeypatch):
    """The port's EuRoC readers give the same messages, start times and
    offsets as the JAX package's on the same directory; the image reader
    decodes with the port's loader, without OpenCV, and raises on a file it
    cannot decode, naming it."""
    _fake_euroc(tmp_path)
    for name in ("imu_msg", "img_msg", "stereo_msg", "gt_msg"):
        assert getattr(tdataset, name)._fields == getattr(jdataset, name)._fields
    monkeypatch.setattr(tdataset.ImageReader, "read", lambda self, path: path)
    monkeypatch.setattr(jdataset.ImageReader, "read", lambda self, path: path)
    got, want = tdataset.EuRoCDataset(str(tmp_path)), jdataset.EuRoCDataset(str(tmp_path))
    for offset in (0.0, 0.01):
        got.set_starttime(offset)
        want.set_starttime(offset)
        assert got.starttime == want.starttime and got.stereo.starttime == want.stereo.starttime
        for a, b in zip(got.imu.arrays(), want.imu.arrays()):
            np.testing.assert_array_equal(a, b)
        assert [tuple(m[:3]) for m in got.stereo] == [tuple(m[:3]) for m in want.stereo]
        assert len(list(got.imu)) == len(list(want.imu)) > 0
        for key, val in got.groundtruth.load().items():
            np.testing.assert_array_equal(val, want.groundtruth.load()[key])
    monkeypatch.undo()
    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 raises
    empty = str(got.cam0.paths[0])
    with pytest.raises(IOError, match=re.escape(empty)):
        tdataset.ImageReader([empty], [0.0]).read(empty)
    img = np.random.default_rng(3).integers(0, 256, (6, 5), dtype=np.uint8)
    twriter.imwrite(str(tmp_path / "img.png"), img)
    reader = tdataset.ImageReader([str(tmp_path / "img.png")], [0.0])
    np.testing.assert_array_equal(next(iter(reader)).image, img)


@pytest.mark.parametrize("duration", [float("inf"), 0.1])
def test_publisher_copy_equals_jax(duration):
    """Both DataPublishers replay the same stream into the same queue
    contents (messages before the start dropped, the duration cut, the
    ``None`` sentinel), no earlier than each message's deadline."""
    msgs = [tdataset.imu_msg(t, None, None) for t in (-0.01, 0.0, 0.05, 0.1, 0.15, 0.2)]
    assert tpublisher._PACING_SLACK_S == jpublisher._PACING_SLACK_S
    seen = []
    for mod in (tpublisher, jpublisher):
        q = Queue()

        class Stream:
            starttime = 0.0

            def __iter__(self):
                return iter(msgs)

        pub = mod.DataPublisher(Stream(), q, duration=duration, ratio=5.0)
        t0 = time.time()
        pub.start(t0)
        out = []
        while True:
            m = q.get(timeout=5)
            out.append((m, time.time() - t0))
            if m is None:
                break
        pub.publish_thread.join(timeout=5)
        assert not pub.publish_thread.is_alive()
        for m, dt in out[:-1]:
            assert dt >= m.timestamp / 5.0
        seen.append([m for m, _ in out])
    assert seen[0] == seen[1]
    assert len(seen[0]) == (6 if duration == float("inf") else 4)


def test_entry_points_default_to_cuda(monkeypatch):
    """get_device() means the card; without CUDA it raises instead of falling
    back to the CPU, and so do init_vio_state, the CLI, the fleet's entry
    points and fleet_bench by default."""
    import inspect

    from uav_airvision_tpu_torch import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        device.get_device()
    assert device.get_device("cpu") == CPU
    with pytest.raises(RuntimeError, match="CUDA"):
        vio.init_vio_state(tconfig.euroc_config())
    assert vio.init_vio_state(tconfig.euroc_config(), device="cpu").filter.cov.device == CPU
    with pytest.raises(RuntimeError, match="CUDA"):
        main.main(["--synthetic", "0.1"])
    with pytest.raises(RuntimeError, match="CUDA"):  # the EuRoC path, before any file is read
        main.main(["--path", "no_such_sequence", "--offset", "0"])
    from uav_airvision_tpu_torch import sweep

    with pytest.raises(RuntimeError, match="CUDA"):
        sweep.main(["--root", "no_such_root"])
    assert inspect.signature(device.get_device).parameters["name"].default == "cuda"
    # the streaming orchestrator and the CLI's realtime mode too
    from uav_airvision_tpu_torch.vio import VIO

    with pytest.raises(RuntimeError, match="CUDA"):
        VIO(tconfig.euroc_config(), Queue(), Queue())
    assert inspect.signature(VIO.__init__).parameters["device"].default == "cuda"
    assert VIO(tconfig.euroc_config(), Queue(), Queue(), device="cpu").device == CPU
    with pytest.raises(RuntimeError, match="CUDA"):
        main.main(["--mode", "realtime", "--synthetic", "0.1"])
    # the fleet's entry points and its benchmark
    from uav_airvision_tpu_torch import fleet_bench
    from uav_airvision_tpu_torch.parallel import fleet

    for call in (lambda: fleet.init_fleet_state(tconfig.euroc_config(), np.zeros(3),
                                                [0.0, 0.0, 9.8], 2),
                 lambda: fleet.make_fleet_step(tconfig.euroc_config()),
                 lambda: fleet_bench.main(["1"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    for fn in (fleet.init_fleet_state, fleet.make_fleet_step):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert fleet.init_fleet_state(tconfig.euroc_config(), np.zeros(3), [0.0, 0.0, 9.8], 2,
                                  device="cpu").filter.cov.device == CPU


@pytest.fixture(scope="module")
def filter_state():
    """A float64 filter state of the oracle scenario after 41 frames (a
    19-camera window) from the port's own back-end and Config."""
    from test_torch_cuda import _host_state

    cfg, state, params = _host_state("float64")
    t = state.features
    sel = torch.nonzero(t.valid & (t.obs_mask.sum(1) >= 3))[:, 0][:16]
    assert len(sel) >= 4
    return cfg, state, params, sel


def _launch_counts():
    fns = (ttri.triangulate, ttri.triangulate_rows, tupd.feature_block, tupd.feature_block_rows, tupd.gating_test_batch, tupd.rank12_update,
           tupd.apply_update_rank12, tupd.apply_update_rank12_rows, tupd.ekf_update, tupd.apply_update, tgrid.dense_grid_topk,
           *tgrid.K8_WRAPPERS, tgrid.select_track,
           *tcam.WRAPPERS, tcam.predict_warp_points, tcam.stereo_gate, textract.extract_windows, tlk.pyramidal_lk_level, tlk.pyramidal_lk,
           tlk.pyramidal_lk_compact,
           tpyr.build_pyramid_pair, tpyr.build_pyramid_padded, tprop.propagate)
    return tuple(fn.launches for fn in fns)


def _assert_identical(got, want):
    if isinstance(got, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_identical(g, w)
    else:
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got, want) or bool((got.isnan() == want.isnan()).all()
                                              and torch.equal(got.nan_to_num(), want.nan_to_num()))


@pytest.mark.parametrize("kernel", ["K13", "K13_rows", "K13_rows_motion", "K9", "K9_prune", "K9_rows",
                                    "K9_rows_prune", "K10", "K12", "K11", "K5", "K8", "K7", "P1",
                                    "K1_level", "K1_compact", "K2", "K14", "K1"])
def test_wrappers_run_plain_on_cpu(filter_state, kernel, monkeypatch):
    """On CPU tensors each kernel's public wrapper returns exactly what its
    plain version returns, counts no launch and reports no call to the
    kernels' observer."""
    observed = []
    monkeypatch.setattr(kernels, "observer", lambda name, args: observed.append(name))
    cfg, state, params, sel = filter_state
    c, t = state.cams, state.features
    n0 = _launch_counts()
    if kernel == "K13":
        active = torch.arange(len(sel)) % 5 != 1
        args = (c.q, c.p, t.obs[sel], t.obs_mask[sel], params.R_cam0_cam1, params.t_cam0_cam1,
                cfg.triangulation, active)
        _assert_identical(ttri.triangulate(*args), ttri.triangulate_plain(*args))
    elif kernel.startswith("K13_rows"):
        tri = cfg.triangulation
        if kernel == "K13_rows_motion":
            tri = dataclasses.replace(tri, translation_threshold=0.05)
        ok = torch.arange(len(sel)) % 5 != 1
        initialized = t.initialized.clone()
        initialized[sel[::3]] = True
        args = (c.q, c.p, t.obs, t.obs_mask, t.position, initialized, sel, ok,
                params.R_cam0_cam1, params.t_cam0_cam1, tri)
        _assert_identical(ttri.triangulate_rows(*args), ttri.triangulate_rows_plain(*args))
    elif kernel.startswith("K9_rows"):
        rm = torch.tensor([3, 7]) if kernel == "K9_rows_prune" else None
        proc = torch.arange(len(sel)) % 4 != 1
        args = (c.q, c.p, c.q_null, c.p_null, t.obs, t.obs_mask, t.position, sel, proc,
                state.gravity, params.R_cam0_cam1, params.t_cam0_cam1, cfg.capacity.state_dim)
        _assert_identical(tupd.feature_block_rows(*args, rm=rm),
                          tupd.feature_block_rows_plain(*args, rm=rm))
    elif kernel.startswith("K9"):
        rm = torch.tensor([3, 7]) if kernel == "K9_prune" else torch.arange(c.q.shape[0])
        args = (c.q[rm], c.p[rm], c.q_null[rm], c.p_null[rm], t.obs[sel][:, rm],
                t.obs_mask[sel][:, rm], t.position[sel], state.gravity, params.R_cam0_cam1,
                params.t_cam0_cam1, cfg.capacity.state_dim)
        _assert_identical(tupd.feature_block(*args), tupd.feature_block_plain(*args))
    elif kernel == "K10":
        H, r, rows = tupd.feature_block_plain(
            c.q, c.p, c.q_null, c.p_null, t.obs[sel], t.obs_mask[sel], t.position[sel],
            state.gravity, params.R_cam0_cam1, params.t_cam0_cam1, cfg.capacity.state_dim)
        dof = t.obs_mask[sel].sum(1).to(torch.int32) - 1
        for scale in (1e-3, 10.0, 1e3):
            # the 77-row gate on both tiers, and the R <= 32 gate on row prefixes
            for rows_true in (rows, torch.full_like(rows, H.shape[1])):
                gate = (H, r * scale, rows_true, state.cov, params.obs_noise, params.chi2_table,
                        dof)
                _assert_identical(tupd.gating_test_batch(*gate),
                                  tupd.gating_test_batch_plain(*gate))
            for m in (5, 32):
                gate = (H[:, :m], r[:, :m] * scale, rows, state.cov, params.obs_noise,
                        params.chi2_table, dof)
                _assert_identical(tupd.gating_test_batch(*gate),
                                  tupd.gating_test_batch_plain(*gate))
    elif kernel == "K11":
        rng = np.random.default_rng(11)
        D = state.cov.shape[0]
        for n_rows in (60, 200, 700):
            H = torch.zeros((1680, D), dtype=torch.float64)
            H[:n_rows, 21:] = torch.as_tensor(rng.normal(0, 0.05, (n_rows, D - 21)))
            r = torch.zeros(1680, dtype=torch.float64)
            r[:n_rows] = torch.as_tensor(rng.normal(0, 0.01, n_rows))
            args = (state.cov, H, r, params.obs_noise, n_rows)
            _assert_identical(tupd.ekf_update(*args), tupd.ekf_update_plain(*args))
            got, warn = tupd.apply_update(state, params, H, r, n_rows)
            want, pwarn = tupd.apply_update_plain(state, params, H, r, n_rows)
            _assert_identical(tuple(torch.utils._pytree.tree_leaves(got)) + (warn,),
                              tuple(torch.utils._pytree.tree_leaves(want)) + (pwarn,))
    elif kernel == "K5":
        score = torch.as_tensor(np.random.default_rng(5).integers(-1, 4, (97, 131)), dtype=torch.int32)
        _assert_identical(tgrid.dense_grid_topk(score, 4, 5, 5),
                          tgrid.dense_grid_topk_plain(score, 4, 5, 5))
    elif kernel == "K8":
        rng = np.random.default_rng(8)
        n = 100
        cell = torch.as_tensor(rng.integers(0, 20, n), dtype=torch.int32)
        pri = torch.as_tensor(rng.integers(0, 3, n), dtype=torch.float32)
        arr = torch.as_tensor(rng.integers(0, 9, n), dtype=torch.int32)
        valid = torch.as_tensor(rng.uniform(size=n) < 0.7)
        rank, perm = tgrid.rank_in_cell(cell, pri, arr, valid, 20)
        _assert_identical((rank, perm), tgrid.rank_in_cell_plain(cell, pri, arr, valid, 20))
        keep = valid & (rank < 2)
        _assert_identical(tgrid.kept_order_stats(perm, keep, cell, valid, 20),
                          tgrid.kept_order_stats_plain(perm, keep, cell, valid, 20))
        _assert_identical(tgrid.compact_kept(perm, keep, 104),
                          tgrid.compact_kept_plain(perm, keep, 104))
        _assert_identical(tgrid.smallest_k_indices(arr, 16), tgrid.smallest_k_indices_plain(arr, 16))
        _assert_identical(tgrid.stable_compact_indices(valid, n),
                          tgrid.stable_compact_indices_plain(valid, n))
        from torch_select_inputs import select_inputs

        arrays, statics = select_inputs(8, 104, 100, "ties")
        args = (*map(torch.as_tensor, arrays), *statics)
        _assert_identical(tgrid.select_track(*args), tgrid.select_track_plain(*args))
    elif kernel == "K14":
        I = cfg.capacity.max_imu_per_frame
        rng = np.random.default_rng(14)
        t0 = float(state.imu.timestamp)
        for n in (0, 11):
            imu_t = torch.where(torch.arange(I) < n, t0 + 0.005 * torch.arange(1, I + 1), 0.0)
            w = torch.as_tensor(rng.normal(0, 0.3, (I, 3)))
            a = torch.as_tensor(rng.normal([0, 0, 9.81], 0.5, (I, 3)))
            args = (state, params, imu_t.double(), w, a, torch.arange(I) < n)
            _assert_identical(tuple(torch.utils._pytree.tree_leaves(tprop.propagate(*args))),
                              tuple(torch.utils._pytree.tree_leaves(tprop.propagate_plain(*args))))
    elif kernel == "K1":
        rng = np.random.default_rng(1)
        img0, img1 = (torch.as_tensor(rng.integers(0, 256, (120, 160)), dtype=torch.uint8)
                      for _ in range(2))
        p0, p1 = tpyr.build_pyramid_padded(img0, 3), tpyr.build_pyramid_padded(img1, 3)
        pts = torch.as_tensor(rng.uniform([5, 5], [155, 115], (30, 2)), dtype=torch.float32)
        valid = torch.as_tensor(rng.uniform(size=30) < 0.9)
        for kw in (dict(n_levels=2, max_iter_upper=5), dict(n_levels=1)):
            _assert_identical(tlk.pyramidal_lk(p0, p1, pts, pts + 1.5, valid, max_iter=10, **kw),
                              tlk.pyramidal_lk_plain(p0, p1, pts, pts + 1.5, valid, max_iter=10,
                                                     **kw))
    elif kernel == "K1_compact":
        rng = np.random.default_rng(1)
        img0, img1 = (torch.as_tensor(rng.integers(0, 256, (120, 160)), dtype=torch.uint8)
                      for _ in range(2))
        p0, p1 = tpyr.build_pyramid_padded(img0, 3), tpyr.build_pyramid_padded(img1, 3)
        pts = torch.as_tensor(rng.uniform([5, 5], [155, 115], (30, 2)), dtype=torch.float32)
        valid = torch.as_tensor(rng.uniform(size=30) < 0.9)
        for kw in (dict(n_levels=2, max_iter_upper=5), dict(n_levels=1)):
            des = torch.zeros((30, kw["n_levels"], 2), dtype=torch.int32)
            got = tlk.pyramidal_lk_compact(p0, p1, pts, pts + 1.5, valid, max_iter=10, des=des,
                                           **kw)
            want = tlk.pyramidal_lk_compact_levels(p0, p1, pts, pts + 1.5, valid, max_iter=10,
                                                   **kw)
            _assert_identical(got + (des,), want)
            _assert_identical(got, tlk.pyramidal_lk_plain(p0, p1, pts, pts + 1.5, valid,
                                                          max_iter=10, compact_windows=True,
                                                          **kw))
    elif kernel in ("P1", "K1_level"):
        img = torch.as_tensor(np.random.default_rng(1).integers(0, 256, (120, 160)),
                              dtype=torch.uint8)
        pyr = tpyr.build_pyramid_padded(img, 3)
        pts = torch.as_tensor(np.random.default_rng(2).uniform([5, 5], [155, 115], (30, 2)),
                              dtype=torch.float32)
        des = tlk.compact_origin(pts, pyr.levels[1], 1)
        args = (pyr.levels[1], des[:, 0], des[:, 1], 32)
        win = textract.extract_windows(*args)
        _assert_identical(win, textract.extract_windows_plain(*args))
        if kernel == "K1_level":
            for L in (1, 0):
                largs = (pyr, pts, pts, torch.ones(30, dtype=torch.bool), win, des, L)
                got = [x for x in tlk.pyramidal_lk_level(*largs) if x is not None]
                _assert_identical(tuple(got), tuple(x for x in tlk.pyramidal_lk_level_plain(*largs)
                                                    if x is not None))
                des = tlk.compact_origin(pts, pyr.levels[0], 0)
                win = textract.extract_windows(pyr.levels[0], des[:, 0], des[:, 1], 32)
    elif kernel == "K2":
        rng = np.random.default_rng(2)
        img0, img1 = (torch.as_tensor(rng.integers(0, 256, (95, 131)), dtype=torch.uint8)
                      for _ in range(2))
        for got, want in zip(tpyr.build_pyramid_pair(img0, img1, 3),
                             tpyr.build_pyramid_pair_plain(img0, img1, 3)):
            _assert_identical(tuple(got.levels), tuple(want.levels))
        _assert_identical(tuple(tpyr.build_pyramid_padded(img1, 3).levels),
                          tuple(tpyr.build_pyramid_padded_plain(img1, 3).levels))
    elif kernel == "K7":
        rng = np.random.default_rng(7)
        pts = torch.as_tensor(rng.uniform([5, 5], [747, 475], (50, 2)), dtype=torch.float32)
        intr = torch.tensor([458.654, 457.296, 367.215, 248.375])
        co = torch.tensor([-0.2834, 0.0739, 0.00019, 1.76e-05])
        R = torch.as_tensor(np.linalg.qr(np.eye(3) + 0.01 * rng.normal(size=(3, 3)))[0],
                            dtype=torch.float32)
        for model in ("radtan", "equidistant"):
            _assert_identical(tcam.undistort_points(pts, intr, model, co, R),
                              tcam.undistort_points_plain(pts, intr, model, co, R))
            _assert_identical(tcam.distort_points(pts / 500, intr, model, co),
                              tcam.distort_points_plain(pts / 500, intr, model, co))
            und, dis = tcam.undistort_distort_points(pts, intr, model, co, R)
            _assert_identical(und, tcam.undistort_points_plain(pts, intr, model, co, R))
            _assert_identical(dis, tcam.distort_points_plain(und, intr, model, co))
        _assert_identical(tcam.homography_warp_points(pts, R, intr),
                          tcam.homography_warp_points_plain(pts, R, intr))
        w, dt = torch.tensor([0.3, -0.2, 0.1]), torch.tensor(0.05)
        _assert_identical(tcam.predict_warp_points(pts, w, dt, R, intr),
                          tcam.predict_warp_points_plain(pts, w, dt, R, intr))
        p0r = pts + torch.as_tensor(rng.normal(0, 2, (50, 2)), dtype=torch.float32)
        p1 = pts - torch.as_tensor(rng.uniform(0, 40, (50, 2)), dtype=torch.float32)
        flags = torch.as_tensor(rng.uniform(size=(2, 50)) < 0.9)
        gate = (pts, p1, p0r, p1, flags[0], flags[1], intr, "radtan", co, R, 3.0, 20.0, 5.0, 480,
                752)
        _assert_identical(tcam.stereo_gate(*gate), tcam.stereo_gate_plain(*gate))
    else:
        rng = np.random.default_rng(12)
        cols = torch.cat([21 + 6 * 4 + torch.arange(6), 21 + 6 * 9 + torch.arange(6)])
        B = torch.as_tensor(rng.normal(0, 0.8, (60, 12)))
        r = torch.as_tensor(rng.normal(0, 0.02, 60))
        _assert_identical(tupd.rank12_update(state.cov, B, r, cols, params.obs_noise),
                          tupd.rank12_update_plain(state.cov, B, r, cols, params.obs_noise))
        got, warn = tupd.apply_update_rank12(state, params, B, r, cols)
        want, pwarn = tupd.apply_update_rank12_plain(state, params, B, r, cols)
        _assert_identical(tuple(torch.utils._pytree.tree_leaves(got)) + (warn,),
                          tuple(torch.utils._pytree.tree_leaves(want)) + (pwarn,))
        H12 = torch.as_tensor(rng.normal(0, 0.8, (12, 5, 33)))[:, :, 21:]
        r_blk = torch.as_tensor(rng.normal(0, 0.02, (12, 5)))
        include = torch.as_tensor(rng.uniform(size=12) < 0.5)
        got, warn = tupd.apply_update_rank12_rows(state, params, H12, r_blk, include, cols)
        want, pwarn = tupd.apply_update_rank12_rows_plain(state, params, H12, r_blk, include,
                                                          cols)
        _assert_identical(tuple(torch.utils._pytree.tree_leaves(got)) + (warn,),
                          tuple(torch.utils._pytree.tree_leaves(want)) + (pwarn,))
    assert _launch_counts() == n0 and not observed


def test_wrappers_raise_on_other_devices(filter_state):
    """A tensor on neither the CPU nor a CUDA device is refused."""
    cfg, state, params, sel = filter_state
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="K13"):
        ttri.triangulate(*(x.to(meta) for x in (state.cams.q, state.cams.p, state.features.obs,
                                                state.features.obs_mask, params.R_cam0_cam1,
                                                params.t_cam0_cam1)), cfg.triangulation)
    H = torch.zeros((2, 77, 141), device=meta)
    idx = torch.zeros(2, dtype=torch.int32, device=meta)
    with pytest.raises(ValueError, match="K10"):
        tupd.gating_test_batch(H, torch.zeros((2, 77), device=meta), idx, state.cov.to(meta),
                               params.obs_noise.to(meta), params.chi2_table.to(meta), idx)
    with pytest.raises(ValueError, match="K2"):
        tpyr.build_pyramid_pair(*(torch.zeros((40, 50), dtype=torch.uint8, device=meta)
                                  for _ in range(2)), 3)
    with pytest.raises(ValueError, match="K11"):
        tupd.ekf_update(state.cov.to(meta), H[0], H[0, :, 0], params.obs_noise.to(meta), 5)
    with pytest.raises(ValueError, match="K12"):
        tupd.apply_update_rank12_rows(state._replace(cov=state.cov.to(meta)), params,
                                      torch.zeros((4, 5, 12), device=meta),
                                      torch.zeros((4, 5), device=meta),
                                      torch.ones(4, dtype=torch.bool, device=meta), idx)
    with pytest.raises(ValueError, match="K5"):
        tgrid.dense_grid_topk(torch.zeros((40, 50), dtype=torch.int32, device=meta), 4, 5, 5)
    with pytest.raises(ValueError, match="K8"):
        tgrid.stable_compact_indices(torch.zeros(8, dtype=torch.bool, device=meta), 8)
    with pytest.raises(ValueError, match="K7"):
        tcam.homography_warp_points(torch.zeros((4, 2), device=meta), torch.eye(3, device=meta),
                                    torch.ones(4, device=meta))
    origins = torch.zeros(4, dtype=torch.int32, device=meta)
    with pytest.raises(ValueError, match="P1"):
        textract.extract_windows(torch.zeros((40, 50), device=meta), origins, origins, 32)
    with pytest.raises(ValueError, match="K13"):
        t = state.features
        ttri.triangulate_rows(*(x.to(meta) for x in (state.cams.q, state.cams.p, t.obs,
                                                     t.obs_mask, t.position, t.initialized, sel,
                                                     torch.ones_like(sel, dtype=torch.bool),
                                                     params.R_cam0_cam1, params.t_cam0_cam1)),
                              cfg.triangulation)
    pyr = tpyr.build_pyramid_padded(torch.zeros((40, 50), dtype=torch.uint8), 1)
    with pytest.raises(ValueError, match="K1"):
        tlk.pyramidal_lk_compact(pyr, pyr, torch.zeros((4, 2), device=meta),
                                 torch.zeros((4, 2), device=meta), origins.bool())
    with pytest.raises(ValueError, match="K1"):
        tlk.pyramidal_lk_level(None, torch.zeros((4, 2), device=meta), torch.zeros((4, 2), device=meta),
                               origins.bool(), torch.zeros((4, 32, 32), device=meta),
                               torch.zeros((4, 2), dtype=torch.int32, device=meta), 0)


def test_gate_makes_no_host_read(filter_state):
    """The 77-row gate with a block in the bounds' undecided band (so the
    exact test decides) reads nothing back to the host: the JAX function
    decides in one lax.cond tree, and so does the port, on the device."""
    cfg, state, params, sel = filter_state
    c, t = state.cams, state.features
    H, r, rows = tupd.feature_block_plain(
        c.q, c.p, c.q_null, c.p_null, t.obs[sel], t.obs_mask[sel], t.position[sel],
        state.gravity, params.R_cam0_cam1, params.t_cam0_cam1, cfg.capacity.state_dim)
    dof = t.obs_mask[sel].sum(1).to(torch.int32) - 1
    thresh = params.chi2_table[dof.long()]
    # every block's r'r at the geometric middle of its undecided band
    s2 = params.obs_noise
    tr = ((H @ state.cov) * H).sum((1, 2))
    r = r * torch.sqrt(thresh * torch.sqrt(s2 * (s2 + tr)) / (r * r).sum(-1))[:, None]
    pass_sure, fail_sure = tupd.gate_bounds_plain(H, r, state.cov, s2, thresh)
    assert H.shape[1] == 77 and not bool((pass_sure | fail_sure).any())
    before = device.host_syncs["sync"]
    got = tupd.gating_test_batch(H, r, rows, state.cov, s2, params.chi2_table, dof)
    assert device.host_syncs["sync"] == before
    want = tupd.gate_gamma_plain(H, r, state.cov, s2) < thresh
    if int(rows.max()) <= tupd.GATE_TIER:
        want = tupd.gate_gamma_plain(H[:, :32], r[:, :32], state.cov, s2) < thresh
    assert torch.equal(got, want)
