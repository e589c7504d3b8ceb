"""The fleet's batched back-end on the CPU (``models/msckf/step.py::
backend_step_fleet``).

(a) the batched plain versions of K14, K13, K9 and K10 against their single
plain versions, instance by instance, bit for bit; (b) the fleet step with
the lost-feature pass, and then the camera prune, triggered on none, one,
some or all of its four instances: each instance's outputs and state equal
its own ``backend_step``'s, bit for bit; (c) widened tiers: an instance with
more than 16 lost candidates (and an overflow pass) beside instances with
fewer, a prune of more than 32 two-view features beside one of fewer, each
instance still its own step; (d) host reads per step at B = 1 and B = 4.

Inputs: the oracle's synthetic scenario (tests/oracle/synthetic.py) through
the back-end alone, at a 10-camera window, in two streams (300 and 60
landmarks); an instance is a stream's state at some frame with that frame's
features as they are, all observed again ("seen": no lost candidate) or
none ("empty": every feature of three or more observations lost).
"""

import dataclasses

import numpy as np
import pytest
import torch

from tests.oracle.synthetic import make_scenario, window_imu
from uav_airvision_tpu_torch import device
from uav_airvision_tpu_torch.config import euroc_config
from uav_airvision_tpu_torch.models.msckf import propagation, step, triangulation, update
from uav_airvision_tpu_torch.models.msckf.state import INT32_MAX, init_state, make_params
from uav_airvision_tpu_torch.ops.gridops import smallest_k_indices
from uav_airvision_tpu_torch.utils import tree
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

CPU = torch.device("cpu")
WINDOW = 10  # camera slots: 37-row blocks, past K10's 32-row tier


def small_config():
    """EuRoC's configuration cut to a 10-camera window and a 128-slot map,
    with two lost tiers (16, 32) and two prune tiers (32, 64)."""
    cfg = euroc_config()
    cap = dataclasses.replace(cfg.capacity, max_features=128, max_map_features=128,
                              max_cam_states=WINDOW, max_lost_per_frame=32, max_prune_feats=64,
                              max_update_rows=1200, max_imu_per_frame=16)
    return dataclasses.replace(cfg, capacity=cap, filter=dataclasses.replace(
        cfg.filter, max_cam_state_size=WINDOW))


CFG = small_config()


def frame_inputs(cfg, sc):
    """The scenario's per-frame back-end inputs (as tests/test_torch_backend.py
    builds them), float32."""
    cap = cfg.capacity
    active = [t >= sc.imu[cap.imu_init_msgs - 1][0] for t, _ in sc.frames]
    windows = window_imu(sc, active)
    I, K = cap.max_imu_per_frame, cap.max_features
    frames = []
    for k, (t, meas) in enumerate(sc.frames):
        imu = np.zeros((I, 7))
        mask = np.zeros(I, bool)
        for j, m in enumerate(windows[k][1][:I]):
            imu[j] = (m[0], *m[1], *m[2])
            mask[j] = True
        ids, uv, fm = np.full(K, -1, np.int32), np.zeros((K, 4)), np.zeros(K, bool)
        for j, (fid, *z) in enumerate(meas[:K]):
            ids[j], uv[j], fm[j] = fid, z, True

        def f32(x):
            return torch.as_tensor(np.asarray(x), dtype=torch.float32)

        frames.append(step.FrameInput(
            timestamp=f32(t), imu_t=f32(imu[:, 0]), imu_w=f32(imu[:, 1:4]), imu_a=f32(imu[:, 4:]),
            imu_mask=torch.as_tensor(mask), feat_ids=torch.as_tensor(ids), feat_uv=f32(uv),
            feat_mask=torch.as_tensor(fm), active=bool(active[k])))
    return frames


def run_stream(n_landmarks, seed):
    """(the states before each frame, the frames) of one stream run through
    ``backend_step``."""
    sc = make_scenario(CFG, duration=3.0, n_landmarks=n_landmarks, seed=seed)
    frames = frame_inputs(CFG, sc)
    params = make_params(CFG, CPU)
    st = init_state(CFG, params, sc.gyro_bias, sc.acc_mean)
    states = []
    for fr in frames:
        states.append(st)
        st, _ = step.backend_step(st, fr, params, CFG)
    return states, frames


@pytest.fixture(scope="module")
def streams():
    return {"dense": run_stream(300, 3), "sparse": run_stream(60, 4)}


@pytest.fixture(scope="module")
def params():
    return make_params(CFG, CPU)


def seen_frame(state, frame):
    """``frame`` with every valid feature of ``state`` observed again (at its
    last observation): no lost candidate."""
    t = state.features
    K = frame.feat_ids.shape[0]
    rows = torch.nonzero(t.valid)[:, 0][:K]
    last = (t.obs_mask.shape[1] - 1) - torch.argmax(t.obs_mask[rows].flip(1).to(torch.int32), 1)
    n = rows.shape[0]
    return frame._replace(
        feat_ids=torch.cat([t.fid[rows], frame.feat_ids.new_full((K - n,), -1)]),
        feat_uv=torch.cat([t.obs[rows, last], frame.feat_uv.new_zeros((K - n, 4))]),
        feat_mask=torch.arange(K) < n)


def empty_frame(frame):
    return frame._replace(feat_ids=torch.full_like(frame.feat_ids, -1),
                          feat_mask=torch.zeros_like(frame.feat_mask))


def instance(streams, name, k, mode="as is"):
    """(state, frame) of stream ``name`` before frame k."""
    states, frames = streams[name]
    st, fr = states[k], frames[k]
    assert fr.active
    if mode == "seen":
        fr = seen_frame(st, fr)
    elif mode == "empty":
        fr = empty_frame(fr)
    return st, fr


def frames_with_count(streams, name, count, n):
    """n frames whose state's window holds ``count`` cameras, from frame 28
    on (the trajectory moves from frame 30; past frame 38 the scenario's
    tracks end with too few observations kept to be marginalized)."""
    states, frames = streams[name]
    ks = [k for k in range(28, 38) if frames[k].active and int(states[k].cams.count) == count]
    assert len(ks) >= n, (name, count, ks)
    return ks[:n]


def stack_frames(frs):
    return step.FrameInput(*(torch.stack(xs) for xs in zip(*(f[:-1] for f in frs))),
                           active=[f.active for f in frs])


def leaves(t, name=""):
    if isinstance(t, tuple) and hasattr(t, "_fields"):
        for n, x in zip(t._fields, t):
            yield from leaves(x, f"{name}.{n}")
    elif isinstance(t, torch.Tensor):
        yield name, t


def assert_instances_are_their_steps(cases, params, calls=None):
    """The fleet step over ``cases`` [(state, frame)] against each
    instance's ``backend_step``: every output field and every state leaf
    bit for bit.  Returns the fleet's outputs."""
    bstate = tree.stack([st for st, _ in cases])
    fst, fout = step.backend_step_fleet(bstate, stack_frames([fr for _, fr in cases]), params, CFG)
    for b, (st, fr) in enumerate(cases):
        want_st, want = step.backend_step(st, fr, params, CFG)
        for name, got, w in zip(want._fields, fout, want):
            assert torch.equal(got[b], w.to(got.dtype)), f"instance {b}: output {name} differs"
        for (name, got), (_, w) in zip(leaves(tree.index(fst, b)), leaves(want_st)):
            assert torch.equal(got, w), f"instance {b}: state{name} differs"
    return fout


class Spy:
    """Records the instances each fleet stage runs on."""

    def __init__(self, monkeypatch):
        self.lost, self.passes, self.prune = [], [], []
        for name, log in (("_remove_lost_fleet", self.lost), ("_prune_fleet", self.prune),
                          ("_remove_lost_once_fleet", self.passes)):
            real = getattr(step, name)

            def spy(st, *args, _real=real, _log=log):
                _log.append((st.cov.shape[0], args[-1]))
                return _real(st, *args)

            monkeypatch.setattr(step, name, spy)


# (a) ------------------------------------------------------------------------

KERNELS = ["K14", "K13", "K9 lost", "K9 prune", "K10 small", "K10 tiered", "K11 T1",
           "K11 mixed tiers", "K12 mixed n_feat"]
# K11's instances' true rows (T1 = 88, T2 = 162 rows at this window; None:
# every row of the buffer) and which of them update
K11_ROWS = {"K11 T1": ([20, 88, 50, 40], [True] * 4),
            "K11 mixed tiers": ([40, 120, 300, 60], [True, True, True, False])}


@pytest.mark.parametrize("kernel", KERNELS)
def test_batched_plain_matches_single(streams, params, kernel):
    """Each batched plain version (a leading instance axis) equals its single
    plain version on each instance, bit for bit."""
    ks = [40, 45, 50, 55]
    states, frames = streams["dense"]
    sts = [states[k] for k in ks]
    bst = tree.stack(sts)
    if kernel == "K14":
        frs = [frames[k] for k in ks]
        imu = [torch.stack([getattr(f, n) for f in frs]) for n in ("imu_t", "imu_w", "imu_a",
                                                                 "imu_mask")]
        got = propagation.propagate_plain(bst, params, *imu)
        for b, (st, fr) in enumerate(zip(sts, frs)):
            want = propagation.propagate_plain(st, params, fr.imu_t, fr.imu_w, fr.imu_a,
                                               fr.imu_mask)
            for (name, g), (_, w) in zip(leaves(tree.index(got, b)), leaves(want)):
                assert torch.equal(g, w), f"instance {b}: {name}"
        return
    if kernel.startswith("K11"):
        rows, upd = K11_ROWS[kernel]
        D = bst.cov.shape[-1]
        rng = np.random.default_rng(len(kernel))
        H = torch.zeros((4, 400, D))
        r = torch.zeros((4, 400))
        for b, m in enumerate(rows):
            H[b, :m, 21:] = torch.as_tensor(rng.normal(0, 0.05, (m, D - 21)), dtype=H.dtype)
            r[b, :m] = torch.as_tensor(rng.normal(0, 0.01, m), dtype=r.dtype)
        assert {update.update_tier(400, D, m) for m in rows} == (
            {"T1"} if kernel == "K11 T1" else {"T1", "T2", "QR"})
        got, warn = update.apply_update_fleet_plain(bst, params, H, r, rows, upd,
                                                    torch.tensor(upd))
        for b, st in enumerate(sts):
            want, wwarn = (update.apply_update_plain(st, params, H[b], r[b], rows[b]) if upd[b]
                           else (st, torch.zeros((), dtype=torch.bool)))
            for (name, g), (_, w) in zip(leaves(tree.index(got, b)), leaves(want)):
                assert torch.equal(g, w), f"instance {b}: {name}"
            assert torch.equal(warn[b], wwarn)
        return
    if kernel == "K12 mixed n_feat":
        n_feats, upd = [32, 64, 32, 64], [True] * 4
        rng = np.random.default_rng(12)
        H = torch.as_tensor(rng.normal(0, 0.8, (4, 64, 5, 33)), dtype=torch.float32)
        r_blk = torch.as_tensor(rng.normal(0, 0.02, (4, 64, 5)), dtype=torch.float32)
        include = torch.as_tensor(rng.uniform(size=(4, 64)) < 0.6)
        c = bst.cams
        cols = torch.stack([torch.cat([21 + 6 * (n - 3) + torch.arange(6),
                                       21 + 6 * (n - 1) + torch.arange(6)]) for n in c.count])
        got, warn = update.apply_update_rank12_rows_fleet_plain(
            bst, params, H[..., 21:], r_blk, include, cols, upd, torch.tensor(upd), n_feats)
        for b, st in enumerate(sts):
            k = n_feats[b]
            want, wwarn = update.apply_update_rank12_rows_plain(
                st, params, H[b, :k, :, 21:], r_blk[b, :k], include[b, :k], cols[b])
            for (name, g), (_, w) in zip(leaves(tree.index(got, b)), leaves(want)):
                assert torch.equal(g, w), f"instance {b}: {name}"
            assert torch.equal(warn[b], wwarn)
        return
    t, c = bst.features, bst.cams
    sel = smallest_k_indices(torch.where(t.valid, t.seq, INT32_MAX), 32).long()
    ok = (t.valid & t.initialized).gather(1, sel)
    ok[1, ::2] = False
    if kernel == "K13":  # every selected row triangulated anew
        fleet = (c.q, c.p, t.obs, t.obs_mask, t.position, torch.zeros_like(t.initialized), sel,
                 ok)
        rest = (params.R_cam0_cam1, params.t_cam0_cam1, CFG.triangulation)
        got = triangulation.triangulate_rows_plain(*fleet, *rest)
        assert bool(got[1].any())
        for b in range(len(ks)):
            want = triangulation.triangulate_rows_plain(*(x[b] for x in fleet), *rest)
            assert all(torch.equal(g[b], w) for g, w in zip(got, want)), f"instance {b}"
        return
    rm = torch.stack([c.count - 2, c.count - 1], 1).long()  # the newest two cameras
    kw = {"rm": rm} if kernel == "K9 prune" else {}
    fargs = (c.q, c.p, c.q_null, c.p_null, t.obs, t.obs_mask, t.position, sel, ok, bst.gravity,
             params.R_cam0_cam1, params.t_cam0_cam1, CFG.capacity.state_dim)
    H, r, rows = update.feature_block_rows_plain(*fargs, **kw)
    if kernel.startswith("K9"):
        assert int(rows.max()) > 0
        for b in range(len(ks)):
            one = [x[b] if i < 10 else x for i, x in enumerate(fargs)]
            want = update.feature_block_rows_plain(*one, **({"rm": rm[b]} if kw else {}))
            assert all(torch.equal(g[b], w) for g, w in zip((H, r, rows), want)), f"instance {b}"
        return
    dof = torch.full(rows.shape, 2) if kernel == "K10 small" else (rows + 3) // 4 - 1
    if kernel == "K10 small":
        H, r, rows = H[:, :, :5], r[:, :, :5], rows.clamp(max=5)
    else:
        assert H.shape[2] > update.GATE_TIER
    # per instance: every block passing by its bounds, as it is, failing
    r = r * torch.tensor([1e-3, 1.0, 30.0, 300.0])[:, None, None]
    args = (H, r, rows, bst.cov, params.obs_noise, params.chi2_table, dof)
    got = update.gating_test_batch_plain(*args)
    assert bool(got.any()) and not bool(got.all())
    for b in range(len(ks)):
        want = update.gating_test_batch_plain(H[b], r[b], rows[b], bst.cov[b], params.obs_noise,
                                              params.chi2_table, dof[b])
        assert torch.equal(got[b], want), f"instance {b}"


# (b) ------------------------------------------------------------------------

PATTERNS = {"none": [], "one": [2], "some": [0, 3], "all": [0, 1, 2, 3]}


@pytest.mark.parametrize("pattern", sorted(PATTERNS))
@pytest.mark.parametrize("stage", ["lost", "prune"])
def test_stage_on_a_subset(streams, params, monkeypatch, stage, pattern):
    """The lost-feature pass (its instances take their frame as it is, the
    others every feature again) or the camera prune (its instances' windows
    full, the others' not) triggered on none, one, some or all of four
    instances: the stage runs once, on those instances, and every instance
    equals its own backend_step, bit for bit."""
    on = PATTERNS[pattern]
    full = frames_with_count(streams, "dense", WINDOW - 1, 4)
    short = frames_with_count(streams, "dense", WINDOW - 2, 4)
    cases = []
    for b in range(4):
        if stage == "lost":
            cases.append(instance(streams, "dense", short[b], "as is" if b in on else "seen"))
        else:
            cases.append(instance(streams, "dense", (full if b in on else short)[b], "seen"))
    spy = Spy(monkeypatch)
    out = assert_instances_are_their_steps(cases, params)
    ran = spy.lost if stage == "lost" else spy.prune
    assert [n for n, _ in ran] == ([len(on)] if on else [])
    if stage == "lost":
        assert not spy.prune
        assert all(int(out.n_update_rows[b]) > 0 for b in on)
    else:
        assert not spy.lost
        assert all(int(out.n_prune_feats[b]) > 0 for b in on)


# (c) ------------------------------------------------------------------------

def test_lost_tier_widened_for_one_instance(streams, params, monkeypatch):
    """One instance loses every feature (more than 16 candidates, more than
    the 32 of the wide tier: an overflow pass of its own) beside two with
    at most 16 candidates and one with none: the pass runs on the wide tier
    for the three, the overflow pass on the one, and each instance equals
    its own step."""
    ks = frames_with_count(streams, "dense", WINDOW - 2, 4)
    cases = [instance(streams, "dense", ks[0], "empty"), instance(streams, "dense", ks[1]),
             instance(streams, "dense", ks[2], "seen"), instance(streams, "dense", ks[3])]
    spy = Spy(monkeypatch)
    out = assert_instances_are_their_steps(cases, params)
    (S, n_cand), = spy.lost
    assert S == 3 and max(n_cand) > CFG.capacity.max_lost_per_frame
    assert 0 < min(n_cand) <= step.LOST_SMALL
    assert spy.passes == [(3, CFG.capacity.max_lost_per_frame),
                          (1, CFG.capacity.max_lost_per_frame)]
    assert int(out.n_lost_overflow[0]) == 0 and int(out.n_update_rows[0]) > 0


def test_prune_tier_widened_for_one_instance(streams, params, monkeypatch):
    """A prune of more than 32 two-view features (the dense stream) beside
    one of fewer (the sparse stream) and an instance whose window is not
    full: both prunes run on the 64-feature tier, and each instance equals
    its own step."""
    dense = frames_with_count(streams, "dense", WINDOW - 1, 1)
    sparse = frames_with_count(streams, "sparse", WINDOW - 1, 1)
    short = frames_with_count(streams, "sparse", WINDOW - 2, 1)
    cases = [instance(streams, "dense", dense[0], "seen"),
             instance(streams, "sparse", sparse[0], "seen"),
             instance(streams, "sparse", short[0], "seen")]
    spy = Spy(monkeypatch)
    out = assert_instances_are_their_steps(cases, params)
    assert [n for n, _ in spy.prune] == [2]
    assert int(out.n_prune_feats[0]) > 32 >= int(out.n_prune_feats[1]) > 0
    assert int(out.n_prune_feats[2]) == 0


# (d) ------------------------------------------------------------------------

@pytest.mark.parametrize("B", [1, 4])
def test_host_reads_per_step(streams, params, B):
    """The fleet's back-end reads at most 6 times to the host a step, at
    B = 1 and B = 4, over steps that take the lost pass, its overflow pass
    and the prune together."""
    states, frames = streams["dense"]
    full = frames_with_count(streams, "dense", WINDOW - 1, 4)
    reads = []
    for k in range(full[-1] - 3, full[-1] + 1):
        cases = [(states[k - b], frames[k - b]) for b in range(B)]
        cases[0] = (cases[0][0], empty_frame(cases[0][1]))
        bstate, bframe = tree.stack([st for st, _ in cases]), stack_frames([f for _, f in cases])
        n0 = device.host_syncs["sync"]
        step.backend_step_fleet(bstate, bframe, params, CFG)
        reads.append(device.host_syncs["sync"] - n0)
    assert max(reads) <= 6 and max(reads) >= 4, reads


@pytest.mark.parametrize("B", [1, 4])
def test_update_calls_per_stage(streams, params, monkeypatch, B):
    """Over steps that take the lost pass, its overflow pass and the prune
    together, the fleet's back-end calls K11's wrapper at most once per
    lost pass and K12's at most once a step, each call taking every
    updating instance of its stage at once (B = 4: at least once with more
    than one), and never the single-instance wrappers."""
    states, frames = streams["dense"]
    full = frames_with_count(streams, "dense", WINDOW - 1, 4)
    log = []
    for name in ("apply_update_fleet", "apply_update_rank12_rows_fleet", "apply_update",
                 "apply_update_rank12_rows", "_remove_lost_once_fleet"):
        def spy(st, *args, _real=getattr(step, name), _name=name):
            log[-1].append((_name, st.cov.shape[0],
                            sum(args[5]) if _name.endswith("_fleet") and "update" in _name
                            else None))
            return _real(st, *args)

        monkeypatch.setattr(step, name, spy)
    for k in range(full[-1] - 3, full[-1] + 1):
        cases = [(states[k - b], frames[k - b]) for b in range(B)]
        cases[0] = (cases[0][0], empty_frame(cases[0][1]))
        bstate, bframe = tree.stack([st for st, _ in cases]), stack_frames([f for _, f in cases])
        log.append([])
        step.backend_step_fleet(bstate, bframe, params, CFG)
    widest = 0
    for calls in log:
        names = [c[0] for c in calls]
        assert "apply_update" not in names and "apply_update_rank12_rows" not in names
        assert names.count("apply_update_fleet") <= names.count("_remove_lost_once_fleet")
        assert names.count("apply_update_rank12_rows_fleet") <= 1
        widest = max([widest] + [c[2] for c in calls if c[2] is not None])
    assert any("apply_update_fleet" in [c[0] for c in calls] for calls in log)
    if B > 1:  # the prune updates on these steps' other instances
        assert any("apply_update_rank12_rows_fleet" in [c[0] for c in calls] for calls in log)
    assert widest == 1 if B == 1 else widest > 1

