"""pipeline/processor.py and solver/tracks.py: the JAX package vs the PyTorch
port on the CPU.

A small store (6 frames at 24x32: a seeded texture panning 1 px a frame,
hierarchical2 flows of the pan plus noise within +-0.2 px, consistency
masks where the target lies in bounds by at least 0.3 px, a dynamic mask
with one moving block, a depth stream and a camera state that is not the
default) is copied, and each of the 13 ops of `Op` runs through both
packages' `Processor.process` on its own copy, in one sequence. Flows and
masks are the same files in both, so flow targets and tracked locations
cannot fall on different sides of a .5 or an in-bounds boundary.

Tolerances: copies, clips, resets and constraint sets are exact; the
filters 1e-5 of the largest depth (the camera's rotation and the
unprojection are float32 in another order); the track tables are equal (the
two corner responses are the same float32 arithmetic on a random texture,
with no near ties among this store's candidates); the solver ops' poses
within 1e-3 and transforms within 1e-3 relative, as the pose-stage parity
test (tests/test_torch_pkg_slice.py): both packages run the same LM steps
in float32 in different summation orders.

The track table alone: compute_tracks on one corner array fed to both
packages (near ties in a recomputed corner response would reorder the
spawn candidates), and its binary and CSV files byte for byte.
"""

import dataclasses
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robust_cvd_tpu import camera as jcam
from robust_cvd_tpu import config as jconfig
from robust_cvd_tpu.io.store import VideoStore as JStore
from robust_cvd_tpu.parallel import mesh as jmesh
from robust_cvd_tpu.pipeline import processor as jproc
from robust_cvd_tpu.solver import tracks as jtracks
from robust_cvd_tpu_torch import camera as tcam
from robust_cvd_tpu_torch import config as tconfig
from robust_cvd_tpu_torch.io import raw
from robust_cvd_tpu_torch.io.frames import save_frames_txt
from robust_cvd_tpu_torch.io.store import VideoStore as TStore, frame_name, save_png_gray
from robust_cvd_tpu_torch.pipeline import processor as tproc
from robust_cvd_tpu_torch.solver import tracks as ttracks
from robust_cvd_tpu_torch.utils.frame_sampling import sample_pairs

from torch_pkg_threads import one_torch_thread  # noqa: F401  (autouse)

N, H, W = 6, 24, 32
OPT = dict(num_steps=2, ctf_long=3, ctf_short=2, lm_max_outer=4, lm_cg_iters=8)
TRACKS = dict(track_spawn_distance=6, track_prune_distance=2, min_track_length=3)


def make_store(base):
    rng = np.random.default_rng(3)
    noise = rng.uniform(0, 1, (H + 2, W + N + 2, 3)).astype(np.float32)
    tex = sum(noise[dy : dy + H, dx : dx + W + N] for dy in range(3) for dx in range(3)) / 9
    os.makedirs(os.path.join(base, "color_down"))
    os.makedirs(os.path.join(base, "dynamic_mask"))
    for i in range(N):
        raw.save_raw_float32_image(
            os.path.join(base, "color_down", frame_name(i, ".raw")), tex[:, i : i + W])
        dyn = np.full((H, W), 255, np.uint8)
        dyn[4:9, 20 - i : 25 - i] = 0
        save_png_gray(os.path.join(base, "dynamic_mask", frame_name(i, ".png")), dyn)
    save_frames_txt(os.path.join(base, "frames.txt"), W, H, [i / 30 for i in range(N)])
    store = TStore.open(base)
    xs = np.arange(W, dtype=np.float32)
    entries = []
    for i, j in sample_pairs(N, ("hierarchical2",), two_way=True):
        flow = rng.uniform(-0.2, 0.2, (H, W, 2)).astype(np.float32)
        flow[..., 0] += i - j
        tx = xs + flow[..., 0]
        mask = (tx >= 0.3) & (tx <= W - 1.3)
        store.save_flow(i, j, flow)
        store.save_flow_mask(i, j, mask)
        entries.append((i, j, float(mask.mean())))
    store.save_flow_list(entries)
    store.save_depth_stream("depth", rng.uniform(1.5, 3.0, (N, H, W)).astype(np.float32))


def camera_arrays():
    rng = np.random.default_rng(4)
    q = np.concatenate([rng.normal(0, 0.03, (N, 3)), np.ones((N, 1))], 1)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return (rng.normal(0, 0.05, (N, 3)).astype(np.float32), q.astype(np.float32),
            np.full(N, 0.8, np.float32), np.full(N, 0.8 * W / H, np.float32))


# (result key, op name, params): one sequence run in both packages
SEQUENCE = [
    ("copy", "COPY", dict(source_depth_stream="depth", depth_stream="depth_copy")),
    ("bilateral_filter", "BILATERAL_FILTER", dict(
        source_depth_stream="depth", depth_stream="depth_bf", spatial_radius=1,
        frame_radius=1, color_sigma=0.2)),
    ("flow_guided_filter", "FLOW_GUIDED_FILTER", dict(
        source_depth_stream="depth", depth_stream="depth_fgf")),
    ("flow_guided_filter_median", "FLOW_GUIDED_FILTER", dict(
        source_depth_stream="depth", depth_stream="depth_fgf_median", median=True)),
    ("flow_guided_filter_far", "FLOW_GUIDED_FILTER", dict(
        source_depth_stream="depth", depth_stream="depth_fgf_far", frame_radius=1,
        far_connections=True)),
    ("clip_max_depth", "CLIP_MAX_DEPTH", dict(
        source_depth_stream="depth", depth_stream="depth_clip", max_depth=2.0)),
    ("compute_tracks", "COMPUTE_TRACKS", TRACKS),
    ("compute_constraints", "COMPUTE_CONSTRAINTS", dict(source_depth_stream="depth")),
    ("normalize_depth", "NORMALIZE_DEPTH", dict(source_depth_stream="depth")),
    ("optimize_poses", "OPTIMIZE_POSES", dict(source_depth_stream="depth")),
    ("grid_xform_split", "GRID_XFORM_SPLIT", dict(grid_size=(4, 3))),
    ("reset_depth_xforms", "RESET_DEPTH_XFORMS", {}),
    ("reset_spatial_xforms", "RESET_SPATIAL_XFORMS", {}),
    ("reset_poses", "RESET_POSES", {}),
    ("reset_normalize_optimize", "RESET_NORMALIZE_OPTIMIZE", dict(source_depth_stream="depth")),
]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("store"))
    make_store(base)
    jdir, tdir = base + "_jax", base + "_torch"
    shutil.copytree(base, jdir)
    shutil.copytree(base, tdir)
    cam = camera_arrays()
    jstore, tstore = JStore.open(jdir), TStore.open(tdir)
    jstore.camera = jcam.CameraState(*map(jnp.asarray, cam))
    tstore.camera = tcam.CameraState(*map(torch.from_numpy, cam))
    jp, tp = jproc.Processor(jstore), tproc.Processor(tstore, device="cpu")
    jopt, topt = jconfig.PoseOptParams(**OPT), tconfig.PoseOptParams(**OPT)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmesh, "pipeline_mesh", lambda *a, **k: None)
        for key, op, kw in SEQUENCE:
            jr = jp.process(jproc.ProcessorParams(op=jproc.Op[op], pose_optimizer=jopt, **kw))
            tr = tp.process(tproc.ProcessorParams(op=tproc.Op[op], pose_optimizer=topt, **kw))
            if key in ("normalize_depth", "optimize_poses", "grid_xform_split",
                       "reset_depth_xforms", "reset_spatial_xforms",
                       "reset_normalize_optimize"):
                jr = {k: np.asarray(v) for k, v in jr._asdict().items() if v is not None}
                tr = {k: v.numpy() for k, v in tr._asdict().items() if v is not None}
            if key in ("reset_poses", "reset_normalize_optimize"):
                out[key + "/camera"] = ([np.asarray(t) for t in jstore.camera],
                                        [t.numpy() for t in tstore.camera])
            out[key] = (jr, tr)
    return dict(jdir=jdir, tdir=tdir, out=out)


def _streams(runs, name):
    return (JStore.open(runs["jdir"]).load_depth_stream(name),
            TStore.open(runs["tdir"]).load_depth_stream(name))


def test_every_op_dispatches():
    assert {op for _, op, _ in SEQUENCE} == {o.name for o in tproc.Op} - {"NONE"}
    assert [o.value for o in tproc.Op] == [o.value for o in jproc.Op]
    assert [f.name for f in dataclasses.fields(tproc.ProcessorParams)] == [
        f.name for f in dataclasses.fields(jproc.ProcessorParams)]
    with pytest.raises(ValueError, match="unsupported op"):
        tproc.Processor(None, device="cpu").process(tproc.ProcessorParams())


@pytest.mark.parametrize("name", ["depth_copy", "depth_clip"])
def test_exact_depth_ops(runs, name):
    j, t = _streams(runs, name)
    np.testing.assert_array_equal(t, j)
    if name == "depth_clip":
        assert t.max() == 2.0


@pytest.mark.parametrize("name", ["depth_bf", "depth_fgf", "depth_fgf_median", "depth_fgf_far"])
def test_filter_ops(runs, name):
    j, t = _streams(runs, name)
    src = _streams(runs, "depth")[1]
    assert t.shape == (N, H, W) and np.isfinite(t).all()
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-5 * np.abs(j).max())
    assert np.abs(t - src).max() > 1e-3  # the filter did something


def test_compute_tracks_op(runs):
    jt, tt = runs["out"]["compute_tracks"]
    assert tt.tracks and sorted(tt.tracks) == sorted(jt.tracks)
    for tid, t in tt.tracks.items():
        assert t.first_frame == jt.tracks[tid].first_frame
        assert t.locs == jt.tracks[tid].locs
    assert tt.frames == jt.frames


def test_compute_constraints_op(runs):
    jpose, tpose = runs["out"]["compute_constraints"]
    assert tpose.pair_keys == jpose.pair_keys and tpose.triplet_keys == jpose.triplet_keys
    for k in tpose.pair_keys:
        np.testing.assert_array_equal(tpose.pairs[k].loc0, jpose.pairs[k].loc0)
        np.testing.assert_array_equal(tpose.pairs[k].loc1, jpose.pairs[k].loc1)
        np.testing.assert_array_equal(tpose.pairs[k].is_static, jpose.pairs[k].is_static)
    assert not all(tpose.pairs[k].is_static.all() for k in tpose.pair_keys)


@pytest.mark.parametrize("key", ["normalize_depth", "optimize_poses", "grid_xform_split",
                                 "reset_depth_xforms", "reset_spatial_xforms",
                                 "reset_normalize_optimize"])
def test_solver_ops(runs, key):
    j, t = runs["out"][key]
    assert sorted(t) == sorted(j)
    for name in t:
        assert t[name].shape == j[name].shape, name
        assert np.isfinite(t[name]).all()
        if name == "pose":
            np.testing.assert_allclose(t[name], j[name], rtol=0, atol=1e-3)
        else:
            np.testing.assert_allclose(t[name], j[name], rtol=1e-3,
                                       atol=1e-3 * np.abs(j[name]).max())
    if key == "grid_xform_split":
        assert t["depth_grid"].shape[1:] == (1, 3, 4)
    if key == "reset_depth_xforms":
        assert t["depth_grid"].shape[1:] == (1, 1, 1) and (t["depth_grid"] == 1).all()
    if key == "reset_spatial_xforms":
        assert t["spatial_grid"].shape[1:3] == (1, 1) and (t["spatial_grid"] == 0).all()


@pytest.mark.parametrize("key", ["reset_poses/camera", "reset_normalize_optimize/camera"])
def test_reset_poses_op(runs, key):
    j, t = runs["out"][key]
    for a, b in zip(t, j):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(t[0], 0.0)


# -- the track table alone ---------------------------------------------------


def track_inputs():
    rng = np.random.default_rng(5)
    corner = rng.random((N, H, W)).astype(np.float32)
    flows, masks = {}, {}
    for i in range(N - 1):
        if i == 2:
            continue  # a missing flow ends every track there
        f = rng.uniform(-0.2, 0.2, (H, W, 2)).astype(np.float32)
        f[..., 0] += 1.0
        flows[i] = f
        masks[i] = rng.uniform(0, 1, (H, W)) > 0.1
    dyn = np.full((N, H, W), 50.0, np.float32)
    dyn[:, 5:10, 5:12] = 1.0
    return corner, flows, masks, dyn


@pytest.fixture(scope="module")
def tables():
    corner, flows, masks, dyn = track_inputs()
    kw = dict(spawn_distance=5, prune_distance=2, min_dynamic_distance=3.0,
              min_track_length=2)
    return (jtracks.compute_tracks(corner, flows, masks, H / W, dyn, **kw),
            ttracks.compute_tracks(corner, flows, masks, H / W, dyn, **kw))


def test_compute_tracks_same_corner(tables):
    jt, tt = tables
    assert len(tt.tracks) > 10 and tt.num_tracks() == jt.num_tracks()
    assert {k: (v.first_frame, v.locs) for k, v in tt.tracks.items()} == {
        k: (v.first_frame, v.locs) for k, v in jt.tracks.items()}
    assert tt.frames == jt.frames


def test_track_files_byte_for_byte(tables, tmp_path):
    jt, tt = tables
    victim = sorted(tt.tracks)[0]  # an invalid slot in the binary file
    jt.delete_track(victim)
    tt.delete_track(victim)
    files = {}
    for name, table in (("jax", jt), ("torch", tt)):
        table.save_binary(tmp_path / f"{name}.dat")
        table.save_csv(tmp_path / f"{name}.csv")
        files[name] = [(tmp_path / f"{name}.{ext}").read_bytes() for ext in ("dat", "csv")]
    assert files["torch"] == files["jax"]
    loaded = ttracks.TrackTable.load_binary(tmp_path / "torch.dat")
    assert loaded.num_tracks() == tt.num_tracks() and set(loaded.tracks) == set(tt.tracks)
    assert loaded.frames == tt.frames
    for tid, t in tt.tracks.items():
        assert loaded.tracks[tid].first_frame == t.first_frame
        np.testing.assert_array_equal(np.float32(loaded.tracks[tid].locs), np.float32(t.locs))
