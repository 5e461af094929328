"""Importers and camera helpers: JAX package vs PyTorch port on the CPU.

Held: the five camera helpers the importers need (CameraState.default,
matrix_to_quat, matrix_to_axis_angle, rotate_point_axis_angle,
world_to_camera_matrix) within 1e-6 of the JAX package's; import_poses,
load_scale, import_colmap_recon (a COLMAP model written by io/colmap.py's
own writers, converted by model_to_npz, with a scales.csv and a frame the
reconstruction lacks) give the same cameras within 1e-6 and the same
enabled frames; import_colmap_depth writes byte-identical .raw files;
import_tracks the same tracks. Then PoseOptimizer on the 6-frame clip of
tests/test_torch_pkg_slice.py with a depth_gt/ directory (poses.txt) and
a COLMAP reconstruction (colmap_dense/metadata.npz, depth_colmap_dense/)
registers the JAX package's streams in its order with the same imported
.raw files and cameras; its first optimize_poses is seeded from the COLMAP
cameras (poses within 1e-3 of the JAX package's seeded solve: the
clip's depth is random, so the solve is loosely conditioned), and video.dat
lists the imported streams as the JAX package's does, its cameras and
transforms within the same 1e-3.
"""

import os
import shutil
from os.path import join as pjoin

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robust_cvd_tpu import camera as jcam
from robust_cvd_tpu import config as jconfig
from robust_cvd_tpu.io import importers as JI
from robust_cvd_tpu.io.store import VideoStore as JStore
from robust_cvd_tpu.parallel import mesh as jmesh
from robust_cvd_tpu.pipeline.pose import PoseOptimizer as JPose
from robust_cvd_tpu_torch import camera as tcam
from robust_cvd_tpu_torch import config as tconfig
from robust_cvd_tpu_torch.io import colmap as TC
from robust_cvd_tpu_torch.io import importers as TI
from robust_cvd_tpu_torch.io import raw
from robust_cvd_tpu_torch.io.store import VideoStore as TStore
from robust_cvd_tpu_torch.io.video_dat import load_video_dat
from robust_cvd_tpu_torch.pipeline.pose import PoseOptimizer as TPose
from test_torch_pkg_colmap import write as write_model
from test_torch_pkg_slice import H, N, OPT, W, make_clip
from torch_pkg_threads import one_torch_thread  # noqa: F401  (autouse)


def _rotations(n, seed):
    rng = np.random.default_rng(seed)
    aa = rng.normal(0, 1.2, (n, 3)).astype(np.float32)
    aa[0] = 0.0
    aa[1] = [np.pi - 1e-3, 0, 0]  # near a half turn: the x-seeded branch
    return np.asarray(jax.vmap(jcam.axis_angle_to_matrix)(jnp.asarray(aa)))


def test_camera_helpers():
    m = _rotations(16, 0)
    np.testing.assert_allclose(tcam.matrix_to_quat(torch.from_numpy(m)).numpy(),
                               np.asarray(jax.vmap(jcam.matrix_to_quat)(m)), atol=1e-6)
    np.testing.assert_allclose(tcam.matrix_to_axis_angle(torch.from_numpy(m)).numpy(),
                               np.asarray(jax.vmap(jcam.matrix_to_axis_angle)(m)), atol=1e-6)
    rng = np.random.default_rng(1)
    p = rng.normal(0, 2, (5, 7, 3)).astype(np.float32)
    for aa in (rng.normal(0, 1, 3).astype(np.float32), np.zeros(3, np.float32),
               np.full(3, 1e-9, np.float32)):
        np.testing.assert_allclose(
            tcam.rotate_point_axis_angle(torch.from_numpy(aa), torch.from_numpy(p)).numpy(),
            np.asarray(jcam.rotate_point_axis_angle(jnp.asarray(aa), jnp.asarray(p))),
            atol=1e-6)
    q = rng.normal(0, 1, (6, 4)).astype(np.float32)
    pos = rng.normal(0, 1, (6, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tcam.world_to_camera_matrix(torch.from_numpy(pos), torch.from_numpy(q)).numpy(),
        np.asarray(jax.vmap(jcam.world_to_camera_matrix)(jnp.asarray(pos), jnp.asarray(q))),
        atol=1e-6)
    for aspect in (16 / 9, 0.75):
        t, j = tcam.CameraState.default(5, aspect), jcam.CameraState.default(5, aspect)
        for a, b in zip(t, j):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


def _same_camera(t, j, enabled_t, enabled_j):
    np.testing.assert_array_equal(enabled_t, enabled_j)
    for a, b in zip(t, j):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


def test_import_poses(tmp_path):
    rng = np.random.default_rng(2)
    vals = rng.normal(0, 1, (4, 9))
    path = str(tmp_path / "poses.txt")
    with open(path, "w") as f:
        f.write("4\n" + "\n".join(" ".join(f"{v:.9f}" for v in row) for row in vals))
    (tc, te), (jc, je) = TI.import_poses(path, 6), JI.import_poses(path, 6)
    _same_camera(tc, jc, te, je)
    assert te.tolist() == [True] * 4 + [False] * 2
    with pytest.raises(ValueError):
        TI.import_poses(path, 3)


def test_load_scale_and_tracks(tmp_path):
    d = str(tmp_path)
    assert TI.load_scale(d) == JI.load_scale(d) == 1.0
    with open(pjoin(d, "scales.csv"), "w") as f:
        f.write("0,1.5\n1,bad\n2\n3,2.25\n")
    assert TI.load_scale(d) == JI.load_scale(d) == 1.875
    with open(pjoin(d, "tracks.csv"), "w") as f:
        f.write("0,1.5,2.5,1,3.0,4.0\n\n2,5,6,\n")
    assert TI.import_tracks(pjoin(d, "tracks.csv")) == JI.import_tracks(pjoin(d, "tracks.csv"))


def colmap_clip(base, frames=(0, 1, 3, 4), scale="0,1.25\n1,1.75\n"):
    """A COLMAP reconstruction under `base` in the importer's layout: the
    model's metadata.npz at colmap_dense/ and one depth .raw a reconstructed
    frame under depth_colmap_dense/depth/, with scales.csv."""
    write_model(TC, pjoin(base, "colmap_dense", "sparse"))
    TC.model_to_npz(pjoin(base, "colmap_dense", "sparse"),
                    pjoin(base, "colmap_dense", "metadata.npz"), (W, H))
    rng = np.random.default_rng(3)
    os.makedirs(pjoin(base, "depth_colmap_dense", "depth"))
    for i in frames:
        raw.save_raw_float32_image(pjoin(base, "depth_colmap_dense", "depth", f"frame_{i:06d}.raw"),
                                   rng.uniform(0.2, 1.0, (H, W)).astype(np.float32))
    with open(pjoin(base, "scales.csv"), "w") as f:
        f.write(scale)


def test_import_colmap(tmp_path):
    base = str(tmp_path)
    colmap_clip(base)
    src = pjoin(base, "depth_colmap_dense", "depth")
    for mod, out in ((TI, "t"), (JI, "j")):
        mod.import_colmap_depth(src, pjoin(base, out), base)
    for name in sorted(os.listdir(src)):
        with open(pjoin(base, "t", name), "rb") as a, open(pjoin(base, "j", name), "rb") as b:
            assert a.read() == b.read()
    meta = pjoin(base, "colmap_dense", "metadata.npz")
    tc, te = TI.import_colmap_recon(base, meta, src, N)
    jc, je = JI.import_colmap_recon(base, meta, src, N)
    _same_camera(tc, jc, te, je)
    assert te.tolist() == [True, True, False, True, True, False]
    shutil.rmtree(pjoin(base, "t"))
    os.remove(pjoin(src, "frame_000004.raw"))
    with pytest.raises(ValueError):
        TI.import_colmap_recon(base, meta, src, N)


@pytest.fixture(scope="module")
def imported(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("importclip"))
    make_clip(base)
    rng = np.random.default_rng(4)
    disp = rng.uniform(0.3, 0.6, (N, H, W)).astype(np.float32)
    os.makedirs(pjoin(base, "depth_midas2", "depth"))
    os.makedirs(pjoin(base, "depth_gt", "depth"))
    for i in range(N):
        raw.save_raw_float32_image(pjoin(base, "depth_midas2", "depth", f"frame_{i:06d}.raw"),
                                   disp[i])
        raw.save_raw_float32_image(pjoin(base, "depth_gt", "depth", f"frame_{i:06d}.raw"),
                                   disp[i] * 1.1)
    with open(pjoin(base, "depth_gt", "poses.txt"), "w") as f:
        f.write(f"{N}\n" + "".join(f"{0.05 * i} 0 0 0 0 0 1 0.9 0.6\n" for i in range(N)))
    colmap_clip(base, frames=range(1, 5))
    jdir, tdir = base + "_jax", base + "_torch"
    shutil.copytree(base, jdir)
    shutil.copytree(base, tdir)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmesh, "pipeline_mesh", lambda *a, **k: None)
        jpose = JPose(jconfig.PipelineConfig(path=jdir, opt=jconfig.PoseOptParams(**OPT)),
                      JStore.open(jdir), "depth_midas2")
        jpose.optimize_poses()
        jpose.save()
    tpose = TPose(tconfig.PipelineConfig(path=tdir, opt=tconfig.PoseOptParams(**OPT)),
                  TStore.open(tdir), "depth_midas2", device="cpu")
    seed = tpose.initial_camera
    tpose.optimize_poses()
    tpose.save()
    return dict(jdir=jdir, tdir=tdir, jpose=jpose, tpose=tpose, seed=seed)


def test_external_streams(imported):
    jpose, tpose = imported["jpose"], imported["tpose"]
    names = [s.name for s in tpose.streams]
    assert names == [s.name for s in jpose.streams] == ["depth_gt", "colmap_dense", "depth_midas2"]
    for ts, js in zip(tpose.streams, jpose.streams):
        assert os.path.relpath(ts.dir, imported["tdir"]) == os.path.relpath(js.dir, imported["jdir"])
    d = "depth_colmap_dense_imported/depth"
    files = sorted(os.listdir(pjoin(imported["tdir"], d)))
    assert files == [f"frame_{i:06d}.raw" for i in range(1, 5)]
    for name in files:
        with open(pjoin(imported["tdir"], d, name), "rb") as a, \
                open(pjoin(imported["jdir"], d, name), "rb") as b:
            assert a.read() == b.read()
    _same_camera(imported["seed"], jpose.initial_camera, tpose.enabled_frames,
                 jpose.enabled_frames)
    gt = tpose.streams[0]
    np.testing.assert_allclose(tpose._load_stream_depth(gt), jpose._load_stream_depth(jpose.streams[0]),
                               rtol=1e-6)


def test_seeded_solve_and_video_dat(imported):
    jsp, tsp = imported["jpose"].solver_params, imported["tpose"].solver_params
    np.testing.assert_allclose(tsp.pose.numpy(), np.asarray(jsp.pose), atol=1e-3)
    log = imported["tpose"].solve_log
    assert [e["stage"] for e in log] == ["normalize", "step0", "step1"]
    jv = load_video_dat(pjoin(imported["jdir"], "video.dat"))
    tv = load_video_dat(pjoin(imported["tdir"], "video.dat"))
    assert [(s.name, s.dir, s.width, s.height) for s in tv.depth_streams] == [
        (s.name, s.dir, s.width, s.height) for s in jv.depth_streams]
    for ts, js in zip(tv.depth_streams, jv.depth_streams):
        assert (ts.depth_desc, ts.spatial_desc) == (js.depth_desc, js.spatial_desc)
        for tf, jf in zip(ts.frames, js.frames):
            assert tf.enabled == jf.enabled
            np.testing.assert_allclose(tf.position + tf.quaternion,
                                       jf.position + jf.quaternion, atol=1e-3)
            np.testing.assert_allclose(tf.depth_params, jf.depth_params, atol=1e-3)
