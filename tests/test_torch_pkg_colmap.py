"""COLMAP model IO: the port's copy of io/colmap.py against the JAX package's.

One seeded model (two cameras, rotated and translated images, 60 points
with tracks) is written by both packages' binary writers: the files are
byte for byte identical, each package reads the other's files (and the
text layout) to the same model, and model_to_npz (with and without a
resize), sparse_depths, vote_scale, sparse_depth_scales and
write_scales_csv give the same results (exactly: the code is numpy in
both). The CLI, `python -m robust_cvd_tpu_torch.io.colmap`, writes the
JAX CLI's metadata.npz and scales.csv.
"""

import os
import subprocess
import sys
from os.path import join as pjoin

import numpy as np
import pytest

from robust_cvd_tpu.io import colmap as J
from robust_cvd_tpu_torch.io import colmap as T
from robust_cvd_tpu_torch.io import raw

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def make_model(mod, n_images=4, n_points=60, seed=0):
    """A seeded model in `mod`'s dataclasses: image k at x = 0.1 k, yawed by
    0.05 k, observing the points in front of it (a few observations
    without a 3D point)."""
    rng = np.random.default_rng(seed)
    cams = {
        1: mod.ColmapCamera(1, "PINHOLE", 64, 48, np.asarray([70.0, 72.0, 32.0, 24.0])),
        2: mod.ColmapCamera(2, "SIMPLE_RADIAL", 128, 96, np.asarray([140.0, 64.0, 48.0, 0.01])),
    }
    points = {
        pid: mod.ColmapPoint3D(
            pid, rng.uniform(-1, 1, 3) + [0, 0, 4.0],
            rng.integers(0, 255, 3).astype(np.uint8), float(rng.uniform(0, 1)),
            np.asarray([1, 2], np.int64), np.asarray([pid, pid + 1], np.int64),
        )
        for pid in range(n_points)
    }
    images = {}
    for iid in range(1, n_images + 1):
        yaw = 0.05 * iid
        half = yaw / 2
        qvec = np.asarray([np.cos(half), 0.0, np.sin(half), 0.0])
        im = mod.ColmapImage(iid, qvec, np.asarray([-0.1 * iid, 0.02, 0.0]), 1 + iid % 2,
                             f"frame_{iid - 1:06d}.png", np.zeros((0, 2)), np.zeros(0, np.int64))
        cam = cams[im.camera_id]
        fx, fy, cx, cy = cam.fx_fy_cx_cy
        xys, ids = [], []
        for pid, p in points.items():
            c = im.rotation() @ p.xyz + im.tvec
            x, y = fx * c[0] / c[2] + cx, fy * c[1] / c[2] + cy
            if c[2] > 0 and 0 <= x < cam.width and 0 <= y < cam.height:
                xys.append([x, y])
                ids.append(pid if pid % 7 else -1)
        images[iid] = im.__class__(iid, qvec, im.tvec, im.camera_id, im.name,
                                   np.asarray(xys, float), np.asarray(ids, np.int64))
    return cams, images, points


def write(mod, d):
    cams, images, points = make_model(mod)
    os.makedirs(d, exist_ok=True)
    mod.write_cameras_binary(cams, pjoin(d, "cameras.bin"))
    mod.write_images_binary(images, pjoin(d, "images.bin"))
    mod.write_points3d_binary(points, pjoin(d, "points3D.bin"))
    return d


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    base = tmp_path_factory.mktemp("colmap")
    return write(J, str(base / "jax")), write(T, str(base / "torch"))


def test_writers_byte_identical(models):
    jd, td = models
    for name in ("cameras.bin", "images.bin", "points3D.bin"):
        with open(pjoin(jd, name), "rb") as a, open(pjoin(td, name), "rb") as b:
            assert a.read() == b.read(), name


def _same_model(a, b):
    (ac, ai, ap), (bc, bi, bp) = a, b
    assert ac.keys() == bc.keys() and ai.keys() == bi.keys() and ap.keys() == bp.keys()
    for k in ac:
        assert (ac[k].model, ac[k].width, ac[k].height) == (bc[k].model, bc[k].width, bc[k].height)
        np.testing.assert_array_equal(ac[k].params, bc[k].params)
        assert ac[k].fx_fy_cx_cy == bc[k].fx_fy_cx_cy
    for k in ai:
        assert (ai[k].name, ai[k].camera_id) == (bi[k].name, bi[k].camera_id)
        for f in ("qvec", "tvec", "xys", "point3d_ids"):
            np.testing.assert_array_equal(getattr(ai[k], f), getattr(bi[k], f))
        np.testing.assert_array_equal(ai[k].rotation(), bi[k].rotation())
    for k in ap:
        for f in ("xyz", "rgb", "image_ids", "point2d_idxs"):
            np.testing.assert_array_equal(getattr(ap[k], f), getattr(bp[k], f))
        assert ap[k].error == bp[k].error


def test_binary_readers_cross(models):
    jd, td = models
    _same_model(T.read_model(jd), J.read_model(jd))
    _same_model(T.read_model(td), J.read_model(td))
    assert [im.name for im in T.ordered_images(T.read_model(td)[1])] == [
        im.name for im in J.ordered_images(J.read_model(jd)[1])]


def test_text_readers(tmp_path):
    d = str(tmp_path)
    with open(pjoin(d, "cameras.txt"), "w") as f:
        f.write("# comment\n1 SIMPLE_PINHOLE 32 24 30.0 16.0 12.0\n2 OPENCV 32 24 1 2 3 4 0 0 0 0\n")
    with open(pjoin(d, "images.txt"), "w") as f:
        f.write("# comment\n1 1 0 0 0 0.5 0 2 1 frame_000000.png\n3.0 4.0 7 10.0 12.0 -1\n")
        f.write("2 0.9 0.1 0 0 0 0 1 2 frame_000001.png\n\n")
    with open(pjoin(d, "points3D.txt"), "w") as f:
        f.write("7 1.0 2.0 3.0 10 20 30 0.5 1 0 2 1\n")
    _same_model(T.read_model(d), J.read_model(d))
    with pytest.raises(FileNotFoundError):
        T.read_model(pjoin(d, "missing"))


@pytest.mark.parametrize("dst", [None, (32, 24)])
def test_model_to_npz(models, tmp_path, dst):
    jd, _ = models
    jo = J.model_to_npz(jd, str(tmp_path / "j.npz"), dst)
    to = T.model_to_npz(jd, str(tmp_path / "t.npz"), dst)
    for k in ("extrinsics", "intrinsics"):
        np.testing.assert_array_equal(to[k], jo[k])
        np.testing.assert_array_equal(np.load(str(tmp_path / "t.npz"))[k],
                                      np.load(str(tmp_path / "j.npz"))[k])
    assert to["extrinsics"].shape == (4, 3, 4)


def test_sparse_depth_scales(models, tmp_path):
    jd, _ = models
    cams, images, points = J.read_model(jd)
    for iid in images:
        for a, b in zip(T.sparse_depths(images[iid], points), J.sparse_depths(images[iid], points)):
            np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(5)
    v = rng.uniform(0, 2, 50)
    assert T.vote_scale(v) == J.vote_scale(v)
    assert np.isnan(T.vote_scale(np.zeros(0)))
    depth = rng.uniform(1, 5, (4, 24, 32)).astype(np.float32)
    got = T.sparse_depth_scales(jd, depth)
    np.testing.assert_array_equal(got, J.sparse_depth_scales(jd, depth))
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(T.sparse_depth_scales(jd, depth, (64, 48)),
                                  J.sparse_depth_scales(jd, depth, (64, 48)))
    got[1] = np.nan
    for mod, sub in ((T, "t"), (J, "j")):
        os.makedirs(tmp_path / sub)
        mod.write_scales_csv(str(tmp_path / sub), got)
    assert (tmp_path / "t" / "scales.csv").read_text() == (tmp_path / "j" / "scales.csv").read_text()


def test_cli(models, tmp_path):
    jd, _ = models
    stream = tmp_path / "depth"
    os.makedirs(stream)
    rng = np.random.default_rng(6)
    for i in range(4):
        raw.save_raw_float32_image(str(stream / f"frame_{i:06d}.raw"),
                                   rng.uniform(0.2, 1.0, (24, 32)).astype(np.float32))
    outs = {}
    for pkg in ("robust_cvd_tpu", "robust_cvd_tpu_torch"):
        out = tmp_path / pkg
        os.makedirs(out)
        proc = subprocess.run(
            [sys.executable, "-m", f"{pkg}.io.colmap", jd, str(out / "metadata.npz"),
             "--depth-stream", str(stream), "--size", "32x24"],
            capture_output=True, text=True, cwd=ROOT, timeout=300,
            env=dict(os.environ, JAX_PLATFORMS="cpu"),
        )
        assert proc.returncode == 0, proc.stderr[-2000:]
        outs[pkg] = out
    j, t = outs["robust_cvd_tpu"], outs["robust_cvd_tpu_torch"]
    assert (t / "scales.csv").read_text() == (j / "scales.csv").read_text()
    for k in ("extrinsics", "intrinsics"):
        np.testing.assert_array_equal(np.load(str(t / "metadata.npz"))[k],
                                      np.load(str(j / "metadata.npz"))[k])
