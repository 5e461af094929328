"""Motion segmentation, epipolar RANSAC and the visualizations: JAX package
vs PyTorch port on numpy-seeded inputs.

Both packages compute these on the host in numpy, so the results are held
identical (bit for bit): sampson_distance, _eight_point,
find_fundamental_ransac, find_homography_ransac (the port skips the full U
of the refit's SVD, which leaves V^T unchanged bit for bit),
motion_segmentation_mask on a flow with a moving block, the PNGs of
compute_dynamic_masks, the flags of set_static_flags_from_ransac, and
flow_to_image, visualize_depth, visualize_scene_flow and apply_mask byte
for byte. warp_by_flow samples in torch in the port and in jax in the JAX
package: within 1e-5.
"""

import os

import numpy as np
import pytest

from robust_cvd_tpu.ops import epipolar as jep
from robust_cvd_tpu.ops import homography as jhg
from robust_cvd_tpu.pipeline import masks as jmasks
from robust_cvd_tpu.solver import constraints as jC
from robust_cvd_tpu.utils import visualization as jvis
from robust_cvd_tpu_torch.io import raw
from robust_cvd_tpu_torch.io.frames import save_frames_txt
from robust_cvd_tpu_torch.io.store import VideoStore, frame_name
from robust_cvd_tpu_torch.ops import epipolar as tep
from robust_cvd_tpu_torch.ops import homography as thg
from robust_cvd_tpu_torch.pipeline import masks as tmasks
from robust_cvd_tpu_torch.solver import constraints as tC
from robust_cvd_tpu_torch.utils import visualization as tvis

H, W = 48, 64


def rigid_points(rng, n, outliers=0.0):
    """n correspondences of a small rotation, translation and perspective,
    with a share of them moved at random."""
    p0 = rng.uniform(0, [W, H], (n, 2))
    Hm = np.array([[1.01, 0.02, 3.0], [-0.015, 0.99, -1.5], [2e-4, -1e-4, 1.0]])
    p1 = jhg._apply_h(Hm[None], p0[None])[0] + rng.normal(0, 0.05, (n, 2))
    k = int(outliers * n)
    p1[:k] += rng.uniform(-20, 20, (k, 2))
    return p0, p1


def moving_block_flow(rng, dx=-2.0, block=(16, 28, 24, 40), move=(6.0, 3.0)):
    """A rigid pan of dx px with a block moving by `move` on top of it. The
    block covers 6% of the frame: where it covers more than a tenth, a
    fundamental matrix explains the pan and the block together, and motion
    segmentation prefers it to the homography."""
    flow = np.zeros((H, W, 2), np.float32)
    flow[..., 0] = dx
    flow += rng.normal(0, 0.05, flow.shape).astype(np.float32)
    y0, y1, x0, x1 = block
    flow[y0:y1, x0:x1] += np.asarray(move, np.float32)
    return flow


def test_sampson_and_eight_point_identical():
    rng = np.random.default_rng(0)
    p0, p1 = rigid_points(rng, 200)
    sel = rng.integers(0, 200, (16, 8))
    F_t = tep._eight_point(p0[sel], p1[sel])
    np.testing.assert_array_equal(F_t, jep._eight_point(p0[sel], p1[sel]))
    F_all = tep._eight_point(p0, p1)  # the tall refit path
    np.testing.assert_array_equal(F_all, jep._eight_point(p0, p1))
    np.testing.assert_array_equal(
        tep.sampson_distance(F_t, np.broadcast_to(p0, (16, 200, 2)),
                             np.broadcast_to(p1, (16, 200, 2))),
        jep.sampson_distance(F_t, np.broadcast_to(p0, (16, 200, 2)),
                             np.broadcast_to(p1, (16, 200, 2))))
    E = tep.essential_from_poses(np.eye(3), np.array([0.1, 0.0, 0.02]))
    np.testing.assert_array_equal(E, jep.essential_from_poses(np.eye(3), np.array([0.1, 0.0, 0.02])))


@pytest.mark.parametrize("outliers", [0.0, 0.3])
@pytest.mark.parametrize("seed", [1, 2])
def test_ransac_fits_identical(outliers, seed):
    p0, p1 = rigid_points(np.random.default_rng(seed), 300, outliers)
    for kw in ({}, {"thresh": 1.0, "iters": 64, "seed": 3}):
        F_t = tep.find_fundamental_ransac(p0, p1, **kw)
        assert F_t is not None
        np.testing.assert_array_equal(F_t, jep.find_fundamental_ransac(p0, p1, **kw))
        H_t = thg.find_homography_ransac(p0, p1, **kw)
        assert H_t is not None and H_t.dtype == np.float32
        np.testing.assert_array_equal(H_t, jhg.find_homography_ransac(p0, p1, **kw))
    np.testing.assert_array_equal(thg._apply_h_np(H_t[None], p0[None]),
                                  jhg._apply_h(H_t[None], p0[None]))
    assert tep.find_fundamental_ransac(p0[:7], p1[:7]) is None
    assert thg.find_homography_ransac(p0[:3], p1[:3]) is None


def test_motion_segmentation_identical():
    flow = moving_block_flow(np.random.default_rng(4))
    got = tmasks.motion_segmentation_mask(flow)
    np.testing.assert_array_equal(got, jmasks.motion_segmentation_mask(flow))
    assert got[16:28, 24:40].all() and got.mean() < 0.1  # the block, not the pan
    np.testing.assert_array_equal(tmasks._dilate(got, 3), jmasks._dilate(got, 3))
    zero = np.zeros((H, W, 2), np.float32)
    assert not tmasks.motion_segmentation_mask(zero).any()


def _mask_store(base, rng):
    """5 frames of color_down with consecutive flows (a pan, a moving block
    in frames 1-2, frame 4's backward flow missing)."""
    os.makedirs(os.path.join(base, "color_down"))
    for i in range(5):
        raw.save_raw_float32_image(os.path.join(base, "color_down", frame_name(i, ".raw")),
                                   rng.uniform(0, 1, (H, W, 3)).astype(np.float32))
    save_frames_txt(os.path.join(base, "frames.txt"), W, H, [i / 30 for i in range(5)])
    store = VideoStore.open(base)
    for i in range(4):
        move = (6.0, 3.0) if i in (1, 2) else (0.0, 0.0)
        store.save_flow(i, i + 1, moving_block_flow(rng, move=move))
        if i < 3:
            store.save_flow(i + 1, i, moving_block_flow(rng, dx=2.0, move=move))


def test_compute_dynamic_masks_identical(tmp_path):
    from robust_cvd_tpu.io.store import VideoStore as JStore

    tbase, jbase = str(tmp_path / "t"), str(tmp_path / "j")
    _mask_store(tbase, np.random.default_rng(5))
    _mask_store(jbase, np.random.default_rng(5))
    assert tmasks.compute_dynamic_masks(VideoStore.open(tbase))
    assert jmasks.compute_dynamic_masks(JStore.open(jbase))
    names = sorted(os.listdir(os.path.join(tbase, "dynamic_mask")))
    assert names == [frame_name(i, ".png") for i in range(5)]
    for name in names:
        a = open(os.path.join(tbase, "dynamic_mask", name), "rb").read()
        assert a == open(os.path.join(jbase, "dynamic_mask", name), "rb").read(), name
    dyn = VideoStore.open(tbase).load_dynamic_mask()
    assert (dyn[1] == 0).any() and (dyn[0] == 255).all()  # frame 1's block is moving
    # existing masks are kept
    mtime = os.path.getmtime(os.path.join(tbase, "dynamic_mask", names[0]))
    tmasks.compute_dynamic_masks(VideoStore.open(tbase))
    assert os.path.getmtime(os.path.join(tbase, "dynamic_mask", names[0])) == mtime


def test_ransac_static_flags_identical():
    rng = np.random.default_rng(6)
    keys = [(0, 1), (1, 0), (1, 2), (2, 3)]
    pairs_t, pairs_j = {}, {}
    for n, key in zip((120, 60, 5, 90), keys):
        p0, p1 = rigid_points(rng, n, outliers=0.2)
        loc0, loc1 = (p / W for p in (p0, p1))
        pairs_t[key] = tC.PairConstraints(loc0, loc1, np.zeros(n, bool))
        pairs_j[key] = jC.PairConstraints(loc0, loc1, np.zeros(n, bool))
    tep.set_static_flags_from_ransac(keys, pairs_t, (H, W), H / W)
    jep.set_static_flags_from_ransac(keys, pairs_j, (H, W), H / W)
    for key in keys:
        np.testing.assert_array_equal(pairs_t[key].is_static, pairs_j[key].is_static)
    assert pairs_t[(1, 2)].is_static.all()  # fewer than 8: all static
    assert 0.6 < pairs_t[(0, 1)].is_static.mean() < 0.95  # the outliers are dynamic


def test_visualizations_identical():
    rng = np.random.default_rng(7)
    flow = rng.normal(0, 3, (H, W, 2)).astype(np.float32)
    for mf in (None, 5.0):
        np.testing.assert_array_equal(tvis.flow_to_image(flow, mf), jvis.flow_to_image(flow, mf))
    depth = rng.uniform(0.5, 20, (H, W)).astype(np.float32)
    depth[3, 4], depth[5, 6] = 0.0, np.inf
    np.testing.assert_array_equal(tvis.visualize_depth(depth), jvis.visualize_depth(depth))
    np.testing.assert_array_equal(tvis.visualize_depth(depth, 1.0, 10.0, "viridis"),
                                  jvis.visualize_depth(depth, 1.0, 10.0, "viridis"))
    sf = rng.normal(0, 1, (H, W, 3)).astype(np.float32)
    np.testing.assert_array_equal(tvis.visualize_scene_flow(sf), jvis.visualize_scene_flow(sf))
    mask = rng.uniform(0, 1, (H, W)) > 0.5
    img = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    for im in (img, (img * 255).astype(np.uint8)):
        np.testing.assert_array_equal(tvis.apply_mask(im, mask), jvis.apply_mask(im, mask))
    got = tvis.warp_by_flow(img, flow)
    np.testing.assert_allclose(got, jvis.warp_by_flow(img, flow), atol=1e-5)
    assert got.shape == img.shape and got.dtype == np.float32


def test_visualize_depth_dir_identical(tmp_path):
    rng = np.random.default_rng(8)
    for d in ("t", "j"):
        os.makedirs(tmp_path / d)
    for i in range(2):
        disp = rng.uniform(0.05, 2, (H, W)).astype(np.float32)
        for d in ("t", "j"):
            raw.save_raw_float32_image(str(tmp_path / d / frame_name(i, ".raw")), disp)
    tvis.visualize_depth_dir(str(tmp_path / "t"), str(tmp_path / "t"))
    jvis.visualize_depth_dir(str(tmp_path / "j"), str(tmp_path / "j"))
    for i in range(2):
        name = frame_name(i, ".png")
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()
