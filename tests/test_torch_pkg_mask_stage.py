"""The Mask R-CNN dynamic-mask stage: JAX package vs PyTorch port on the CPU.

A 4-frame clip (color_full and color_down PNG/raw frames of a seeded
texture, 48x64) and one detectron2-layout checkpoint pickle: the Flax
params of tests/test_torch_pkg_mask_rcnn.py with its heads shaped to give
dynamic detections over part of each frame, carried to detectron2 keys by
models/mask_rcnn.py::state_dict_from_jax. Both packages'
compute_dynamic_masks_rcnn run at test_size=64 (the frames resize to
64x85 and pad to 64x96) at float32: the JAX stage builds MaskRCNN() in
bfloat16, so the test patches robust_cvd_tpu.models.mask_rcnn.MaskRCNN
with a float32 partial (a patch inside the test; the JAX package is
unchanged). Its single-device branch runs (4 frames, fewer than the 8
virtual devices, take no mesh).

Held: the same dynamic_mask PNGs (the port at 4 frames a pass and at the
JAX package's 2), at least one dynamic pixel in every frame and not all
of them dynamic, both stages' stats keys; a rerun skips the finished
frames; an unreadable or incomplete checkpoint raises.
"""

import functools
import os
import pickle
import shutil
from os.path import join as pjoin

import jax.numpy as jnp
import numpy as np
import pytest

import robust_cvd_tpu.models.mask_rcnn as JM
from robust_cvd_tpu.io.frames import save_frames_txt
from robust_cvd_tpu.io.store import VideoStore as JStore
from robust_cvd_tpu.pipeline.masks import compute_dynamic_masks_rcnn as jax_stage
from robust_cvd_tpu_torch.io import raw
from robust_cvd_tpu_torch.io.store import VideoStore, frame_name, load_png_gray, save_png_color
from robust_cvd_tpu_torch.models import mask_rcnn as TM
from robust_cvd_tpu_torch.pipeline.masks import compute_dynamic_masks_rcnn, rcnn_test_size
from test_torch_pkg_mask_rcnn import PERSON_BIAS, _flax_params, _shaped
from torch_pkg_threads import one_torch_thread  # noqa: F401  (autouse)

N, H, W = 4, 48, 64
TEST_SIZE = 64
STATS = {"load_convert_s", "weights_h2d_s", "first_dispatch_s", "steady_infer_s"}


def make_clip(base):
    rng = np.random.default_rng(3)
    noise = rng.uniform(0, 1, (H + 2, W + 2 * N + 2, 3)).astype(np.float32)
    tex = sum(noise[dy : dy + H, dx : dx + W + 2 * N] for dy in range(3) for dx in range(3)) / 9
    os.makedirs(pjoin(base, "color_full"))
    os.makedirs(pjoin(base, "color_down"))
    for i in range(N):
        frame = tex[:, 2 * i : 2 * i + W]
        save_png_color(pjoin(base, "color_full", frame_name(i, ".png")), frame)
        raw.save_raw_float32_image(pjoin(base, "color_down", frame_name(i, ".raw")), frame)
    save_frames_txt(pjoin(base, "frames.txt"), W, H, [i / 30 for i in range(N)])


def write_checkpoint(path):
    params = _shaped(_flax_params())
    # a person bias 1 lower than the forward test's: about half the
    # proposals score person above 0.5, and the frames are partly dynamic
    params["box_head"]["cls_score"]["bias"][0] = PERSON_BIAS - 1.0
    sd = TM.state_dict_from_jax(params)
    with open(path, "wb") as f:
        pickle.dump({"model": {k: v.numpy() for k, v in sd.items()}, "__author__": "test"}, f)


def _masks(base):
    return np.stack([load_png_gray(pjoin(base, "dynamic_mask", frame_name(i, ".png")))
                     for i in range(N)])


@pytest.fixture(scope="module")
def stages(tmp_path_factory):
    root = tmp_path_factory.mktemp("mask_stage")
    jbase, tbase = str(root / "jax"), str(root / "torch")
    make_clip(jbase)
    shutil.copytree(jbase, tbase)
    pkl = str(root / "model_final.pkl")
    write_checkpoint(pkl)
    mp = pytest.MonkeyPatch()
    mp.setattr(JM, "MaskRCNN", functools.partial(JM.MaskRCNN, dtype=jnp.float32))
    jstats, tstats = {}, {}
    try:
        jax_stage(JStore.open(jbase), pkl, test_size=TEST_SIZE, stats=jstats)
    finally:
        mp.undo()
    compute_dynamic_masks_rcnn(VideoStore.open(tbase), pkl, test_size=TEST_SIZE,
                               stats=tstats, device="cpu")
    return dict(jbase=jbase, tbase=tbase, pkl=pkl, jstats=jstats, tstats=tstats)


def test_test_size():
    assert rcnn_test_size((H, W), TEST_SIZE) == ((64, 85), (64, 96))
    assert rcnn_test_size((224, 384)) == ((778, 1333), (800, 1344))
    assert rcnn_test_size((1080, 1920)) == ((750, 1333), (768, 1344))


def test_stage_matches_jax(stages):
    j, t = _masks(stages["jbase"]), _masks(stages["tbase"])
    assert set(np.unique(t)) <= {0, 255}
    dynamic = (t == 0).reshape(N, -1).mean(1)
    assert (dynamic > 0).all() and (dynamic < 1).all(), dynamic
    np.testing.assert_array_equal(t, j)


def test_stage_stats(stages, tmp_path, monkeypatch):
    """The JAX stage's stats keys. The port runs its 4 frames in one pass
    (RCNN_FRAMES_PER_PASS), so it has no steady state; at the JAX
    package's 2 frames a pass it has every key, and the same masks."""
    from robust_cvd_tpu_torch.pipeline import masks

    assert set(stages["jstats"]) == STATS
    assert masks.RCNN_FRAMES_PER_PASS >= N
    assert set(stages["tstats"]) == STATS - {"steady_infer_s"}
    base = str(tmp_path / "clip")
    shutil.copytree(stages["tbase"], base)
    shutil.rmtree(pjoin(base, "dynamic_mask"))
    monkeypatch.setattr(masks, "RCNN_FRAMES_PER_PASS", 2)
    stats = {}
    compute_dynamic_masks_rcnn(VideoStore.open(base), stages["pkl"], test_size=TEST_SIZE,
                               stats=stats, device="cpu")
    assert set(stats) == STATS and all(v >= 0 for v in stats.values())
    np.testing.assert_array_equal(_masks(base), _masks(stages["jbase"]))


def test_stage_skips_finished_frames(stages):
    """A rerun writes nothing and runs no frame; a deleted frame is made
    again, equal to the first run's."""
    base = stages["tbase"]
    first = _masks(base)
    path = pjoin(base, "dynamic_mask", frame_name(2, ".png"))
    before = {i: os.path.getmtime(pjoin(base, "dynamic_mask", frame_name(i, ".png")))
              for i in range(N)}
    stats = {}
    assert compute_dynamic_masks_rcnn(VideoStore.open(base), stages["pkl"], test_size=TEST_SIZE,
                                      stats=stats, device="cpu")
    assert "first_dispatch_s" not in stats
    os.remove(path)
    compute_dynamic_masks_rcnn(VideoStore.open(base), stages["pkl"], test_size=TEST_SIZE,
                               device="cpu")
    np.testing.assert_array_equal(_masks(base), first)
    for i in (0, 1, 3):
        assert os.path.getmtime(pjoin(base, "dynamic_mask", frame_name(i, ".png"))) == before[i]


def test_stage_bad_checkpoint_raises(stages, tmp_path):
    base = str(tmp_path / "clip")
    shutil.copytree(stages["tbase"], base)
    shutil.rmtree(pjoin(base, "dynamic_mask"))
    empty = tmp_path / "empty.pkl"
    empty.write_bytes(b"")
    with pytest.raises(EOFError):
        compute_dynamic_masks_rcnn(VideoStore.open(base), str(empty), device="cpu")
    with open(tmp_path / "partial.pkl", "wb") as f:
        pickle.dump({"model": {"backbone.fpn_lateral2.bias": np.zeros(256, np.float32)}}, f)
    with pytest.raises(KeyError):
        compute_dynamic_masks_rcnn(VideoStore.open(base), str(tmp_path / "partial.pkl"),
                                   device="cpu")
    assert not os.path.exists(pjoin(base, "dynamic_mask"))
