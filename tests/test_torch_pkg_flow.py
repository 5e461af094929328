"""The flow stage of the PyTorch port against the JAX package's.

Pieces (the antialiased resize, the post-process, the consistency masks,
the copied video stage and PNG colour I/O) on numpy-seeded inputs, float32
on the CPU; then FlowStage end to end on one 8-frame clip (color_flow
48x64, color_down 24x32, pairs in chunks of 2, RAFT float32 with 2
iterations and the same Flax-initialised weights, homography on) against
the JAX FlowStage on a copy of the same store, on one device. Tolerances:
resizes and the post-process 1e-5 of the largest value (float32 summation
order; 5e-5 for align_corners=True, whose JAX weights come from
float64); masks of identical inputs exactly; flows of the whole stage 1e-3
px (they differ by ~5e-5 px, registration and RAFT summing in other
orders), their masks in at most 0.5% of pixels (a flip needs a pixel
within that distance of a threshold) and mask ratios within 0.005.
"""

import json
import os
import shutil
from os.path import join as pjoin

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robust_cvd_tpu.io import store as jstore
from robust_cvd_tpu.io.frames import save_frames_txt
from robust_cvd_tpu.models import raft as jr
from robust_cvd_tpu.models.layers import resize_bilinear as j_resize
from robust_cvd_tpu.pipeline import flow as jflow
from robust_cvd_tpu.pipeline.video import VideoStage as JVideoStage
from robust_cvd_tpu_torch.io import store as tstore
from robust_cvd_tpu_torch.models import raft as tr
from robust_cvd_tpu_torch.models.layers import resize_bilinear
from robust_cvd_tpu_torch.pipeline import flow as tflow
from robust_cvd_tpu_torch.pipeline.video import VideoStage

N, H, W, SHIFT = 8, 48, 64, 2


@pytest.mark.parametrize("shape", [
    ((256, 384), (224, 384)),  # the flow stage's shrink
    ((16, 24), (8, 12)), ((10, 20), (17, 7)), ((7, 9), (3, 4)), ((8, 12), (16, 24)),
])
@pytest.mark.parametrize("align_corners", [False, True])
def test_resize_bilinear_matches_jax(shape, align_corners):
    (h, w), (oh, ow) = shape
    x = np.random.default_rng(0).normal(0, 1, (2, h, w, 3)).astype(np.float32)
    want = np.asarray(j_resize(jnp.asarray(x), (oh, ow), align_corners))
    got = resize_bilinear(torch.from_numpy(x).permute(0, 3, 1, 2), (oh, ow), align_corners)
    # align_corners=True: the JAX package's interpolation weights come from
    # float64 sample positions, torch's from float32 ones (measured 2.5e-5)
    tol = 5e-5 if align_corners else 1e-5
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=tol * np.abs(want).max())


def test_resize_flow_matches_jax():
    flow = np.random.default_rng(1).normal(0, 3, (20, 30, 2)).astype(np.float32)
    for out in ((10, 15), (20, 30), (33, 41)):
        np.testing.assert_allclose(tflow.resize_flow(flow, out), jflow.resize_flow(flow, out),
                                   atol=1e-5 * np.abs(flow).max())


@pytest.mark.parametrize("use_h", [True, False])
def test_postproc_matches_jax(use_h):
    rng = np.random.default_rng(2)
    flows = rng.uniform(-3, 3, (2, 16, 24, 2)).astype(np.float32)
    Hs = np.stack([np.eye(3, dtype=np.float32),
                   np.array([[1.02, 0.01, 0.5], [-0.01, 0.98, -0.3], [1e-4, -1e-4, 1.0]],
                            np.float32)])
    want = np.asarray(jflow._postproc_fn()(jnp.asarray(flows), jnp.asarray(Hs), (14, 12), use_h))
    got = tflow._postproc(torch.from_numpy(flows), torch.from_numpy(Hs), (14, 12), use_h).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


def test_masks_match_jax():
    """Random flows and colours, both thresholds binding: the batched masks,
    the per-pair wrapper and the clip program with colours gathered by
    frame index are the JAX package's bit for bit."""
    rng = np.random.default_rng(3)
    B, h, w = 3, 12, 18
    c0, c1 = (rng.uniform(0, 1, (B, h, w, 3)).astype(np.float32) for _ in range(2))
    f01 = rng.uniform(-3, 3, (B, h, w, 2)).astype(np.float32)
    f10 = (-f01 + rng.normal(0, 0.6, f01.shape)).astype(np.float32)
    c1 = (c0 + rng.normal(0, 0.4, c0.shape)).astype(np.float32)
    want = jflow.consistent_flow_masks_batched(f01, f10, c0, c1)
    got = tflow.consistent_flow_masks_batched(f01, f10, c0, c1)
    for a, b in zip(got, want):
        assert a.dtype == bool and 0.05 < a.mean() < 0.95
        np.testing.assert_array_equal(a, np.asarray(b))
    for a, b in zip(tflow.consistent_flow_masks(f01[1], f10[1], c0[1], c1[1], 0.5, 0.7),
                    jflow.consistent_flow_masks(f01[1], f10[1], c0[1], c1[1], 0.5, 0.7)):
        np.testing.assert_array_equal(a, np.asarray(b))
    colors = np.concatenate([c0, c1])
    ii, jj = np.array([0, 4, 2]), np.array([3, 1, 5])
    want = jflow.clip_masks_np(jnp.asarray(colors), jnp.asarray(f01), jnp.asarray(f10),
                               jnp.asarray(ii), jnp.asarray(jj), 1.0, 1.0)
    got = tflow.clip_masks(torch.from_numpy(colors), torch.from_numpy(f01),
                           torch.from_numpy(f10), torch.from_numpy(ii), torch.from_numpy(jj),
                           1.0, 1.0)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b)
    np.testing.assert_array_equal(
        tflow.consistency_mask(c0[0], c1[0], f01[0], 0.3),
        jflow.consistency_mask(c0[0], c1[0], f01[0], 0.3))


def make_clip(base):
    """N frames of a panning texture as color_full PNGs, SHIFT px a frame."""
    rng = np.random.default_rng(4)
    noise = rng.uniform(0, 1, (H + 2, W + SHIFT * N + 2, 3)).astype(np.float32)
    tex = sum(noise[dy:dy + H, dx:dx + W + SHIFT * N]
              for dy in range(3) for dx in range(3)) / 9.0
    os.makedirs(pjoin(base, "color_full"))
    for i in range(N):
        jstore.save_png_color(pjoin(base, "color_full", jstore.frame_name(i, ".png")),
                              tex[:, SHIFT * i:SHIFT * i + W])
    save_frames_txt(pjoin(base, "frames.txt"), W, H, [i / 30 for i in range(N)])


@pytest.fixture(scope="module")
def stages(tmp_path_factory):
    """The same clip through both video stages and both FlowStages."""
    root = tmp_path_factory.mktemp("flow")
    jbase, tbase = str(root / "jax"), str(root / "torch")
    make_clip(jbase)
    shutil.copytree(jbase, tbase)
    for base, stage in ((jbase, JVideoStage(jbase)), (tbase, VideoStage(tbase))):
        stage.downscale_frames("color_down", 32, ".raw", align=8)
        stage.downscale_frames("color_flow", 64, ".png", align=8)

    model = jr.RAFT(iters=2, dtype=jnp.float32)
    variables = jax.tree.map(np.asarray, model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)), jnp.zeros((1, H, W, 3))))
    js = jstore.VideoStore.open(jbase)
    real = jax.devices()
    mp = pytest.MonkeyPatch()
    mp.setattr(jax, "devices", lambda backend=None: real[:1])
    try:
        jstage = jflow.FlowStage(js, raft_model=model, raft_variables=variables, batch_size=2)
        pairs = jstage.sample_index_pairs(("hierarchical2",), N)
        jstage.compute_flow(pairs)
        jstage.compute_flow_masks(pairs)
        jentries = jstage.compute_flow_pair_stats(pairs)
    finally:
        mp.undo()

    ts = tstore.VideoStore.open(tbase)
    net = tr.RAFT(iters=2, dtype=torch.float32)
    tstage = tflow.FlowStage(ts, net, tr.state_dict_from_jax(
        variables["params"], variables["batch_stats"]), batch_size=2, device="cpu")
    assert tstage.sample_index_pairs(("hierarchical2",), N) == pairs
    tstage.compute_flow(pairs)
    tstage.compute_flow_masks(pairs)
    tentries = tstage.compute_flow_pair_stats(pairs)
    return pairs, (jbase, js, jentries), (tbase, ts, tentries, tstage)


def test_video_stage_matches_jax(stages):
    _, (jbase, _, _), (tbase, _, _, _) = stages
    for sub, ext, shape in (("color_down", ".raw", (24, 32)), ("color_flow", ".png", (48, 64))):
        for i in range(N):
            name = jstore.frame_name(i, ext)
            with open(pjoin(jbase, sub, name), "rb") as a, open(pjoin(tbase, sub, name), "rb") as b:
                assert a.read() == b.read(), (sub, i)
    assert tstore.load_png_color(pjoin(tbase, "color_flow", "frame_000000.png")).shape == (48, 64, 3)


def test_flow_stage_matches_jax(stages):
    pairs, (jbase, js, jentries), (tbase, ts, tentries, _) = stages
    assert len(pairs) == 30 and ts.flow_pairs() == sorted(pairs) == js.flow_pairs()
    worst_flow, worst_mask = 0.0, 0.0
    for p in pairs:
        a, b = ts.load_flow(*p), js.load_flow(*p)
        assert a.shape == (24, 32, 2)
        worst_flow = max(worst_flow, np.abs(a - b).max())
        worst_mask = max(worst_mask, np.mean(ts.load_flow_mask(*p) != js.load_flow_mask(*p)))
    assert worst_flow <= 1e-3, worst_flow
    assert worst_mask <= 0.005, worst_mask
    got = json.load(open(pjoin(tbase, "flow_list.json")))
    want = json.load(open(pjoin(jbase, "flow_list.json")))
    assert got[0] == want[0] and [r[:2] for r in got] == [r[:2] for r in want]
    np.testing.assert_allclose([r[2] for r in got[1:]], [r[2] for r in want[1:]], atol=0.005)
    assert [e[:2] for e in tentries] == [e[:2] for e in jentries]
    # the masks are not vacuous: registration explains the panning
    assert 0.2 < np.mean([e[2] for e in tentries]) < 0.95


def test_flow_stage_records_homographies(stages):
    pairs, _, (_, _, _, tstage) = stages
    for (i, j) in pairs:
        H_BA = tstage.homographies[(i, j)]
        # frame j is frame i moved SHIFT*(j - i) px to the left
        np.testing.assert_allclose(H_BA[:2, 2], [SHIFT * (j - i), 0.0], atol=0.05)


def test_stale_resolution_flow_recomputed(stages, tmp_path):
    """A flow file at another resolution does not count as computed."""
    _, _, (tbase, _, _, _) = stages
    base = str(tmp_path / "clip")
    shutil.copytree(tbase, base, ignore=shutil.ignore_patterns("flow", "flow_mask"))
    store = tstore.VideoStore.open(base)
    store.save_flow(0, 1, np.zeros((24, 32, 2), np.float32))
    store.save_flow(1, 0, np.zeros((48, 64, 2), np.float32))
    stage = tflow.FlowStage(store, None, device="cpu")
    with pytest.raises(RuntimeError, match="RAFT model required"):
        stage.compute_flow([(0, 1), (1, 0)])
    stage.compute_flow([(0, 1)])
    with pytest.raises(NotImplementedError):
        stage.visualize_flow([(0, 1)])


def test_png_color_io_matches_jax(tmp_path):
    img = np.random.default_rng(5).uniform(0, 1, (9, 11, 3)).astype(np.float32)
    tstore.save_png_color(str(tmp_path / "t.png"), img)
    jstore.save_png_color(str(tmp_path / "j.png"), img)
    assert (tmp_path / "t.png").read_bytes() == (tmp_path / "j.png").read_bytes()
    np.testing.assert_array_equal(tstore.load_png_color(str(tmp_path / "j.png")),
                                  jstore.load_png_color(str(tmp_path / "j.png")))
    os.makedirs(tmp_path / "color_full")
    for i in range(2):
        tstore.save_png_color(str(tmp_path / "color_full" / f"frame_{i:06d}.png"), img)
    save_frames_txt(str(tmp_path / "frames.txt"), 11, 9, [0.0, 0.1])
    full = tstore.VideoStore.open(str(tmp_path)).load_color_full()
    np.testing.assert_array_equal(
        full, jstore.VideoStore.open(str(tmp_path)).load_color_full())
