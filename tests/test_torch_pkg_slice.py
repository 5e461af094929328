"""The pose-stage slice end to end: JAX package vs PyTorch port on the CPU.

A tiny synthetic clip (6 frames at 32x64, a seeded texture panning 1 px per
frame, hierarchical2 pairs, exact flows, in-bounds consistency masks) goes
through both packages' compute_initial_depth (the small MiDaS net, same
weights) and PoseOptimizer(...).optimize_poses(), each on its own copy of
the clip directory. Depth within 1e-4 relative; equal constraint counts and
byte-identical flow_constraints.dat; poses within 1e-3. The JAX side runs
its single-device path (the test suite's virtual 8-device mesh would shard
the solve), so both packages sum in comparable orders.
"""

import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from robust_cvd_tpu import config as jconfig
from robust_cvd_tpu.models import midas as jm
from robust_cvd_tpu.parallel import mesh as jmesh
from robust_cvd_tpu.io.store import VideoStore as JStore
from robust_cvd_tpu.pipeline.depth import compute_initial_depth as j_depth
from robust_cvd_tpu.pipeline.pose import PoseOptimizer as JPose
from robust_cvd_tpu_torch import config as tconfig
from robust_cvd_tpu_torch.io import raw
from robust_cvd_tpu_torch.io.frames import save_frames_txt
from robust_cvd_tpu_torch.io.store import VideoStore as TStore, frame_name
from robust_cvd_tpu_torch.models import midas as tm
from robust_cvd_tpu_torch.pipeline.depth import compute_initial_depth as t_depth
from robust_cvd_tpu_torch.pipeline.pose import PoseOptimizer as TPose
from robust_cvd_tpu_torch.utils.frame_sampling import sample_pairs

N, H, W = 6, 32, 64
OPT = dict(num_steps=2, ctf_long=3, ctf_short=2, lm_max_outer=4, lm_cg_iters=8)


def make_clip(base):
    rng = np.random.default_rng(0)
    tex = rng.uniform(0, 1, (H, W + N, 3)).astype(np.float32)
    os.makedirs(os.path.join(base, "color_down"))
    for i in range(N):
        raw.save_raw_float32_image(
            os.path.join(base, "color_down", frame_name(i, ".raw")), tex[:, i : i + W]
        )
    save_frames_txt(os.path.join(base, "frames.txt"), W, H, [i / 30 for i in range(N)])
    store = TStore.open(base)
    xs = np.arange(W)
    entries = []
    for i, j in sample_pairs(N, ("hierarchical2",), two_way=True):
        flow = np.zeros((H, W, 2), np.float32)
        flow[..., 0] = i - j
        mask = np.broadcast_to((xs + i - j >= 0) & (xs + i - j < W), (H, W))
        store.save_flow(i, j, flow)
        store.save_flow_mask(i, j, mask)
        entries.append((i, j, float(mask.mean())))
    store.save_flow_list(entries)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("clip"))
    make_clip(base)
    jdir, tdir = base + "_jax", base + "_torch"
    shutil.copytree(base, jdir)
    shutil.copytree(base, tdir)

    fnet = jm.MidasNet(features=32, backbone_layers=(1, 1, 1, 1), dtype=jnp.float32)
    variables = jax.jit(fnet.init)(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)))
    params = jax.tree.map(np.asarray, variables["params"])
    stats = jax.tree.map(np.asarray, variables["batch_stats"])
    params["output_conv3"]["bias"] = np.full((1,), 1.0, np.float32)
    adapter = jm.MidasV2Adapter(params=params, batch_stats=stats)
    adapter.net = fnet
    tnet = tm.MidasNet(features=32, backbone_layers=(1, 1, 1, 1))
    tnet.load_state_dict(tm.state_dict_from_jax(params, stats))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmesh, "pipeline_mesh", lambda *a, **k: None)
        jstore = JStore.open(jdir)
        jd = j_depth(jstore, adapter, "midas2")
        jcfg = jconfig.PipelineConfig(path=jdir, opt=jconfig.PoseOptParams(**OPT))
        jpose = JPose(jcfg, jstore, "depth_midas2")
        jsp = jpose.optimize_poses()

    tstore = TStore.open(tdir)
    td = t_depth(tstore, tm.MidasV2Adapter(tnet), "midas2", device="cpu")
    tcfg = tconfig.PipelineConfig(path=tdir, opt=tconfig.PoseOptParams(**OPT))
    tpose = TPose(tcfg, tstore, "depth_midas2", device="cpu")
    tsp = tpose.optimize_poses()
    return dict(jdir=jdir, tdir=tdir, jd=jd, td=td, jpose=jpose, tpose=tpose,
                jsp=jsp, tsp=tsp, tcfg=tcfg, tstore=tstore)


def test_initial_depth(runs):
    jd, td = runs["jd"], runs["td"]
    assert td.shape == (N, H, W) and np.isfinite(td).all()
    np.testing.assert_allclose(td, jd, rtol=1e-4)
    # the saved stream reloads to the same depth in both packages
    np.testing.assert_allclose(
        TStore.open(runs["tdir"]).load_depth_stream("depth_midas2"),
        JStore.open(runs["jdir"]).load_depth_stream("depth_midas2"), rtol=1e-4,
    )


def test_constraints(runs):
    jp, tp = runs["jpose"], runs["tpose"]
    assert tp.pair_keys == jp.pair_keys and tp.triplet_keys == jp.triplet_keys
    assert [len(tp.pairs[k].loc0) for k in tp.pair_keys] == [
        len(jp.pairs[k].loc0) for k in jp.pair_keys
    ]
    assert [len(tp.triplets[t].loc) for t in tp.triplet_keys] == [
        len(jp.triplets[t].loc) for t in jp.triplet_keys
    ]
    with open(os.path.join(runs["jdir"], "flow_constraints.dat"), "rb") as f:
        jbytes = f.read()
    with open(os.path.join(runs["tdir"], "flow_constraints.dat"), "rb") as f:
        assert f.read() == jbytes


def test_poses(runs):
    jsp, tsp = runs["jsp"], runs["tsp"]
    assert tuple(tsp.depth_grid.shape) == tuple(jsp.depth_grid.shape)
    np.testing.assert_allclose(tsp.pose.numpy(), np.asarray(jsp.pose), atol=1e-3)
    log = runs["tpose"].solve_log
    assert [e["stage"] for e in log] == ["normalize", "step0", "step1"]
    assert all(e["cost"] < e["cost0"] for e in log)


def test_constraint_cache_is_reused(runs, monkeypatch):
    def recompute(*a):
        raise AssertionError("flow_constraints.dat was not reused")

    monkeypatch.setattr(TPose, "_compute_constraints", recompute)
    again = TPose(runs["tcfg"], TStore.open(runs["tdir"]), "depth_midas2", device="cpu")
    for k in again.pair_keys:
        np.testing.assert_array_equal(again.pairs[k].loc0, runs["tpose"].pairs[k].loc0)


def test_unported_paths_raise(runs, tmp_path):
    tpose = runs["tpose"]
    tpose.save()  # writes video.dat of the solved clip
    from robust_cvd_tpu_torch.io.video_dat import load_video_dat

    vd = load_video_dat(os.path.join(runs["tdir"], "video.dat"))
    assert [s.name for s in vd.depth_streams] == ["depth_midas2"]
    with pytest.raises(NotImplementedError):
        tpose.filter_depth(4)
    # dynamic_constraints="Ransac" now runs: the flags of a rigid pan are
    # those of the JAX package (tests/test_torch_pkg_masks.py) and mostly
    # static
    cfg = dataclasses.replace(
        runs["tcfg"], opt=tconfig.PoseOptParams(dynamic_constraints="Ransac")
    )
    ransac = TPose(cfg, runs["tstore"], "depth_midas2", device="cpu")
    for k in ransac.pair_keys:
        flags = ransac.pairs[k].is_static
        assert flags.dtype == bool and len(flags) == len(ransac.pairs[k].loc0)
    assert np.mean(np.concatenate([ransac.pairs[k].is_static for k in ransac.pair_keys])) > 0.9
    # a depth_gt/ directory is imported as a stream ahead of the estimated
    # one (tests/test_torch_pkg_importers.py holds the importers)
    gt = str(tmp_path / "clip")
    shutil.copytree(runs["tdir"], gt)
    os.makedirs(os.path.join(gt, "depth_gt"))
    imported = TPose(runs["tcfg"], TStore.open(gt), "depth_midas2", device="cpu")
    assert [s.name for s in imported.streams] == ["depth_gt", "depth_midas2"]
    assert imported.initial_camera is None
