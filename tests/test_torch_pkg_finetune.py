"""The fine-tune slice end to end: JAX package vs PyTorch port on the CPU.

The 6-frame 32x64 synthetic clip of tests/test_torch_pkg_slice.py (a seeded
texture panning 1 px per frame, hierarchical2 pairs, exact flows, in-bounds
consistency masks) goes through both packages' compute_initial_depth and
DatasetProcessor.fine_tune, each on its own copy of the clip directory:
the small MiDaS net with the same weights (the port's seeded_init_, carried
to Flax by convert_midas_v2), num_epochs=2, batch_size=2 and the small
solver schedule OPT, with an intermediate depth stream saved every epoch.
The JAX side runs its single-device path (pipeline_mesh patched to None);
the port also saves a checkpoint every epoch.

The learning rate is the MiDaS adapter's default, 1e-6. At 1e-4, two
epochs on random weights are chaotic: on the port alone, a 1e-7 relative
perturbation of the initial weights moved the fine-tuned depth by up to
9.4e-3 and the poses by 1.7e-3 (Flax-initialised weights), or the depth by
6.6e-4 (these weights), so no two float32 implementations could be held
at 1e-3. At 1e-6 the same perturbation moved depth by 7e-7 and poses by
5.7e-6.

Held: per-epoch mean losses within 1e-3 relative; the same depth streams
(depth_e0000, then per epoch depth_e%04d_opt and the next epoch's stream),
each within 1e-3 relative, the last one holding the final refresh; the
poses after the last warm solve within 1e-3; video.dat parses to the same
streams and frames, with intrinsics, poses and transform parameters within
1e-4 (pose floats may differ in the last bits, so the file is not held
byte for byte); one checkpoint per epoch with the step count so far.
"""

import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest

from robust_cvd_tpu import config as jconfig
from robust_cvd_tpu.io.store import VideoStore as JStore
from robust_cvd_tpu.models import midas as jm
from robust_cvd_tpu.models.torch_port import convert_midas_v2
from robust_cvd_tpu.parallel import mesh as jmesh
from robust_cvd_tpu.pipeline.depth import compute_initial_depth as j_depth
from robust_cvd_tpu.pipeline.process import DatasetProcessor as JProcessor
from robust_cvd_tpu_torch import config as tconfig
from robust_cvd_tpu_torch.io import raw
from robust_cvd_tpu_torch.io.store import VideoStore as TStore
from robust_cvd_tpu_torch.io.video_dat import load_video_dat
from robust_cvd_tpu_torch.models import midas as tm
from robust_cvd_tpu_torch.pipeline.depth import compute_initial_depth as t_depth
from robust_cvd_tpu_torch.pipeline.process import DatasetProcessor as TProcessor
from test_torch_pkg_slice import H, N, OPT, W, make_clip

FT = dict(num_epochs=2, batch_size=2, learning_rate=1e-6, save_tensorboard=False,
          save_intermediate_depth_streams_freq=1)
STREAMS = ["depth_midas2", "e0000", "e0000_opt", "e0001", "e0001_opt"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("ftclip"))
    make_clip(base)
    jdir, tdir = base + "_jax", base + "_torch"
    shutil.copytree(base, jdir)
    shutil.copytree(base, tdir)

    tnet = tm.seeded_init_(tm.MidasNet(features=32, backbone_layers=(1, 1, 1, 1)), 0)
    params, stats = convert_midas_v2(tnet.state_dict())
    adapter = jm.MidasV2Adapter(params=params, batch_stats=stats)
    adapter.net = jm.MidasNet(features=32, backbone_layers=(1, 1, 1, 1), dtype=jnp.float32)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmesh, "pipeline_mesh", lambda *a, **k: None)
        jstore = JStore.open(jdir)
        jd = j_depth(jstore, adapter, "midas2")
        jcfg = jconfig.PipelineConfig(
            path=jdir, opt=jconfig.PoseOptParams(**OPT), ft=jconfig.FineTuneParams(**FT)
        )
        jtuner = JProcessor(jcfg, models={"depth": adapter}).fine_tune(jstore, jd)

    tstore = TStore.open(tdir)
    tadapter = tm.MidasV2Adapter(tnet)
    td = t_depth(tstore, tadapter, "midas2", device="cpu")
    tcfg = tconfig.PipelineConfig(
        path=tdir, opt=tconfig.PoseOptParams(**OPT),
        ft=tconfig.FineTuneParams(**FT, save_checkpoints=True),
    )
    tproc = TProcessor(tcfg, models={"depth": tadapter}, device="cpu")
    ttuner = tproc.fine_tune(tstore, td)
    return dict(jdir=jdir, tdir=tdir, jtuner=jtuner, ttuner=ttuner, tproc=tproc,
                tstore=tstore, tcfg=tcfg)


def test_epoch_losses(runs):
    jl = [h["loss"] for h in runs["jtuner"].history]
    tl = [h["loss"] for h in runs["ttuner"].history]
    assert len(tl) == len(jl) == 2 and np.isfinite(tl).all()
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    assert all(h["skipped"] == 0 for h in runs["ttuner"].history)
    assert set(runs["ttuner"].stats) == set(runs["jtuner"].stats)


def _stream(path):
    return np.stack([
        raw.load_raw_float32_image(os.path.join(path, "depth", f"frame_{i:06d}.raw"))
        for i in range(N)
    ])


def test_depth_streams(runs):
    jtuner, ttuner = runs["jtuner"], runs["ttuner"]
    assert os.path.relpath(ttuner.out_dir, runs["tdir"]) == os.path.relpath(
        jtuner.out_dir, runs["jdir"])
    assert [s.name for s in ttuner.pose.streams] == [s.name for s in jtuner.pose.streams]
    assert [s.name for s in ttuner.pose.streams] == STREAMS
    for ts, js in zip(ttuner.pose.streams[1:], jtuner.pose.streams[1:]):
        assert os.path.relpath(ts.dir, ttuner.out_dir) == "depth_" + ts.name
        assert os.path.relpath(ts.dir, ttuner.out_dir) == os.path.relpath(js.dir, jtuner.out_dir)
        got = _stream(ts.dir)
        assert np.isfinite(got).all(), ts.name
        np.testing.assert_allclose(got, _stream(js.dir), rtol=1e-3, err_msg=ts.name)
    np.testing.assert_allclose(_stream(ttuner.pose.streams[-1].dir),
                               raw.depth_to_disparity(ttuner.current_depth.numpy()), rtol=1e-6)


def test_poses_after_the_last_warm_solve(runs):
    jsp, tsp = runs["jtuner"].solver_params, runs["ttuner"].solver_params
    np.testing.assert_allclose(tsp.pose.numpy(), np.asarray(jsp.pose), atol=1e-3)
    log = runs["ttuner"].solve_log
    assert [e["stage"] for e in log] == ["normalize", "step0", "step1", "warm", "warm"]
    assert all(e["cost"] < e["cost0"] for e in log[:3])
    assert all(e["cost"] <= e["cost0"] for e in log[3:])


def test_video_dat(runs):
    jv = load_video_dat(os.path.join(runs["jdir"], "video.dat"))
    tv = load_video_dat(os.path.join(runs["tdir"], "video.dat"))
    assert [(s.name, s.dir, s.width, s.height) for s in tv.depth_streams] == [
        (s.name, s.dir, s.width, s.height) for s in jv.depth_streams
    ]
    assert [s.name for s in tv.depth_streams] == STREAMS
    assert (tv.pts, tv.width, tv.height) == (jv.pts, jv.width, jv.height)
    for ts, js in zip(tv.depth_streams, jv.depth_streams):
        assert (ts.depth_desc, ts.spatial_desc) == (js.depth_desc, js.spatial_desc)
        for tf, jf in zip(ts.frames, js.frames):
            np.testing.assert_allclose([tf.vfov, tf.hfov], [jf.vfov, jf.hfov], atol=1e-4)
            np.testing.assert_allclose(tf.position + tf.quaternion,
                                       jf.position + jf.quaternion, atol=1e-4)
            np.testing.assert_allclose(tf.depth_params, jf.depth_params, atol=1e-4)
            np.testing.assert_allclose(tf.spatial_params, jf.spatial_params, atol=1e-4)


def test_checkpoint_round_trip(runs, tmp_path):
    tuner = runs["ttuner"]
    opt = tuner.optimizer
    tuner.save_checkpoint(str(tmp_path), 2)
    saved = [t.clone() for t in (opt.flat, opt.mu, opt.nu, opt.count)]
    for t in (opt.flat, opt.mu, opt.nu):
        t.add_(1.0)
    tuner.load_checkpoint(str(tmp_path), 2)
    for a, b in zip((opt.flat, opt.mu, opt.nu, opt.count), saved):
        assert a.data_ptr() != b.data_ptr() and a.equal(b)


def test_checkpoints_per_epoch(runs):
    import torch

    tuner = runs["ttuner"]
    ckpt_dir = os.path.join(tuner.out_dir, "checkpoints")
    assert sorted(os.listdir(ckpt_dir)) == ["0001.pth", "0002.pth"]
    steps = np.cumsum([h["steps"] for h in tuner.history])
    for epoch, want in zip((1, 2), steps):
        ck = torch.load(os.path.join(ckpt_dir, f"{epoch:04d}.pth"), weights_only=True)
        assert int(ck["count"]) == want


def test_unported_fine_tune_paths_raise(runs):
    import dataclasses

    from robust_cvd_tpu_torch.training.fine_tune import FineTuner

    tuner, cfg = runs["ttuner"], runs["tcfg"]

    def ft(**kw):
        return dataclasses.replace(cfg, ft=dataclasses.replace(cfg.ft, **kw))

    for c in (ft(optimizer="RAdam"), ft(optimizer_mu_bf16=True),
              dataclasses.replace(cfg, post_filter=True)):
        with pytest.raises(NotImplementedError):
            FineTuner(c, tuner.adapter, tuner.clip, tuner.pose_inputs, device="cpu")
    # validation and recon=colmap are ported (tests/test_torch_pkg_validation.py);
    # recon=colmap needs the COLMAP poses, as in the JAX package
    FineTuner(ft(val_epoch_freq=1), tuner.adapter, tuner.clip, tuner.pose_inputs, device="cpu")
    with pytest.raises(ValueError, match="pose_state_override"):
        FineTuner(dataclasses.replace(cfg, recon="colmap"), tuner.adapter, tuner.clip,
                  tuner.pose_inputs, device="cpu")
    with pytest.raises(NotImplementedError):
        FineTuner(cfg, tuner.adapter, tuner.clip, tuner.pose_inputs, mesh=object(),
                  device="cpu")
    # pipeline() now runs: on a copy of the clip given colour frames, every
    # stage before fine-tuning reuses the clip's outputs (no RAFT needed)
    base = runs["tdir"] + "_pipeline"
    shutil.copytree(runs["tdir"], base)
    from robust_cvd_tpu_torch.io.store import frame_name, save_png_color

    os.makedirs(os.path.join(base, "color_full"))
    for i, frame in enumerate(runs["tstore"].load_color_down()):
        save_png_color(os.path.join(base, "color_full", frame_name(i, ".png")), frame)
    one = dataclasses.replace(cfg, path=base, ft=dataclasses.replace(cfg.ft, num_epochs=1))
    proc = TProcessor(one, models={"depth": tuner.adapter, "flow": None}, device="cpu")
    store = proc.pipeline()
    assert store.num_frames == N and len(proc.tuner.history) == 1
    assert os.path.exists(os.path.join(proc.out_dir(N), "stage_timings.json"))
    assert "fine_tune" in proc.tracer.summary()
    # recon=colmap runs; without a COLMAP reconstruction it says which file
    # it needs
    colmap = TProcessor(dataclasses.replace(cfg, recon="colmap"),
                        models=runs["tproc"].models, device="cpu")
    with pytest.raises(FileNotFoundError, match="metadata.npz"):
        colmap.fine_tune(runs["tstore"], np.ones((N, H, W), np.float32))
