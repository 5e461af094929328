"""The whole pipeline: JAX package vs PyTorch port on the CPU.

The 4-frame 48x64 clip of tests/test_e2e.py (color_full PNGs of a seeded
texture panning 2 px a frame, with frames.txt) goes through both packages'
DatasetProcessor(...).process(), each on its own copy: color_down at
32x32 (--size 32 --align 32), color_flow at 48x64 (FLOW_MAX_SIZE and
FLOW_ALIGN patched to 64 and 8 as tests/test_e2e.py does), the small MiDaS
net with Flax-initialised weights carried across by
models/midas.py::state_dict_from_jax, RAFT float32 with 2 iterations,
carried across the same way, whose last flow-head convolution has a zero
kernel and a small bias: its flow is the registration homography's plus a
fraction of a pixel, so the masks are not empty (random flow heads leave
them near empty), and no flow target lands on the frame's edge, where the
two packages' flows, 1e-5 px apart, would put a border pixel in bounds in
one and out in the other,
motion-segmentation dynamic masks, the small solver schedule, one epoch at
the adapter's learning rate of 1e-6, the post filter (a fine_tuned_filtered
stream, frame_radius 4), flow visualizations and tensorboard on (image and
histogram summaries every 2 pairs), depth visualizations on. The JAX side
runs its single-device path.

Held: color_down byte for byte; initial depth within 1e-4 relative; flows
within 1e-4 px; flow masks, dynamic_mask PNGs and the flow_list.json pairs
identical (mask ratios then too); the poses after the last warm solve
within 1e-3; fine-tuned depth within 1e-3 relative, and its filtered stream
too; stage_timings.json with the JAX package's span names in its order (the
port adds the flow stage's compute_flow/load_s, chunk_s and write_s right
after compute_flow, and fine_tune/post_filter_s last); the
same vis_flow files, within 2 of 255 per channel (flows 1e-4 px apart move
the colour wheel's floor by at most that); the fine-tuned depth's colour
maps within 4 of 255 (depth 1e-3 apart moves a pixel by at most one step
of the 256-entry colour map); the same tensorboard tags.
Then a rerun through the CLI (main([...], device="cpu") with --post_filter,
checkpoints under <clip>/models/) recomputes no finished stage and filters
again. With --mask_rcnn_weights the CLI runs the Mask R-CNN stage (the
same masks as the stage alone, its stats as spans), falls back to motion
segmentation when the file does not exist, and raises an unreadable
checkpoint's error out of pipeline() rather than the mask stage's handler
swallowing it.
"""

import functools
import glob
import json
import os
import shutil
from os.path import join as pjoin

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import robust_cvd_tpu.pipeline.process as jproc_mod
import robust_cvd_tpu_torch.pipeline.process as tproc_mod
from robust_cvd_tpu import config as jconfig
from robust_cvd_tpu.io.frames import save_frames_txt
from robust_cvd_tpu.io.store import frame_name, save_png_color
from robust_cvd_tpu.models import midas as jm
from robust_cvd_tpu.models import raft as jr
from robust_cvd_tpu_torch import config as tconfig
from robust_cvd_tpu_torch.io import raw
from robust_cvd_tpu_torch.io.store import VideoStore, frame_name, load_png_color, load_png_gray
from robust_cvd_tpu_torch.io.video_dat import load_video_dat
from robust_cvd_tpu_torch.main import main
from robust_cvd_tpu_torch.models import midas as tm
from robust_cvd_tpu_torch.models import raft as tr

N, H, W = 4, 48, 64
OPT = dict(num_steps=2, ctf_long=3, ctf_short=2, lm_max_outer=4, lm_cg_iters=8)
CFG = dict(size=32, align=32, vis_flow=True, post_filter=True)
FT = dict(num_epochs=1, batch_size=2, display_freq=2, save_depth_visualization=True)
ARGV = ["--size", "32", "--align", "32", "--vis_flow", "true", "--post_filter", "true",
        "--num_epochs", "1",
        "--batch_size", "2", "--display_freq", "2", "--save_depth_visualization", "true",
        "--opt.num_steps", "2", "--opt.ctf_long", "3",
        "--opt.ctf_short", "2", "--opt.lm_max_outer", "4", "--opt.lm_cg_iters", "8"]
SMALL_MIDAS = dict(features=32, backbone_layers=(1, 1, 1, 1))
# RAFT's flow head adds this much a 1/8-resolution pixel an iteration, so
# the flows are the registration's plus ~0.16 px right and ~0.21 px down at
# color_down (less where the convex upsampling reaches past the border)
HEAD_BIAS = 0.02


def make_clip(base):
    rng = np.random.default_rng(0)
    bg = rng.uniform(0, 1, (H, W + 16, 3)).astype(np.float32)
    os.makedirs(pjoin(base, "color_full"))
    for i in range(N):
        save_png_color(pjoin(base, "color_full", frame_name(i, ".png")), bg[:, 2 * i : 2 * i + W])
    save_frames_txt(pjoin(base, "frames.txt"), W, H, [i / 30 for i in range(N)])


def _weights():
    """Flax variables of the small MiDaS net and of RAFT (float32, 2
    iterations) with its last flow-head convolution's kernel zeroed and its
    bias set to HEAD_BIAS, as numpy."""
    jnet = jm.MidasNet(**SMALL_MIDAS, dtype=jnp.float32)
    mv = jax.tree.map(np.array, jnet.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))
    jraft = jr.RAFT(iters=2, dtype=jnp.float32)
    rv = jax.tree.map(np.array, jraft.init(
        jax.random.PRNGKey(1), jnp.zeros((1, H, W, 3)), jnp.zeros((1, H, W, 3))))
    head = rv["params"]["update_block"]["block"]["flow_head"]["conv2"]
    head["kernel"][:] = 0
    head["bias"][:] = HEAD_BIAS
    return jnet, mv, jraft, rv


def _torch_models(mv, rv):
    tnet = tm.MidasNet(**SMALL_MIDAS)
    tnet.load_state_dict(tm.state_dict_from_jax(mv["params"], mv["batch_stats"]))
    traft = tr.RAFT(iters=2, dtype=torch.float32)
    traft.load_state_dict(tr.state_dict_from_jax(rv["params"], rv["batch_stats"]))
    return tnet, traft


def _keep_tuner(proc, store):
    """Wraps proc.fine_tune to keep the FineTuner the JAX pipeline drops."""
    run = proc.fine_tune

    def fine_tune(*a):
        store["tuner"] = run(*a)
        return store["tuner"]

    proc.fine_tune = fine_tune


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("pipeline")
    jbase, tbase = str(root / "jax"), str(root / "torch")
    make_clip(jbase)
    shutil.copytree(jbase, tbase)
    jnet, mv, jraft, rv = _weights()
    tnet, traft = _torch_models(mv, rv)

    jadapter = jm.MidasV2Adapter(params=mv["params"], batch_stats=mv["batch_stats"])
    jadapter.net = jnet
    jcfg = jconfig.PipelineConfig(path=jbase, **CFG, opt=jconfig.PoseOptParams(**OPT),
                                  ft=jconfig.FineTuneParams(**FT))
    jkept = {}
    real = jax.devices()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "devices", lambda backend=None: real[:1])
        mp.setattr(jproc_mod, "FLOW_MAX_SIZE", 64)
        mp.setattr(jproc_mod, "FLOW_ALIGN", 8)
        jproc = jproc_mod.DatasetProcessor(
            jcfg, models={"depth": jadapter, "flow": (jraft, rv)})
        _keep_tuner(jproc, jkept)
        jproc.process()
    jkept["tuner"].writer.flush()

    tcfg = tconfig.PipelineConfig(path=tbase, **CFG, opt=tconfig.PoseOptParams(**OPT),
                                  ft=tconfig.FineTuneParams(**FT))
    tkept = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tproc_mod, "FLOW_MAX_SIZE", 64)
        mp.setattr(tproc_mod, "FLOW_ALIGN", 8)
        tproc = tproc_mod.DatasetProcessor(
            tcfg, models={"depth": tm.MidasV2Adapter(tnet), "flow": traft}, device="cpu")
        _keep_tuner(tproc, tkept)
        tstore = tproc.process()
    return dict(jbase=jbase, tbase=tbase, jtuner=jkept["tuner"], ttuner=tkept["tuner"],
                tproc=tproc, tstore=tstore, mv=mv, rv=rv)


def _files(base, sub, pattern="*"):
    return sorted(os.path.relpath(p, base) for p in glob.glob(pjoin(base, sub, pattern)))


def test_color_down_identical(runs):
    jb, tb = runs["jbase"], runs["tbase"]
    for sub in ("color_down", "color_down_png", "color_flow"):
        names = _files(tb, sub)
        assert len(names) == N and names == _files(jb, sub)
    for name in _files(tb, "color_down"):
        with open(pjoin(jb, name), "rb") as a, open(pjoin(tb, name), "rb") as b:
            assert a.read() == b.read(), name
    assert VideoStore.open(tb).load_color_down().shape == (N, 32, 32, 3)


def _disparity(base, sub):
    return np.stack([raw.load_raw_float32_image(pjoin(base, sub, frame_name(i, ".raw")))
                     for i in range(N)])


def test_initial_depth(runs):
    got = _disparity(runs["tbase"], "depth_midas2/depth")
    want = _disparity(runs["jbase"], "depth_midas2/depth")
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())


def test_flows_and_masks(runs):
    jb, tb = runs["jbase"], runs["tbase"]
    jlist = json.load(open(pjoin(jb, "flow_list.json")))
    tlist = json.load(open(pjoin(tb, "flow_list.json")))
    assert [r[:2] for r in tlist] == [r[:2] for r in jlist] and len(tlist) > 1
    js, ts = VideoStore.open(jb), VideoStore.open(tb)
    for (i, j) in (tuple(r[:2]) for r in tlist[1:]):
        a, b = ts.load_flow(i, j), js.load_flow(i, j)
        np.testing.assert_allclose(a, b, atol=1e-4, err_msg=f"{i}->{j}")
        # registration's 2 px a frame, halved to 32 wide, plus the head's bias
        np.testing.assert_allclose(a[..., 0], (i - j), atol=0.5)
        np.testing.assert_array_equal(ts.load_flow_mask(i, j), js.load_flow_mask(i, j))
    assert [r[2] for r in tlist[1:]] == [r[2] for r in jlist[1:]]
    assert min(r[2] for r in tlist[1:]) > 0.5  # the masks hold the in-bounds area


def test_dynamic_masks_identical(runs):
    jb, tb = runs["jbase"], runs["tbase"]
    names = _files(tb, "dynamic_mask")
    assert len(names) == N and names == _files(jb, "dynamic_mask")
    for name in names:
        with open(pjoin(jb, name), "rb") as a, open(pjoin(tb, name), "rb") as b:
            assert a.read() == b.read(), name
        assert load_png_gray(pjoin(tb, name)).min() == 255  # a rigid pan: all static


def test_poses_after_the_last_warm_solve(runs):
    jt, tt = runs["jtuner"], runs["ttuner"]
    np.testing.assert_allclose(tt.solver_params.pose.numpy(), np.asarray(jt.solver_params.pose),
                               atol=1e-3)
    assert [e["stage"] for e in tt.solve_log] == ["normalize", "step0", "step1", "warm"]
    jv = load_video_dat(pjoin(runs["jbase"], "video.dat"))
    tv = load_video_dat(pjoin(runs["tbase"], "video.dat"))
    assert [s.name for s in tv.depth_streams] == [s.name for s in jv.depth_streams] == [
        "depth_midas2", "fine_tuned", "fine_tuned_filtered"]
    for tf, jf in zip(tv.depth_streams[-1].frames, jv.depth_streams[-1].frames):
        np.testing.assert_allclose(tf.position + tf.quaternion, jf.position + jf.quaternion,
                                   atol=1e-3)


def test_fine_tuned_depth(runs):
    jt, tt = runs["jtuner"], runs["ttuner"]
    assert os.path.relpath(tt.out_dir, runs["tbase"]) == os.path.relpath(
        jt.out_dir, runs["jbase"])
    got, want = _disparity(tt.out_dir, "depth"), _disparity(jt.out_dir, "depth")
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-3 * np.abs(want).max())
    assert [h["skipped"] for h in tt.history] == [0]


def test_post_filter_stream(runs):
    """--post_filter: the newest stream copied to fine_tuned_filtered and
    filtered there, within the fine-tuned depth's tolerance of the JAX
    package's; the filter moved the depth."""
    jt, tt = runs["jtuner"], runs["ttuner"]
    sub = os.path.join("fine_tuned_filtered", "depth")
    got, want = _disparity(tt.out_dir, sub), _disparity(jt.out_dir, sub)
    assert np.isfinite(got).all() and (got > 0).all()
    np.testing.assert_allclose(got, want, atol=1e-3 * np.abs(want).max())
    assert np.abs(got - _disparity(tt.out_dir, "depth")).max() > 1e-4
    assert tt.stats["post_filter_s"] > 0
    assert tt.pose.streams[-1].name == "fine_tuned_filtered"


def _spans(base, tuner):
    path = pjoin(os.path.dirname(tuner.out_dir), "stage_timings.json")
    return [s["name"] for s in json.load(open(path))["spans"]]


def test_stage_timings_spans(runs):
    got = _spans(runs["tbase"], runs["ttuner"])
    want = _spans(runs["jbase"], runs["jtuner"])
    flow_stats = ["compute_flow/load_s", "compute_flow/chunk_s", "compute_flow/write_s"]
    k = got.index("compute_flow")
    assert got[k + 1 : k + 4] == flow_stats
    assert got[-1] == "fine_tune/post_filter_s"
    assert [n for n in got[:-1] if n not in flow_stats] == want
    assert "visualize_flow" in got and "compute_dynamic_mask" in got


def test_flow_visualizations(runs):
    jb, tb = runs["jbase"], runs["tbase"]
    for sub in ("vis_flow", "vis_flow_warped"):
        names = _files(tb, sub)
        assert names and names == _files(jb, sub)
        for name in names:
            a = load_png_color(pjoin(tb, name)) * 255.0
            b = load_png_color(pjoin(jb, name)) * 255.0
            assert a.shape == b.shape and np.abs(a - b).max() <= 2.0 + 1e-3, name


def test_depth_visualizations(runs):
    tdir, jdir = (os.path.join(runs[k].out_dir, "depth") for k in ("ttuner", "jtuner"))
    names = sorted(n for n in os.listdir(tdir) if n.endswith(".png"))
    assert names == [frame_name(i, ".png") for i in range(N)]
    assert names == sorted(n for n in os.listdir(jdir) if n.endswith(".png"))
    for name in names:
        a = load_png_color(pjoin(tdir, name)) * 255.0
        b = load_png_color(pjoin(jdir, name)) * 255.0
        assert a.shape == (32, 32, 3) and np.abs(a - b).max() <= 4.0 + 1e-3, name


def _tags(tuner):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(tuner.writer.log_dir)
    acc.Reload()
    return {k: sorted(v) for k, v in acc.Tags().items() if k in ("scalars", "histograms",
                                                                 "images")}


def test_tensorboard_tags(runs):
    got = _tags(runs["ttuner"])
    assert got == _tags(runs["jtuner"])
    assert "Train/loss" in got["scalars"] and "Train/batch_losses" in got["histograms"]
    assert got["images"] == ["Train/flow_mask", "Train/image"]
    assert os.path.dirname(runs["ttuner"].writer.log_dir) == runs["ttuner"].out_dir


def test_cli_rerun_skips_finished_stages(runs, monkeypatch):
    """python -m robust_cvd_tpu_torch's main() on the finished tree, with the
    models loaded from <clip>/models/ (the CLI's nets narrowed to the test's
    sizes): every stage before fine-tuning is skipped (mtimes unchanged),
    fine-tuning and stage_timings.json run again."""
    base = runs["tbase"]
    tnet, traft = _torch_models(runs["mv"], runs["rv"])
    os.makedirs(pjoin(base, "models"))
    torch.save(tnet.state_dict(), pjoin(base, "models", "midas_v21-f6b98070.pt"))
    torch.save(traft.state_dict(), pjoin(base, "models", "raft-things.pth"))
    monkeypatch.setattr(tm, "MidasNet", functools.partial(tm.MidasNet, **SMALL_MIDAS))
    monkeypatch.setattr(tr, "RAFT", functools.partial(tr.RAFT, iters=2, dtype=torch.float32))
    monkeypatch.setattr(tproc_mod, "FLOW_MAX_SIZE", 64)
    monkeypatch.setattr(tproc_mod, "FLOW_ALIGN", 8)
    stable = [pjoin(base, p) for p in (
        "color_down/frame_000000.raw", "color_flow/frame_000000.png",
        "depth_midas2/depth/frame_000000.raw", "flow/flow_000000_000001.raw",
        "flow_mask/mask_000000_000001.png", "dynamic_mask/frame_000000.png",
        "vis_flow/frame_000000_000001.png", "flow_constraints.dat")]
    timings = pjoin(runs["tproc"].out_dir(N), "stage_timings.json")
    before = {p: os.path.getmtime(p) for p in stable + [timings]}
    proc = main(["--path", base, *ARGV], device="cpu")
    assert proc.device.type == "cpu" and proc.tuner.history[0]["skipped"] == 0
    assert proc.tuner.pose.streams[-1].name == "fine_tuned_filtered"
    assert "post_filter_s" in proc.tuner.stats
    for p in stable:
        assert os.path.getmtime(p) == before[p], f"stage recomputed {p}"
    assert os.path.getmtime(timings) > before[timings]


def test_mask_rcnn_weights_raise_outside_the_mask_handler(runs, tmp_path):
    """An unreadable Mask R-CNN checkpoint (an empty pickle): its load error
    out of pipeline(), not a "mask generation failed; continuing" line and
    a run without masks; the stage alone raises it too."""
    weights = tmp_path / "model_final.pkl"
    weights.write_bytes(b"")
    cfg = tconfig.parse_config(["--path", runs["tbase"], *ARGV,
                                "--mask_rcnn_weights", str(weights)])
    proc = tproc_mod.DatasetProcessor(cfg, models=runs["tproc"].models, device="cpu")
    with pytest.raises(EOFError):
        proc.process()
    from robust_cvd_tpu_torch.pipeline.masks import compute_dynamic_masks_rcnn

    with pytest.raises(EOFError):
        compute_dynamic_masks_rcnn(runs["tstore"], str(weights), device="cpu")


def _cli_clip(runs, base, monkeypatch):
    """A copy of the finished port tree without its dynamic masks, with the
    CLI's checkpoints under <clip>/models/ and its nets narrowed to the
    test's sizes."""
    shutil.copytree(runs["tbase"], base)
    shutil.rmtree(pjoin(base, "dynamic_mask"))
    tnet, traft = _torch_models(runs["mv"], runs["rv"])
    os.makedirs(pjoin(base, "models"), exist_ok=True)
    torch.save(tnet.state_dict(), pjoin(base, "models", "midas_v21-f6b98070.pt"))
    torch.save(traft.state_dict(), pjoin(base, "models", "raft-things.pth"))
    monkeypatch.setattr(tm, "MidasNet", functools.partial(tm.MidasNet, **SMALL_MIDAS))
    monkeypatch.setattr(tr, "RAFT", functools.partial(tr.RAFT, iters=2, dtype=torch.float32))
    monkeypatch.setattr(tproc_mod, "FLOW_MAX_SIZE", 64)
    monkeypatch.setattr(tproc_mod, "FLOW_ALIGN", 8)


def _dynamic_masks(base):
    return np.stack([load_png_gray(pjoin(base, "dynamic_mask", frame_name(i, ".png")))
                     for i in range(N)])


def test_cli_runs_mask_rcnn(runs, tmp_path, monkeypatch):
    """main([... "--mask_rcnn_weights", pkl], device="cpu") with a seeded
    detectron2-layout checkpoint (chip_smoke.mask_rcnn_checkpoint, heads
    shaped so that 3 proposals of the first frame score person) at a test
    size of 64: the same dynamic_mask/ as compute_dynamic_masks_rcnn on
    another copy, some of it dynamic, and the stage's stats as
    compute_dynamic_mask/<name> spans."""
    import chip_smoke
    from robust_cvd_tpu_torch.pipeline import masks

    base, other = str(tmp_path / "cli"), str(tmp_path / "stage")
    _cli_clip(runs, base, monkeypatch)
    shutil.copytree(base, other)
    pkl = chip_smoke.mask_rcnn_checkpoint(base, 0, device="cpu", keep=3, test_size=64)
    monkeypatch.setattr(masks, "compute_dynamic_masks_rcnn", functools.partial(
        masks.compute_dynamic_masks_rcnn, test_size=64))
    proc = main(["--path", base, *ARGV, "--mask_rcnn_weights", pkl], device="cpu")
    names = [sp["name"] for sp in proc.tracer.spans]
    # the 4 frames run in one pass: no steady state
    for stat in ("load_convert_s", "weights_h2d_s", "first_dispatch_s"):
        assert f"compute_dynamic_mask/{stat}" in names
    masks.compute_dynamic_masks_rcnn(VideoStore.open(other), pkl, device="cpu")
    got = _dynamic_masks(base)
    np.testing.assert_array_equal(got, _dynamic_masks(other))
    assert (got == 0).any() and (got == 255).any()


def test_cli_missing_mask_rcnn_weights_fall_back(runs, tmp_path, monkeypatch, capsys):
    """A --mask_rcnn_weights file that does not exist: the JAX package's
    fallback line, then motion segmentation (the masks of the first run)."""
    base = str(tmp_path / "cli")
    _cli_clip(runs, base, monkeypatch)
    missing = str(tmp_path / "none.pkl")
    main(["--path", base, *ARGV, "--mask_rcnn_weights", missing], device="cpu")
    assert (f"--mask_rcnn_weights {missing!r} not found; falling back to motion "
            "segmentation") in capsys.readouterr().out
    np.testing.assert_array_equal(_dynamic_masks(base), _dynamic_masks(runs["tbase"]))


def test_stage_tracer_matches_jax(tmp_path):
    """The same spans give the same summary and JSON layout in both
    packages' StageTracer; the port's stages are also spans of
    utils/spans.py, whose durations are the tracer's seconds."""
    from robust_cvd_tpu.utils.experiment import StageTracer as JTracer
    from robust_cvd_tpu_torch.utils import spans
    from robust_cvd_tpu_torch.utils.experiment import StageTracer

    tracers = (StageTracer(device="cpu"), JTracer())
    for tracer in tracers:
        for name in ("a", "b", "a"):
            with tracer.span(name, pairs=3):
                torch.ones(8).sum()
    (t, j) = tracers
    assert list(t.summary()) == list(j.summary()) == ["a", "b"]
    assert [s["name"] for s in t.spans] == ["a", "b", "a"] and t.spans[0]["pairs"] == 3
    t.save(str(tmp_path / "t.json"))
    j.save(str(tmp_path / "j.json"))
    tj, jj = (json.load(open(tmp_path / f)) for f in ("t.json", "j.json"))
    assert list(tj) == list(jj) == ["spans", "summary"]
    assert [sorted(s) for s in tj["spans"]] == [sorted(s) for s in jj["spans"]]
    ring = spans.recent("a", 2) + spans.recent("b", 1)
    assert [r["attrs"] for r in ring] == [{"pairs": 3}] * 3
    assert sorted((r["t1_ns"] - r["t0_ns"]) / 1e9 for r in ring) == sorted(
        s["sec"] for s in t.spans)
