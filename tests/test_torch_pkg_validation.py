"""Validation and the recon=colmap fine-tune: JAX package vs PyTorch port.

1. eval_pair_losses on the 4-frame 32x64 clip and small net of
   tests/test_torch_pkg_step.py, in float64 on both sides (the float32 trap
   of ROADMAP.md §3: random-weight ReLU inputs within rounding of 0): the
   port's batched eval (batch_size pairs a pass, each pair with its own
   train-mode BatchNorm statistics) against the JAX package's one-pair
   scan, per-pair totals and parts within 1e-5 relative, as the float64
   train step is held (tests/test_torch_pkg_step.py; the depth-based parts
   differ by up to 8e-7 here, statistics shared across a batch would move
   them by far more); save_eval_json writes the same entries.
2. DatasetProcessor.fine_tune with recon=colmap (scaling=depth) on the
   6-frame clip of tests/test_torch_pkg_slice.py, a COLMAP reconstruction
   written by io/colmap.py's writers (colmap_dense/metadata.npz and
   depth_colmap_dense/), val_epoch_freq=1 with the eval images, the scale
   maps and the scene-flow images, 1 epoch at the adapter's learning rate
   of 1e-6 (the float32 trap again), both packages from the same weights:
   no solve runs, the poses are the COLMAP ones, the epoch losses within
   1e-3 relative and the fine-tuned depth within 1e-3 relative; eval/ holds
   the JAX package's file names, the loss JSONs its keys in its order and
   values within 1e-3 relative, the eval depth within 1e-3 relative.
3. main(..., device="cpu") through the CLI on a copy of that clip, with
   --recon colmap and --val_epoch_freq 1, and (marked slow) with the i3d
   solve and --val_epoch_freq 1, writes the JAX package's result tree
   under the experiment dir.
"""

import functools
import json
import os
import shutil
from os.path import join as pjoin

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robust_cvd_tpu import config as jconfig
from robust_cvd_tpu.io.store import VideoStore as JStore
from robust_cvd_tpu.models import midas as jm
from robust_cvd_tpu.models.torch_port import convert_midas_v2
from robust_cvd_tpu.parallel import mesh as jmesh
from robust_cvd_tpu.pipeline.process import DatasetProcessor as JProcessor
from robust_cvd_tpu.solver.residuals import SolverParams as JSolverParams
from robust_cvd_tpu.training import fine_tune as jft
from robust_cvd_tpu_torch import config as tconfig
from robust_cvd_tpu_torch.io import colmap as TC
from robust_cvd_tpu_torch.io import raw
from robust_cvd_tpu_torch.io.store import VideoStore as TStore, frame_name, save_png_color
from robust_cvd_tpu_torch.main import main
from robust_cvd_tpu_torch.models import midas as tm
from robust_cvd_tpu_torch.models import raft as tr
from robust_cvd_tpu_torch.pipeline.process import DatasetProcessor as TProcessor
from robust_cvd_tpu_torch.solver.residuals import SolverParams as TSolverParams
from robust_cvd_tpu_torch.training import fine_tune as tft
from test_torch_pkg_slice import H, N, OPT, W, make_clip
import test_torch_pkg_step as step
from torch_pkg_threads import one_torch_thread  # noqa: F401  (autouse)

SMALL_MIDAS = dict(features=32, backbone_layers=(1, 1, 1, 1))
FT = dict(num_epochs=1, batch_size=2, learning_rate=1e-6, save_tensorboard=False,
          val_epoch_freq=1, save_eval_images=True, save_depth_xform_maps=True,
          save_scene_flow_vis=True)
ARGV = ["--num_epochs", "1", "--batch_size", "2", "--learning_rate", "1e-6",
        "--save_tensorboard", "false", "--val_epoch_freq", "1",
        "--save_eval_images", "true", "--save_depth_xform_maps", "true",
        "--save_scene_flow_vis", "true", "--opt.num_steps", "2", "--opt.ctf_long", "3",
        "--opt.ctf_short", "2", "--opt.lm_max_outer", "4", "--opt.lm_cg_iters", "8"]


def test_eval_pair_losses_float64(tmp_path):
    _, params, stats, (images, depth, flow_list, flows, masks), sp, _ = step._setup()
    loss = jconfig.LossParams(lambda_parameter=1e-3)
    with jax.enable_x64(True):
        fnet = jm.MidasNet(**SMALL_MIDAS, dtype=jnp.float64)
        jclip = jft.build_clip_data(images, depth, flow_list, flows, masks, 0.2)
        jps = jft.pose_state_from_solver(
            JSolverParams(**step._f64(sp)), (32, 64), 2.0,
            jnp.asarray(jclip.depth_orig, jnp.float64))
        p64 = step._f64(params)
        init = jax.tree.map(lambda a: a * 0.99, p64)  # a nonzero parameter loss
        losses_p, parts_p = jft.make_eval_all_fn(fnet, loss, False)(
            p64, step._f64(stats), jclip, jps, init)
        want_loss = np.asarray(losses_p)
        want_parts = {k: np.asarray(v).reshape(len(want_loss), -1).mean(1)
                      for k, v in parts_p.items()}

    net = tm.MidasNet(**SMALL_MIDAS)
    net.load_state_dict(tm.state_dict_from_jax(params, stats))
    net = net.double()
    cfg = tconfig.PipelineConfig(
        loss=tconfig.LossParams(lambda_parameter=1e-3),
        ft=tconfig.FineTuneParams(batch_size=2, save_tensorboard=False))
    clip = tft.build_clip_data(images, depth, flow_list, flows, masks, 0.2, device="cpu")
    clip = tft.ClipData(*[t.double() if t is not None and t.is_floating_point() else t
                          for t in clip])
    tuner = tft.FineTuner(cfg, tm.MidasV2Adapter(net), clip, None, device="cpu")
    tuner.optimizer.init.copy_(tuner.optimizer.flat * 0.99)
    tuner.pose_state = tft.pose_state_from_solver(
        TSolverParams(**{k: torch.from_numpy(v).double() for k, v in sp.items()}),
        (32, 64), 2.0, clip.depth_orig)
    stats_before = [b.clone() for b in net.buffers()]
    entries = tuner.eval_pair_losses()
    assert len(entries) == len(want_loss) == 5  # batches of 2, 2 and 1
    assert list(entries[0]) == ["pair", "loss"] + sorted(want_parts)
    assert [e["pair"] for e in entries] == np.asarray(jclip.pair_idx).tolist()
    np.testing.assert_allclose([e["loss"] for e in entries], want_loss, rtol=1e-5)
    for k, v in want_parts.items():
        np.testing.assert_allclose([e[k] for e in entries], v, rtol=1e-5, err_msg=k)
    # the eval leaves the BatchNorm statistics alone
    assert all(a.equal(b) for a, b in zip(stats_before, net.buffers()))
    tuner.save_eval_json(str(tmp_path), 3)
    with open(tmp_path / "loss_0003.json") as f:
        assert json.load(f) == entries


def colmap_reconstruction(base):
    """A 6-image COLMAP model (io/colmap.py's writers) as the importer
    chain leaves it: colmap_dense/metadata.npz at the clip's resolution and
    one reference disparity a frame in depth_colmap_dense/depth/."""
    from test_torch_pkg_colmap import make_model

    model = pjoin(base, "colmap_dense", "sparse")
    os.makedirs(model)
    cams, images, points = make_model(TC, n_images=N)
    TC.write_cameras_binary(cams, pjoin(model, "cameras.bin"))
    TC.write_images_binary(images, pjoin(model, "images.bin"))
    TC.write_points3d_binary(points, pjoin(model, "points3D.bin"))
    TC.model_to_npz(model, pjoin(base, "colmap_dense", "metadata.npz"), (W, H))
    rng = np.random.default_rng(7)
    os.makedirs(pjoin(base, "depth_colmap_dense", "depth"))
    for i in range(N):
        ref = rng.uniform(0.3, 0.6, (H, W)).astype(np.float32)
        ref[:2, :5] = np.nan  # invalid reference pixels
        raw.save_raw_float32_image(pjoin(base, "depth_colmap_dense", "depth", frame_name(i, ".raw")),
                                   ref)


def _initial_depth(base):
    rng = np.random.default_rng(8)
    disp = rng.uniform(0.4, 0.6, (N, H, W)).astype(np.float32)
    os.makedirs(pjoin(base, "depth_midas2", "depth"))
    for i in range(N):
        raw.save_raw_float32_image(pjoin(base, "depth_midas2", "depth", frame_name(i, ".raw")),
                                   disp[i])
    return raw.disparity_to_depth(disp)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("valclip"))
    make_clip(base)
    colmap_reconstruction(base)
    depth = _initial_depth(base)
    jdir, tdir = base + "_jax", base + "_torch"
    shutil.copytree(base, jdir)
    shutil.copytree(base, tdir)

    tnet = tm.seeded_init_(tm.MidasNet(**SMALL_MIDAS), 0)
    params, stats = convert_midas_v2(tnet.state_dict())
    adapter = jm.MidasV2Adapter(params=params, batch_stats=stats)
    adapter.net = jm.MidasNet(**SMALL_MIDAS, dtype=jnp.float32)
    kw = dict(recon="colmap", scaling="depth")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmesh, "pipeline_mesh", lambda *a, **k: None)
        jcfg = jconfig.PipelineConfig(path=jdir, opt=jconfig.PoseOptParams(**OPT),
                                      ft=jconfig.FineTuneParams(**FT), **kw)
        jtuner = JProcessor(jcfg, models={"depth": adapter}).fine_tune(JStore.open(jdir), depth)
    tcfg = tconfig.PipelineConfig(path=tdir, opt=tconfig.PoseOptParams(**OPT),
                                  ft=tconfig.FineTuneParams(**FT), **kw)
    ttuner = TProcessor(tcfg, models={"depth": tm.MidasV2Adapter(tnet)}, device="cpu").fine_tune(
        TStore.open(tdir), depth)
    return dict(base=base, jdir=jdir, tdir=tdir, jtuner=jtuner, ttuner=ttuner, tnet=tnet)


def test_colmap_fine_tune_skips_the_solver(runs):
    jtuner, ttuner = runs["jtuner"], runs["ttuner"]
    assert jtuner.solver_params is None and ttuner.solver_params is None
    assert ttuner.solve_log == []
    meta = np.load(pjoin(runs["tdir"], "colmap_dense", "metadata.npz"))
    np.testing.assert_array_equal(ttuner.pose_state.extrinsics.numpy(),
                                  meta["extrinsics"].astype(np.float32))
    np.testing.assert_array_equal(ttuner.pose_state.intrinsics.numpy(),
                                  meta["intrinsics"].astype(np.float32))
    assert ttuner.clip.ref_disp is not None
    steps = sum(h["steps"] for h in ttuner.history)
    assert int(ttuner.optimizer.count) == steps and steps > 0
    np.testing.assert_allclose([h["loss"] for h in ttuner.history],
                               [h["loss"] for h in jtuner.history], rtol=1e-3)
    names = [s.name for s in ttuner.pose.streams]
    assert names == [s.name for s in jtuner.pose.streams] == [
        "colmap_dense", "depth_midas2", "fine_tuned"]
    got, want = (np.stack([raw.load_raw_float32_image(pjoin(t.pose.streams[-1].dir, "depth",
                                                             frame_name(i, ".raw")))
                           for i in range(N)]) for t in (ttuner, jtuner))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-3)
    # the depth moved from the initial stream
    init = raw.depth_to_disparity(TStore.open(runs["tdir"]).load_depth_stream("depth_midas2"))
    assert np.abs(got - init).max() > 1e-3 * np.abs(init).max()


def _tree(root):
    return sorted(os.path.relpath(pjoin(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def test_colmap_depth_scale_matches_jax():
    rng = np.random.default_rng(3)
    depth = rng.uniform(0.5, 4.0, (2, 2, 7, 9)).astype(np.float32)
    ref = rng.uniform(0.1, 2.0, (2, 2, 7, 9)).astype(np.float32)
    ref[0, 0, :2, :3] = np.inf
    ref[1, 1, 3, :] = np.nan
    ref[1, 0] = np.nan  # no valid pixel: scale 1
    got = tft.colmap_depth_scale(torch.from_numpy(depth), torch.from_numpy(ref)).numpy()
    want = np.asarray(jft.colmap_depth_scale(jnp.asarray(depth), jnp.asarray(ref)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[1, 0] == 1.0


def test_validate_files_and_json(runs):
    jdir, tdir = (pjoin(t.out_dir, "eval") for t in (runs["jtuner"], runs["ttuner"]))
    names = _tree(tdir)
    assert names == _tree(jdir)
    n_pairs = int(runs["ttuner"].clip.pair_idx.shape[0])
    sufs = [f"_e{e:04d}_iter{e * n_pairs:06d}" for e in range(FT["num_epochs"] + 1)]
    assert [n for n in names if n.startswith("loss")] == [f"loss{s}.json" for s in sufs]
    for kind in ("depth", "scale"):
        assert len([n for n in names if n.startswith(kind)]) == 2 * N * len(sufs)
    assert len([n for n in names if n.startswith("scene_flow")]) == n_pairs * len(sufs)
    for s in sufs:
        with open(pjoin(tdir, f"loss{s}.json")) as f:
            got = json.load(f)
        with open(pjoin(jdir, f"loss{s}.json")) as f:
            want = json.load(f)
        assert list(got) == list(want)
        for k in want:
            assert list(got[k]) == list(want[k])
            vals = np.array(list(got[k].values()))
            assert np.isfinite(vals).all()
            np.testing.assert_allclose(vals, list(want[k].values()), rtol=1e-3, err_msg=k)
        np.testing.assert_allclose(
            raw.load_raw_float32_image(pjoin(tdir, f"depth_000003{s}.raw")),
            raw.load_raw_float32_image(pjoin(jdir, f"depth_000003{s}.raw")), rtol=1e-3)


def _cli_clip(runs, tmp_path, monkeypatch):
    """A copy of the pristine clip with colour frames and the small nets'
    checkpoints under models/, the CLI's nets narrowed to their sizes."""
    clip = str(tmp_path / "clip")
    shutil.copytree(runs["base"], clip)
    os.makedirs(pjoin(clip, "color_full"))
    for i, frame in enumerate(TStore.open(clip).load_color_down()):
        save_png_color(pjoin(clip, "color_full", frame_name(i, ".png")), frame)
    os.makedirs(pjoin(clip, "models"))
    torch.save(runs["tnet"].state_dict(), pjoin(clip, "models", "midas_v21-f6b98070.pt"))
    raft = tr.seeded_init_(tr.RAFT(iters=2, dtype=torch.float32), 0)
    torch.save(raft.state_dict(), pjoin(clip, "models", "raft-things.pth"))
    monkeypatch.setattr(tm, "MidasNet", functools.partial(tm.MidasNet, **SMALL_MIDAS))
    monkeypatch.setattr(tr, "RAFT", functools.partial(tr.RAFT, iters=2, dtype=torch.float32))
    return clip


# The i3d case adds a pose solve to the CLI run; it is marked slow to keep
# the file inside its tier-1 time. The colmap case runs --val_epoch_freq 1
# through the CLI as well.
@pytest.mark.parametrize("recon", ["colmap", pytest.param("i3d", marks=pytest.mark.slow)])
def test_cli_writes_the_result_tree(runs, tmp_path, monkeypatch, recon):
    clip = _cli_clip(runs, tmp_path, monkeypatch)
    proc = main(["--path", clip, "--recon", recon, *ARGV], device="cpu")
    tuner = proc.tuner
    jout = runs["jtuner"].out_dir
    assert os.path.basename(tuner.out_dir) == os.path.basename(jout)
    assert _tree(pjoin(tuner.out_dir, "eval")) == _tree(pjoin(jout, "eval"))
    if recon == "colmap":
        assert _tree(tuner.out_dir) == _tree(jout)
        assert tuner.solver_params is None
    else:
        assert len(tuner.solve_log) > 0 and os.path.exists(pjoin(clip, "video.dat"))
        assert _tree(pjoin(tuner.out_dir, "depth")) == _tree(pjoin(jout, "depth"))
    assert os.path.exists(pjoin(proc.out_dir(N), "stage_timings.json"))


def test_depth_colours_need_no_matplotlib(monkeypatch):
    """The eval depth images' colour map: the JAX package's (matplotlib's
    magma) byte for byte, with matplotlib unimportable (the GPU machine
    has none)."""
    import sys

    from robust_cvd_tpu.utils.visualization import visualize_depth as jvis
    from robust_cvd_tpu_torch.utils.visualization import visualize_depth as tvis

    rng = np.random.default_rng(9)
    depth = rng.uniform(0.5, 3.0, (48, 64)).astype(np.float32)
    depth[0, :4] = 0.0
    depth[1, 1] = np.inf
    want = [jvis(depth), jvis(depth, depth_min=0.7)]
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    got = [tvis(depth), tvis(depth, depth_min=0.7)]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_magma_table_matches_matplotlib():
    """Every bin of the port's magma table against matplotlib's map, as the
    JAX package renders it (x * 255 + 0.5 -> uint8): t over [0, 1] in steps
    of 1/4096 (16 samples a bin, t = 1.0 included), and NaN to black."""
    import matplotlib

    from robust_cvd_tpu_torch.utils.visualization import _colormap_u8

    t = np.append(np.linspace(0, 1, 4097, dtype=np.float32), np.float32(np.nan))
    want = (matplotlib.colormaps["magma"](t)[..., :3] * 255 + 0.5).astype(np.uint8)
    got = _colormap_u8(t, "magma")
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got[:-1], axis=0)) == 256
    np.testing.assert_array_equal(got[-1], 0)
