"""The data-parallel mesh on the CPU: the port's torch.distributed ranks
against the JAX package's 2-device mesh.

The 6-frame 32x64 clip of tests/test_torch_pkg_slice.py, with its flow
masks and flow_list.json removed, goes through compute_initial_depth, the
flow masks and pair stats, and DatasetProcessor.fine_tune (the small
MiDaS net of tests/test_torch_pkg_finetune.py, 2 epochs, batch_size 2 a
rank, lr 1e-6, an intermediate stream every epoch) three times, each on its
own copy of the clip:
  - the port on two gloo ranks (spawned processes, one torch thread each,
    a file:// store), sharing their copy (tests/torch_pkg_mesh_ranks.py);
  - the JAX package with pipeline_mesh patched to a 2-device mesh of the
    suite's virtual CPU devices (the global batch of 4 pairs a step);
  - the port in one process, for the initial depth and the masks.
The ranks run while the JAX side runs.

Held: the epoch losses equal on both ranks and within 1e-3 relative of the
JAX mesh run's; every depth stream within 1e-3 relative of the JAX mesh
run's; the poses after the last warm solve within 1e-3 of their largest
magnitude; the initial depth stream within 1e-5 of max|ref| of the
single-process run's and the masks and flow_list.json equal to its; the
two ranks' flat parameters and BatchNorm buffers bitwise equal, and so
their SolverParams after every LM solve (each rank solves each step on
its half of the constraints, solver/lm.py sums over the ranks; the
normalize solve runs whole on each rank, with no all-reduce); a step in
which one rank's loss alone is non-finite skipped by both ranks, parameters
and step count unchanged. Beside it: shard/all_gather_leading against the
JAX package's _pad_leading for 1, 5, 6 and 7 items over 1-4 ranks, and the
backend rules of init_mesh.
"""

import json
import os
import shutil
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_pkg_mesh_ranks as ranks
from robust_cvd_tpu import config as jconfig
from robust_cvd_tpu.io.store import VideoStore as JStore
from robust_cvd_tpu.models import midas as jm
from robust_cvd_tpu.models.torch_port import convert_midas_v2
from robust_cvd_tpu.parallel import mesh as jmesh
from robust_cvd_tpu.pipeline.depth import compute_initial_depth as j_depth
from robust_cvd_tpu.pipeline.flow import FlowStage as JFlow
from robust_cvd_tpu.pipeline.process import DatasetProcessor as JProcessor
from robust_cvd_tpu_torch.io import raw
from robust_cvd_tpu_torch.io.store import VideoStore as TStore, load_png_gray
from robust_cvd_tpu_torch.models import midas as tm
from robust_cvd_tpu_torch.parallel import mesh as tmesh
from robust_cvd_tpu_torch.pipeline.depth import compute_initial_depth as t_depth
from robust_cvd_tpu_torch.pipeline.flow import FlowStage as TFlow
from robust_cvd_tpu_torch.utils.frame_sampling import sample_pairs
from test_torch_pkg_slice import N, OPT, make_clip
from torch_pkg_threads import one_torch_thread  # noqa: F401  (autouse)

FT = dict(num_epochs=2, batch_size=2, learning_rate=1e-6, save_tensorboard=False,
          save_intermediate_depth_streams_freq=1)
STREAMS = ["depth_midas2", "e0000", "e0000_opt", "e0001", "e0001_opt"]
COUNTS = (1, 5, 6, 7)
JOIN_S = 600


def _spawn(fn, size, *args):
    return mp.start_processes(fn, args=(size, *args), nprocs=size, join=False,
                              start_method="spawn")


def _join(ctx):
    """Wait for every rank; a failed rank raises here (and the others are
    stopped)."""
    deadline = time.monotonic() + JOIN_S
    while not ctx.join(max(1.0, deadline - time.monotonic())):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"the ranks did not finish in {JOIN_S} s")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh")
    base = str(root / "clip")
    os.makedirs(base)
    make_clip(base)
    shutil.rmtree(os.path.join(base, "flow_mask"))
    os.remove(os.path.join(base, "flow_list.json"))
    jdir, tdir, sdir = (str(root / k) for k in ("jax", "ranks", "single"))
    for d in (jdir, tdir, sdir):
        shutil.copytree(base, d)
    out = str(root / "out")
    os.makedirs(out)
    ctx = _spawn(ranks.slice_rank, 2, str(root / "store"), tdir, out, OPT, FT)
    try:
        tnet = tm.seeded_init_(tm.MidasNet(features=32, backbone_layers=(1, 1, 1, 1)), 0)
        params, stats = convert_midas_v2(tnet.state_dict())
        adapter = jm.MidasV2Adapter(params=params, batch_stats=stats)
        adapter.net = jm.MidasNet(features=32, backbone_layers=(1, 1, 1, 1), dtype=jnp.float32)
        pairs = sample_pairs(N, ("hierarchical2",), two_way=True)
        with pytest.MonkeyPatch.context() as m:
            m.setattr(jmesh, "pipeline_mesh", lambda *a, **k: jmesh.make_mesh(2))
            jstore = JStore.open(jdir)
            jd = j_depth(jstore, adapter, "midas2")
            jflow = JFlow(jstore, None)
            jflow.compute_flow_masks(pairs)
            jflow.compute_flow_pair_stats(pairs)
            jcfg = jconfig.PipelineConfig(
                path=jdir, opt=jconfig.PoseOptParams(**OPT), ft=jconfig.FineTuneParams(**FT))
            jtuner = JProcessor(jcfg, models={"depth": adapter}).fine_tune(jstore, jd)

        sstore = TStore.open(sdir)
        t_depth(sstore, tm.MidasV2Adapter(tnet), "midas2", device="cpu")
        sflow = TFlow(sstore, device="cpu")
        sflow.compute_flow_masks(pairs)
        sflow.compute_flow_pair_stats(pairs)
    finally:
        _join(ctx)
    rank = [dict(np.load(os.path.join(out, f"rank{r}.npz"))) for r in range(2)]
    return dict(jdir=jdir, tdir=tdir, sdir=sdir, jtuner=jtuner, rank=rank, pairs=pairs)


def test_shard_and_gather_padding(tmp_path):
    """Each rank's shard is its slice of the JAX package's padding (copies
    of item 0 up to a multiple of the size), and all_gather_leading gives
    every member the n items back."""
    for size in range(1, 5):
        for n in COUNTS:
            want = np.asarray(jmesh._pad_leading(jnp.arange(n), -(-n // size) * size))
            got = sum((tmesh.Mesh(r, size, torch.device("cpu")).shard(n)
                       for r in range(size)), [])
            assert got == want.tolist(), (size, n)
            shares = sum((tmesh.Mesh(r, size, torch.device("cpu")).share(range(n))
                          for r in range(size)), [])
            assert shares == list(range(n))
    _join(_spawn(ranks.gather_rank, 4, str(tmp_path / "store"), str(tmp_path), COUNTS))
    for r in range(4):
        got = np.load(tmp_path / f"gather_rank{r}.npz")
        for size in range(r + 1, 5):
            for n in COUNTS:
                want = np.repeat((np.arange(n, dtype=np.float32) * 10 + 1)[:, None], 3, 1)
                np.testing.assert_array_equal(got[f"k{size}_n{n}"], want)


def test_backend_rules(monkeypatch, tmp_path):
    assert tmesh.pipeline_mesh() is None
    with pytest.raises(ValueError, match="cards only"):
        tmesh.init_mesh(backend="nccl", device="cpu", init_method=f"file://{tmp_path}/s",
                        rank=0, world_size=1)
    # two local ranks on one card: nccl, asked for or by default, raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    for backend in (None, "nccl"):
        with pytest.raises(ValueError, match="gloo"):
            tmesh.init_mesh(backend=backend, init_method=f"file://{tmp_path}/s", rank=0,
                            world_size=2)
    assert not torch.distributed.is_initialized()


def test_epoch_losses_match_jax_mesh(runs):
    r0, r1 = runs["rank"]
    np.testing.assert_array_equal(r0["losses"], r1["losses"])
    jl = [h["loss"] for h in runs["jtuner"].history]
    assert len(r0["losses"]) == len(jl) == 2 and np.isfinite(r0["losses"]).all()
    np.testing.assert_allclose(r0["losses"], jl, rtol=1e-3)
    assert (r0["skipped"] == 0).all()
    # global batches of 4 pairs (2 a rank), then the trailing ones whole
    n_pairs = int(runs["jtuner"].clip.pair_idx.shape[0])
    assert r0["steps"].tolist() == [-(-n_pairs // 4)] * 2


def _stream(path):
    return np.stack([
        raw.load_raw_float32_image(os.path.join(path, "depth", f"frame_{i:06d}.raw"))
        for i in range(N)
    ])


def test_depth_streams_match_jax_mesh(runs):
    jtuner = runs["jtuner"]
    ft_dir = os.path.relpath(jtuner.out_dir, runs["jdir"])
    tdir = os.path.join(runs["tdir"], ft_dir)
    assert [s.name for s in jtuner.pose.streams] == STREAMS
    for js in jtuner.pose.streams:
        rel = os.path.relpath(js.dir, runs["jdir"])
        got = _stream(os.path.join(runs["tdir"], rel))
        assert np.isfinite(got).all(), js.name
        np.testing.assert_allclose(got, _stream(js.dir), rtol=1e-3, err_msg=js.name)
    np.testing.assert_allclose(_stream(os.path.join(tdir, "depth_e0001_opt")),
                               raw.depth_to_disparity(runs["rank"][1]["current_depth"]),
                               rtol=1e-6)


def test_poses_match_jax_mesh(runs):
    ref = np.asarray(runs["jtuner"].solver_params.pose)
    got = runs["rank"][0]["pose"]
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3 * np.abs(ref).max())


def test_depth_and_masks_match_single_process(runs):
    tdir, sdir = runs["tdir"], runs["sdir"]
    ref = TStore.open(sdir).load_depth_stream("depth_midas2")
    got = TStore.open(tdir).load_depth_stream("depth_midas2")
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    names = sorted(os.listdir(os.path.join(sdir, "flow_mask")))
    assert names == sorted(os.listdir(os.path.join(tdir, "flow_mask")))
    assert len(names) == len(runs["pairs"])
    for name in names:
        np.testing.assert_array_equal(load_png_gray(os.path.join(tdir, "flow_mask", name)),
                                      load_png_gray(os.path.join(sdir, "flow_mask", name)))
    with open(os.path.join(tdir, "flow_list.json")) as f, \
            open(os.path.join(sdir, "flow_list.json")) as g:
        assert json.load(f) == json.load(g)


def test_replicas_are_bitwise_equal(runs):
    r0, r1 = runs["rank"]
    assert r0["flat"].tobytes() == r1["flat"].tobytes()
    assert r0["buffers"].tobytes() == r1["buffers"].tobytes()
    assert int(r0["count"]) == int(r1["count"]) == r0["steps"].sum()


def test_every_rank_solves_its_share_to_the_same_bits(runs):
    r0, r1 = runs["rank"]
    assert len(r0["digests"]) > 0 and r0["digests"].tolist() == r1["digests"].tolist()
    assert r0["pose"].tobytes() == r1["pose"].tobytes()
    # the normalize solve reads per-frame data only and runs whole on each
    # rank; every other solve sums over the ranks
    step = r0["stages"] != "normalize"
    assert step.any() and (r0["all_reduces"][step] > 0).all()
    assert not r0["all_reduces"][~step].any()
    assert r0["all_reduces"].tolist() == r1["all_reduces"].tolist()
    # each rank holds half of the pairs (the JAX mesh's are padded to an
    # even count)
    n_pairs = int(runs["jtuner"].pose_inputs.data.pair.shape[0])
    assert int(r0["pairs"]) == int(r1["pairs"]) == -(-n_pairs // 2)


def test_a_rank_with_a_non_finite_loss_makes_every_rank_skip(runs):
    for r in runs["rank"]:
        ok_step, ok_adam, params_kept, count_kept, loss_finite = r["guard"]
        assert not ok_step and not ok_adam and not loss_finite
        assert params_kept and count_kept
