"""Package rules of the PyTorch port (robust_cvd_tpu_torch).

- Importing every module of the port loads neither jax nor robust_cvd_tpu.
- No source of the port (nor chip_smoke.py, nor the port's tools) imports
  them. tools/registration_share.py is not one of them: it runs the JAX
  package on purpose, to measure the reference.
- The training and pipeline layers reach the depth models only through
  the model-neutral modules (models/depth_model.py, models/layers.py, the
  registry), and neither DPT, BEiT nor Swin V2 takes anything from MiDaS
  v2's module.
- The copied configuration keeps the JAX package's defaults, and the copied
  writers produce byte-identical files.
- Entry points raise without CUDA unless the caller asks for the CPU, and a
  failed native build raises.
"""

import ast
import dataclasses
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import robust_cvd_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_DIR = os.path.dirname(robust_cvd_tpu_torch.__file__)


def _port_modules():
    return sorted(
        m.name for m in pkgutil.walk_packages([PKG_DIR], "robust_cvd_tpu_torch.")
    )


def test_import_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {_port_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'robust_cvd_tpu' or m.startswith('robust_cvd_tpu.')]\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        env=env, timeout=300,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert len(_port_modules()) >= 53
    for m in ("quality", "io.colmap", "io.importers", "ops.filters", "solver.tracks",
              "pipeline.processor", "parallel.mesh", "models.registry", "native"):
        assert f"robust_cvd_tpu_torch.{m}" in _port_modules()


def _imported_names(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_sources_import_no_jax_or_jax_package():
    files = [os.path.join(REPO, p) for p in (
        "chip_smoke.py", "tools/sweep_corner_cuda.py", "tools/time_kernels_cuda.py",
        "tools/flow_path_cuda.py", "tools/pipeline_cuda.py", "tools/quality_cuda.py",
        "tools/processor_cuda.py", "tools/mask_rcnn_cuda.py", "tools/mesh_cuda.py",
        "tools/filter_ties_cuda.py", "tools/sharded_solve_cuda.py", "tools/spans_cuda.py",
        "tools/flow_loader_cuda.py")]
    for root, _, names in os.walk(PKG_DIR):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    bad = []
    for f in files:
        for name in _imported_names(f):
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "flax", "optax", "robust_cvd_tpu"):
                bad.append((f, name))
    assert not bad
    assert len(files) >= 20


def _absolute_imports(path):
    """Every module the port's source `path` imports, relative imports
    resolved; `from package import name` gives package.name as well, since
    the name may be a module."""
    package = os.path.relpath(os.path.dirname(path), os.path.dirname(PKG_DIR)).split(os.sep)
    for node in ast.walk(ast.parse(open(path).read(), path)):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            base = package[: len(package) - node.level + 1] if node.level else []
            module = ".".join(base + ([node.module] if node.module else []))
            yield module
            yield from (f"{module}.{a.name}" for a in node.names)


def test_depth_model_layer_is_model_neutral():
    models = "robust_cvd_tpu_torch.models."
    bad = []
    for sub in ("training", "pipeline"):
        for root, _, names in os.walk(os.path.join(PKG_DIR, sub)):
            for f in (os.path.join(root, n) for n in names if n.endswith(".py")):
                bad += [(f, m) for m in _absolute_imports(f)
                        if m.startswith((models + "midas", models + "dpt", models + "beit",
                                         models + "swin2"))]
    dpt = os.path.join(PKG_DIR, "models", "dpt.py")
    bad += [(dpt, m) for m in _absolute_imports(dpt) if m.startswith(models + "midas")]
    for name in ("beit.py", "swin2.py"):
        path = os.path.join(PKG_DIR, "models", name)
        bad += [(path, m) for m in _absolute_imports(path) if m.startswith(models + "midas")]
    assert not bad
    # the relative imports are seen: the train step's forward and BatchNorm
    seen = set(_absolute_imports(os.path.join(PKG_DIR, "training", "fine_tune.py")))
    assert {models + "depth_model.depth_apply", models + "layers.commit_batch_stats"} <= seen
    assert models + "layers.FeatureFusionBlock" in set(_absolute_imports(dpt))


def test_config_defaults_identical():
    from robust_cvd_tpu import config as jcfg
    from robust_cvd_tpu_torch import config as tcfg

    for name in ("PoseOptParams", "LossParams", "FineTuneParams", "PipelineConfig"):
        assert dataclasses.asdict(getattr(tcfg, name)()) == dataclasses.asdict(
            getattr(jcfg, name)()
        ), name
    opt = tcfg.PoseOptParams()
    assert (opt.lm_cg_iters, opt.lm_precond_exact, opt.lm_precond_pose_blocks) == (16, True, True)


def test_writers_byte_identical(tmp_path):
    from robust_cvd_tpu.io import flow_constraints_dat as jdat
    from robust_cvd_tpu.io import frames as jframes
    from robust_cvd_tpu.io import raw as jraw
    from robust_cvd_tpu_torch.io import flow_constraints_dat as tdat
    from robust_cvd_tpu_torch.io import frames as tframes
    from robust_cvd_tpu_torch.io import raw as traw

    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1, (5, 7, 3)).astype(np.float32)
    pairs = {(0, 1): rng.uniform(0, 1, (4, 2, 2)).astype(np.float32),
             (2, 1): rng.uniform(0, 1, (0, 2, 2)).astype(np.float32)}
    trips = {1: rng.uniform(0, 1, (3, 3, 2)).astype(np.float32)}
    for name, jw, tw in (
        ("a.raw", lambda p: jraw.save_raw_float32_image(p, img),
         lambda p: traw.save_raw_float32_image(p, img)),
        ("b.dat", lambda p: jdat.save_flow_constraints_dat(p, 10, pairs, trips),
         lambda p: tdat.save_flow_constraints_dat(p, 10, pairs, trips)),
        ("frames.txt", lambda p: jframes.save_frames_txt(p, 64, 32, [0.0, 0.5]),
         lambda p: tframes.save_frames_txt(p, 64, 32, [0.0, 0.5])),
    ):
        jw(str(tmp_path / ("j" + name)))
        tw(str(tmp_path / ("t" + name)))
        assert (tmp_path / ("j" + name)).read_bytes() == (tmp_path / ("t" + name)).read_bytes()
    ms, lp, lt = tdat.load_flow_constraints_dat(str(tmp_path / "jb.dat"))
    assert ms == 10 and set(lp) == set(pairs) and np.array_equal(lt[1], trips[1])

    # video.dat of the same solver state (a 2x3x1 depth grid with shifts and
    # a 2x2 bicubic warp grid) from both packages' writers
    from robust_cvd_tpu.io import video_dat as jvd
    from robust_cvd_tpu_torch.io import video_dat as tvd

    n = 3
    grid = rng.uniform(0.5, 2, (n, 6)).astype(np.float64)
    shift = rng.normal(0, 0.1, (n, 6))
    warp = rng.normal(0, 0.01, (n, 8))
    pose = rng.normal(0, 1, (n, 7)).astype(np.float32)

    def container(vd):
        frames = [
            vd.DepthFrameInfo(
                vfov=0.8 + 0.01 * i, hfov=1.2, position=tuple(map(float, pose[i, :3])),
                quaternion=tuple(map(float, pose[i, 3:])), enabled=True,
                depth_params=np.stack([grid[i], shift[i]], -1).reshape(-1),
                spatial_params=warp[i],
            )
            for i in range(n)
        ]
        ddesc = vd.XformDesc(type="Depth", depth_type="Grid", value_xform="ScaleShift",
                             grid_size=(3, 2, 1))
        sdesc = vd.XformDesc(type="Spatial", spatial_type="BicubicGrid", grid_size=(2, 2, 0))
        return vd.VideoDat(
            pts=[0.0, 0.5, 1.0],
            color_streams=[vd.ColorStreamInfo("down", "color_down", ".raw", 21, 64, 32)],
            depth_streams=[vd.DepthStreamInfo("depth_midas2", "depth_midas2", ddesc, sdesc,
                                              64, 32, frames)],
            duration=1.0, width=64, height=32,
        )

    jvd.save_video_dat(str(tmp_path / "j.dat"), container(jvd))
    tvd.save_video_dat(str(tmp_path / "t.dat"), container(tvd))
    assert (tmp_path / "j.dat").read_bytes() == (tmp_path / "t.dat").read_bytes()
    back = tvd.load_video_dat(str(tmp_path / "j.dat"))
    assert np.allclose(back.depth_streams[0].frames[2].spatial_params, warp[2])


def test_entry_points_refuse_cpu_without_asking(monkeypatch, tmp_path):
    from robust_cvd_tpu_torch.config import PipelineConfig
    from robust_cvd_tpu_torch.device import resolve_device
    from robust_cvd_tpu_torch.pipeline.process import DatasetProcessor
    from robust_cvd_tpu_torch.training.fine_tune import FineTuner, build_clip_data
    from robust_cvd_tpu_torch.io.frames import save_frames_txt
    from robust_cvd_tpu_torch.io.store import VideoStore
    from robust_cvd_tpu_torch.pipeline.depth import compute_initial_depth
    from robust_cvd_tpu_torch.pipeline.pose import PoseOptimizer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    save_frames_txt(str(tmp_path / "frames.txt"), 64, 32, [0.0])
    store = VideoStore.open(str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        compute_initial_depth(store, None, "midas2")
    with pytest.raises(RuntimeError, match="CUDA"):
        PoseOptimizer(PipelineConfig(), store, "depth_midas2")
    with pytest.raises(RuntimeError, match="CUDA"):
        DatasetProcessor(PipelineConfig())
    from robust_cvd_tpu_torch.main import main

    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--path", str(tmp_path / "clip")])
    # asked for the CPU, the CLI and pipeline() get past the device and stop
    # at the empty clip
    with pytest.raises(FileNotFoundError, match="color_full"):
        main(["--path", str(tmp_path / "clip")], device="cpu")
    with pytest.raises(FileNotFoundError, match="color_full"):
        DatasetProcessor(PipelineConfig(path=str(tmp_path / "clip2")), device="cpu").pipeline()
    from robust_cvd_tpu_torch.pipeline.flow import FlowStage

    with pytest.raises(RuntimeError, match="CUDA"):
        FlowStage(store, None)
    (tmp_path / "models").mkdir()
    (tmp_path / "models" / "raft-things.pth").write_bytes(b"")
    with pytest.raises(RuntimeError, match="CUDA"):
        DatasetProcessor(PipelineConfig(path=str(tmp_path)))._flow_model()
    monkeypatch.delenv("RAFT_CHECKPOINT", raising=False)
    proc = DatasetProcessor(PipelineConfig(path=str(tmp_path / "absent")), device="cpu")
    with pytest.raises(FileNotFoundError, match="RAFT"):
        proc._flow_model()
    clip = build_clip_data(
        np.zeros((2, 4, 4, 3), np.float32), np.ones((2, 4, 4), np.float32),
        [(0, 1, 1.0), (1, 0, 1.0)],
        {(0, 1): np.zeros((4, 4, 2), np.float32), (1, 0): np.zeros((4, 4, 2), np.float32)},
        {(0, 1): np.ones((4, 4)), (1, 0): np.ones((4, 4))}, 0.2, device="cpu",
    )
    with pytest.raises(RuntimeError, match="CUDA"):
        build_clip_data(np.zeros((2, 4, 4, 3)), np.ones((2, 4, 4)), [], {}, {}, 0.2)
    from robust_cvd_tpu_torch.models.midas import MidasV2Adapter, MidasNet

    with pytest.raises(RuntimeError, match="CUDA"):
        FineTuner(PipelineConfig(), MidasV2Adapter(MidasNet(32, (1, 1, 1, 1))), clip, None)
    from robust_cvd_tpu_torch.pipeline.processor import Processor

    with pytest.raises(RuntimeError, match="CUDA"):
        Processor(store)
    from robust_cvd_tpu_torch import quality

    for gate in (quality.static_quality_gate, quality.dynamic_solver_gate,
                 quality.contaminated_constraint_gate):
        with pytest.raises(RuntimeError, match="CUDA"):
            gate(tiny=True)
    from robust_cvd_tpu_torch.pipeline.masks import compute_dynamic_masks_rcnn

    (tmp_path / "models" / "mask_rcnn.pkl").write_bytes(b"")
    with pytest.raises(RuntimeError, match="CUDA"):
        compute_dynamic_masks_rcnn(store, str(tmp_path / "models" / "mask_rcnn.pkl"))
    assert resolve_device("cpu").type == "cpu"


def test_native_build_failure_raises(monkeypatch, tmp_path):
    from robust_cvd_tpu_torch import native

    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC", str(bad))
    monkeypatch.setattr(native, "_SO", str(tmp_path / "bad.so"))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="failed"):
        native.build_pair_candidates(
            np.zeros((4, 4), np.float32), np.zeros((4, 4, 2), np.float32),
            np.ones((4, 4), bool), 2,
        )
