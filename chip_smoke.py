"""Smoke run of the PyTorch/CUDA port (robust_cvd_tpu_torch) on one GPU.

    python3 chip_smoke.py [--frames 100] [--seed 0]

Phases, each of which raises on failure (exit code 1):

1. device: requires CUDA; prints the card's name and power limit.
2. kernels: builds every kernel of the path from csrc/ and holds each
   against its plain PyTorch version on the card, at the path's shape and at
   an odd shape with partial tiles (tolerance 1e-4 * max|ref| + 1e-5), and
   times both with CUDA events (median of 20 after warm-up).
3. solver: the pose solve of a small exact-reprojection problem on the card
   against the same solve on the CPU (poses within 1e-3).
4. path: a synthetic 224x384 clip (a seeded texture panning by a fixed
   number of pixels per frame, hierarchical2 pairs, exact flows, in-bounds
   consistency masks) goes through the port's entry points: initial depth
   with the full-width MiDaS-v2 (seeded random weights unless
   <clip>/models/midas_v21-f6b98070.pt exists), PoseOptimizer (whose
   constructor builds the flow constraints through the corner kernel) and a
   cold optimize_poses() with the default PoseOptParams. Checks finite
   depth, constraints and parameters, a kernel launch on the path, and that
   every LM solve ended below its starting cost.

Prints per-stage seconds, a {"kernels": [...]} line, the nvidia-smi line,
and as its last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

H, W = 224, 384  # color_down of the bench clip (bench.py)
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_F32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, arg, reps: int = 20) -> float:
    """Median CUDA-event time of fn(arg) after warm-up, in ms."""
    import torch

    for _ in range(3):
        fn(arg)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(arg)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def kernel_phase(n_frames: int, seed: int) -> dict:
    import torch

    from robust_cvd_tpu_torch.ops import corner
    from robust_cvd_tpu_torch.ops._build import load_cuda_library

    t0 = time.perf_counter()
    load_cuda_library("corner_min_eigenval")
    print(f"kernel build: corner_min_eigenval {time.perf_counter() - t0:.2f} s")

    g = torch.Generator().manual_seed(seed)
    result = {}
    for shape in ((n_frames, H, W), (3, 37, 53)):
        gray = torch.rand(shape, generator=g).cuda()
        got = corner.corner_min_eigenval(gray)
        torch.cuda.synchronize()
        ref = corner.corner_min_eigenval_plain(gray)
        err = (got - ref).abs().max().item()
        tol = 1e-4 * ref.abs().max().item() + 1e-5
        print(f"corner_min_eigenval {shape}: max|err| {err:.3e} (tolerance {tol:.3e})")
        if not err <= tol:
            raise AssertionError(f"corner kernel disagrees with its plain version at {shape}")
        if shape[0] == n_frames:
            ms = time_ms(corner.corner_min_eigenval, gray)
            plain_ms = time_ms(corner.corner_min_eigenval_plain, gray)
            pixels = gray.numel()
            bytes_ms = 8.0 * pixels / PEAK_BYTES_PER_S * 1e3  # one f32 read + write
            ops_ms = 50.0 * pixels / PEAK_F32_FLOPS * 1e3  # ~50 flops per pixel
            result = {
                "name": "corner_min_eigenval",
                "route": "cuda",
                "source": "robust_cvd_tpu_torch/csrc/corner_min_eigenval.cu",
                "replaces": "robust_cvd_tpu/ops/pallas_kernels.py:74",
                "max_abs_err": err,
                "ms": ms,
                "plain_ms": plain_ms,
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "library_ms": None,  # no single PyTorch call computes it
            }
            print(f"corner_min_eigenval {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"bound {result['bound_ms']:.4f} ms")
    return result


def solver_phase(seed: int) -> None:
    """A 6-frame exact-reprojection problem with corrupted per-frame depth
    scales (the shape of bench.py::make_clip_problem), solved on the card
    and on the CPU."""
    import torch

    from robust_cvd_tpu_torch.config import PoseOptParams
    from robust_cvd_tpu_torch.solver import pose_opt, residuals
    from robust_cvd_tpu_torch.utils.frame_sampling import sample_pairs

    n, c = 6, 16
    rng = np.random.default_rng(seed)
    pairs = np.asarray(sample_pairs(n, ("hierarchical2",), two_way=True), np.int64)
    p = len(pairs)
    pose = np.zeros((n, 6), np.float32)
    pose[:, 0] = 0.05 * np.arange(n)
    loc0 = rng.uniform(-0.9, 0.9, (p, c, 2)).astype(np.float32)
    depth0 = rng.uniform(1.5, 4.0, (p, c)).astype(np.float32)
    fx = torch.full((p,), 0.5 * 16 / 9)
    fy = torch.full((p,), 0.5)
    pose_t = torch.from_numpy(pose)
    world = residuals.camera_to_world(
        torch.cat([torch.from_numpy(loc0), torch.from_numpy(depth0)[..., None]], -1),
        fx, fy, pose_t[pairs[:, 0]],
    )
    p1 = residuals.world_to_camera(world, fx, fy, pose_t[pairs[:, 1]]).numpy()
    scale = rng.uniform(0.7, 1.4, n).astype(np.float32)
    opt = dataclasses.replace(PoseOptParams(), num_steps=2, ctf_long=3, ctf_short=2)

    def solve(device):
        data = residuals.ConstraintData(
            pair=torch.from_numpy(pairs), loc0=torch.from_numpy(loc0),
            loc1=torch.from_numpy(p1[..., :2].copy()),
            depth0=torch.from_numpy(depth0 / scale[pairs[:, 0], None]),
            depth1=torch.from_numpy(p1[..., 2] / scale[pairs[:, 1], None]),
            weight=torch.ones((p, c)),
        )
        inputs = pose_opt.PoseOptInputs(
            data=residuals.ConstraintData(*[t.to(device) for t in data]),
            median_depth=torch.from_numpy(2.5 / scale).to(device),
            aspect=16 / 9, num_frames=n,
        )
        return pose_opt.run(opt, inputs).pose.cpu()

    gpu, cpu = solve("cuda"), solve("cpu")
    err = (gpu - cpu).abs().max().item()
    print(f"solver: 6-frame cold solve, card vs CPU poses max|err| {err:.3e} (tolerance 1e-3)")
    if not err <= 1e-3:
        raise AssertionError("the solver on the card disagrees with the CPU")


def make_clip(base: str, n: int, seed: int, shift: int = 2) -> None:
    """A synthetic clip: frame i is columns [i*shift, i*shift + W) of one
    seeded texture, so the flow from i to j is exactly (i - j) * shift px in
    x; a pair's consistency mask is where the flow target lands in bounds."""
    from robust_cvd_tpu_torch.io import raw
    from robust_cvd_tpu_torch.io.frames import save_frames_txt
    from robust_cvd_tpu_torch.io.store import VideoStore, frame_name
    from robust_cvd_tpu_torch.utils.frame_sampling import sample_pairs

    rng = np.random.default_rng(seed)
    noise = rng.uniform(0.0, 1.0, (H + 2, W + shift * (n - 1) + 2, 3)).astype(np.float32)
    texture = sum(  # 3x3 box blur: structure at several scales
        noise[dy : dy + H, dx : dx + noise.shape[1] - 2]
        for dy in range(3) for dx in range(3)
    ) / 9.0
    os.makedirs(os.path.join(base, "color_down"))
    for i in range(n):
        raw.save_raw_float32_image(
            os.path.join(base, "color_down", frame_name(i, ".raw")),
            texture[:, i * shift : i * shift + W],
        )
    save_frames_txt(os.path.join(base, "frames.txt"), W, H, [i / 30 for i in range(n)])
    store = VideoStore.open(base)
    entries = []
    xs = np.arange(W, dtype=np.float32)
    for i, j in sample_pairs(n, ("hierarchical2",), two_way=True):
        dx = float((i - j) * shift)
        flow = np.zeros((H, W, 2), np.float32)
        flow[..., 0] = dx
        target = (xs + dx + 0.5).astype(np.int32)
        mask = np.broadcast_to((target >= 0) & (target < W), (H, W))
        store.save_flow(i, j, flow)
        store.save_flow_mask(i, j, mask)
        entries.append((i, j, float(mask.mean())))
    store.save_flow_list(entries)


def path_phase(n_frames: int, seed: int, device: str = "cuda", net=None) -> int:
    """Drives the port's main path with the full-width MiDaS-v2 (or `net`);
    returns the corner kernel's launches."""
    import torch

    from robust_cvd_tpu_torch.config import PipelineConfig
    from robust_cvd_tpu_torch.io.store import VideoStore
    from robust_cvd_tpu_torch.models import midas
    from robust_cvd_tpu_torch.ops import corner
    from robust_cvd_tpu_torch.pipeline.depth import compute_initial_depth
    from robust_cvd_tpu_torch.pipeline.pose import PoseOptimizer

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    with tempfile.TemporaryDirectory(prefix="chip_smoke_clip_") as base:
        t0 = time.perf_counter()
        make_clip(base, n_frames, seed)
        print(f"stage clip_build_s {time.perf_counter() - t0:.3f}")

        ckpt = os.path.join(base, "models", "midas_v21-f6b98070.pt")
        net = midas.MidasNet() if net is None else net
        if os.path.exists(ckpt):
            net.load_state_dict(midas.load_checkpoint(ckpt))
            print("midas weights: checkpoint")
        else:
            midas.seeded_init_(net, seed)
            print(f"midas weights: seeded random (seed {seed})")
        params = sum(p.numel() for p in net.parameters())
        print(f"midas: {params} parameters")

        corner.corner_min_eigenval.launches = 0
        store = VideoStore.open(base)
        stats = {}
        t0 = time.perf_counter()
        depth = compute_initial_depth(
            store, midas.MidasV2Adapter(net), "midas2", stats=stats, device=device
        )
        print(f"stage initial_depth_s {time.perf_counter() - t0:.3f} "
              + " ".join(f"{k} {v:.3f}" for k, v in stats.items()))
        if depth.shape != (n_frames, H, W) or not np.isfinite(depth).all():
            raise AssertionError(f"bad depth {depth.shape}")
        if not (depth > 0).all():
            raise AssertionError("non-positive depth")
        q = np.quantile(depth, [0.0, 0.5, 1.0])
        print(f"depth min/median/max {q[0]:.4f} {q[1]:.4f} {q[2]:.4f}")

        cfg = PipelineConfig(path=base)
        t0 = time.perf_counter()
        po = PoseOptimizer(cfg, store, "depth_midas2", device=device)
        sync()
        print(f"stage constraints_s {time.perf_counter() - t0:.3f}")
        n_pair = sum(len(po.pairs[k].loc0) for k in po.pair_keys)
        n_trip = sum(len(po.triplets[t].loc) for t in po.triplet_keys)
        print(f"constraints: {len(po.pair_keys)} pairs, {n_pair} pair constraints, "
              f"{len(po.triplet_keys)} triplets, {n_trip} triplet constraints")
        for pc in po.pairs.values():
            if not (np.isfinite(pc.loc0).all() and np.isfinite(pc.loc1).all()):
                raise AssertionError("non-finite constraint")
        if n_pair == 0:
            raise AssertionError("no constraints")

        t0 = time.perf_counter()
        sp = po.optimize_poses()
        sync()
        print(f"stage pose_solve_s {time.perf_counter() - t0:.3f}")
        launches = corner.corner_min_eigenval.launches
        data = po.last_inputs.data
        print(f"solver problem: P {data.weight.shape[0]} pairs x C {data.weight.shape[1]} "
              f"samples, {int(data.weight.sum().item())} weighted")
        for e in po.solve_log:
            print("solve " + json.dumps(e))
        for name, t in sp._asdict().items():
            if t is not None and not torch.isfinite(t).all():
                raise AssertionError(f"non-finite solved {name}")
        if not all(e["cost"] < e["cost0"] for e in po.solve_log):
            raise AssertionError("an LM solve did not lower its cost")
        print(f"solve totals: {sum(e['outer'] for e in po.solve_log)} outer steps, "
              f"{sum(e['cg'] for e in po.solve_log)} CG iterations, "
              f"{sum(e['syncs'] for e in po.solve_log)} host syncs")
        print(f"final depth grid {tuple(sp.depth_grid.shape[1:])}, "
              f"pose |t| max {sp.pose[:, :3].abs().max().item():.4f}")
    print(f"corner_min_eigenval launches on the path: {launches}")
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=100,
                    help="clip length (100 = the bench clip)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import robust_cvd_tpu_torch  # noqa: F401  (fails outside a checkout)

    t_start = time.perf_counter()
    smi = device_line()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    print(f"frames: {args.frames}" + (" (the bench clip length)" if args.frames == 100 else " (cut)"))
    kernel = kernel_phase(args.frames, args.seed)
    solver_phase(args.seed)
    kernel["launches"] = path_phase(args.frames, args.seed)
    if kernel["launches"] < 1:
        raise AssertionError("the corner kernel was not launched on the path")
    print(f"total_s {time.perf_counter() - t_start:.3f}")
    print(json.dumps({"kernels": [kernel]}))
    print(smi)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
