"""Smoke run of the PyTorch/CUDA port (robust_cvd_tpu_torch) on one GPU.

    python3 chip_smoke.py [--frames 100] [--epochs 10] [--seed 0]

Phases, each of which raises on failure (exit code 1):

1. device: requires CUDA; prints the card's name and power limit.
2. kernels: builds every kernel of the path from csrc/ (one nvcc per source,
   started together) and holds each against its plain PyTorch version on
   the card. Each kernel's time (`ms`) is the card's: K back-to-back
   launches through its raw ctypes launcher (no wrapper on the host)
   between one CUDA event pair, over buffers that one cycle of launches
   cannot find in the L2, divided by K (`back_to_back_ms`). Beside it,
   `call_ms` is one wrapper call between an event pair (median after
   warm-up), what the path pays per call; the plain version is timed that
   way and the PyTorch library call, where one exists, back to back:
   - corner response at the path's shape, at the edge shapes of
     tests/test_torch_pkg_corner.py (every ragged path of the kernel), on a
     non-contiguous input, at N = 0 and at N = 70,000 frames (tolerance
     1e-4 * max|ref| + 1e-5);
   - Adam at the full-width MiDaS-v2 parameter count and at 1,000,003, with
     bias correction on and off, at step counts 0 and 7: mu', nu' and the
     update p' - p within 1e-4 * max|ref| + 1e-7; with the guard flag false
     all four buffers stay bitwise unchanged.
3. solver: the pose solve of a small exact-reprojection problem on the card
   against the same solve on the CPU (poses within 1e-3).
4. train step: two FineTuner steps of the small MiDaS net (features 32,
   backbone (1, 1, 1, 1)) on a 4-frame 32x64 clip on the card (Adam kernel)
   and on the CPU (plain Adam), convolutions without TF32: losses, BatchNorm
   statistics and parameters within 1e-4 relative, mu and nu within 1e-3
   (each against the largest magnitude of its flat buffer; step_phase says
   why).
5. pose path: a synthetic 224x384 clip (a seeded texture panning by a fixed
   number of pixels per frame, hierarchical2 pairs, exact flows, in-bounds
   consistency masks) goes through the port's entry points: initial depth
   with the full-width MiDaS-v2 (seeded random weights unless
   <clip>/models/midas_v21-f6b98070.pt exists), PoseOptimizer (whose
   constructor builds the flow constraints through the corner kernel) and a
   cold optimize_poses() with the default PoseOptParams. Checks finite
   depth, constraints and parameters, a corner kernel launch on the path,
   and that every LM solve ended below its starting cost.
6. fine-tune path: DatasetProcessor(...).fine_tune(store, depth) on the same
   clip (the cached flow_constraints.dat is reused) with the full-width
   MiDaS-v2 and the default FineTuneParams and LossParams (--epochs cuts
   the 10 epochs): the cold solve, the epochs of training (one Adam kernel
   launch per step), a depth refresh and a warm re-solve after each epoch,
   the fine-tuned depth stream and video.dat. Checks finite losses, Adam
   launches equal to the train steps with none skipped, the cold solve
   below its start and every warm solve at or below its start, finite
   outputs, and parameters that moved.
7. profile: torch.profiler over 5 steady-state train steps of that path:
   the 10 device kernels with the most time, the share of index, gather and
   scatter kernels (the loss stack's sampler), the device idle share.

Prints per-stage seconds, a {"kernels": [...]} line, the nvidia-smi line,
and as its last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

H, W = 224, 384  # color_down of the bench clip (bench.py)
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_F32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores
KERNELS = ("corner_min_eigenval", "adam")  # csrc/<name>.cu
L2_BYTES = 50e6  # H100 SXM
BACK_TO_BACK = 60  # launches between one event pair
SPIN_CYCLES = 50_000_000  # torch.cuda._sleep ahead of them, ~25 ms
# The corner kernel's edge shapes, as in tests/test_torch_pkg_corner.py:
# W % 4 in {1, 2, 3} (the scalar path), H not a multiple of the 32-row
# strip, W narrower than one 128-column band, a partial last band on the
# float4 path, H = W = 2.
CORNER_EDGE_SHAPES = ((3, 37, 53), (2, 24, 128), (3, 17, 33), (2, 40, 129),
                      (1, 37, 130), (3, 64, 131), (2, 64, 200), (3, 2, 2))


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, *args, reps: int = 20) -> float:
    """Median CUDA-event time of fn(*args) after warm-up, in ms."""
    import torch

    for _ in range(3):
        fn(*args)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def back_to_back_ms(launch, k: int = BACK_TO_BACK, warm: int = 4) -> float:
    """Device ms per call of launch(i), i = 0..k-1, enqueued back to back
    between one CUDA event pair (elapsed / k), after `warm` untimed calls.

    A spin kernel (torch.cuda._sleep) runs ahead of the first event, so the
    host has enqueued all k calls before the card reaches them and the time
    is the card's, not the host's enqueue rate; raises if the host took
    longer than the spin."""
    import torch

    for i in range(warm):
        launch(i)
    torch.cuda.synchronize()
    spin, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    spin.record()
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for i in range(k):
        launch(i)
    host_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    end.synchronize()
    if host_ms >= spin.elapsed_time(start):
        raise AssertionError(f"enqueueing {k} calls took {host_ms:.3f} ms, longer than "
                             f"the {spin.elapsed_time(start):.3f} ms spin ahead of them")
    return start.elapsed_time(end) / k


def build_kernels() -> None:
    """Compile and load every csrc/<name>.cu, all builds started together
    (one nvcc process each)."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        for name, dt in zip(KERNELS, pool.map(_timed_build, KERNELS)):
            print(f"kernel build: {name} {dt:.2f} s")
    print(f"kernel builds, all: {time.perf_counter() - t0:.2f} s")


def _timed_build(name: str) -> float:
    from robust_cvd_tpu_torch.ops._build import load_cuda_library

    t0 = time.perf_counter()
    load_cuda_library(name)
    return time.perf_counter() - t0


def corner_check(gray, label: str) -> float:
    """The corner kernel (through its wrapper) against its plain version on
    one input; returns max|err|."""
    import torch

    from robust_cvd_tpu_torch.ops import corner

    before = corner.corner_min_eigenval.launches
    got = corner.corner_min_eigenval(gray)
    torch.cuda.synchronize()
    ref = corner.corner_min_eigenval_plain(gray)
    if got.shape != gray.shape or corner.corner_min_eigenval.launches != before + (
            gray.shape[0] > 0):
        raise AssertionError(f"corner kernel at {label}: shape {tuple(got.shape)}, "
                             f"{corner.corner_min_eigenval.launches - before} launches")
    if ref.numel() == 0:
        print(f"corner_min_eigenval {label}: empty output, no launch")
        return 0.0
    err = (got - ref).abs().max().item()
    tol = 1e-4 * ref.abs().max().item() + 1e-5
    print(f"corner_min_eigenval {label}: max|err| {err:.3e} (tolerance {tol:.3e})")
    if not err <= tol:
        raise AssertionError(f"corner kernel disagrees with its plain version at {label}")
    return err


def corner_phase(n_frames: int, seed: int) -> dict:
    """The corner kernel against its plain version at the path's shape and
    every edge shape; its kernels-line entry."""
    import torch

    g = torch.Generator().manual_seed(seed)
    for shape in CORNER_EDGE_SHAPES + ((0, 24, 128), (70_000, 3, 5)):
        corner_check(torch.rand(shape, generator=g).cuda(), str(shape))
    corner_check(torch.rand((2, 48, 24), generator=g).cuda().transpose(1, 2),
                 "(2, 24, 48) non-contiguous")
    gray = torch.rand((n_frames, H, W), generator=g).cuda()
    return corner_entry(gray, corner_check(gray, str(tuple(gray.shape))))


def corner_entry(gray, err: float) -> dict:
    """Times the corner kernel (raw launcher, back to back) on `gray` and
    further input/output pairs, at least 4 and a cycle of at least twice
    the L2; the wrapper (one call) and the plain version on `gray`. Returns
    its kernels-line entry."""
    import torch

    from robust_cvd_tpu_torch.ops import corner

    n, h, w = gray.shape
    nbytes = 8.0 * gray.numel()  # one f32 read + one f32 write per pixel
    pairs = max(4, math.ceil(2 * L2_BYTES / nbytes))
    ins = [gray] + [torch.rand_like(gray) for _ in range(pairs - 1)]
    outs = [torch.empty_like(gray) for _ in range(pairs)]
    fn = corner._kernel()
    stream = torch.cuda.current_stream().cuda_stream

    def launch(i):
        if fn(ins[i % pairs].data_ptr(), outs[i % pairs].data_ptr(), n, h, w, stream):
            raise RuntimeError("corner kernel launch failed")

    ms = back_to_back_ms(launch)
    call_ms = time_ms(corner.corner_min_eigenval, gray)
    plain_ms = time_ms(corner.corner_min_eigenval_plain, gray)
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = 50.0 * gray.numel() / PEAK_F32_FLOPS * 1e3  # ~50 flops per pixel
    result = {
        "name": "corner_min_eigenval",
        "route": "cuda",
        "source": "robust_cvd_tpu_torch/csrc/corner_min_eigenval.cu",
        "replaces": "robust_cvd_tpu/ops/pallas_kernels.py:74",
        "max_abs_err": err,
        "ms": ms,
        "call_ms": call_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,  # no single PyTorch call computes it
        "gbps": nbytes / ms * 1e-6,
        "share_of_bound": max(bytes_ms, ops_ms) / ms,
    }
    print(f"corner_min_eigenval {tuple(gray.shape)}: kernel {ms:.4f} ms back to back over "
          f"{pairs} cold pairs ({result['gbps']:.1f} GB/s, {result['share_of_bound']:.3f} "
          f"of the bound), one wrapper call {call_ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {result['bound_ms']:.4f} ms")
    del ins, outs
    torch.cuda.empty_cache()
    return result


ADAM_REPLACES = "tools/probe_adam_bw.py:105"


def adam_phase(n_full: int, seed: int) -> dict:
    """The Adam kernel against its plain version; its kernels-line entry
    (timed at n_full with bias correction, as on the fine-tune path)."""
    import torch

    from robust_cvd_tpu_torch.ops import adam

    g = torch.Generator(device="cuda").manual_seed(seed)
    lr = 1e-4
    result = {}
    worst = 0.0
    for n in (n_full, 1_000_003):
        base = [torch.randn(n, generator=g, device="cuda") for _ in range(3)]
        base.append(torch.rand(n, generator=g, device="cuda") * 1e-2)  # nu >= 0
        base[1].mul_(1e-2)
        for bias in (True, False):
            for count0 in (0, 7):
                count = torch.tensor(count0, dtype=torch.int32, device="cuda")
                ok = torch.ones((), dtype=torch.bool, device="cuda")
                got = [t.clone() for t in base]
                ref = [t.clone() for t in base]
                adam.adam_update(*got, count, ok, lr, bias_correction=bias)
                torch.cuda.synchronize()
                adam.adam_update_plain(*ref, count, ok, lr, bias_correction=bias)
                for what, a, b in (("update", got[0] - base[0], ref[0] - base[0]),
                                   ("mu", got[2], ref[2]), ("nu", got[3], ref[3])):
                    err = (a - b).abs().max().item()
                    tol = 1e-4 * b.abs().max().item() + 1e-7
                    worst = max(worst, err)
                    if not err <= tol:
                        raise AssertionError(
                            f"Adam kernel {what} disagrees at n={n}, bias correction "
                            f"{bias}, count {count0}: {err:.3e} > {tol:.3e}")
                if int(count) != count0:
                    raise AssertionError("the Adam kernel wrote the step count")
        skip = [t.clone() for t in base]
        adam.adam_update(*skip, count, torch.zeros_like(ok), lr)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(skip, base)):
            raise AssertionError("the Adam kernel wrote with its guard flag false")
        print(f"adam n={n}: kernel vs plain max|err| {worst:.3e} over mu, nu and the "
              f"update (bias correction on/off, count 0/7); guard false leaves all "
              f"four buffers bitwise unchanged")
        if n == n_full:
            # one set of buffers (7 x 4 B x n = 2.95 GB a launch) is far
            # larger than the L2, so back-to-back launches reuse it cold
            count = torch.zeros((), dtype=torch.int32, device="cuda")
            ok = torch.ones((), dtype=torch.bool, device="cuda")
            bufs = [t.clone() for t in base]
            fn = adam._kernel()
            stream = torch.cuda.current_stream().cuda_stream
            ptrs = [t.data_ptr() for t in bufs]

            def launch(_):
                if fn(*ptrs, n, lr, 0.9, 0.999, 1e-8, 1, count.data_ptr(),
                      ok.data_ptr(), stream):
                    raise RuntimeError("adam kernel launch failed")

            ms = back_to_back_ms(launch)
            call_ms = time_ms(lambda: adam.adam_update(*bufs, count, ok, lr))
            plain_ms = time_ms(lambda: adam.adam_update_plain(*bufs, count, ok, lr))
            flat = torch.nn.Parameter(base[0].clone())
            flat.grad = base[1].clone()
            lib = torch.optim.Adam([flat], lr=lr, fused=True)
            library_ms = back_to_back_ms(lambda _: lib.step())
            nbytes = 7 * 4.0 * n  # 4 streams in, 3 out
            bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
            ops_ms = 14.0 * n / PEAK_F32_FLOPS * 1e3  # ~14 flops per element
            result = {
                "name": "adam",
                "route": "cuda",
                "source": "robust_cvd_tpu_torch/csrc/adam.cu",
                "replaces": ADAM_REPLACES,
                "max_abs_err": worst,
                "ms": ms,
                "call_ms": call_ms,
                "plain_ms": plain_ms,
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "library_ms": library_ms,
                "gbps": nbytes / ms * 1e-6,
                "share_of_bound": max(bytes_ms, ops_ms) / ms,
            }
            print(f"adam n={n}: kernel {ms:.4f} ms back to back ({result['gbps']:.1f} GB/s, "
                  f"{result['share_of_bound']:.3f} of the bound), one wrapper call "
                  f"{call_ms:.4f} ms, plain {plain_ms:.4f} ms, torch.optim.Adam(fused=True) "
                  f"{library_ms:.4f} ms back to back, bound {result['bound_ms']:.4f} ms")
            del bufs, flat, lib
        del base
    torch.cuda.empty_cache()
    return result


def small_tuner(device: str, seed: int, n: int = 4, h: int = 32, w: int = 64):
    """A FineTuner of the small MiDaS net on an n-frame h x w clip (seeded
    images, depths, flows and masks; a pose state from seeded poses, a 2x3
    depth grid and a spatial warp), convolutions without TF32.

    The net's BatchNorms ahead of a ReLU get a bias of +3. With random
    weights about a quarter of such small configurations have a ReLU input
    within float32 rounding of 0, where two float32 implementations take
    different ReLU decisions and the gradients upstream move by up to 1e-3
    of their largest value (measured on the CPU, float32 against float64,
    12 seeds); with the shift none did, and mu and nu agreed within 2.3e-5."""
    import torch

    from robust_cvd_tpu_torch.config import FineTuneParams, PipelineConfig
    from robust_cvd_tpu_torch.models import midas
    from robust_cvd_tpu_torch.solver.residuals import SolverParams
    from robust_cvd_tpu_torch.training.fine_tune import (
        FineTuner, build_clip_data, pose_state_from_solver,
    )

    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 1, (n, h, w, 3)).astype(np.float32)
    depth = rng.uniform(1, 3, (n, h, w)).astype(np.float32)
    flow_list, flows, masks = [], {}, {}
    for i in range(n):
        for j in range(n):
            if i != j and abs(i - j) <= 2:
                flow_list.append((i, j, 0.9))
                flows[(i, j)] = rng.normal(0, 1, (h, w, 2)).astype(np.float32)
                masks[(i, j)] = (rng.uniform(0, 1, (h, w)) > 0.3).astype(np.float32)
    sp = SolverParams(
        pose=torch.from_numpy(rng.normal(0, 0.02, (n, 6)).astype(np.float32)),
        focal=torch.full((n,), 0.5),
        depth_grid=torch.from_numpy(rng.uniform(0.8, 1.2, (n, 1, 2, 3)).astype(np.float32)),
        spatial_grid=torch.from_numpy(rng.normal(0, 0.01, (n, 1, 1, 2)).astype(np.float32)),
    )
    net = midas.seeded_init_(midas.MidasNet(features=32, backbone_layers=(1, 1, 1, 1)), seed)
    with torch.no_grad():
        for name, m in net.named_modules():
            if isinstance(m, midas.BatchNorm2d) and not name.endswith("bn3"):
                m.bias.fill_(3.0)
    cfg = PipelineConfig(ft=FineTuneParams(save_tensorboard=False))
    clip = build_clip_data(images, depth, flow_list, flows, masks, 0.2, device=device)
    tuner = FineTuner(cfg, midas.MidasV2Adapter(net), clip, None, device=device,
                      cudnn_tf32=False)
    tuner.pose_state = pose_state_from_solver(
        SolverParams(*[t.to(device) for t in sp[:4]]), (h, w), w / h, clip.depth_orig
    )
    return tuner


def step_phase(seed: int) -> None:
    """Two train steps of the small net on the card (Adam kernel) and on the
    CPU (plain Adam), without TF32 on either. Losses, parameters and
    BatchNorm statistics agree within 1e-4 relative; mu and nu within 1e-3:
    the head's 1x1 convolution (scratch.output_conv.4) sums 8,192 products
    with heavy cancellation into each weight gradient, card and CPU sum
    them in different orders (the card's order varies from call to call),
    and in float32 mu there differs by up to 3.5e-4 of the largest gradient
    and nu, a square, by up to 4.2e-4 (14 runs on the H100, 3 seeds; the
    CPU's float32 step differs from its float64 step as much), while every
    other tensor agreed within 1e-5."""
    import torch

    from robust_cvd_tpu_torch.models import midas

    def run(device):
        tuner = small_tuner(device, seed)
        losses = []
        for ids in ((2, 0), (1, 3)):
            loss, _, ok = tuner.train_step(torch.tensor(ids, device=device))
            if not bool(ok):
                raise AssertionError(f"train step on {device} was skipped")
            losses.append(loss.item())
        opt = tuner.optimizer
        stats = torch.cat([torch.cat([m.running_mean, m.running_var])
                           for m in midas.batch_norms(tuner.net)])
        return losses, {"params": opt.flat, "mu": opt.mu, "nu": opt.nu,
                        "batch_stats": stats, "count": opt.count}

    from robust_cvd_tpu_torch.ops import adam

    before = adam.adam_update.launches
    gpu_losses, gpu = run("cuda")
    if adam.adam_update.launches != before + 2:
        raise AssertionError("the card's train steps did not launch the Adam kernel")
    cpu_losses, cpu = run("cpu")
    err = max(abs(a - b) / abs(b) for a, b in zip(gpu_losses, cpu_losses))
    report = [f"losses {err:.3e} (1e-4)"]
    ok = err <= 1e-4
    for name, tol in (("params", 1e-4), ("batch_stats", 1e-4), ("mu", 1e-3), ("nu", 1e-3)):
        a, b = gpu[name].cpu(), cpu[name]
        rel = ((a - b).abs().max() / b.abs().max()).item()
        report.append(f"{name} {rel:.3e} ({tol:g})")
        ok = ok and rel <= tol
    ok = ok and int(gpu["count"]) == int(cpu["count"]) == 2
    print("train step, card vs CPU (2 steps, small net, 4x32x64, no TF32): relative "
          "max|err| (tolerance) " + ", ".join(report))
    if not ok:
        raise AssertionError("the train step on the card disagrees with the CPU")


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


def path_phase(base: str, n_frames: int, seed: int, device: str = "cuda", net=None):
    """Drives the pose path on a clip made in `base` with the full-width
    MiDaS-v2 (or `net`); returns the corner kernel's launches, the initial
    depth and the net."""
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
    print(f"corner_min_eigenval launches on the pose path: {launches}")
    return launches, depth, net


def finetune_phase(base: str, depth, net, seed: int, epochs: int, device: str = "cuda"):
    """Drives DatasetProcessor.fine_tune on the pose path's clip; returns the
    tuner and the Adam kernel's launches on this path."""
    import torch

    from robust_cvd_tpu_torch.config import FineTuneParams, PipelineConfig
    from robust_cvd_tpu_torch.io import raw
    from robust_cvd_tpu_torch.io.store import VideoStore
    from robust_cvd_tpu_torch.io.video_dat import load_video_dat
    from robust_cvd_tpu_torch.models import midas
    from robust_cvd_tpu_torch.ops import adam, corner
    from robust_cvd_tpu_torch.pipeline.process import DatasetProcessor

    cfg = PipelineConfig(path=base, ft=FineTuneParams(num_epochs=epochs))
    store = VideoStore.open(base)
    adam.adam_update.launches = 0
    corner.corner_min_eigenval.launches = 0
    t0 = time.perf_counter()
    tuner = DatasetProcessor(
        cfg, models={"depth": midas.MidasV2Adapter(net)}, device=device
    ).fine_tune(store, depth)
    if device == "cuda":
        torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = adam.adam_update.launches
    print(f"stage fine_tune_s {total:.3f} " + " ".join(
        f"{k} {v:.3f}" for k, v in tuner.stats.items()))
    print(f"fine-tune: {int(tuner.clip.pair_idx.shape[0])} training pairs, batch "
          f"{cfg.ft.batch_size}, {epochs} epochs, lr {tuner.optimizer.lr:g}, "
          f"{tuner.optimizer.numel} parameters")
    for h in tuner.history:
        print("epoch " + json.dumps(h))
    for e in tuner.solve_log:
        print("solve " + json.dumps(e))

    steps = sum(h["steps"] for h in tuner.history)
    skipped = [h["epoch"] for h in tuner.history if h["skipped"]]
    if skipped:
        print(f"epochs with skipped steps: {skipped}")
    if not all(np.isfinite(h["loss"]) for h in tuner.history):
        raise AssertionError("a non-finite epoch loss")
    want = steps if device == "cuda" else 0
    if launches != want or skipped:
        raise AssertionError(f"Adam launches {launches} for {steps} train steps, "
                             f"skipped in epochs {skipped}")
    if int(tuner.optimizer.count) != steps:
        raise AssertionError("the Adam step count does not match the train steps")
    print(f"adam launches on the fine-tune path: {launches} for {steps} train steps "
          f"(corner launches {corner.corner_min_eigenval.launches}: constraints cached)")
    cold = [e for e in tuner.solve_log if e["stage"] != "warm"]
    warm = [e for e in tuner.solve_log if e["stage"] == "warm"]
    if len(warm) != epochs or not cold:
        raise AssertionError(f"{len(cold)} cold and {len(warm)} warm solves for {epochs} epochs")
    if not all(e["cost"] < e["cost0"] for e in cold):
        raise AssertionError("a cold LM solve did not lower its cost")
    if not all(e["cost"] <= e["cost0"] for e in warm):
        raise AssertionError("a warm LM solve raised its cost")
    print(f"solves: {len(cold)} cold below their start, {len(warm)} warm at or below "
          f"their start; warm host syncs {sum(e['syncs'] for e in warm)}")

    stream = tuner.pose.streams[-1]
    disp = np.stack([
        raw.load_raw_float32_image(os.path.join(stream.dir, "depth", f"frame_{i:06d}.raw"))
        for i in range(store.num_frames)
    ])
    if not (np.isfinite(disp).all() and (disp > 0).all()):
        raise AssertionError("non-finite or non-positive fine-tuned disparity")
    vd = load_video_dat(os.path.join(base, "video.dat"))
    vals = np.array([[f.vfov, f.hfov, *f.position, *f.quaternion, *f.depth_params]
                     for s_ in vd.depth_streams for f in s_.frames], np.float64)
    if not np.isfinite(vals).all() or len(vd.depth_streams) != len(tuner.pose.streams):
        raise AssertionError("bad video.dat")
    moved = (tuner.optimizer.flat - tuner.optimizer.init).abs().max().item()
    if not moved > 0:
        raise AssertionError("the parameters did not move")
    print(f"outputs: stream {os.path.relpath(stream.dir, base)} ({disp.shape[0]} frames, "
          f"disparity {disp.min():.4f}..{disp.max():.4f}), video.dat with "
          f"{len(vd.depth_streams)} depth streams; parameters moved by up to {moved:.3e}")
    return tuner, launches


def profile_phase(tuner, steps: int = 5) -> None:
    """torch.profiler over `steps` steady-state train steps of the tuner."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    n_pairs = int(tuner.clip.pair_idx.shape[0])
    batch = tuner.cfg.ft.batch_size
    ids = [torch.arange(s, s + batch, device="cuda") % n_pairs for s in range(steps + 2)]
    for i in ids[:2]:  # warm-up outside the window
        tuner.train_step(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in ids[2:]:  # the same steps without the profiler
        tuner.train_step(i)
    torch.cuda.synchronize()
    plain_step = (time.perf_counter() - t0) / steps
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in ids[2:]:
            tuner.train_step(i)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        print(f"profile: the profiler recorded no device time; {steps} steps took "
              f"{wall * 1e3 / steps:.2f} ms each (host clock, synchronised); idle "
              f"share not measured")
        return
    by_name = {}
    spans = []
    for e in kernels:
        dt = e.time_range.end - e.time_range.start
        by_name[e.name] = by_name.get(e.name, 0.0) + dt
        spans.append((e.time_range.start, e.time_range.end))
    spans.sort()
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s0, e0 in spans[1:]:
        if s0 > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0]
    total = sum(by_name.values())
    busy_step = busy / 1e6 / steps
    print(f"profile: {steps} train steps, {plain_step * 1e3:.2f} ms per step unprofiled, "
          f"{wall * 1e3 / steps:.2f} ms profiled (host clock), device busy "
          f"{busy_step * 1e3:.2f} ms per step, {len(kernels) / steps:.0f} device events "
          f"per step; device idle share {1 - busy / window:.4f} of the profiled "
          f"{window / 1e3:.2f} ms kernel window, {1 - busy_step / plain_step:.4f} of the "
          f"unprofiled step")
    for name, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"profile top: {t / 1e3 / steps:8.3f} ms/step {t / total:7.2%}  {name[:110]}")
    keys = ("index", "gather", "scatter")
    sampler = sum(t for n, t in by_name.items() if any(k in n.lower() for k in keys))
    print(f"profile: index/gather/scatter kernels (the loss stack's bilinear sampler, its "
          f"scatter-add backward and the step's clip gathers) {sampler / 1e3 / steps:.3f} "
          f"ms/step, {sampler / total:.2%} of device time")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=100,
                    help="clip length (100 = the bench clip)")
    ap.add_argument("--epochs", type=int, default=10,
                    help="fine-tune epochs (10 = the default FineTuneParams)")
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
    print(f"epochs: {args.epochs}" + (" (the default)" if args.epochs == 10 else " (cut from 10)"))
    build_kernels()
    corner_k = corner_phase(args.frames, args.seed)
    from robust_cvd_tpu_torch.models.midas import MidasNet

    with torch.device("meta"):
        n_params = sum(p.numel() for p in MidasNet().parameters())
    adam_k = adam_phase(n_params, args.seed)
    solver_phase(args.seed)
    step_phase(args.seed)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_clip_") as base:
        corner_k["launches"], depth, net = path_phase(base, args.frames, args.seed)
        if corner_k["launches"] < 1:
            raise AssertionError("the corner kernel was not launched on the pose path")
        tuner, adam_k["launches"] = finetune_phase(base, depth, net, args.seed, args.epochs)
        if adam_k["launches"] < 1:
            raise AssertionError("the Adam kernel was not launched on the fine-tune path")
        profile_phase(tuner)
    print(f"total_s {time.perf_counter() - t_start:.3f}")
    print(json.dumps({"kernels": [corner_k, adam_k]}))
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
