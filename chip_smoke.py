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
   MiDaS-v2 and the default FineTuneParams and LossParams but 2 epochs
   (the pipeline phase runs the 10): the cold solve, the epochs of
   training (one Adam kernel launch per step), a depth refresh and a warm
   re-solve after each epoch, the fine-tuned depth stream and video.dat. Checks finite losses, Adam
   launches equal to the train steps with none skipped, the cold solve
   below its start and every warm solve at or below its start, finite
   outputs, and parameters that moved.
7. profile: torch.profiler over 5 steady-state train steps of that path:
   the 10 device kernels with the most time, the share of index, gather and
   scatter kernels (the loss stack's sampler), the device idle share.
8. RAFT, card vs CPU: seeded RAFT at float32 (no TF32), 3 iterations, 2
   pairs at 64x96 (RAFT_TOL); run after the train-step check.
9. flow path: a second synthetic 100-frame clip written as the pipeline
   makes it (color_full PNGs at 224x384, color_down 224x384 .raw,
   color_flow 256x384 .png by pipeline/video.py), RAFT (bf16, 20
   iterations, seeded random weights saved as <clip>/models/raft-things.pth
   unless RAFT_CHECKPOINT names a checkpoint) loaded through
   DatasetProcessor._flow_model(), and FlowStage(batch_size=16):
   compute_flow over the 572 hierarchical2 pairs (registration through the
   corner kernel, one launch a chunk over both frame stacks, RAFT, un-warp
   and resize), compute_flow_masks, compute_flow_pair_stats. Checks 572
   finite flows at 224x384, masks of the 286 unordered pairs, 572 entries
   in flow_list.json, corner launches on the path, and that H_BA maps the
   image centre within 1 px of the true shift in at least the share of
   pairs the JAX package reaches on the CPU (JAX_REGISTRATION_SHARE).
10. exact-flow masks: the mask program on make_clip's exact flows
   reproduces its in-bounds masks bit for bit; register_pairs card vs CPU
   on 4 pairs (H within 1e-3); RAFT bf16 vs float32 on one full chunk
   (printed); the corner kernel checked and timed at the registration's
   shape (32, 256, 384).
11. flow profile: torch.profiler over one steady-state 16-pair chunk of
   compute_flow: ms per chunk, the top 10 device kernels, the device time
   of registration, RAFT, the correlation lookup and the post-process, the
   device idle share.
12. pipeline: the whole schedule through the port's CLI,
   robust_cvd_tpu_torch.main.main(["--path", clip]) with every default but
   --num_epochs (--epochs, 10 by default), on a third clip of
   panning_frames given as color_full PNGs only (no frames.txt), with
   seeded full-width MiDaS-v2 and RAFT checkpoints under <clip>/models/
   (RAFT's last flow-head convolution zeroed: pipeline_checkpoints says
   why): frames, three downscales, initial depth, compute_flow (572 pairs),
   masks, pair stats, motion-segmentation dynamic masks, constraints, the
   cold solve, the epochs with warm re-solves, video.dat and
   stage_timings.json. Checks the result tree, each close pair's flow
   against the true shift (median within 1 px) and its mask ratio against
   its in-bounds share (within 0.02), dynamic masks at least 99% static,
   the corner kernel launched at least once a flow chunk plus once for the
   constraints, one Adam launch a train step with none skipped, and the
   solves. Prints the stage table and pipeline_s_per_frame.

Prints per-stage seconds, a {"kernels": [...]} line (each kernel's entry
carries its launches by path; the corner kernel's, under "flow_path", its
numbers at the registration's shape), the nvidia-smi line, and as its last
line {"ok": true, "device": {...}}.
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
SHIFT = 2  # px a frame of the synthetic clips' panning
# Sizes of the flow store's color_down and color_flow (size or max size,
# align), as the pipeline makes them (pipeline/process.py).
DOWN_SIZE = (384, 32)
FLOW_SIZE = (1024, 64)
# Share of the registration-vs-truth pairs (|i - j| * SHIFT <= 96 px) whose
# H_BA maps the image centre within 1 px of the true shift, reached by the
# JAX package's register_pairs on the CPU on the same 100 frames: 568 of
# 568 (tools/registration_share.py); the port on the card must reach it too.
JAX_REGISTRATION_SHARE = 1.0
RAFT_TOL = (1e-4, 5e-5)  # card vs CPU flow at float32: rel of max|flow|, abs px
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


def panning_frames(n: int, seed: int, shift: int = SHIFT) -> np.ndarray:
    """(n, H, W, 3) float32: frame i is columns [i*shift, i*shift + W) of
    one seeded texture, so frame j is frame i moved (j - i) * shift px to
    the left and the flow from i to j is exactly (i - j) * shift px in x."""
    rng = np.random.default_rng(seed)
    noise = rng.uniform(0.0, 1.0, (H + 2, W + shift * (n - 1) + 2, 3)).astype(np.float32)
    texture = sum(  # 3x3 box blur: structure at several scales
        noise[dy : dy + H, dx : dx + noise.shape[1] - 2]
        for dy in range(3) for dx in range(3)
    ) / 9.0
    return np.stack([texture[:, i * shift : i * shift + W] for i in range(n)])


def make_clip(base: str, n: int, seed: int, shift: int = SHIFT) -> None:
    """A synthetic clip of panning_frames as color_down, with the exact
    flows of every hierarchical2 pair and their consistency masks: where
    the flow target lands in bounds."""
    from robust_cvd_tpu_torch.io import raw
    from robust_cvd_tpu_torch.io.frames import save_frames_txt
    from robust_cvd_tpu_torch.io.store import VideoStore, frame_name
    from robust_cvd_tpu_torch.utils.frame_sampling import sample_pairs

    frames = panning_frames(n, seed, shift)
    os.makedirs(os.path.join(base, "color_down"))
    for i in range(n):
        raw.save_raw_float32_image(
            os.path.join(base, "color_down", frame_name(i, ".raw")), frames[i])
    save_frames_txt(os.path.join(base, "frames.txt"), W, H, [i / 30 for i in range(n)])
    store = VideoStore.open(base)
    entries = []
    xs = np.arange(W, dtype=np.float32)
    for i, j in sample_pairs(n, ("hierarchical2",), two_way=True):
        dx = float((i - j) * shift)
        flow = np.zeros((H, W, 2), np.float32)
        flow[..., 0] = dx
        target = np.floor(xs + dx + 0.5)  # the nearest pixel, also left of 0
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
    kernels = _device_events(prof)
    if not kernels:
        print(f"profile: the profiler recorded no device time; {steps} steps took "
              f"{wall * 1e3 / steps:.2f} ms each (host clock, synchronised); idle "
              f"share not measured")
        return
    by_name = _time_by_name(kernels)
    busy, window = _busy_us(kernels)
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


def flow_store(base: str, n: int, seed: int) -> None:
    """A clip of panning_frames written as the pipeline makes it: color_full
    PNGs (H x W), frames.txt, color_down (.raw) and color_flow (.png)."""
    from robust_cvd_tpu_torch.io.frames import save_frames_txt
    from robust_cvd_tpu_torch.io.store import frame_name, save_png_color
    from robust_cvd_tpu_torch.pipeline.video import VideoStage

    os.makedirs(os.path.join(base, "color_full"))
    for i, frame in enumerate(panning_frames(n, seed)):
        save_png_color(os.path.join(base, "color_full", frame_name(i, ".png")), frame)
    save_frames_txt(os.path.join(base, "frames.txt"), W, H, [i / 30 for i in range(n)])
    video = VideoStage(base)
    video.downscale_frames("color_down", DOWN_SIZE[0], ".raw", DOWN_SIZE[1])
    video.downscale_frames("color_flow", FLOW_SIZE[0], ".png", FLOW_SIZE[1])


def registration_truth(homographies: dict, flow_hw, shift_px: float, max_shift: float = 96.0):
    """Of the pairs (i, j) with |i - j| * shift_px <= max_shift, those whose
    H_BA maps the image centre within 1 px of its true place (frame j is
    frame i moved (j - i) * shift_px to the left). Returns (hits, pairs,
    worst error in px)."""
    h, w = flow_hw
    c = np.array([(w - 1) / 2.0, (h - 1) / 2.0, 1.0])
    hits, n, worst = 0, 0, 0.0
    for (i, j), H_BA in homographies.items():
        if abs(i - j) * shift_px > max_shift:
            continue
        p = H_BA @ c
        err = float(np.hypot(p[0] / p[2] - c[0] - (j - i) * shift_px, p[1] / p[2] - c[1]))
        n += 1
        hits += err <= 1.0
        worst = max(worst, err if np.isfinite(err) else np.inf)
    return hits, n, worst


def flow_phase(base: str, n_frames: int, seed: int, device: str = "cuda",
               iters: int | None = None, dtype=None, min_share: float | None = None):
    """Drives the flow stage on a flow store made in `base`: RAFT from
    <base>/models/raft-things.pth (seeded random weights written there
    unless RAFT_CHECKPOINT names a checkpoint) through
    DatasetProcessor._flow_model(), FlowStage(batch_size=16):
    compute_flow over the hierarchical2 pairs, compute_flow_masks,
    compute_flow_pair_stats. `iters` and `dtype` cut the RAFT (20, bf16)
    for a CPU run. Checks the outputs and the registration against the
    truth; returns the corner kernel's launches and the stage."""
    import torch

    from robust_cvd_tpu_torch.config import PipelineConfig
    from robust_cvd_tpu_torch.io import raw
    from robust_cvd_tpu_torch.io.store import VideoStore
    from robust_cvd_tpu_torch.models import raft
    from robust_cvd_tpu_torch.ops import corner
    from robust_cvd_tpu_torch.pipeline.flow import FlowStage
    from robust_cvd_tpu_torch.pipeline.process import DatasetProcessor

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    flow_store(base, n_frames, seed)
    print(f"stage flow_store_build_s {time.perf_counter() - t0:.3f}")
    ckpt = os.path.join(base, "models", "raft-things.pth")
    if os.path.exists(os.environ.get("RAFT_CHECKPOINT", "")):
        print(f"raft weights: checkpoint {os.environ['RAFT_CHECKPOINT']}")
    else:
        os.makedirs(os.path.dirname(ckpt), exist_ok=True)
        torch.save(raft.seeded_init_(raft.RAFT(), seed).state_dict(), ckpt)
        print(f"raft weights: seeded random (seed {seed}), saved in the checkpoint layout")
    proc = DatasetProcessor(PipelineConfig(path=base), device=device)
    model = proc._flow_model()
    if iters is not None:
        model.iters = iters
    if dtype is not None:
        model.set_dtype(dtype)
    print(f"raft: {sum(p.numel() for p in model.parameters())} parameters, "
          f"{model.iters} iterations, {model.dtype}")
    store = VideoStore.open(base)
    stage = FlowStage(store, *proc._flow_model_pair(), batch_size=16, device=device)
    pairs = stage.sample_index_pairs(("hierarchical2",), n_frames)
    down_hw = store.load_color_down().shape[1:3]
    flow_hw = stage.load_chunk(pairs[:1])[0].shape[1:3]
    print(f"flow stage: {len(pairs)} pairs, color_flow {flow_hw[0]}x{flow_hw[1]}, "
          f"color_down {down_hw[0]}x{down_hw[1]}, chunks of {stage.batch_size}")

    corner.corner_min_eigenval.launches = 0
    t0 = time.perf_counter()
    stage.compute_flow(pairs)
    sync()
    print(f"stage compute_flow_s {time.perf_counter() - t0:.3f} "
          + " ".join(f"{k} {v:.3f}" for k, v in stage.stats.items()))
    launches = corner.corner_min_eigenval.launches
    t0 = time.perf_counter()
    stage.compute_flow_masks(pairs)
    sync()
    print(f"stage compute_flow_masks_s {time.perf_counter() - t0:.3f}")
    t0 = time.perf_counter()
    entries = stage.compute_flow_pair_stats(pairs)
    print(f"stage flow_pair_stats_s {time.perf_counter() - t0:.3f}")

    flow_dir = os.path.join(base, "flow")
    files = sorted(os.listdir(flow_dir))
    mags = []
    for (i, j) in pairs:
        f = raw.load_raw_float32_image(os.path.join(flow_dir, f"flow_{i:06d}_{j:06d}.raw"))
        if f.shape != tuple(down_hw) + (2,) or not np.isfinite(f).all():
            raise AssertionError(f"flow {i}->{j}: shape {f.shape} or non-finite values")
        mags.append(float(np.abs(f).mean()))
    if len(files) != len(pairs):
        raise AssertionError(f"{len(files)} flow files for {len(pairs)} pairs")
    unordered = {(min(p), max(p)) for p in pairs}
    masks = os.listdir(os.path.join(base, "flow_mask"))
    if len(masks) != 2 * len(unordered):
        raise AssertionError(f"{len(masks)} mask files for {len(unordered)} unordered pairs")
    listed = json.load(open(os.path.join(base, "flow_list.json")))
    if len(listed) != len(pairs) + 1 or len(entries) != len(pairs):
        raise AssertionError(f"flow_list.json holds {len(listed) - 1} pairs for {len(pairs)}")
    ratios = [e[2] for e in entries]
    print(f"outputs: {len(files)} finite flows at {down_hw[0]}x{down_hw[1]} (mean |flow| "
          f"{np.mean(mags):.4f} px), masks of {len(unordered)} unordered pairs, "
          f"{len(listed) - 1} pairs in flow_list.json (mask ratio mean {np.mean(ratios):.4f}, "
          f"min {min(ratios):.4f}, max {max(ratios):.4f})")
    print(f"corner_min_eigenval launches on the flow path: {launches} "
          f"({-(-len(pairs) // stage.batch_size)} chunks, one launch a chunk over both stacks)")

    shift_px = SHIFT * flow_hw[1] / W
    hits, n, worst = registration_truth(stage.homographies, flow_hw, shift_px)
    want = JAX_REGISTRATION_SHARE if min_share is None else min_share
    print(f"registration vs truth: {hits} of {n} pairs with |i - j| * {shift_px:g} <= 96 px "
          f"map the centre within 1 px (share {hits / max(n, 1):.4f}, worst {worst:.4f} px; "
          f"the JAX package on the CPU: {want:.4f})")
    if n == 0 or hits / n < want:
        raise AssertionError("registration fell short of the JAX package's share")
    return launches, stage


def exact_mask_check(base: str, n_frames: int, seed: int, device: str = "cuda") -> None:
    """The mask program on make_clip's exact flows, in a copy of its store
    without flow_mask/, must reproduce make_clip's in-bounds masks bit for
    bit (the targets land on whole pixels; colours match exactly there)."""
    from robust_cvd_tpu_torch.io.store import VideoStore, load_png_gray
    from robust_cvd_tpu_torch.pipeline.flow import FlowStage

    make_clip(base, n_frames, seed)
    os.rename(os.path.join(base, "flow_mask"), os.path.join(base, "flow_mask_made"))
    store = VideoStore.open(base)
    pairs = [(i, j) for (i, j, _) in store.load_flow_list()]
    t0 = time.perf_counter()
    FlowStage(store, None, device=device).compute_flow_masks(pairs)
    dt = time.perf_counter() - t0
    names = sorted(os.listdir(os.path.join(base, "flow_mask_made")))
    differ = [n for n in names if not np.array_equal(
        load_png_gray(os.path.join(base, "flow_mask", n)),
        load_png_gray(os.path.join(base, "flow_mask_made", n)))]
    print(f"mask program on exact flows: {len(names) - len(differ)} of {len(names)} masks "
          f"equal to the in-bounds masks bit for bit ({dt:.3f} s)")
    if differ or len(os.listdir(os.path.join(base, "flow_mask"))) != len(names):
        raise AssertionError(f"masks differ: {differ[:5]}")


def raft_device_check(seed: int) -> None:
    """Seeded RAFT at float32, 3 iterations, on 2 pairs at 64x96, on the
    card and on the CPU, TF32 off on both: flows within RAFT_TOL (the CPU's
    float32 net differs from its float64 net by 3.7e-6 px at max|flow|
    0.53, so the tolerance leaves ~25x)."""
    import torch

    from robust_cvd_tpu_torch.device import float32_precision
    from robust_cvd_tpu_torch.models import raft

    net = raft.seeded_init_(raft.RAFT(iters=3, dtype=torch.float32), seed).eval()
    rng = np.random.default_rng(seed)
    ims = [torch.from_numpy(rng.uniform(0, 255, (2, 3, 64, 96)).astype(np.float32))
           for _ in range(2)]
    with torch.no_grad(), float32_precision(cudnn_tf32=False):
        cpu = net(*ims)
        gpu = net.cuda()(*[x.cuda() for x in ims]).cpu()
    err = (gpu - cpu).abs().max().item()
    tol = RAFT_TOL[0] * cpu.abs().max().item() + RAFT_TOL[1]
    print(f"raft, card vs CPU (float32, no TF32, 3 iterations, 2 pairs at 64x96): max|err| "
          f"{err:.3e} px (tolerance {tol:.3e}; max|flow| {cpu.abs().max().item():.4f})")
    if not err <= tol:
        raise AssertionError("RAFT on the card disagrees with the CPU")


def flow_card_checks(stage) -> None:
    """register_pairs on 4 pairs of the flow store, card vs CPU (H within
    1e-3); the card's bf16-vs-float32 RAFT difference on the first chunk
    at full size (printed, not checked)."""
    import torch

    from robust_cvd_tpu_torch.device import float32_precision
    from robust_cvd_tpu_torch.ops.homography import register_pairs

    n = stage.store.num_frames
    pairs = [(0, 1), (0, min(4, n - 1)), (min(10, n - 1), 2), (min(50, n - 1), min(30, n - 1))]
    im1, im2 = stage.load_chunk(pairs)
    gpu, _ = register_pairs(im1[:4], im2[:4])
    cpu, _ = register_pairs(im1[:4].cpu(), im2[:4].cpu())
    err = (gpu.cpu() - cpu).abs().max().item()
    print(f"register_pairs, card vs CPU on pairs {pairs}: H max|err| {err:.3e} "
          f"(tolerance 1e-3)")
    if not err <= 1e-3:
        raise AssertionError("registration on the card disagrees with the CPU")

    model = stage.model
    im1, im2 = stage.load_chunk(stage.sample_index_pairs(("hierarchical2",), n)[: stage.batch_size])
    a, b = im1.permute(0, 3, 1, 2) * 255.0, im2.permute(0, 3, 1, 2) * 255.0
    with torch.no_grad(), float32_precision(cudnn_tf32=False):
        bf16 = model.set_dtype(torch.bfloat16)(a, b)
        f32 = model.set_dtype(torch.float32)(a, b)
    model.set_dtype(torch.bfloat16)
    d = (bf16 - f32).abs()
    print(f"raft bf16 vs float32 on the card ({a.shape[0]} pairs at {a.shape[2]}x{a.shape[3]}, "
          f"{model.iters} iterations, no registration): max|diff| {d.max().item():.4f} px, "
          f"mean {d.mean().item():.5f} px, mean|flow| {f32.abs().mean().item():.4f} px")


def corner_flow_entry(stage, launches: int) -> dict:
    """The corner kernel at the registration's shape: both gray stacks of
    the first chunk, (2 x batch, H, W), as register_pairs launches it;
    checked against its plain version and timed as on the pose path."""
    import torch

    pairs = stage.sample_index_pairs(("hierarchical2",), stage.store.num_frames)
    rgb = torch.stack(stage.load_chunk(pairs[: stage.batch_size]))
    gray = 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]
    gray = gray.reshape(-1, *gray.shape[2:]).contiguous()
    entry = corner_entry(gray, corner_check(gray, f"{tuple(gray.shape)} registration"))
    keep = ("max_abs_err", "ms", "call_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "gbps", "share_of_bound")
    return {"shape": list(gray.shape), "launches": launches, **{k: entry[k] for k in keep}}


def _device_events(prof):
    """The profiler's device kernels (user-annotation spans left out)."""
    import torch

    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.name.startswith(("flow.", "raft."))]


def _time_by_name(kernels) -> dict:
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.end - e.time_range.start
    return by_name


def _busy_us(kernels):
    """(busy, window) in us: the union of the kernels' spans, and from the
    first start to the last end."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, (cur_s, cur_e) = 0.0, spans[0]
    for s0, e0 in spans[1:]:
        if s0 > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    return busy + cur_e - cur_s, spans[-1][1] - spans[0][0]


def flow_profile_phase(stage, reps: int = 3) -> None:
    """torch.profiler over one steady-state 16-pair chunk of compute_flow
    (registration, RAFT, post-process): ms per chunk, the top device
    kernels, the correlation lookup's share, the device idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    pairs = stage.sample_index_pairs(("hierarchical2",), stage.store.num_frames)
    ims = stage.load_chunk(pairs[: stage.batch_size])
    out_hw = stage.store.load_color_down().shape[1:3]
    for _ in range(2):
        stage.flow_chunk(*ims, out_hw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        stage.flow_chunk(*ims, out_hw)
    torch.cuda.synchronize()
    plain = (time.perf_counter() - t0) / reps
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        stage.flow_chunk(*ims, out_hw)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    kernels = _device_events(prof)
    if not kernels:
        print(f"flow profile: the profiler recorded no device time; a chunk took "
              f"{plain * 1e3:.2f} ms (host clock, synchronised); idle share not measured")
        return
    by_name = _time_by_name(kernels)
    busy, window = _busy_us(kernels)
    total = sum(by_name.values())
    print(f"flow profile: one chunk of {stage.batch_size} pairs, {plain * 1e3:.2f} ms unprofiled "
          f"(host clock, mean of {reps}), {wall * 1e3:.2f} ms profiled, device busy "
          f"{busy / 1e3:.2f} ms, {len(kernels)} device kernels; device idle share "
          f"{1 - busy / window:.4f} of the {window / 1e3:.2f} ms kernel window, "
          f"{1 - busy / 1e3 / (plain * 1e3):.4f} of the unprofiled chunk")
    for name, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"flow profile top: {t / 1e3:8.3f} ms {t / total:7.2%}  {name[:110]}")
    cpu_events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU]
    for rng_name in ("flow.register", "flow.raft", "raft.lookup_corr", "flow.postproc"):
        dev = sum(getattr(e, "device_time_total", 0.0) for e in cpu_events if e.name == rng_name)
        share = f"{dev / total:.2%} of device kernel time" if dev else "not measured"
        print(f"flow profile range {rng_name}: device kernels {dev / 1e3:.3f} ms, {share}")


def pipeline_clip(base: str, n: int, seed: int) -> None:
    """A clip as a user hands it to the CLI without a video file: color_full
    PNGs of panning_frames and nothing else (no frames.txt)."""
    from robust_cvd_tpu_torch.io.store import frame_name, save_png_color

    os.makedirs(os.path.join(base, "color_full"))
    for i, frame in enumerate(panning_frames(n, seed)):
        save_png_color(os.path.join(base, "color_full", frame_name(i, ".png")), frame)


def pipeline_checkpoints(base: str, seed: int) -> None:
    """Seeded MiDaS-v2 and RAFT weights in the layout the CLI loads from
    <clip>/models/. RAFT's last flow-head convolution is zeroed: every layer,
    the correlation pyramid and all iterations still run, but its flow in
    the registered frame is exactly 0, so the stage's flow is the
    registration homography and its consistency masks cover the in-bounds
    area (random flow heads give near-empty masks)."""
    import torch

    from robust_cvd_tpu_torch.models import midas, raft

    os.makedirs(os.path.join(base, "models"))
    torch.save(midas.seeded_init_(midas.MidasNet(), seed).state_dict(),
               os.path.join(base, "models", "midas_v21-f6b98070.pt"))
    net = raft.seeded_init_(raft.RAFT(), seed)
    with torch.no_grad():
        net.update_block.flow_head.conv2.weight.zero_()
        net.update_block.flow_head.conv2.bias.zero_()
    torch.save(net.state_dict(), os.path.join(base, "models", "raft-things.pth"))


PIPELINE_SPANS = ("extract_frames", "downscale_frames", "load_models", "compute_initial_depth",
                  "compute_initial_depth/first_dispatch_s", "compute_flow",
                  "compute_flow/load_s", "compute_flow/chunk_s", "compute_flow/write_s",
                  "compute_flow_masks", "compute_dynamic_mask", "fine_tune",
                  "fine_tune/setup_s", "fine_tune/pose_opt_s", "fine_tune/train_steps_s",
                  "fine_tune/refresh_s", "fine_tune/persist_io_s")


def pipeline_phase(base: str, n_frames: int, seed: int, epochs: int, device: str = "cuda",
                   argv=()):
    """The whole pipeline through the CLI, `main(["--path", clip])` with every
    default but --num_epochs (and `argv`, which cuts the solver for a CPU
    run), on a clip of color_full PNGs, with the checkpoints of
    pipeline_checkpoints. Checks the result tree, the flows against the
    true shift, the kernels' launches on this path and the solves. Returns
    the corner and Adam kernels' launches and the DatasetProcessor."""
    import torch

    from robust_cvd_tpu_torch.io import raw
    from robust_cvd_tpu_torch.io.store import VideoStore, load_png_gray
    from robust_cvd_tpu_torch.io.video_dat import load_video_dat
    from robust_cvd_tpu_torch.main import main as cli_main
    from robust_cvd_tpu_torch.ops import adam, corner
    from robust_cvd_tpu_torch.utils.frame_sampling import sample_pairs

    t0 = time.perf_counter()
    pipeline_clip(base, n_frames, seed)
    pipeline_checkpoints(base, seed)
    print(f"stage pipeline_clip_build_s {time.perf_counter() - t0:.3f}")

    corner.corner_min_eigenval.launches = 0
    adam.adam_update.launches = 0
    t0 = time.perf_counter()
    proc = cli_main(["--path", base, "--num_epochs", str(epochs), *argv], device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = {"corner": corner.corner_min_eigenval.launches, "adam": adam.adam_update.launches}
    for name, sec in proc.tracer.summary().items():
        print(f"pipeline stage {name} {sec:.3f}")
    print(f"pipeline_s {total:.3f}")
    print(f"pipeline_s_per_frame {total / n_frames:.4f}")

    def count(sub, ext):
        d = os.path.join(base, sub)
        return len([f for f in os.listdir(d) if f.endswith(ext)]) if os.path.isdir(d) else 0

    store = VideoStore.open(base)
    down_hw = store.load_color_down().shape[1:3]
    for sub, ext in (("color_down", ".raw"), ("color_down_png", ".png"), ("color_flow", ".png"),
                     ("depth_midas2/depth", ".raw"), ("dynamic_mask", ".png")):
        if count(sub, ext) != n_frames:
            raise AssertionError(f"{count(sub, ext)} frames in {sub} for {n_frames}")
    listed = [tuple(e[:2]) for e in store.load_flow_list()]
    n_pairs = len(listed)
    if sorted(listed) != sorted(sample_pairs(n_frames, ("hierarchical2",), two_way=True)):
        raise AssertionError(f"flow_list.json holds {n_pairs} pairs, not the hierarchical2 ones")
    if count("flow", ".raw") != n_pairs or count("flow_mask", ".png") != n_pairs:
        raise AssertionError(f"{count('flow', '.raw')} flows and {count('flow_mask', '.png')} "
                             f"masks for {n_pairs} pairs in flow_list.json")

    # flows and masks against the truth: frame j is frame i moved
    # (j - i) * SHIFT px to the left, scaled to color_down's width
    shift = SHIFT * down_hw[1] / W
    xs = np.arange(down_hw[1], dtype=np.float32)
    worst_flow, worst_ratio, checked = 0.0, 0.0, 0
    for (i, j, ratio) in store.load_flow_list():
        if abs(i - j) * SHIFT > 96:
            continue
        dx = (i - j) * shift
        flow = store.load_flow(i, j)
        err = float(np.median(np.hypot(flow[..., 0] - dx, flow[..., 1])))
        target = np.floor(xs + dx + 0.5)
        share = float(np.mean((target >= 0) & (target < down_hw[1])))
        worst_flow = max(worst_flow, err)
        worst_ratio = max(worst_ratio, abs(ratio - share))
        checked += 1
    print(f"pipeline flows vs truth: {checked} pairs with |i - j| * {SHIFT} <= 96 px, worst "
          f"median |flow - shift| {worst_flow:.4f} px (tolerance 1), worst |mask ratio - "
          f"in-bounds share| {worst_ratio:.4f} (tolerance 0.02)")
    if checked == 0 or not worst_flow <= 1.0 or not worst_ratio <= 0.02:
        raise AssertionError("the pipeline's flows or masks disagree with the true shift")
    static = [float(np.mean(load_png_gray(os.path.join(base, "dynamic_mask", f)) == 255))
              for f in sorted(os.listdir(os.path.join(base, "dynamic_mask")))]
    print(f"pipeline dynamic masks: static share min {min(static):.4f}, mean "
          f"{np.mean(static):.4f} (a rigid pan: at least 0.99)")
    if min(static) < 0.99:
        raise AssertionError("a dynamic mask marks more than 1% of a rigid pan as moving")
    if not os.path.exists(os.path.join(base, "flow_constraints.dat")):
        raise AssertionError("no flow_constraints.dat")

    tuner = proc.tuner
    streams = [s.name for s in load_video_dat(os.path.join(base, "video.dat")).depth_streams]
    if streams[:1] != ["depth_midas2"] or "fine_tuned" not in streams:
        raise AssertionError(f"video.dat streams {streams}")
    depth_dir = os.path.join(tuner.out_dir, "depth")
    disp = [raw.load_raw_float32_image(os.path.join(depth_dir, f))
            for f in sorted(os.listdir(depth_dir)) if f.endswith(".raw")]
    if len(disp) != n_frames or not all(np.isfinite(d).all() for d in disp):
        raise AssertionError(f"{len(disp)} fine-tuned depth frames, or non-finite ones")
    timings = json.load(open(os.path.join(proc.out_dir(n_frames), "stage_timings.json")))
    missing = [s for s in PIPELINE_SPANS if s not in timings["summary"]]
    if missing:
        raise AssertionError(f"stage_timings.json lacks {missing}")

    steps = sum(h["steps"] for h in tuner.history)
    skipped = sum(h["skipped"] for h in tuner.history)
    want_corner = 1 + -(-n_pairs // 16) if device == "cuda" else 0
    want_adam = steps if device == "cuda" else 0
    print(f"pipeline launches: corner_min_eigenval {launches['corner']} ({-(-n_pairs // 16)} flow "
          f"chunks and the constraint build), adam {launches['adam']} for {steps} train steps, "
          f"{skipped} skipped")
    if launches["corner"] < want_corner or launches["adam"] != want_adam or skipped:
        raise AssertionError("the pipeline path missed a kernel launch or skipped a step")
    cold = [e for e in tuner.solve_log if e["stage"] != "warm"]
    warm = [e for e in tuner.solve_log if e["stage"] == "warm"]
    if not cold or len(warm) != epochs:
        raise AssertionError(f"{len(cold)} cold and {len(warm)} warm solves for {epochs} epochs")
    if not all(e["cost"] < e["cost0"] for e in cold) or not all(
            e["cost"] <= e["cost0"] for e in warm):
        raise AssertionError("a cold solve did not lower its cost or a warm one raised it")
    print(f"pipeline outputs: {n_frames} frames, {n_pairs} flows and masks, {n_frames} dynamic "
          f"masks, video.dat streams {streams}, {len(disp)} fine-tuned depth frames under "
          f"{os.path.relpath(depth_dir, base)}; {len(cold)} cold solves below their start, "
          f"{len(warm)} warm at or below")
    for name, solves in (("cold", cold), ("warm", warm)):
        print(f"pipeline {name} solves: {sum(e['outer'] for e in solves)} outer steps, "
              f"{sum(e['cg'] for e in solves)} CG iterations, "
              f"{sum(e['syncs'] for e in solves)} host syncs")
    return launches, proc


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=100,
                    help="clip length (100 = the bench clip)")
    ap.add_argument("--epochs", type=int, default=10,
                    help="the pipeline phase's fine-tune epochs (10 = the default "
                         "FineTuneParams); the fine-tune phase runs at most 2")
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
    raft_device_check(args.seed)
    launches = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_clip_") as base:
        launches["pose"], depth, net = path_phase(base, args.frames, args.seed)
        if launches["pose"] < 1:
            raise AssertionError("the corner kernel was not launched on the pose path")
        tuner, adam_fine_tune = finetune_phase(base, depth, net, args.seed,
                                               min(2, args.epochs))
        if adam_fine_tune < 1:
            raise AssertionError("the Adam kernel was not launched on the fine-tune path")
        profile_phase(tuner)
    del tuner, net, depth
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_flow_") as base:
        launches["flow"], stage = flow_phase(os.path.join(base, "clip"), args.frames, args.seed)
        if launches["flow"] < 1:
            raise AssertionError("the corner kernel was not launched on the flow path")
        exact_mask_check(os.path.join(base, "exact"), args.frames, args.seed)
        flow_card_checks(stage)
        corner_k["flow_path"] = corner_flow_entry(stage, launches["flow"])
        flow_profile_phase(stage)
    del stage
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_pipeline_") as base:
        pipe, _ = pipeline_phase(os.path.join(base, "clip"), args.frames, args.seed,
                                 args.epochs)
    launches["pipeline"] = pipe["corner"]
    corner_k["launches"] = sum(launches.values())
    corner_k["launches_by_path"] = launches
    adam_k["launches_by_path"] = {"fine_tune": adam_fine_tune, "pipeline": pipe["adam"]}
    adam_k["launches"] = adam_fine_tune + pipe["adam"]
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
