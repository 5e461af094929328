"""Smoke run of the PyTorch/CUDA port (robust_cvd_tpu_torch) on one GPU.

    python3 chip_smoke.py [--frames 100] [--epochs 3] [--seed 0]

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
   - Adam at the full-width MiDaS-v2 parameter count and at 1,000,003 in
     each of its modes: adam_pl (no bias correction) and optax.adam at step
     counts 0 and 7, optax.radam at 0, 4, 5 and 7 (its rectification turns
     on between steps 5 and 6), optax.adam with a bf16 first moment at 0
     and 7: mu', nu' and the update p' - p within 1e-4 * max|ref| + 1e-7;
     with the guard flag false all four buffers stay bitwise unchanged. The
     kernels line has an entry for optax.adam (adam), optax.radam
     (adam_radam, beside one call of torch.optim.RAdam(foreach=True))
     and the bf16
     first moment (adam_mu_bf16, no PyTorch call to compare);
   - the ViT attention (csrc/vit_attention.cu, attention_phase): forward
     and backward against the plain version in float64 at ATTENTION_CHECKS
     (N 1, 65, 577 and the DPT cell's (4, 1009, 16)), the output and each
     of dq, dk, dv within twice F.scaled_dot_product_attention's float32
     error on the same input; its entry times forward, backward and both
     back to back at the cell's shape beside the 3xTF32 bound, the plain
     version (forward and backward, one call), SDPA's forward and backward
     (library_ms) and the kernels' registers, local bytes and shared
     memory (attention_entry);
   - the same kernels with BEiT's relative-position bias
     (attention_bias_phase): at ATTENTION_BIAS_CHECKS (N 1, 65, 577, the
     BEiT cell's (4, 1793, 16) on a 32x56 grid, 92 on a 7x13 grid and
     3,241 on a 40x81 grid) the output, dq, dk, dv and the table's
     gradient each, at its largest over the card test's three inputs, no
     worse than the bias gathered into a float32 mask through
     F.scaled_dot_product_attention (at N = 1, where the exact dq, dk and
     dT are 0, within twice its error); its entry times
     both paths back to back at BEiT's shape (the bias path faster than
     the library call; whether it keeps within 1.3x the path without is
     printed and kept in its entry) beside the plain version and the
     library call (attention_bias_entry);
   - the same kernels at head width 32 with Swin V2's window form
     (window_attention_phase): at WINDOW_CHECKS and the cell's two shapes
     (stage 2's (4, 576, 24) and stage 0's shifted (64, 576, 6) with the
     mask) out, dq, dk, dv and dT each, at its largest over three inputs,
     within twice the bias and mask gathered into a float32 mask through
     F.scaled_dot_product_attention at scale 1 (window_error_limit); its
     entry times both shapes back to back beside that library call (each
     must be faster) and the 3xTF32 bound; then one eager
     FineTuner.train_step of the published net through its adapter, at
     the cell's 384x672 frames and batch of 2 pairs, runs the window
     kernels in its 24 blocks (window_launches_check).
3. solver: the pose solve of a small exact-reprojection problem on the card
   against the same solve on the CPU (poses within 1e-3); the same cold
   solve on the card with the exact diagonal off and 4 Hutchinson probes
   an outer step (at most 10 LM steps a solve) ends each LM solve below
   its start. Then the constraint-sharded solve (sharded_solve_check): the
   static scene of tests/test_torch_pkg_sharded_solve.py on the card in
   this process and on SHARDED_RANKS spawned ranks sharing it over gloo,
   the ranks' SolverParams bitwise equal after every LM solve, the poses
   within 5e-3 and the depth grid within 2e-2 relative of one process's;
   and the IO engine (io_engine_check): a 100-frame 224x384 depth stream
   written and read through native/io_engine.cpp and through io/raw.py's
   loop, the files equal byte for byte, both times printed.
4. train step: two FineTuner steps of the small MiDaS net (features 32,
   backbone (1, 1, 1, 1)) on a 4-frame 32x64 clip on the card (Adam kernel)
   and on the CPU (plain Adam), convolutions without TF32, with Adam, RAdam
   and the bf16 first moment: losses, BatchNorm statistics and parameters
   within 1e-4 relative, mu and nu within 1e-3 (each against the largest
   magnitude of its flat buffer; a bf16 mu also one bf16 ulp; step_phase
   says why). Then the step graph (step_graph_check): the small tuner's
   graphed steps against GRAPH_EAGER_RUNS eager runs of the same 6 steps
   (batch sizes 2 and 1, a pose-state swap between the third and the
   fourth): the step count equal, and the losses, parameters, mu, nu and
   BatchNorm statistics equal to an eager run's where the eager runs agree
   bitwise, else within step_phase's tolerances of the nearest (the gap
   and the eager runs' own spread printed; step_graph_check says why).
5. pose path: a synthetic 224x384 clip of POSE_CLIP_FRAMES frames (a
   seeded texture panning by a fixed number of pixels per frame,
   hierarchical2 pairs, exact flows, in-bounds consistency masks) goes
   through the port's entry points: initial depth
   with the full-width MiDaS-v2 (seeded random weights unless
   <clip>/models/midas_v21-f6b98070.pt exists), PoseOptimizer (whose
   constructor builds the flow constraints through the corner kernel) and a
   cold optimize_poses() with the default PoseOptParams. Checks finite
   depth, constraints and parameters, a corner kernel launch on the path,
   and that every LM solve ended below its starting cost.
6. fine-tune path: DatasetProcessor(...).fine_tune(store, depth) on the same
   clip (the cached flow_constraints.dat is reused) with the full-width
   MiDaS-v2 and the default FineTuneParams and LossParams but 2 epochs
   (the pipeline phase runs 3): the cold solve, the epochs of
   training (one Adam kernel launch per step), a depth refresh and a warm
   re-solve after each epoch, the fine-tuned depth stream and video.dat. Checks finite losses, Adam
   launches equal to the train steps with none skipped, the cold solve
   below its start and every warm solve at or below its start, finite
   outputs, and parameters that moved.
7. RAFT, card vs CPU: seeded RAFT at float32 (no TF32), 3 iterations, 2
   pairs at 64x96 (RAFT_TOL); run after the train-step check.
8. flow path: a second synthetic 100-frame clip written as the pipeline
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
9. exact-flow masks: the mask program on make_clip's exact flows
   reproduces its in-bounds masks bit for bit; register_pairs card vs CPU
   on 4 pairs (H within 1e-3); RAFT bf16 vs float32 on one full chunk
   (printed); the corner kernel checked and timed at the registration's
   shape (32, 256, 384).
10. pipeline: the whole schedule through the port's CLI,
   robust_cvd_tpu_torch.main.main(["--path", clip]) with every default but
   --num_epochs (--epochs, 3 by default: PIPELINE_EPOCHS says why), on a
   third clip of
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
   solves. --post_filter is on: the fine_tuned_filtered stream holds finite,
   positive depth, and its first 8 frames equal the CPU's filter of the
   same inputs within 1e-4 relative. Prints the stage table,
   pipeline_s_per_frame (without the post filter, as before it) and
   post_filter_s, then profiles the filter alone at full width (seconds,
   device ms, peak memory, bytes bounds).
11. quality: the four golden-scene gates of robust_cvd_tpu_torch/quality.py
   at full size (tiny=False: 8 frames at 96x128) on the card: static,
   dynamic with the spatial-warp recovery, and contaminated constraints with
   and without the exclusion. Each gap-closed value must reach the JAX
   package's value on the CPU (JAX_GATES) less GATE_SLACK; without the
   exclusion the contamination gate must stay EXCLUSION_MARGIN below its
   value with it. Prints each value beside the JAX package's.
12. eval, card vs CPU: eval_pair_losses of the small tuner of phase 4 on the
   card and on the CPU (no TF32), per-pair totals and parts within 1e-4
   relative.
13. validate: FineTuner.validate on phase 6's tuner (the pose clip, full
   width) with the eval images, the scale maps and the scene-flow
   images on: every file the JAX package writes (eval/loss_e*_iter*.json,
   depth_*, scale_*, scene_flow_*) is there and every loss is finite.
14. processor: the 13 ops of pipeline/processor.py through
   Processor.process on the pose clip with the fine-tune phase's cameras
   (processor_phase: the filters on the whole clip and, card vs CPU, on its
   first 16 frames; compute_tracks with one corner launch and tracks that
   follow the pan; the solver ops on an 8-frame clip at full width).
15. optimizers: one fine-tune epoch of FineTuner.run with optax.radam and
   one with a bf16 first moment on the fine-tune phase's clip and poses:
   one launch of the kernel's mode a step, none skipped.
16. colmap: a COLMAP model of the pose clip's known cameras (a camera
   moving SHIFT px a frame along x over a fronto-parallel plane) written by
   io/colmap.py's writers and converted by model_to_npz, the plane's
   disparity as depth_colmap_dense/, then DatasetProcessor.fine_tune with
   recon=colmap for 1 epoch: no solve runs, the poses are the imported
   ones, the depth moves, one Adam launch a step.
17. mask_rcnn: on the pipeline clip after the pipeline phase, a seeded
   detectron2-layout checkpoint whose heads are shaped on the first frame
   (mask_rcnn_state: RCNN_KEEP of its proposals score person) pickled as
   <clip>/models/mask_rcnn_R_50_FPN_3x.pkl, then
   compute_dynamic_masks_rcnn(store, pkl) in bf16 on the card over the
   100 frames at detectron2's test size (224x384 -> 778x1333, padded to
   800x1344). Checks 100 PNGs of 0 and 255 only, each frame's dynamic
   share in (0, RCNN_MAX_SHARE) and 1 to RCNN_MAX_DYNAMIC dynamic
   detections in each; card vs CPU at float32 without TF32 on one frame at
   test size 320 (mask_rcnn_checks: P2-P6 and RPN outputs, detections,
   dynamic masks, roi_align_fpn and paste_masks); bf16 against float32 on
   one full-size frame (printed). Prints the stage's stats, seconds a frame
   in steady state and host syncs a frame, then profiles one steady frame
   pair (mask_rcnn_profile: device time of the backbone and FPN, RPN with
   NMS, ROIAlign, the heads, detection and the paste; the idle share).
   No CUDA kernel of the repo is on this path (models/mask_rcnn.py is
   plain PyTorch, as its JAX counterpart reaches no pallas_call).
18. keypoints (after the RAFT check): ops/homography.py's detect_keypoints
   (one corner kernel launch) and warp_perspective on one panning frame,
   card vs CPU (keypoints_check).
19. mesh: the whole CLI at 1 epoch on a data mesh of MESH_RANKS spawned
   ranks that share the card over gloo (NCCL refuses two ranks on one
   card), each main(["--path", clip, "--num_epochs", "1", "--post_filter",
   "true"]) on a copy of the inputs of the pipeline clip's first
   MESH_CLIP_FRAMES frames (mesh_phase, mesh_rank):
   the result tree; the initial depth, flows and masks against the pipeline
   phase's one-process files (MESH_DEPTH_TOL, RAFT_TOL, MESH_MASK_SHARE);
   replicas bitwise equal (one digest of parameters and BatchNorm
   buffers, and every LM solve's SolverParams digest equal on every rank:
   each rank solves each step on its share of the constraints); each rank's Adam
   launches equal to its train steps with none skipped, the corner kernel
   in every rank's flow chunks. Prints each rank's solves (seconds, the
   cold solve's, LM solves, CG iterations, all-reduces and their seconds)
   and epochs (seconds, steps, ms a step, the collectives' share) beside
   the pipeline phase's epochs. Then a 1-rank nccl group's all_reduce on
   the card, and with two or more cards the CLI over nccl on one rank a
   card (a line says when it was not run).

Prints per-stage seconds, a {"kernels": [...]} line (each kernel's entry
carries its launches by path, the mesh's also by rank; the corner kernel's,
under "flow_path", its numbers at the registration's shape), the
nvidia-smi line, and as its last line {"ok": true, "device": {...}}.
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
# The pose clip's length (the pose path and the phases on its clip:
# fine-tune, validate, processor, optimizers, colmap); the flow and
# pipeline phases keep --frames. It was 100 until the script outgrew its
# 950 s budget (978.0 s on an H100 with the processor and optimizer phases).
POSE_CLIP_FRAMES = 50
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
# The JAX package's golden-scene gates at full size (tiny=False) on the CPU,
# from `JAX_PLATFORMS=cpu python3 -c "import bench; from robust_cvd_tpu
# import quality; d = {}; bench.quality_gate(d); print(d,
# quality.dynamic_solver_gate(), quality.contaminated_constraint_gate())"`.
# The round-5 TPU run (BENCH_r05.json's tail) gave 0.9926, 0.8141 (1.0 against
# the floor), 0.8887, 0.9988 and 0.2861; its ground-truth errors differ from
# the CPU's too (static 0.001077 there against 0.000319), so the CPU run is
# the one the port is held to. These are quality numbers, not speed numbers.
JAX_GATES = {
    "quality_gap_closed": 0.9796,
    "quality_gap_closed_dynamic": 0.7802,
    "quality_gap_closed_dynamic_vs_floor": 1.0,
    "spatial_warp_recovery": 0.8887,
    "quality_gap_closed_contaminated": 0.9955,
    "quality_gap_closed_contaminated_no_exclusion": 0.2722,
}
GATE_SLACK = 0.02  # each gate at least the JAX package's value less this
EXCLUSION_MARGIN = 0.3  # tests/test_quality.py: off < on - 0.3
EVAL_TOL = 1e-4  # eval losses, card vs CPU, relative
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_F32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12  # H100 SXM, dense TF32 on the tensor cores
KERNELS = ("corner_min_eigenval", "adam", "vit_attention")  # csrc/<name>.cu
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
# The Adam kernel's entries in the kernels line: (name, FlatAdam options,
# bytes moved per element, ~flops per element). Modes 2 and 3 of
# csrc/adam.cu are optax.radam and optax.adam(mu_dtype=bfloat16).
ADAM_ENTRIES = (
    ("adam", dict(), 28, 14),
    ("adam_radam", dict(rectified=True), 28, 16),
    ("adam_mu_bf16", dict(mu_bf16=True), 24, 14),
)
# (label, bias correction, rectified, bf16 mu, step counts checked): every
# mode of the kernel; RAdam's ro_t crosses 5 between steps 5 and 6 (counts 4
# and 5)
ADAM_CHECKS = (
    ("adam", True, False, False, (0, 7)),
    ("adam", False, False, False, (0, 7)),
    ("adam_radam", True, True, False, (0, 4, 5, 7)),
    ("adam_mu_bf16", True, False, True, (0, 7)),
)


def adam_phase(n_full: int, seed: int) -> list:
    """The Adam kernel in each of its modes against its plain version; the
    kernels-line entries of optax.adam, optax.radam and the bf16 first
    moment (timed at n_full, as on the fine-tune path)."""
    import torch

    from robust_cvd_tpu_torch.ops import adam

    g = torch.Generator(device="cuda").manual_seed(seed)
    lr = 1e-4
    worst = dict.fromkeys((e[0] for e in ADAM_ENTRIES), 0.0)
    entries = []
    for n in (n_full, 1_000_003):
        base = [torch.randn(n, generator=g, device="cuda") for _ in range(3)]
        base.append(torch.rand(n, generator=g, device="cuda") * 1e-2)  # nu >= 0
        base[1].mul_(1e-2)
        for label, bias, rectified, bf16, counts in ADAM_CHECKS:
            start = list(base)
            if bf16:
                start[2] = base[2].to(torch.bfloat16)
            for count0 in counts:
                count = torch.tensor(count0, dtype=torch.int32, device="cuda")
                ok = torch.ones((), dtype=torch.bool, device="cuda")
                got = [t.clone() for t in start]
                ref = [t.clone() for t in start]
                adam.adam_update(*got, count, ok, lr, bias_correction=bias, rectified=rectified)
                torch.cuda.synchronize()
                adam.adam_update_plain(*ref, count, ok, lr, bias_correction=bias,
                                       rectified=rectified)
                for what, a, b in (("update", got[0] - base[0], ref[0] - base[0]),
                                   ("mu", got[2].float(), ref[2].float()),
                                   ("nu", got[3], ref[3])):
                    err = (a - b).abs().max().item()
                    tol = 1e-4 * b.abs().max().item() + 1e-7
                    worst[label] = max(worst[label], err)
                    if not err <= tol:
                        raise AssertionError(
                            f"Adam kernel ({label}) {what} disagrees at n={n}, bias "
                            f"correction {bias}, count {count0}: {err:.3e} > {tol:.3e}")
                if int(count) != count0:
                    raise AssertionError("the Adam kernel wrote the step count")
            skip = [t.clone() for t in start]
            adam.adam_update(*skip, count, torch.zeros_like(ok), lr, bias_correction=bias,
                             rectified=rectified)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(skip, start)):
                raise AssertionError(f"the Adam kernel ({label}) wrote with its guard flag false")
            print(f"adam n={n} {label}: kernel vs plain max|err| {worst[label]:.3e} over mu, "
                  f"nu and the update (bias correction {bias}, counts {counts}); guard false "
                  f"leaves all four buffers bitwise unchanged")
        if n == n_full:
            for name, options, per_elem, flops in ADAM_ENTRIES:
                entries.append(adam_entry(name, options, per_elem, flops, base, lr,
                                          worst[name]))
        del base
    torch.cuda.empty_cache()
    return entries


def adam_entry(name: str, options: dict, per_elem: int, flops: int, base, lr: float,
               err: float) -> dict:
    """Times one mode of the Adam kernel on copies of `base` (p, g, mu, nu;
    4-7 x 4 B x n, far larger than the L2, so back-to-back launches find
    them cold), its wrapper, its plain version and the PyTorch library call
    where one exists; returns its kernels-line entry."""
    import torch

    from robust_cvd_tpu_torch.ops import adam

    rectified, bf16 = options.get("rectified", False), options.get("mu_bf16", False)
    n = base[0].numel()
    count = torch.zeros((), dtype=torch.int32, device="cuda")
    ok = torch.ones((), dtype=torch.bool, device="cuda")
    bufs = [t.clone() for t in base]
    if bf16:
        bufs[2] = bufs[2].to(torch.bfloat16)
    mode = adam._mode(bufs[2], True, rectified)
    fn = adam._kernel()
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [t.data_ptr() for t in bufs]

    def launch(_):
        if fn(*ptrs, n, lr, 0.9, 0.999, 1e-8, mode, count.data_ptr(), ok.data_ptr(), stream):
            raise RuntimeError("adam kernel launch failed")

    ms = back_to_back_ms(launch)
    call_ms = time_ms(lambda: adam.adam_update(*bufs, count, ok, lr, rectified=rectified))
    plain_ms = time_ms(lambda: adam.adam_update_plain(*bufs, count, ok, lr, rectified=rectified))
    library_ms, library = None, "none: no single PyTorch call keeps a bf16 first moment"
    if not bf16:
        flat = torch.nn.Parameter(base[0].clone())
        flat.grad = base[1].clone()
        if rectified:
            # its step enqueues for longer (about 3.5 ms) than the spin ahead
            # of a back-to-back run lasts, so it is timed one call at a time,
            # host included, as call_ms is
            lib = torch.optim.RAdam([flat], lr=lr, foreach=True)
            library = "RAdam(foreach=True), one call"
            library_ms = time_ms(lib.step)
        else:
            lib = torch.optim.Adam([flat], lr=lr, fused=True)
            library = "Adam(fused=True)"
            library_ms = back_to_back_ms(lambda _: lib.step())
        del flat, lib
    nbytes = per_elem * float(n)
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = flops * float(n) / PEAK_F32_FLOPS * 1e3
    result = {
        "name": name,
        "route": "cuda",
        "source": "robust_cvd_tpu_torch/csrc/adam.cu",
        "replaces": ADAM_REPLACES,
        "max_abs_err": err,
        "ms": ms,
        "call_ms": call_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms,
        "gbps": nbytes / ms * 1e-6,
        "share_of_bound": max(bytes_ms, ops_ms) / ms,
    }
    print(f"{name} n={n}: kernel {ms:.4f} ms back to back ({result['gbps']:.1f} GB/s, "
          f"{result['share_of_bound']:.3f} of the bound), one wrapper call {call_ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, bound {result['bound_ms']:.4f} ms ({per_elem} B a "
          f"parameter); library call {library}"
          + ("" if library_ms is None else f" {library_ms:.4f} ms"))
    del bufs
    return result


# The DPT cell's attention (frames, tokens, heads): 4 frames (2 pairs) of
# 1,009 tokens (the 24x42 patch grid of 384x672 and the class token), 16
# heads of 64; and the checks' shapes: one token, one past a 64-key tile,
# 577 (ViT's 24x24 grid and the class token)
ATTENTION_SHAPE = (4, 1009, 16)
ATTENTION_CHECKS = ((1, 1, 2), (2, 65, 3), (1, 577, 4), ATTENTION_SHAPE)
ATTENTION_NAMES = ("flash_attention_fwd_prep", "flash_attention_fwd", "flash_attention_bwd_prep",
                   "flash_attention_bwd_dkdv", "flash_attention_bwd_dq")


def attention_errors(b: int, n: int, h: int, seed: int) -> dict:
    """The attention kernels' and F.scaled_dot_product_attention's (float32)
    largest errors against the plain version in float64 on the same random
    input, for the output and each of dq, dk, dv: max|err| / max|ref| (for a
    gradient that is 0, as dq and dk are at N = 1, over the largest of the
    whole gradient)."""
    import torch
    import torch.nn.functional as F

    from robust_cvd_tpu_torch.ops import attention

    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((b, n, 3, h, 64), generator=g, device="cuda")
    dout = torch.randn((b, n, h, 64), generator=g, device="cuda")

    def sdpa(x):
        q, k, v = x.permute(2, 0, 3, 1, 4)
        return F.scaled_dot_product_attention(q, k, v).transpose(1, 2)

    def run(fn, x):
        x = x.detach().requires_grad_(True)
        y = fn(x)
        y.backward(dout.to(x.dtype))
        return y.detach().double(), x.grad.double()

    ref = run(attention.attention_plain, qkv.double())
    errs = {}
    for name, fn in (("kernel", attention.vit_attention), ("sdpa", sdpa)):
        y, dx = run(fn, qkv)
        pairs = [("out", y, ref[0])] + [(f"d{c}", dx[:, :, i], ref[1][:, :, i])
                                        for i, c in enumerate("qkv")]
        scale = ref[1].abs().max()
        errs[name] = {k: float((a - r).abs().max() / (r.abs().max() or scale))
                      for k, a, r in pairs}
    return errs


def attention_phase(seed: int) -> dict:
    """The attention kernels against the plain version in float64, forward
    and backward, at ATTENTION_CHECKS: each error at most twice
    F.scaled_dot_product_attention's in float32 on the same input (or one
    float32 rounding, 2^-24, where SDPA's is below it); then its
    kernels-line entry."""
    worst = 0.0
    for b, n, h in ATTENTION_CHECKS:
        errs = attention_errors(b, n, h, seed)
        line = ", ".join(f"{k} {v:.3e} (sdpa {errs['sdpa'][k]:.3e})"
                         for k, v in errs["kernel"].items())
        print(f"vit_attention ({b}, {n}, 3, {h}, 64) vs float64: {line}")
        for k, v in errs["kernel"].items():
            worst = max(worst, v)
            if not v <= max(2 * errs["sdpa"][k], 2.0 ** -24):
                raise AssertionError(f"vit_attention {k} at ({b}, {n}, {h}): error {v:.3e}, "
                                     f"more than twice SDPA's {errs['sdpa'][k]:.3e}")
    return attention_entry(seed, worst)


def attention_entry(seed: int, err: float) -> dict:
    """Times the attention kernels at the DPT cell's shape: forward,
    backward, and both, back to back through the raw launchers over two
    input sets (each 50 MB, the L2's size); the plain version (float32,
    forward and backward, one call) and F.scaled_dot_product_attention's
    forward and backward (back to back); the kernels' registers, local
    (spill) bytes and shared memory. Returns its kernels-line entry."""
    import ctypes

    import torch
    import torch.nn.functional as F

    from robust_cvd_tpu_torch.ops import attention

    b, n, h = ATTENTION_SHAPE
    lib = attention._library()
    g = torch.Generator(device="cuda").manual_seed(seed)
    sets = [dict(qkv=torch.randn((b, n, 3, h, 64), generator=g, device="cuda"),
                 dout=torch.randn((b, n, h, 64), generator=g, device="cuda")) for _ in range(2)]
    for t in sets:
        t["out"], t["lse"] = attention.forward_kernel(t["qkv"])
        t["dqkv"] = torch.empty_like(t["qkv"])
    fs, bs = (attention._scratch(lib, sets[0]["qkv"], back) for back in (False, True))
    stream = torch.cuda.current_stream().cuda_stream

    def fwd(i):
        t = sets[i % 2]
        attention._raise(lib.vit_attention_forward(
            t["qkv"].data_ptr(), t["out"].data_ptr(), t["lse"].data_ptr(), fs.data_ptr(), b, n,
            h, stream), "forward")

    def bwd(i):
        t = sets[i % 2]
        attention._raise(lib.vit_attention_backward(
            t["qkv"].data_ptr(), t["out"].data_ptr(), t["lse"].data_ptr(), t["dout"].data_ptr(),
            t["dqkv"].data_ptr(), bs.data_ptr(), b, n, h, stream), "backward")

    fwd_ms, bwd_ms = back_to_back_ms(fwd, k=20), back_to_back_ms(bwd, k=20)
    both_ms = back_to_back_ms(lambda i: (fwd(i), bwd(i)), k=20)
    qkv, dout = sets[0]["qkv"], sets[0]["dout"]
    x = qkv.detach().requires_grad_(True)
    call_ms = time_ms(lambda: torch.autograd.grad(attention.vit_attention(x), x, dout), reps=10)
    plain_ms = time_ms(lambda: torch.autograd.grad(attention.attention_plain(x), x, dout), reps=5)
    q, k, v = (t.detach().requires_grad_(True) for t in qkv.permute(2, 0, 3, 1, 4))
    y = F.scaled_dot_product_attention(q, k, v)
    dy = dout.transpose(1, 2)
    lib_fwd = back_to_back_ms(lambda _: F.scaled_dot_product_attention(q, k, v), k=20)
    lib_bwd = back_to_back_ms(lambda _: torch.autograd.grad(y, (q, k, v), dy, retain_graph=True),
                              k=20)
    info = {}
    for i, name in enumerate(ATTENTION_NAMES):
        regs, local, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        attention._raise(lib.vit_attention_kernel_info(i, ctypes.byref(regs), ctypes.byref(local),
                                                       ctypes.byref(smem)), "info")
        info[name] = {"registers": regs.value, "local_bytes": local.value,
                      "shared_bytes": smem.value}
    flops = 4.0 * b * h * n * n * 64  # q k^T and p v, a forward call
    fwd_bound_ms = 3 * flops / PEAK_TF32_FLOPS * 1e3  # three TF32 products a product
    result = {
        "name": "vit_attention",
        "route": "cuda",
        "source": "robust_cvd_tpu_torch/csrc/vit_attention.cu",
        "replaces": "F.scaled_dot_product_attention (float32), models/dpt.py::Attention",
        "max_abs_err": err,
        "ms": both_ms,
        "forward_ms": fwd_ms,
        "backward_ms": bwd_ms,
        "call_ms": call_ms,
        "plain_ms": plain_ms,
        "bound_ms": 3 * fwd_bound_ms,  # the forward, and the backward at twice its products
        "bound_by": "operations (3xTF32)",
        "library_ms": lib_fwd + lib_bwd,
        "library_forward_ms": lib_fwd,
        "library_backward_ms": lib_bwd,
        "share_of_bound": 3 * fwd_bound_ms / both_ms,
        "ptxas": info,
    }
    print(f"vit_attention {ATTENTION_SHAPE}: forward {fwd_ms:.4f} ms, backward {bwd_ms:.4f} ms, "
          f"both {both_ms:.4f} ms back to back ({result['share_of_bound']:.3f} of the 3xTF32 "
          f"bound {3 * fwd_bound_ms:.4f} ms; forward {flops / 1e9:.2f} GFLOP: "
          f"{flops / PEAK_TF32_FLOPS * 1e6:.1f} us at the TF32 peak, {fwd_bound_ms * 1e3:.1f} us "
          f"at 3xTF32; backward {2 * flops / 1e9:.2f} GFLOP, {2 * flops / PEAK_TF32_FLOPS * 1e6:.1f} / "
          f"{2 * fwd_bound_ms * 1e3:.1f} us), one forward and backward call {call_ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, library F.scaled_dot_product_attention forward "
          f"{lib_fwd:.4f} ms, backward {lib_bwd:.4f} ms; kernels {info}")
    del sets, fs, bs, x, q, k, v, y
    torch.cuda.empty_cache()
    return result


# BEiT-L's cell (frames, token grid, heads): 4 frames (2 pairs) of 512x896,
# a 32x56 patch grid and the class token (1,793 tokens), 16 heads of 64;
# the checks' grids give N = 1 (the class token alone), 65, 577, 1,793, 92
# (7x13: a width that divides neither 32 nor 64, a ragged last key tile)
# and 3,241 (40x81: the widest grid of 40 rows whose table, 12,722
# entries, the kernels take; vit_attention_max_table() is 12,799).
ATTENTION_BIAS_SHAPE = (4, (32, 56), 16)
ATTENTION_BIAS_MAX_GRID = (40, 81)
# (N = 1 with 4 frames of 16 heads: 64 single-key rows, so that the largest
# rounding compared is a maximum over many)
ATTENTION_BIAS_CHECKS = ((4, (0, 0), 16), (2, (8, 8), 3), (1, (24, 24), 4), ATTENTION_BIAS_SHAPE,
                         (2, (7, 13), 3), (1, ATTENTION_BIAS_MAX_GRID, 2))
BIAS_BUDGET = 1.3  # the bias path's time over the path without, at most
ATTENTION_BIAS_NAMES = ("flash_attention_fwd_bias", "flash_attention_bwd_dkdv_bias",
                        "flash_attention_bwd_dq_bias")


def _bias_inputs(b: int, grid, h: int, seed: int):
    """Random qkv (B, N, 3, H, 64), a table (H, R) of standard normals (a
    bias as large as the scores) and dout, on the card."""
    import torch

    wh, ww = grid
    n, r = 1 + wh * ww, (2 * wh - 1) * (2 * ww - 1) + 3
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((b, n, 3, h, 64), generator=g, device="cuda")
    table = torch.randn((h, r), generator=g, device="cuda")
    dout = torch.randn((b, n, h, 64), generator=g, device="cuda")
    return qkv, table, dout


def sdpa_with_bias(x, table, grid):
    """The library call the port would otherwise make: the bias gathered
    from the table into an (H, N, N) float32 mask that requires a gradient,
    then F.scaled_dot_product_attention."""
    import torch.nn.functional as F

    from robust_cvd_tpu_torch.ops import attention

    idx = attention.relative_position_index(grid).to(table.device)
    q, k, v = x.permute(2, 0, 3, 1, 4)
    return F.scaled_dot_product_attention(q, k, v, attn_mask=table[:, idx][None]).transpose(1, 2)


def attention_bias_errors(b: int, grid, h: int, seed: int) -> dict:
    """The bias kernels' and sdpa_with_bias's (float32) largest errors
    against the plain version in float64 on the same random input, for the
    output, dq, dk, dv and the table's gradient dT: max|err| / max|ref|
    (over the whole qkv gradient's largest where a part is 0)."""
    from robust_cvd_tpu_torch.ops import attention

    qkv, table, dout = _bias_inputs(b, grid, h, seed)

    def run(fn, x, t):
        x = x.detach().requires_grad_(True)
        t = t.detach().requires_grad_(True)
        y = fn(x, t, grid)
        y.backward(dout.to(x.dtype))
        return y.detach().double(), x.grad.double(), t.grad.double()

    ref = run(attention.attention_plain, qkv.double(), table.double())
    errs = {}
    for name, fn in (("kernel", attention.vit_attention), ("sdpa", sdpa_with_bias)):
        y, dx, dt = run(fn, qkv, table)
        pairs = ([("out", y, ref[0])] + [(f"d{c}", dx[:, :, i], ref[1][:, :, i])
                                         for i, c in enumerate("qkv")] + [("dT", dt, ref[2])])
        scale = ref[1].abs().max()
        errs[name] = {k: float((a - r).abs().max() / (r.abs().max() or scale))
                      for k, a, r in pairs}
    return errs


BIAS_CHECK_SEEDS = (5, 6, 7)  # the bias kernels' accuracy check's inputs


def attention_bias_errors_max(b: int, grid, h: int) -> dict:
    """attention_bias_errors' largest error of each part over the inputs
    of BIAS_CHECK_SEEDS, each side: the check of both the card test and
    attention_bias_phase. On one input, or one set, the two float32 errors
    can fall either way by a few percent, for the kernels before the dq
    pass's walker warps as for these (the same bits where one CTA covers
    the rows): dk 1.081e-6 and 1.070e-6 at the cell's shape on one input;
    dT 4.03e-7 and 3.87e-7 at the 7x13 grid on seed 0, and 5.288e-7 and
    5.247e-7 at 24x24 over seeds 0-2."""
    runs = [attention_bias_errors(b, grid, h, seed) for seed in BIAS_CHECK_SEEDS]
    return {side: {k: max(r[side][k] for r in runs) for k in runs[0][side]}
            for side in ("kernel", "sdpa")}


def bias_error_limit(errs: dict, part: str, n: int) -> float:
    """The largest error of `part` that the bias kernels may have: SDPA's
    (or 2^-24 where that is below it). With one token the float64 dq, dk
    and dT are exactly 0 (one key: dS = P (dP - D) = 0) and both float32
    results are the rounding of dP - D alone, which falls either way from
    seed to seed: there twice SDPA's, the limit the kernels without a bias
    are held to."""
    lim = max(errs["sdpa"][part], 2.0 ** -24)
    return 2 * lim if n == 1 and part in ("dq", "dk", "dT") else lim


def attention_bias_phase(seed: int) -> dict:
    """The bias kernels against the plain version in float64 at
    ATTENTION_BIAS_CHECKS, the card test's check: out, dq, dk, dv and dT
    each, at its largest over the inputs of BIAS_CHECK_SEEDS, within
    bias_error_limit (sdpa_with_bias's float32 error at its largest over
    the same inputs); then the entry with the times on `seed`'s inputs."""
    worst = 0.0
    for b, grid, h in ATTENTION_BIAS_CHECKS:
        errs = attention_bias_errors_max(b, grid, h)
        n = 1 + grid[0] * grid[1]
        line = ", ".join(f"{k} {v:.3e} (sdpa {errs['sdpa'][k]:.3e})"
                         for k, v in errs["kernel"].items())
        print(f"vit_attention bias ({b}, {n}, 3, {h}, 64), grid {grid} vs float64: {line}")
        for k, v in errs["kernel"].items():
            worst = max(worst, v)
            if not v <= bias_error_limit(errs, k, n):
                raise AssertionError(f"vit_attention bias {k} at ({b}, {grid}, {h}): error "
                                     f"{v:.3e}, more than SDPA's {errs['sdpa'][k]:.3e}")
    return attention_bias_entry(seed, worst)


def attention_bias_entry(seed: int, err: float) -> dict:
    """Times, at BEiT's cell shape, back to back over two input sets: the
    bias kernels' forward, backward and both; the kernels without a bias at
    the same shape (both); sdpa_with_bias's forward and backward, with and
    without the gather; the plain version's one call. Raises unless the
    bias path is faster than the library call; `within_budget` says whether
    it takes at most BIAS_BUDGET times the path without a bias."""
    import ctypes

    import torch

    from robust_cvd_tpu_torch.ops import attention

    b, grid, h = ATTENTION_BIAS_SHAPE
    wh, ww = grid
    n = 1 + wh * ww
    lib = attention._library()
    sets = []
    for i in range(2):
        qkv, table, dout = _bias_inputs(b, grid, h, seed + i)
        t = dict(qkv=qkv, table=table, dout=dout, dqkv=torch.empty_like(qkv),
                 dtable=torch.zeros_like(table))
        t["out"], t["lse"] = attention.forward_bias_kernel(qkv, table, grid)
        t["out0"], t["lse0"] = attention.forward_kernel(qkv)
        sets.append(t)
    r = sets[0]["table"].shape[1]
    pos = attention.grid_offsets(grid, "cuda")
    fs, bs = (attention._scratch(lib, sets[0]["qkv"], back) for back in (False, True))
    stream = torch.cuda.current_stream().cuda_stream

    def fwd(i):
        t = sets[i % 2]
        attention._raise(lib.vit_attention_forward_biased(
            t["qkv"].data_ptr(), t["table"].data_ptr(), pos.data_ptr(), None, t["out"].data_ptr(),
            t["lse"].data_ptr(), fs.data_ptr(), b, n, h, 64, wh, ww, 1, 1, stream), "forward")

    def bwd(i):
        t = sets[i % 2]
        t["dtable"].zero_()
        attention._raise(lib.vit_attention_backward_biased(
            t["qkv"].data_ptr(), t["table"].data_ptr(), pos.data_ptr(), None, t["out"].data_ptr(),
            t["lse"].data_ptr(), t["dout"].data_ptr(), t["dqkv"].data_ptr(),
            t["dtable"].data_ptr(), bs.data_ptr(), b, n, h, 64, wh, ww, 1, 1, stream),
            "backward")

    def plain_both(i):
        t = sets[i % 2]
        attention._raise(lib.vit_attention_forward(
            t["qkv"].data_ptr(), t["out0"].data_ptr(), t["lse0"].data_ptr(), fs.data_ptr(), b, n,
            h, stream), "forward")
        attention._raise(lib.vit_attention_backward(
            t["qkv"].data_ptr(), t["out0"].data_ptr(), t["lse0"].data_ptr(),
            t["dout"].data_ptr(), t["dqkv"].data_ptr(), bs.data_ptr(), b, n, h, stream),
            "backward")

    fwd_ms, bwd_ms = back_to_back_ms(fwd, k=20), back_to_back_ms(bwd, k=20)
    both_ms = back_to_back_ms(lambda i: (fwd(i), bwd(i)), k=20)
    nobias_ms = back_to_back_ms(plain_both, k=20)
    qkv, table, dout = sets[0]["qkv"], sets[0]["table"], sets[0]["dout"]
    x = qkv.detach().requires_grad_(True)
    tt = table.detach().requires_grad_(True)
    call_ms = time_ms(lambda: torch.autograd.grad(attention.vit_attention(x, tt, grid), (x, tt),
                                                  dout), reps=10)
    idx = attention.relative_position_index(grid).cuda()
    q, k, v = (u.detach().requires_grad_(True) for u in qkv.permute(2, 0, 3, 1, 4))
    mask = table[:, idx][None].detach().requires_grad_(True)
    import torch.nn.functional as F

    y = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    dy = dout.transpose(1, 2)
    lib_fwd = back_to_back_ms(lambda _: F.scaled_dot_product_attention(q, k, v, attn_mask=mask),
                              k=10)
    lib_bwd = back_to_back_ms(
        lambda _: torch.autograd.grad(y, (q, k, v, mask), dy, retain_graph=True), k=10)
    lib_call_ms = time_ms(lambda: torch.autograd.grad(sdpa_with_bias(x, tt, grid), (x, tt),
                                                      dout), reps=5)
    del y, mask
    plain_ms = time_ms(lambda: torch.autograd.grad(attention.attention_plain(x, tt, grid),
                                                   (x, tt), dout), reps=3)
    info = {}
    for i, name in zip((5, 6, 7), ATTENTION_BIAS_NAMES):
        regs, local, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        attention._raise(lib.vit_attention_kernel_info(i, ctypes.byref(regs), ctypes.byref(local),
                                                       ctypes.byref(smem)), "info")
        info[name] = {"registers": regs.value, "local_bytes": local.value,
                      "shared_bytes": smem.value + (i == 7) * 8 * lib.vit_attention_dq_bias_copy_cls(
                          wh, ww, 1)}
    flops = 4.0 * b * h * n * n * 64
    bound_ms = 3 * 3 * flops / PEAK_TF32_FLOPS * 1e3
    result = {
        "name": "vit_attention_bias",
        "route": "cuda",
        "source": "robust_cvd_tpu_torch/csrc/vit_attention.cu",
        "replaces": "the bias gather and F.scaled_dot_product_attention with a float32 mask, "
                    "models/beit.py::Attention",
        "max_abs_err": err,
        "ms": both_ms,
        "forward_ms": fwd_ms,
        "backward_ms": bwd_ms,
        "no_bias_ms": nobias_ms,
        "bias_over_no_bias": both_ms / nobias_ms,
        "call_ms": call_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations (3xTF32)",
        "library_ms": lib_fwd + lib_bwd,
        "library_forward_ms": lib_fwd,
        "library_backward_ms": lib_bwd,
        "library_call_ms": lib_call_ms,
        "share_of_bound": bound_ms / both_ms,
        "ptxas": info,
    }
    print(f"vit_attention bias ({b}, {n}, 3, {h}, 64), grid {grid}, table {r}: forward "
          f"{fwd_ms:.4f} ms, backward {bwd_ms:.4f} ms, both {both_ms:.4f} ms back to back "
          f"({both_ms / nobias_ms:.3f}x the {nobias_ms:.4f} ms without a bias; "
          f"{result['share_of_bound']:.3f} of the 3xTF32 bound {bound_ms:.4f} ms), one call "
          f"{call_ms:.4f} ms, plain {plain_ms:.4f} ms; library SDPA with a float32 mask "
          f"forward {lib_fwd:.4f} ms, backward {lib_bwd:.4f} ms back to back, with the gather "
          f"one call {lib_call_ms:.4f} ms; kernels {info}")
    result["within_budget"] = both_ms <= BIAS_BUDGET * nobias_ms
    if not result["within_budget"]:
        print(f"vit_attention bias: {both_ms / nobias_ms:.3f}x the path without a bias, over "
              f"its {BIAS_BUDGET}x budget")
    if both_ms >= lib_fwd + lib_bwd:
        raise AssertionError("the bias path is not faster than SDPA with a float32 mask")
    del sets, fs, bs, x, tt, q, k, v
    torch.cuda.empty_cache()
    return result


# Swin V2-L/24-384's window attention at 384x384 (frames, window side,
# heads, windows an image, shifted): stage 2's one 576-token window a frame
# of 24 heads (18 blocks, no shift) and stage 0's shifted block, 16 windows
# an image of 6 heads with the shift mask; the checks add a window of 3x3
# (N 9), stage 3's 12x12 (N 144: a ragged last block) and a shifted 8x8
# map of 4x4 windows.
WINDOW_STAGE2 = (4, 24, 24, 1, False)
WINDOW_STAGE0 = (64, 24, 6, 16, True)
WINDOW_CHECKS = ((2, 3, 2, 1, False), (4, 12, 48, 1, False), (8, 4, 3, 4, True),
                 (4, 24, 4, 1, False), (16, 24, 2, 16, True))
WINDOW_NAMES = ("flash_attention_fwd_prep32", "flash_attention_bwd_prep32",
                "flash_attention_fwd_window", "flash_attention_bwd_dkdv_window",
                "flash_attention_bwd_dq_window", "flash_attention_fwd_window_mask",
                "flash_attention_bwd_dkdv_window_mask", "flash_attention_bwd_dq_window_mask")
WINDOW_TAU = 10.0  # timm's initial temperature, exp(log 10)


def _window_inputs(b: int, w: int, h: int, nw: int, shifted: bool, seed: int):
    """Inputs of Swin V2's window attention on the card: q = tau q^, k^
    (unit rows) and v, (B, w^2, 3, H, 32); a table 16 sigmoid(2 N(0, 1))
    (H, (2w - 1)^2); the region codes of a shifted map of nw windows an
    image (or None); dout."""
    import math

    import torch
    import torch.nn.functional as F

    from robust_cvd_tpu_torch.models import swin2

    n = w * w
    g = torch.Generator(device="cuda").manual_seed(seed)
    raw = torch.randn((b, n, 3, h, 32), generator=g, device="cuda")
    q, k, v = raw.unbind(2)
    qkv = torch.stack([F.normalize(q, dim=-1) * WINDOW_TAU, F.normalize(k, dim=-1), v], 2)
    table = 16 * torch.sigmoid(2 * torch.randn((h, (2 * w - 1) ** 2), generator=g,
                                               device="cuda"))
    region = None
    if shifted:
        side = w * math.isqrt(nw)
        region = swin2.region_codes(side, w, w // 2).cuda()
    dout = torch.randn((b, n, h, 32), generator=g, device="cuda")
    return qkv.contiguous(), table, region, dout


def sdpa_window(x, table, window, region):
    """The library call the port would otherwise make: the bias gathered
    and the mask added into a (B, H, N, N) float32 mask that requires a
    gradient, then F.scaled_dot_product_attention at scale 1."""
    import torch
    import torch.nn.functional as F

    from robust_cvd_tpu_torch.ops import attention

    idx = attention.relative_position_index(window, cls=False).to(table.device)
    mask = table[:, idx][None].expand(x.shape[0], -1, -1, -1)
    if region is not None:
        other = region[:, :, None] != region[:, None, :]
        m = torch.where(other, attention.MASK_VALUE, 0.0)
        mask = mask + m.repeat(x.shape[0] // region.shape[0], 1, 1)[:, None]
    q, k, v = x.permute(2, 0, 3, 1, 4)
    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=1.0).transpose(1, 2)


def window_attention_errors(b: int, w: int, h: int, nw: int, shifted: bool, seed: int) -> dict:
    """The window kernels' and sdpa_window's (float32) largest errors
    against the plain version in float64 on the same input: out, dq, dk,
    dv and dT, max|err| / max|ref|."""
    from robust_cvd_tpu_torch.ops import attention

    qkv, table, region, dout = _window_inputs(b, w, h, nw, shifted, seed)

    def run(fn, x, t):
        x = x.detach().requires_grad_(True)
        t = t.detach().requires_grad_(True)
        y = fn(x, t, (w, w), region)
        y.backward(dout.to(x.dtype))
        return y.detach().double(), x.grad.double(), t.grad.double()

    def plain(x, t, window, reg):
        return attention.attention_plain(x, t, window, reg, window=True)

    ref = run(plain, qkv.double(), table.double())
    errs = {}
    for name, fn in (("kernel", attention.window_attention), ("sdpa", sdpa_window)):
        y, dx, dt = run(fn, qkv, table)
        pairs = ([("out", y, ref[0])] + [(f"d{c}", dx[:, :, i], ref[1][:, :, i])
                                         for i, c in enumerate("qkv")] + [("dT", dt, ref[2])])
        errs[name] = {k: float((a - r).abs().max() / r.abs().max()) for k, a, r in pairs}
    return errs


def window_attention_errors_max(b, w, h, nw, shifted) -> dict:
    """window_attention_errors' largest of each part over BIAS_CHECK_SEEDS."""
    runs = [window_attention_errors(b, w, h, nw, shifted, seed) for seed in BIAS_CHECK_SEEDS]
    return {side: {k: max(r[side][k] for r in runs) for k in runs[0][side]}
            for side in ("kernel", "sdpa")}


def window_error_limit(errs: dict, part: str) -> float:
    """The largest error of `part` the window kernels may have: twice
    sdpa_window's (or 2^-24 where that is below it), the limit the kernels
    without a bias are held to. Both are float32 roundings of the same
    sums and fall either way at small windows: dv at a 3x3 window read
    9.45e-7 against SDPA's 8.57e-7 over seeds 5-7 (NVIDIA H100 80GB HBM3)."""
    return 2 * max(errs["sdpa"][part], 2.0 ** -24)


def window_attention_phase(seed: int) -> dict:
    """The window kernels against the plain version in float64 at
    WINDOW_CHECKS and both cell shapes: out, dq, dk, dv and dT each, at its
    largest over BIAS_CHECK_SEEDS, within window_error_limit of SDPA's
    float32 error at its largest over the same inputs; then the entry with
    the times."""
    worst = 0.0
    for b, w, h, nw, shifted in WINDOW_CHECKS + (WINDOW_STAGE2, WINDOW_STAGE0):
        errs = window_attention_errors_max(b, w, h, nw, shifted)
        line = ", ".join(f"{k} {v:.3e} (sdpa {errs['sdpa'][k]:.3e})"
                         for k, v in errs["kernel"].items())
        print(f"window_attention ({b}, {w * w}, 3, {h}, 32), window {w}, "
              f"{'shifted ' * shifted}vs float64: {line}")
        for k, v in errs["kernel"].items():
            worst = max(worst, v)
            if not v <= window_error_limit(errs, k):
                raise AssertionError(f"window_attention {k} at ({b}, {w}, {h}, shifted "
                                     f"{shifted}): error {v:.3e}, more than twice SDPA's "
                                     f"{errs['sdpa'][k]:.3e}")
    return window_attention_entry(seed, worst)


def _window_times(shape, seed: int) -> dict:
    """At one shape, back to back over two input sets: the kernels'
    forward, backward and both (through the autograd Function's launchers),
    and sdpa_window's forward and backward with the mask requiring a
    gradient."""
    import torch
    import torch.nn.functional as F

    from robust_cvd_tpu_torch.ops import attention

    b, w, h, nw, shifted = shape
    sets = []
    for i in range(2):
        qkv, table, region, dout = _window_inputs(b, w, h, nw, shifted, seed + i)
        out, lse = attention.forward_bias_kernel(qkv, table, (w, w), region, cls=False)
        sets.append(dict(qkv=qkv, table=table, region=region, dout=dout, out=out, lse=lse))

    def fwd(i):
        t = sets[i % 2]
        attention.forward_bias_kernel(t["qkv"], t["table"], (w, w), t["region"], cls=False)

    def bwd(i):
        t = sets[i % 2]
        attention.backward_bias_kernel(t["qkv"], t["table"], (w, w), t["out"], t["lse"],
                                       t["dout"], t["region"], cls=False)

    fwd_ms, bwd_ms = back_to_back_ms(fwd, k=20), back_to_back_ms(bwd, k=20)
    both_ms = back_to_back_ms(lambda i: (fwd(i), bwd(i)), k=20)
    t = sets[0]
    idx = attention.relative_position_index((w, w), cls=False).cuda()
    mask = t["table"][:, idx][None].expand(b, -1, -1, -1)
    if t["region"] is not None:
        other = t["region"][:, :, None] != t["region"][:, None, :]
        mask = mask + torch.where(other, attention.MASK_VALUE, 0.0).repeat(
            b // nw, 1, 1)[:, None]
    mask = mask.contiguous().requires_grad_(True)
    q, k, v = (u.detach().requires_grad_(True) for u in t["qkv"].permute(2, 0, 3, 1, 4))
    y = F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=1.0)
    dy = t["dout"].transpose(1, 2)
    lib_fwd = back_to_back_ms(
        lambda _: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=1.0), k=10)
    lib_bwd = back_to_back_ms(
        lambda _: torch.autograd.grad(y, (q, k, v, mask), dy, retain_graph=True), k=10)
    n = w * w
    flops = 4.0 * b * h * n * n * 32
    bound_ms = 3 * 3 * flops / PEAK_TF32_FLOPS * 1e3
    del sets, y, mask, q, k, v
    torch.cuda.empty_cache()
    return {"forward_ms": fwd_ms, "backward_ms": bwd_ms, "ms": both_ms,
            "library_forward_ms": lib_fwd, "library_backward_ms": lib_bwd,
            "library_ms": lib_fwd + lib_bwd, "bound_ms": bound_ms,
            "share_of_bound": bound_ms / both_ms}


def window_attention_entry(seed: int, err: float) -> dict:
    """Times the window kernels at stage 2's and stage 0's shapes (budget:
    forward and backward faster than sdpa_window's), their registers, local
    bytes and shared memory. Raises where a shape misses the budget."""
    import ctypes

    import torch

    from robust_cvd_tpu_torch.ops import attention

    lib = attention._library()
    shapes = {"stage2": _window_times(WINDOW_STAGE2, seed),
              "stage0_shifted": _window_times(WINDOW_STAGE0, seed)}
    info = {}
    for i, name in enumerate(WINDOW_NAMES, 8):
        regs, local, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        attention._raise(lib.vit_attention_kernel_info(i, ctypes.byref(regs), ctypes.byref(local),
                                                       ctypes.byref(smem)), "info")
        info[name] = {"registers": regs.value, "local_bytes": local.value,
                      "shared_bytes": smem.value}
    result = {
        "name": "vit_attention_window",
        "route": "cuda",
        "source": "robust_cvd_tpu_torch/csrc/vit_attention.cu",
        "replaces": "the bias gathered and the shift mask added into a float32 mask, then "
                    "F.scaled_dot_product_attention at scale 1, models/swin2.py::WindowAttention",
        "max_abs_err": err,
        "ms": shapes["stage2"]["ms"],
        "shapes": shapes,
        "bound_by": "operations (3xTF32)",
        "ptxas": info,
    }
    for name, r in shapes.items():
        print(f"window_attention {name}: forward {r['forward_ms']:.4f} ms, backward "
              f"{r['backward_ms']:.4f} ms, both {r['ms']:.4f} ms back to back "
              f"({r['share_of_bound']:.3f} of the 3xTF32 bound {r['bound_ms']:.4f} ms); library "
              f"SDPA with a float32 mask forward {r['library_forward_ms']:.4f} ms, backward "
              f"{r['library_backward_ms']:.4f} ms")
    print(f"window_attention kernels {info}")
    for name, r in shapes.items():
        if r["ms"] >= r["library_ms"]:
            raise AssertionError(f"the window path at {name} is not faster than SDPA with a "
                                 f"float32 mask")
    return result


def window_launches_check(seed: int) -> dict:
    """The window kernels' launches on the main path at the cell's shapes:
    one FineTuner.train_step (a StepGraph's first call runs eagerly) of the
    published SwinV2-L/24-384 through DPTSwin2LargeAdapter, on a 4-frame
    384x672 clip, batch 2 pairs (4 frames). With the six vit_attention
    counters set to 0 just before it, `window_launches` and
    `.window_backward_launches` read its 24 blocks each (the 2 shifted
    blocks with the mask), the other forms 0. Returns the counts under
    `fine_tune_step`."""
    import torch

    from robust_cvd_tpu_torch.models import swin2
    from robust_cvd_tpu_torch.ops import attention

    va = attention.vit_attention
    names = ("launches", "backward_launches", "bias_launches", "bias_backward_launches",
             "window_launches", "window_backward_launches")
    with torch.device("cuda"):
        net = swin2.Swin2DepthNet()
    tuner = small_tuner("cuda", seed, h=384, w=672, adapter=swin2.DPTSwin2LargeAdapter(net),
                        cudnn_tf32=True)
    for k in names:
        setattr(va, k, 0)
    loss, _, ok = tuner.train_step(torch.tensor([0, 2], device="cuda"))
    torch.cuda.synchronize()
    got = {k: getattr(va, k) for k in names}
    eager = tuner.step_graph.stats["eager"] if tuner.step_graph is not None else 1
    print(f"window_attention launches over one eager Swin2 train step (batch 2 pairs, "
          f"384x672): {got}, loss {float(loss):.4g}, finite guard {bool(ok)}")
    if eager != 1:
        raise AssertionError(f"the Swin2 train step was not one eager step ({eager})")
    if [got[k] for k in names] != [0, 0, 0, 0, 24, 24]:
        raise AssertionError(f"the window kernels ran {got}, not 24 + 24")
    del tuner, net
    torch.cuda.empty_cache()
    return {"fine_tune_step": got}


def small_tuner(device: str, seed: int, n: int = 4, h: int = 32, w: int = 64, mesh=None,
                adapter=None, cudnn_tf32: bool = False, **ft_options):
    """A FineTuner of the small MiDaS net (or of `adapter`) on an n-frame
    h x w clip (seeded images, depths, flows and masks; a pose state from
    seeded poses, a 2x3 depth grid and a spatial warp), convolutions with
    TF32 only where `cudnn_tf32`, on the data mesh `mesh` where one is
    given; `ft_options` go to its FineTuneParams (the optimizer).

    The net's BatchNorms ahead of a ReLU get a bias of +3. With random
    weights about a quarter of such small configurations have a ReLU input
    within float32 rounding of 0, where two float32 implementations take
    different ReLU decisions and the gradients upstream move by up to 1e-3
    of their largest value (measured on the CPU, float32 against float64,
    12 seeds); with the shift none did, and mu and nu agreed within 2.3e-5."""
    import torch

    from robust_cvd_tpu_torch.config import FineTuneParams, PipelineConfig
    from robust_cvd_tpu_torch.models import layers, midas
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
    if adapter is None:
        net = midas.seeded_init_(midas.MidasNet(features=32, backbone_layers=(1, 1, 1, 1)),
                                 seed)
        with torch.no_grad():
            for name, m in net.named_modules():
                if isinstance(m, layers.BatchNorm2d) and not name.endswith("bn3"):
                    m.bias.fill_(3.0)
        adapter = midas.MidasV2Adapter(net)
    cfg = PipelineConfig(ft=FineTuneParams(save_tensorboard=False, **ft_options))
    clip = build_clip_data(images, depth, flow_list, flows, masks, 0.2, device=device)
    tuner = FineTuner(cfg, adapter, clip, None, device=device, cudnn_tf32=cudnn_tf32,
                      mesh=mesh)
    tuner.pose_state = pose_state_from_solver(
        SolverParams(*[t.to(device) for t in sp[:4]]), (h, w), w / h, clip.depth_orig
    )
    return tuner


# The optimizers of the fine-tune path: (name, FineTuneParams options, the
# Adam kernel's mode)
OPTIMIZERS = (
    ("adam", dict(), "adam"),
    ("radam", dict(optimizer="RAdam"), "radam"),
    ("mu_bf16", dict(optimizer_mu_bf16=True), "adam_mu_bf16"),
)


def step_phase(seed: int) -> None:
    """Two train steps of the small net on the card (Adam kernel) and on the
    CPU (plain Adam), without TF32 on either, with each optimizer: Adam,
    RAdam and Adam with a bf16 first moment. Losses, parameters and
    BatchNorm statistics agree within 1e-4 relative; mu and nu within 1e-3:
    the head's 1x1 convolution (scratch.output_conv.4) sums 8,192 products
    with heavy cancellation into each weight gradient, card and CPU sum
    them in different orders (the card's order varies from call to call),
    and in float32 mu there differs by up to 3.5e-4 of the largest gradient
    and nu, a square, by up to 4.2e-4 (14 runs on the H100, 3 seeds; the
    CPU's float32 step differs from its float64 step as much), while every
    other tensor agreed within 1e-5. A bf16 mu rounds two such values to
    neighbouring bf16 numbers, so there each element may also differ by one
    bf16 ulp of its value."""
    import torch

    from robust_cvd_tpu_torch.models import layers
    from robust_cvd_tpu_torch.ops import adam

    def run(device, options):
        tuner = small_tuner(device, seed, **options)
        losses = []
        for ids in ((2, 0), (1, 3)):
            loss, _, ok = tuner.train_step(torch.tensor(ids, device=device))
            if not bool(ok):
                raise AssertionError(f"train step on {device} was skipped")
            losses.append(loss.item())
        opt = tuner.optimizer
        stats = torch.cat([torch.cat([m.running_mean, m.running_var])
                           for m in layers.batch_norms(tuner.net)])
        return losses, {"params": opt.flat, "mu": opt.mu.float(), "nu": opt.nu,
                        "batch_stats": stats, "count": opt.count}

    for label, options, mode in OPTIMIZERS:
        before = adam.adam_update.launches_by_mode[mode]
        gpu_losses, gpu = run("cuda", options)
        if adam.adam_update.launches_by_mode[mode] != before + 2:
            raise AssertionError(f"the card's train steps ({label}) did not launch the "
                                 f"Adam kernel's {mode} mode")
        cpu_losses, cpu = run("cpu", options)
        err = max(abs(a - b) / abs(b) for a, b in zip(gpu_losses, cpu_losses))
        report = [f"losses {err:.3e} (1e-4)"]
        ok = err <= 1e-4
        for name, tol in (("params", 1e-4), ("batch_stats", 1e-4), ("mu", 1e-3), ("nu", 1e-3)):
            a, b = gpu[name].cpu(), cpu[name]
            diff = (a - b).abs()
            rel = (diff.max() / b.abs().max()).item()
            report.append(f"{name} {rel:.3e} ({tol:g})")
            if name == "mu" and label == "mu_bf16":
                # one bf16 ulp of each element on top of the float32 tolerance
                ulp = torch.exp2(torch.floor(torch.log2(b.abs().clamp_min(2.0**-126))) - 7)
                ok = ok and bool((diff <= tol * b.abs().max() + ulp).all())
            else:
                ok = ok and rel <= tol
        ok = ok and int(gpu["count"]) == int(cpu["count"]) == 2
        print(f"train step, card vs CPU ({label}, 2 steps, small net, 4x32x64, no TF32): "
              "relative max|err| (tolerance) " + ", ".join(report))
        if not ok:
            raise AssertionError(f"the train step on the card ({label}) disagrees with the CPU")


# step_graph_check's steps: the pair ids of each, None where the pose state
# is swapped for another
GRAPH_STEPS = ((2, 0), (4,), (1, 3), None, (0,), (3, 4), (2, 1))
GRAPH_EAGER_RUNS = 5
# step_graph_check's tolerances, relative to the largest magnitude: those of
# step_phase (the card against the CPU)
GRAPH_TOL = {"losses": 1e-4, "params": 1e-4, "batch_stats": 1e-4, "mu": 1e-3, "nu": 1e-3}


def graph_steps(tuner, device: str) -> dict:
    """GRAPH_STEPS through tuner.train_step; the state after them."""
    import torch

    from robust_cvd_tpu_torch.models import layers

    losses, oks = [], []
    for ids in GRAPH_STEPS:
        if ids is None:
            ps = tuner.pose_state
            tuner.pose_state = ps._replace(extrinsics=ps.extrinsics + 0.05,
                                           scales=ps.scales * 1.1, warp=ps.warp * 0.5)
            continue
        loss, _, ok = tuner.train_step(torch.tensor(ids, device=device))
        losses.append(loss)
        oks.append(ok)
    opt = tuner.optimizer
    stats = torch.cat([torch.cat([m.running_mean, m.running_var])
                       for m in layers.batch_norms(tuner.net)])
    return {"losses": torch.stack(losses), "oks": torch.stack(oks), "params": opt.flat,
            "mu": opt.mu.float(), "nu": opt.nu, "batch_stats": stats, "count": opt.count}


def step_graph_check(seed: int, device: str = "cuda") -> dict:
    """The small tuner's steps through its StepGraph (one eager warm-up
    call a batch size, so that both sizes capture and replay) against
    GRAPH_EAGER_RUNS runs of the eager train_step from the same state.
    Each tensor's gap is max|graph - eager| / max|eager| to the nearest
    eager run, its spread the largest such difference between two eager
    runs. Where the eager runs agree bitwise, the graph's must equal them.
    Elsewhere the card's kernels add in a varying order (atomics in the
    backward of the upsampling and of grid_sample), and now and then a
    heavily cancelled gradient element of one run, graph or eager, lands
    far from the others' (mu and nu, up to 1.5e-4 of their largest value
    on the H100 between two eager runs; a graph run is no more prone to
    it). A gap under the spread of five runs would then fail about one
    fault-free check in twenty, so the gap is held to step_phase's tolerance
    of the card against the CPU (GRAPH_TOL), which a stale pose state, a
    lost BatchNorm commit or an extra Adam update exceeds many times. The
    step count must be equal, every step taken. Returns {name: (gap,
    spread)}."""
    import torch

    eager = []
    for _ in range(GRAPH_EAGER_RUNS):
        tuner = small_tuner(device, seed)
        tuner.step_graph = None
        eager.append(graph_steps(tuner, device))
    tuner = small_tuner(device, seed)
    tuner.step_graph.warmup = 1
    graphed = graph_steps(tuner, device)
    stats = tuner.step_graph.stats
    want = {"eager": 2, "captures": 2, "replays": 4, "pose_copies": 2}
    if stats != want:
        raise AssertionError(f"step graph: {stats}, expected {want}")

    def diff(a, b):
        return float((a.double() - b.double()).abs().max() / b.double().abs().max())

    report, ok = {}, True
    for name, tol in GRAPH_TOL.items():
        runs = [e[name] for e in eager]
        spread = max(diff(a, b) for i, a in enumerate(runs) for b in runs[i + 1:])
        gap = min(diff(graphed[name], a) for a in runs)
        report[name] = (gap, spread)
        ok = ok and gap <= (tol if spread else 0.0)
    counts = {int(r["count"]) for r in eager + [graphed]}
    taken = all(bool(r["oks"].all()) for r in eager + [graphed])
    print(f"step graph vs eager ({len(GRAPH_STEPS) - 1} steps of batch 2 and 1, a pose swap, "
          f"small net, 4x32x64, no TF32; {GRAPH_EAGER_RUNS} eager runs): relative max|err| to "
          "the nearest eager run (between eager runs; tolerance) "
          + ", ".join(f"{k} {g:.3e} ({s:.3e}; {GRAPH_TOL[k]:g})" for k, (g, s) in report.items())
          + f"; counts {sorted(counts)}; graph {stats}")
    if not ok or counts != {len(GRAPH_STEPS) - 1} or not taken:
        raise AssertionError("the graphed train step disagrees with the eager one")
    return report


def eval_check(seed: int) -> None:
    """eval_pair_losses of the small tuner on the card and on the CPU (no
    TF32 on either): per-pair totals and parts within EVAL_TOL relative to
    the largest magnitude of each."""
    card, cpu = (small_tuner(d, seed).eval_pair_losses() for d in ("cuda", "cpu"))
    worst = 0.0
    for key in card[0]:
        if key == "pair":
            continue
        a = np.array([e[key] for e in card])
        b = np.array([e[key] for e in cpu])
        if not np.isfinite(a).all():
            raise AssertionError(f"non-finite eval {key} on the card")
        worst = max(worst, float(np.abs(a - b).max() / np.abs(b).max()))
    print(f"eval, card vs CPU ({len(card)} pairs, small net, 4x32x64, no TF32): relative "
          f"max|err| {worst:.3e} over the per-pair totals and parts (tolerance {EVAL_TOL:g})")
    if [e["pair"] for e in card] != [e["pair"] for e in cpu] or not worst <= EVAL_TOL:
        raise AssertionError("eval_pair_losses on the card disagrees with the CPU")


def solver_phase(seed: int) -> None:
    """A 6-frame exact-reprojection problem with corrupted per-frame depth
    scales (the shape of bench.py::make_clip_problem), solved on the card
    and on the CPU; then a cold solve on the card with the exact diagonal
    off and 4 Hutchinson probes an outer step (lm_precond_probes, at most
    10 LM steps a solve), every LM solve of which must end below its
    start."""
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

    def solve(device, opt=opt, log=None):
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
        return pose_opt.run(opt, inputs, log=log).pose.cpu()

    gpu, cpu = solve("cuda"), solve("cpu")
    err = (gpu - cpu).abs().max().item()
    print(f"solver: 6-frame cold solve, card vs CPU poses max|err| {err:.3e} (tolerance 1e-3)")
    if not err <= 1e-3:
        raise AssertionError("the solver on the card disagrees with the CPU")
    log = []
    # at most 10 LM steps a solve: with the default 50 it ran to the cap
    probed = solve("cuda", dataclasses.replace(opt, lm_precond_exact=False,
                                               lm_precond_probes=4, lm_max_outer=10), log)
    for e in log:
        print("solve with probes " + json.dumps(e))
    if not (log and all(e["cost"] < e["cost0"] for e in log)
            and torch.isfinite(probed).all()):
        raise AssertionError("the cold solve with Hutchinson probes did not end below its start")
    print(f"solver: 6-frame cold solve with 4 Hutchinson probes on the card, {len(log)} LM "
          f"solves below their start; poses within {(probed - gpu).abs().max().item():.3e} "
          f"of the exact-diagonal solve's")


# The sharded solve's check: the static scene of
# tests/test_torch_pkg_sharded_solve.py (tests/test_solver.py's
# make_scene(num_frames=4, pts_per_pair=24): exact reprojections, cameras
# at (0.1 i, 0, 0.05 i), focal 0.5) under tests/test_parallel_solver.py's
# options, held to that test's bounds.
SHARDED_RANKS = 2
SHARDED_OPT = dict(num_steps=2, ctf_long=4, ctf_short=3, lm_max_outer=10, lm_cg_iters=16,
                   graduate_deformation_regularization=True)
SHARDED_POSE_ATOL, SHARDED_GRID_RTOL = 5e-3, 2e-2
RANKS_JOIN_S = 300  # the sharded solve's ranks' time limit


def sharded_scene(num_frames: int = 4, pts: int = 24, seed: int = 0) -> dict:
    """make_scene's pair constraints as numpy arrays (ConstraintData's
    fields), drawn from the same numpy generator."""
    import torch

    from robust_cvd_tpu_torch.solver import residuals

    rng = np.random.default_rng(seed)
    pose = np.zeros((num_frames, 6), np.float32)
    pose[:, 0] = 0.1 * np.arange(num_frames)
    pose[:, 2] = 0.05 * np.arange(num_frames)
    pair = np.asarray([(i, j) for i in range(num_frames) for j in range(num_frames)
                       if abs(i - j) == 1], np.int64)
    ndc = rng.uniform(-0.8, 0.8, (len(pair), pts, 2)).astype(np.float32)
    depth = rng.uniform(1.5, 3.0, (len(pair), pts)).astype(np.float32)
    f = torch.full((len(pair),), 0.5)
    pose_t = torch.from_numpy(pose)
    world = residuals.camera_to_world(
        torch.cat([torch.from_numpy(ndc), torch.from_numpy(depth)[..., None]], -1), f, f,
        pose_t[pair[:, 0]])
    pj = residuals.world_to_camera(world, f, f, pose_t[pair[:, 1]]).numpy()
    return dict(pair=pair, loc0=ndc, loc1=np.ascontiguousarray(pj[..., :2]), depth0=depth,
                depth1=np.ascontiguousarray(pj[..., 2]),
                weight=np.ones((len(pair), pts), np.float32))


def sharded_solve(arrays: dict, opt: dict, device, mesh=None) -> dict:
    """pose_opt.run with the PoseOptParams `opt` on the scene `arrays` on
    `device`: on this rank's share
    (shard_pose_inputs) with a mesh, else whole. Returns the poses, depth
    grid, each LM solve's stage, SolverParams digest (on a mesh) and
    all-reduces, and the seconds (the card synchronized)."""
    import torch

    from robust_cvd_tpu_torch.config import PoseOptParams
    from robust_cvd_tpu_torch.parallel.mesh import shard_pose_inputs
    from robust_cvd_tpu_torch.solver import pose_opt
    from robust_cvd_tpu_torch.solver.residuals import ConstraintData

    n = int(arrays["pair"].max()) + 1
    inputs = pose_opt.PoseOptInputs(
        data=ConstraintData(**{k: torch.from_numpy(arrays[k]).to(device)
                               for k in ConstraintData._fields}),
        median_depth=torch.full((n,), 2.5, device=device), aspect=1.0, num_frames=n)
    if mesh is not None:
        inputs = shard_pose_inputs(inputs, mesh)
    log = []
    t0 = time.perf_counter()
    sp = pose_opt.run(PoseOptParams(**opt), inputs,
                      focal=torch.full((n,), 0.5, device=device), log=log)
    pose = sp.pose.cpu().numpy()
    return dict(pose=pose, depth_grid=sp.depth_grid.cpu().numpy(),
                stages=np.array([e["stage"] for e in log]),
                digests=np.array([e.get("digest", "") for e in log]),
                all_reduces=np.array([e.get("all_reduces", 0) for e in log]),
                seconds=time.perf_counter() - t0)


def sharded_solve_rank(rank: int, size: int, store: str, arrays: dict, opt: dict,
                       out_dir: str, device: str) -> None:
    """One rank of the sharded-solve check (gloo over the file:// `store`,
    sharing `device`): sharded_solve on its share twice, the second saved
    with its collective seconds to sharded_rank<r>.npz (a fresh process's
    first solve also loads its kernels: 16.5 s against 5.9 s warm on an
    H100)."""
    import torch

    from robust_cvd_tpu_torch.parallel.mesh import destroy_mesh, init_mesh

    if device == "cpu":
        torch.set_num_threads(1)
    mesh = init_mesh(backend="gloo", device=device, init_method=f"file://{store}", rank=rank,
                     world_size=size)
    try:
        sharded_solve(arrays, opt, mesh.device, mesh)
        mesh.stats.update(collectives=0, collective_s=0.0)
        res = sharded_solve(arrays, opt, mesh.device, mesh)
        res["all_reduce_s"] = mesh.stats["collective_s"]
    finally:
        destroy_mesh()
    np.savez(os.path.join(out_dir, f"sharded_rank{rank}.npz"), **res)


def join_ranks(ctx, limit_s: float, what: str) -> None:
    """Wait for spawned ranks; a failed rank raises (the others are
    stopped), past limit_s all are killed."""
    deadline = time.monotonic() + limit_s
    while not ctx.join(max(1.0, deadline - time.monotonic())):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{what}: the ranks did not finish in {limit_s} s")


def sharded_solve_check(device: str = "cuda") -> None:
    """The constraint-sharded pose solve on `device`: the static scene
    (sharded_scene) solved in this process (the second of two solves),
    then on SHARDED_RANKS spawned ranks that share the device over gloo
    (sharded_solve_rank). Every rank's SolverParams equal
    bit for bit after every LM solve, the poses within SHARDED_POSE_ATOL
    and the depth grid within SHARDED_GRID_RTOL of the one-process solve's
    (the sums over the constraints run in another order), all-reduces in
    every solve but the normalize solve (per-frame data only, whole on
    every rank). Prints the seconds of both and the all-reduces."""
    import torch.multiprocessing as mp

    arrays, opt = sharded_scene(), SHARDED_OPT
    sharded_solve(arrays, opt, device)
    one = sharded_solve(arrays, opt, device)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sharded_") as d:
        t0 = time.perf_counter()
        ctx = mp.start_processes(
            sharded_solve_rank,
            args=(SHARDED_RANKS, os.path.join(d, "store"), arrays, opt, d, device),
            nprocs=SHARDED_RANKS, join=False, start_method="spawn")
        join_ranks(ctx, RANKS_JOIN_S, "sharded solve")
        wall = time.perf_counter() - t0
        reps = [dict(np.load(os.path.join(d, f"sharded_rank{r}.npz")))
                for r in range(SHARDED_RANKS)]
    pose_err = float(np.abs(reps[0]["pose"] - one["pose"]).max())
    grid_err = float(np.abs(reps[0]["depth_grid"] / one["depth_grid"] - 1).max())
    same = all(r["digests"].tolist() == reps[0]["digests"].tolist() and all(r["digests"])
               and r["pose"].tobytes() == reps[0]["pose"].tobytes() for r in reps)
    step = reps[0]["stages"] != "normalize"
    reduced = all((r["all_reduces"][step] > 0).all() and not r["all_reduces"][~step].any()
                  for r in reps)
    for r, rep in enumerate(reps):
        print(f"sharded solve rank {r}: {float(rep['seconds']):.3f} s, "
              f"{int(rep['all_reduces'].sum())} all-reduces in {len(rep['digests'])} LM solves, "
              f"{float(rep['all_reduce_s']):.3f} s in them")
    print(f"sharded solve: {SHARDED_RANKS} ranks over gloo on {device} ({wall:.3f} s with their "
          f"start) against one process ({one['seconds']:.3f} s): poses max|err| {pose_err:.3e} "
          f"(tolerance {SHARDED_POSE_ATOL:g}), depth grid {grid_err:.3e} relative (tolerance "
          f"{SHARDED_GRID_RTOL:g}), SolverParams {'equal' if same else 'DIFFERENT'} on every "
          f"rank after each of {len(one['digests'])} LM solves")
    if not (same and reduced and pose_err <= SHARDED_POSE_ATOL
            and grid_err <= SHARDED_GRID_RTOL):
        raise AssertionError("the sharded solve disagrees with one process or across its ranks")


IO_FRAMES = 100  # the IO engine check's depth stream: the bench clip's length
IO_REPS = 3


def io_engine_check(base: str, n: int = IO_FRAMES, seed: int = 0) -> None:
    """One n-frame HxW depth stream (disparity .raw files) written and read
    through the IO engine (io/store.py::write_f32_frames, read_f32_frames,
    built first) and through io/raw.py's frame-by-frame loop: the files
    equal byte for byte and both reads equal the data. Prints the best of
    IO_REPS times of each (the files in the page cache)."""
    from robust_cvd_tpu_torch import native
    from robust_cvd_tpu_torch.io import raw
    from robust_cvd_tpu_torch.io.store import frame_name, read_f32_frames, write_f32_frames

    t0 = time.perf_counter()
    native._load_io()
    build_s = time.perf_counter() - t0
    disp = raw.depth_to_disparity(
        np.random.default_rng(seed).uniform(0.5, 10.0, (n, H, W)).astype(np.float32))
    paths = {}
    for way in ("engine", "loop"):
        os.makedirs(os.path.join(base, way))
        paths[way] = [os.path.join(base, way, frame_name(i, ".raw")) for i in range(n)]

    def loop_write(ps, frames):
        for p, x in zip(ps, frames):
            raw.save_raw_float32_image(p, x)

    def loop_read(ps):
        return np.stack([raw.load_raw_float32_image(p) for p in ps])

    def best(fn, *args):
        times, out = [], None
        for _ in range(IO_REPS):
            t = time.perf_counter()
            out = fn(*args)
            times.append(time.perf_counter() - t)
        return min(times), out

    we, _ = best(write_f32_frames, paths["engine"], disp)
    wl, _ = best(loop_write, paths["loop"], disp)
    re, got_e = best(read_f32_frames, paths["engine"])
    rl, got_l = best(loop_read, paths["loop"])
    same = all(open(a, "rb").read() == open(b, "rb").read()
               for a, b in zip(paths["engine"], paths["loop"]))
    mb = disp.nbytes / 1e6
    print(f"io engine: a {n}-frame {H}x{W} depth stream ({mb:.1f} MB), build {build_s:.3f} s; "
          f"write {we:.4f} s against the loop's {wl:.4f} s, read {re:.4f} s against "
          f"{rl:.4f} s (best of {IO_REPS}); files {'equal' if same else 'DIFFERENT'} byte "
          f"for byte")
    if not (same and np.array_equal(got_e, disp) and np.array_equal(got_l, disp)):
        raise AssertionError("the IO engine's files or reads differ from io/raw.py's")


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
        net.load_state_dict(midas.MidasV2Adapter.read_checkpoint(ckpt))
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


def validate_phase(tuner, device: str = "cuda") -> float:
    """FineTuner.validate(epoch, iters) on the fine-tune phase's tuner with
    the three save flags on; checks the eval/ files the JAX package writes
    and finite losses. Returns the seconds of one eval_pair_losses."""
    import contextlib
    import io

    import torch

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    ft = dataclasses.replace(tuner.cfg.ft, save_eval_images=True, save_depth_xform_maps=True,
                             save_scene_flow_vis=True)
    tuner.cfg = dataclasses.replace(tuner.cfg, ft=ft)
    n_pairs = int(tuner.clip.pair_idx.shape[0])
    n_frames = int(tuner.clip.images.shape[0])
    epoch = len(tuner.history)
    t0 = time.perf_counter()
    tuner.eval_pair_losses()
    sync()
    eval_s = time.perf_counter() - t0
    table = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(table):  # one line a pair
        losses = tuner.validate(epoch, epoch * n_pairs)
    sync()
    validate_s = time.perf_counter() - t0
    suf = f"_e{epoch:04d}_iter{epoch * n_pairs:06d}"
    eval_dir = os.path.join(tuner.out_dir, "eval")
    pairs = tuner.clip.pair_idx.cpu().numpy()
    want = {f"loss{suf}.json"}
    want |= {f"{k}_{i:06d}{suf}{x}" for k in ("depth", "scale") for i in range(n_frames)
             for x in (".raw", ".png")}
    want |= {f"scene_flow_{i:06d}_{j:06d}{suf}.png" for i, j in pairs}
    missing = sorted(want - set(os.listdir(eval_dir)))
    with open(os.path.join(eval_dir, f"loss{suf}.json")) as f:
        saved = json.load(f)
    vals = np.array([v for per in saved.values() for v in per.values()])
    print(f"validate: {n_pairs} pairs, eval_pair_losses {eval_s:.3f} s, validate {validate_s:.3f} s "
          f"({len(want)} files: the loss JSON, {2 * n_frames} depth, {2 * n_frames} scale and "
          f"{n_pairs} scene-flow files); {table.getvalue().strip().splitlines()[-1]}")
    print(f"stage validate_s {validate_s:.3f}")
    if missing or len(saved["loss"]) != n_pairs or not np.isfinite(vals).all():
        raise AssertionError(f"validate: missing {missing[:5]} ({len(missing)}), "
                             f"{len(saved['loss'])} pairs in the JSON, or non-finite losses")
    if set(saved) != set(losses) or list(saved["mean"]) != list(losses["mean"]):
        raise AssertionError("validate: the JSON and the returned losses disagree")
    return eval_s


def colmap_clip(base: str, n: int, cfg) -> None:
    """The pose clip's known geometry as a COLMAP reconstruction: frame i is
    a camera (default focal) at x = i * SHIFT * Z / fx over a
    fronto-parallel plane at depth Z = 1, so the plane moves SHIFT px a
    frame as the clip does. recon=colmap takes metadata.npz's extrinsics as
    the port's camera-to-world [R|t] (as the JAX package does), so the
    model's images carry R = I and t = the camera centre; the plane's
    disparity (1) is depth_colmap_dense/."""
    import torch

    from robust_cvd_tpu_torch.io import colmap, raw
    from robust_cvd_tpu_torch.io.store import frame_name
    from robust_cvd_tpu_torch.ops import geometry

    v_focal = cfg.opt.focal_long / (W / H)
    intr = geometry.intrinsics_px(torch.tensor(2 * math.atan(v_focal)),
                                  torch.tensor(2 * math.atan(v_focal * W / H)), (H, W))
    fx, fy, cx, cy = (float(v) for v in intr)
    model = os.path.join(base, "colmap_dense", "sparse")
    os.makedirs(model)
    cams = {1: colmap.ColmapCamera(1, "PINHOLE", W, H, np.array([fx, fy, cx, cy]))}
    images = {
        i + 1: colmap.ColmapImage(i + 1, np.array([1.0, 0.0, 0.0, 0.0]),
                                  np.array([i * SHIFT / fx, 0.0, 0.0]), 1,
                                  frame_name(i, ".png"), np.zeros((0, 2)), np.zeros(0, np.int64))
        for i in range(n)
    }
    colmap.write_cameras_binary(cams, os.path.join(model, "cameras.bin"))
    colmap.write_images_binary(images, os.path.join(model, "images.bin"))
    colmap.write_points3d_binary({}, os.path.join(model, "points3D.bin"))
    colmap.model_to_npz(model, os.path.join(base, "colmap_dense", "metadata.npz"))
    os.makedirs(os.path.join(base, "depth_colmap_dense", "depth"))
    for i in range(n):
        raw.save_raw_float32_image(
            os.path.join(base, "depth_colmap_dense", "depth", frame_name(i, ".raw")),
            np.ones((H, W), np.float32))


def colmap_phase(base: str, net, seed: int, device: str = "cuda") -> int:
    """DatasetProcessor.fine_tune with recon=colmap for 1 epoch on the pose
    clip given colmap_clip's reconstruction, from the seeded weights.
    Checks: no solve, the poses are metadata.npz's, the depth moved, one
    Adam launch a train step. Returns the Adam launches."""
    import torch

    from robust_cvd_tpu_torch.config import FineTuneParams, PipelineConfig
    from robust_cvd_tpu_torch.io import raw
    from robust_cvd_tpu_torch.io.store import VideoStore
    from robust_cvd_tpu_torch.models import midas
    from robust_cvd_tpu_torch.ops import adam
    from robust_cvd_tpu_torch.pipeline.process import DatasetProcessor

    cfg = PipelineConfig(path=base, recon="colmap",
                         ft=FineTuneParams(num_epochs=1, save_tensorboard=False))
    store = VideoStore.open(base)
    colmap_clip(base, store.num_frames, cfg)
    depth = store.load_depth_stream("depth_midas2")
    midas.seeded_init_(net, seed)
    adam.adam_update.launches = 0
    t0 = time.perf_counter()
    tuner = DatasetProcessor(cfg, models={"depth": midas.MidasV2Adapter(net)},
                             device=device).fine_tune(store, depth)
    if device == "cuda":
        torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = adam.adam_update.launches
    steps = sum(h["steps"] for h in tuner.history)
    print(f"stage colmap_fine_tune_s {total:.3f} " + " ".join(
        f"{k} {v:.3f}" for k, v in tuner.stats.items()))
    for h in tuner.history:
        print("colmap epoch " + json.dumps(h))
    meta = np.load(os.path.join(base, "colmap_dense", "metadata.npz"))
    ps = tuner.pose_state
    same_poses = (np.array_equal(ps.extrinsics.cpu().numpy(), meta["extrinsics"].astype(np.float32))
                  and np.array_equal(ps.intrinsics.cpu().numpy(),
                                     meta["intrinsics"].astype(np.float32)))
    stream = tuner.pose.streams[-1]
    disp = np.stack([raw.load_raw_float32_image(os.path.join(stream.dir, "depth",
                                                             f"frame_{i:06d}.raw"))
                     for i in range(store.num_frames)])
    moved = float(np.abs(disp - raw.depth_to_disparity(depth)).max())
    want = steps if device == "cuda" else 0
    print(f"colmap: {len(tuner.solve_log)} solves, poses equal metadata.npz's: {same_poses}, "
          f"streams {[s.name for s in tuner.pose.streams]}, fine-tuned disparity moved by up "
          f"to {moved:.4f}, adam launches {launches} for {steps} train steps")
    if tuner.solver_params is not None or tuner.solve_log:
        raise AssertionError("recon=colmap ran a pose solve")
    if not same_poses:
        raise AssertionError("recon=colmap's poses are not the imported ones")
    if not (np.isfinite(disp).all() and moved > 0 and all(np.isfinite(h["loss"])
                                                           for h in tuner.history)):
        raise AssertionError("recon=colmap: non-finite output or the depth did not move")
    if launches != want or int(tuner.optimizer.count) != steps or steps == 0:
        raise AssertionError(f"recon=colmap: adam launches {launches} for {steps} steps")
    return launches


def optimizer_epochs_phase(tuner, device: str = "cuda") -> dict:
    """One fine-tune epoch (FineTuner.run) with optax.radam and one with a
    bf16 Adam first moment, on the fine-tune phase's clip, net and solved
    poses. The poses are held fixed (recon=colmap with the phase's pose
    state), so no solve runs and the epoch is all train steps. Checks one
    launch of the kernel's mode a step, no skipped step, finite losses and
    moved parameters. Returns the launches by kernels-line name."""
    import torch

    from robust_cvd_tpu_torch.ops import adam
    from robust_cvd_tpu_torch.training.fine_tune import FineTuner

    launches = {}
    for label, options, mode in OPTIMIZERS[1:]:
        cfg = dataclasses.replace(tuner.cfg, recon="colmap", ft=dataclasses.replace(
            tuner.cfg.ft, num_epochs=1, val_epoch_freq=-1, save_checkpoints=False,
            save_tensorboard=False, **options))
        run = FineTuner(cfg, tuner.adapter, tuner.clip, tuner.pose_inputs,
                        pose_state_override=tuner.pose_state, device=device)
        adam.adam_update.launches_by_mode[mode] = 0
        t0 = time.perf_counter()
        run.run(1)
        if device == "cuda":
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        count = adam.adam_update.launches_by_mode[mode]
        h = run.history[0]
        moved = (run.optimizer.flat - run.optimizer.init).abs().max().item()
        print(f"optimizer {label}: 1 epoch, {h['steps']} steps, {h['skipped']} skipped, loss "
              f"{h['loss']:.6f}, {count} Adam launches in mode {mode}, mu {run.optimizer.mu.dtype}, "
              f"parameters moved by up to {moved:.3e}, {dt:.3f} s")
        want = h["steps"] if device == "cuda" else 0
        if count != want or h["skipped"] or not np.isfinite(h["loss"]) or not moved > 0:
            raise AssertionError(f"the {label} epoch: {count} launches for {h['steps']} steps, "
                                 f"{h['skipped']} skipped, loss {h['loss']}")
        launches["adam_" + label] = count
        del run
    return launches


# The processor phase's filter ops: (output stream, ProcessorParams fields)
PROCESSOR_FILTERS = (
    ("proc_bilateral", dict(op="BILATERAL_FILTER", spatial_radius=1, frame_radius=1,
                            color_sigma=0.2)),
    ("proc_fgf_mean", dict(op="FLOW_GUIDED_FILTER", frame_radius=2)),
    ("proc_fgf_median", dict(op="FLOW_GUIDED_FILTER", frame_radius=2, median=True)),
    ("proc_fgf_far", dict(op="FLOW_GUIDED_FILTER", frame_radius=2, far_connections=True)),
)
PROCESSOR_CPU_FRAMES = 16  # the first frames of the clip, filtered on both devices
PROCESSOR_SOLVER_FRAMES = 8  # the solver ops' clip, at full width
# The solver ops' schedule, cut from the default 4 coarse-to-fine steps of up
# to 50 LM steps: their solves are host-bound (about 45 ms a CG iteration on
# the 8-frame clip), and the default schedule took 133 s there on the H100.
PROCESSOR_SOLVER_OPTIONS = dict(num_steps=2, lm_max_outer=6)
FILTER_TOL = 1e-5  # card vs CPU filters, relative to the largest depth
# A weighted median is discontinuous where a pixel's cumulative weight ties
# with half its total: the card's and the CPU's last-bit differences in the
# weights (exp, the summation order) can then pick neighbouring samples, up
# to 1e-3 of the depth apart. The card's median is held to the CPU's samples
# as any weighted median under weights moved by up to MEDIAN_TIE of their
# total; everywhere else that bracket is the CPU's own sample.
MEDIAN_TIE = 1e-5


def median_bracket(zs, wgt, tie: float = MEDIAN_TIE):
    """(lo, hi, ties): per pixel, the least and greatest weighted median over
    dim 0 of samples `zs` under weights `wgt` moved by up to `tie` of their
    total (the first sorted sample whose cumulative weight reaches the half
    total, as filters._weighted_median, minus and plus `tie` of the total),
    and the number of pixels where the two differ."""
    import torch

    order = torch.argsort(zs, dim=0, stable=True)
    z = torch.gather(zs, 0, order)
    cum = torch.cumsum(torch.gather(wgt, 0, order).double(), dim=0)
    total = cum[-1]

    def first(level):
        pick = torch.argmax((cum >= level[None]).to(torch.uint8), dim=0)
        return torch.gather(z, 0, pick[None])[0]

    lo, hi = first(total * (0.5 - tie)), first(total * (0.5 + tie))
    return lo, hi, int((lo != hi).sum())


def filters_card_vs_cpu(store, src: str, m: int, params, device: str = "cuda") -> None:
    """PROCESSOR_FILTERS on the first m frames of `store`'s stream `src`, on
    `device` and on the CPU: within FILTER_TOL of the largest depth, the
    median within FILTER_TOL of the CPU samples' median bracket (MEDIAN_TIE
    says why). `params(**kw)` makes the ProcessorParams."""
    from robust_cvd_tpu_torch.ops import filters
    from robust_cvd_tpu_torch.pipeline.processor import Processor

    outs = {}
    for dev in (device, "cpu"):
        view = first_frames(store, m)
        vproc = Processor(view, device=dev)  # the CPU's is kept for its median samples
        for stream, kw in PROCESSOR_FILTERS:
            name = f"cmp_{dev}_{stream}"
            vproc.process(params(source_depth_stream=src, depth_stream=name, **kw))
            outs[dev, stream] = view.load_depth_stream(name)
    worst = 0.0
    for stream, kw in PROCESSOR_FILTERS:
        a, b = outs[device, stream], outs["cpu", stream]
        scale = np.abs(b).max()
        err = float(np.abs(a - b).max() / scale)
        note = ""
        if kw.get("median"):  # held to the CPU's samples' median bracket
            args, fkw = vproc.flow_guided_filter_inputs(view.load_depth_stream(src),
                                                        params(**kw))
            fkw.pop("median")
            lo, hi, ties = median_bracket(*filters.flow_guided_samples(*args, **fkw))
            lo, hi = lo.numpy(), hi.numpy()
            if not (np.all(lo <= b) and np.all(b <= hi)):
                raise AssertionError(f"{stream}: the CPU's median lies outside its own bracket")
            off = np.maximum(lo - a, a - hi).clip(min=0)
            note = (f" from the median bracket; against the CPU's pick {err:.3e}, "
                    f"{int((np.abs(a - b) > FILTER_TOL * scale).sum())} pixels off it, "
                    f"{ties} pixels whose median moves with {MEDIAN_TIE:g} of the weight")
            err = float(off.max() / scale)
        worst = max(worst, err)
        print(f"processor {stream}, card vs CPU on {m} frames: relative max|err| {err:.3e} "
              f"(tolerance {FILTER_TOL:g}){note}")
    if not worst <= FILTER_TOL:
        raise AssertionError("a filter op on the card disagrees with the CPU")


def processor_phase(base: str, solver_params, seed: int, device: str = "cuda",
                    solver_options=PROCESSOR_SOLVER_OPTIONS) -> int:
    """All 13 ops of pipeline/processor.py through Processor.process on the
    pose phase's store (exact constant-shift flows, so tracked locations
    stay on integers), with the fine-tune phase's cameras (`solver_params`;
    None: the default cameras):
    - copy, clip and the filters (bilateral with colour, flow-guided in
      mean, median and far-connections modes) on the whole clip: finite
      output that moved; then each filter on the clip's first
      PROCESSOR_CPU_FRAMES frames on the card and on the CPU, within
      FILTER_TOL of the largest depth (the median within FILTER_TOL of the
      CPU samples' median bracket: MEDIAN_TIE says why);
    - compute_tracks: one corner-kernel launch, and every kept track moves
      SHIFT px a frame (within 0.5 px);
    - the constraint and solver ops on a PROCESSOR_SOLVER_FRAMES-frame clip
      at full width (make_clip's, with the pose clip's initial depth):
      compute_constraints, normalize_depth, optimize_poses,
      grid_xform_split, the resets and reset_normalize_optimize; every LM
      solve ends below its start (PoseOptParams with `solver_options`:
      PROCESSOR_SOLVER_OPTIONS says why the schedule is cut).
    Returns the corner kernel's launches (compute_tracks and the solver
    clip's constraints)."""
    import torch

    from robust_cvd_tpu_torch.camera import pose_params_to_camera
    from robust_cvd_tpu_torch.config import PoseOptParams
    from robust_cvd_tpu_torch.io.store import VideoStore
    from robust_cvd_tpu_torch.ops import corner
    from robust_cvd_tpu_torch.pipeline.processor import Op, Processor, ProcessorParams

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    solver_opt = PoseOptParams(**solver_options)

    def params(**kw):
        kw["op"] = Op[kw["op"]]
        return ProcessorParams(pose_optimizer=solver_opt, **kw)

    src = "depth_midas2"
    store = VideoStore.open(base)
    n = store.num_frames
    if solver_params is not None:  # else the Processor's default cameras
        store.camera = pose_params_to_camera(solver_params.pose, solver_params.focal,
                                             store.aspect)
    proc = Processor(store, device=device)
    depth = store.load_depth_stream(src)
    launches = 0

    def run(label, p, on=None):
        t0 = time.perf_counter()
        out = (on or proc).process(p)
        sync()
        print(f"processor {label}: {time.perf_counter() - t0:.3f} s")
        return out

    run("copy", params(op="COPY", source_depth_stream=src, depth_stream="proc_copy"))
    if not np.array_equal(VideoStore.open(base).load_depth_stream("proc_copy"), depth):
        raise AssertionError("the copy op changed the depth")
    cap = float(np.median(depth))
    run("clip_max_depth", params(op="CLIP_MAX_DEPTH", source_depth_stream=src,
                                 depth_stream="proc_clip", max_depth=cap))
    clipped = store.load_depth_stream("proc_clip")
    if not (clipped.max() <= cap and np.array_equal(clipped, np.minimum(depth, cap))):
        raise AssertionError("the clip op is not min(depth, max_depth)")
    for stream, kw in PROCESSOR_FILTERS:
        run(stream, params(source_depth_stream=src, depth_stream=stream, **kw))
        out = store.load_depth_stream(stream)
        moved = float(np.abs(out - depth).max())
        print(f"processor {stream}: {out.shape}, depth {out.min():.4f}..{out.max():.4f}, moved "
              f"by up to {moved:.4f}")
        if out.shape != depth.shape or not np.isfinite(out).all() or not moved > 0:
            raise AssertionError(f"the {stream} filter gave non-finite or unchanged depth")

    # the same filters on the first frames, card and CPU
    filters_card_vs_cpu(store, src, min(PROCESSOR_CPU_FRAMES, n), params, device)

    corner.corner_min_eigenval.launches = 0
    tracks = run("compute_tracks", params(op="COMPUTE_TRACKS"))
    launches += corner.corner_min_eigenval.launches
    want = 1 if device == "cuda" else 0
    h, w = depth.shape[1:]
    steps = [(x1 - x0) * w for t in tracks.tracks.values()
             for (x0, _), (x1, _) in zip(t.locs, t.locs[1:])]
    dys = [(y1 - y0) / store.inv_aspect * h for t in tracks.tracks.values()
           for (_, y0), (_, y1) in zip(t.locs, t.locs[1:])]
    worst_dx = max((abs(d + SHIFT) for d in steps), default=float("inf"))
    worst_dy = max((abs(d) for d in dys), default=float("inf"))
    lengths = [t.length for t in tracks.tracks.values()]
    print(f"processor compute_tracks: {len(lengths)} tracks, lengths {min(lengths, default=0)}"
          f"..{max(lengths, default=0)} (mean {np.mean(lengths) if lengths else 0:.1f}), "
          f"{len(steps)} steps, worst |dx + {SHIFT}| {worst_dx:.4f} px, worst |dy| "
          f"{worst_dy:.4f} px (tolerance 0.5), corner launches {launches}")
    if launches != want or not lengths or worst_dx > 0.5 or worst_dy > 0.5:
        raise AssertionError("compute_tracks: wrong corner launches or a track off the pan")

    # the constraint and solver ops on a few frames at full width
    sbase = os.path.join(base, "solver_ops")
    k = min(PROCESSOR_SOLVER_FRAMES, n)
    make_clip(sbase, k, seed)
    small = VideoStore.open(sbase)
    small.save_depth_stream(src, depth[:k])
    sproc = Processor(small, device=device)
    corner.corner_min_eigenval.launches = 0
    pose = run("compute_constraints", params(op="COMPUTE_CONSTRAINTS", source_depth_stream=src),
               sproc)
    launches += corner.corner_min_eigenval.launches
    n_pair = sum(len(pose.pairs[key].loc0) for key in pose.pair_keys)
    print(f"processor compute_constraints: {len(pose.pair_keys)} pairs, {n_pair} constraints "
          f"on the {k}-frame clip")
    if n_pair == 0:
        raise AssertionError("compute_constraints built no constraints")
    sp = None
    for op in ("NORMALIZE_DEPTH", "OPTIMIZE_POSES"):
        sp = run(op.lower(), params(op=op, source_depth_stream=src), sproc)
    gz, gy, gx = sp.depth_grid.shape[1:]
    sp = run("grid_xform_split", params(op="GRID_XFORM_SPLIT", grid_size=(2 * gx, 2 * gy)),
             sproc)
    if sp.depth_grid.shape[1:] != (gz, 2 * gy, 2 * gx):
        raise AssertionError(f"grid_xform_split gave {tuple(sp.depth_grid.shape)}")
    sp = run("reset_depth_xforms", params(op="RESET_DEPTH_XFORMS"), sproc)
    if sp.depth_grid.shape[1:] != (1, 1, 1) or not bool((sp.depth_grid == 1).all()):
        raise AssertionError("reset_depth_xforms did not reset the depth transforms")
    sp = run("reset_spatial_xforms", params(op="RESET_SPATIAL_XFORMS"), sproc)
    if sp.spatial_grid.shape[1:3] != (1, 1) or bool(sp.spatial_grid.abs().max() > 0):
        raise AssertionError("reset_spatial_xforms did not reset the spatial transforms")
    run("reset_poses", params(op="RESET_POSES"), sproc)
    if bool(small.camera.position.abs().max() > 0):
        raise AssertionError("reset_poses left a camera off the origin")
    sp = run("reset_normalize_optimize", params(op="RESET_NORMALIZE_OPTIMIZE",
                                                source_depth_stream=src), sproc)
    for e in sproc.solve_log:
        print("processor solve " + json.dumps(e))
    finite = all(bool(torch.isfinite(t).all()) for t in sp if t is not None)
    if not (sproc.solve_log and finite
            and all(e["cost"] < e["cost0"] for e in sproc.solve_log)):
        raise AssertionError("a solver op did not lower its cost, or non-finite parameters")
    print(f"processor solver ops: {len(sproc.solve_log)} LM solves, each below its start")
    return launches


QUALITY_GATES = ("static_quality_gate", "dynamic_solver_gate", "contaminated_constraint_gate")


def quality_phase(device: str = "cuda") -> dict:
    """The three golden-scene gate functions of quality.py at full size on
    `device`, in turn. Each gap-closed value is held to the JAX package's
    (JAX_GATES) less
    GATE_SLACK, and the contamination gate without exclusion
    EXCLUSION_MARGIN below its value with it. Returns every number of the
    gates."""
    import torch

    from robust_cvd_tpu_torch import quality

    t_all = time.perf_counter()
    res = {}
    for name in QUALITY_GATES:
        t0 = time.perf_counter()
        out = getattr(quality, name)(tiny=False, device=device)
        if device == "cuda":
            torch.cuda.synchronize()
        print(f"quality gate {name}: {time.perf_counter() - t0:.3f} s {json.dumps(out)}")
        res.update(out)
    bad = [k for k, v in res.items() if not math.isfinite(v)]
    on = res["quality_gap_closed_contaminated"]
    off = res["quality_gap_closed_contaminated_no_exclusion"]
    for key, ref in JAX_GATES.items():
        if key == "quality_gap_closed_contaminated_no_exclusion":
            ok = off <= on - EXCLUSION_MARGIN
            rule = f"at most {on - EXCLUSION_MARGIN:.4f}, the value with exclusion less " \
                   f"{EXCLUSION_MARGIN}"
        else:
            ok = res[key] >= ref - GATE_SLACK
            rule = f"at least {ref - GATE_SLACK:.4f}"
        print(f"quality {key} {res[key]:.4f} (JAX package on the CPU {ref:.4f}; {rule}) "
              f"{'ok' if ok else 'FAILED'}")
        if not ok:
            bad.append(key)
    print(f"stage quality_s {time.perf_counter() - t_all:.3f}")
    if bad:
        raise AssertionError(f"quality gates failed: {bad}")
    return res


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
            and not e.name.startswith(("flow.", "raft.", "mask_rcnn."))]


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
                  "fine_tune/refresh_s", "fine_tune/persist_io_s", "fine_tune/post_filter_s")
POST_FILTER_CPU_FRAMES = 8  # the filtered frames checked against the CPU
POST_FILTER_TOL = 1e-4  # their disparity, card vs CPU, relative


# The pipeline phase's epochs, cut from the default 10: the script, host-bound
# for most of its time, took 693-1003 s on one H100 with 10, near the
# 1200 s limit; each epoch more costs 12-17 s (a train epoch and a warm
# re-solve).
PIPELINE_EPOCHS = 3


def pipeline_phase(base: str, n_frames: int, seed: int, epochs: int, device: str = "cuda",
                   argv=()):
    """The whole pipeline through the CLI, `main(["--path", clip,
    "--post_filter", "true"])` with every other default but --num_epochs
    (and `argv`, which cuts the solver for a CPU run), on a clip of
    color_full PNGs, with the checkpoints of pipeline_checkpoints. Checks
    the result tree, the flows against the true shift, the kernels'
    launches on this path, the solves and the post filter's stream (see
    post_filter_check). pipeline_s_per_frame leaves the post filter out, as
    the runs before it had none. Returns the corner and Adam kernels'
    launches and the DatasetProcessor."""
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
    proc = cli_main(["--path", base, "--num_epochs", str(epochs), "--post_filter", "true",
                     *argv], device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = {"corner": corner.corner_min_eigenval.launches, "adam": adam.adam_update.launches}
    for name, sec in proc.tracer.summary().items():
        print(f"pipeline stage {name} {sec:.3f}")
    post = proc.tuner.stats["post_filter_s"]
    print(f"pipeline_s {total:.3f}")
    print(f"post_filter_s {post:.3f}")
    print(f"pipeline_s_per_frame {(total - post) / n_frames:.4f}")
    print(f"pipeline_s_per_frame_with_post_filter {total / n_frames:.4f}")

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
    if streams[:1] != ["depth_midas2"] or streams[-2:] != ["fine_tuned", "fine_tuned_filtered"]:
        raise AssertionError(f"video.dat streams {streams}")
    post_filter_check(tuner, n_frames)
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


def first_frames(store, m: int):
    """A store over the first m frames of `store`'s folder, with the first m
    of its cameras on the host (its reads of frames past m never happen)."""
    from robust_cvd_tpu_torch.camera import CameraState
    from robust_cvd_tpu_torch.io.store import VideoStore

    view = VideoStore(store.base_dir, dataclasses.replace(store.meta, pts=store.meta.pts[:m]))
    if store.camera is not None:
        view.camera = CameraState(*[t[:m].cpu() for t in store.camera])
    return view


def post_filter_check(tuner, n_frames: int) -> None:
    """The post filter's stream: n_frames finite, positive disparity frames;
    the first POST_FILTER_CPU_FRAMES of them equal the same filter on the
    CPU (the fine-tuned stream's depth and the cameras of the first
    POST_FILTER_CPU_FRAMES + filter_radius frames, all a chain from those
    frames reaches) within POST_FILTER_TOL relative."""
    from robust_cvd_tpu_torch.pipeline.processor import Op, Processor, ProcessorParams

    pose = tuner.pose
    src, dst = pose.streams[-2], pose.streams[-1]
    filtered = pose._load_stream_depth(dst)
    if filtered.shape[0] != n_frames or not (np.isfinite(filtered).all() and (filtered > 0).all()):
        raise AssertionError(f"post filter: {filtered.shape[0]} frames, or non-finite or "
                             f"non-positive depth")
    radius = tuner.cfg.filter_radius
    k = min(POST_FILTER_CPU_FRAMES, n_frames)
    m = min(k + radius, n_frames)
    cpu = Processor(first_frames(pose.store, m), device="cpu").flow_guided_filter_array(
        pose._load_stream_depth(src)[:m],
        ProcessorParams(op=Op.FLOW_GUIDED_FILTER, frame_radius=radius),
    ).numpy()[:k]
    a, b = 1.0 / filtered[:k], 1.0 / cpu
    err = float(np.abs(a - b).max() / np.abs(b).max())
    moved = float(np.abs(filtered - pose._load_stream_depth(src)).max())
    print(f"post filter: stream {dst.name}, {n_frames} finite positive frames, depth moved by up "
          f"to {moved:.4f}; the first {k} frames vs the CPU's filter of the first {m}: relative "
          f"max|err| {err:.3e} in disparity (tolerance {POST_FILTER_TOL:g})")
    if not err <= POST_FILTER_TOL:
        raise AssertionError("the post filter on the card disagrees with the CPU")


def post_filter_profile(proc) -> dict:
    """The pipeline's post filter again, at full width, on its inputs:
    seconds of the whole call (host included), the device time of
    filters.flow_guided_filter between one event pair, the peak device
    memory above what was allocated before, and its bytes bounds: each
    input read once and the output written once (depth, world points,
    both flow stacks, both mask stacks, output: 38 B a pixel), and the
    reads of every chain step (a flow, a mask and a world point, 21 B a
    pixel and step, 2 * radius steps, plus the pixel's own world point,
    depth and output)."""
    import torch

    from robust_cvd_tpu_torch.ops import filters
    from robust_cvd_tpu_torch.pipeline.processor import Op, Processor, ProcessorParams

    tuner = proc.tuner
    pose = tuner.pose
    radius = tuner.cfg.filter_radius
    depth = pose._load_stream_depth(pose.streams[-2])
    fp = Processor(pose.store, device="cuda")
    p = ProcessorParams(op=Op.FLOW_GUIDED_FILTER, frame_radius=radius)
    fp.flow_guided_filter_array(depth, p)  # warm-up
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    args, kwargs = fp.flow_guided_filter_inputs(depth, p)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    filters.flow_guided_filter(*args, **kwargs)
    end.record()
    end.synchronize()
    call_s = time.perf_counter() - t0
    device_ms = start.elapsed_time(end)
    peak = torch.cuda.max_memory_allocated() - before
    pixels = float(depth.size)
    once_ms = 38 * pixels / PEAK_BYTES_PER_S * 1e3
    steps_ms = (42 * radius + 20) * pixels / PEAK_BYTES_PER_S * 1e3
    result = {"pipeline_post_filter_s": tuner.stats["post_filter_s"], "call_s": call_s,
              "device_ms": device_ms, "peak_bytes": peak, "bound_once_ms": once_ms,
              "bound_steps_ms": steps_ms, "shape": list(depth.shape), "radius": radius}
    print(f"post filter profile {tuple(depth.shape)}, radius {radius}: in the pipeline "
          f"{result['pipeline_post_filter_s']:.3f} s (stream copy, loads, filter, writes); one "
          f"flow_guided_filter_array call {call_s:.3f} s; filters.flow_guided_filter "
          f"{device_ms:.3f} ms on the card; peak device memory {peak / 2**30:.3f} GiB above "
          f"the {before / 2**30:.3f} GiB held before; bytes bound {once_ms:.4f} ms (each input "
          f"once), {steps_ms:.4f} ms (every chain step's reads)")
    return result


# The mask_rcnn phase: Mask R-CNN dynamic masks on the pipeline clip.
RCNN_KEEP = 20  # proposals of the first frame the shaped heads score person above 0.5
RCNN_MAX_DYNAMIC = 50  # a frame's dynamic detections, at most
RCNN_MAX_SHARE = 0.9  # a frame's dynamic share, below this (and above 0)
RCNN_CPU_TEST_SIZE = 320  # the card-vs-CPU frame's shortest edge
RCNN_TOL = 1e-4  # P2-P6, RPN logits and deltas, card vs CPU: of their largest magnitude
RCNN_MARGIN = 1e-3  # detections compared card vs CPU: score this far above the threshold
RCNN_MASK_SHARE = 0.005  # dynamic-mask pixels that may differ card vs CPU
ROI_ALIGN_TOL = 1e-5  # roi_align_fpn card vs CPU, of the largest magnitude
PASTE_SHARE = 1e-4  # paste_masks pixels that may differ card vs CPU (values at 0.5)
RCNN_RANGES = ("mask_rcnn.backbone", "mask_rcnn.rpn", "mask_rcnn.roi_align",
               "mask_rcnn.heads", "mask_rcnn.detect", "mask_rcnn.paste")


def mask_rcnn_state(frame, seed: int, device: str = "cuda", keep: int = RCNN_KEEP,
                    test_size: int = 800) -> dict:
    """A seeded detectron2-layout Mask R-CNN state dict (float32, on the host)
    whose heads are shaped on `frame` (H, W, 3) so that detections come out:
    cls_score's rows and biases of every class but person zeroed (their
    logits 0, so person scores above 0.5 where its logit exceeds ln 80), the
    person row scaled to a logit spread of 2 over the frame's proposals and
    its bias set midway between the keep-th and the next of them; the mask
    predictor's class 0 biased by +1."""
    import torch

    from robust_cvd_tpu_torch.device import float32_precision
    from robust_cvd_tpu_torch.models import mask_rcnn as M
    from robust_cvd_tpu_torch.pipeline.masks import rcnn_input

    net = M.seeded_init_(M.MaskRCNN(dtype=torch.float32), seed).to(device).eval()
    with torch.inference_mode(), float32_precision(False):
        x, _ = rcnn_input(torch.from_numpy(frame[None]).to(device), test_size)
        feats = net.features(x)
        logits = net.box_outputs(feats, net.proposals(feats, tuple(x.shape[-2:])))[0]
    u = torch.sort(logits[0, :, 0].double().cpu(), descending=True).values
    scale = 2.0 / float(u.std())
    cls = net.roi_heads.box_predictor.cls_score
    with torch.no_grad():
        person = cls.weight[0] * scale
        cls.weight.zero_()
        cls.bias.zero_()
        cls.weight[0] = person
        cls.bias[0] = math.log(80.0) - scale * float(u[keep - 1] + u[keep]) / 2
        net.roi_heads.mask_head.predictor.bias[0] = 1.0
    return {k: v.detach().cpu() for k, v in net.state_dict().items()}


def mask_rcnn_checkpoint(base: str, seed: int, device: str = "cuda", keep: int = RCNN_KEEP,
                         test_size: int = 800) -> str:
    """mask_rcnn_state on the clip's first color_full frame, pickled in the
    model zoo's layout as <clip>/models/mask_rcnn_R_50_FPN_3x.pkl."""
    import pickle

    from robust_cvd_tpu_torch.io.store import VideoStore

    frame = VideoStore.open(base).load_color_full()[0]
    sd = mask_rcnn_state(frame, seed, device, keep, test_size)
    os.makedirs(os.path.join(base, "models"), exist_ok=True)
    path = os.path.join(base, "models", "mask_rcnn_R_50_FPN_3x.pkl")
    with open(path, "wb") as f:
        pickle.dump({"model": {k: v.numpy() for k, v in sd.items()}, "__author__": "seeded"}, f)
    return path


def mask_rcnn_clip(base: str, n: int, seed: int) -> None:
    """pipeline_clip's color_full PNGs with frames.txt and color_down as the
    pipeline makes them (the mask_rcnn phase's inputs without the rest of
    the pipeline)."""
    from robust_cvd_tpu_torch.pipeline.video import VideoStage

    pipeline_clip(base, n, seed)
    video = VideoStage(base)
    video.extract_frames()
    video.downscale_frames("color_down", DOWN_SIZE[0], ".raw", DOWN_SIZE[1])


def _rcnn_net(pkl: str, dtype, device: str):
    from robust_cvd_tpu_torch.models import mask_rcnn as M

    net = M.MaskRCNN(dtype=dtype).eval()
    return M.load_weights_(net, M.load_checkpoint(pkl)).to(device)


def _dynamic_detections(det) -> np.ndarray:
    from robust_cvd_tpu_torch.models.mask_rcnn import DYNAMIC_OBJECT_CATEGORIES

    cls = det["classes"].cpu().numpy()
    return ((det["scores"].cpu().numpy() > 0.5)
            & np.isin(cls, DYNAMIC_OBJECT_CATEGORIES)).sum(-1)


def mask_rcnn_phase(base: str, seed: int, device: str = "cuda", keep: int = RCNN_KEEP,
                    test_size: int = 800, cpu_test_size: int = RCNN_CPU_TEST_SIZE):
    """Mask R-CNN dynamic masks on a clip with color_full and color_down
    (the pipeline clip): a seeded checkpoint with shaped heads
    (mask_rcnn_checkpoint), then compute_dynamic_masks_rcnn(store, pkl) in
    bf16 on `device` over every frame (the motion-segmentation masks are
    moved to dynamic_mask_motion/). Checks one PNG a frame, values 0 and
    255 only, each frame's dynamic share in (0, RCNN_MAX_SHARE), and 1 to
    RCNN_MAX_DYNAMIC dynamic detections in each frame; then mask_rcnn_checks.
    Prints the stage's stats, seconds a frame in steady state and the host
    syncs a frame. Returns the checkpoint's path and the bf16 net."""
    import torch

    from robust_cvd_tpu_torch.io.store import VideoStore, frame_name, load_png_gray
    from robust_cvd_tpu_torch.models import mask_rcnn as M
    from robust_cvd_tpu_torch.pipeline import masks

    t0 = time.perf_counter()
    pkl = mask_rcnn_checkpoint(base, seed, device, keep, test_size)
    print(f"stage mask_rcnn_checkpoint_s {time.perf_counter() - t0:.3f}")
    motion = os.path.join(base, "dynamic_mask")
    if os.path.isdir(motion):
        os.rename(motion, motion + "_motion")
    store = VideoStore.open(base)
    n = store.num_frames
    stats = {}
    M.nms_keep.syncs = 0
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    masks.compute_dynamic_masks_rcnn(store, pkl, stats=stats, device=device,
                                     test_size=test_size)
    total = time.perf_counter() - t0
    if device == "cuda":
        print(f"mask_rcnn peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    syncs = M.nms_keep.syncs
    passes = -(-n // masks.RCNN_FRAMES_PER_PASS)
    for k in sorted(stats):
        print(f"mask_rcnn stats {k} {stats[k]:.4f}")
    steady = max(n - masks.RCNN_FRAMES_PER_PASS, 1)
    (th, tw), (ph, pw) = masks.rcnn_test_size(store.load_color_full().shape[1:3], test_size)
    print(f"mask_rcnn_s {total:.3f} for {n} frames at {th}x{tw} padded to {ph}x{pw}: "
          f"steady {stats.get('steady_infer_s', 0.0) / steady:.4f} s a frame "
          f"({masks.RCNN_FRAMES_PER_PASS} a pass), first pass {stats['first_dispatch_s']:.3f} s")
    print(f"mask_rcnn host syncs: {syncs} NMS convergence reads and {2 * passes} copies "
          f"(frames in, masks out) for {n} frames, {(syncs + 2 * passes) / n:.2f} a frame")

    names = [frame_name(i, ".png") for i in range(n)]
    pngs = np.stack([load_png_gray(os.path.join(base, "dynamic_mask", f)) for f in names])
    if not set(np.unique(pngs)) <= {0, 255}:
        raise AssertionError(f"dynamic masks hold values {np.unique(pngs)}, not 0 and 255")
    share = (pngs == 0).reshape(n, -1).mean(1)
    print(f"mask_rcnn dynamic share: min {share.min():.4f}, mean {share.mean():.4f}, "
          f"max {share.max():.4f} over {n} frames")
    if not (share > 0).all() or not (share < RCNN_MAX_SHARE).all():
        raise AssertionError(f"a frame's dynamic share is 0 or {RCNN_MAX_SHARE} or more")

    net = _rcnn_net(pkl, torch.bfloat16 if device == "cuda" else torch.float32, device)
    frames = store.load_color_full()
    counts = []
    with torch.inference_mode():
        for s in range(0, n, masks.RCNN_FRAMES_PER_PASS):
            x, _ = masks.rcnn_input(torch.from_numpy(
                frames[s : s + masks.RCNN_FRAMES_PER_PASS]).to(device), test_size)
            counts.extend(_dynamic_detections(net(x)).tolist())
    print(f"mask_rcnn dynamic detections a frame: min {min(counts)}, mean "
          f"{np.mean(counts):.2f}, max {max(counts)}")
    if min(counts) < 1 or max(counts) > RCNN_MAX_DYNAMIC:
        raise AssertionError(f"a frame has no dynamic detection or more than {RCNN_MAX_DYNAMIC}")
    mask_rcnn_checks(pkl, frames[0], store.load_color_down().shape[1:3], device,
                     test_size, cpu_test_size)
    return pkl, net


def _rel_err(a, b) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def mask_rcnn_checks(pkl: str, frame, down_hw, device: str = "cuda", test_size: int = 800,
                     cpu_test_size: int = RCNN_CPU_TEST_SIZE) -> None:
    """Card against CPU at float32 without TF32 on one frame at
    `cpu_test_size`: P2-P6 and the RPN logits and deltas within RCNN_TOL
    of their largest magnitude; the same detections among those scoring
    RCNN_MARGIN or more above the threshold on either side (class, box
    within 0.01 px, score within 1e-4); dynamic masks differing in at most
    RCNN_MASK_SHARE of their pixels; roi_align_fpn (ROI_ALIGN_TOL) and
    paste_masks (PASTE_SHARE) on the CPU's features and detections. Then,
    printed only, bf16 against float32 on the card on the frame at
    `test_size`: the share of dynamic-mask pixels that differ."""
    import torch

    from robust_cvd_tpu_torch.device import float32_precision
    from robust_cvd_tpu_torch.models import mask_rcnn as M
    from robust_cvd_tpu_torch.pipeline.masks import rcnn_frames, rcnn_input

    out = {}
    with torch.inference_mode(), float32_precision(False):
        for dev in ("cpu", device):
            net = _rcnn_net(pkl, torch.float32, dev)
            img = torch.from_numpy(frame[None]).to(dev)
            x, _ = rcnn_input(img, cpu_test_size)
            feats = net.features(x)
            rpn = net.proposal_generator.rpn_head(feats)
            det = net(x)
            dyn = rcnn_frames(net, img, down_hw, cpu_test_size)
            out[dev] = ([f.cpu() for f in feats], [(o.cpu(), d.cpu()) for o, d in rpn],
                        {k: v.cpu() for k, v in det.items()}, dyn.cpu())
            del net
        (cf, cr, cd, cm), (gf, gr, gd, gm) = out["cpu"], out[device]
        feat_err = max(_rel_err(g, c) for g, c in zip(gf, cf))
        rpn_err = max(max(_rel_err(go, co), _rel_err(gdl, cdl))
                      for (go, gdl), (co, cdl) in zip(gr, cr))
        print(f"mask_rcnn card vs CPU at {tuple(x.shape[-2:])}: P2-P6 {feat_err:.3g}, RPN "
              f"{rpn_err:.3g} of the largest magnitude (tolerance {RCNN_TOL})")
        if not feat_err <= RCNN_TOL or not rpn_err <= RCNN_TOL:
            raise AssertionError("Mask R-CNN features or RPN outputs differ card vs CPU")

        def confident(det):
            keep = det["scores"][0] >= 0.5 + RCNN_MARGIN
            return [(int(c), b, float(s)) for c, b, s in zip(
                det["classes"][0][keep], det["boxes"][0][keep], det["scores"][0][keep])]

        a, b = confident(cd), confident(gd)
        matched = sum(any(c == c2 and float((bx - bx2).abs().max()) < 0.01
                          and abs(s - s2) < 1e-4 for c2, bx2, s2 in b) for c, bx, s in a)
        differ = float((cm != gm).float().mean())
        print(f"mask_rcnn card vs CPU detections: {len(a)} on the CPU and {len(b)} on the "
              f"card score {RCNN_MARGIN} or more above 0.5, {matched} matched; dynamic masks "
              f"differ in {differ:.5f} of pixels (at most {RCNN_MASK_SHARE})")
        if not a or matched != len(a) or len(b) != len(a) or differ > RCNN_MASK_SHARE:
            raise AssertionError("Mask R-CNN detections or dynamic masks differ card vs CPU")

        boxes = cd["boxes"]
        ra = {dev: M.roi_align_fpn([f.to(dev) for f in cf], boxes.to(dev), 14).cpu()
              for dev in ("cpu", device)}
        roi_err = _rel_err(ra[device], ra["cpu"])
        hw = tuple(x.shape[-2:])
        pa = {dev: M.paste_masks(cd["masks"].to(dev), boxes.to(dev), hw).cpu()
              for dev in ("cpu", device)}
        paste_differ = float((pa[device] != pa["cpu"]).float().mean())
        print(f"mask_rcnn card vs CPU: roi_align_fpn {roi_err:.3g} of the largest magnitude "
              f"(tolerance {ROI_ALIGN_TOL}), paste_masks differs in {paste_differ:.3g} of "
              f"pixels (at most {PASTE_SHARE}), {int(pa['cpu'].sum())} pasted")
        if not roi_err <= ROI_ALIGN_TOL or paste_differ > PASTE_SHARE:
            raise AssertionError("roi_align_fpn or paste_masks differs card vs CPU")

    with torch.inference_mode():
        img = torch.from_numpy(frame[None]).to(device)
        dyn = {}
        for dt in (torch.bfloat16, torch.float32):
            net = _rcnn_net(pkl, dt, device)
            with float32_precision(False):
                dyn[dt] = rcnn_frames(net, img, down_hw, test_size).cpu()
            del net
    print(f"mask_rcnn bf16 vs float32 on the card at test size {test_size}: dynamic masks "
          f"differ in {float((dyn[torch.bfloat16] != dyn[torch.float32]).float().mean()):.5f} "
          f"of pixels (dynamic share {float(dyn[torch.float32].float().mean()):.4f} at float32, "
          f"{float(dyn[torch.bfloat16].float().mean()):.4f} at bf16; printed, not checked)")


def mask_rcnn_profile(net, frames, down_hw, test_size: int = 800) -> None:
    """torch.profiler over one steady frame pair of the stage's pass
    (rcnn_frames, bf16): the device time of the backbone and FPN, RPN with
    its NMS, ROIAlign, the heads, detection (class scores, boxes, NMS) and
    the paste, the device idle share, and the pass's host syncs."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from robust_cvd_tpu_torch.models import mask_rcnn as M
    from robust_cvd_tpu_torch.pipeline.masks import rcnn_frames

    x = torch.from_numpy(frames[:2]).cuda()
    with torch.inference_mode():
        for _ in range(2):
            rcnn_frames(net, x, down_hw, test_size).cpu()
        torch.cuda.synchronize()
        reps = 5
        t0 = time.perf_counter()
        for _ in range(reps):
            rcnn_frames(net, x, down_hw, test_size).cpu()
        plain = (time.perf_counter() - t0) / reps
        M.nms_keep.syncs = 0
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            rcnn_frames(net, x, down_hw, test_size).cpu()
            torch.cuda.synchronize()
    syncs = M.nms_keep.syncs
    kernels = _device_events(prof)
    print(f"mask_rcnn profile: a pass of 2 frames {plain * 1e3:.2f} ms unprofiled (host clock, "
          f"mean of {reps}, frames on the card, masks read back), {syncs} NMS syncs and 1 "
          f"readback a pass")
    if not kernels:
        print("mask_rcnn profile: the profiler recorded no device time; split not measured")
        return
    busy, window = _busy_us(kernels)
    total = sum(_time_by_name(kernels).values())
    print(f"mask_rcnn profile: device busy {busy / 1e3:.2f} ms, {len(kernels)} kernels; "
          f"device idle share {1 - busy / window:.4f} of the {window / 1e3:.2f} ms kernel "
          f"window, {1 - busy / 1e3 / (plain * 1e3):.4f} of the unprofiled pass")
    cpu_events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU]
    ranged = 0.0
    for name in RCNN_RANGES:
        dev = sum(getattr(e, "device_time_total", 0.0) for e in cpu_events if e.name == name)
        ranged += dev
        print(f"mask_rcnn profile range {name}: device {dev / 1e3:.3f} ms, "
              f"{dev / total:.2%} of device kernel time")
    print(f"mask_rcnn profile: outside the ranges (resize, pad, crop, downsample, casts) "
          f"{(total - ranged) / 1e3:.3f} ms")
    for name, t in sorted(_time_by_name(kernels).items(), key=lambda kv: -kv[1])[:8]:
        print(f"mask_rcnn profile top: {t / 1e3:8.3f} ms {t / total:7.2%}  {name[:110]}")


# The mesh phase: the whole CLI on a data mesh of MESH_RANKS ranks.
MESH_RANKS = 2
MESH_JOIN_S = 900  # the ranks' time limit
MESH_MASK_SHARE = 1e-3  # mask pixels that may differ from the one-process run's
# The initial depth against the one-process run's, of max|ref|: MiDaS runs
# cuDNN convolutions in TF32 (10 mantissa bits, 2^-10 = 9.8e-4), and a
# frame's depth moved by 3.4e-4 of the largest when its chunk of 16 held
# other frames (H100, 100 frames over 2 ranks).
MESH_DEPTH_TOL = 1e-3
# The mesh phase's clip: the first frames of the pipeline clip. Cut from
# 100 (159.7 s for the ranks on an H100 at 1 epoch) to keep the script
# within 950 s; tools/mesh_cuda.py runs all of them.
MESH_CLIP_FRAMES = 50


def mesh_rank(rank: int, size: int, store: str, clip: str, out_dir: str, epochs: int,
              backend, device: str, argv, small_nets: bool) -> None:
    """One rank of the mesh phase, in a process of its own: init_mesh over
    the file:// `store`, then the CLI, main(["--path", clip, "--num_epochs",
    epochs, "--post_filter", "true", *argv], device) on the clip every rank
    shares, with the kernels' launch counts set to 0 just before it. Writes
    mesh_rank<r>.json to `out_dir` (seconds, launches, steps, epochs, the
    tuner's and the mesh's stats, a digest of the flat parameters and the
    BatchNorm buffers) and its output to mesh_rank<r>.log. small_nets:
    the CPU rehearsal's nets (the small MiDaS net, RAFT float32 with 2
    iterations)."""
    import contextlib

    with open(os.path.join(out_dir, f"mesh_rank{rank}.log"), "w", buffering=1) as log, \
            contextlib.redirect_stdout(log), contextlib.redirect_stderr(log):
        _mesh_rank(rank, size, store, clip, out_dir, epochs, backend, device, argv, small_nets)


def _mesh_rank(rank, size, store, clip, out_dir, epochs, backend, device, argv, small_nets):
    import functools
    import hashlib

    import torch

    from robust_cvd_tpu_torch.main import main as cli_main
    from robust_cvd_tpu_torch.models import midas, raft
    from robust_cvd_tpu_torch.ops import adam, corner
    from robust_cvd_tpu_torch.parallel.mesh import destroy_mesh, init_mesh

    if small_nets:
        torch.set_num_threads(1)
        midas.MidasNet = functools.partial(midas.MidasNet, features=32,
                                           backbone_layers=(1, 1, 1, 1))
        raft.RAFT = functools.partial(raft.RAFT, iters=2, dtype=torch.float32)
    mesh = init_mesh(backend=backend, device=device, init_method=f"file://{store}", rank=rank,
                     world_size=size)
    try:
        corner.corner_min_eigenval.launches = 0
        adam.adam_update.launches = 0
        t0 = time.perf_counter()
        proc = cli_main(["--path", clip, "--num_epochs", str(epochs), "--post_filter", "true",
                         *argv], device=str(mesh.device))
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        seconds = time.perf_counter() - t0
        tuner = proc.tuner
        digest = hashlib.sha256(tuner.optimizer.flat.cpu().numpy().tobytes())
        for b in tuner.net.buffers():
            digest.update(b.cpu().numpy().tobytes())
        with open(os.path.join(out_dir, f"mesh_rank{rank}.json"), "w") as f:
            json.dump({
                "rank": rank, "device": str(mesh.device), "seconds": seconds,
                "corner": corner.corner_min_eigenval.launches,
                "adam": adam.adam_update.launches, "history": tuner.history,
                "stats": tuner.stats, "stages": proc.tracer.summary(),
                "mesh": mesh.stats, "digest": digest.hexdigest(),
                "out_dir": tuner.out_dir, "solve_log": tuner.solve_log,
            }, f)
    finally:
        destroy_mesh()


def run_mesh(base: str, size: int, epochs: int, backend, device, argv=(), small_nets=False):
    """The mesh phase's ranks, `size` processes spawned together, each
    running mesh_rank on the clip `base`; waits for all of them (a failed
    rank raises and the others are stopped; past MESH_JOIN_S all are
    killed). Returns their reports and the seconds of the whole run."""
    import torch.multiprocessing as mp

    out_dir = base + "_reports"
    os.makedirs(out_dir)
    store = os.path.join(out_dir, "store")
    t0 = time.perf_counter()
    ctx = mp.start_processes(
        mesh_rank, args=(size, store, base, out_dir, epochs, backend, device, list(argv),
                         small_nets),
        nprocs=size, join=False, start_method="spawn")
    deadline = time.monotonic() + MESH_JOIN_S
    try:
        while not ctx.join(max(1.0, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                raise TimeoutError(f"the mesh's ranks did not finish in {MESH_JOIN_S} s")
    except BaseException:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
        for r in range(size):
            log = os.path.join(out_dir, f"mesh_rank{r}.log")
            if os.path.exists(log):
                print(f"--- mesh rank {r}, the end of its output:")
                print(open(log).read()[-3000:])
        raise
    seconds = time.perf_counter() - t0
    reports = [json.load(open(os.path.join(out_dir, f"mesh_rank{r}.json"))) for r in range(size)]
    return reports, seconds


def mesh_clip(src: str, base: str, n_frames: int) -> None:
    """A copy of a pipeline clip's inputs: the first n_frames of color_full
    and the MiDaS and RAFT checkpoints."""
    import shutil

    from robust_cvd_tpu_torch.io.store import frame_name

    os.makedirs(os.path.join(base, "color_full"))
    for i in range(n_frames):
        name = frame_name(i, ".png")
        shutil.copy(os.path.join(src, "color_full", name), os.path.join(base, "color_full", name))
    os.makedirs(os.path.join(base, "models"))
    for name in ("midas_v21-f6b98070.pt", "raft-things.pth"):
        shutil.copy(os.path.join(src, "models", name), os.path.join(base, "models", name))


def mesh_phase(single: str, base: str, n_frames: int, epochs: int, single_history=(),
               device: str = "cuda", argv=(), small_nets: bool = False) -> dict:
    """The whole CLI on a data mesh of MESH_RANKS ranks that share one card
    (gloo: NCCL refuses two ranks on a card), on a copy of the inputs of the
    first n_frames of the pipeline phase's clip `single` (run_mesh, epochs
    epochs). Checks the result tree, the initial depth, flows and masks
    against `single`'s files (its pairs of those frames)
    (depth within MESH_DEPTH_TOL of max|ref|, flows within RAFT_TOL, masks
    but MESH_MASK_SHARE of their pixels), replicas bitwise equal, each
    rank's Adam launches equal to its train steps with none skipped, and the
    corner kernel in every rank's flow chunks (rank 0 also builds the
    constraints). Prints the seconds, each rank's epochs (s, steps, ms a
    step, the collectives' share) beside the one-process run's
    `single_history`. Then mesh_nccl_checks. Returns the launches by rank."""
    from robust_cvd_tpu_torch.io import raw
    from robust_cvd_tpu_torch.io.store import VideoStore, load_png_gray
    from robust_cvd_tpu_torch.io.video_dat import load_video_dat

    t_phase = time.perf_counter()
    mesh_clip(single, base, n_frames)
    reports, seconds = run_mesh(base, MESH_RANKS, epochs, "gloo", device, argv, small_nets)
    print(f"mesh: {MESH_RANKS} ranks on {reports[0]['device']} over gloo, the CLI at {epochs} "
          f"epoch(s): {seconds:.3f} s, {seconds / n_frames:.4f} s per clip frame")
    for name, sec in reports[0]["stages"].items():
        print(f"mesh rank 0 stage {name} {sec:.3f}")

    store, ref = VideoStore.open(base), VideoStore.open(single)
    listed = [tuple(e[:2]) for e in store.load_flow_list()]
    if not set(listed) <= {tuple(e[:2]) for e in ref.load_flow_list()}:
        raise AssertionError("the mesh's flow_list.json lists pairs one process has not")
    n_pairs = len(listed)

    def count(sub, ext):
        d = os.path.join(base, sub)
        return len([f for f in os.listdir(d) if f.endswith(ext)]) if os.path.isdir(d) else 0

    for sub, ext, want in (("color_down", ".raw", n_frames), ("color_down_png", ".png", n_frames),
                           ("color_flow", ".png", n_frames), ("depth_midas2/depth", ".raw", n_frames),
                           ("dynamic_mask", ".png", n_frames), ("flow", ".raw", n_pairs),
                           ("flow_mask", ".png", n_pairs)):
        if count(sub, ext) != want:
            raise AssertionError(f"mesh: {count(sub, ext)} files in {sub} for {want}")
    streams = [s.name for s in load_video_dat(os.path.join(base, "video.dat")).depth_streams]
    if streams[:1] != ["depth_midas2"] or streams[-2:] != ["fine_tuned", "fine_tuned_filtered"]:
        raise AssertionError(f"mesh: video.dat streams {streams}")
    depth_dir = os.path.join(reports[0]["out_dir"], "depth")
    disp = [raw.load_raw_float32_image(os.path.join(depth_dir, f))
            for f in sorted(os.listdir(depth_dir)) if f.endswith(".raw")]
    if len(disp) != n_frames or not all(np.isfinite(d).all() for d in disp):
        raise AssertionError(f"mesh: {len(disp)} fine-tuned depth frames, or non-finite ones")
    for f in ("flow_constraints.dat", os.path.join(os.path.dirname(reports[0]["out_dir"]),
                                                   "stage_timings.json")):
        if not os.path.exists(os.path.join(base, f)):
            raise AssertionError(f"mesh: no {f}")

    d = store.load_depth_stream("depth_midas2")
    d_ref = ref.load_depth_stream("depth_midas2")[:n_frames]
    depth_err = float(np.abs(d - d_ref).max() / np.abs(d_ref).max())
    depth_same = int((d == d_ref).reshape(n_frames, -1).all(1).sum())
    flow_err, flow_tol, mask_diff, mask_px = 0.0, 0.0, 0, 0
    for (i, j) in listed:
        f, f_ref = store.load_flow(i, j), ref.load_flow(i, j)
        flow_err = max(flow_err, float(np.abs(f - f_ref).max()))
        flow_tol = max(flow_tol, RAFT_TOL[0] * float(np.abs(f_ref).max()) + RAFT_TOL[1])
        name = f"mask_{i:06d}_{j:06d}.png"
        m = load_png_gray(os.path.join(base, "flow_mask", name))
        mask_diff += int((m != load_png_gray(os.path.join(single, "flow_mask", name))).sum())
        mask_px += m.size
    print(f"mesh vs one process: initial depth max|err| {depth_err:.3e} of max|ref| (tolerance "
          f"{MESH_DEPTH_TOL:g}), {depth_same} of {n_frames} frames bit for bit; {n_pairs} flows max|err| {flow_err:.3e} px (tolerance "
          f"{flow_tol:.3e}); masks differ in {mask_diff} of {mask_px} pixels (tolerance "
          f"{MESH_MASK_SHARE:g} of them)")
    if not (depth_err <= MESH_DEPTH_TOL and flow_err <= flow_tol
            and mask_diff <= MESH_MASK_SHARE * mask_px):
        raise AssertionError("the mesh's initial depth, flows or masks differ from one process's")

    digests = {r["digest"] for r in reports}
    if len(digests) != 1:
        raise AssertionError("the mesh's replicas ended with different parameters or statistics")
    solves = {tuple(e["digest"] for e in r["solve_log"]) for r in reports}
    if len(solves) != 1 or not reports[0]["solve_log"]:
        raise AssertionError("the mesh's ranks ended an LM solve with different SolverParams")
    if not all((e["all_reduces"] > 0) == (e["stage"] != "normalize")
               for r in reports for e in r["solve_log"]):
        raise AssertionError("a step solve of the mesh ran unsharded, or a normalize solve "
                             "sharded")
    for r, rep in enumerate(reports):
        log, st = rep["solve_log"], rep["stats"]
        print(f"mesh rank {r} solves: {st['pose_opt_s']:.3f} s (the cold solve "
              f"{st['pose_opt_first_s']:.3f} s), {len(log)} LM solves, "
              f"{sum(e['outer'] for e in log)} outer steps, {sum(e['cg'] for e in log)} CG "
              f"iterations, {sum(e['all_reduces'] for e in log)} all-reduces, "
              f"{sum(e['all_reduce_s'] for e in log):.3f} s in them (the cold solve's "
              f"{sum(e['all_reduces'] for e in log if e['stage'] != 'warm')})")
    print(f"mesh solves: every rank solved its share of the constraints; SolverParams equal "
          f"on the {MESH_RANKS} ranks after each of {len(reports[0]['solve_log'])} LM solves")
    import torch

    from robust_cvd_tpu_torch.parallel.mesh import Mesh

    cpu = torch.device("cpu")
    chunks = [-(-len(Mesh(r, MESH_RANKS, cpu).share(range(n_pairs))) // 16)
              for r in range(MESH_RANKS)]
    for r, rep in enumerate(reports):
        steps = sum(h["steps"] for h in rep["history"])
        skipped = sum(h["skipped"] for h in rep["history"])
        want_corner = chunks[r] + (r == 0) if device == "cuda" else 0
        want_adam = steps if device == "cuda" else 0
        print(f"mesh rank {r} launches: corner_min_eigenval {rep['corner']} ({chunks[r]} flow "
              f"chunks{' and the constraint build' if r == 0 else ''}), adam {rep['adam']} for "
              f"{steps} train steps, {skipped} skipped; {rep['mesh']['collectives']} "
              f"collectives, {rep['mesh']['collective_s']:.3f} s in them")
        if rep["corner"] < want_corner or rep["adam"] != want_adam or skipped or not steps:
            raise AssertionError(f"mesh rank {r} missed a kernel launch or skipped a step")
        for h in rep["history"]:
            print(f"mesh rank {r} epoch {h['epoch']}: {h['sec']:.3f} s, {h['steps']} steps, "
                  f"{1e3 * h['sec'] / h['steps']:.2f} ms a step, collectives "
                  f"{h['collective_s']:.3f} s ({h['collective_s'] / h['sec']:.1%} of the epoch), "
                  f"loss {h['loss']:.6f}")
    for h in single_history:
        print(f"one process epoch {h['epoch']}: {h['sec']:.3f} s, {h['steps']} steps, "
              f"{1e3 * h['sec'] / h['steps']:.2f} ms a step, loss {h['loss']:.6f}")
    print(f"mesh replicas: one digest of parameters and BatchNorm buffers "
          f"({next(iter(digests))[:16]}) on {MESH_RANKS} ranks")
    mesh_nccl_checks(single, os.path.dirname(base), n_frames, epochs, device, argv, small_nets)
    print(f"stage mesh_phase_s {time.perf_counter() - t_phase:.3f}")
    return {"corner": [r["corner"] for r in reports], "adam": [r["adam"] for r in reports]}


KEYPOINT_SHARE = 0.95  # the CPU's keypoints the card's detect_keypoints must find


def keypoints_check(seed: int) -> None:
    """ops/homography.py's single-image helpers on the card against the
    CPU, on one panning frame at 224x384: detect_keypoints (the corner
    kernel, one launch) finds at least KEYPOINT_SHARE of the CPU's
    keypoints (the kernel's response is within 1e-4 of the plain one's, so
    near-equal corners may trade places), warp_perspective within 1e-5 of
    max|ref|."""
    import torch

    from robust_cvd_tpu_torch.ops import corner, homography as hg

    frame = panning_frames(1, seed)[0]
    gray = frame.mean(-1)
    corner.corner_min_eigenval.launches = 0
    card = hg.detect_keypoints(torch.from_numpy(gray).cuda())
    launches = corner.corner_min_eigenval.launches
    cpu = hg.detect_keypoints(gray)
    share = len({tuple(k) for k in card.tolist()} & {tuple(k) for k in cpu.tolist()}) / len(cpu)
    H = np.array([[1.02, 0.01, -1.5], [-0.015, 0.99, 2.0], [1e-4, -5e-5, 1.0]], np.float32)
    w_card = hg.warp_perspective(torch.from_numpy(frame).cuda(), H).cpu()
    w_cpu = hg.warp_perspective(frame, H)
    err = _rel_err(w_card, w_cpu)
    print(f"keypoints card vs CPU: {len(card)} and {len(cpu)} keypoints, {share:.4f} of the "
          f"CPU's found (at least {KEYPOINT_SHARE}), {launches} corner launch; "
          f"warp_perspective max|err| {err:.3e} of max|ref| (tolerance 1e-5)")
    if launches != 1 or share < KEYPOINT_SHARE or not err <= 1e-5:
        raise AssertionError("detect_keypoints or warp_perspective on the card disagrees")


def mesh_nccl_checks(single: str, base: str, n_frames: int, epochs: int, device: str, argv,
                     small_nets: bool) -> None:
    """nccl on the card: a 1-rank group's all_reduce; with two or more
    cards, the whole CLI on one rank a card (run_mesh over nccl) and its
    replicas bitwise equal. Nothing on the CPU."""
    import torch

    from robust_cvd_tpu_torch.parallel.mesh import destroy_mesh, init_mesh

    if device != "cuda":
        return
    mesh = init_mesh(backend="nccl", device="cuda:0",
                     init_method=f"file://{os.path.join(base, 'nccl_store')}", rank=0,
                     world_size=1)
    try:
        t = torch.arange(5, dtype=torch.float32, device="cuda:0")
        mesh.all_reduce_mean_(t)
        torch.cuda.synchronize()
        if not torch.equal(t.cpu(), torch.arange(5, dtype=torch.float32)):
            raise AssertionError("a 1-rank nccl all_reduce changed its tensor")
    finally:
        destroy_mesh()
    print("mesh nccl: a 1-rank group's all_reduce on cuda:0 gave its tensor back")
    cards = torch.cuda.device_count()
    if cards < 2:
        print(f"mesh over nccl with one rank a card: not run ({cards} card)")
        return
    clip = os.path.join(base, "nccl_clip")
    mesh_clip(single, clip, n_frames)
    reports, seconds = run_mesh(clip, cards, epochs, None, None, argv, small_nets)
    if len({r["digest"] for r in reports}) != 1:
        raise AssertionError("the nccl mesh's replicas ended with different parameters")
    print(f"mesh over nccl: {cards} ranks, one a card, {seconds:.3f} s, replicas equal")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=100,
                    help="clip length (100 = the bench clip)")
    ap.add_argument("--epochs", type=int, default=PIPELINE_EPOCHS,
                    help=f"the pipeline phase's fine-tune epochs ({PIPELINE_EPOCHS}, cut from "
                         "the default FineTuneParams' 10); the fine-tune phase runs at most 2")
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
    print(f"epochs: {args.epochs}" + (" (the default FineTuneParams')" if args.epochs == 10
                                      else " (cut from the default FineTuneParams' 10)"))
    pose_frames = min(args.frames, POSE_CLIP_FRAMES)
    print(f"pose clip frames: {pose_frames}")
    build_kernels()
    corner_k = corner_phase(args.frames, args.seed)
    from robust_cvd_tpu_torch.models.midas import MidasNet

    with torch.device("meta"):
        n_params = sum(p.numel() for p in MidasNet().parameters())
    adam_entries = {e["name"]: e for e in adam_phase(n_params, args.seed)}
    t0 = time.perf_counter()
    attention_k = attention_phase(args.seed)
    attention_bias_k = attention_bias_phase(args.seed)
    attention_window_k = window_attention_phase(args.seed)
    attention_window_k["launches_by_path"] = window_launches_check(args.seed)
    print(f"stage attention_phase_s {time.perf_counter() - t0:.3f}")
    solver_phase(args.seed)
    sharded_solve_check()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_io_") as base:
        io_engine_check(base, seed=args.seed)
    step_phase(args.seed)
    step_graph_check(args.seed)
    eval_check(args.seed)
    raft_device_check(args.seed)
    keypoints_check(args.seed)
    launches = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_clip_") as base:
        launches["pose"], depth, net = path_phase(base, pose_frames, args.seed)
        if launches["pose"] < 1:
            raise AssertionError("the corner kernel was not launched on the pose path")
        tuner, adam_fine_tune = finetune_phase(base, depth, net, args.seed,
                                               min(2, args.epochs))
        if adam_fine_tune < 1:
            raise AssertionError("the Adam kernel was not launched on the fine-tune path")
        validate_phase(tuner)
        launches["processor"] = processor_phase(base, tuner.solver_params, args.seed)
        adam_modes = optimizer_epochs_phase(tuner)
        del tuner
        torch.cuda.empty_cache()
        adam_colmap = colmap_phase(base, net, args.seed)
    del net, depth
    torch.cuda.empty_cache()
    quality_phase()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_flow_") as base:
        launches["flow"], stage = flow_phase(os.path.join(base, "clip"), args.frames, args.seed)
        if launches["flow"] < 1:
            raise AssertionError("the corner kernel was not launched on the flow path")
        exact_mask_check(os.path.join(base, "exact"), args.frames, args.seed)
        flow_card_checks(stage)
        corner_k["flow_path"] = corner_flow_entry(stage, launches["flow"])
    del stage
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_pipeline_") as base:
        pipe, proc = pipeline_phase(os.path.join(base, "clip"), args.frames, args.seed,
                                    args.epochs)
        single_history = proc.tuner.history
        post_filter_profile(proc)
        del proc
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        clip = os.path.join(base, "clip")
        _, rcnn_net = mask_rcnn_phase(clip, args.seed)
        from robust_cvd_tpu_torch.io.store import VideoStore

        rcnn_store = VideoStore.open(clip)
        mask_rcnn_profile(rcnn_net, rcnn_store.load_color_full(),
                          rcnn_store.load_color_down().shape[1:3])
        del rcnn_net
        torch.cuda.empty_cache()
        print(f"stage mask_rcnn_phase_s {time.perf_counter() - t0:.3f}")
        mesh = mesh_phase(clip, os.path.join(base, "mesh", "clip"),
                          min(args.frames, MESH_CLIP_FRAMES), 1, single_history)
    launches["pipeline"] = pipe["corner"]
    launches["mesh"] = sum(mesh["corner"])
    corner_k["launches"] = sum(launches.values())
    corner_k["launches_by_path"] = dict(launches, mesh_by_rank=mesh["corner"])
    adam_k = adam_entries["adam"]
    adam_k["launches_by_path"] = {"fine_tune": adam_fine_tune, "colmap": adam_colmap,
                                  "pipeline": pipe["adam"], "mesh": sum(mesh["adam"]),
                                  "mesh_by_rank": mesh["adam"]}
    adam_k["launches"] = adam_fine_tune + adam_colmap + pipe["adam"] + sum(mesh["adam"])
    for name, count in adam_modes.items():
        if count < 1:
            raise AssertionError(f"the Adam kernel's {name} mode was not launched on its path")
        adam_entries[name]["launches"] = count
        adam_entries[name]["launches_by_path"] = {"fine_tune_epoch": count}
    print(f"total_s {time.perf_counter() - t_start:.3f}")
    print(json.dumps({"kernels": [corner_k] + list(adam_entries.values())
                      + [attention_k, attention_bias_k, attention_window_k]}))
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
