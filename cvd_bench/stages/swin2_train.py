"""Stage `swin2_train`: the `train` stage's fine-tune train steps with
SwinV2-L/24-384 under DPT's decoder (MiDaS v3.1's dpt_swin2_large_384) in
MiDaS v2's place.

Set-up is stages/dpt_train.py's with the depth model built through the
port's registry (`dpt_swin2_large_384`, robust_cvd_tpu_torch/models/
registry.py) at the configuration's widths and seeded on the card
(weights_swin2.py); the initial depth comes from the adapter's
estimate_depth (TF32 matrix products) in chunks of 16. The net squashes
each 384x672 frame to 384x384 and resizes its disparity back. The
window's unit, its bookkeeping, the port's readings and the comparison are
stages/train.py's, imported. After the window the port's state is freed
and the plain reference (reference/swin2.py) takes the same steps from the
same weights and inputs in full float32; the control puts bf16 autocast in
the port's place, and the faults half of each batch, the continuous
position bias left out, the shift mask left out, the shift left out and
dot-product attention (1 / sqrt(32)) in the cosine attention's place.

Compared, as in stages/train.py: `loss`, `grad` and `change`.
"""

from __future__ import annotations

import statistics
import time

import torch

from .. import clip as bench_clip
from .. import weights_swin2
from ..core import Check
from ..counts import swin2_train as counts
from ..reference import swin2 as ref_swin2
from . import train
from .train import attempted_failed, close_window, gaps, min_units, port_readings, report, unit

__all__ = ["setup", "unit", "min_units", "close_window", "counters", "attempted_failed",
           "report", "check", "control"]

REGISTRY_NAME = "dpt_swin2_large_384"
FAULTS = {"fault_no_bias": {"bias": False}, "fault_no_mask": {"mask": False},
          "fault_no_shift": {"shift": False}, "fault_dot_product": {"dot_product": True}}


def setup(ctx):
    from robust_cvd_tpu_torch.config import FineTuneParams, LossParams, PipelineConfig
    from robust_cvd_tpu_torch.device import float32_precision
    from robust_cvd_tpu_torch.models.registry import get_depth_model
    from robust_cvd_tpu_torch.models.swin2 import Swin2DepthNet
    from robust_cvd_tpu_torch.training.fine_tune import ClipData, FineTuner, PoseState

    cfg, mix, dev = ctx.config, ctx.mix, ctx.device
    n = cfg["clip"]["frames"]
    h, w = cfg["clip"]["down_hw"]
    shift = mix["shift_px"]
    st = train.State()
    st.ctx = ctx
    t0 = time.perf_counter()
    frames = torch.from_numpy(bench_clip.panning_frames(n, h, w, shift, ctx.seed)).to(dev)
    pairs = bench_clip.training_pairs(n)
    flows, masks = bench_clip.exact_flows(pairs, h, w, shift, dev)
    pose = bench_clip.camera_path(n, h, w, ctx.seed, dev)
    st.inputs = dict(images=frames, pairs=torch.tensor(pairs, device=dev), flows=flows,
                     masks=masks, pose=pose)
    train._sync(dev)
    ctx.say(f"setup: clip {n} frames {h}x{w}, {len(pairs)} training pairs, "
            f"{time.perf_counter() - t0:.3f} s")

    t0 = time.perf_counter()
    model = cfg["model"]
    with torch.device(dev):
        net = Swin2DepthNet(**{k: model[k] for k in ref_swin2.NET_KEYS})
    weights_swin2.seed_swin2_(net, ctx.seed)
    adapter = get_depth_model(REGISTRY_NAME)(net)
    frames_a_step = 2 * cfg["train"]["batch_size"]
    st.tokens, st.windows = counts.tokens(model), counts.windows(model, frames_a_step)
    with float32_precision(cudnn_tf32=True):
        depth0 = torch.cat([adapter.estimate_depth(frames[s : s + 16]) for s in range(0, n, 16)])
    train._sync(dev)
    ctx.say(f"setup: Swin2 {sum(p.numel() for p in net.parameters())} parameters, "
            f"{st.tokens} tokens a frame at stage 0, {st.windows} windows a step, initial "
            f"depth {time.perf_counter() - t0:.3f} s")

    ft = FineTuneParams(batch_size=cfg["train"]["batch_size"],
                        learning_rate=cfg["train"]["learning_rate"], save_tensorboard=False)
    pcfg = PipelineConfig(ft=ft, loss=LossParams(**cfg["loss"]), model_type=REGISTRY_NAME)
    data = ClipData(images=frames, depth_orig=depth0, pair_idx=st.inputs["pairs"], flows=flows,
                    masks=masks)
    tuner = FineTuner(pcfg, adapter, data, None, seed=ctx.seed, device=dev)
    ext, intr, scales, warp = pose
    tuner.pose_state = PoseState(extrinsics=ext, intrinsics=intr, scales=scales, warp=warp)
    st.tuner = tuner
    opt = tuner.optimizer

    # warm-up as stages/train.py's; the net has no buffers to put back
    t0 = time.perf_counter()
    st.pending, st.epochs, st.steps, st.skipped = [], [], 0, 0
    order = torch.as_tensor(tuner.rng.permutation(len(pairs)), device=dev)
    warm = tuner.epoch_batches(order)
    for k in range(mix["warmup_steps"]):
        loss, _, ok = tuner.train_step(warm[k % len(warm)][1])
        st.pending.append((loss, ok))
    train._epoch_end(st)
    with torch.no_grad():
        opt.flat.copy_(opt.init)
        opt.mu.zero_()
        opt.nu.zero_()
        opt.count.zero_()
    train._sync(dev)
    ctx.say(f"setup: {mix['warmup_steps']} warm-up steps {time.perf_counter() - t0:.3f} s, "
            f"then the state reset")

    st.steps = 0
    st.skipped = 0
    st.epochs = []
    st.pending = []
    st.queue = []
    st.checked = []
    st.mu_first = None
    st.flat_checked = None
    return st


def counters(st):
    """Adam's parameter count, the encoder's tokens a frame at stage 0 and
    its windows a step at stage 0."""
    return {"parameters": int(st.tuner.optimizer.numel), "tokens": st.tokens,
            "windows": st.windows}


def reference(st, kind: str = "float32", half_batch: bool = False, **faults):
    ctx, cfg = st.ctx, st.ctx.config
    t0 = time.perf_counter()
    ref = ref_swin2.steps(cfg["model"], ctx.seed, st.inputs["images"], st.inputs["pairs"],
                          st.inputs["flows"], st.inputs["masks"], st.inputs["pose"], st.batches,
                          cfg["loss"], cfg["train"]["learning_rate"], kind=kind,
                          half_batch=half_batch, **faults)
    planted = ", half batch" * half_batch + "".join(f", {k}={v}" for k, v in faults.items())
    ctx.say(f"reference ({kind}{planted}): {time.perf_counter() - t0:.3f} s, "
            f"losses {ref['losses']}")
    return ref


def _cpb(ref):
    """The continuous position bias's leaves (its MLPs and the
    temperatures): their reference gradient norms over the median leaf's;
    none may fall under the 1e-3 that `gaps` leaves out."""
    med = statistics.median(ref["grad_norms"].values())
    return [v / med for k, v in ref["grad_norms"].items()
            if ".cpb_mlp." in k or k.endswith("logit_scale")]


def check(st):
    limits = st.ctx.limits
    port = port_readings(st)
    ref = reference(st)
    (loss, grad, change), left_out = gaps(port, ref)
    cpb = _cpb(ref)
    st.ctx.say(f"check: {left_out} leaves left out (reference gradient under 1e-3 of the "
               f"median leaf's); the {len(cpb)} CPB and temperature leaves' gradients "
               f"{min(cpb):.4g} to {max(cpb):.4g} of the median leaf's")
    return [Check("loss", loss, limits["loss"]), Check("grad", grad, limits["grad"]),
            Check("change", change, limits["change"])]


def control(st):
    """The readings the limits are set from, on this seed: the port's
    (lower), the reference under bf16 autocast in the port's place (the
    control), and the reference with each planted fault (half of each
    batch; FAULTS), each against the float32 reference; and the CPB and
    temperature leaves' gradient norms over the median leaf's."""
    port = port_readings(st)
    ref = reference(st)
    out = {
        "port": gaps(port, ref)[0],
        "control_bf16": gaps(reference(st, "bfloat16"), ref)[0],
        "fault_half_batch": gaps(reference(st, half_batch=True), ref)[0],
    }
    for name, fault in FAULTS.items():
        out[name] = gaps(reference(st, **fault), ref)[0]
    out["cpb_over_median"] = [min(_cpb(ref)), max(_cpb(ref))]
    return out
