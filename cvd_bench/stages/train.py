"""Stage `train`: fine-tune train steps of the port (FineTuner.train_step),
epoch after epoch over a seeded permutation of the clip's training pairs,
the loss read back once an epoch as FineTuner.run does. No pose solve runs
in the window.

Set-up makes the clip, the exact flows and masks and a solved camera path
from the seed (clip.py), builds MiDaS-v2 with seeded weights on the card,
infers the initial depth through the port's adapter, builds the FineTuner,
warms up through the window's own call and puts the state back. The
window's first `checked_steps` steps, on batches whose pairs all differ,
are the check's: their losses, Adam's first moment after the first and the
parameters after the last are kept on the card. After the window the
port's state is freed and the plain reference (reference/train.py) takes
the same steps from the same weights and inputs.

Compared (the largest over the steps or the leaves):
- `loss`: each step's loss, |port - ref| / |ref|;
- `grad`: each parameter's gradient norm at the first step, as Adam got it
  (its first moment after one step over 1 - b1), |port - ref| /
  max(ref, the median parameter's);
- `change`: each parameter's change after the last checked step, the same
  way. Parameters whose reference gradient is under a thousandth of the
  median parameter's move by round-off alone and are left out of `grad`
  and `change`.
"""

from __future__ import annotations

import statistics
import time

import torch

from .. import clip as bench_clip
from .. import weights
from ..core import Check
from ..reference import train as ref_train

B1 = 0.9  # optax.adam's first-moment decay


class State:
    pass


def _sync(device):
    if device == "cuda":
        torch.cuda.synchronize()


def setup(ctx):
    from robust_cvd_tpu_torch.config import FineTuneParams, LossParams, PipelineConfig
    from robust_cvd_tpu_torch.device import float32_precision
    from robust_cvd_tpu_torch.models.midas import MidasNet, MidasV2Adapter
    from robust_cvd_tpu_torch.training.fine_tune import ClipData, FineTuner, PoseState

    cfg, mix, dev = ctx.config, ctx.mix, ctx.device
    n = cfg["clip"]["frames"]
    h, w = cfg["clip"]["down_hw"]
    shift = mix["shift_px"]
    st = State()
    st.ctx = ctx
    t0 = time.perf_counter()
    frames = torch.from_numpy(bench_clip.panning_frames(n, h, w, shift, ctx.seed)).to(dev)
    pairs = bench_clip.training_pairs(n)
    flows, masks = bench_clip.exact_flows(pairs, h, w, shift, dev)
    pose = bench_clip.camera_path(n, h, w, ctx.seed, dev)
    st.inputs = dict(images=frames, pairs=torch.tensor(pairs, device=dev), flows=flows,
                     masks=masks, pose=pose)
    _sync(dev)
    ctx.say(f"setup: clip {n} frames {h}x{w}, {len(pairs)} training pairs, "
            f"{time.perf_counter() - t0:.3f} s")

    t0 = time.perf_counter()
    model = cfg["model"]
    with torch.device(dev):
        net = MidasNet(features=model["features"], backbone_layers=model["backbone_layers"])
    weights.seed_midas_(net, ctx.seed)
    adapter = MidasV2Adapter(net)
    # the initial depth as the pipeline's stage infers it (eval mode, TF32
    # convolutions, chunks of 16)
    with float32_precision(cudnn_tf32=True):
        depth0 = torch.cat([adapter.estimate_depth(frames[s : s + 16]) for s in range(0, n, 16)])
    _sync(dev)
    ctx.say(f"setup: MiDaS-v2 {sum(p.numel() for p in net.parameters())} parameters, "
            f"initial depth {time.perf_counter() - t0:.3f} s")

    ft = FineTuneParams(batch_size=cfg["train"]["batch_size"],
                        learning_rate=cfg["train"]["learning_rate"], save_tensorboard=False)
    pcfg = PipelineConfig(ft=ft, loss=LossParams(**cfg["loss"]))
    data = ClipData(images=frames, depth_orig=depth0, pair_idx=st.inputs["pairs"], flows=flows,
                    masks=masks)
    tuner = FineTuner(pcfg, adapter, data, None, seed=ctx.seed, device=dev)
    ext, intr, scales, warp = pose
    tuner.pose_state = PoseState(extrinsics=ext, intrinsics=intr, scales=scales, warp=warp)
    st.tuner = tuner
    opt = tuner.optimizer

    # warm-up: the mix's `warmup_steps` through the window's own call on
    # every shape it uses, the epoch's readback included; then the
    # optimizer, the BatchNorm statistics and so the net are put back as
    # they were, so that the window's first steps are the check's
    t0 = time.perf_counter()
    buffers = [b.clone() for b in tuner.net.buffers()]
    st.pending, st.epochs, st.steps, st.skipped = [], [], 0, 0
    order = torch.as_tensor(tuner.rng.permutation(len(pairs)), device=dev)
    warm = tuner.epoch_batches(order)
    for k in range(mix["warmup_steps"]):
        loss, _, ok = tuner.train_step(warm[k % len(warm)][1])
        st.pending.append((loss, ok))
    _epoch_end(st)
    with torch.no_grad():
        opt.flat.copy_(opt.init)
        opt.mu.zero_()
        opt.nu.zero_()
        opt.count.zero_()
        for b, b0 in zip(tuner.net.buffers(), buffers):
            b.copy_(b0)
    _sync(dev)
    ctx.say(f"setup: {mix['warmup_steps']} warm-up steps {time.perf_counter() - t0:.3f} s, "
            f"then the state reset")

    st.steps = 0
    st.skipped = 0
    st.epochs = []
    st.pending = []
    st.queue = []
    st.checked = []  # (pair ids, loss) of the window's first steps, on the card
    st.mu_first = None  # Adam's first moment after the window's first step
    st.flat_checked = None  # the parameters after the last checked step
    return st


def _epoch_end(st):
    """The epoch's one host sync: its mean loss and skipped steps."""
    if not st.pending:
        return
    losses = torch.stack([l for l, _ in st.pending])
    oks = torch.stack([o for _, o in st.pending])
    mean, skipped = torch.stack([losses.mean(), (~oks).sum().float()]).tolist()
    t = time.perf_counter() - st.t_first if st.steps else 0.0
    st.epochs.append({"steps": len(st.pending), "loss": mean, "skipped": int(skipped),
                      "at_s": t})
    st.skipped += int(skipped)
    st.pending = []


def unit(st):
    """One train step; a new epoch's permutation when the last ran out."""
    tuner = st.tuner
    if not st.queue:
        _epoch_end(st)
        order = torch.as_tensor(tuner.rng.permutation(int(tuner.clip.pair_idx.shape[0])),
                                device=st.ctx.device)
        st.queue = [ids for _, ids in tuner.epoch_batches(order)]
    ids = st.queue.pop(0)
    if not st.steps:
        st.t_first = time.perf_counter()
    loss, _, ok = tuner.train_step(ids)
    st.pending.append((loss, ok))
    st.steps += 1
    n_checked = st.ctx.mix["checked_steps"]
    if st.steps <= n_checked:
        # copies on the card; read back once the window has closed
        opt = tuner.optimizer
        st.checked.append((ids, loss))
        if st.steps == 1:
            st.mu_first = opt.mu.clone()
        if st.steps == n_checked:
            st.flat_checked = opt.flat.clone()


def min_units(st):
    """The window holds at least the steps its check compares."""
    return st.ctx.mix["checked_steps"]


def close_window(st):
    _epoch_end(st)


def counters(st):
    return {"parameters": int(st.tuner.optimizer.numel)}


def attempted_failed(st):
    return st.steps, st.skipped


def report(st):
    """Each epoch's steps, mean loss, skipped steps and the window's time at
    its readback (the steps' pace through the window)."""
    return [f"epoch {e}" for e in st.epochs]


def _leaf_gap(port, ref, grads_ref):
    """The largest |port - ref| / max(ref, median) over the leaves whose
    reference gradient is at least a thousandth of the median leaf's."""
    med_g = statistics.median(grads_ref.values())
    med = statistics.median(ref.values())
    keep = [k for k in ref if grads_ref[k] >= 1e-3 * med_g]
    return max(abs(port[k] - ref[k]) / max(ref[k], med) for k in keep), len(ref) - len(keep)


def gaps(port, ref):
    """(loss, grad, change) gaps of `port` against `ref`, each a dict of
    `losses`, `grad_norms` and `change_norms`, and the leaves left out."""
    loss = max(abs(p - r) / abs(r) for p, r in zip(port["losses"], ref["losses"]))
    grad, left_out = _leaf_gap(port["grad_norms"], ref["grad_norms"], ref["grad_norms"])
    change, _ = _leaf_gap(port["change_norms"], ref["change_norms"], ref["grad_norms"])
    return (loss, grad, change), left_out


def port_readings(st):
    """The port's checked numbers from the window's first steps; frees its
    state. Records the steps' pair ids as `st.batches` for the
    reference."""
    opt = st.tuner.optimizer
    st.batches = [ids.tolist() for ids, _ in st.checked]
    losses = [float(loss) for _, loss in st.checked]
    grads = [float(x) / (1 - B1) for x in torch._foreach_norm(opt.views(st.mu_first.float()))]
    changes = [float(x) for x in torch._foreach_norm(opt.views(st.flat_checked - opt.init))]
    names = opt.names
    st.tuner = st.checked = st.mu_first = st.flat_checked = None
    if st.ctx.device == "cuda":
        torch.cuda.empty_cache()
    st.ctx.say(f"check: the window's first {len(losses)} steps, losses {losses}")
    return {"losses": losses, "grad_norms": dict(zip(names, grads)),
            "change_norms": dict(zip(names, changes))}


def reference(st, kind: str = "float32", half_batch: bool = False):
    ctx, cfg = st.ctx, st.ctx.config
    t0 = time.perf_counter()
    ref = ref_train.steps(cfg["model"], ctx.seed, st.inputs["images"], st.inputs["pairs"],
                          st.inputs["flows"], st.inputs["masks"], st.inputs["pose"], st.batches,
                          cfg["loss"], cfg["train"]["learning_rate"], kind=kind,
                          half_batch=half_batch)
    ctx.say(f"reference ({kind}{', half batch' if half_batch else ''}): "
            f"{time.perf_counter() - t0:.3f} s, losses {ref['losses']}")
    return ref


def check(st):
    limits = st.ctx.limits
    port = port_readings(st)
    (loss, grad, change), left_out = gaps(port, reference(st))
    st.ctx.say(f"check: {left_out} leaves left out (reference gradient under 1e-3 of the "
               f"median leaf's)")
    return [Check("loss", loss, limits["loss"]), Check("grad", grad, limits["grad"]),
            Check("change", change, limits["change"])]


def control(st):
    """The readings that the limits are set from, on this seed: the port's
    (lower), the reference in bfloat16 put in the port's place (the
    control) and the reference with half of each batch left out (a fault),
    each against the float32 reference. A step that returns its state
    unchanged reads 1 on `change` by definition."""
    port = port_readings(st)
    ref = reference(st)
    return {
        "port": gaps(port, ref)[0],
        "control_bf16": gaps(reference(st, "bfloat16"), ref)[0],
        "fault_half_batch": gaps(reference(st, half_batch=True), ref)[0],
    }
