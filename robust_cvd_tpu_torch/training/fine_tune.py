"""Test-time depth fine-tuning (PyTorch): the train step and the loop.

Port of robust_cvd_tpu/training/fine_tune.py (reference
depth_fine_tuning.py:207-860):
  - the whole clip's frames, flows and masks live on the device; a batch is
    a set of pair ids gathered inside the step;
  - one train step: MiDaS forward in train mode (Flax BatchNorm semantics),
    the depth-transform scale maps, JointLoss, backward, the non-finite
    guard and one fused Adam kernel launch over the flat parameter buffer
    (training/optimizer.py, ops/adam.py), then the guarded BatchNorm update;
  - the epoch loop alternates with depth refreshes and warm pose re-solves,
    in the JAX package's pair order (a numpy permutation per epoch), batch
    grouping (P // B full batches, then the remainder as one step) and
    persistence (depth streams, video.dat, checkpoints).

The JAX package runs an epoch's full batches as one lax.scan; here they are
a Python loop whose per-step losses stay on the device, read back once per
epoch (the loop's only host sync).

Precision on the card: float32 parameters, activations and Adam state;
cuDNN convolutions in TF32 unless the tuner is built with
cudnn_tf32=False; the loss stack and geometry in full float32.

recon=colmap: the poses come fixed from the COLMAP reconstruction
(`pose_state_override`) and the solver never runs; with a reference
disparity (`ClipData.ref_disp`) every train and eval step rescales each
frame's depth by the median ratio of its disparity to the reference's.

Validation (val_epoch_freq >= 0): per-pair losses at epoch 0, every
val_epoch_freq epochs and after the last, computed on the device over all
pairs in batches of batch_size (each pair with its own train-mode
BatchNorm statistics, as the JAX package's one-pair scan) and read back
once; `eval/loss_e%04d_iter%06d.json` in the reference's layout, the eval
depth images, the depth-transform scale maps and the scene-flow images.

Not ported yet, raising NotImplementedError: RAdam and the bf16 first
moment (optimizer slice), the post filter (processor slice) and the
data-parallel mesh fine-tune (multi-GPU slice).

Tensorboard: with ft.save_tensorboard, the tuner logs the JAX package's
scalars, histograms and images through torch.utils.tensorboard under
<experiment dir>/tensorboard (or ft.tensorboard_log_path / ft.log_dir);
where the tensorboard package is missing it prints one line and logs
nothing. The per-step values are read back once per epoch, after the
epoch's host sync.
"""

from __future__ import annotations

import contextlib
import os
import time
from os.path import join as pjoin
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..camera import pose_params_to_camera, quat_to_matrix
from ..config import LossParams, PipelineConfig
from ..device import float32_precision, resolve_device
from ..models.midas import (
    commit_batch_stats, depth_apply, normalize_images, per_slice_batch_stats,
)
from ..ops import geometry
from ..solver import pose_opt, xforms
from ..solver.pose_opt import PoseOptInputs
from ..solver.residuals import SolverParams
from ..solver.xforms import GridSpec
from . import losses
from .losses import LossMeta
from .optimizer import FlatAdam


class ClipData(NamedTuple):
    """Whole-clip training data on the device (static across epochs)."""

    images: torch.Tensor  # (N, H, W, 3) in [0, 1]
    depth_orig: torch.Tensor  # (N, H, W) initial depth
    pair_idx: torch.Tensor  # (P, 2) int64
    flows: torch.Tensor  # (P, 2, H, W, 2)
    masks: torch.Tensor  # (P, 2, H, W) float
    # temporal neighbours (only when the smoothness losses are on)
    neighbor_idx: Optional[torch.Tensor] = None  # (P, 4) int64
    flows_n: Optional[torch.Tensor] = None  # (P, 4, H, W, 2)
    masks_n: Optional[torch.Tensor] = None  # (P, 4, H, W)
    valid_n: Optional[torch.Tensor] = None  # (P, 2)
    # recon=colmap with scaling=depth: per-frame reference disparity, where
    # non-finite pixels are invalid (reference depth_fine_tuning.py:494-511)
    ref_disp: Optional[torch.Tensor] = None  # (N, H, W)


class PoseState(NamedTuple):
    """Per-frame geometry pulled from the solver after each pose solve."""

    extrinsics: torch.Tensor  # (N, 3, 4) camera-to-world [R|t]
    intrinsics: torch.Tensor  # (N, 4) pixel (fx, fy, cx, cy)
    scales: torch.Tensor  # (N, H, W) depth-transform scale maps
    warp: torch.Tensor  # (N, H, W, 2) NDC spatial warp maps


def pose_state_from_solver(
    params: SolverParams, shape: Tuple[int, int], aspect: float,
    source_depth: Optional[torch.Tensor] = None,
) -> PoseState:
    """SolverParams -> per-frame training metadata (reference
    loaders/video_dataset.py:153-217 update_poses)."""
    shape = tuple(shape)
    if source_depth is None:
        source_depth = torch.ones(
            (params.pose.shape[0],) + shape, device=params.pose.device
        )
    cam = pose_params_to_camera(params.pose, params.focal, aspect)
    ext = torch.cat([quat_to_matrix(cam.quaternion), cam.position[:, :, None]], 2)
    intr = geometry.intrinsics_px(cam.vfov, cam.hfov, shape)
    gz, gy, gx = params.depth_grid.shape[1:]
    dspec = GridSpec(gx=gx, gy=gy, gz=gz)
    scales = torch.stack([
        xforms.depth_param_map(g, dspec, shape, d)
        for g, d in zip(params.depth_grid, source_depth)
    ])
    sy, sx = params.spatial_grid.shape[1:3]
    warp = torch.stack([
        xforms.spatial_warp_map(g, cubic=sx > 2 or sy > 2, shape=shape)
        for g in params.spatial_grid
    ])
    return PoseState(extrinsics=ext, intrinsics=intr, scales=scales, warp=warp)


def build_clip_data(
    images: np.ndarray,
    depth_orig: np.ndarray,
    flow_list: List[Tuple[int, int, float]],
    flows: Dict[Tuple[int, int], np.ndarray],
    masks: Dict[Tuple[int, int], np.ndarray],
    min_mask_ratio: float,
    use_temporal: bool = False,
    ref_disp: Optional[np.ndarray] = None,
    device="cuda",
) -> ClipData:
    """Device tensors from per-pair host data. Keeps the pairs (i, j) with
    i < j and min(ratio_ij, ratio_ji) > min_mask_ratio, sorted
    (reference loaders/video_dataset.py:124-147)."""
    device = resolve_device(device)
    ratio = {(i, j): r for (i, j, r) in flow_list}
    pairs = sorted(
        (i, j)
        for (i, j, r) in flow_list
        if i < j and min(r, ratio.get((j, i), 0.0)) > min_mask_ratio
    )
    if not pairs:
        raise ValueError("no frame pairs pass the mask-ratio filter")

    n = images.shape[0]
    p = len(pairs)
    h, w = images.shape[1:3]

    def dev(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    data = dict(
        images=dev(images),
        depth_orig=dev(depth_orig),
        pair_idx=dev(pairs, torch.int64),
        flows=dev(np.stack([np.stack([flows[(i, j)], flows[(j, i)]]) for (i, j) in pairs])),
        masks=dev(np.stack([
            np.stack([np.asarray(masks[(i, j)], np.float32),
                      np.asarray(masks[(j, i)], np.float32)])
            for (i, j) in pairs
        ])),
    )
    if ref_disp is not None:
        data["ref_disp"] = dev(ref_disp)
    if use_temporal:
        nbr = np.zeros((p, 4), np.int64)
        fln = np.zeros((p, 4, h, w, 2), np.float32)
        mkn = np.zeros((p, 4, h, w), np.float32)
        val = np.zeros((p, 2), np.float32)
        for q, (i, j) in enumerate(pairs):
            for a, anchor in enumerate((i, j)):
                bw, fw = anchor - 1, anchor + 1
                ok = bw >= 0 and fw < n and (anchor, bw) in flows and (anchor, fw) in flows
                val[q, a] = float(ok)
                if ok:
                    nbr[q, 2 * a], nbr[q, 2 * a + 1] = bw, fw
                    fln[q, 2 * a] = flows[(anchor, bw)]
                    fln[q, 2 * a + 1] = flows[(anchor, fw)]
                    mkn[q, 2 * a] = masks[(anchor, bw)]
                    mkn[q, 2 * a + 1] = masks[(anchor, fw)]
                else:
                    nbr[q, 2 * a] = nbr[q, 2 * a + 1] = anchor
        data.update(
            neighbor_idx=dev(nbr, torch.int64), flows_n=dev(fln), masks_n=dev(mkn),
            valid_n=dev(val),
        )
    return ClipData(**data)


def colmap_depth_scale(depth: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Per-frame scale (B, K): the median over valid pixels of estimated
    disparity / reference disparity, detached (reference
    depth_fine_tuning.py:494-511); 1 where no pixel is valid. depth, ref:
    (B, K, H, W). Invalid pixels sort to +inf; with m valid ones the median
    is the mean of ranks (m - 1) // 2 and m // 2 (numpy's median)."""
    b, k = depth.shape[:2]
    valid = torch.isfinite(ref)
    ratio = torch.where(valid, (1.0 / depth) / ref, torch.inf).reshape(b, k, -1)
    srt = ratio.sort(dim=-1).values
    m = valid.reshape(b, k, -1).sum(-1)
    lo = ((m - 1) // 2).clamp_min(0)
    hi = (m // 2).clamp_min(0)
    med = (srt.gather(-1, lo[..., None]) + srt.gather(-1, hi[..., None]))[..., 0] / 2.0
    return torch.where(m > 0, med, torch.ones_like(med)).detach()


def _batch(batch_ids: torch.Tensor, clip: ClipData, ps: PoseState, use_temporal: bool):
    """The frames (B, K), images (B, K, H, W, 3) and LossMeta of the pairs
    `batch_ids` (B,) of `clip.pair_idx`."""
    pair = clip.pair_idx[batch_ids]
    frames = torch.cat([pair, clip.neighbor_idx[batch_ids]], 1) if use_temporal else pair
    meta = LossMeta(
        extrinsics=ps.extrinsics[frames],
        intrinsics=ps.intrinsics[frames],
        flows=clip.flows[batch_ids],
        masks=clip.masks[batch_ids],
        warp=ps.warp[frames],
        flows_n=clip.flows_n[batch_ids] if use_temporal else None,
        masks_n=clip.masks_n[batch_ids] if use_temporal else None,
        valid_n=clip.valid_n[batch_ids] if use_temporal else None,
    )
    return frames, clip.images[frames], meta


def _train_mode_depth(net, images: torch.Tensor, frames: torch.Tensor, clip: ClipData,
                      ps: PoseState) -> torch.Tensor:
    """Train-mode MiDaS depth (B, K, H, W) of images (B, K, H, W, 3), times
    the scale maps, rescaled to the COLMAP reference where it is set."""
    b, k, h, w, _ = images.shape
    net.train()
    x = normalize_images(images.reshape(b * k, h, w, 3)).permute(0, 3, 1, 2).contiguous()
    depth = (1.0 / (net(x) + 1e-7)).reshape(b, k, h, w) * ps.scales[frames]
    if clip.ref_disp is not None:
        depth = depth * colmap_depth_scale(depth, clip.ref_disp[frames])[..., None, None]
    return depth


def train_step(net, optimizer: FlatAdam, loss_opt: LossParams,
               batch_ids: torch.Tensor, clip: ClipData, ps: PoseState,
               use_temporal: bool):
    """One fused train step (robust_cvd_tpu/training/fine_tune.py
    ::_make_step_body) on the pairs `batch_ids` (B,) of `clip.pair_idx`.

    Updates the net's parameters (through `optimizer`) and its BatchNorm
    running statistics in place, both only when the loss and every gradient
    are finite. Returns device tensors: the loss, the loss parts, and the
    guard flag. Nothing is read back to the host."""
    frames, images, meta = _batch(batch_ids, clip, ps, use_temporal)
    optimizer.zero_grad()
    depth = _train_mode_depth(net, images, frames, clip, ps)
    total, parts = losses.joint_loss(
        loss_opt, images, clip.depth_orig[frames], depth, meta,
        params=optimizer.leaf, params_init=optimizer.init,
    )
    total.backward()
    optimizer.check_aliasing()
    loss = total.detach()
    ok = optimizer.step(loss)
    commit_batch_stats(net, ok)
    return loss, {name: v.detach() for name, v in parts.items()}, ok


def eval_losses(net, flat: torch.Tensor, init: torch.Tensor, loss_opt: LossParams,
                batch_ids: torch.Tensor, clip: ClipData, ps: PoseState,
                use_temporal: bool):
    """Loss-only eval of the pairs `batch_ids` (B,) (the JAX package's
    _make_eval_body): each pair goes through the net in train mode with its
    own BatchNorm statistics, as if alone, and nothing is updated. Returns
    per-pair totals (B,) and parts {name: (B,)} on the device."""
    frames, images, meta = _batch(batch_ids, clip, ps, use_temporal)
    with torch.no_grad(), per_slice_batch_stats(net, len(batch_ids)):
        depth = _train_mode_depth(net, images, frames, clip, ps)
        return losses.pair_losses(
            loss_opt, images, clip.depth_orig[frames], depth, meta,
            params=flat, params_init=init,
        )


class FineTuner:
    """Epochs of train steps alternating with depth refreshes and pose
    solves (reference DepthFineTuner.fine_tune, depth_fine_tuning.py:311-631).

    With `pose` (the PoseOptimizer) and `out_dir` set, video.dat is written
    after every pose solve, the depth streams under the experiment dir after
    training, intermediate depth_e%04d[_opt] streams at
    save_intermediate_depth_streams_freq, checkpoints/%04d.pth at
    save_epoch_freq and the eval/ artifacts at val_epoch_freq. With
    recon=colmap, `pose_state_override` holds the fixed COLMAP geometry (on
    `device`) and no pose solve runs. `device` is where training runs ("cuda" unless the
    caller asks for "cpu"); `clip` and `pose_inputs` must live there."""

    def __init__(self, cfg: PipelineConfig, adapter, clip: ClipData,
                 pose_inputs: Optional[PoseOptInputs], seed: int = 0,
                 pose=None, out_dir: Optional[str] = None, mesh=None,
                 pose_state_override: Optional[PoseState] = None,
                 device="cuda", cudnn_tf32: bool = True):
        ft = cfg.ft
        if mesh is not None:
            raise NotImplementedError(
                "the data-parallel mesh fine-tune is not ported yet (multi-GPU slice)"
            )
        if cfg.recon == "colmap" and pose_state_override is None:
            raise ValueError(
                "recon=colmap requires a pose_state_override built from the "
                "COLMAP metadata npz (pipeline/process.py builds it)"
            )
        if ft.optimizer.lower() == "radam":
            raise NotImplementedError(
                "the RAdam optimizer is not ported yet (a later optimizer slice)"
            )
        if ft.optimizer.lower() != "adam":
            raise ValueError(f"unknown optimizer {ft.optimizer!r}")
        if ft.optimizer_mu_bf16:
            raise NotImplementedError(
                "a bf16 Adam first moment is not ported yet (a later optimizer slice)"
            )
        if cfg.post_filter:
            raise NotImplementedError(
                "the post filter is not ported yet (processor slice)"
            )
        self.cfg = cfg
        self.device = resolve_device(device)
        self.cudnn_tf32 = cudnn_tf32
        self.pose_state_override = pose_state_override
        self.adapter = adapter
        self.net = adapter.net.to(self.device)
        self.clip = clip
        self.pose_inputs = pose_inputs
        self.pose = pose
        self.out_dir = out_dir
        self.rng = np.random.default_rng(seed)

        lr = ft.learning_rate if ft.learning_rate > 0 else adapter.learning_rate
        self.optimizer = FlatAdam(list(self.net.named_parameters()), lr)
        self.use_temporal = (
            cfg.loss.lambda_smooth_disparity > 0
            or cfg.loss.lambda_smooth_reprojection > 0
            or cfg.loss.lambda_smooth_depth_ratio > 0
        )
        self.solver_params: Optional[SolverParams] = None
        self.pose_state: Optional[PoseState] = None
        self.current_depth: Optional[torch.Tensor] = None
        self.history: List[Dict] = []
        self.solve_log: List[Dict] = []
        self.stats: Dict[str, float] = {
            "pose_opt_s": 0.0, "train_steps_s": 0.0, "refresh_s": 0.0,
            "persist_io_s": 0.0,
        }
        self.writer = None
        # reference default: <experiment dir>/tensorboard
        # (depth_fine_tuning.py:386-395)
        tb_dir = ft.tensorboard_log_path or ft.log_dir
        if not tb_dir and out_dir is not None:
            tb_dir = pjoin(out_dir, "tensorboard")
        if ft.save_tensorboard and tb_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as e:
                print(f"fine-tune: no tensorboard logging ({e})")
            else:
                self.writer = SummaryWriter(tb_dir)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def train_step(self, batch_ids: torch.Tensor):
        with float32_precision(self.cudnn_tf32):
            return train_step(
                self.net, self.optimizer, self.cfg.loss, batch_ids, self.clip,
                self.pose_state, self.use_temporal,
            )

    def optimize_poses(self):
        """Cold solve the first time, warm re-solves after that
        (opt.warm_start); every LM solve is appended to `solve_log`."""
        t0 = time.perf_counter()
        self.solver_params = pose_opt.run(
            self.cfg.opt, self.pose_inputs, initial=self.solver_params,
            log=self.solve_log,
        )
        self.pose_state = pose_state_from_solver(
            self.solver_params, tuple(self.clip.images.shape[1:3]),
            self.pose_inputs.aspect, self.clip.depth_orig,
        )
        self._sync()
        dt = time.perf_counter() - t0
        self.stats["pose_opt_s"] += dt
        self.stats.setdefault("pose_opt_first_s", dt)
        if self.pose is not None:
            # camera state and video.dat after every solve (reference
            # pose_optimization.py:240 depth_video.save())
            t1 = time.perf_counter()
            self.pose.solver_params = self.solver_params
            self.pose.save()
            self.stats["persist_io_s"] += time.perf_counter() - t1

    def run(self, num_epochs: Optional[int] = None):
        ft = self.cfg.ft
        num_epochs = num_epochs or ft.num_epochs
        n_pairs = int(self.clip.pair_idx.shape[0])
        batch = max(1, min(ft.batch_size, n_pairs))
        inter_freq = ft.save_intermediate_depth_streams_freq
        persist = self.pose is not None and self.out_dir is not None

        @contextlib.contextmanager
        def persist_io():
            t = time.perf_counter()
            yield
            self.stats["persist_io_s"] += time.perf_counter() - t

        def save_current_depth():
            with persist_io():
                self.pose.save_depth_to_last_stream(self.current_depth.cpu().numpy())

        total_iters = 0
        # recon=colmap: the COLMAP poses stay fixed and the solver never
        # runs (reference depth_fine_tuning.py:357-368, 581-583)
        use_solver = self.cfg.recon == "i3d"
        if use_solver:
            self.optimize_poses()
        else:
            self.pose_state = self.pose_state_override
        if persist:
            # depth_e0000 with intermediate streams on, else the fine_tuned
            # stream at the experiment dir itself (reference
            # depth_fine_tuning.py:360-365)
            with persist_io():
                if inter_freq > 0:
                    self.pose.duplicate_last_depth_stream(
                        "e0000", pjoin(self.out_dir, "depth_e0000")
                    )
                else:
                    self.pose.duplicate_last_depth_stream("fine_tuned", self.out_dir)

        # validation at epoch 0, every val_epoch_freq epochs and after the
        # last (reference depth_fine_tuning.py:415-432, 622-627); a
        # frequency of 0 validates only at epoch 0 and after the last
        val_freq = ft.val_epoch_freq
        if val_freq >= 0:
            self.validate(0, 0)

        for epoch in range(num_epochs):
            t0 = time.perf_counter()
            order = torch.as_tensor(self.rng.permutation(n_pairs), device=self.device)
            losses_d, parts_d, oks = [], [], []
            # P // B full batches, then the remainder as one step (reference
            # DataLoader drop_last=False), as the JAX package groups them
            for s in range(0, n_pairs, batch):
                loss, parts, ok = self.train_step(order[s : s + batch])
                losses_d.append(loss)
                parts_d.append(parts)
                oks.append(ok)
            # the loop's one host sync: mean loss and skipped-step count
            mean_loss, skipped = torch.stack(
                [torch.stack(losses_d).mean(), (~torch.stack(oks)).sum().float()]
            ).tolist()
            dt = time.perf_counter() - t0
            self.stats["train_steps_s"] += dt
            self.stats.setdefault("train_first_epoch_s", dt)
            self.history.append({
                "epoch": epoch, "loss": mean_loss, "sec": dt, "steps": len(oks),
                "skipped": int(skipped), "host_syncs": 1,
            })
            print(f"fine-tune epoch {epoch}: loss {mean_loss:.6f}, {len(oks)} steps, "
                  f"{int(skipped)} skipped, 1 host sync in the train loop, {dt:.3f} s")
            if self.writer is not None:
                self._log_epoch(total_iters, batch, n_pairs, losses_d, parts_d)
            total_iters += n_pairs

            if val_freq > 0 and (epoch + 1) % val_freq == 0:
                self.validate(epoch + 1, total_iters)

            if ft.save_checkpoints and (epoch + 1) % max(1, ft.save_epoch_freq) == 0:
                ckpt_dir = pjoin(self.out_dir, "checkpoints") if self.out_dir else "checkpoints"
                self.save_checkpoint(ckpt_dir, epoch + 1)

            save_inter = inter_freq > 0 and (epoch + 1) % inter_freq == 0
            if save_inter:
                self.refresh_depth()
                if persist:
                    save_current_depth()

            if use_solver and (epoch + 1) % max(1, ft.pose_opt_freq) == 0:
                if persist and inter_freq > 0:
                    with persist_io():
                        self.pose.duplicate_last_depth_stream(
                            f"e{epoch:04d}_opt", pjoin(self.out_dir, f"depth_e{epoch:04d}_opt")
                        )
                if not save_inter:
                    self.refresh_depth()
                self.optimize_poses()
                if persist and save_inter:
                    save_current_depth()

            if persist and save_inter and epoch + 1 < num_epochs:
                with persist_io():
                    self.pose.duplicate_last_depth_stream(
                        f"e{epoch + 1:04d}", pjoin(self.out_dir, f"depth_e{epoch + 1:04d}")
                    )

        if val_freq == 0 or (val_freq > 0 and num_epochs % val_freq != 0):
            self.validate(num_epochs, total_iters)

        self.refresh_depth()
        if persist:
            save_current_depth()
        if self.writer is not None:
            self.writer.flush()
        return self.history

    def _log_epoch(self, iters0: int, batch: int, n_pairs: int, losses, parts):
        """Tensorboard summaries of one epoch, as the JAX package writes them
        (on the reference's running pair counter, depth_fine_tuning.py:
        542-551): per-step loss and part mean/max/min every print_freq
        pairs; when the epoch passes a multiple of display_freq, histograms
        of the last step's parts and the epoch's losses, and the image grid."""
        ft = self.cfg.ft
        losses = torch.stack(losses).cpu().numpy()
        parts = [{k: np.atleast_1d(v.cpu().numpy()) for k, v in p.items()} for p in parts]
        it, display_at = iters0, None
        for s, (lval, prow) in enumerate(zip(losses, parts)):
            it += min(batch, n_pairs - s * batch)
            if it % max(1, ft.print_freq) == 0:
                self.writer.add_scalar("Train/loss", float(lval), it)
                for k, arr in prow.items():
                    self.writer.add_scalar(f"Train/{k}/mean", float(arr.mean()), it)
                    self.writer.add_scalar(f"Train/{k}/max", float(arr.max()), it)
                    self.writer.add_scalar(f"Train/{k}/min", float(arr.min()), it)
            if it % max(1, ft.display_freq) == 0:
                display_at = it
        if display_at is not None:
            for k, v in parts[-1].items():
                self.writer.add_histogram(f"Train/{k}", v, display_at)
            self.writer.add_histogram("Train/batch_losses", losses, display_at)
            self._log_image_grid(display_at)

    def _log_image_grid(self, step: int):
        """Image, inverse depth and flow mask of the first training pair
        (reference depth_fine_tuning.py:120-191 image summaries)."""
        i = int(self.clip.pair_idx[0, 0])
        self.writer.add_image("Train/image", self.clip.images[i].cpu().numpy(), step,
                              dataformats="HWC")
        if self.current_depth is not None:
            inv = 1.0 / np.maximum(self.current_depth[i].cpu().numpy(), 1e-7)
            inv = inv / max(float(inv.max()), 1e-9)
            self.writer.add_image("Train/inv_depth", inv[None], step, dataformats="CHW")
        self.writer.add_image("Train/flow_mask", self.clip.masks[0, 0].cpu().numpy()[None],
                              step, dataformats="CHW")

    def eval_pair_losses(self) -> List[Dict]:
        """Per-pair loss breakdown (reference eval_and_save,
        depth_fine_tuning.py:633-860): every pair in order, in batches of
        batch_size on the device, read back once. Entries are
        {"pair": [i, j], "loss": total, <part>: value, ...}, parts in name
        order as the JAX package's scanned dict gives them."""
        n_pairs = int(self.clip.pair_idx.shape[0])
        batch = max(1, min(self.cfg.ft.batch_size, n_pairs))
        ids = torch.arange(n_pairs, device=self.device)
        totals, parts = [], []
        with float32_precision(self.cudnn_tf32):
            for s in range(0, n_pairs, batch):
                t, p = eval_losses(
                    self.net, self.optimizer.flat, self.optimizer.init, self.cfg.loss,
                    ids[s : s + batch], self.clip, self.pose_state, self.use_temporal,
                )
                totals.append(t)
                parts.append(p)
        names = sorted(parts[0])
        table = torch.stack(
            [torch.cat(totals)] + [torch.cat([p[k] for p in parts]) for k in names], 1
        ).cpu().numpy().astype(np.float64)
        pair_idx = self.clip.pair_idx.cpu().numpy()
        return [
            {"pair": [int(x) for x in pair_idx[q]],
             **{k: float(v) for k, v in zip(["loss"] + names, table[q])}}
            for q in range(n_pairs)
        ]

    def save_eval_json(self, out_dir: str, epoch: int):
        """eval_pair_losses as `loss_%04d.json` in `out_dir`."""
        import json

        os.makedirs(out_dir, exist_ok=True)
        with open(pjoin(out_dir, f"loss_{epoch:04d}.json"), "w") as f:
            json.dump(self.eval_pair_losses(), f, indent=1)

    def validate(self, epoch: int, niters: int):
        """Per-pair eval losses and artifacts (reference validate ->
        eval_and_save, depth_fine_tuning.py:415-432, 633-860). Without
        out_dir, returns eval_pair_losses(). Otherwise writes
        eval/loss_e%04d_iter%06d.json ({loss name: {"[i, j]": value},
        "mean": {loss name: mean}}), the eval depth images (.raw disparity
        and .png) with save_eval_images or at the first and last epoch, the
        depth-transform scale maps with save_depth_xform_maps, one
        scene-flow image a pair with save_scene_flow_vis, and prints the
        per-pair table; returns the loss dict."""
        import json

        from ..io import raw as raw_io
        from ..io.store import save_png_color, save_png_gray
        from ..utils.visualization import visualize_depth, visualize_scene_flow

        if self.out_dir is None:
            return self.eval_pair_losses()
        ft = self.cfg.ft
        eval_dir = pjoin(self.out_dir, "eval")
        os.makedirs(eval_dir, exist_ok=True)
        suf = f"_e{epoch:04d}_iter{niters:06d}"

        entries = self.eval_pair_losses()
        loss_dict: Dict[str, Dict[str, float]] = {}
        for e in entries:
            key = str(e["pair"])
            for name, val in e.items():
                if name != "pair":
                    loss_dict.setdefault(name, {})[key] = val
        loss_dict["mean"] = {
            name: float(np.mean(list(vals.values()))) for name, vals in loss_dict.items()
        }
        with open(pjoin(eval_dir, f"loss{suf}.json"), "w") as f:
            json.dump(loss_dict, f)
        if self.writer is not None:
            for name, mean in loss_dict["mean"].items():
                self.writer.add_scalar(f"validation/{name}", mean, epoch)

        depth = None
        if ft.save_eval_images or epoch in (0, ft.num_epochs):
            depth = self.infer_depth()
            disparity = (1.0 / depth.clamp_min(1e-7)).cpu().numpy()
            depth_np = depth.cpu().numpy()
            dmax = float(disparity.max())
            for i in range(depth_np.shape[0]):
                pre = pjoin(eval_dir, f"depth_{i:06d}{suf}")
                raw_io.save_raw_float32_image(pre + ".raw", disparity[i])
                save_png_color(
                    pre + ".png", visualize_depth(depth_np[i], depth_min=1.0 / max(dmax, 1e-7))
                )

        if ft.save_depth_xform_maps:
            scales = self.pose_state.scales.cpu().numpy()
            smax = float(scales.max())
            for i in range(scales.shape[0]):
                pre = pjoin(eval_dir, f"scale_{i:06d}{suf}")
                raw_io.save_raw_float32_image(pre + ".raw", scales[i])
                save_png_gray(
                    pre + ".png",
                    np.uint8(np.clip(scales[i] / max(smax, 1e-12), 0, 1) * 255),
                )

        if ft.save_scene_flow_vis:
            # ref->trg 3D scene flow of every pair (reference
            # depth_fine_tuning.py:653-737 save_scene_flow)
            if depth is None:
                depth = self.infer_depth()
            pair_idx = self.clip.pair_idx.cpu().numpy()
            for s, flow in self._scene_flow_chunks(depth * self.pose_state.scales):
                for q in range(flow.shape[0]):
                    i, j = (int(x) for x in pair_idx[s + q])
                    save_png_color(
                        pjoin(eval_dir, f"scene_flow_{i:06d}_{j:06d}{suf}.png"),
                        visualize_scene_flow(flow[q]),
                    )

        # stdout table (reference depth_fine_tuning.py:826-858)
        names = [n for n in loss_dict if n != "mean"]
        for e in entries:
            line = f"({e['pair'][0]:3d}, {e['pair'][1]:3d}): "
            line += ", ".join(f"{n}: {e.get(n, 0.0):10.6f}" for n in names)
            print(line)
        print("Mean:        "
              + ", ".join(f"{n}: {loss_dict['mean'][n]:10.6f}" for n in names))
        return loss_dict

    def _scene_flow_chunks(self, depth: torch.Tensor, chunk: int = 32):
        """(start, (B, H, W, 3) numpy) per chunk of pairs: the world-space
        displacement from each pixel of frame i to its flow match in frame
        j, both lifted through `depth` (N, H, W) and the pose state."""
        ps, clip = self.pose_state, self.clip
        h, w = depth.shape[1:]
        pix = geometry.pixel_grid((h, w), depth.device)
        for s in range(0, clip.pair_idx.shape[0], chunk):
            i, j = clip.pair_idx[s : s + chunk].unbind(1)
            pts_i = geometry.pixels_to_points(ps.intrinsics[i][:, None, None], depth[i], pix)
            world_i = geometry.points_cam_to_world(pts_i, ps.extrinsics[i][:, None, None])
            match = pix + clip.flows[s : s + chunk, 0]
            d_j = geometry.grid_sample(depth[j][..., None], match)[..., 0]
            pts_j = geometry.pixels_to_points(ps.intrinsics[j][:, None, None], d_j, match)
            world_j = geometry.points_cam_to_world(pts_j, ps.extrinsics[j][:, None, None])
            yield s, (world_j - world_i).cpu().numpy()

    def refresh_depth(self):
        """Re-infer the clip's depth with the current weights, then refresh
        the solver inputs: per-frame median depth and the constraints'
        source depths by nearest sampling, all on the device."""
        t0 = time.perf_counter()
        depth = self.infer_depth()
        n, h, w = depth.shape
        srt = depth.reshape(n, -1).sort(dim=1).values
        m = srt.shape[1]
        med = (srt[:, (m - 1) // 2] + srt[:, m // 2]) / 2  # jnp.median's midpoint
        inv_aspect = 1.0 / self.pose_inputs.aspect

        def samp(frames, loc):
            # NDC -> [0, 1] x [0, inv_aspect], then truncation toward zero
            u = (loc[..., 0] + 1) / 2
            v = (1 - loc[..., 1]) / 2 * inv_aspect
            x = torch.clamp((u * w).to(torch.int32), 0, w - 1).long()
            y = torch.clamp((v / inv_aspect * h).to(torch.int32), 0, h - 1).long()
            return depth[frames[:, None], y, x]

        data = self.pose_inputs.data
        self.pose_inputs = self.pose_inputs._replace(
            data=data._replace(
                depth0=samp(data.pair[:, 0], data.loc0),
                depth1=samp(data.pair[:, 1], data.loc1),
            ),
            median_depth=med,
        )
        self.current_depth = depth
        self._sync()
        self.stats["refresh_s"] += time.perf_counter() - t0

    def infer_depth(self, batch: int = 8) -> torch.Tensor:
        """Whole-clip eval-mode inference in chunks of `batch` frames, the
        last chunk padded by repeating its final frame (reference
        save_depth, depth_fine_tuning.py:227-294)."""
        images = self.clip.images
        n = images.shape[0]
        outs = []
        self.net.eval()
        with torch.no_grad(), float32_precision(self.cudnn_tf32):
            for s in range(0, n, batch):
                chunk = images[s : s + batch]
                pad = batch - chunk.shape[0]
                if pad:
                    chunk = torch.cat([chunk, chunk[-1:].expand(pad, -1, -1, -1)], 0)
                outs.append(depth_apply(self.net, chunk)[: batch - pad])
        return torch.cat(outs, 0)

    def save_checkpoint(self, ckpt_dir: str, epoch: int):
        """Model and optimizer state as torch `checkpoints/%04d.pth` (the
        reference's format, depth_fine_tuning.py:218-220, 568-573): the
        net's state dict (BatchNorm statistics included), mu, nu and the
        step count."""
        os.makedirs(ckpt_dir, exist_ok=True)
        opt = self.optimizer
        torch.save(
            {"state_dict": self.net.state_dict(), "mu": opt.mu, "nu": opt.nu,
             "count": opt.count},
            pjoin(ckpt_dir, f"{epoch:04d}.pth"),
        )

    def load_checkpoint(self, ckpt_dir: str, epoch: int):
        ck = torch.load(pjoin(ckpt_dir, f"{epoch:04d}.pth"), map_location=self.device,
                        weights_only=True)
        self.net.load_state_dict(ck["state_dict"])
        opt = self.optimizer
        opt.mu.copy_(ck["mu"])
        opt.nu.copy_(ck["nu"])
        opt.count.copy_(ck["count"])
        opt.check_aliasing()
