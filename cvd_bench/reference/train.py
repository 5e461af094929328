"""Plain train steps of the depth fine-tune (the reference code's
depth_fine_tuning.py train loop with optax.adam's update): the initial
depth in eval mode, then per step the train-mode forward with batch
statistics, the depth-transform scales, the joint loss, the backward and
an Adam step with bias correction, skipped where the loss or a gradient is
not finite.

Returns what the comparison reads: each step's loss, each parameter's
gradient norm at the first step and its change after the last step, by
state-dict name.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List

import torch

from .. import weights
from . import losses, midas


@contextlib.contextmanager
def precision(kind: str, device):
    """"float32": full float32 (no TF32 in matrix products or cuDNN);
    "bfloat16": the same under bf16 autocast (the control)."""
    old = torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32
    torch.set_float32_matmul_precision("highest")
    torch.backends.cudnn.allow_tf32 = False
    try:
        if kind == "bfloat16":
            with torch.autocast(device_type=torch.device(device).type, dtype=torch.bfloat16):
                yield
        elif kind == "float32":
            yield
        else:
            raise ValueError(kind)
    finally:
        torch.set_float32_matmul_precision(old[0])
        torch.backends.cudnn.allow_tf32 = old[1]


def steps(model: Dict, seed: int, images, pairs, flows, masks, pose, batches: List[List[int]],
          loss_opt: Dict, lr: float, kind: str = "float32", eval_batch: int = 8,
          half_batch: bool = False) -> Dict:
    """`batches` are lists of pair ids; `pairs` (P, 2) frame ids; images
    (N, H, W, 3); flows (P, 2, H, W, 2); masks (P, 2, H, W); pose =
    (extrinsics (N, 3, 4), intrinsics (N, 4), scales (N, H, W), warp
    (N, H, W, 2)). All on one device. `half_batch` plants a fault for the
    limits' upper readings: each step takes the first half of its batch
    only."""
    losses.check_supported(loss_opt)
    device = images.device
    with torch.device(device):
        net = midas.MidasNet(model["features"], model["backbone_layers"])
    weights.seed_midas_(net, seed)
    ext, intr, scales, warp = pose
    frames_used = sorted({int(f) for b in batches for q in b for f in pairs[q].tolist()})

    with precision(kind, device):
        net.eval()
        depth0 = {}
        with torch.no_grad():
            for s in range(0, len(frames_used), eval_batch):
                ids = frames_used[s : s + eval_batch]
                for f, d in zip(ids, midas.depth(net, images[ids]).float()):
                    depth0[f] = d

        params = dict(net.named_parameters())
        init = {k: p.detach().clone() for k, p in params.items()}
        mu = {k: torch.zeros_like(p) for k, p in params.items()}
        nu = {k: torch.zeros_like(p) for k, p in params.items()}
        b1, b2, eps = 0.9, 0.999, 1e-8
        count = 0
        out_losses, grad1 = [], None
        net.train()
        for ids in batches:
            if half_batch:
                ids = ids[: max(1, len(ids) // 2)]
            fr = pairs[ids]  # (B, 2)
            b = fr.shape[0]
            d = midas.depth(net, images[fr.reshape(-1)]).float().reshape(b, 2, *images.shape[1:3])
            d = d * scales[fr]
            d0 = torch.stack([torch.stack([depth0[int(f)] for f in row]) for row in fr.tolist()])
            loss = losses.joint(None, d0, d, ext[fr], intr[fr], warp[fr], flows[ids], masks[ids],
                                loss_opt)
            net.zero_grad(set_to_none=False)
            loss.backward()
            grads = {k: torch.zeros_like(p) if p.grad is None else p.grad.detach().float()
                     for k, p in params.items()}
            ok = bool(torch.isfinite(loss)) and all(bool(torch.isfinite(g).all()) for g in grads.values())
            out_losses.append(float(loss.detach()))
            if grad1 is None:
                grad1 = {k: float(torch.linalg.vector_norm(g)) for k, g in grads.items()}
            if not ok:
                continue
            count += 1
            with torch.no_grad():
                for k, p in params.items():
                    g = grads[k]
                    mu[k].mul_(b1).add_((1 - b1) * g)
                    nu[k].mul_(b2).add_((1 - b2) * g * g)
                    mhat = mu[k] / (1 - b1 ** count)
                    vhat = nu[k] / (1 - b2 ** count)
                    p.sub_(lr * mhat / (torch.sqrt(vhat) + eps))
        change = {k: float(torch.linalg.vector_norm(p.detach() - init[k])) for k, p in params.items()}
    return {"losses": out_losses, "grad_norms": grad1, "change_norms": change}
