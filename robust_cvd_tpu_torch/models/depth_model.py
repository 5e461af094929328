"""The depth-model contract (reference monodepth/depth_model.py::DepthModel):
a net maps (B, 3, H, W) to (B, H, W) disparity and carries its own input
normalisation (`net.normalize`); `disparity` is every caller's forward."""

from __future__ import annotations

import torch
import torch.nn as nn

from ..device import float32_precision


def disparity(net: nn.Module, images: torch.Tensor) -> torch.Tensor:
    """The net's disparity (B, H, W) of images (B, H, W, 3) in [0, 1]."""
    return net(net.normalize(images).permute(0, 3, 1, 2).contiguous())


def disparity_to_depth(disparity: torch.Tensor, epsilon: float = 1e-7) -> torch.Tensor:
    """(reference midas_v2_model.py:60-62)."""
    return 1.0 / (disparity + epsilon)


def depth_apply(net: nn.Module, images: torch.Tensor) -> torch.Tensor:
    """images (B, H, W, 3) in [0, 1] -> depth (B, H, W), in the net's mode."""
    return disparity_to_depth(disparity(net, images))


class DepthModel:
    """A subclass sets the requirements the CLI resolves from (reference
    params.py:245-255), its checkpoint under `<clip>/models/` or in
    `$checkpoint_env`, `new_net`, and `matmul_tf32` where TF32 suits it."""

    align: int
    learning_rate: float
    lambda_view_baseline: float
    checkpoint: str
    checkpoint_env: str
    matmul_tf32 = False

    def __init__(self, net: nn.Module | None = None):
        self.net = self.new_net() if net is None else net

    @staticmethod
    def new_net() -> nn.Module:
        raise NotImplementedError

    @staticmethod
    def read_checkpoint(path: str) -> dict[str, torch.Tensor]:
        """The state dict, bare or under "state_dict" or MiDaS v3's "model"."""
        sd = torch.load(path, map_location="cpu", weights_only=True)
        for key in ("state_dict", "model"):
            sd = sd.get(key, sd)
        return {k.removeprefix("module."): v for k, v in sd.items()}

    @classmethod
    def from_checkpoint(cls, path: str):
        net = cls.new_net()
        net.load_state_dict(cls.read_checkpoint(path))
        return cls(net)

    def precision(self, cudnn_tf32: bool):
        """The one TF32 rule: matrix products only with `matmul_tf32`."""
        return float32_precision(cudnn_tf32, cudnn_tf32 and self.matmul_tf32)

    def estimate_depth(self, images: torch.Tensor, scales=None) -> torch.Tensor:
        """images (B, H, W, 3) in [0, 1] -> depth (B, H, W) in eval mode, at
        the caller's cuDNN TF32 setting; `scales` divides the disparity."""
        training = self.net.training
        self.net.eval()
        try:
            with torch.no_grad(), self.precision(torch.backends.cudnn.allow_tf32):
                d = disparity(self.net, images)
                return disparity_to_depth(d if scales is None else d / scales)
        finally:
            self.net.train(training)
