"""Adam over one flat parameter buffer (the fine-tune optimizer).

Port of the optimizer half of robust_cvd_tpu/training/fine_tune.py
(optax.adam, optax.radam and optax.adam(mu_dtype=bfloat16) at :486-494,
the initial-parameter copy at :511 and the non-finite guard at :288-307). The JAX package keeps parameters, gradients
and Adam state as pytrees; here they are flat float32 buffers on the
device, so one kernel launch (ops/adam.py) updates all of them:

- each parameter of the net becomes a view into `flat`, and each
  parameter's `.grad` a view into `grad`, assigned before the first
  backward. Autograd then accumulates every gradient in place into the one
  buffer, `zero_grad` is a single `zero_()`, and no per-step gather or
  copy exists. `check_aliasing` verifies (on the host, without a sync)
  that no view was replaced, and raises if one was.
- `leaf` is a second alias of `flat` that requires grad and whose `.grad`
  is `grad` too: the parameter loss differentiates through it and its
  gradient lands in the same buffer.
- the guard flag isfinite(loss) & isfinite(grad).all() stays on the
  device; the kernel skips the whole update when it is false and the step
  count advances by the flag, so a skipped step leaves parameters, moments
  and count (and, through the caller, BatchNorm statistics) unchanged, as
  optax's state is reverted in the JAX step.
- on a data mesh (parallel/mesh.py) `step` first replaces the gradient and
  the loss by their means over the ranks (the flat buffer makes the
  gradient one all-reduce), so the guard and the update see the global
  batch's, every rank takes or skips the same step, and replicas that
  start equal stay equal bit for bit.

The views are made on the net's current device; moving the net afterwards
would break them (`check_aliasing` catches that).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn as nn

from ..ops.adam import adam_update


class FlatAdam:
    """optax.adam(lr) with its defaults (b1 0.9, b2 0.999, eps 1e-8, bias
    correction on); with `rectified`, optax.radam(lr) (threshold 5); with
    `mu_bf16`, optax.adam(lr, mu_dtype=jnp.bfloat16): the first moment is a
    bfloat16 buffer. The two options exclude each other."""

    def __init__(self, named_params: List[Tuple[str, nn.Parameter]], lr: float,
                 rectified: bool = False, mu_bf16: bool = False, mesh=None):
        if rectified and mu_bf16:
            raise ValueError("optax.radam has no bf16 first moment")
        if not named_params:
            raise ValueError("no parameters to optimize")
        device = named_params[0][1].device
        dtype = named_params[0][1].dtype
        self.names = [n for n, _ in named_params]
        self.params = [p for _, p in named_params]
        self.shapes = [p.shape for p in self.params]
        self.offsets = []
        n = 0
        for p in self.params:
            if p.device != device or p.dtype != dtype:
                raise ValueError("FlatAdam needs parameters of one type on one device")
            self.offsets.append(n)
            n += p.numel()
        self.numel = n
        self.lr = lr
        self.rectified = rectified
        self.mesh = mesh

        self.flat = torch.empty(n, dtype=dtype, device=device)
        self.grad = torch.zeros(n, dtype=dtype, device=device)
        with torch.no_grad():
            for p, v in zip(self.params, self.views(self.flat)):
                v.copy_(p)
        for p, v, gv in zip(self.params, self.views(self.flat), self.views(self.grad)):
            p.data = v
            p.grad = gv
        self.init = self.flat.clone()
        self.mu = torch.zeros_like(self.flat, dtype=torch.bfloat16 if mu_bf16 else dtype)
        self.nu = torch.zeros_like(self.flat)
        self.count = torch.zeros((), dtype=torch.int32, device=device)
        self.leaf = self.flat.detach().requires_grad_(True)
        self.leaf.grad = self.grad
        self._ptrs = [v.data_ptr() for v in self.views(self.flat)]
        self._grad_ptrs = [v.data_ptr() for v in self.views(self.grad)]

    def views(self, buf: torch.Tensor) -> List[torch.Tensor]:
        """Per-parameter views (in parameter order) of a flat buffer."""
        return [buf[o : o + s.numel()].view(s) for o, s in zip(self.offsets, self.shapes)]

    def named_views(self, buf: torch.Tensor) -> Dict[str, torch.Tensor]:
        return dict(zip(self.names, self.views(buf)))

    def zero_grad(self) -> None:
        self.grad.zero_()

    def check_aliasing(self) -> None:
        """Raise unless every parameter and gradient still lives in the flat
        buffers (a `.to()`, `load_state_dict(assign=True)` or a
        `.grad = None` would silently detach it)."""
        for name, p, ptr, gptr in zip(self.names, self.params, self._ptrs, self._grad_ptrs):
            if p.data_ptr() != ptr or p.grad is None or p.grad.data_ptr() != gptr:
                raise RuntimeError(f"parameter {name} no longer aliases the flat buffers")
        if self.leaf.grad is None or self.leaf.grad.data_ptr() != self.grad.data_ptr():
            raise RuntimeError("the parameter-loss leaf no longer aliases the flat gradient")

    def step(self, loss: torch.Tensor) -> torch.Tensor:
        """Guarded update from the accumulated `grad`; returns the device
        bool flag (True: the step was taken). On a mesh, `grad` and `loss`
        (this rank's) are replaced in place by their means over the ranks
        first."""
        if self.mesh is not None:
            self.mesh.all_reduce_mean_(self.grad)
            self.mesh.all_reduce_mean_(loss)
        ok = torch.isfinite(loss) & torch.isfinite(self.grad).all()
        adam_update(self.flat, self.grad, self.mu, self.nu, self.count, ok, self.lr,
                    rectified=self.rectified)
        self.count += ok.to(torch.int32)
        return ok
