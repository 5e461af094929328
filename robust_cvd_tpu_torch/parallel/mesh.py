"""The data-parallel mesh: torch.distributed, one process per rank.

Port of robust_cvd_tpu/parallel/mesh.py. The JAX package shards the
pipeline's batch axes over the devices of one program (a "data" mesh);
here each rank is a process of its own, launched by torchrun

    torchrun --standalone --nproc_per_node N -m robust_cvd_tpu_torch --path <clip>

or by a caller that passes `init_mesh` an init method, rank and size. The
pipeline uses the mesh where the JAX package does: the initial depth's
frames, the flow stage's pairs, Mask R-CNN's frames, the fine-tune's
batches (training/fine_tune.py: the global batch of batch_size pairs a
rank, BatchNorm statistics, loss and gradient over all of it) and the pose
solve's constraints (`shard_pose_inputs`: every rank solves on its share
of the pairs and triplets, solver/lm.py sums the normal equations over the
ranks). Parameters are replicated: every rank holds the whole net and the
whole SolverParams and takes the same steps.

Devices are explicit: `cuda:LOCAL_RANK` where every local rank has a card
of its own, with the `nccl` backend; the CPU with `gloo`. Ranks that share
a card (more local ranks than cards) need `backend="gloo"` from the caller
(NCCL refuses two ranks on one card); asking for `nccl` there, or for it
on the CPU, raises. Nothing switches backend or device on its own.

`pipeline_mesh()` is None unless `init_mesh` made a group of more than one
rank, so one process runs the single-device paths unchanged.

`Mesh.stats` counts the collectives and the host seconds spent in them
(from the call to its return: with gloo a call on a CUDA tensor first
waits for the work queued before it).
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import time
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

# The mesh init_mesh made in this process: torch.distributed's default
# group is process-wide, and so is its record here.
_MESH: Optional["Mesh"] = None


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks whose backward sums the gradients over the ranks
    too: the derivative of a global statistic for every rank's share."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        out = t.clone()
        with mesh.timed():
            dist.all_reduce(out, group=mesh.group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        with ctx.mesh.timed():
            dist.all_reduce(grad, group=ctx.mesh.group)
        return grad, None


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the data mesh: its rank, the number of ranks,
    the device it computes on and its process group (None: the default
    group)."""

    rank: int
    size: int
    device: torch.device
    group: Optional[dist.ProcessGroup] = None
    stats: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {"collectives": 0, "collective_s": 0.0}, compare=False)

    @contextlib.contextmanager
    def timed(self):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stats["collectives"] += 1
            self.stats["collective_s"] += time.perf_counter() - t0

    def shard(self, n: int) -> List[int]:
        """This rank's indices of n items: the items padded to a multiple
        of the size with copies of item 0 (the JAX package's _pad_leading),
        then cut into equal contiguous slices, one a rank."""
        per = -(-n // self.size)
        return [k if k < n else 0 for k in range(self.rank * per, (self.rank + 1) * per)]

    def share(self, items: Sequence) -> list:
        """This rank's slice of `items` in shard's cut, without the padding
        (possibly empty): the work a rank does when each item is its own."""
        per = -(-len(items) // self.size)
        return list(items[self.rank * per : (self.rank + 1) * per])

    def all_gather_leading(self, x: torch.Tensor, n: int) -> torch.Tensor:
        """Every rank's `shard(n)` result x (per, ...) concatenated in rank
        order, the padding cut off: (n, ...) on x's device on every rank.
        The gather runs where the backend works: gloo on the host (it
        carries a CUDA tensor through the host either way), nccl on the
        mesh's card."""
        via = torch.device("cpu") if dist.get_backend(self.group) == "gloo" else self.device
        local = x.contiguous().to(via)
        parts = [torch.empty_like(local) for _ in range(self.size)]
        with self.timed():
            dist.all_gather(parts, local, group=self.group)
        return torch.cat(parts, 0)[:n].to(x.device)

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of t over the ranks, differentiable (its backward sums
        the incoming gradients over the ranks)."""
        return _AllReduceSum.apply(t, self)

    def all_reduce_sum_(self, t: torch.Tensor) -> torch.Tensor:
        """t replaced in place by its sum over the ranks; every rank gets
        the same bits."""
        with self.timed():
            dist.all_reduce(t, group=self.group)
        return t

    def all_reduce_mean_(self, t: torch.Tensor) -> torch.Tensor:
        """t replaced in place by its mean over the ranks; every rank gets
        the same bits."""
        return self.all_reduce_sum_(t).div_(self.size)

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """t replaced in place by rank `src`'s."""
        with self.timed():
            dist.broadcast(t, group=self.group, group_src=src)
        return t

    def barrier(self) -> None:
        nccl = self.device.type == "cuda" and dist.get_backend(self.group) == "nccl"
        with self.timed():
            dist.barrier(group=self.group, device_ids=[self.device.index] if nccl else None)


def _shard_rows(rows, mesh: Mesh):
    """This rank's block of a NamedTuple of row-aligned tensors (a
    ConstraintData or TripletData), the pad rows' weight set to 0."""
    n = int(rows.weight.shape[0])
    dev = rows.weight.device
    idx = torch.as_tensor(mesh.shard(n), device=dev)
    out = type(rows)(*[t[idx] for t in rows])
    pad = torch.arange(idx.numel(), device=dev) + mesh.rank * idx.numel() >= n
    return out._replace(weight=out.weight.masked_fill(pad[:, None], 0.0))


def shard_pose_inputs(inputs, mesh: Mesh):
    """This rank's share of a solver problem (the JAX package's
    shard_pose_inputs): the constraint pairs (P) and triplets (T) padded
    to a multiple of the mesh size with copies of row 0 whose weight is 0
    (a skipped constraint, reference lib/PoseOptimizer.cpp:1177-1193),
    then cut into the contiguous blocks of `Mesh.shard`; the per-frame
    tensors stay whole. The result records the mesh (`inputs.mesh`), so
    that pose_opt sums the ranks' residual products."""
    trip = inputs.triplets
    return inputs._replace(
        data=_shard_rows(inputs.data, mesh),
        triplets=None if trip is None else _shard_rows(trip, mesh),
        mesh=mesh,
    )


def is_writer(mesh: Optional[Mesh]) -> bool:
    """Whether this process writes the shared outputs: rank 0, or the one
    process of a run without a mesh."""
    return mesh is None or mesh.rank == 0


def barrier(mesh: Optional[Mesh]) -> None:
    """Wait for every rank; nothing without a mesh."""
    if mesh is not None:
        mesh.barrier()


def init_mesh(backend: Optional[str] = None, device=None, init_method: Optional[str] = None,
              rank: Optional[int] = None, world_size: Optional[int] = None,
              timeout_s: Optional[float] = None) -> Mesh:
    """Initialise torch.distributed's default group and return this rank's
    Mesh. Rank and size come from torchrun's RANK, WORLD_SIZE, LOCAL_RANK
    and LOCAL_WORLD_SIZE (init method env://) unless the caller passes
    them with an init method (a file:// store in tests). The device is
    `device`, else cuda:LOCAL_RANK (modulo the card count) where CUDA is
    available, else the CPU; the backend is `backend`, else nccl on a card
    that is the rank's own and gloo on the CPU. Raises ValueError for nccl
    on the CPU or on a card shared by several local ranks."""
    global _MESH
    if dist.is_initialized():
        raise RuntimeError("torch.distributed is initialised already")
    env = os.environ
    rank = int(env["RANK"]) if rank is None else rank
    world_size = int(env["WORLD_SIZE"]) if world_size is None else world_size
    local_rank = int(env.get("LOCAL_RANK", rank))
    local_size = int(env.get("LOCAL_WORLD_SIZE", world_size))
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if device is None:
        device = f"cuda:{local_rank % cards}" if cards else "cpu"
    device = torch.device(device)
    if device.type == "cuda":
        if not cards:
            raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
        if device.index is None:
            device = torch.device("cuda", local_rank % cards)
        shared = local_size > cards
        if backend is None:
            if shared:
                raise ValueError(
                    f"{local_size} local ranks share {cards} card(s): NCCL needs a card a "
                    "rank, so pass backend='gloo' to run them over gloo")
            backend = "nccl"
        if backend == "nccl" and shared:
            raise ValueError(f"nccl refuses {local_size} local ranks on {cards} card(s); "
                             "pass backend='gloo'")
        torch.cuda.set_device(device)
    elif backend is None:
        backend = "gloo"
    elif backend == "nccl":
        raise ValueError("nccl runs on cards only; the CPU takes backend='gloo'")
    kwargs = {} if timeout_s is None else {"timeout": datetime.timedelta(seconds=timeout_s)}
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                            world_size=world_size, **kwargs)
    _MESH = Mesh(rank=rank, size=world_size, device=device)
    return _MESH


def destroy_mesh() -> None:
    """Tear down the group init_mesh made (nothing if there is none)."""
    global _MESH
    if dist.is_initialized():
        dist.destroy_process_group()
    _MESH = None


def pipeline_mesh() -> Optional[Mesh]:
    """The pipeline's rule in one place, as the JAX package's: the mesh
    when init_mesh made a group of more than one rank, else None (the
    single-device paths)."""
    if _MESH is not None and _MESH.size > 1 and dist.is_initialized():
        return _MESH
    return None
