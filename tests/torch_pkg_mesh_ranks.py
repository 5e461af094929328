"""The ranks of tests/test_torch_pkg_mesh.py: functions that a spawned
process runs as one rank of a CPU data mesh (gloo over a file:// store),
each leaving its results in a .npz file for the test to read. They import
only torch, numpy and the port, so that a rank starts without JAX."""

import os

import numpy as np
import torch

from robust_cvd_tpu_torch.parallel.mesh import Mesh, destroy_mesh, init_mesh


def _init(rank: int, size: int, store_file: str) -> Mesh:
    torch.set_num_threads(1)
    return init_mesh(device="cpu", init_method=f"file://{store_file}", rank=rank,
                     world_size=size, timeout_s=300)


def gather_rank(rank: int, size: int, store_file: str, out_dir: str, counts) -> None:
    """For every group of the first k ranks (k = 1..size) and every n of
    `counts`: this rank's shard of n items (item i is 10 i + 1) gathered
    with all_gather_leading, saved by the group's members."""
    import torch.distributed as dist

    _init(rank, size, store_file)
    try:
        out = {}
        for k in range(1, size + 1):
            group = dist.new_group(list(range(k)))
            if rank >= k:
                continue
            mesh = Mesh(rank=rank, size=k, device=torch.device("cpu"), group=group)
            for n in counts:
                items = torch.arange(n, dtype=torch.float32) * 10 + 1
                mine = items[mesh.shard(n)][:, None].repeat(1, 3)
                out[f"k{k}_n{n}"] = mesh.all_gather_leading(mine, n).numpy()
        np.savez(os.path.join(out_dir, f"gather_rank{rank}.npz"), **out)
    finally:
        destroy_mesh()


def slice_rank(rank: int, size: int, store_file: str, clip: str, out_dir: str, opt: dict,
               ft: dict) -> None:
    """One rank of the mesh run on the slice clip `clip` (shared by the
    ranks): compute_initial_depth, the flow masks and pair stats, then
    DatasetProcessor.fine_tune with the small MiDaS net of
    tests/test_torch_pkg_finetune.py. Then the guard: a step in which this
    rank's loss alone is non-finite (rank 1's masks set to inf), and a
    FlatAdam step in which only rank 1 passes an infinite loss, must be
    skipped by every rank. Saves the flat parameters, the BatchNorm
    buffers, the epochs' losses, the guard's flags and (rank 0) the
    poses."""
    from robust_cvd_tpu_torch import config
    from robust_cvd_tpu_torch.io.store import VideoStore
    from robust_cvd_tpu_torch.models import midas
    from robust_cvd_tpu_torch.pipeline.depth import compute_initial_depth
    from robust_cvd_tpu_torch.pipeline.flow import FlowStage
    from robust_cvd_tpu_torch.pipeline.process import DatasetProcessor
    from robust_cvd_tpu_torch.utils.frame_sampling import sample_pairs

    _init(rank, size, store_file)
    try:
        net = midas.seeded_init_(midas.MidasNet(features=32, backbone_layers=(1, 1, 1, 1)), 0)
        adapter = midas.MidasV2Adapter(net)
        store = VideoStore.open(clip)
        depth = compute_initial_depth(store, adapter, "midas2", device="cpu")
        pairs = sample_pairs(store.num_frames, ("hierarchical2",), two_way=True)
        stage = FlowStage(store, device="cpu")
        stage.compute_flow_masks(pairs)
        stage.compute_flow_pair_stats(pairs)
        cfg = config.PipelineConfig(path=clip, opt=config.PoseOptParams(**opt),
                                    ft=config.FineTuneParams(**ft))
        tuner = DatasetProcessor(cfg, models={"depth": adapter}, device="cpu").fine_tune(
            store, depth)

        opt_ = tuner.optimizer
        flat, count = opt_.flat.clone(), int(opt_.count)
        order = torch.arange(int(tuner.clip.pair_idx.shape[0]))
        _, ids = tuner.epoch_batches(order)[0]
        clip_data = tuner.clip
        if rank == 1:
            tuner.clip = clip_data._replace(masks=torch.full_like(clip_data.masks, torch.inf))
        # rank 0's data are untouched and its local loss finite
        loss, _, ok_step = tuner.train_step(ids)
        tuner.clip = clip_data
        opt_.grad.zero_()
        ok_adam = opt_.step(torch.tensor(torch.inf if rank == 1 else 1.0))
        np.savez(
            os.path.join(out_dir, f"rank{rank}.npz"),
            flat=flat.numpy(), count=count,
            buffers=torch.cat([b.reshape(-1).double() for b in net.buffers()]).numpy(),
            losses=np.array([h["loss"] for h in tuner.history]),
            skipped=np.array([h["skipped"] for h in tuner.history]),
            steps=np.array([h["steps"] for h in tuner.history]),
            guard=np.array([bool(ok_step), bool(ok_adam), torch.equal(opt_.flat, flat),
                            int(opt_.count) == count, bool(torch.isfinite(loss))]),
            pose=(tuner.solver_params.pose.numpy() if rank == 0 else np.zeros(0)),
            current_depth=tuner.current_depth.numpy(),
        )
    finally:
        destroy_mesh()
