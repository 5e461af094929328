"""Stage `flow`: the port's flow stage (FlowStage.compute_flow) one chunk
of pairs a call, cycling through the clip's hierarchical2 pairs: PNG loads
of color_flow, the homography registration (corner kernel), RAFT, the
un-warp and resize to color_down, and the flow files written.

Set-up writes the clip under TMPDIR (color_flow PNGs at the
configuration's flow size, color_down .raw, frames.txt), builds RAFT with
seeded weights on the card and warms up one chunk. compute_flow skips flows
that exist, so each pass over the pairs writes into a fresh store
directory that links the clip's inputs; the first pass's directory is kept
for the check, later ones are deleted when they finish.

Compared: `flow_px`, the largest |port - reference| of a flow vector
component in pixels of color_down over a sample of the first pass's pairs
drawn from the seed, against the plain float32 reference
(reference/registration.py, reference/raft.py) on the same PNGs and
weights; a pair whose file never came reads as not finite (1e30).
"""

from __future__ import annotations

import os
import shutil
import struct
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

from .. import clip as bench_clip
from .. import weights
from ..core import Check
from ..reference import raft as ref_raft
from ..reference import registration as ref_reg

RAW_HEADER = struct.Struct("<iiiQ")
ENCODE_THREADS = 8
FAULT_SHIFT_PX = 0.5  # the planted fault of the control readings


class State:
    pass


def _sync(device):
    if device == "cuda":
        torch.cuda.synchronize()


def write_raw(path, img: np.ndarray) -> None:
    """float32 (H, W, C) in the pipeline's .raw container."""
    img = np.ascontiguousarray(img, np.float32)
    h, w, c = img.shape
    with open(path, "wb") as f:
        f.write(RAW_HEADER.pack(h, w, 5 + ((c - 1) << 3), 4 * c))
        f.write(img.tobytes())


def read_raw(path) -> np.ndarray:
    with open(path, "rb") as f:
        h, w, cvt, _ = RAW_HEADER.unpack(f.read(RAW_HEADER.size))
        data = np.frombuffer(f.read(), np.float32)
    return data.reshape(h, w, (cvt >> 3) + 1)


def load_png(path) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), np.float32) / 255.0


def write_clip(base: str, cfg: dict, shift: int, seed: int) -> None:
    """color_flow PNGs of a seeded pan at the flow size, color_down .raw at
    the training size (an antialiased resize of the same frames) and
    frames.txt of a 30 fps source."""
    from PIL import Image

    n = cfg["clip"]["frames"]
    fh, fw = cfg["clip"]["flow_hw"]
    dh, dw = cfg["clip"]["down_hw"]
    sh, sw = cfg["clip"]["source_hw"]
    frames = bench_clip.panning_frames(n, fh, fw, shift, seed)
    os.makedirs(os.path.join(base, "color_flow"))
    os.makedirs(os.path.join(base, "color_down"))
    u8 = np.clip(frames * 255.0 + 0.5, 0, 255).astype(np.uint8)
    down = F.interpolate(torch.from_numpy(u8.astype(np.float32) / 255.0).permute(0, 3, 1, 2),
                         size=(dh, dw), mode="bilinear", align_corners=False,
                         antialias=True).permute(0, 2, 3, 1).numpy()

    def save(i):
        Image.fromarray(u8[i], mode="RGB").save(
            os.path.join(base, "color_flow", f"frame_{i:06d}.png"))
        write_raw(os.path.join(base, "color_down", f"frame_{i:06d}.raw"), down[i])

    # PIL encodes without the interpreter lock: the PNGs in parallel
    with ThreadPoolExecutor(ENCODE_THREADS) as pool:
        list(pool.map(save, range(n)))
    with open(os.path.join(base, "frames.txt"), "w") as f:
        f.write("\n".join([str(n), str(sw), str(sh)] + [repr(i / 30) for i in range(n)]) + "\n")


def setup(ctx):
    from robust_cvd_tpu_torch.models.raft import RAFT

    cfg, mix, dev = ctx.config, ctx.mix, ctx.device
    st = State()
    st.ctx = ctx
    os.makedirs(ctx.tmpdir, exist_ok=True)
    st.root = tempfile.mkdtemp(prefix="cvd_bench_flow_", dir=ctx.tmpdir)
    st.clip_dir = os.path.join(st.root, "clip")
    t0 = time.perf_counter()
    write_clip(st.clip_dir, cfg, mix["shift_px"], ctx.seed)
    ctx.say(f"setup: clip of {cfg['clip']['frames']} frames written in "
            f"{time.perf_counter() - t0:.3f} s")
    r = cfg["raft"]
    with torch.device(dev):
        st.model = RAFT(iters=r["iters"], corr_levels=r["corr_levels"],
                        corr_radius=r["corr_radius"], hidden_dim=r["hidden_dim"],
                        context_dim=r["context_dim"])
    weights.seed_raft_(st.model, ctx.seed)
    st.pairs = bench_clip.hierarchical2_pairs(cfg["clip"]["frames"])
    st.batch = cfg["flow"]["batch_size"]
    st.chunks = [st.pairs[s : s + st.batch] for s in range(0, len(st.pairs), st.batch)]
    st.passes = 0
    st.next_chunk = 0
    st.stage = None
    st.pass_dir = None
    st.first_pass_dir = None
    st.first_pass_done = []
    st.stats = {"load_s": 0.0, "chunk_s": 0.0, "write_s": 0.0}
    st.units = 0
    st.pairs_done = 0
    st.unit_ends = []  # each chunk's end, seconds after the first began
    # warm-up: one chunk through a throwaway store (every chunk is padded
    # to the batch's shape, so this is the only shape)
    t0 = time.perf_counter()
    _new_pass(st, warm=True)
    st.stage.compute_flow(st.chunks[0])
    _sync(dev)
    shutil.rmtree(st.pass_dir)
    st.stage = st.pass_dir = None
    ctx.say(f"setup: warm-up chunk {time.perf_counter() - t0:.3f} s")
    return st


def _new_pass(st, warm=False):
    from robust_cvd_tpu_torch.io.store import VideoStore
    from robust_cvd_tpu_torch.pipeline.flow import FlowStage

    name = "warm" if warm else f"pass{st.passes:04d}"
    d = os.path.join(st.root, name)
    os.makedirs(d)
    for item in ("color_flow", "color_down", "frames.txt"):
        os.symlink(os.path.join(st.clip_dir, item), os.path.join(d, item))
    st.pass_dir = d
    st.stage = FlowStage(VideoStore.open(d), st.model, batch_size=st.batch,
                         homography=st.ctx.config["flow"]["homography"], device=st.ctx.device)


def _end_pass(st):
    for k in st.stats:
        st.stats[k] += st.stage.stats.get(k, 0.0)
    if st.first_pass_dir is None:
        st.first_pass_dir = st.pass_dir
    else:
        shutil.rmtree(st.pass_dir)
    st.stage = st.pass_dir = None
    st.passes += 1


def unit(st):
    """compute_flow over the next chunk of pairs."""
    if st.stage is None:
        _new_pass(st)
    chunk = st.chunks[st.next_chunk]
    if not st.units:
        st.t_first = time.perf_counter()
    st.stage.compute_flow(chunk)
    st.unit_ends.append(time.perf_counter() - st.t_first)
    if st.passes == 0:
        st.first_pass_done.extend(chunk)
    st.units += 1
    st.pairs_done += len(chunk)
    st.next_chunk += 1
    if st.next_chunk == len(st.chunks):
        st.next_chunk = 0
        _end_pass(st)


def min_units(st):
    return 1


def close_window(st):
    if st.stage is not None:
        for k in st.stats:
            st.stats[k] += st.stage.stats.get(k, 0.0)
        st.stage.stats = {}
        if st.first_pass_dir is None:
            st.first_pass_dir = st.pass_dir


def counters(st):
    return {"pairs": st.pairs_done, "chunks": st.units, **st.stats}


def attempted_failed(st):
    return st.pairs_done, 0


def report(st):
    """The window's pairs, chunks and stage times, and each chunk's end
    (the pace through the window)."""
    return [f"flow: {st.pairs_done} pairs in {st.units} chunks, {st.passes} whole passes, "
            + ", ".join(f"{k} {v:.3f}" for k, v in st.stats.items()),
            "flow: chunk ends at " + " ".join(f"{t:.4f}" for t in st.unit_ends)]


def sample(st):
    """Pairs of the first pass compared with the reference, drawn from the
    seed."""
    rng = np.random.default_rng(st.ctx.seed)
    done = st.first_pass_done
    k = min(st.ctx.mix["sample_pairs"], len(done))
    return [done[i] for i in sorted(rng.choice(len(done), k, replace=False))]


def port_flows(st, pairs):
    """The flow files the window wrote, or None where one never came."""
    out = []
    for i, j in pairs:
        path = os.path.join(st.first_pass_dir, "flow", f"flow_{i:06d}_{j:06d}.raw")
        out.append(read_raw(path) if os.path.exists(path) else None)
    return out


def reference_flows(st, pairs, quant=None, block=8):
    """The plain reference's flows of `pairs` at color_down, from the PNGs
    and the seeded weights, in blocks of `block` pairs."""
    cfg, dev = st.ctx.config, st.ctx.device
    r = cfg["raft"]
    with torch.device(dev):
        net = ref_raft.RAFT(r["iters"], r["corr_levels"], r["corr_radius"], r["hidden_dim"],
                            r["context_dim"])
    weights.seed_raft_(net, st.ctx.seed)
    net.set_quant(quant).eval()
    flow_dir = os.path.join(st.clip_dir, "color_flow")
    out = []
    old = torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32
    torch.set_float32_matmul_precision("highest")
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            for s in range(0, len(pairs), block):
                ps = pairs[s : s + block]
                ims = [torch.from_numpy(np.stack([
                    load_png(os.path.join(flow_dir, f"frame_{p[k]:06d}.png")) for p in ps]))
                    .to(dev) for k in (0, 1)]
                if cfg["flow"]["homography"]:
                    h_ba, im2 = ref_reg.register(ims[0], ims[1])
                else:
                    h_ba, im2 = torch.eye(3, device=dev).expand(len(ps), 3, 3), ims[1]
                flows = net(ims[0].permute(0, 3, 1, 2) * 255.0,
                            im2.permute(0, 3, 1, 2) * 255.0).permute(0, 2, 3, 1)
                out.extend(ref_reg.unwarp_and_resize(flows, h_ba, cfg["clip"]["down_hw"]).cpu().numpy())
    finally:
        torch.set_float32_matmul_precision(old[0])
        torch.backends.cudnn.allow_tf32 = old[1]
    return out


def flow_gap(got, want) -> float:
    return max(float("inf") if g is None else float(np.abs(g - w).max())
               for g, w in zip(got, want))


def _free(st):
    st.stage = None
    st.model = None
    if st.ctx.device == "cuda":
        torch.cuda.empty_cache()


def check(st):
    pairs = sample(st)
    try:
        got = port_flows(st, pairs)
        _free(st)
        t0 = time.perf_counter()
        want = reference_flows(st, pairs)
        gap = flow_gap(got, want) if pairs else float("inf")
        st.ctx.say(f"check: {len(pairs)} pairs against the reference in "
                   f"{time.perf_counter() - t0:.3f} s")
    finally:
        shutil.rmtree(st.root, ignore_errors=True)
    return [Check("flow_px", gap, st.ctx.limits["flow_px"])]


def control(st):
    """The port's reading, the fp8 control's (the reference with float8
    convolutions and correlation features in the port's place) and a
    planted fault's (every flow moved by FAULT_SHIFT_PX), each against the
    float32 reference."""
    pairs = sample(st)
    try:
        got = port_flows(st, pairs)
        _free(st)
        want = reference_flows(st, pairs)
        ctl = reference_flows(st, pairs, quant="fp8")
    finally:
        shutil.rmtree(st.root, ignore_errors=True)
    return {"port": [flow_gap(got, want)], "control_fp8": [flow_gap(ctl, want)],
            "fault_shift": [flow_gap([w + FAULT_SHIFT_PX for w in want], want)]}
