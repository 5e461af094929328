"""Compare builds of the ViT attention kernels on one NVIDIA GPU, in turns.

    PYTHONPATH=. python3 tools/attention_bias_cuda.py \
        [--source NAME=PATH[:NVCC_FLAG,...] ...] [--rounds 2] [--reps 20]

Each --source is a copy of robust_cvd_tpu_torch/csrc/vit_attention.cu (the
default: the package's own, as "change"); a parent's copy beside the
change's gives both on one card. Every source is built with nvcc -Xptxas
-v (all builds started together) into robust_cvd_tpu_torch/_build/compare/.
For each build the script prints ptxas's registers, shared memory and
spills a kernel, checks the bias path against the plain version in float64
(out, dq, dk, dv, dT at the 8x8, 7x13 and 24x24 grids: the largest error
over the largest value, printed beside nothing: the tests hold the limits)
and, at BEiT's cell shape (4 frames, 32x56 grid, 16 heads), times in
rounds that visit the builds forwards and then backwards:
- the bias backward and forward, back to back through the raw launchers
  (chip_smoke.back_to_back_ms, two input sets);
- each kernel of the bias backward, a call, from torch.profiler;
- the backward without a bias at DPT-Large's shape (4, 1009, 16), the
  control that shares the dq pass's template.
Prints the card's name and power limit first and last.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import statistics
import subprocess
import sys

import numpy as np
import torch

import chip_smoke
from robust_cvd_tpu_torch.ops import attention
from robust_cvd_tpu_torch.ops._build import BUILD_DIR, CSRC_DIR, CUDA_FLAGS

CELL = (4, (32, 56), 16)
CHECK_GRIDS = ((2, (8, 8), 3), (2, (7, 13), 2), (1, (24, 24), 4))
NO_BIAS_SHAPE = (4, 1009, 16)


def build(sources: dict) -> dict:
    """name -> (path, flags): builds all with nvcc in parallel; returns
    name -> (bound library, ptxas summary)."""
    from torch.utils.cpp_extension import CUDA_HOME

    out_dir = os.path.join(BUILD_DIR, "..", "compare")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, (path, flags) in sources.items():
        so = os.path.join(out_dir, f"{name}.so")
        cmd = [os.path.join(CUDA_HOME, "bin", "nvcc"), *CUDA_FLAGS, *flags, "-Xptxas", "-v",
               "-Xcompiler", "-fPIC", "-shared", "-cudart", "shared", "-o", so, path]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, p) in procs.items():
        log = p.communicate(timeout=900)[0]
        if p.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        lines = []
        for m in re.finditer(r"Function properties for (\w+)\n(.*?)\n.*?Used (\d+) registers"
                             r"(?:.*?(\d+) bytes smem)?", log, re.S):
            kernel = m.group(1)
            if "flash_attention" not in kernel:
                continue
            spill = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                              r"(\d+) bytes spill loads", m.group(2))
            lines.append(f"{kernel}: {m.group(3)} registers, {m.group(4) or 0} B static smem, "
                         f"stack/spill st/ld {spill.groups() if spill else '?'}")
        libs[name] = (bind(ctypes.CDLL(so)), "\n  ".join(lines))
    return libs


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """attention.bind_library, and the bias entries of a build from before
    the windows of head width 32 (vit_attention_scratch_bytes,
    vit_attention_forward_bias and _backward_bias, a class token and head
    width 64 only), which the port's source no longer has."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name, args, res in (("vit_attention_scratch_bytes", [i32] * 4, ctypes.c_longlong),
                            ("vit_attention_forward_bias", [ptr] * 6 + [i32] * 5 + [ptr], i32),
                            ("vit_attention_backward_bias", [ptr] * 9 + [i32] * 5 + [ptr], i32)):
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes, fn.restype = args, res
    return attention.bind_library(lib)


def scratch_bytes(lib, b: int, n: int, h: int, backward: int) -> int:
    """Scratch bytes of a call at head width 64, by whichever entry the
    build has."""
    width = getattr(lib, "vit_attention_scratch_bytes_width", None)
    if width is not None:
        return width(b, n, h, 64, backward)
    return lib.vit_attention_scratch_bytes(b, n, h, backward)


def pos_for(lib, grid) -> torch.Tensor:
    wh, ww = grid
    n = 1 + wh * ww
    c = torch.zeros(lib.vit_attention_pos_length(n), dtype=torch.int32)
    y, x = torch.meshgrid(torch.arange(wh), torch.arange(ww), indexing="ij")
    c[0] = -1
    c[1:n] = (y * (2 * ww - 1) + x).flatten().to(torch.int32)
    return c.cuda()


class BiasCall:
    """The bias forward and backward of one build on fixed inputs."""

    def __init__(self, lib, b, grid, h, seed):
        self.lib, self.grid = lib, grid
        self.qkv, self.table, self.dout = chip_smoke._bias_inputs(b, grid, h, seed)
        self.b, self.n, self.h = b, 1 + grid[0] * grid[1], h
        self.pos = pos_for(lib, grid)
        self.out = torch.empty((b, self.n, h, 64), device="cuda")
        self.lse = torch.empty((b * h, lib.vit_attention_lse_stride(self.n)), device="cuda")
        self.dqkv = torch.empty_like(self.qkv)
        self.dtable = torch.zeros_like(self.table)
        self.fs, self.bs = (torch.empty(scratch_bytes(lib, b, self.n, h, back),
                                        dtype=torch.uint8, device="cuda") for back in (0, 1))
        self.stream = torch.cuda.current_stream().cuda_stream
        # the entries taking the head width, the class token and the
        # windows' region codes, where the build has them
        self.biased = getattr(lib, "vit_attention_forward_biased", None) is not None

    def forward(self):
        ptrs = (self.qkv.data_ptr(), self.table.data_ptr(), self.pos.data_ptr())
        rest = (self.out.data_ptr(), self.lse.data_ptr(), self.fs.data_ptr(), self.b, self.n,
                self.h)
        if self.biased:
            err = self.lib.vit_attention_forward_biased(*ptrs, None, *rest, 64, *self.grid, 1, 1,
                                                        self.stream)
        else:
            err = self.lib.vit_attention_forward_bias(*ptrs, *rest, *self.grid, self.stream)
        attention._raise(err, "forward (bias)")

    def backward(self):
        self.dtable.zero_()
        ptrs = (self.qkv.data_ptr(), self.table.data_ptr(), self.pos.data_ptr())
        rest = (self.out.data_ptr(), self.lse.data_ptr(), self.dout.data_ptr(),
                self.dqkv.data_ptr(), self.dtable.data_ptr(), self.bs.data_ptr(), self.b, self.n,
                self.h)
        if self.biased:
            err = self.lib.vit_attention_backward_biased(*ptrs, None, *rest, 64, *self.grid, 1, 1,
                                                         self.stream)
        else:
            err = self.lib.vit_attention_backward_bias(*ptrs, *rest, *self.grid, self.stream)
        attention._raise(err, "backward (bias)")


def errors(lib, b, grid, h, seed) -> dict:
    call = BiasCall(lib, b, grid, h, seed)
    call.forward()
    call.backward()
    x = call.qkv.double().requires_grad_(True)
    t = call.table.double().requires_grad_(True)
    y = attention.attention_plain(x, t, grid)
    y.backward(call.dout.double())
    pairs = [("out", call.out, y)] + [(f"d{c}", call.dqkv[:, :, i], x.grad[:, :, i])
                                      for i, c in enumerate("qkv")] + [("dT", call.dtable, t.grad)]
    return {k: float((a.double() - r.detach()).abs().max() / r.detach().abs().max())
            for k, a, r in pairs}


def kernel_ms(call, reps: int) -> dict:
    """Device ms a call of each kernel of the bias backward."""
    from torch.profiler import ProfilerActivity, profile

    call.backward()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call.backward()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if "flash_attention" in e.key:
            total = getattr(e, "device_time_total", None) or e.cuda_time_total
            out[e.key] = total / e.count / 1e3
    return out


def no_bias_ms(lib, seed: int) -> float:
    b, n, h = NO_BIAS_SHAPE
    g = torch.Generator(device="cuda").manual_seed(seed)
    sets = [dict(qkv=torch.randn((b, n, 3, h, 64), generator=g, device="cuda"),
                 dout=torch.randn((b, n, h, 64), generator=g, device="cuda")) for _ in range(2)]
    fs, bs = (torch.empty(scratch_bytes(lib, b, n, h, back), dtype=torch.uint8, device="cuda")
              for back in (0, 1))
    stream = torch.cuda.current_stream().cuda_stream
    for t in sets:
        t["out"] = torch.empty((b, n, h, 64), device="cuda")
        t["lse"] = torch.empty((b * h, lib.vit_attention_lse_stride(n)), device="cuda")
        t["dqkv"] = torch.empty_like(t["qkv"])
        attention._raise(lib.vit_attention_forward(
            t["qkv"].data_ptr(), t["out"].data_ptr(), t["lse"].data_ptr(), fs.data_ptr(), b, n,
            h, stream), "forward")

    def bwd(i):
        t = sets[i % 2]
        attention._raise(lib.vit_attention_backward(
            t["qkv"].data_ptr(), t["out"].data_ptr(), t["lse"].data_ptr(), t["dout"].data_ptr(),
            t["dqkv"].data_ptr(), bs.data_ptr(), b, n, h, stream), "backward")

    return chip_smoke.back_to_back_ms(bwd, k=20)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[],
                    help="NAME=PATH[:FLAG,...] (default: change=the package's source)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--no-checks", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("attention_bias_cuda: CUDA is not available", file=sys.stderr)
        return 1
    print(chip_smoke.device_line(), flush=True)
    sources = {}
    for item in args.source or [f"change={os.path.join(CSRC_DIR, 'vit_attention.cu')}"]:
        name, rest = item.split("=", 1)
        path, _, flags = rest.partition(":")
        sources[name] = (path, [f for f in flags.split(",") if f])
    libs = build(sources)
    for name, (lib, ptxas) in libs.items():
        print(f"{name}: ptxas\n  {ptxas}", flush=True)
        if not args.no_checks:
            for b, grid, h in CHECK_GRIDS + (CELL,):
                errs = errors(lib, b, grid, h, args.seed)
                print(f"{name}: errors vs float64 at {grid}: "
                      + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()), flush=True)
    calls = {name: [BiasCall(lib, *CELL, args.seed + i) for i in range(2)]
             for name, (lib, _) in libs.items()}
    times = {name: {"backward": [], "forward": [], "no_bias_backward": []} for name in libs}
    kernels = {name: [] for name in libs}
    order = list(libs)
    for r in range(args.rounds):
        for name in order if r % 2 == 0 else order[::-1]:
            pair = calls[name]
            t = times[name]
            t["backward"].append(chip_smoke.back_to_back_ms(lambda i: pair[i % 2].backward(),
                                                            k=args.reps))
            t["forward"].append(chip_smoke.back_to_back_ms(lambda i: pair[i % 2].forward(),
                                                           k=args.reps))
            t["no_bias_backward"].append(no_bias_ms(libs[name][0], args.seed))
            kernels[name].append(kernel_ms(pair[0], 10))
            print(f"round {r} {name}: " + ", ".join(f"{k} {v[-1]:.4f} ms" for k, v in t.items())
                  + "; " + ", ".join(f"{k} {v:.4f}" for k, v in sorted(kernels[name][-1].items())),
                  flush=True)
    for name in libs:
        med = {k: statistics.median(v) for k, v in times[name].items()}
        ks = {k: float(np.median([d.get(k, np.nan) for d in kernels[name]]))
              for k in kernels[name][0]}
        print(f"{name} medians: " + ", ".join(f"{k} {v:.4f} ms" for k, v in med.items())
              + "; kernels a call: " + ", ".join(f"{k} {v:.4f}" for k, v in sorted(ks.items())))
    print(chip_smoke.device_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
