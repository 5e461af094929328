"""Sweep the corner kernel's design constants on one NVIDIA GPU.

    PYTHONPATH=. python3 tools/sweep_corner_cuda.py [--frames 100] [--rounds 2]

Builds variants of robust_cvd_tpu_torch/csrc/corner_min_eigenval.cu into
robust_cvd_tpu_torch/_build/sweep/ (one nvcc process per variant, all
started together). A variant is a list of overrides of the source's
`constexpr int` constants, e.g. RING=4,WARPS=8 ("base": none). It
checks each against the plain PyTorch version at the path's shape and two
ragged shapes, then times each as chip_smoke.py does (back-to-back launches
of the raw launcher over 4 cold input/output pairs), in rounds that visit
the variants forwards and then backwards. Prints one line per variant with
its ptxas line and every time, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys

import torch

import chip_smoke
from robust_cvd_tpu_torch.ops import corner
from robust_cvd_tpu_torch.ops._build import CSRC_DIR, CUDA_FLAGS, BUILD_DIR

VARIANTS = ["base", "RING=2", "RING=4", "RING=6", "RING=8,WARPS=4", "WARPS=4",
            "WARPS=16", "STRIP=28", "STRIP=40"]


def build(names):
    """Compiles every variant in parallel; returns name -> (ctypes
    launcher, ptxas summary)."""
    from torch.utils.cpp_extension import CUDA_HOME

    src = open(os.path.join(CSRC_DIR, "corner_min_eigenval.cu")).read()
    out_dir = os.path.join(BUILD_DIR, "..", "sweep")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name in names:
        text = src
        for item in name.split(",") if name != "base" else []:
            const, value = item.split("=")
            text, hits = re.subn(rf"constexpr int {const} = \d+;",
                                 f"constexpr int {const} = {int(value)};", text)
            if hits != 1:
                raise ValueError(f"{name}: no constant {const} in the source")
        stem = name.replace(",", "_").replace("=", "")
        cu = os.path.join(out_dir, f"{stem}.cu")
        with open(cu, "w") as f:
            f.write(text)
        cmd = [os.path.join(CUDA_HOME, "bin", "nvcc"), *CUDA_FLAGS, "-Xptxas", "-v",
               "-Xcompiler", "-fPIC", "-shared", "-cudart", "shared", "-o",
               os.path.join(out_dir, f"{stem}.so"), cu]
        procs[name] = (stem, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (stem, p) in procs.items():
        log = p.communicate(timeout=600)[0]
        if p.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        ptxas = "; ".join(
            f"{m.group(1)} regs {m.group(2)} B smem" for m in
            re.finditer(r"Used (\d+) registers.*?(\d+) bytes smem", log))
        spills = "; ".join(re.findall(r"\d+ bytes spill stores", log))
        fn = ctypes.CDLL(os.path.join(out_dir, f"{stem}.so")).corner_min_eigenval_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        libs[name] = (fn, f"{ptxas} ({spills})")
    return libs


def check(fn, gray) -> float:
    out = torch.empty_like(gray)
    n, h, w = gray.shape
    if fn(gray.data_ptr(), out.data_ptr(), n, h, w, torch.cuda.current_stream().cuda_stream):
        raise RuntimeError("launch failed")
    torch.cuda.synchronize()
    ref = corner.corner_min_eigenval_plain(gray)
    err = (out - ref).abs().max().item()
    if not err <= 1e-4 * ref.abs().max().item() + 1e-5:
        raise AssertionError(f"disagrees with the plain version at {tuple(gray.shape)}: {err}")
    return err


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--variants", nargs="*", default=VARIANTS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sweep_corner_cuda: CUDA is not available", file=sys.stderr)
        return 1
    libs = build(args.variants)
    g = torch.Generator().manual_seed(0)
    pairs = 4
    ins = [torch.rand((args.frames, chip_smoke.H, chip_smoke.W), generator=g).cuda()
           for _ in range(pairs)]
    outs = [torch.empty_like(x) for x in ins]
    small = [torch.rand(s, generator=g).cuda() for s in ((3, 37, 53), (2, 64, 200))]
    stream = torch.cuda.current_stream().cuda_stream
    n, h, w = ins[0].shape
    times = {name: [] for name in libs}
    for name, (fn, _) in libs.items():
        for x in [ins[0]] + small:
            check(fn, x)
    order = list(libs)
    for r in range(args.rounds):
        for name in order if r % 2 == 0 else order[::-1]:
            fn = libs[name][0]

            def launch(i, fn=fn):
                if fn(ins[i % pairs].data_ptr(), outs[i % pairs].data_ptr(), n, h, w, stream):
                    raise RuntimeError("launch failed")

            times[name].append(chip_smoke.back_to_back_ms(launch))
    bound = 8.0 * ins[0].numel() / chip_smoke.PEAK_BYTES_PER_S * 1e3
    for name, (_, ptxas) in libs.items():
        best = min(times[name])
        print(f"{name:24s} best {best:.4f} ms ({bound / best:.3f} of the {bound:.4f} ms bound); "
              f"all {' '.join(f'{t:.4f}' for t in times[name])}; {ptxas}")
    print(chip_smoke.device_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
