"""One run of one benchmark cell of robust_cvd_tpu_torch on the card.

    python3 -m cvd_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The last line of standard output is the
result object; the numbers compared for `correct` are the last lines of
standard error. Exits with 2, printing no result, when the card or the
program is missing, and with 3 when a forbidden module (the JAX package
or JAX) is loaded once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# Caches of the program and of PyTorch at fixed paths inside the checkout,
# so that only a cell's first run in a checkout builds or compiles. The
# port's own kernels build into robust_cvd_tpu_torch/_build/kernels/.
ROOT = os.getcwd()
CACHE = os.path.join(ROOT, ".bench_cache")
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda")):
    os.environ[_var] = os.path.join(CACHE, _sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from . import core

    bench = core.load_benchmark(ROOT)
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}.get(args.workload)
    if chips is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        import robust_cvd_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"the program robust_cvd_tpu_torch does not import here: {e}", file=sys.stderr)
        return 2
    try:
        tmpdir = core.scratch_dir()
    except RuntimeError as e:
        print(e, file=sys.stderr)
        return 2
    result = core.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), ROOT,
                           T_START, tmpdir)
    loaded = core.forbidden_modules()
    if loaded:
        print(f"forbidden modules loaded in this run: {loaded}", file=sys.stderr)
        return 3
    core.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
