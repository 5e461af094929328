"""The Adam kernel's share of its bandwidth bound: 28 B a parameter over
3.35 TB/s, over the kernel's device time a step (kernels named
adam_kernel, csrc/adam.cu). Nothing to read where the kernel did not
run."""

from cvd_bench.counts import adam, peaks

KERNEL = "adam_kernel"


def read(run):
    t = run["trace"]
    if t is None or not run["units"]:
        return None
    secs = sum(v for k, v in t["kernels"].items() if KERNEL in k)
    if secs <= 0:
        print("adam.roofline: no adam_kernel in the trace")
        return None
    bound = adam.step_bytes(run["counters"]["parameters"]) / peaks.HBM_BYTES_PER_S
    return 100.0 * bound / (secs / run["units"])
