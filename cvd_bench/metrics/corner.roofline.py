"""The corner kernel's share of its bandwidth bound at the flow chunk's
launch (2 x batch gray frames at the flow size): each input and output
float read or written once, over 3.35 TB/s, over the kernel's device time
a launch (kernels named corner_min_eigenval, csrc/corner_min_eigenval.cu).
Nothing to read where the kernel did not run."""

from cvd_bench.counts import peaks

KERNEL = "corner_min_eigenval"


def read(run):
    t = run["trace"]
    if t is None:
        return None
    names = [k for k in t["kernels"] if KERNEL in k]
    launches = sum(t["kernel_counts"][k] for k in names)
    if not launches:
        print("corner.roofline: no corner_min_eigenval kernel in the trace")
        return None
    cfg = run["config"]
    h, w = cfg["clip"]["flow_hw"]
    frames = 2 * cfg["flow"]["batch_size"]
    bound = 2 * 4 * frames * h * w / peaks.HBM_BYTES_PER_S
    return 100.0 * bound / (sum(t["kernels"][k] for k in names) / launches)
