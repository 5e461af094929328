"""The Swin V2 encoder's window attention kernels' share of their roofline:
the attention products a train step needs (q k^T and softmax v, forward
and backward, 12 N^2 C a window, block and frame; counts/swin2_train.py::
attention_flops), over those kernels' device time a step, over 495
TFLOP/s (TF32).

The port's window attention runs the hand-written kernels
`flash_attention_*_window` and `*_window_mask` (3xTF32 products at head
width 32, the continuous position bias gathered, the shift mask added and
the table's gradient accumulated inside), after their pre-passes
`flash_attention_*_prep32`: kernels are matched by name (`attention`,
`flash`, `relpos`, `cpb`), pre-passes included. Three TF32 products a
float32 one: a 3xTF32 kernel reads at most 33.3%. Nothing to read where
none ran."""

from cvd_bench.counts import peaks, swin2_train

KERNELS = ("attention", "flash", "relpos", "cpb")


def read(run):
    t = run["trace"]
    if t is None or not run["units"]:
        return None
    secs = sum(v for k, v in t["kernels"].items() if any(s in k.lower() for s in KERNELS))
    if secs <= 0:
        print("swin2.attention_roofline: no attention kernel in the trace")
        return None
    cfg = run["config"]
    flops = swin2_train.attention_flops(cfg["model"], 2 * cfg["train"]["batch_size"])
    return 100.0 * flops / peaks.TF32_FLOPS / (secs / run["units"])
