"""The BEiT encoder's attention kernels' share of their roofline: the
attention products a train step needs (q k^T and softmax v, forward and
backward, 12 T^2 D a block and frame; counts/beit_train.py::
attention_flops), over those kernels' device time a step, over 495
TFLOP/s (TF32).

The port's attention with the relative-position bias runs the
hand-written kernels `flash_attention_*_bias` (3xTF32 products, the bias
gathered and its table's gradient accumulated inside), after their
pre-passes `flash_attention_*_prep`: kernels are matched by name
(`attention`, `flash`, `relpos`), pre-passes and any table kernel
included. Three TF32 products a float32 one: a 3xTF32 kernel reads at most
33.3%. Nothing to read where none ran."""

from cvd_bench.counts import beit_train, peaks

KERNELS = ("attention", "flash", "relpos")


def read(run):
    t = run["trace"]
    if t is None or not run["units"]:
        return None
    secs = sum(v for k, v in t["kernels"].items() if any(s in k.lower() for s in KERNELS))
    if secs <= 0:
        print("beit.attention_roofline: no attention kernel in the trace")
        return None
    cfg = run["config"]
    h, w = cfg["clip"]["down_hw"]
    flops = beit_train.attention_flops(cfg["model"], 2 * cfg["train"]["batch_size"], h, w)
    return 100.0 * flops / peaks.TF32_FLOPS / (secs / run["units"])
