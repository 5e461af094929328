"""The DPT encoder's attention kernels' share of their roofline: the
attention products a train step needs (q k^T and softmax v, forward and
backward, 12 T^2 D a block and frame; counts/dpt_train.py::
attention_flops), over those kernels' device time a step, over 495 TFLOP/s.

F.scaled_dot_product_attention on float32 runs PyTorch's memory-efficient
(CUTLASS) kernels, `fmha_cutlassF_f32_*` forward and `fmha_cutlassB_f32_*`
backward, whose products go through the tensor cores in TF32 (three
TF32 products a float32 one, CUTLASS's OpMultiplyAddFastF32), so the peak
is the TF32 one. Kernels are matched by name (`fmha`, `attention`,
`flash`); nothing to read where none ran."""

from cvd_bench.counts import dpt_train, peaks

KERNELS = ("fmha", "attention", "flash")


def read(run):
    t = run["trace"]
    if t is None or not run["units"]:
        return None
    secs = sum(v for k, v in t["kernels"].items() if any(s in k.lower() for s in KERNELS))
    if secs <= 0:
        print("dpt.attention_roofline: no attention kernel in the trace")
        return None
    cfg = run["config"]
    h, w = cfg["clip"]["down_hw"]
    flops = dpt_train.attention_flops(cfg["model"], 2 * cfg["train"]["batch_size"], h, w)
    return 100.0 * flops / peaks.TF32_FLOPS / (secs / run["units"])
