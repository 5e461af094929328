"""The whole train step's share of the card's TF32 peak: the operations
a step of the plain reference needs (counts/midas_train.py), over the
host-clock time a step of the traced run's untraced pace block (the mix's
`pace_units` steps, run just before the traced ones: the profiler slows the
host-bound step), over 495 TFLOP/s (the step's convolutions run in TF32)."""

from cvd_bench.counts import midas_train, peaks


def read(run):
    pace = run.get("pace")
    if not pace or not pace["units"]:
        return None
    cfg = run["config"]
    h, w = cfg["clip"]["down_hw"]
    flops = midas_train.train_step_flops(cfg["model"], 2 * cfg["train"]["batch_size"], h, w,
                                         cfg["loss"])
    return 100.0 * flops * pace["units"] / pace["seconds"] / peaks.TF32_FLOPS
