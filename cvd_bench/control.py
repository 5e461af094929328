"""The readings a cell's limits are set from, over many seeds in one
process: the port's numbers (the lower readings), the control's (the
plain reference put in the port's place at the next lower precision) and
any planted faults', each against the plain reference. Each seed first
runs a short window of the stage's `min_units`, or the mix's
`control_units` where that is more, so that the port's readings come from
units of a window as in a run.

    python3 -m cvd_bench.control --workload <cell> --seeds <n> [<n> ...]

Prints one JSON line a seed and, last, the largest reading of each number
over the seeds for the port and the smallest for the control and each
fault.
"""

import argparse
import json
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    from . import core

    root = os.getcwd()
    cell = core.resolve(core.load_benchmark(root), args.workload)
    rows = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        ctx = core.Ctx(workload=args.workload, config=cell["config"], mix=cell["mix"], seed=seed,
                       device="cuda", tmpdir=core.scratch_dir(), trace=False,
                       limits=core.load_json(core.limits_path(args.workload)))
        st = cell["stage"].setup(ctx)
        units = max(cell["stage"].min_units(st), int(cell["mix"].get("control_units", 0)))
        core.run_window(cell["stage"], st, "cuda", 0.0, max_units=units)
        row = {"seed": seed, **cell["stage"].control(st), "s": time.perf_counter() - t0}
        del st
        rows.append(row)
        print(json.dumps(row), flush=True)
    names = [k for k in rows[0] if k not in ("seed", "s")]
    summary = {}
    for k in names:
        cols = list(zip(*[r[k] for r in rows]))
        summary[k] = [max(c) if k == "port" else min(c) for c in cols]
    print(json.dumps({"summary": summary, "seeds": len(rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
