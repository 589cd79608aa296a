"""Read the check's numbers of one cell over many seeds in one process: the
program's (the lower readings its limits are set from) and the control's
(the reference in TF32 in the program's place: the upper readings).

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,3 \
        --control-seeds 4,5,6 --seconds 2 [--out calib.jsonl]

Each run is a whole run of the cell (set-up, a short window at the cell's
own load, the check); one JSON line a run.  The benchmark's own runs never
run the control.
"""

import time

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch
    from benchmark import harness

    dev = torch.device(args.device)
    if dev.type == "cuda":
        torch.set_num_threads(2)
    runs = [("program", int(s)) for s in args.seeds.split(",") if s]
    runs += [("control", int(s)) for s in args.control_seeds.split(",") if s]
    out = open(args.out, "a") if args.out else None
    try:
        for sut, seed in runs:
            t = time.perf_counter()
            line = harness.run_cell(ROOT, args.workload, seed, args.seconds,
                                    False, dev, t, sut=sut)
            rec = {"workload": args.workload, "sut": sut, "seed": seed,
                   "calls": line["attempted"],
                   "calls_ms": line["calls_ms"],
                   "run_s": time.perf_counter() - t,
                   "checks": {k: c["value"] for k, c in line["checks"].items()},
                   "metrics": {k: m["value"] for k, m in line["metrics"].items()}}
            print(json.dumps(rec), flush=True)
            if out:
                out.write(json.dumps(rec) + "\n")
                out.flush()
            del line
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
