"""Run one cell of the benchmark once on the card and print its result.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is the
result (JSON); the numbers the check compared, each beside its limit, are
the last lines of standard error.  Without a CUDA card, or with fewer cards
than the cell asks for, or when a module of JAX or of the JAX package was
loaded, it exits with a code other than 0 and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every cache of the program and of torch in fixed directories of the
# checkout, so the first run of a cell builds and later runs find it
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ.setdefault("OMP_NUM_THREADS", "2")
sys.path.insert(0, str(ROOT))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from benchmark import harness

    if not torch.cuda.is_available():
        print("no CUDA card: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    chips = harness.Spec(ROOT).workload(args.workload)["chips"]
    if torch.cuda.device_count() < chips:
        print(f"the cell asks for {chips} cards, {torch.cuda.device_count()} "
              "present", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    line = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                            bool(args.trace), torch.device("cuda", 0), T_START)
    found = harness.banned_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3
    for k, c in line["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
