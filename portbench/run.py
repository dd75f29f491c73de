"""Run one cell of the port's benchmark on the card this process finds.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints one JSON line last on standard output: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics with --trace 0, its
per-layer metrics with --trace 1), `device`, with --trace 1 `breakdown`,
and last `checks`, every number the comparison with the plain reference
read beside its limit (also the last lines on standard error). Exits 2,
printing no result, when there is no card, fewer cards than the cell asks
for, or a JAX module was loaded.
"""

import time

T_PROCESS = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        cell = harness.find_cell(args.workload)
        harness.require_cards(cell.chips)
        entry = harness.entry_module(cell)
        outcome = entry.run(cell, args.seed, args.seconds, bool(args.trace),
                            T_PROCESS)
        found = harness.forbidden_modules()
        if found:
            raise harness.Refused("modules of JAX or the JAX package were "
                                  f"loaded: {', '.join(found)}")
    except harness.Refused as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    res = harness.result(cell, outcome, bool(args.trace))
    sys.stdout.flush()
    for line in harness.check_lines(outcome):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
