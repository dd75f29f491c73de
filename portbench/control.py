"""Run a cell's control, or one of its planted faults, over several seeds,
and print what the comparison read: one JSON line a seed.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 [--seconds 8]
        [--fault half|stale|altered|other]

The control is what must come out as not correct. For a verify cell it is
the plain reference put in the program's place with one guarantee broken:
each batch folds only half of its lanes (`--fault half`, the default; it
needs no card). For the prove cell it is the program on the card handing
back a proof of another statement: the next witness seed's circuit
(`--fault other`, the default). The benchmark's own runs never run this.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import faults, harness, program  # noqa: E402


def system_for(cell, fault: str):
    if cell.entry == "verify":
        return faults.RefVerifier(cell.config, program.fixture_proofs(cell.config),
                                  fault)
    harness.require_cards(cell.chips)
    return faults.FaultyProver(program.Prover(cell.config), fault)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)
    cell = harness.find_cell(args.workload)
    fault = args.fault or ("half" if cell.entry == "verify" else "other")
    entry = harness.entry_module(cell)
    for seed in args.seeds:
        system = system_for(cell, fault)
        t0 = time.perf_counter()
        out = entry.run(cell, seed, args.seconds, False, t0, system=system)
        print(json.dumps({"workload": cell.name, "fault": fault, "seed": seed,
                          "correct": out.correct, "attempted": out.attempted,
                          "failed": out.failed,
                          "checks": {k: v for k, (v, _lim) in out.checks.items()},
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
