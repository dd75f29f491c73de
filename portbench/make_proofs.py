"""Make a configuration's pool of committed proofs with the port's prover on
the card, one JSON line a proof.

    python3 portbench/make_proofs.py --config zkevm16 --start 0 --count 40 \
        --out proofs.0.jsonl

Proof i proves the configuration's circuit for witness seed 2 + i with
blinding seed i, the seeds the JAX package's prover made the first
committed proofs with. A line holds `index`, `witness_seed`,
`blinding_seed`, `proof` (hex) and `instances`. Nothing made here is
committed before the plain reference has accepted every proof (each
verify run of the benchmark checks them again: `fixtures_rejected`).
The benchmark's runs never run this.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness, program  # noqa: E402


def config(name: str) -> dict:
    spec = harness.load_json(harness.ROOT / "BENCHMARK.json")
    files = {c["name"]: c["file"] for c in spec["configs"]}
    return harness.load_json(harness.ROOT / files[name])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--start", type=int, required=True)
    ap.add_argument("--count", type=int, required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    harness.require_cards(1)
    cfg = config(args.config)
    prover = program.Prover(cfg)
    with open(args.out, "w") as f:
        for i in range(args.start, args.start + args.count):
            seeds = (2 + i, i)
            proof = prover.prove(seeds)
            inst = program.circuit(cfg, seeds[0]).instances()
            f.write(json.dumps({"index": i, "witness_seed": seeds[0],
                                "blinding_seed": seeds[1], "proof": proof.hex(),
                                "instances": [[str(v) for v in col]
                                              for col in inst]}) + "\n")
            f.flush()
    prover.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
