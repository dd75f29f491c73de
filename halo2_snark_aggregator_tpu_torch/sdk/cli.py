"""CLI of the zkaggregate! stages on the card (port of
halo2_snark_aggregator_tpu/sdk/cli.py; reference sdk/src/lib.rs).

Usage:  python -m halo2_snark_aggregator_tpu_torch.sdk.cli -c <command> -f <folder> [--cpu]

Commands (sdk/src/lib.rs:30-41, 83-177):
  sample_setup     target-circuit params + keys
  sample_run       create + self-verify N_PROOFS target proofs
  verify_setup     aggregation-circuit keygen (accelerated SRS + keygen at
                   --agg-k)
  verify_run       outer aggregation proof (accelerated prover, SHA256)
  verify_check     aggregation verify on the hybrid chips -> final pair;
                   verifies the stored outer proof on values when present

Every stage runs on the card, and raises when there is none; `--cpu` runs
every stage on the CPU instead (each kernel's plain twin). Not ported yet:
verify_solidity, verify2_run, verify2_check.

The built-in demo target is the SimpleMulCircuit (2 proofs, K=6), the analog
of sdk/examples/simple-example.rs.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

from ..circuits.simple import SimpleMulCircuit
from ..utils.store import FolderStore
from . import harness


def demo_spec() -> harness.TargetCircuitSpec:
    return harness.TargetCircuitSpec(
        name="simple",
        k=SimpleMulCircuit.K,
        n_proofs=2,
        public_input_size=1,
        circuit_builder=lambda seed: SimpleMulCircuit(2 + seed, 3 + seed),
        instance_builder=lambda c: c.instances(),
    )


def demo_specs(demo: str) -> list[harness.TargetCircuitSpec]:
    """`simple` mirrors simple-example.rs (one circuit family, 2 proofs);
    `multi` mirrors multi-circuit.rs (two families x 2 proofs, aggregated in
    one outer statement, sdk/examples/multi-circuit.rs:322-401)."""
    specs = [demo_spec()]
    if demo == "multi":
        from ..circuits.lookup import SimpleLookupCircuit

        specs.append(harness.TargetCircuitSpec(
            name="lookup",
            k=SimpleLookupCircuit.K,
            n_proofs=2,
            public_input_size=0,
            circuit_builder=lambda seed: SimpleLookupCircuit(
                [1, 3, 5, 7, 11, 13, (seed * 2 + 1) % 16]),
            instance_builder=lambda c: c.instances(),
        ))
    return specs


def main(argv=None):
    parser = argparse.ArgumentParser(prog="halo2-snark-aggregator-tpu-torch")
    parser.add_argument("-c", "--command", required=True,
                        choices=["sample_setup", "sample_run", "verify_setup",
                                 "verify_run", "verify_check"])
    parser.add_argument("-f", "--folder", required=True)
    parser.add_argument("--cpu", action="store_true",
                        help="run the stage on the CPU (the kernels' plain "
                             "twins) instead of the card")
    parser.add_argument("--agg-k", type=int, default=22,
                        help="aggregation-circuit size (reference k=22, "
                             "simple-example.rs:361-363)")
    parser.add_argument("--transcript", choices=["sha", "poseidon"],
                        default="sha",
                        help="outer-proof transcript flavor (poseidon feeds "
                             "a second recursion layer)")
    parser.add_argument("--demo", choices=["simple", "multi"], default="simple",
                        help="target-circuit set: simple-example.rs or "
                             "multi-circuit.rs analog")
    parser.add_argument("--vk-digest", choices=["native", "halo2-pinned"],
                        default=None,
                        help="pinned-vk transcript digest style: our "
                             "canonical serialization (default) or the "
                             "reconstructed halo2 {:?} pinned format "
                             "(verify.rs:56-72 interop; protocol/"
                             "pinned_compat.py)")
    args = parser.parse_args(argv)
    if args.vk_digest:
        os.environ["H2T_VK_DIGEST"] = args.vk_digest

    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(message)s")
    device = "cpu" if args.cpu else "cuda"
    store = FolderStore(args.folder)
    specs = demo_specs(args.demo)

    if args.command == "sample_setup":
        for s in specs:
            harness.sample_setup(s, store, device=device)
    elif args.command == "sample_run":
        for s in specs:
            harness.sample_run(s, store, device=device)
    elif args.command == "verify_setup":
        harness.verify_setup(specs, store, agg_k=args.agg_k, device=device)
        print(f"aggregator vkey at k={args.agg_k} stored")
    elif args.command == "verify_run":
        proof, instances = harness.verify_run(specs, store, agg_k=args.agg_k,
                                              transcript=args.transcript,
                                              device=device)
        print(f"outer proof written ({len(proof)} bytes, "
              f"{len(instances[0])} public inputs)")
    elif args.command == "verify_check":
        w_x, w_g, _ = harness.verify_check(specs, store, device=device)
        print(f"final pair:\n  w_x = {w_x}\n  w_g = {w_g}")
        if store.exists("verify_circuit_proof.data"):
            harness.verify_check_outer(store, agg_k=args.agg_k, device=device)
            print("outer proof natively verified (SHA256 transcript)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
