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
  verify_solidity  EVM verifier codegen (verifier.sol, verifier_packed.sol):
                   over the stored outer proof, else over a demo target
                   proof made with --algo; both sources executed
  verify2_run      second recursion layer: aggregate the (Poseidon) layer-1
                   outer proof into a layer-2 proof under <folder>/l2
  verify2_check    verify the layer-2 outer proof on values

Every stage runs on the card, and raises when there is none; `--cpu` runs
every stage on the CPU instead (each kernel's plain twin). verify2_run
takes the layer-1 k from the stored layer-1 vk (the reference CLI assumes
--agg-k; the two agree when this CLI's verify_run made the layer-1 proof
at --agg-k) and proves layer 2 at --agg-k.

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
                                 "verify_run", "verify_check", "verify_solidity",
                                 "verify2_run", "verify2_check"])
    parser.add_argument("-f", "--folder", required=True)
    parser.add_argument("--cpu", action="store_true",
                        help="run the stage on the CPU (the kernels' plain "
                             "twins) instead of the card")
    parser.add_argument("--agg-k", type=int, default=22,
                        help="aggregation-circuit size (reference k=22, "
                             "simple-example.rs:361-363)")
    parser.add_argument("--algo", choices=["sha256", "keccak256"],
                        default="sha256",
                        help="verify_solidity transcript hash: sha256 "
                             "precompile or the native keccak256 opcode "
                             "(reference codegen.rs:19-37)")
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
    elif args.command == "verify2_run":
        l2 = FolderStore(os.path.join(args.folder, "l2"))
        proof, instances = harness.verify2_run(store, l2, l2_k=args.agg_k,
                                               device=device)
        print(f"layer-2 outer proof written ({len(proof)} bytes, "
              f"{len(instances[0])} public inputs)")
    elif args.command == "verify2_check":
        l2 = FolderStore(os.path.join(args.folder, "l2"))
        harness.verify2_check(l2, l2_k=args.agg_k, device=device)
        print("layer-2 outer proof natively verified")
    elif args.command == "verify_solidity":
        outer = store.exists("verify_circuit_proof.data")
        if outer and args.algo != "sha256":
            raise SystemExit("stored outer proofs use the sha256 "
                             "transcript (harness.verify_run)")
        if outer:
            print(f"generating verifier for the stored outer proof "
                  f"({len(store.read_verify_proof())} bytes, k={args.agg_k})")
        run = harness.verify_solidity(specs, store, agg_k=args.agg_k,
                                      algo=args.algo, device=device)
        prog = run.prog
        print(f"verifier.sol written ({run.gen.transcript_words} proof words, "
              f"{len(run.gen.cg.statements)} statements); verifier_packed.sol "
              f"written ({len(prog.ops)}B opcode blob + "
              f"{32 * len(prog.cpool)}B constant pool, memory_size "
              f"{prog.memory_size}); both sources executed and verified "
              f"the proof"
              + (" (+ on-chain final-pair packing checked)" if outer else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
