# Copy of halo2_snark_aggregator_tpu/protocol/instances.py, so that the port imports
# nothing of the JAX package. No edits: tests/test_torch_host_copies.py
# holds it equal to the reference.
"""Final-pair instance packing (reference C4, verify_circuit.rs:768-825).

The aggregation circuit exposes the folded pair (w_x, w_g) as public inputs
by packing each point's x-coordinate into two 136-bit field elements with the
y-parity bit carried in the high half:

    [x_lo (136 bits), x_hi + y_parity * 2^136]  per point

followed by all the inner proofs' public inputs
(`compute_verify_public_input_size` = 4 + sum N_PROOFS * PUBLIC_INPUT_SIZE,
sdk/src/lib.rs:76-81). `final_pair_to_instances` must match the in-circuit
packing bit-for-bit (verify_circuit.rs:264-353) once the aggregation circuit
lands; until then it defines the public-input ABI and feeds the generated
EVM verifier's `target_final_pair` calldata.
"""

from __future__ import annotations

from ..ff import bn254 as ff

PACK_BITS = 136


def pack_point(pt) -> list[int]:
    """G1 affine point -> [x_lo(136b), x_hi + parity*2^136] (Fr elements)."""
    if pt is None:
        return [0, 0]
    x, y = pt
    mask = (1 << PACK_BITS) - 1
    x_lo = x & mask
    x_hi = x >> PACK_BITS
    parity = y & 1
    return [x_lo % ff.R, (x_hi + (parity << PACK_BITS)) % ff.R]


def unpack_point(packed: list[int]):
    """Inverse of pack_point (recovers y from the curve equation + parity)."""
    x_lo, hi = packed
    if x_lo == 0 and hi == 0:
        return None
    parity = (hi >> PACK_BITS) & 1
    x_hi = hi & ((1 << PACK_BITS) - 1)
    x = (x_hi << PACK_BITS) | x_lo
    y = ff.sqrt_mod_p((x * x * x + ff.G1_B) % ff.P)
    if y is None:
        raise ValueError("packed x not on curve")
    if (y & 1) != parity:
        y = ff.P - y
    return (x, y)


def final_pair_to_instances(w_x, w_g, inner_instances: list[int]) -> list[int]:
    """The aggregation circuit's public-input vector
    (verify_circuit.rs:768-804 + 806-825)."""
    return pack_point(w_x) + pack_point(w_g) + [v % ff.R for v in inner_instances]


def compute_verify_public_input_size(circuits: list) -> int:
    """4 + sum(N_PROOFS * PUBLIC_INPUT_SIZE) (sdk/src/lib.rs:76-81).
    `circuits` entries need .n_proofs and .public_input_size attributes."""
    return 4 + sum(c.n_proofs * c.public_input_size for c in circuits)
