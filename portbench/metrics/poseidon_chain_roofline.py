"""poseidon_chain_roofline: the sponge chain kernel's share of its roofline in
the verifier. Work: the transcript's Poseidon permutations a lane (counted by
the plain reference's replay) times the lanes, over the profiled batches;
time: the profiler's device time of `poseidon_chain_kernel` over the same
batches."""

from portbench import roofline


def read(r):
    t = r.get("trace")
    if r.get("entry") != "verify" or t is None:
        return None
    _launches, seconds = t.kernel(r"poseidon_chain_kernel")
    perms = r["shapes"]["permutations_per_call"] * r["profiled_calls"]
    return roofline.share(roofline.poseidon_chain_seconds(perms), seconds)
