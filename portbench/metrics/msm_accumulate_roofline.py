"""msm_accumulate_roofline: the MSM bucket accumulate kernel's share of its
roofline in the prover. Work: the mixed adds the bucket method at a fixed
c = 8 needs for the profiled proofs' commitments, one a nonzero digit of
each scalar in standard form, counted by the yardstick from the scalars
the prover committed (roofline.nonzero_digits); time: the profiler's
device time of `accumulate_kernel` over the same proofs."""

from portbench import roofline


def read(r):
    t = r.get("trace")
    if r.get("entry") != "prove" or t is None or not r.get("counters"):
        return None
    _launches, seconds = t.kernel(r"accumulate_kernel")
    adds = sum(c["accumulate_adds"] for c in r["counters"])
    return roofline.share(roofline.accumulate_seconds(adds), seconds)
