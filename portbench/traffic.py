"""The one traffic generator: it reads a mix's parameters and draws the
inputs of a run from `--seed`.

A mix (traffic/<name>.json) names its entry and gives its parameters:

  * verify mixes: `batch` lanes a call, each lane one of the
    configuration's committed proofs. Every call holds `batch` distinct
    proofs of the pool, drawn anew from the seed in a random order, so no
    lane repeats another of its call and the calls differ;
  * prove mixes: each call proves one circuit whose witness seed and
    blinding seed are drawn from the seed, over one range, so every call
    has the same sizes.

Streams are independent by name: the warm-up's draws never move the
window's, and the sample of calls compared draws from its own stream.
"""

from __future__ import annotations

import itertools
import random

SEED_LO, SEED_HI = 1 << 16, 1 << 31


def stream(seed: int, name: str) -> random.Random:
    """A generator of its own for the draw `name` of run `seed`."""
    return random.Random(f"portbench/{name}/{seed}")


def lane_draws(seed: int, name: str, n_proofs: int, batch: int):
    """Endless lane assignments: `batch` distinct proofs of the pool's
    `n_proofs`, drawn anew each call."""
    if n_proofs < batch:
        raise ValueError(f"{n_proofs} committed proofs cannot fill {batch} "
                         "distinct lanes")
    rng = stream(seed, name)
    while True:
        yield rng.sample(range(n_proofs), batch)


def circuit_draws(seed: int, name: str):
    """Endless (witness seed, blinding seed) pairs."""
    rng = stream(seed, name)
    while True:
        yield rng.randrange(SEED_LO, SEED_HI), rng.randrange(SEED_LO, SEED_HI)


def sample(seed: int, n: int, k: int) -> list[int]:
    """k of the indices 0..n-1 drawn from the seed, always with the last
    one, in order."""
    if n <= k:
        return list(range(n))
    rng = stream(seed, "compare")
    pick = set(rng.sample(range(n - 1), k - 1)) | {n - 1}
    return sorted(pick)


def take(gen, n: int) -> list:
    return list(itertools.islice(gen, n))
