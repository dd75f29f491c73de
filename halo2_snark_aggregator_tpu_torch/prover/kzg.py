# Copy of halo2_snark_aggregator_tpu/prover/kzg.py, so that the port imports
# nothing of the JAX package. No edits: tests/test_torch_host_copies.py
# holds it equal to the reference.
"""KZG commitment parameters (SRS) for BN254 — halo2 ParamsKZG equivalent.

`unsafe_setup` mirrors halo2's testing setup (a deterministic toxic-waste tau;
the reference caches params on disk keyed by k — verify_circuit.rs:701-731 and
fs.rs). Production deployments would load a real ceremony SRS via
`ParamsKZG.from_arrays`.
"""

from __future__ import annotations

import hashlib
import pickle
from pathlib import Path

from ..ff import bn254 as ff
from .domain import Domain


class ParamsKZG:
    def __init__(self, k: int, g: list, g_lagrange: list, g2, s_g2):
        self.k = k
        self.n = 1 << k
        self.g = g                    # [tau^i]G1, i in 0..n
        self.g_lagrange = g_lagrange  # [L_i(tau)]G1
        self.g2 = g2                  # G2 generator
        self.s_g2 = s_g2              # [tau]G2

    # -- setup -------------------------------------------------------------
    @staticmethod
    def unsafe_setup(k: int, seed: bytes = b"halo2-snark-aggregator-tpu") -> "ParamsKZG":
        tau = int.from_bytes(hashlib.sha256(seed + k.to_bytes(4, "little")).digest(), "little") % ff.R
        n = 1 << k
        g = []
        acc = ff.G1_GEN
        t = 1
        for _ in range(n):
            g.append(ff.g1_mul(ff.G1_GEN, t))
            t = t * tau % ff.R
        # Lagrange basis at tau: L_i(tau) = (omega^i / n) * (tau^n - 1) / (tau - omega^i)
        dom = Domain(k)
        tau_n = pow(tau, n, ff.R)
        n_inv = pow(n, -1, ff.R)
        w = 1
        g_lagrange = []
        for _ in range(n):
            li = w * n_inv % ff.R * (tau_n - 1) % ff.R * pow(tau - w, -1, ff.R) % ff.R
            g_lagrange.append(ff.g1_mul(ff.G1_GEN, li))
            w = w * dom.omega % ff.R
        return ParamsKZG(k, g, g_lagrange, ff.G2_GEN, ff.g2_mul(ff.G2_GEN, tau))

    @staticmethod
    def setup_cached(k: int, cache_dir: str | Path | None = None) -> "ParamsKZG":
        """Disk-cached unsafe setup (HALO2_PARAMS_{k} analog)."""
        if cache_dir is None:
            cache_dir = Path.home() / ".cache" / "halo2_snark_aggregator_tpu"
        cache_dir = Path(cache_dir)
        cache_dir.mkdir(parents=True, exist_ok=True)
        path = cache_dir / f"params_k{k}.pkl"
        if path.exists():
            with open(path, "rb") as f:
                data = pickle.load(f)
            return ParamsKZG(**data)
        params = ParamsKZG.unsafe_setup(k)
        with open(path, "wb") as f:
            pickle.dump(
                dict(k=params.k, g=params.g, g_lagrange=params.g_lagrange,
                     g2=params.g2, s_g2=params.s_g2),
                f,
            )
        return params

    # -- commitments -------------------------------------------------------
    def commit_lagrange(self, values: list[int]):
        assert len(values) <= self.n
        return ff.g1_msm(self.g_lagrange[: len(values)], values)

    def commit_coeff(self, coeffs: list[int]):
        assert len(coeffs) <= self.n, (len(coeffs), self.n)
        return ff.g1_msm(self.g[: len(coeffs)], coeffs)

    def verifier(self) -> "ParamsKZG":
        """The verifier only needs g_lagrange (instance commitments), g2, s_g2."""
        return self
