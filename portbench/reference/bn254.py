# Frozen copy of halo2_snark_aggregator_tpu_torch/ff/bn254.py for the benchmark's
# plain reference: imports rewritten to this folder, the native (C++)
# fast paths removed. It imports nothing of the program under test.
"""BN254 (alt_bn128) exact host-side arithmetic: Fr, Fq, tower fields, G1/G2, pairing.

This module is the *oracle layer* of the TPU framework: bit-exact reference
arithmetic in plain Python integers, against which the vectorized JAX/Pallas
kernels in `ops/` are differentially tested. It plays the role the
`halo2curves` crate (v0.2.1) plays for the reference implementation
(halo2-snark-aggregator-api/src/systems/halo2/verify.rs uses E = Bn256).

Conventions (matching halo2curves bn256):
  - field element byte repr: 32 bytes little-endian (`to_repr`)
  - `from_bytes_wide`: 64 bytes LE reduced mod the field modulus
  - G1 compressed encoding: 32 bytes = x (LE); top bit of byte 31 carries the
    sign of y (y odd); identity encodes as all zeros
"""

from __future__ import annotations

# ---------------------------------------------------------------------------
# Field moduli
# ---------------------------------------------------------------------------

# Base field Fq modulus
P = 21888242871839275222246405745257275088696311157297823662689037894645226208583
# Scalar field Fr modulus
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617

# BN parameter x such that p = 36x^4 + 36x^3 + 24x^2 + 6x + 1
BN_X = 4965661367192848881
ATE_LOOP_COUNT = 6 * BN_X + 2  # 29793968203157093288

# Fr 2-adicity structure (matches halo2curves bn256::Fr)
FR_S = 28
FR_GENERATOR = 7  # multiplicative generator of Fr*
FR_T = (R - 1) >> FR_S
FR_ROOT_OF_UNITY = pow(FR_GENERATOR, FR_T, R)  # 2^28-th primitive root of unity
FR_DELTA = pow(FR_GENERATOR, 1 << FR_S, R)  # FieldExt::DELTA for Fr


# ---------------------------------------------------------------------------
# Base field helpers (plain ints mod a modulus)
# ---------------------------------------------------------------------------

def inv_mod(a: int, m: int) -> int:
    if a % m == 0:
        raise ZeroDivisionError("inversion of zero")
    return pow(a, -1, m)


def sqrt_mod_p(a: int) -> int | None:
    """Square root in Fq (p % 4 == 3 so a^((p+1)/4))."""
    assert P % 4 == 3
    r = pow(a, (P + 1) // 4, P)
    if r * r % P != a % P:
        return None
    return r


def fr_inv_batch(vals: list[int]) -> list[int]:
    """Batch inversion mod R (Montgomery trick).

    Zero entries map to zero (callers treat them as invalid-witness)."""
    out = [0] * len(vals)
    prefix = [1] * (len(vals) + 1)
    for i, v in enumerate(vals):
        prefix[i + 1] = prefix[i] * v % R if v % R else prefix[i]
    inv = pow(prefix[-1], -1, R)
    for i in range(len(vals) - 1, -1, -1):
        v = vals[i] % R
        if v:
            out[i] = inv * prefix[i] % R
            inv = inv * v % R
    return out


def fe_to_bytes(a: int) -> bytes:
    """32-byte little-endian repr (halo2curves `to_repr`)."""
    return int(a).to_bytes(32, "little")


def fe_from_bytes(b: bytes, m: int) -> int | None:
    """Parse canonical 32-byte LE repr; None if non-canonical (>= modulus)."""
    v = int.from_bytes(b, "little")
    if v >= m:
        return None
    return v


def fe_from_bytes_wide(b: bytes, m: int) -> int:
    """64-byte LE reduced mod m (halo2curves `from_bytes_wide`)."""
    assert len(b) == 64
    return int.from_bytes(b, "little") % m


# ---------------------------------------------------------------------------
# Fq2 = Fq[u] / (u^2 + 1)
# ---------------------------------------------------------------------------

class Fq2:
    __slots__ = ("c0", "c1")

    def __init__(self, c0: int, c1: int):
        self.c0 = c0 % P
        self.c1 = c1 % P

    @staticmethod
    def zero() -> "Fq2":
        return Fq2(0, 0)

    @staticmethod
    def one() -> "Fq2":
        return Fq2(1, 0)

    def __eq__(self, o) -> bool:
        return isinstance(o, Fq2) and self.c0 == o.c0 and self.c1 == o.c1

    def __hash__(self):
        return hash((self.c0, self.c1))

    def __repr__(self):
        return f"Fq2({self.c0}, {self.c1})"

    def is_zero(self) -> bool:
        return self.c0 == 0 and self.c1 == 0

    def __add__(self, o: "Fq2") -> "Fq2":
        return Fq2(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o: "Fq2") -> "Fq2":
        return Fq2(self.c0 - o.c0, self.c1 - o.c1)

    def __neg__(self) -> "Fq2":
        return Fq2(-self.c0, -self.c1)

    def __mul__(self, o: "Fq2") -> "Fq2":
        # (a0 + a1 u)(b0 + b1 u) with u^2 = -1
        t0 = self.c0 * o.c0 % P
        t1 = self.c1 * o.c1 % P
        t2 = (self.c0 + self.c1) * (o.c0 + o.c1) % P
        return Fq2(t0 - t1, t2 - t0 - t1)

    def mul_scalar(self, k: int) -> "Fq2":
        return Fq2(self.c0 * k, self.c1 * k)

    def square(self) -> "Fq2":
        return self * self

    def conjugate(self) -> "Fq2":
        return Fq2(self.c0, -self.c1)

    def inverse(self) -> "Fq2":
        # 1/(a0 + a1 u) = (a0 - a1 u) / (a0^2 + a1^2)
        norm = (self.c0 * self.c0 + self.c1 * self.c1) % P
        ninv = inv_mod(norm, P)
        return Fq2(self.c0 * ninv, -self.c1 * ninv)

    def pow(self, e: int) -> "Fq2":
        result = Fq2.one()
        base = self
        while e:
            if e & 1:
                result = result * base
            base = base * base
            e >>= 1
        return result

    def frobenius(self) -> "Fq2":
        """x -> x^p, i.e. conjugation in Fq2."""
        return self.conjugate()


# Twist factor xi = 9 + u for the D-twist used by BN254
XI = Fq2(9, 1)

# Frobenius coefficients for Fq6/Fq12, computed from xi at import time.
# gamma1[i] = xi^((p-1)/6 * i) style constants; we derive the exact sets used
# by the untwist-frobenius-twist in the pairing below.
_XI_P_MINUS1_OVER_3 = XI.pow((P - 1) // 3)  # for Fq6 v -> v^p
_XI_P_MINUS1_OVER_2 = XI.pow((P - 1) // 2)  # for Fq12 w -> w^p


# ---------------------------------------------------------------------------
# Fq6 = Fq2[v] / (v^3 - xi),  Fq12 = Fq6[w] / (w^2 - v)
# ---------------------------------------------------------------------------

class Fq6:
    __slots__ = ("c0", "c1", "c2")

    def __init__(self, c0: Fq2, c1: Fq2, c2: Fq2):
        self.c0, self.c1, self.c2 = c0, c1, c2

    @staticmethod
    def zero() -> "Fq6":
        return Fq6(Fq2.zero(), Fq2.zero(), Fq2.zero())

    @staticmethod
    def one() -> "Fq6":
        return Fq6(Fq2.one(), Fq2.zero(), Fq2.zero())

    def __eq__(self, o) -> bool:
        return (
            isinstance(o, Fq6)
            and self.c0 == o.c0
            and self.c1 == o.c1
            and self.c2 == o.c2
        )

    def is_zero(self) -> bool:
        return self.c0.is_zero() and self.c1.is_zero() and self.c2.is_zero()

    def __add__(self, o: "Fq6") -> "Fq6":
        return Fq6(self.c0 + o.c0, self.c1 + o.c1, self.c2 + o.c2)

    def __sub__(self, o: "Fq6") -> "Fq6":
        return Fq6(self.c0 - o.c0, self.c1 - o.c1, self.c2 - o.c2)

    def __neg__(self) -> "Fq6":
        return Fq6(-self.c0, -self.c1, -self.c2)

    def __mul__(self, o: "Fq6") -> "Fq6":
        a0, a1, a2 = self.c0, self.c1, self.c2
        b0, b1, b2 = o.c0, o.c1, o.c2
        t0 = a0 * b0
        t1 = a1 * b1
        t2 = a2 * b2
        c0 = ((a1 + a2) * (b1 + b2) - t1 - t2) * XI + t0
        c1 = (a0 + a1) * (b0 + b1) - t0 - t1 + t2 * XI
        c2 = (a0 + a2) * (b0 + b2) - t0 - t2 + t1
        return Fq6(c0, c1, c2)

    def mul_fq2(self, k: Fq2) -> "Fq6":
        return Fq6(self.c0 * k, self.c1 * k, self.c2 * k)

    def mul_by_v(self) -> "Fq6":
        """Multiply by v (v^3 = xi)."""
        return Fq6(self.c2 * XI, self.c0, self.c1)

    def inverse(self) -> "Fq6":
        a0, a1, a2 = self.c0, self.c1, self.c2
        t0 = a0 * a0 - (a1 * a2) * XI
        t1 = a2 * a2 * XI - a0 * a1
        t2 = a1 * a1 - a0 * a2
        denom = a0 * t0 + (a2 * t1) * XI + (a1 * t2) * XI
        # denom is in Fq (c1 == 0) when computed exactly; invert as Fq2 anyway
        dinv = denom.inverse()
        return Fq6(t0 * dinv, t1 * dinv, t2 * dinv)


class Fq12:
    __slots__ = ("c0", "c1")

    def __init__(self, c0: Fq6, c1: Fq6):
        self.c0, self.c1 = c0, c1

    @staticmethod
    def one() -> "Fq12":
        return Fq12(Fq6.one(), Fq6.zero())

    def __eq__(self, o) -> bool:
        return isinstance(o, Fq12) and self.c0 == o.c0 and self.c1 == o.c1

    def is_one(self) -> bool:
        return self == Fq12.one()

    def __mul__(self, o: "Fq12") -> "Fq12":
        a0, a1 = self.c0, self.c1
        b0, b1 = o.c0, o.c1
        t0 = a0 * b0
        t1 = a1 * b1
        c0 = t0 + t1.mul_by_v()
        c1 = (a0 + a1) * (b0 + b1) - t0 - t1
        return Fq12(c0, c1)

    def square(self) -> "Fq12":
        return self * self

    def conjugate(self) -> "Fq12":
        return Fq12(self.c0, -self.c1)

    def inverse(self) -> "Fq12":
        t = (self.c0 * self.c0 - (self.c1 * self.c1).mul_by_v()).inverse()
        return Fq12(self.c0 * t, -(self.c1 * t))

    def pow(self, e: int) -> "Fq12":
        result = Fq12.one()
        base = self
        while e:
            if e & 1:
                result = result * base
            base = base.square()
            e >>= 1
        return result

    def frobenius(self) -> "Fq12":
        """x -> x^p."""
        c0 = _fq6_frobenius(self.c0)
        c1 = _fq6_frobenius(self.c1)
        # w -> w^p = w * xi^((p-1)/2) / ... : w^p = w^(p-1) * w, and
        # w^(p-1) = (w^2)^((p-1)/2) = v^((p-1)/2) ... easier: w^(p-1) =
        # xi^((p-1)/6)-style constant. Since w^2 = v and v^3 = xi:
        # w^12 relations give w^(p-1) = xi^((p-1)/6) viewed in Fq2.
        c1 = c1.mul_fq2(_FROB_W)
        return Fq12(c0, c1)


# v^(p-1) = xi^((p-1)/3); applied to Fq6 frobenius
_FROB_V = _XI_P_MINUS1_OVER_3
_FROB_V2 = _FROB_V * _FROB_V
# w^(p-1) = xi^((p-1)/6): (p-1)/6 is not an integer times needed... compute via
# exponent (p-1)//6: p % 6 == 1 for BN254 so this is exact.
assert (P - 1) % 6 == 0
_FROB_W = XI.pow((P - 1) // 6)


def _fq6_frobenius(a: Fq6) -> Fq6:
    c0 = a.c0.frobenius()
    c1 = a.c1.frobenius() * _FROB_V
    c2 = a.c2.frobenius() * _FROB_V2
    return Fq6(c0, c1, c2)


# ---------------------------------------------------------------------------
# G1: y^2 = x^3 + 3 over Fq.  Affine points as (x, y) tuples, None = identity.
# ---------------------------------------------------------------------------

G1_B = 3
G1_GEN = (1, 2)

G1Point = "tuple[int, int] | None"


def g1_is_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y * y - x * x * x - G1_B) % P == 0


def g1_neg(pt):
    if pt is None:
        return None
    return (pt[0], (-pt[1]) % P)


def g1_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        return g1_double(p1)
    lam = (y2 - y1) * inv_mod(x2 - x1, P) % P
    x3 = (lam * lam - x1 - x2) % P
    y3 = (lam * (x1 - x3) - y1) % P
    return (x3, y3)


def g1_double(pt):
    if pt is None:
        return None
    x, y = pt
    if y == 0:
        return None
    lam = 3 * x * x * inv_mod(2 * y, P) % P
    x3 = (lam * lam - 2 * x) % P
    y3 = (lam * (x - x3) - y) % P
    return (x3, y3)


def g1_mul(pt, k: int):
    """Scalar mul (`g1_mul_py`)."""
    return g1_mul_py(pt, k)


def g1_mul_py(pt, k: int):
    k %= R
    result = None
    add = pt
    while k:
        if k & 1:
            result = g1_add(result, add)
        add = g1_double(add)
        k >>= 1
    return result


def g1_msm(points, scalars):
    """Pippenger MSM over G1 (`g1_msm_py`)."""
    return g1_msm_py(points, scalars)


def g1_msm_py(points, scalars):
    """Pippenger MSM over G1 with window 8. Host-exact oracle for ops/msm."""
    assert len(points) == len(scalars)
    pairs = [(p, s % R) for p, s in zip(points, scalars) if p is not None and s % R != 0]
    if not pairs:
        return None
    c = 8 if len(pairs) >= 32 else 3
    nbits = 256
    nwin = (nbits + c - 1) // c
    result = None
    for w in reversed(range(nwin)):
        if result is not None:
            for _ in range(c):
                result = g1_double(result)
        buckets: dict[int, object] = {}
        shift = w * c
        mask = (1 << c) - 1
        for p, s in pairs:
            d = (s >> shift) & mask
            if d:
                buckets[d] = g1_add(buckets.get(d), p)
        # running-sum bucket reduction
        acc = None
        total = None
        for d in range(mask, 0, -1):
            acc = g1_add(acc, buckets.get(d))
            total = g1_add(total, acc)
        result = g1_add(result, total)
    return result


def g1_to_compressed(pt) -> bytes:
    """halo2curves bn256 G1 compressed: x LE, sign-of-y in top bit of byte 31."""
    if pt is None:
        return b"\x00" * 32
    x, y = pt
    b = bytearray(fe_to_bytes(x))
    if y & 1:
        b[31] |= 0x80
    return bytes(b)


def g1_from_compressed(b: bytes):
    if len(b) != 32:
        raise ValueError("bad length")
    if b == b"\x00" * 32:
        return None
    raw = bytearray(b)
    sign = (raw[31] >> 7) & 1
    raw[31] &= 0x7F
    x = fe_from_bytes(bytes(raw), P)
    if x is None:
        raise ValueError("x not canonical")
    y = sqrt_mod_p((x * x * x + G1_B) % P)
    if y is None:
        raise ValueError("not on curve")
    if (y & 1) != sign:
        y = P - y
    pt = (x, y)
    assert g1_is_on_curve(pt)
    return pt


# ---------------------------------------------------------------------------
# G2: y^2 = x^3 + 3/xi over Fq2. Affine (Fq2, Fq2) tuples, None = identity.
# ---------------------------------------------------------------------------

G2_B = Fq2(3, 0) * XI.inverse()

G2_GEN = (
    Fq2(
        10857046999023057135944570762232829481370756359578518086990519993285655852781,
        11559732032986387107991004021392285783925812861821192530917403151452391805634,
    ),
    Fq2(
        8495653923123431417604973247489272438418190587263600148770280649306958101930,
        4082367875863433681332203403145435568316851327593401208105741076214120093531,
    ),
)


def g2_is_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    return y * y == x * x * x + G2_B


def g2_neg(pt):
    if pt is None:
        return None
    return (pt[0], -pt[1])


def g2_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2).is_zero():
            return None
        return g2_double(p1)
    lam = (y2 - y1) * (x2 - x1).inverse()
    x3 = lam * lam - x1 - x2
    y3 = lam * (x1 - x3) - y1
    return (x3, y3)


def g2_double(pt):
    if pt is None:
        return None
    x, y = pt
    if y.is_zero():
        return None
    lam = (x * x).mul_scalar(3) * (y.mul_scalar(2)).inverse()
    x3 = lam * lam - x - x
    y3 = lam * (x - x3) - y
    return (x3, y3)


def g2_mul(pt, k: int):
    k %= R
    result = None
    add = pt
    while k:
        if k & 1:
            result = g2_add(result, add)
        add = g2_double(add)
        k >>= 1
    return result


# ---------------------------------------------------------------------------
# Optimal ate pairing
# ---------------------------------------------------------------------------

def _line_double(t, p):
    """Double step: returns (2T, line_eval at p) with line embedded in Fq12.

    T is an affine point on the twist E'(Fq2), p an affine G1 point. The
    tangent line at psi(T) on E(Fq12), evaluated at P.
    """
    x_t, y_t = t
    x_p, y_p = p
    lam = (x_t * x_t).mul_scalar(3) * (y_t.mul_scalar(2)).inverse()
    x_r = lam * lam - x_t - x_t
    y_r = lam * (x_t - x_r) - y_t
    return (x_r, y_r), _sparse_line(lam, x_t, y_t, x_p, y_p)


def _line_add(t, q, p):
    """Addition step: returns (T+Q, line eval at p)."""
    x_t, y_t = t
    x_q, y_q = q
    x_p, y_p = p
    lam = (y_q - y_t) * (x_q - x_t).inverse()
    x_r = lam * lam - x_t - x_q
    y_r = lam * (x_t - x_r) - y_t
    return (x_r, y_r), _sparse_line(lam, x_t, y_t, x_p, y_p)


def _sparse_line(lam: Fq2, x_t: Fq2, y_t: Fq2, x_p: int, y_p: int) -> Fq12:
    """Line through psi(T) with twist-slope lam, evaluated at P in G1.

    D-twist untwist map: psi(x', y') = (x' w^2, y' w^3) with w^6 = xi, since
    (y' w^3)^2 = (x' w^2)^3 + b  <=>  y'^2 = x'^3 + b/xi on E'.
    Slope of the untwisted line is lam * w, so
        l(P) = y_P - lam*x_P * w + (lam*x_T - y_T) * w^3
    with slots: w^0 -> c0.c0 (Fq), w^1 -> c1.c0, w^3 = v*w -> c1.c1.
    """
    return Fq12(
        Fq6(Fq2(y_p, 0), Fq2.zero(), Fq2.zero()),
        Fq6(lam.mul_scalar((-x_p) % P), lam * x_t - y_t, Fq2.zero()),
    )


def _g2_frobenius(pt):
    """Untwist-Frobenius-twist endomorphism on E'(Fq2)."""
    x, y = pt
    # x -> x^p * xi^((p-1)/3), y -> y^p * xi^((p-1)/2)
    return (x.frobenius() * _XI_P_MINUS1_OVER_3, y.frobenius() * _XI_P_MINUS1_OVER_2)


def miller_loop(q, p) -> Fq12:
    """Optimal ate Miller loop f_{6x+2,Q}(P) including the two frobenius steps."""
    if q is None or p is None:
        return Fq12.one()
    f = Fq12.one()
    t = q
    # MSB-first over ATE_LOOP_COUNT (plain binary; NAF is an optimization only)
    bits = bin(ATE_LOOP_COUNT)[2:]
    for bit in bits[1:]:
        f = f.square()
        t, l = _line_double(t, p)
        f = f * l
        if bit == "1":
            t, l = _line_add(t, q, p)
            f = f * l
    # frobenius steps: Q1 = pi(Q), Q2 = -pi^2(Q)
    q1 = _g2_frobenius(q)
    q2 = g2_neg(_g2_frobenius(_g2_frobenius(q)))
    t, l = _line_add(t, q1, p)
    f = f * l
    _, l = _line_add(t, q2, p)
    f = f * l
    return f


_FINAL_EXP = (P**12 - 1) // R


def final_exponentiation(f: Fq12) -> Fq12:
    """Full final exponentiation (p^12-1)/r.

    Uses the easy part ((p^6-1)(p^2+1)) via cheap conjugate/frobenius ops and a
    plain pow for the hard part. Host-side only; runs O(1) per aggregate so
    speed-of-light does not matter here (cf. SURVEY.md §2.6: pairing stays on
    host in the reference too, verify.rs:733-740).
    """
    # easy part: f^(p^6-1) = conj(f) * f^-1 ; then ^(p^2+1)
    f1 = f.conjugate() * f.inverse()
    f2 = f1.frobenius().frobenius() * f1
    # hard part: ^(p^4 - p^2 + 1)/r
    hard = (P**4 - P**2 + 1) // R
    return f2.pow(hard)


def pairing(p, q) -> Fq12:
    """e(P in G1, Q in G2)."""
    return final_exponentiation(miller_loop(q, p))


def pairing_check(pairs) -> bool:
    """prod e(P_i, Q_i) == 1, computed with one shared final exponentiation.

    Mirrors E::multi_miller_loop(...).final_exponentiation().is_identity()
    at reference verify.rs:733-740 (`pairing_check_py`).
    """
    return pairing_check_py(pairs)


def pairing_check_py(pairs) -> bool:
    f = Fq12.one()
    for p, q in pairs:
        if p is None or q is None:
            continue
        f = f * miller_loop(q, p)
    return final_exponentiation(f).is_one()
