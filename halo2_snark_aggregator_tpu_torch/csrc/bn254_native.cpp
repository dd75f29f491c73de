// BN254 host-native arithmetic: Montgomery field ops, Poseidon permutation,
// G1 group ops / Pippenger MSM, radix-2 NTT.
//
// This is the native runtime companion of the host-exact oracle layer
// (halo2_snark_aggregator_tpu/ff/bn254.py). It plays the role the compiled
// `halo2curves` crate plays for the Rust reference (/root/reference uses
// halo2curves 0.2.1 for all host arithmetic, e.g. verify.rs pairing check):
// the Python ints remain the differential oracle; this library is the fast
// path for host-side protocol replay (Poseidon transcripts), SRS/commitment
// MSMs and prover NTTs.
//
// ABI: every field element crosses the boundary as 32 canonical little-endian
// bytes (halo2curves `to_repr` convention). Montgomery form never escapes.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -pthread (see native/__init__.py).

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <thread>
#include <vector>

typedef unsigned __int128 u128;

struct Fe {
  uint64_t l[4];
};

static inline int fe_cmp(const Fe &a, const Fe &b) {
  for (int i = 3; i >= 0; --i) {
    if (a.l[i] < b.l[i]) return -1;
    if (a.l[i] > b.l[i]) return 1;
  }
  return 0;
}

static inline bool fe_is_zero(const Fe &a) {
  return (a.l[0] | a.l[1] | a.l[2] | a.l[3]) == 0;
}

// out = a + b (raw 256-bit, returns carry)
static inline uint64_t fe_add_raw(const Fe &a, const Fe &b, Fe &out) {
  u128 c = 0;
  for (int i = 0; i < 4; ++i) {
    c += (u128)a.l[i] + b.l[i];
    out.l[i] = (uint64_t)c;
    c >>= 64;
  }
  return (uint64_t)c;
}

// out = a - b (raw, returns borrow)
static inline uint64_t fe_sub_raw(const Fe &a, const Fe &b, Fe &out) {
  u128 borrow = 0;
  for (int i = 0; i < 4; ++i) {
    u128 cur = (u128)a.l[i] - b.l[i] - (uint64_t)borrow;
    out.l[i] = (uint64_t)cur;
    borrow = (cur >> 64) ? 1 : 0;
  }
  return (uint64_t)borrow;
}

struct FieldCtx {
  Fe mod;
  uint64_t n0;  // -mod^{-1} mod 2^64
  Fe r2;        // 2^512 mod mod
  Fe one_m;     // 2^256 mod mod (Montgomery one)
};

static inline void fe_add_mod(const FieldCtx &F, const Fe &a, const Fe &b, Fe &out) {
  uint64_t carry = fe_add_raw(a, b, out);
  if (carry || fe_cmp(out, F.mod) >= 0) {
    Fe t;
    fe_sub_raw(out, F.mod, t);
    out = t;
  }
}

static inline void fe_sub_mod(const FieldCtx &F, const Fe &a, const Fe &b, Fe &out) {
  if (fe_sub_raw(a, b, out)) {
    Fe t;
    fe_add_raw(out, F.mod, t);
    out = t;
  }
}

static inline void fe_neg_mod(const FieldCtx &F, const Fe &a, Fe &out) {
  if (fe_is_zero(a)) { out = a; return; }
  fe_sub_raw(F.mod, a, out);
}

// CIOS Montgomery multiplication: out = a*b*2^-256 mod m.
static inline void mont_mul(const FieldCtx &F, const Fe &a, const Fe &b, Fe &out) {
  uint64_t t[6] = {0, 0, 0, 0, 0, 0};
  for (int i = 0; i < 4; ++i) {
    u128 carry = 0;
    for (int j = 0; j < 4; ++j) {
      u128 cur = (u128)a.l[i] * b.l[j] + t[j] + (uint64_t)carry;
      t[j] = (uint64_t)cur;
      carry = cur >> 64;
    }
    u128 cur = (u128)t[4] + (uint64_t)carry;
    t[4] = (uint64_t)cur;
    t[5] = (uint64_t)(cur >> 64);

    uint64_t m = t[0] * F.n0;
    carry = ((u128)m * F.mod.l[0] + t[0]) >> 64;
    for (int j = 1; j < 4; ++j) {
      u128 cur2 = (u128)m * F.mod.l[j] + t[j] + (uint64_t)carry;
      t[j - 1] = (uint64_t)cur2;
      carry = cur2 >> 64;
    }
    u128 cur3 = (u128)t[4] + (uint64_t)carry;
    t[3] = (uint64_t)cur3;
    t[4] = t[5] + (uint64_t)(cur3 >> 64);
    t[5] = 0;
  }
  Fe res{{t[0], t[1], t[2], t[3]}};
  if (t[4] || fe_cmp(res, F.mod) >= 0) {
    Fe tt;
    fe_sub_raw(res, F.mod, tt);
    res = tt;
  }
  out = res;
}

static inline void mont_sqr(const FieldCtx &F, const Fe &a, Fe &out) { mont_mul(F, a, a, out); }

static inline void to_mont(const FieldCtx &F, const Fe &a, Fe &out) { mont_mul(F, a, F.r2, out); }
static inline void from_mont(const FieldCtx &F, const Fe &a, Fe &out) {
  Fe one{{1, 0, 0, 0}};
  mont_mul(F, a, one, out);
}

// out = base^e (both Montgomery in/out), e canonical 256-bit.
static void mont_pow(const FieldCtx &F, const Fe &base, const Fe &e, Fe &out) {
  Fe acc = F.one_m;
  bool started = false;
  for (int i = 255; i >= 0; --i) {
    if (started) mont_sqr(F, acc, acc);
    if ((e.l[i / 64] >> (i % 64)) & 1) {
      if (started) {
        mont_mul(F, acc, base, acc);
      } else {
        acc = base;
        started = true;
      }
    }
  }
  out = started ? acc : F.one_m;
}

// Montgomery-domain inverse via Fermat (mod is prime).
static void mont_inv(const FieldCtx &F, const Fe &a, Fe &out) {
  Fe e;
  Fe two{{2, 0, 0, 0}};
  fe_sub_raw(F.mod, two, e);
  mont_pow(F, a, e, out);
}

static FieldCtx FR, FQ;
static bool g_init_done = false;

static void field_init(FieldCtx &F, const uint64_t mod_limbs[4]) {
  memcpy(F.mod.l, mod_limbs, 32);
  // n0 = -mod^{-1} mod 2^64 via Newton iteration
  uint64_t inv = 1;
  for (int i = 0; i < 6; ++i) inv *= 2 - F.mod.l[0] * inv;
  F.n0 = ~inv + 1;
  // one_m = 2^256 mod m, r2 = 2^512 mod m by repeated doubling
  Fe acc{{1, 0, 0, 0}};
  for (int i = 0; i < 256; ++i) fe_add_mod(F, acc, acc, acc);
  F.one_m = acc;
  for (int i = 0; i < 256; ++i) fe_add_mod(F, acc, acc, acc);
  F.r2 = acc;
}

extern "C" void h2t_init() {
  if (g_init_done) return;
  // Fr = 21888242871839275222246405745257275088548364400416034343698204186575808495617
  static const uint64_t FR_MOD[4] = {0x43e1f593f0000001ULL, 0x2833e84879b97091ULL,
                                     0xb85045b68181585dULL, 0x30644e72e131a029ULL};
  // Fq = 21888242871839275222246405745257275088696311157297823662689037894645226208583
  static const uint64_t FQ_MOD[4] = {0x3c208c16d87cfd47ULL, 0x97816a916871ca8dULL,
                                     0xb85045b68181585dULL, 0x30644e72e131a029ULL};
  field_init(FR, FR_MOD);
  field_init(FQ, FQ_MOD);
  g_init_done = true;
}

static inline const FieldCtx &ctx_for(int field) { return field == 0 ? FR : FQ; }

static inline void load_fe(const uint8_t *p, Fe &out) { memcpy(out.l, p, 32); }
static inline void store_fe(uint8_t *p, const Fe &a) { memcpy(p, a.l, 32); }

// ---------------------------------------------------------------------------
// Batch field ops (canonical in/out). op: 0=add 1=sub 2=mul
// ---------------------------------------------------------------------------

extern "C" void h2t_fe_op(int field, int op, const uint8_t *a, const uint8_t *b,
                          uint8_t *out, size_t n) {
  const FieldCtx &F = ctx_for(field);
  for (size_t i = 0; i < n; ++i) {
    Fe x, y, r;
    load_fe(a + 32 * i, x);
    load_fe(b + 32 * i, y);
    if (op == 0) {
      fe_add_mod(F, x, y, r);
    } else if (op == 1) {
      fe_sub_mod(F, x, y, r);
    } else {
      Fe xm, ym, rm;
      to_mont(F, x, xm);
      to_mont(F, y, ym);
      mont_mul(F, xm, ym, rm);
      from_mont(F, rm, r);
    }
    store_fe(out + 32 * i, r);
  }
}

// out[i] = a[i]^e  (single shared exponent, canonical bytes)
extern "C" void h2t_fe_pow(int field, const uint8_t *a, const uint8_t *e_bytes,
                           uint8_t *out, size_t n) {
  const FieldCtx &F = ctx_for(field);
  Fe e;
  load_fe(e_bytes, e);
  for (size_t i = 0; i < n; ++i) {
    Fe x, xm, rm, r;
    load_fe(a + 32 * i, x);
    to_mont(F, x, xm);
    mont_pow(F, xm, e, rm);
    from_mont(F, rm, r);
    store_fe(out + 32 * i, r);
  }
}

// Batch inversion (Montgomery trick); zero maps to zero.
extern "C" void h2t_fe_inv_batch(int field, const uint8_t *a, uint8_t *out, size_t n) {
  const FieldCtx &F = ctx_for(field);
  std::vector<Fe> vals(n), prefix(n);
  Fe acc = F.one_m;
  for (size_t i = 0; i < n; ++i) {
    Fe x;
    load_fe(a + 32 * i, x);
    to_mont(F, x, vals[i]);
    prefix[i] = acc;
    if (!fe_is_zero(vals[i])) mont_mul(F, acc, vals[i], acc);
  }
  Fe inv;
  mont_inv(F, acc, inv);
  for (size_t i = n; i-- > 0;) {
    Fe r;
    if (fe_is_zero(vals[i])) {
      r = Fe{{0, 0, 0, 0}};
    } else {
      Fe t;
      mont_mul(F, inv, prefix[i], t);  // t = inv(prod all) * prod(before i) = inv of suffix incl i... fix below
      mont_mul(F, inv, vals[i], inv);  // strip element i: inv of prod(before i)
      r = t;                            // t currently = inv(prod(0..i)) * prod(0..i-1) = inv(vals[i])
      Fe rc;
      from_mont(F, r, rc);
      r = rc;
    }
    store_fe(out + 32 * i, r);
  }
}

// ---------------------------------------------------------------------------
// Poseidon permutation over Fr (t x 32-byte states, dense MDS).
// Matches hashes/poseidon_spec.permute (reference hash/poseidon.rs:193-230).
// ---------------------------------------------------------------------------

static int POS_T = 0, POS_RF = 0, POS_RP = 0;
static std::vector<Fe> POS_RC;   // (rf+rp) * t, Montgomery
static std::vector<Fe> POS_MDS;  // t * t, Montgomery

extern "C" void h2t_poseidon_setup(const uint8_t *rc, size_t rounds, const uint8_t *mds,
                                   int t, int r_f, int r_p) {
  h2t_init();
  POS_T = t;
  POS_RF = r_f;
  POS_RP = r_p;
  POS_RC.assign(rounds * t, Fe{{0, 0, 0, 0}});
  POS_MDS.assign((size_t)t * t, Fe{{0, 0, 0, 0}});
  for (size_t i = 0; i < rounds * (size_t)t; ++i) {
    Fe x;
    load_fe(rc + 32 * i, x);
    to_mont(FR, x, POS_RC[i]);
  }
  for (size_t i = 0; i < (size_t)t * t; ++i) {
    Fe x;
    load_fe(mds + 32 * i, x);
    to_mont(FR, x, POS_MDS[i]);
  }
}

static inline void pos_sbox(Fe &x) {
  Fe x2, x4;
  mont_sqr(FR, x, x2);
  mont_sqr(FR, x2, x4);
  mont_mul(FR, x4, x, x);
}

static void pos_permute_one(Fe *s) {
  const int t = POS_T;
  std::vector<Fe> tmp(t);
  int idx = 0;
  auto mds_apply = [&](Fe *st) {
    for (int i = 0; i < t; ++i) {
      Fe acc{{0, 0, 0, 0}};
      for (int j = 0; j < t; ++j) {
        Fe p;
        mont_mul(FR, POS_MDS[(size_t)i * t + j], st[j], p);
        fe_add_mod(FR, acc, p, acc);
      }
      tmp[i] = acc;
    }
    memcpy(st, tmp.data(), sizeof(Fe) * t);
  };
  for (int r = 0; r < POS_RF / 2; ++r, ++idx) {
    for (int i = 0; i < t; ++i) {
      fe_add_mod(FR, s[i], POS_RC[(size_t)idx * t + i], s[i]);
      pos_sbox(s[i]);
    }
    mds_apply(s);
  }
  for (int r = 0; r < POS_RP; ++r, ++idx) {
    for (int i = 0; i < t; ++i) fe_add_mod(FR, s[i], POS_RC[(size_t)idx * t + i], s[i]);
    pos_sbox(s[0]);
    mds_apply(s);
  }
  for (int r = 0; r < POS_RF / 2; ++r, ++idx) {
    for (int i = 0; i < t; ++i) {
      fe_add_mod(FR, s[i], POS_RC[(size_t)idx * t + i], s[i]);
      pos_sbox(s[i]);
    }
    mds_apply(s);
  }
}

// states: count states of t*32 bytes each, permuted in place.
extern "C" void h2t_poseidon_permute(uint8_t *states, size_t count) {
  const int t = POS_T;
  std::vector<Fe> s(t);
  for (size_t k = 0; k < count; ++k) {
    uint8_t *base = states + (size_t)k * t * 32;
    for (int i = 0; i < t; ++i) {
      Fe x;
      load_fe(base + 32 * i, x);
      to_mont(FR, x, s[i]);
    }
    pos_permute_one(s.data());
    for (int i = 0; i < t; ++i) {
      Fe x;
      from_mont(FR, s[i], x);
      store_fe(base + 32 * i, x);
    }
  }
}

// ---------------------------------------------------------------------------
// G1 (y^2 = x^3 + 3 over Fq): Jacobian coordinates in Montgomery form.
// ---------------------------------------------------------------------------

struct G1J {
  Fe X, Y, Z;  // Z == 0 => identity
};

static inline bool g1_is_id(const G1J &p) { return fe_is_zero(p.Z); }

static const G1J G1_ID = {{{0, 0, 0, 0}}, {{0, 0, 0, 0}}, {{0, 0, 0, 0}}};

// dbl-2009-l (a = 0)
static void g1_dbl(const G1J &p, G1J &out) {
  if (g1_is_id(p) || fe_is_zero(p.Y)) { out = G1_ID; return; }
  Fe A, B, C, D, E, Fv, t, t2;
  mont_sqr(FQ, p.X, A);
  mont_sqr(FQ, p.Y, B);
  mont_sqr(FQ, B, C);
  fe_add_mod(FQ, p.X, B, t);
  mont_sqr(FQ, t, t2);
  fe_sub_mod(FQ, t2, A, t2);
  fe_sub_mod(FQ, t2, C, t2);
  fe_add_mod(FQ, t2, t2, D);  // D = 2*((X+B)^2 - A - C)
  fe_add_mod(FQ, A, A, E);
  fe_add_mod(FQ, E, A, E);  // E = 3A
  mont_sqr(FQ, E, Fv);
  G1J r;
  fe_sub_mod(FQ, Fv, D, r.X);
  fe_sub_mod(FQ, r.X, D, r.X);  // X3 = F - 2D
  Fe c8;
  fe_add_mod(FQ, C, C, c8);
  fe_add_mod(FQ, c8, c8, c8);
  fe_add_mod(FQ, c8, c8, c8);  // 8C
  fe_sub_mod(FQ, D, r.X, t);
  mont_mul(FQ, E, t, r.Y);
  fe_sub_mod(FQ, r.Y, c8, r.Y);
  mont_mul(FQ, p.Y, p.Z, t);
  fe_add_mod(FQ, t, t, r.Z);  // Z3 = 2YZ
  out = r;
}

// add-2007-bl, general Jacobian add
static void g1_add(const G1J &p, const G1J &q, G1J &out) {
  if (g1_is_id(p)) { out = q; return; }
  if (g1_is_id(q)) { out = p; return; }
  Fe Z1Z1, Z2Z2, U1, U2, S1, S2, t;
  mont_sqr(FQ, p.Z, Z1Z1);
  mont_sqr(FQ, q.Z, Z2Z2);
  mont_mul(FQ, p.X, Z2Z2, U1);
  mont_mul(FQ, q.X, Z1Z1, U2);
  mont_mul(FQ, p.Y, q.Z, t);
  mont_mul(FQ, t, Z2Z2, S1);
  mont_mul(FQ, q.Y, p.Z, t);
  mont_mul(FQ, t, Z1Z1, S2);
  Fe H, Rr;
  fe_sub_mod(FQ, U2, U1, H);
  fe_sub_mod(FQ, S2, S1, Rr);
  if (fe_is_zero(H)) {
    if (fe_is_zero(Rr)) { g1_dbl(p, out); return; }
    out = G1_ID;
    return;
  }
  Fe I, J, V, r2;
  fe_add_mod(FQ, H, H, t);
  mont_sqr(FQ, t, I);  // I = (2H)^2
  mont_mul(FQ, H, I, J);
  fe_add_mod(FQ, Rr, Rr, Rr);  // r = 2*(S2-S1)
  mont_mul(FQ, U1, I, V);
  G1J r;
  mont_sqr(FQ, Rr, r2);
  fe_sub_mod(FQ, r2, J, r.X);
  fe_sub_mod(FQ, r.X, V, r.X);
  fe_sub_mod(FQ, r.X, V, r.X);  // X3 = r^2 - J - 2V
  Fe sj;
  mont_mul(FQ, S1, J, sj);
  fe_add_mod(FQ, sj, sj, sj);  // 2*S1*J
  fe_sub_mod(FQ, V, r.X, t);
  mont_mul(FQ, Rr, t, r.Y);
  fe_sub_mod(FQ, r.Y, sj, r.Y);
  Fe zz;
  fe_add_mod(FQ, p.Z, q.Z, t);
  mont_sqr(FQ, t, zz);
  fe_sub_mod(FQ, zz, Z1Z1, zz);
  fe_sub_mod(FQ, zz, Z2Z2, zz);
  mont_mul(FQ, zz, H, r.Z);
  out = r;
}

// mixed add: q affine (Z=1 implicit), madd-2007-bl
static void g1_madd(const G1J &p, const Fe &qx, const Fe &qy, G1J &out) {
  if (g1_is_id(p)) {
    out.X = qx;
    out.Y = qy;
    out.Z = FQ.one_m;
    return;
  }
  Fe Z1Z1, U2, S2, t;
  mont_sqr(FQ, p.Z, Z1Z1);
  mont_mul(FQ, qx, Z1Z1, U2);
  mont_mul(FQ, qy, p.Z, t);
  mont_mul(FQ, t, Z1Z1, S2);
  Fe H, Rr;
  fe_sub_mod(FQ, U2, p.X, H);
  fe_sub_mod(FQ, S2, p.Y, Rr);
  if (fe_is_zero(H)) {
    if (fe_is_zero(Rr)) { g1_dbl(p, out); return; }
    out = G1_ID;
    return;
  }
  Fe HH, I, J, V, r2;
  mont_sqr(FQ, H, HH);
  fe_add_mod(FQ, HH, HH, I);
  fe_add_mod(FQ, I, I, I);  // I = 4*HH
  mont_mul(FQ, H, I, J);
  fe_add_mod(FQ, Rr, Rr, Rr);  // r = 2*(S2-Y1)
  mont_mul(FQ, p.X, I, V);
  G1J r;
  mont_sqr(FQ, Rr, r2);
  fe_sub_mod(FQ, r2, J, r.X);
  fe_sub_mod(FQ, r.X, V, r.X);
  fe_sub_mod(FQ, r.X, V, r.X);
  Fe yj;
  mont_mul(FQ, p.Y, J, yj);
  fe_add_mod(FQ, yj, yj, yj);
  fe_sub_mod(FQ, V, r.X, t);
  mont_mul(FQ, Rr, t, r.Y);
  fe_sub_mod(FQ, r.Y, yj, r.Y);
  fe_add_mod(FQ, p.Z, H, t);
  mont_sqr(FQ, t, r.Z);
  fe_sub_mod(FQ, r.Z, Z1Z1, r.Z);
  fe_sub_mod(FQ, r.Z, HH, r.Z);
  out = r;
}

static void g1_to_affine(const G1J &p, Fe &ox, Fe &oy, uint8_t &oinf) {
  if (g1_is_id(p)) {
    ox = Fe{{0, 0, 0, 0}};
    oy = Fe{{0, 0, 0, 0}};
    oinf = 1;
    return;
  }
  Fe zi, zi2, zi3, xm, ym;
  mont_inv(FQ, p.Z, zi);
  mont_sqr(FQ, zi, zi2);
  mont_mul(FQ, zi2, zi, zi3);
  mont_mul(FQ, p.X, zi2, xm);
  mont_mul(FQ, p.Y, zi3, ym);
  from_mont(FQ, xm, ox);
  from_mont(FQ, ym, oy);
  oinf = 0;
}

static inline int scalar_bit(const Fe &s, int i) { return (s.l[i / 64] >> (i % 64)) & 1; }

static void g1_scalar_mul(const Fe &px_m, const Fe &py_m, uint8_t inf, const Fe &s, G1J &out) {
  out = G1_ID;
  if (inf) return;
  bool any = false;
  for (int i = 255; i >= 0; --i) {
    if (any) g1_dbl(out, out);
    if (scalar_bit(s, i)) {
      g1_madd(out, px_m, py_m, out);
      any = true;
    }
  }
}

// xs/ys: n*32 bytes canonical affine coords; inf: n bytes; scalars: n*32 canonical.
// out: 64 bytes (x,y) + out_inf: 1 byte.
extern "C" void h2t_g1_mul_batch(const uint8_t *xs, const uint8_t *ys, const uint8_t *inf,
                                 const uint8_t *scalars, size_t n, uint8_t *oxs,
                                 uint8_t *oys, uint8_t *oinf) {
  h2t_init();
  size_t nthreads = std::min<size_t>(std::thread::hardware_concurrency(), 8);
  if (nthreads == 0) nthreads = 1;
  if (n < 8) nthreads = 1;
  auto work = [&](size_t lo, size_t hi) {
    for (size_t i = lo; i < hi; ++i) {
      Fe x, y, xm, ym, s;
      load_fe(xs + 32 * i, x);
      load_fe(ys + 32 * i, y);
      load_fe(scalars + 32 * i, s);
      to_mont(FQ, x, xm);
      to_mont(FQ, y, ym);
      G1J r;
      g1_scalar_mul(xm, ym, inf[i], s, r);
      Fe ox, oy;
      uint8_t oi;
      g1_to_affine(r, ox, oy, oi);
      store_fe(oxs + 32 * i, ox);
      store_fe(oys + 32 * i, oy);
      oinf[i] = oi;
    }
  };
  if (nthreads == 1) {
    work(0, n);
  } else {
    std::vector<std::thread> ts;
    size_t chunk = (n + nthreads - 1) / nthreads;
    for (size_t t = 0; t < nthreads; ++t) {
      size_t lo = t * chunk, hi = std::min(n, lo + chunk);
      if (lo >= hi) break;
      ts.emplace_back(work, lo, hi);
    }
    for (auto &t : ts) t.join();
  }
}

// Pippenger MSM. Window partial sums computed in parallel threads, combined
// serially with c doublings per window (same bucket algorithm as the host
// oracle ff/bn254.py g1_msm and the reference's halo2curves best_multiexp).
extern "C" void h2t_g1_msm(const uint8_t *xs, const uint8_t *ys, const uint8_t *inf,
                           const uint8_t *scalars, size_t n, uint8_t *out_xy,
                           uint8_t *out_inf) {
  h2t_init();
  // preload + montify points and scalars once
  std::vector<Fe> px(n), py(n), sc(n);
  std::vector<uint8_t> pinf(n);
  for (size_t i = 0; i < n; ++i) {
    Fe x, y;
    load_fe(xs + 32 * i, x);
    load_fe(ys + 32 * i, y);
    to_mont(FQ, x, px[i]);
    to_mont(FQ, y, py[i]);
    load_fe(scalars + 32 * i, sc[i]);
    pinf[i] = inf[i];
  }
  int c;
  if (n < 32) {
    c = 3;
  } else {
    int log2n = 0;
    while ((size_t(1) << (log2n + 1)) <= n) ++log2n;
    c = log2n * 7 / 10;  // ~ln(n), the classic Pippenger optimum
    if (c < 3) c = 3;
    if (c > 16) c = 16;
  }
  int nwin = (256 + c - 1) / c;
  uint32_t mask = (1u << c) - 1;
  std::vector<G1J> window_sums(nwin, G1_ID);

  auto do_window = [&](int w) {
    int shift = w * c;
    std::vector<G1J> buckets(mask + 1, G1_ID);
    std::vector<bool> used(mask + 1, false);
    for (size_t i = 0; i < n; ++i) {
      if (pinf[i]) continue;
      // extract c bits at `shift` from sc[i]
      int limb = shift / 64, off = shift % 64;
      uint64_t d = sc[i].l[limb] >> off;
      if (off + c > 64 && limb < 3) d |= sc[i].l[limb + 1] << (64 - off);
      d &= mask;
      if (!d) continue;
      g1_madd(buckets[d], px[i], py[i], buckets[d]);
      used[d] = true;
    }
    G1J acc = G1_ID, total = G1_ID;
    for (uint32_t d = mask; d >= 1; --d) {
      if (used[d]) g1_add(acc, buckets[d], acc);
      if (!g1_is_id(acc)) g1_add(total, acc, total);
    }
    window_sums[w] = total;
  };

  size_t nthreads = std::min<size_t>(std::thread::hardware_concurrency(), 8);
  if (nthreads <= 1 || n < 64) {
    for (int w = 0; w < nwin; ++w) do_window(w);
  } else {
    std::vector<std::thread> ts;
    for (size_t t = 0; t < nthreads; ++t) {
      ts.emplace_back([&, t]() {
        for (int w = (int)t; w < nwin; w += (int)nthreads) do_window(w);
      });
    }
    for (auto &t : ts) t.join();
  }

  G1J result = G1_ID;
  for (int w = nwin - 1; w >= 0; --w) {
    if (!g1_is_id(result))
      for (int i = 0; i < c; ++i) g1_dbl(result, result);
    g1_add(result, window_sums[w], result);
  }
  Fe ox, oy;
  uint8_t oi;
  g1_to_affine(result, ox, oy, oi);
  store_fe(out_xy, ox);
  store_fe(out_xy + 32, oy);
  *out_inf = oi;
}

// ---------------------------------------------------------------------------
// Radix-2 NTT over Fr (in-order input -> in-order output, matches
// prover/domain.py ntt: bit-reverse then iterative butterflies).
// ---------------------------------------------------------------------------

extern "C" void h2t_fr_ntt(uint8_t *data, size_t n, const uint8_t *omega_bytes) {
  h2t_init();
  std::vector<Fe> a(n);
  for (size_t i = 0; i < n; ++i) {
    Fe x;
    load_fe(data + 32 * i, x);
    to_mont(FR, x, a[i]);
  }
  // bit-reverse permute
  int bits = 0;
  while ((size_t(1) << bits) < n) ++bits;
  for (size_t i = 0; i < n; ++i) {
    size_t j = 0;
    for (int b = 0; b < bits; ++b) j |= ((i >> b) & 1) << (bits - 1 - b);
    if (j > i) std::swap(a[i], a[j]);
  }
  Fe om, om_m;
  load_fe(omega_bytes, om);
  to_mont(FR, om, om_m);
  for (size_t length = 2; length <= n; length <<= 1) {
    // w_len = omega^(n/length)
    Fe w_len = om_m;
    for (size_t e = n / length; e > 1; e >>= 1) mont_sqr(FR, w_len, w_len);
    // note: n/length is a power of two, so repeated squaring is exact
    size_t half = length >> 1;
    for (size_t start = 0; start < n; start += length) {
      Fe w = FR.one_m;
      for (size_t j = start; j < start + half; ++j) {
        Fe u = a[j], v;
        mont_mul(FR, a[j + half], w, v);
        fe_add_mod(FR, u, v, a[j]);
        fe_sub_mod(FR, u, v, a[j + half]);
        mont_mul(FR, w, w_len, w);
      }
    }
  }
  for (size_t i = 0; i < n; ++i) {
    Fe x;
    from_mont(FR, a[i], x);
    store_fe(data + 32 * i, x);
  }
}

// ---------------------------------------------------------------------------
// Tower fields Fq2/Fq6/Fq12 and the optimal ate pairing check.
// Mirrors the host oracle ff/bn254.py (same D-twist xi = 9+u, same sparse
// line embedding, same easy-part/hard-part final exponentiation split as the
// reference's host pairing at verify.rs:733-740).
// All Fe values below are Montgomery-form Fq.
// ---------------------------------------------------------------------------

struct Fe2 { Fe c0, c1; };
struct Fe6 { Fe2 c0, c1, c2; };
struct Fe12 { Fe6 c0, c1; };

static inline bool fe2_is_zero(const Fe2 &a) { return fe_is_zero(a.c0) && fe_is_zero(a.c1); }

static inline void fe2_add(const Fe2 &a, const Fe2 &b, Fe2 &o) {
  fe_add_mod(FQ, a.c0, b.c0, o.c0);
  fe_add_mod(FQ, a.c1, b.c1, o.c1);
}
static inline void fe2_sub(const Fe2 &a, const Fe2 &b, Fe2 &o) {
  fe_sub_mod(FQ, a.c0, b.c0, o.c0);
  fe_sub_mod(FQ, a.c1, b.c1, o.c1);
}
static inline void fe2_neg(const Fe2 &a, Fe2 &o) {
  fe_neg_mod(FQ, a.c0, o.c0);
  fe_neg_mod(FQ, a.c1, o.c1);
}
static void fe2_mul(const Fe2 &a, const Fe2 &b, Fe2 &o) {
  // (a0 + a1 u)(b0 + b1 u), u^2 = -1 (karatsuba)
  Fe t0, t1, s1, s2, t2;
  mont_mul(FQ, a.c0, b.c0, t0);
  mont_mul(FQ, a.c1, b.c1, t1);
  fe_add_mod(FQ, a.c0, a.c1, s1);
  fe_add_mod(FQ, b.c0, b.c1, s2);
  mont_mul(FQ, s1, s2, t2);
  Fe2 r;
  fe_sub_mod(FQ, t0, t1, r.c0);
  fe_sub_mod(FQ, t2, t0, r.c1);
  fe_sub_mod(FQ, r.c1, t1, r.c1);
  o = r;
}
static inline void fe2_sqr(const Fe2 &a, Fe2 &o) { fe2_mul(a, a, o); }
static inline void fe2_mul_fe(const Fe2 &a, const Fe &k, Fe2 &o) {
  mont_mul(FQ, a.c0, k, o.c0);
  mont_mul(FQ, a.c1, k, o.c1);
}
static inline void fe2_conj(const Fe2 &a, Fe2 &o) {
  o.c0 = a.c0;
  fe_neg_mod(FQ, a.c1, o.c1);
}
static void fe2_inv(const Fe2 &a, Fe2 &o) {
  Fe n0, n1, norm, ninv;
  mont_sqr(FQ, a.c0, n0);
  mont_sqr(FQ, a.c1, n1);
  fe_add_mod(FQ, n0, n1, norm);
  mont_inv(FQ, norm, ninv);
  Fe2 r;
  mont_mul(FQ, a.c0, ninv, r.c0);
  mont_mul(FQ, a.c1, ninv, r.c1);
  fe_neg_mod(FQ, r.c1, r.c1);
  o = r;
}
// pow by a canonical 256-bit exponent
static void fe2_pow(const Fe2 &base, const Fe &e, Fe2 &o) {
  Fe2 acc{FQ.one_m, {{0, 0, 0, 0}}};
  for (int i = 255; i >= 0; --i) {
    fe2_sqr(acc, acc);
    if ((e.l[i / 64] >> (i % 64)) & 1) fe2_mul(acc, base, acc);
  }
  o = acc;
}

static Fe2 XI_M;                       // 9 + u
static Fe2 FROB_V, FROB_V2, FROB_W;    // xi^((p-1)/3), its square, xi^((p-1)/6)
static Fe2 XI_P12;                     // xi^((p-1)/2)
static bool g_tower_init = false;

static void tower_init() {
  if (g_tower_init) return;
  h2t_init();
  Fe nine{{9, 0, 0, 0}}, one{{1, 0, 0, 0}};
  to_mont(FQ, nine, XI_M.c0);
  to_mont(FQ, one, XI_M.c1);
  // exponents (p-1)/3, (p-1)/2, (p-1)/6 all fit 256 bits
  Fe pm1;
  fe_sub_raw(FQ.mod, one, pm1);
  // divide 256-bit by small d
  auto div_small = [](const Fe &a, uint64_t d, Fe &o) {
    u128 rem = 0;
    for (int i = 3; i >= 0; --i) {
      u128 cur = (rem << 64) | a.l[i];
      o.l[i] = (uint64_t)(cur / d);
      rem = cur % d;
    }
  };
  Fe e3, e2, e6;
  div_small(pm1, 3, e3);
  div_small(pm1, 2, e2);
  div_small(pm1, 6, e6);
  fe2_pow(XI_M, e3, FROB_V);
  fe2_mul(FROB_V, FROB_V, FROB_V2);
  fe2_pow(XI_M, e2, XI_P12);
  fe2_pow(XI_M, e6, FROB_W);
  g_tower_init = true;
}

static inline void fe6_add(const Fe6 &a, const Fe6 &b, Fe6 &o) {
  fe2_add(a.c0, b.c0, o.c0);
  fe2_add(a.c1, b.c1, o.c1);
  fe2_add(a.c2, b.c2, o.c2);
}
static inline void fe6_sub(const Fe6 &a, const Fe6 &b, Fe6 &o) {
  fe2_sub(a.c0, b.c0, o.c0);
  fe2_sub(a.c1, b.c1, o.c1);
  fe2_sub(a.c2, b.c2, o.c2);
}
static inline void fe6_neg(const Fe6 &a, Fe6 &o) {
  fe2_neg(a.c0, o.c0);
  fe2_neg(a.c1, o.c1);
  fe2_neg(a.c2, o.c2);
}
static void fe6_mul(const Fe6 &A, const Fe6 &B, Fe6 &o) {
  Fe2 t0, t1, t2, s1, s2, x, y;
  fe2_mul(A.c0, B.c0, t0);
  fe2_mul(A.c1, B.c1, t1);
  fe2_mul(A.c2, B.c2, t2);
  Fe6 r;
  // c0 = ((a1+a2)(b1+b2) - t1 - t2) * xi + t0
  fe2_add(A.c1, A.c2, s1);
  fe2_add(B.c1, B.c2, s2);
  fe2_mul(s1, s2, x);
  fe2_sub(x, t1, x);
  fe2_sub(x, t2, x);
  fe2_mul(x, XI_M, x);
  fe2_add(x, t0, r.c0);
  // c1 = (a0+a1)(b0+b1) - t0 - t1 + t2 * xi
  fe2_add(A.c0, A.c1, s1);
  fe2_add(B.c0, B.c1, s2);
  fe2_mul(s1, s2, x);
  fe2_sub(x, t0, x);
  fe2_sub(x, t1, x);
  fe2_mul(t2, XI_M, y);
  fe2_add(x, y, r.c1);
  // c2 = (a0+a2)(b0+b2) - t0 - t2 + t1
  fe2_add(A.c0, A.c2, s1);
  fe2_add(B.c0, B.c2, s2);
  fe2_mul(s1, s2, x);
  fe2_sub(x, t0, x);
  fe2_sub(x, t2, x);
  fe2_add(x, t1, r.c2);
  o = r;
}
static inline void fe6_mul_fe2(const Fe6 &a, const Fe2 &k, Fe6 &o) {
  fe2_mul(a.c0, k, o.c0);
  fe2_mul(a.c1, k, o.c1);
  fe2_mul(a.c2, k, o.c2);
}
static void fe6_mul_by_v(const Fe6 &a, Fe6 &o) {
  Fe6 r;
  fe2_mul(a.c2, XI_M, r.c0);
  r.c1 = a.c0;
  r.c2 = a.c1;
  o = r;
}
static void fe6_inv(const Fe6 &a, Fe6 &o) {
  Fe2 t0, t1, t2, x, y, denom, dinv;
  // t0 = a0^2 - a1*a2*xi ; t1 = a2^2*xi - a0*a1 ; t2 = a1^2 - a0*a2
  fe2_sqr(a.c0, x);
  fe2_mul(a.c1, a.c2, y);
  fe2_mul(y, XI_M, y);
  fe2_sub(x, y, t0);
  fe2_sqr(a.c2, x);
  fe2_mul(x, XI_M, x);
  fe2_mul(a.c0, a.c1, y);
  fe2_sub(x, y, t1);
  fe2_sqr(a.c1, x);
  fe2_mul(a.c0, a.c2, y);
  fe2_sub(x, y, t2);
  // denom = a0*t0 + a2*t1*xi + a1*t2*xi
  fe2_mul(a.c0, t0, denom);
  fe2_mul(a.c2, t1, x);
  fe2_mul(x, XI_M, x);
  fe2_add(denom, x, denom);
  fe2_mul(a.c1, t2, x);
  fe2_mul(x, XI_M, x);
  fe2_add(denom, x, denom);
  fe2_inv(denom, dinv);
  fe2_mul(t0, dinv, o.c0);
  fe2_mul(t1, dinv, o.c1);
  fe2_mul(t2, dinv, o.c2);
}
static void fe6_frob(const Fe6 &a, Fe6 &o) {
  Fe2 x;
  fe2_conj(a.c0, o.c0);
  fe2_conj(a.c1, x);
  fe2_mul(x, FROB_V, o.c1);
  fe2_conj(a.c2, x);
  fe2_mul(x, FROB_V2, o.c2);
}

static const Fe2 FE2_ZERO = {{{0, 0, 0, 0}}, {{0, 0, 0, 0}}};

static void fe12_one(Fe12 &o) {
  o.c0.c0 = Fe2{FQ.one_m, {{0, 0, 0, 0}}};
  o.c0.c1 = FE2_ZERO;
  o.c0.c2 = FE2_ZERO;
  o.c1.c0 = FE2_ZERO;
  o.c1.c1 = FE2_ZERO;
  o.c1.c2 = FE2_ZERO;
}
static bool fe12_is_one(const Fe12 &a) {
  if (!(fe_cmp(a.c0.c0.c0, FQ.one_m) == 0) || !fe_is_zero(a.c0.c0.c1)) return false;
  return fe2_is_zero(a.c0.c1) && fe2_is_zero(a.c0.c2) && fe2_is_zero(a.c1.c0) &&
         fe2_is_zero(a.c1.c1) && fe2_is_zero(a.c1.c2);
}
static void fe12_mul(const Fe12 &A, const Fe12 &B, Fe12 &o) {
  Fe6 t0, t1, x, y;
  fe6_mul(A.c0, B.c0, t0);
  fe6_mul(A.c1, B.c1, t1);
  Fe12 r;
  fe6_mul_by_v(t1, x);
  fe6_add(t0, x, r.c0);
  fe6_add(A.c0, A.c1, x);
  fe6_add(B.c0, B.c1, y);
  fe6_mul(x, y, x);
  fe6_sub(x, t0, x);
  fe6_sub(x, t1, r.c1);
  o = r;
}
static inline void fe12_sqr(const Fe12 &a, Fe12 &o) { fe12_mul(a, a, o); }
static void fe12_conj(const Fe12 &a, Fe12 &o) {
  o.c0 = a.c0;
  fe6_neg(a.c1, o.c1);
}
static void fe12_inv(const Fe12 &a, Fe12 &o) {
  Fe6 t, x;
  fe6_mul(a.c1, a.c1, x);
  fe6_mul_by_v(x, x);
  fe6_mul(a.c0, a.c0, t);
  fe6_sub(t, x, t);
  fe6_inv(t, t);
  Fe12 r;
  fe6_mul(a.c0, t, r.c0);
  fe6_mul(a.c1, t, r.c1);
  fe6_neg(r.c1, r.c1);
  o = r;
}
static void fe12_frob(const Fe12 &a, Fe12 &o) {
  Fe12 r;
  fe6_frob(a.c0, r.c0);
  fe6_frob(a.c1, r.c1);
  fe6_mul_fe2(r.c1, FROB_W, r.c1);
  o = r;
}
// pow by little-endian byte exponent
static void fe12_pow_bytes(const Fe12 &base, const uint8_t *e, size_t elen, Fe12 &o) {
  int top = -1;
  for (int i = (int)elen * 8 - 1; i >= 0; --i)
    if ((e[i / 8] >> (i % 8)) & 1) { top = i; break; }
  Fe12 acc;
  fe12_one(acc);
  if (top < 0) { o = acc; return; }
  acc = base;
  for (int i = top - 1; i >= 0; --i) {
    fe12_sqr(acc, acc);
    if ((e[i / 8] >> (i % 8)) & 1) fe12_mul(acc, base, acc);
  }
  o = acc;
}

// -- miller loop -------------------------------------------------------------

struct G2A { Fe2 x, y; };  // affine twist point, Montgomery coords

// sparse line l(P) = y_P - lam*x_P * w + (lam*x_T - y_T) * w^3
// slots: w^0 -> c0.c0 (Fq scalar), w^1 -> c1.c0, w^3 -> c1.c1
static void sparse_line(const Fe2 &lam, const Fe2 &xt, const Fe2 &yt, const Fe &xp,
                        const Fe &yp, Fe12 &o) {
  Fe12 r;
  r.c0.c0 = Fe2{yp, {{0, 0, 0, 0}}};
  r.c0.c1 = FE2_ZERO;
  r.c0.c2 = FE2_ZERO;
  Fe negxp;
  fe_neg_mod(FQ, xp, negxp);
  fe2_mul_fe(lam, negxp, r.c1.c0);
  Fe2 t;
  fe2_mul(lam, xt, t);
  fe2_sub(t, yt, r.c1.c1);
  r.c1.c2 = FE2_ZERO;
  o = r;
}

static void g2_line_dbl(G2A &t, const Fe &xp, const Fe &yp, Fe12 &line) {
  Fe2 lam, x2, denom, xr, yr, tmp;
  fe2_sqr(t.x, x2);
  Fe2 three_x2;
  fe2_add(x2, x2, three_x2);
  fe2_add(three_x2, x2, three_x2);
  fe2_add(t.y, t.y, denom);
  fe2_inv(denom, denom);
  fe2_mul(three_x2, denom, lam);
  fe2_sqr(lam, xr);
  fe2_sub(xr, t.x, xr);
  fe2_sub(xr, t.x, xr);
  fe2_sub(t.x, xr, tmp);
  fe2_mul(lam, tmp, yr);
  fe2_sub(yr, t.y, yr);
  sparse_line(lam, t.x, t.y, xp, yp, line);
  t.x = xr;
  t.y = yr;
}

static void g2_line_add(G2A &t, const G2A &q, const Fe &xp, const Fe &yp, Fe12 &line) {
  Fe2 lam, num, den, xr, yr, tmp;
  fe2_sub(q.y, t.y, num);
  fe2_sub(q.x, t.x, den);
  fe2_inv(den, den);
  fe2_mul(num, den, lam);
  fe2_sqr(lam, xr);
  fe2_sub(xr, t.x, xr);
  fe2_sub(xr, q.x, xr);
  fe2_sub(t.x, xr, tmp);
  fe2_mul(lam, tmp, yr);
  fe2_sub(yr, t.y, yr);
  sparse_line(lam, t.x, t.y, xp, yp, line);
  t.x = xr;
  t.y = yr;
}

static void g2_frob_endo(const G2A &p, G2A &o) {
  Fe2 x, y;
  fe2_conj(p.x, x);
  fe2_mul(x, FROB_V, o.x);  // xi^((p-1)/3)
  fe2_conj(p.y, y);
  fe2_mul(y, XI_P12, o.y);  // xi^((p-1)/2)
}

// f_{6x+2,Q}(P) with the two frobenius correction steps
static void miller_loop_native(const G2A &q, const Fe &xp, const Fe &yp, Fe12 &f) {
  // ATE_LOOP_COUNT = 6x+2 = 29793968203157093288 (65 bits)
  u128 loop_count = (u128)6 * 4965661367192848881ULL + 2;
  int top = 127;
  while (top >= 0 && !((loop_count >> top) & 1)) --top;
  fe12_one(f);
  G2A t = q;
  Fe12 l;
  for (int i = top - 1; i >= 0; --i) {
    fe12_sqr(f, f);
    g2_line_dbl(t, xp, yp, l);
    fe12_mul(f, l, f);
    if ((loop_count >> i) & 1) {
      g2_line_add(t, q, xp, yp, l);
      fe12_mul(f, l, f);
    }
  }
  G2A q1, q2;
  g2_frob_endo(q, q1);
  g2_frob_endo(q1, q2);
  fe2_neg(q2.y, q2.y);
  g2_line_add(t, q1, xp, yp, l);
  fe12_mul(f, l, f);
  g2_line_add(t, q2, xp, yp, l);
  fe12_mul(f, l, f);
}

// prod_i e(P_i, Q_i) == 1 with one shared final exponentiation.
// g1xy: n*64 bytes (x,y canonical); g2coords: n*128 bytes (x.c0,x.c1,y.c0,y.c1);
// inf flags per side; hard_exp: LE bytes of (p^4 - p^2 + 1)/r.
extern "C" int h2t_pairing_check(const uint8_t *g1xy, const uint8_t *g1inf,
                                 const uint8_t *g2coords, const uint8_t *g2inf,
                                 size_t n, const uint8_t *hard_exp, size_t hard_len) {
  tower_init();
  Fe12 f;
  fe12_one(f);
  for (size_t i = 0; i < n; ++i) {
    if (g1inf[i] || g2inf[i]) continue;
    Fe xp, yp, t;
    load_fe(g1xy + 64 * i, t);
    to_mont(FQ, t, xp);
    load_fe(g1xy + 64 * i + 32, t);
    to_mont(FQ, t, yp);
    G2A q;
    load_fe(g2coords + 128 * i, t);
    to_mont(FQ, t, q.x.c0);
    load_fe(g2coords + 128 * i + 32, t);
    to_mont(FQ, t, q.x.c1);
    load_fe(g2coords + 128 * i + 64, t);
    to_mont(FQ, t, q.y.c0);
    load_fe(g2coords + 128 * i + 96, t);
    to_mont(FQ, t, q.y.c1);
    Fe12 m;
    miller_loop_native(q, xp, yp, m);
    fe12_mul(f, m, f);
  }
  // easy part: f^(p^6-1) = conj(f) * f^-1, then ^(p^2+1)
  Fe12 f1, fi, f2;
  fe12_conj(f, f1);
  fe12_inv(f, fi);
  fe12_mul(f1, fi, f1);
  fe12_frob(f1, f2);
  fe12_frob(f2, f2);
  fe12_mul(f2, f1, f2);
  // hard part
  Fe12 out;
  fe12_pow_bytes(f2, hard_exp, hard_len, out);
  return fe12_is_one(out) ? 1 : 0;
}
