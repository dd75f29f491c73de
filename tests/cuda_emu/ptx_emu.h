// The PTX carry-chain instructions of csrc/field.cuh's `namespace ptx`,
// emulated with one carry flag a thread. An instruction throws when it
// reads the flag after one that left it undefined, or after one of the
// other kind (an add reading a subtract's flag, or the reverse: the card's
// flag after a subtract is not the borrow that an add would read), or
// when a chain end that the header declares carry-free (addc, madc.hi
// without .cc) carries.
#pragma once
#include <cstdint>
#include <stdexcept>

namespace ptx {

enum Flag : uint32_t { kUndefined, kAddCarry, kSubBorrow };
inline thread_local Flag kind = kUndefined;  // what set the flag
inline thread_local uint32_t CF = 0;         // its value

inline uint32_t read_cf(Flag want) {
  if (kind != want)
    throw std::runtime_error(kind == kUndefined ? "carry flag read while undefined"
                                                : "carry flag of the other kind read");
  return CF;
}
inline uint32_t end(uint64_t s, bool carry_free) {
  if (carry_free && (s >> 32)) throw std::runtime_error("carry out of a carry-free chain end");
  kind = kUndefined;
  return (uint32_t)s;
}
inline uint32_t out(uint64_t s) {
  CF = (uint32_t)(s >> 32);
  kind = kAddCarry;
  return (uint32_t)s;
}
inline uint32_t borrow_out(uint32_t a, uint64_t bb) {
  CF = a < bb;
  kind = kSubBorrow;
  return (uint32_t)(a - bb);
}
inline uint64_t lo(uint32_t a, uint32_t b) { return (uint32_t)(a * b); }
inline uint64_t hi(uint32_t a, uint32_t b) { return ((uint64_t)a * b) >> 32; }

inline uint32_t add_cc(uint32_t a, uint32_t b) { return out((uint64_t)a + b); }
inline uint32_t addc_cc(uint32_t a, uint32_t b) { return out((uint64_t)a + b + read_cf(kAddCarry)); }
inline uint32_t addc(uint32_t a, uint32_t b) { return end((uint64_t)a + b + read_cf(kAddCarry), true); }
inline uint32_t sub_cc(uint32_t a, uint32_t b) { return borrow_out(a, b); }
inline uint32_t subc_cc(uint32_t a, uint32_t b) {
  return borrow_out(a, (uint64_t)b + read_cf(kSubBorrow));
}
inline uint32_t subc(uint32_t a, uint32_t b) {
  const uint64_t bb = (uint64_t)b + read_cf(kSubBorrow);
  kind = kUndefined;
  return (uint32_t)(a - bb);
}
inline uint32_t mad_lo_cc(uint32_t a, uint32_t b, uint32_t c) { return out(lo(a, b) + c); }
inline uint32_t madc_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  return out(lo(a, b) + c + read_cf(kAddCarry));
}
// the chain end of a modular sum wraps by design (mod_sub adds p back)
inline uint32_t madc_lo(uint32_t a, uint32_t b, uint32_t c) {
  return end(lo(a, b) + c + read_cf(kAddCarry), false);
}
inline uint32_t madc_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
  return out(hi(a, b) + c + read_cf(kAddCarry));
}
inline uint32_t madc_hi(uint32_t a, uint32_t b, uint32_t c) {
  return end(hi(a, b) + c + read_cf(kAddCarry), true);
}

}  // namespace ptx
