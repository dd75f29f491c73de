// Host stand-ins for the CUDA runtime names that csrc/field.cuh,
// csrc/curve.cuh and csrc/curve.cu's kernels use, so that g++ compiles
// their device code for the CPU (tests/test_torch_csrc_emulated.py).
#pragma once
#include <algorithm>
#include <cstdint>

#define __device__
#define __forceinline__ inline
#define __constant__
#define __global__
#define __launch_bounds__(x)
#define __restrict__

struct uint4 {
  uint32_t x, y, z, w;
};
inline uint4 make_uint4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return uint4{a, b, c, d};
}
inline uint4 __ldg(const uint4* p) { return *p; }
inline uint32_t __ldg(const uint32_t* p) { return *p; }
inline uint32_t __umulhi(uint32_t a, uint32_t b) {
  return (uint32_t)(((uint64_t)a * b) >> 32);
}

typedef int cudaError_t;

// one thread's launch coordinates (set by the harness)
struct EmuDim {
  long x = 0;
};
inline EmuDim threadIdx, blockIdx, blockDim;
using std::min;
