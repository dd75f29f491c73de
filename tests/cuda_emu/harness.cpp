// Drives csrc/field.cuh, csrc/curve.cuh and csrc/curve.cu's kernels on the
// CPU (headers prepared by tests/test_torch_csrc_emulated.py). Reads one
// command a line, words in hex, and prints each result's words:
//   mul|add|sub F a b           mont_mul / mod_add / mod_sub on field F
//   mds F a0 b0 .. a8 b8        redc(sum of 9 wide products, 3 subtracts)
//   fadd p q / madd p x y       full_add / mixed_add (Fq, points x y z)
//   fb n scalars... table...    fixed_base_kernel over n scalars
#include <cstdio>
#include <iostream>
#include <string>
#include <vector>

#include "curve_kernels.h"

using namespace h2t;

static Fe rd() {
  Fe r;
  for (auto& w : r.w) std::cin >> std::hex >> w;
  return r;
}
static void wr(const Fe& a) {
  for (auto w : a.w) printf("%08x ", w);
}
static Pt rdp() {
  Fe x = rd(), y = rd(), z = rd();
  return Pt{x, y, z};
}

static void fixed_base() {
  long n;
  std::cin >> std::dec >> n;
  std::vector<uint32_t> sc(n * 8), table(8192 * 24), out(n * 24);
  for (auto& w : sc) std::cin >> std::hex >> w;
  for (auto& w : table) std::cin >> std::hex >> w;
  blockDim.x = kCurveThreads;
  for (long t = 0; t < n; t++) {
    blockIdx.x = t / kCurveThreads;
    threadIdx.x = t % kCurveThreads;
    fixed_base_kernel(sc.data(), table.data(), out.data(), n);
  }
  for (auto w : out) printf("%08x ", w);
}

int main() {
  std::string op;
  while (std::cin >> op) {
    try {
      if (op == "fb") {
        fixed_base();
      } else if (op == "fadd") {
        Pt p = rdp(), q = rdp();
        Pt r = full_add(p, q);
        wr(r.x), wr(r.y), wr(r.z);
      } else if (op == "madd") {
        Pt p = rdp();
        Fe x = rd(), y = rd();
        Pt r = mixed_add(p, x, y);
        wr(r.x), wr(r.y), wr(r.z);
      } else {
        int f;
        std::cin >> std::dec >> f;
        if (op == "mds") {
          Wide t;
          wide_zero(t);
          for (int j = 0; j < 9; j++) {
            Fe a = rd(), b = rd();
            wide_mac(t, a, b);
          }
          wr(f ? redc<kFq>(t, 3) : redc<kFr>(t, 3));
        } else {
          Fe a = rd(), b = rd();
          if (op == "mul") wr(f ? mont_mul<kFq>(a, b) : mont_mul<kFr>(a, b));
          if (op == "add") wr(f ? mod_add<kFq>(a, b) : mod_add<kFr>(a, b));
          if (op == "sub") wr(f ? mod_sub<kFq>(a, b) : mod_sub<kFr>(a, b));
        }
      }
    } catch (const std::exception& e) {
      printf("ERROR %s", e.what());
    }
    printf("\n");
    fflush(stdout);
  }
}
