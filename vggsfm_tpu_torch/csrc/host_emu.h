// Host emulation of the small CUDA subset fused_former.cuh and
// corr_sample.cuh use, so their device code compiles with a plain C++20
// compiler and runs on the CPU for
// testing: one std::thread per CUDA thread, a std::barrier per block for
// __syncthreads, blocks one after another, bit-exact bfloat16 conversions
// (round to nearest even), and the 16x16x16 nvcuda::wmma calls with every
// lane holding the whole tile (f32 products and sums, k in order; lane 0
// of each warp stores). Not used by the CUDA build.
#pragma once

#include <math.h>

#include <algorithm>
#include <barrier>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <thread>
#include <type_traits>
#include <vector>

struct dim3 {
  unsigned x = 1, y = 1, z = 1;
};

inline thread_local dim3 threadIdx;
inline thread_local dim3 blockIdx;

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline

struct __nv_bfloat16 {
  uint16_t bits;
};

inline float __bfloat162float(__nv_bfloat16 v) {
  const uint32_t u = uint32_t(v.bits) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}

inline __nv_bfloat16 __float2bfloat16(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {uint16_t((u >> 16) | 0x40)};
  u += 0x7fffu + ((u >> 16) & 1u);
  return {uint16_t(u >> 16)};
}

inline float rsqrtf(float v) { return 1.0f / sqrtf(v); }

inline float emu_to_f(float v) { return v; }
inline float emu_to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

namespace nvcuda {
namespace wmma {

struct matrix_a {};
struct matrix_b {};
struct accumulator {};
struct row_major {};
struct col_major {};
enum layout_t { mem_row_major, mem_col_major };

template <typename Use, int m, int n, int k, typename T,
          typename Layout = void>
struct fragment {
  float v[16][16];
};

template <typename Use, typename T, typename Layout>
void load_matrix_sync(fragment<Use, 16, 16, 16, T, Layout>& f, const T* p,
                      unsigned ldm) {
  const bool rm = std::is_same<Layout, row_major>::value;
  for (int r = 0; r < 16; ++r)
    for (int c = 0; c < 16; ++c)
      f.v[r][c] = emu_to_f(rm ? p[r * ldm + c] : p[c * ldm + r]);
}

inline void fill_fragment(fragment<accumulator, 16, 16, 16, float>& f,
                          float x) {
  for (auto& row : f.v)
    for (auto& e : row) e = x;
}

template <typename T, typename LA, typename LB>
void mma_sync(fragment<accumulator, 16, 16, 16, float>& d,
              const fragment<matrix_a, 16, 16, 16, T, LA>& a,
              const fragment<matrix_b, 16, 16, 16, T, LB>& b,
              const fragment<accumulator, 16, 16, 16, float>& c) {
  float out[16][16];
  for (int r = 0; r < 16; ++r)
    for (int n = 0; n < 16; ++n) {
      float s = c.v[r][n];
      for (int k = 0; k < 16; ++k) s = fmaf(a.v[r][k], b.v[k][n], s);
      out[r][n] = s;
    }
  std::memcpy(d.v, out, sizeof(out));
}

inline void store_matrix_sync(float* p,
                              const fragment<accumulator, 16, 16, 16, float>& f,
                              unsigned ldm, layout_t layout) {
  if (threadIdx.x % 32 != 0) return;
  for (int r = 0; r < 16; ++r)
    for (int c = 0; c < 16; ++c) {
      if (layout == mem_row_major)
        p[r * ldm + c] = f.v[r][c];
      else
        p[c * ldm + r] = f.v[r][c];
    }
}

}  // namespace wmma
}  // namespace nvcuda

inline std::barrier<>* emu_barrier = nullptr;

inline void __syncthreads() { emu_barrier->arrive_and_wait(); }

// Runs body(smem) for every thread of `grid` x `grid_y` blocks of `threads`
// threads, blockIdx.x fastest.
template <class F>
void emu_launch(int grid, int threads, size_t smem_bytes, F body,
                int grid_y = 1) {
  std::vector<float> smem((smem_bytes + 3) / 4 + 4);
  for (int b = 0; b < grid * grid_y; ++b) {
    // fill with NaN so reads of never-written shared memory show up
    std::fill(smem.begin(), smem.end(), NAN);
    std::barrier<> bar(threads);
    emu_barrier = &bar;
    std::vector<std::thread> pool;
    pool.reserve(threads);
    for (int t = 0; t < threads; ++t)
      pool.emplace_back([&, t, b] {
        threadIdx.x = unsigned(t);
        blockIdx.x = unsigned(b % grid);
        blockIdx.y = unsigned(b / grid);
        body(reinterpret_cast<unsigned char*>(smem.data()));
      });
    for (auto& th : pool) th.join();
    emu_barrier = nullptr;
  }
}
