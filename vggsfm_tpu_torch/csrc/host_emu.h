// Host emulation of the small CUDA subset fused_former.cuh and
// corr_sample.cuh use, so their device code compiles with a plain C++20
// compiler and runs on the CPU for
// testing: one std::thread per CUDA thread, a std::barrier per block for
// __syncthreads and one per warp for __syncwarp and __shfl_xor_sync (all
// 32 lanes converged), blocks one after another, bit-exact bfloat16
// conversions
// (round to nearest even). The warp-level PTX (fused_former.cuh) is
// emulated by its documented per-lane layouts: ldmatrix and
// mma.sync.m16n8k16 exchange the lanes' registers through a per-warp
// scratch between two 32-thread barriers, and each lane then computes its
// own fragment (mma: f32 products and sums, k in order); a cp.async copy
// is held back until the cp.async.wait_group that must see it, the latest
// moment the hardware may land it, so a read of a stage before its wait
// finds stale data. Not used by the CUDA build.
#pragma once

#include <math.h>

#include <algorithm>
#include <barrier>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
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

inline float __uint_as_float(unsigned u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}

inline unsigned __float_as_uint(float f) {
  unsigned u;
  std::memcpy(&u, &f, 4);
  return u;
}

inline unsigned short __bfloat16_as_ushort(__nv_bfloat16 v) { return v.bits; }

inline std::barrier<>* emu_barrier = nullptr;

inline void __syncthreads() { emu_barrier->arrive_and_wait(); }

// ------------------------------------------- warp-level PTX of the ring path

// One warp's exchange area and its 32-thread barrier.
struct EmuWarp {
  std::barrier<>* bar;
  const void* addr[32];
  unsigned a[32][4];
  unsigned b[32][2];
  float f[32];
};

inline EmuWarp* emu_warps = nullptr;

inline EmuWarp& emu_warp() { return emu_warps[threadIdx.x / 32]; }

inline float emu_bf16_half(unsigned reg, int hi) {
  return __bfloat162float({uint16_t(hi ? reg >> 16 : reg & 0xffffu)});
}

// ldmatrix.sync.aligned.m8n8.xNM.shared.b16: lanes 8i..8i+7 give the row
// addresses of matrix i; lane l receives, of each matrix, row l / 4,
// columns 2 (l % 4) and 2 (l % 4) + 1 (the lower column in the low half).
template <int NM>
void emu_ldsm(unsigned* r, const void* p) {
  EmuWarp& w = emu_warp();
  const int lane = threadIdx.x % 32;
  w.addr[lane] = p;
  w.bar->arrive_and_wait();
  for (int i = 0; i < NM; ++i) {
    const uint16_t* row = static_cast<const uint16_t*>(w.addr[8 * i + lane / 4]);
    r[i] = unsigned(row[2 * (lane % 4)]) | unsigned(row[2 * (lane % 4) + 1]) << 16;
  }
  w.bar->arrive_and_wait();
}

inline void ldsm_x4(unsigned (&r)[4], const void* p) { emu_ldsm<4>(r, p); }
inline void ldsm_x2(unsigned (&r)[2], const void* p) { emu_ldsm<2>(r, p); }

// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, d += a b, with
// g = lane / 4, t = lane % 4: a0..a3 hold A[g][2t..2t+1], A[g+8][2t..],
// A[g][2t+8..], A[g+8][2t+8..]; b0, b1 hold B[2t..2t+1][g], B[2t+8..][g];
// d0..d3 are D[g][2t], D[g][2t+1], D[g+8][2t], D[g+8][2t+1].
inline void mma_16816(float (&d)[4], const unsigned (&a)[4],
                      const unsigned (&b)[2]) {
  EmuWarp& w = emu_warp();
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  for (int i = 0; i < 4; ++i) w.a[lane][i] = a[i];
  for (int i = 0; i < 2; ++i) w.b[lane][i] = b[i];
  w.bar->arrive_and_wait();
  for (int i = 0; i < 4; ++i) {
    const int r = g + 8 * (i / 2), n = 2 * t + i % 2;
    float s = d[i];
    for (int k = 0; k < 16; ++k) {
      const float av = emu_bf16_half(
          w.a[(r % 8) * 4 + (k % 8) / 2][r / 8 + 2 * (k / 8)], k % 2);
      const float bv = emu_bf16_half(w.b[n * 4 + (k % 8) / 2][k / 8], k % 2);
      s = fmaf(av, bv, s);
    }
    d[i] = s;
  }
  w.bar->arrive_and_wait();
}

// __syncwarp and the xor shuffle (corr_sample.cuh). Each is a 32-thread
// barrier of the warp, so all 32 lanes must reach it together
// (converged), as the kernels call them; a lane that skipped one would
// deadlock the emulation where the hardware's behaviour is undefined. The
// shuffle writes the lane's value to the warp's area between two
// barriers and reads the source lane's.
inline void __syncwarp(unsigned = 0xffffffffu) {
  emu_warp().bar->arrive_and_wait();
}

inline float __shfl_xor_sync(unsigned, float v, int lane_mask) {
  EmuWarp& w = emu_warp();
  const int lane = threadIdx.x % 32;
  w.f[lane] = v;
  w.bar->arrive_and_wait();
  const float r = w.f[(lane ^ lane_mask) % 32];
  w.bar->arrive_and_wait();
  return r;
}

// cp.async.cg.shared.global (16 bytes), commit_group, wait_group N
struct EmuCopy {
  void* dst;
  const void* src;
  long group;
};

inline thread_local std::vector<EmuCopy> emu_copies;
inline thread_local long emu_groups = 0;

inline void cp_async_16(void* dst, const void* src) {
  emu_copies.push_back({dst, src, emu_groups});
}

inline void cp_async_commit() { ++emu_groups; }

// lands every copy but those of the N most recently committed groups
template <int N>
void cp_async_wait() {
  const long done = emu_groups - N;
  std::vector<EmuCopy> left;
  for (const EmuCopy& c : emu_copies) {
    if (c.group < done)
      std::memcpy(c.dst, c.src, 16);
    else
      left.push_back(c);
  }
  emu_copies.swap(left);
}

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
    const int nwarps = (threads + 31) / 32;
    std::vector<std::unique_ptr<std::barrier<>>> warp_bars;
    std::vector<EmuWarp> warps(nwarps);
    for (int w = 0; w < nwarps; ++w) {
      warp_bars.push_back(std::make_unique<std::barrier<>>(
          std::min(32, threads - 32 * w)));
      warps[w].bar = warp_bars.back().get();
    }
    emu_warps = warps.data();
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
    emu_warps = nullptr;
  }
}
