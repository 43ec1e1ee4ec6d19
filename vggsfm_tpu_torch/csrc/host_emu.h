// Host emulation of the small CUDA subset fused_former.cuh, corr_sample.cuh
// and flash_attn.cuh use, so their device code compiles with a plain C++20
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
// finds stale data. The Hopper instructions of flash_attn.cuh (mbarrier,
// TMA, named barriers, wgmma) are emulated further down, in the same
// spirit. Not used by the CUDA build.
#pragma once

#include <math.h>

#include <algorithm>
#include <barrier>
#include <chrono>
#include <condition_variable>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
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

// ------------------------------------------ Hopper: mbarrier, TMA, wgmma
//
// What flash_attn.cuh's warp-specialised kernel uses. A shared-memory
// address (smem_u32) is the byte offset from the block's shared memory,
// so the hardware's address-bit swizzle is reproduced exactly; the
// block's synchronisation state sits in one EmuBlock (one mutex, one
// condition variable), and a wait that sees no signal for 60 s aborts
// with the name of the barrier's kind (a deadlock of the kernel's
// protocol).
//  * mbarrier init, arrive, arrive.expect_tx and try_wait.parity: a phase
//    completes when its pending arrivals and its transaction bytes are
//    both 0; a wait on parity P returns once the current phase's parity is
//    not P (so the first wait on parity 1 passes at once).
//  * TMA tile loads (cp.async.bulk.tensor.3d ... complete_tx::bytes): held
//    on the mbarrier they signal and landed by the first wait on it, the
//    latest moment the hardware may land them, so a read of a stage
//    before its wait finds stale data; elements out of the tensor's bounds
//    read as 0, and the 128-byte swizzle XORs address bits [4, 7) with
//    bits [7, 10) of the destination.
//  * named barriers (bar.sync, bar.arrive with an id and a thread count),
//    counted a thread at a time; every one must be balanced when the block
//    ends.
//  * wgmma.mma_async m64nNk16, f32 += bf16 x bf16: the 128 threads of the
//    warpgroup meet and must give the same descriptors; each then computes
//    its own accumulator fragment (register i: row 16 warp + lane / 4 +
//    8 ((i >> 1) & 1), column 8 (i >> 2) + 2 (lane % 4) + (i & 1)) from
//    the operands as they are at issue, k in order: A from the warpgroup's
//    registers (mma.sync's A fragment a warp of 16 rows) or a descriptor,
//    B from a descriptor, K-major or (B) MN-major, 128-byte swizzled. The
//    result is held until the wgmma.wait_group that must see it
//    (commit_group closes a group), so a read of an accumulator before its
//    wait finds the old values; a later wgmma on the same accumulator
//    chains onto the held result, as the hardware orders them.
//  * fence.mbarrier_init, wgmma.fence and setmaxnreg: no-ops.

struct CUtensorMap {  // stands in for the driver's opaque tensor map
  const unsigned char* base;
  uint64_t dim[3];
  uint64_t stride[3];  // bytes; stride[0] is the element size
  uint32_t box[3];
  int swizzle;  // bytes: 0 or 128
};

struct EmuTma {
  unsigned dst;
  CUtensorMap map;
  int c[3];
};

struct EmuMbar {
  int expected = 0, pending = 0, phase = 0;
  long tx = 0;
  std::vector<EmuTma> copies;
};

struct EmuNamed {
  int arrived = 0, count = 0;
  long gen = 0;
};

// one warpgroup's exchange area for wgmma
struct EmuGroup {
  std::barrier<>* bar;
  unsigned a[128][4];
  uint64_t desc[128][2];
};

struct EmuBlock {
  unsigned char* smem;
  std::mutex mu;
  std::condition_variable cv;
  std::map<unsigned, EmuMbar> mbars;
  EmuNamed named[16];
  EmuGroup* groups;
};

inline EmuBlock* emu_block = nullptr;

[[noreturn]] inline void emu_fail(const char* what) {
  std::fprintf(stderr, "host_emu: %s (block %u, %u; thread %u)\n", what,
               blockIdx.x, blockIdx.y, threadIdx.x);
  std::abort();
}

inline unsigned smem_u32(const void* p) {
  return unsigned(static_cast<const unsigned char*>(p) - emu_block->smem);
}

inline unsigned emu_swizzle128(unsigned a) {
  return a ^ (((a >> 7) & 7u) << 4);
}

// waits on the block's condition variable until done(); aborts after 60 s
// in which no thread of the block signalled anything
template <class P>
void emu_block_wait(std::unique_lock<std::mutex>& lk, P done,
                    const char* what) {
  while (!done())
    if (emu_block->cv.wait_for(lk, std::chrono::seconds(60)) ==
            std::cv_status::timeout &&
        !done())
      emu_fail(what);
}

inline EmuMbar& emu_mbar(const uint64_t* bar) {
  auto it = emu_block->mbars.find(smem_u32(bar));
  if (it == emu_block->mbars.end())
    emu_fail("mbarrier used before mbarrier.init");
  return it->second;
}

inline void emu_mbar_try_complete(EmuMbar& b) {
  if (b.pending == 0 && b.tx == 0 && b.copies.empty()) {
    ++b.phase;
    b.pending = b.expected;
    emu_block->cv.notify_all();
  }
}

inline void mbar_init(uint64_t* bar, unsigned count) {
  std::lock_guard<std::mutex> lk(emu_block->mu);
  EmuMbar& b = emu_block->mbars[smem_u32(bar)];
  b = EmuMbar();
  b.expected = b.pending = int(count);
}

inline void mbar_fence_init() {}

inline void emu_mbar_arrive(uint64_t* bar, long tx) {
  std::lock_guard<std::mutex> lk(emu_block->mu);
  EmuMbar& b = emu_mbar(bar);
  b.tx += tx;
  if (--b.pending < 0) emu_fail("mbarrier: more arrivals than its count");
  emu_mbar_try_complete(b);
}

inline void mbar_arrive(uint64_t* bar) { emu_mbar_arrive(bar, 0); }

inline void mbar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  emu_mbar_arrive(bar, long(bytes));
}

inline long emu_tma_bytes(const EmuTma& c) {
  return long(c.map.box[0]) * c.map.box[1] * c.map.box[2] *
         long(c.map.stride[0]);
}

inline void emu_tma_land(const EmuTma& c) {
  const CUtensorMap& m = c.map;
  const unsigned es = unsigned(m.stride[0]);
  unsigned off = c.dst;
  for (uint32_t z = 0; z < m.box[2]; ++z)
    for (uint32_t y = 0; y < m.box[1]; ++y)
      for (uint32_t x = 0; x < m.box[0]; ++x, off += es) {
        const long g[3] = {long(c.c[0]) + x, long(c.c[1]) + y,
                           long(c.c[2]) + z};
        unsigned char* dst =
            emu_block->smem + (m.swizzle ? emu_swizzle128(off) : off);
        if (g[0] >= 0 && g[0] < long(m.dim[0]) && g[1] >= 0 &&
            g[1] < long(m.dim[1]) && g[2] >= 0 && g[2] < long(m.dim[2]))
          std::memcpy(dst, m.base + g[0] * es + g[1] * m.stride[1] +
                               g[2] * m.stride[2], es);
        else
          std::memset(dst, 0, es);
      }
}

inline void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1,
                        int c2, uint64_t* bar) {
  const unsigned d = smem_u32(dst);
  if (d % (map->swizzle ? 1024u : 128u))
    emu_fail("TMA destination not aligned to its swizzle");
  std::lock_guard<std::mutex> lk(emu_block->mu);
  emu_mbar(bar).copies.push_back({d, *map, {c0, c1, c2}});
  emu_block->cv.notify_all();  // a waiter lands it
}

// returns once the phase of parity `parity` has completed; lands the
// copies the barrier waits for
inline void mbar_wait(uint64_t* bar, unsigned parity) {
  std::unique_lock<std::mutex> lk(emu_block->mu);
  EmuMbar& b = emu_mbar(bar);
  emu_block_wait(lk, [&] {
    if (unsigned(b.phase & 1) != parity) return true;
    if (!b.copies.empty()) {
      for (const EmuTma& c : b.copies) {
        emu_tma_land(c);
        b.tx -= emu_tma_bytes(c);
      }
      b.copies.clear();
      emu_mbar_try_complete(b);
    }
    return unsigned(b.phase & 1) != parity;
  }, "mbarrier wait saw no signal in 60 s");
}

inline void emu_named(int id, int count, bool wait) {
  if (id < 0 || id >= 16 || count <= 0 || count % 32)
    emu_fail("named barrier: bad id or thread count");
  std::unique_lock<std::mutex> lk(emu_block->mu);
  EmuNamed& n = emu_block->named[id];
  if (n.arrived && n.count != count)
    emu_fail("named barrier: thread counts differ");
  n.count = count;
  const long gen = n.gen;
  if (++n.arrived == count) {
    n.arrived = 0;
    ++n.gen;
    emu_block->cv.notify_all();
    return;
  }
  if (wait)
    emu_block_wait(lk, [&] { return n.gen != gen; },
                   "named barrier saw no signal in 60 s");
}

inline void named_bar_sync(int id, int count) { emu_named(id, count, true); }
inline void named_bar_arrive(int id, int count) {
  emu_named(id, count, false);
}

template <int N>
void setmaxnreg_inc() {}
template <int N>
void setmaxnreg_dec() {}

// a thread's wgmma results not yet waited on
struct EmuAcc {
  float* d;
  std::vector<float> val;
  long group;
};

inline thread_local std::vector<EmuAcc> emu_accs;
inline thread_local long emu_wg_groups = 0;

inline void wgmma_fence() {}
inline void wgmma_commit() { ++emu_wg_groups; }

// lands the results of every committed group but the N most recent
template <int N>
void wgmma_wait() {
  const long done = emu_wg_groups - N;
  std::vector<EmuAcc> left;
  for (EmuAcc& a : emu_accs) {
    if (a.group < done)
      std::copy(a.val.begin(), a.val.end(), a.d);
    else
      left.push_back(std::move(a));
  }
  emu_accs.swap(left);
}

// element (mn, k) of a 128-byte swizzled operand: K-major (rows of mn,
// 8-row groups `sbo` apart) or MN-major (rows of k, 8-row groups `sbo`
// apart, 64-wide mn atoms `lbo` apart)
inline float emu_desc_elem(uint64_t desc, int mn, int k, bool mn_major) {
  if ((desc >> 62) != 1 || ((desc >> 49) & 7))
    emu_fail("wgmma: only the 128-byte swizzle at base offset 0");
  const unsigned start = unsigned(desc & 0x3fff) << 4;
  const unsigned lbo = unsigned((desc >> 16) & 0x3fff) << 4;
  const unsigned sbo = unsigned((desc >> 32) & 0x3fff) << 4;
  const unsigned a =
      mn_major ? start + (mn / 64) * lbo + (k / 8) * sbo + (k % 8) * 128 +
                     (mn % 64) * 2
               : start + (mn / 8) * sbo + (mn % 8) * 128 + k * 2;
  uint16_t v;
  std::memcpy(&v, emu_block->smem + emu_swizzle128(a), 2);
  return __bfloat162float({v});
}

// wgmma.mma_async.sync.aligned.m64nNk16.f32.bf16.bf16: d = (scale_d ? d :
// 0) + A B, A from `a_regs` (4 registers a thread) or `a_desc` (K-major),
// B from `b_desc` (N x 16, K-major, or MN-major if `b_mn_major`)
template <int N>
void emu_wgmma(float* d, const unsigned* a_regs, uint64_t a_desc,
               uint64_t b_desc, int scale_d, bool b_mn_major) {
  EmuGroup& w = emu_block->groups[threadIdx.x / 128];
  const int tid = threadIdx.x % 128;
  if (a_regs) std::memcpy(w.a[tid], a_regs, sizeof w.a[tid]);
  w.desc[tid][0] = a_regs ? 0 : a_desc;
  w.desc[tid][1] = b_desc;
  w.bar->arrive_and_wait();
  if (w.desc[tid][0] != w.desc[0][0] || w.desc[tid][1] != w.desc[0][1])
    emu_fail("wgmma: the warpgroup's threads give different operands");
  EmuAcc* held = nullptr;
  for (EmuAcc& a : emu_accs)
    if (a.d == d) held = &a;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  std::vector<float> val(N / 2);
  for (int i = 0; i < N / 2; ++i) {
    const int row = 16 * warp + g + 8 * ((i >> 1) & 1);
    const int col = 8 * (i >> 2) + 2 * t + (i & 1);
    float s = scale_d ? (held ? held->val[i] : d[i]) : 0.f;
    for (int k = 0; k < 16; ++k) {
      const int r = row % 16;
      const float av =
          a_regs ? emu_bf16_half(w.a[32 * (row / 16) + (r % 8) * 4 +
                                     (k % 8) / 2][r / 8 + 2 * (k / 8)],
                                 k % 2)
                 : emu_desc_elem(a_desc, row, k, false);
      s = fmaf(av, emu_desc_elem(b_desc, col, k, b_mn_major), s);
    }
    val[i] = s;
  }
  w.bar->arrive_and_wait();
  if (held) {
    held->val = std::move(val);
    held->group = emu_wg_groups;
  } else {
    emu_accs.push_back({d, std::move(val), emu_wg_groups});
  }
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
    const int ngroups = (threads + 127) / 128;
    std::vector<std::unique_ptr<std::barrier<>>> group_bars;
    std::vector<EmuGroup> groups(ngroups);
    for (int w = 0; w < ngroups; ++w) {
      group_bars.push_back(std::make_unique<std::barrier<>>(
          std::min(128, threads - 128 * w)));
      groups[w].bar = group_bars.back().get();
    }
    EmuBlock block;
    block.smem = reinterpret_cast<unsigned char*>(smem.data());
    block.groups = groups.data();
    emu_block = &block;
    std::vector<std::thread> pool;
    pool.reserve(threads);
    for (int t = 0; t < threads; ++t)
      pool.emplace_back([&, t, b] {
        threadIdx.x = unsigned(t);
        blockIdx.x = unsigned(b % grid);
        blockIdx.y = unsigned(b / grid);
        body(reinterpret_cast<unsigned char*>(smem.data()));
        if (!emu_accs.empty()) emu_fail("a wgmma result was never waited on");
      });
    for (auto& th : pool) th.join();
    for (const EmuNamed& n : block.named)
      if (n.arrived) emu_fail("a named barrier is unbalanced at the block's end");
    for (const auto& kv : block.mbars)
      if (!kv.second.copies.empty())
        emu_fail("a TMA copy was never waited on");
    emu_block = nullptr;
    emu_barrier = nullptr;
    emu_warps = nullptr;
  }
}
