// Device code of the long-sequence attention forward (flash_attn.cu holds
// the kernel, its tensor maps and its C entry point).
//
// Replaces no TPU kernel: the JAX package attends over a few thousand
// tokens at most and leaves that to XLA. It was added for VGGT-1B
// (models/vggt.py), whose global blocks attend over every token of a
// scene (L = S x 1374, 65,952 at 48 frames), where the plain route's
// (L, L) scores would take 278 GB a layer; its frame blocks and its
// DINOv2 ViT-L take it at L = 1374.
//
// The function: out[b, i, h, :] = softmax_j(q[bh, i] . k[bh, j] / sqrt(64))
// v[bh, j] for bf16 q, k, v of shape (B*H, L, 64), non-causal, any L >= 1;
// out is bf16 (B, L, H * 64), the layout the out-projection reads.
//
// What bounds it on an H100: per score 2 x 64 multiply-adds for q.k and as
// many for p.v (256 FLOP on the tensor cores, 989 TFLOP/s) against one
// exponential on the special-function units (16 a clock per SM, about 3.9
// T/s on the card). At head width 64 the two bounds are equal within 1%,
// and both are far above the bytes (q, k, v and out read or written once),
// so the kernel can near its bound only if the exponentials of one set of
// rows run while the tensor cores multiply another's. The design
// (FlashAttention-3, arXiv:2407.08608, warp-specialised):
//   * a block of 384 threads owns 128 query rows of one (batch, head):
//     warpgroup 0 is the producer, warpgroups 1 and 2 the consumers, 64
//     rows each, so every K/V tile brought in serves 128 rows. The grid
//     walks one head's query tiles before the next, so the blocks in flight
//     read the same K and V (16.9 MB a head at L = 65,952) from L2;
//   * one thread of the producer keeps K/V tiles of 128 keys in flight
//     through a ring of kStages stages: TMA tile loads (tensor maps built
//     per call by the entry point) into the 128-byte swizzled layout that
//     wgmma reads, each signalling a "full" mbarrier with its bytes; the
//     consumers hand a stage back through its "empty" mbarrier once their
//     p.v has read it. TMA zero-fills rows past L, in q, k and v alike.
//     The consumers issue no copies and never wait on the whole block;
//   * the products run on wgmma, accumulators in f32 registers: q.k as
//     m64n128k16 with q and K read from shared memory by descriptor; p.v
//     as m64n64k16 with the probabilities as the register A operand (the
//     score accumulator's layout is the A fragment's, so they never touch
//     shared memory) and V read MN-major;
//   * the two consumers take turns on the tensor cores (ping-pong), each
//     issuing its products between a bar.sync on its own named barrier
//     and a bar.arrive on the other's, so one warpgroup's softmax (max,
//     ex2.approx, row sums, the bf16 pack) runs while the other's
//     products run. Inside a warpgroup, tile j + 1's q.k is issued with
//     tile j's p.v, and its softmax starts as soon as q.k is done, while
//     p.v still runs;
//   * online softmax in f32: the scores' scale (log2(e) / 8) folds into
//     one FFMA before each ex2; each lane keeps partial row sums, added
//     across the lane quad once at the end. The probabilities are rounded
//     to bf16 once, before p.v; keys past L are masked on the last key
//     tile only, and rows past L are not stored;
//   * setmaxnreg gives the consumers 240 registers a thread and leaves the
//     producer 24 (one block of 384 threads an SM).
// Shared memory: q (16 KB), kStages stages of K and V (32 KB each), the
// mbarriers, and 1 KB to align the tiles to the swizzle's 1024-byte period.
//
// The same source builds for the CPU against host_emu.h (attn_emu.cpp),
// whose emulation of each Hopper instruction used here (mbarrier, TMA with
// its swizzle and zero fill, named barriers, wgmma's descriptor, register
// and accumulator layouts, wgmma fence / commit / wait, setmaxnreg) runs
// this device code for the tests.
#pragma once

#ifdef __CUDACC__
#include <cuda.h>
#include <cuda_bf16.h>
#endif

#include <math.h>
#include <stdint.h>

namespace vfa {

constexpr int kD = 64;             // head width: one 128-byte swizzled row
constexpr int kBM = 128;           // query rows a block
constexpr int kWM = 64;            // query rows a consumer warpgroup
constexpr int kBN = 128;           // keys a tile
constexpr int kStages = 4;         // K/V ring depth
constexpr int kThreads = 384;      // producer + two consumer warpgroups
constexpr int kRowBytes = kD * 2;
constexpr int kQBytes = kBM * kRowBytes;     // 16 KB
constexpr int kTileBytes = kBN * kRowBytes;  // 16 KB, one K or V tile
constexpr int kBarOffset = kQBytes + 2 * kStages * kTileBytes;
constexpr int kNumBars = 1 + 3 * kStages;  // q; full K, full V, empty
constexpr int kSmemBytes = 1024 + kBarOffset + 8 * kNumBars;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

#ifdef __CUDACC__
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned a = smem_u32(bar);
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of a 3-d tensor map into shared memory, completing its bytes on
// `bar`
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void named_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void named_bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving a read or write of an accumulator across
// the wgmma that owns it
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

#define VFA_ACC8(b)                                                     \
  "+f"(d[b]), "+f"(d[b + 1]), "+f"(d[b + 2]), "+f"(d[b + 3]),          \
      "+f"(d[b + 4]), "+f"(d[b + 5]), "+f"(d[b + 6]), "+f"(d[b + 7])

// d (64 x 128, f32) = (scale_d ? d : 0) + a b: a 64 x 16 and b 128 x 16,
// both K-major in shared memory
__device__ __forceinline__ void wgmma_qk(float (&d)[64], uint64_t a,
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : VFA_ACC8(0), VFA_ACC8(8), VFA_ACC8(16), VFA_ACC8(24), VFA_ACC8(32),
        VFA_ACC8(40), VFA_ACC8(48), VFA_ACC8(56)
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 64, f32) += a b: a 64 x 16 bf16 in registers (the A fragment),
// b 16 x 64 MN-major in shared memory
__device__ __forceinline__ void wgmma_pv(float (&d)[32],
                                         const unsigned* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : VFA_ACC8(0), VFA_ACC8(8), VFA_ACC8(16), VFA_ACC8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef VFA_ACC8

// 2^x on the special-function unit (2^-inf = +0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
#else
inline void wgmma_qk(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  emu_wgmma<128>(d, nullptr, a, b, scale_d, false);
}
inline void wgmma_pv(float (&d)[32], const unsigned* a, uint64_t b) {
  emu_wgmma<64>(d, a, 0, b, 1, true);
}
inline void fence_operand(float&) {}
inline float fast_exp2(float x) { return exp2f(x); }
#endif

// wgmma's shared-memory matrix descriptor of a 128-byte swizzled tile at
// `p` (1024-byte aligned but for a K offset inside the swizzle's row):
// start address, leading and stride byte offsets, each in 16-byte units
__device__ __forceinline__ uint64_t sw128_desc(const void* p, unsigned lbo,
                                               unsigned sbo) {
  return uint64_t((smem_u32(p) & 0x3ffffu) >> 4) | uint64_t(lbo >> 4) << 16
         | uint64_t(sbo >> 4) << 32 | uint64_t(1) << 62;
}

// two f32 values rounded to bf16 and packed, the first in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const unsigned l = __bfloat16_as_ushort(__float2bfloat16(lo));
  const unsigned h = __bfloat16_as_ushort(__float2bfloat16(hi));
  return l | (h << 16);
}

// One consumer warpgroup `c`: query rows [row0 + 64 c, +64) of head bh.
// Accumulator register i of a thread holds row 16 warp + g + 8 ((i >> 1) & 1)
// and column 8 (i >> 2) + 2 t + (i & 1) of the warpgroup's tile.
__device__ __forceinline__ void attn_consumer(
    int c, unsigned char* smem, uint64_t* q_full, uint64_t* full_k,
    uint64_t* full_v, uint64_t* empty, __nv_bfloat16* __restrict__ out,
    int L, int H, float scale) {
  const int tc = threadIdx.x % 128, warp = tc / 32, lane = tc % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.y, row0 = kBM * blockIdx.x;
  const int tiles = (L + kBN - 1) / kBN;
  unsigned char* sq = smem + c * (kQBytes / 2);
  unsigned char* sk = smem + kQBytes;
  unsigned char* sv = sk + kStages * kTileBytes;
  // named barrier 1 + c: this warpgroup's turn on the tensor cores
  const int own = 1 + c, other = 2 - c;
  if (c == 0) named_bar_arrive(own, 256);  // consumer 0 goes first

  float o[kD / 2];       // output accumulator, 64 rows x 64
  float s[kBN / 2];      // scores, then probabilities: 64 rows x 128 keys
  unsigned p[kBN / 4];   // probabilities as bf16 A fragments
  float m[2], l[2], alpha[2];  // rows g, g + 8: running max (scaled), sum
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) o[i] = 0.f;
  m[0] = m[1] = -INFINITY;
  l[0] = l[1] = 0.f;

  // q.k of tile j into s (the caller commits)
  auto issue_qk = [&](int j) {
    unsigned char* kt = sk + (j % kStages) * kTileBytes;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wgmma_qk(s, sw128_desc(sq + 32 * kk, 16, 1024),
               sw128_desc(kt + 32 * kk, 16, 1024), kk);
  };
  // o += p v of tile j (the caller commits)
  auto issue_pv = [&](int j) {
    unsigned char* vt = sv + (j % kStages) * kTileBytes;
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
      wgmma_pv(o, p + 4 * kk, sw128_desc(vt + 16 * kRowBytes * kk, 1024, 1024));
  };
  // online softmax of tile j's scores in s, keys past L masked on the last
  // tile; s becomes the probabilities, alpha the factor of the old sums
  auto softmax = [&](int j) {
    if (j == tiles - 1) {
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i)
        if (kBN * j + 8 * (i >> 2) + 2 * t + (i & 1) >= L) s[i] = -INFINITY;
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mn = fmaxf(m[r], mx[r] * scale);
      alpha[r] = fast_exp2(m[r] - mn);  // 0 on the first tile
      m[r] = mn;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) {
      const int r = (i >> 1) & 1;
      s[i] = fast_exp2(fmaf(s[i], scale, -m[r]));
      l[r] += s[i];
    }
  };
  auto pack = [&]() {
#pragma unroll
    for (int i = 0; i < kBN / 4; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
  };
  auto rescale = [&]() {
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
  };

  mbar_wait(q_full, 0);
  mbar_wait(full_k, 0);
  named_bar_sync(own, 256);
  wgmma_fence();
  issue_qk(0);
  wgmma_commit();
  named_bar_arrive(other, 256);
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) fence_operand(s[i]);
  softmax(0);
  pack();

  for (int j = 1; j < tiles; ++j) {
    const int pj = j - 1;
    rescale();
    mbar_wait(full_k + j % kStages, (j / kStages) & 1);
    mbar_wait(full_v + pj % kStages, (pj / kStages) & 1);
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) fence_operand(o[i]);
    named_bar_sync(own, 256);
    wgmma_fence();
    issue_qk(j);
    wgmma_commit();
    issue_pv(pj);
    wgmma_commit();
    named_bar_arrive(other, 256);
    wgmma_wait<1>();  // q.k of tile j done, p.v of tile j - 1 may run on
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) fence_operand(s[i]);
    softmax(j);
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) fence_operand(o[i]);
    if (tc == 0) mbar_arrive(empty + pj % kStages);
    pack();
  }

  const int lj = tiles - 1;
  rescale();
  mbar_wait(full_v + lj % kStages, (lj / kStages) & 1);
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) fence_operand(o[i]);
  named_bar_sync(own, 256);
  wgmma_fence();
  issue_pv(lj);
  wgmma_commit();
  // consumer 1's turns are all taken: it owes consumer 0 no further one
  if (c == 0) named_bar_arrive(other, 256);
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) fence_operand(o[i]);

  // the row sums across the lane quad, then out = o / l in bf16
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = 1.f / l[r];
  }
  const int b = bh / H, h = bh % H;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + kWM * c + 16 * warp + g + 8 * r;
    if (row >= L) continue;
    __nv_bfloat16* dst = out + ((size_t(b) * L + row) * H + h) * kD + 2 * t;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      const unsigned pk =
          pack_bf16(o[4 * j + 2 * r] * l[r], o[4 * j + 2 * r + 1] * l[r]);
      *reinterpret_cast<unsigned*>(dst + 8 * j) = pk;
    }
  }
}

// One block: query rows [128 blockIdx.x, +128) of head bh = blockIdx.y.
// tq, tk, tv: tensor maps of q, k, v (BH, L, 64) with 128-byte swizzle,
// boxes of 64 (q) and 128 (k, v) rows; out: (B, L, H, 64) with b = bh / H,
// h = bh % H. `scale` is log2(e) / sqrt(64). `smem_raw`: kSmemBytes.
__device__ inline void attn_body(const CUtensorMap* tq, const CUtensorMap* tk,
                                 const CUtensorMap* tv,
                                 __nv_bfloat16* __restrict__ out, int L,
                                 int H, float scale,
                                 unsigned char* smem_raw) {
  unsigned char* smem = smem_raw + (1024 - smem_u32(smem_raw) % 1024) % 1024;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + kBarOffset);
  uint64_t* full_k = q_full + 1;
  uint64_t* full_v = full_k + kStages;
  uint64_t* empty = full_v + kStages;
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k + s, 1);
      mbar_init(full_v + s, 1);
      mbar_init(empty + s, 2);  // one arrival from each consumer
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid < 128) {  // the producer warpgroup: one thread issues every copy
    setmaxnreg_dec<kProducerRegs>();
    if (tid == 0) {
      const int bh = blockIdx.y, row0 = kBM * blockIdx.x;
      const int tiles = (L + kBN - 1) / kBN;
      mbar_arrive_expect_tx(q_full, kQBytes);
      tma_load_3d(smem, tq, 0, row0, bh, q_full);
      tma_load_3d(smem + kQBytes / 2, tq, 0, row0 + kWM, bh, q_full);
      unsigned char* sk = smem + kQBytes;
      unsigned char* sv = sk + kStages * kTileBytes;
      for (int j = 0; j < tiles; ++j) {
        const int st = j % kStages;
        if (j >= kStages) mbar_wait(empty + st, (j / kStages - 1) & 1);
        mbar_arrive_expect_tx(full_k + st, kTileBytes);
        tma_load_3d(sk + st * kTileBytes, tk, 0, kBN * j, bh, full_k + st);
        mbar_arrive_expect_tx(full_v + st, kTileBytes);
        tma_load_3d(sv + st * kTileBytes, tv, 0, kBN * j, bh, full_v + st);
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    attn_consumer(tid / 128 - 1, smem, q_full, full_k, full_v, empty, out, L,
                  H, scale);
  }
}

}  // namespace vfa
