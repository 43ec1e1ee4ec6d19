// Device code of the long-sequence attention forward (flash_attn.cu holds
// the kernel and its C entry point).
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
// T/s on the card): at head width 64 the two bounds are the same within a
// few percent, and both are far above the bytes (q, k, v and out read or
// written once). This first version is right and simple, not tuned:
//   * one block of 4 warps owns 64 query rows of one (batch, head); each
//     warp owns 16 rows, holds its q tile as mma.sync A fragments, and its
//     scores, running max, running sum and output accumulator in
//     registers (FlashAttention-2's split of the rows over the warps, so
//     no warp waits on another's softmax);
//   * the keys and values stream through shared memory in tiles of 64,
//     two stages of cp.async so the next tile lands while this one is
//     read; rows past L are zero-filled, their scores set to -inf;
//   * q.k and p.v run on mma.sync m16n8k16 (bf16 operands, f32 sums), K
//     read by ldmatrix, V by ldmatrix.trans; the probabilities go from
//     the score accumulators to the A fragments of p.v in registers,
//     rounded to bf16 (the one rounding the plain route repeats);
//   * online softmax in f32 with exp2: the 1/8 scale and log2(e) are one
//     multiplier folded into the scores; each lane keeps partial row sums,
//     added across the lane quad once at the end;
//   * the grid walks the query tiles of one head before the next, so the
//     blocks in flight read the same K and V (16.9 MB a head at L =
//     65,952) from the L2 cache.
// Shared memory: 46,080 bytes a block (q tile and two K/V stages, rows
// padded to 144 bytes so ldmatrix's eight rows fall in distinct banks).
//
// Apart from cp.async, ldmatrix (plain and .trans), mma.sync and the xor
// shuffle it uses threadIdx/blockIdx, __syncthreads and shared and global
// memory, so host_emu.h (with ldsm_x4_trans from attn_emu.cpp) runs it on
// the CPU for the tests.
#pragma once

#ifdef __CUDACC__
#include <cuda_bf16.h>
#endif

#include <math.h>

namespace vfa {

constexpr int kD = 64;             // head width
constexpr int kBM = 64;            // query rows a block
constexpr int kBN = 64;            // keys a tile
constexpr int kThreads = 128;      // 4 warps of 16 query rows
constexpr int kLd = kD + 8;        // smem row stride (elements): 144 bytes
constexpr int kTile = kBM * kLd;   // elements of one 64-row tile
// q, then K and V of two stages
constexpr int kSmemBytes = 5 * kTile * 2;

#ifdef __CUDACC__
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// four 8x8 matrices, each transposed on its way to the lanes
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void mma_16816(float (&d)[4],
                                          const unsigned (&a)[4],
                                          const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 2^x on the special-function unit (2^-inf = +0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
#else
inline float fast_exp2(float x) { return exp2f(x); }
#endif

// two f32 values rounded to bf16 and packed, the first in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const unsigned l = __bfloat16_as_ushort(__float2bfloat16(lo));
  const unsigned h = __bfloat16_as_ushort(__float2bfloat16(hi));
  return l | (h << 16);
}

// rows [row0, row0 + 64) of a (L, 64) bf16 matrix into a padded smem tile:
// cp.async for rows < L, zeros for the rest (16 bytes a copy, 4 a thread)
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int row0,
                                          int L) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < kBM * kD / 8 / kThreads; ++i) {
    const int c = tid + i * kThreads;
    const int r = c / (kD / 8), col = 8 * (c % (kD / 8));
    __nv_bfloat16* d = dst + r * kLd + col;
    if (row0 + r < L) {
      cp_async_16(d, src + size_t(row0 + r) * kD + col);
    } else {
      unsigned* z = reinterpret_cast<unsigned*>(d);
      z[0] = z[1] = z[2] = z[3] = 0u;
    }
  }
}

// One block: query rows [64 blockIdx.x, +64) of head bh = blockIdx.y.
// q, k, v: (BH, L, 64); out: (B, L, H, 64) with b = bh / H, h = bh % H.
// `scale` is log2(e) / sqrt(64).
__device__ inline void attn_body(const __nv_bfloat16* __restrict__ q,
                                 const __nv_bfloat16* __restrict__ k,
                                 const __nv_bfloat16* __restrict__ v,
                                 __nv_bfloat16* __restrict__ out, int L,
                                 int H, float scale, unsigned char* smem) {
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sk = sq + kTile;      // two stages: sk, sk + 2 kTile
  __nv_bfloat16* sv = sq + 2 * kTile;  // two stages: sv, sv + 2 kTile
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.y, row0 = kBM * blockIdx.x;
  const size_t head = size_t(bh) * L * kD;
  const __nv_bfloat16* qh = q + head;
  const __nv_bfloat16* kh = k + head;
  const __nv_bfloat16* vh = v + head;
  const int tiles = (L + kBN - 1) / kBN;

  load_tile(sq, qh, row0, L);
  load_tile(sk, kh, 0, L);
  load_tile(sv, vh, 0, L);
  cp_async_commit();

  unsigned qa[kD / 16][4];  // this warp's 16 q rows as A fragments
  float o[kD / 8][4];       // output accumulator: 16 rows x 64
  float m[2], l[2];         // rows g and g + 8: running max and sum
#pragma unroll
  for (int j = 0; j < kD / 8; ++j)
    o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  m[0] = m[1] = -INFINITY;
  l[0] = l[1] = 0.f;

  for (int it = 0; it < tiles; ++it) {
    const int st = it % 2;
    if (it + 1 < tiles) {
      const int nx = (it + 1) % 2;
      load_tile(sk + 2 * nx * kTile, kh, kBN * (it + 1), L);
      load_tile(sv + 2 * nx * kTile, vh, kBN * (it + 1), L);
    }
    cp_async_commit();  // empty past the last tile
    cp_async_wait<1>();
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kc = 0; kc < kD / 16; ++kc)
        ldsm_x4(qa[kc], sq + (16 * warp + (lane & 15)) * kLd + 16 * kc
                            + (lane >> 4) * 8);
    }
    const __nv_bfloat16* ks = sk + 2 * st * kTile;
    const __nv_bfloat16* vs = sv + 2 * st * kTile;

    // scores: 16 rows x 64 keys, n-tile j holds keys 8j + 2t, 8j + 2t + 1
    float s[kBN / 8][4];
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < kD / 16; ++kc) {
#pragma unroll
      for (int j = 0; j < kBN / 8; j += 2) {
        unsigned b[4];
        ldsm_x4(b, ks + (8 * j + (lane & 7) + (lane >> 4) * 8) * kLd
                       + 16 * kc + ((lane >> 3) & 1) * 8);
        const unsigned lo[2] = {b[0], b[1]}, hi[2] = {b[2], b[3]};
        mma_16816(s[j], qa[kc], lo);
        mma_16816(s[j + 1], qa[kc], hi);
      }
    }

    // online softmax on the scaled scores, keys past L masked
    const int key0 = kBN * it;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = key0 + 8 * j + 2 * t + (c & 1);
        s[j][c] = key < L ? s[j][c] * scale : -INFINITY;
        mx[c / 2] = fmaxf(mx[c / 2], s[j][c]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      alpha[r] = fast_exp2(m[r] - mx[r]);  // 0 on the first tile
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }
    unsigned pa[kBN / 16][4];  // probabilities as A fragments of p.v
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      float p[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        p[c] = fast_exp2(s[j][c] - m[c / 2]);
        l[c / 2] += p[c];
      }
      pa[j / 2][2 * (j % 2)] = pack_bf16(p[0], p[1]);
      pa[j / 2][2 * (j % 2) + 1] = pack_bf16(p[2], p[3]);
    }

    // o += p v: k = the tile's keys, n = the head's 64 dims
#pragma unroll
    for (int kc = 0; kc < kBN / 16; ++kc) {
#pragma unroll
      for (int j = 0; j < kD / 8; j += 2) {
        unsigned b[4];
        ldsm_x4_trans(b, vs + (16 * kc + (lane & 7) + ((lane >> 3) & 1) * 8)
                                  * kLd + 8 * j + (lane >> 4) * 8);
        const unsigned lo[2] = {b[0], b[1]}, hi[2] = {b[2], b[3]};
        mma_16816(o[j], pa[kc], lo);
        mma_16816(o[j + 1], pa[kc], hi);
      }
    }
    __syncthreads();  // this stage is refilled two tiles on
  }

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
    const int row = row0 + 16 * warp + g + 8 * r;
    if (row >= L) continue;
    __nv_bfloat16* dst = out + ((size_t(b) * L + row) * H + h) * kD + 2 * t;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      const unsigned pk = pack_bf16(o[j][2 * r] * l[r], o[j][2 * r + 1] * l[r]);
      *reinterpret_cast<unsigned*>(dst + 8 * j) = pk;
    }
  }
}

}  // namespace vfa
