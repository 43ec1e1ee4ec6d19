// Device code of the fused former kernels: a whole pre-LN transformer block
// and the LN -> MLP -> residual tail, for the tracker's update formers.
//
// Replaces vggsfm_tpu/ops/fused_mlp.py:
//   fused_transformer_block (_block_kernel) -> block_body below,
//   fused_ln_mlp (_kernel)                  -> ln_mlp_body below.
//
// What bounds it on an H100: at the tracker's shapes the block is ~3.5 MFLOP
// per row against ~1.5 KB of row traffic, far above the card's ~295 FLOP/B
// ridge, so it is bound by operations: the matrix products. In bf16 they run
// on the tensor cores (wmma 16x16x16, bf16 operands, f32 accumulation, the
// TPU kernel's preferred_element_type=f32 dots); in f32, and for shapes the
// 16-wide tiles do not divide, on the CUDA cores in f32 (bf16 operands
// widened on load, so products are exact and sums f32 either way). The
// design keeps every intermediate on-chip, which is what the TPU kernel is
// for:
//   * one block of 256 threads owns up to 64 rows = whole tracks
//     (64 / L tracks of L rows), so attention never leaves the block;
//   * the residual stream (x1, then the MLP output) stays in registers, each
//     thread holding a fixed 4 x (C/16) slice of the 64 x C tile; tensor-core
//     products land in a shared f32 tile and are added into it;
//   * attention runs head by head: q/k/v of one head (64 x 3D), its L x L
//     scores and its output are the only per-head state in shared memory,
//     and the out-projection accumulates into the register x1;
//   * the MLP streams the hidden width in 64-wide chunks
//     (fc1 chunk -> GELU -> accumulate fc2), so the 4C hidden never exists;
//   * weights are read from global memory (L2-resident): straight into
//     tensor-core fragments, or in 16-deep k-tiles staged through shared
//     memory on the CUDA-core path.
// Shared memory peaks at ~190 KB per block (C=384, L=64), inside the 227 KB
// a Hopper block may take.
//
// Dtype contract (fused_mlp.py:99-137): LN statistics, every accumulation,
// softmax and x1 are f32; the normalized input, q/k/v, the probabilities,
// the per-head outputs and the GELU output are rounded to the working dtype.
//
// Apart from the wmma calls the code uses only threadIdx/blockIdx,
// __syncthreads and shared memory (no warp shuffles), so host_emu.h can run
// it on the CPU for testing.
#pragma once

#ifdef __CUDACC__
#include <cuda_bf16.h>
#include <mma.h>
#endif

namespace vf {

constexpr int kThreads = 256;        // 16 x 16 thread grid, 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kBM = 64;              // rows per block
constexpr int kRI = kBM / 16;        // rows per thread
constexpr int kBK = 16;              // k-depth of one staged weight tile
constexpr int kMC = 64;              // MLP hidden chunk
constexpr int kMaxC = 384;           // widest C the register tile holds
constexpr int kNJ = kMaxC / 16;      // column slots per thread
constexpr int kMaxD = 64;            // widest head
constexpr int kNJD = kMaxD / 16;
constexpr int kMaxL = 64;            // longest attention group (rows/track)

// ---------------------------------------------------------------- host side

// shared-memory regions start on 128-byte boundaries (wmma needs 32)
__host__ __device__ inline size_t align_up(size_t n) {
  return (n + 127) & ~size_t(127);
}

// Whether the tensor-core path takes these shapes: bf16, and every
// product's dimensions multiples of the 16-wide wmma tile.
__host__ __device__ inline bool use_tc(int tsize, int C, int D, int M) {
  return tsize == 2 && C % 16 == 0 && D % 16 == 0 && M % 16 == 0;
}

__host__ __device__ inline int a_stride(int C, int tsize, bool tc) {
  // pad the A-operand rows off a multiple of 32 banks; the tensor-core
  // path keeps the stride a multiple of 8 elements (wmma's ldm)
  return tc ? C + 8 : C + (tsize == 2 ? 2 : 1);
}

// f32 tile the tensor-core products land in: 64 x max(C, 3D, kMC)
__host__ __device__ inline int y_width(int C, int D) {
  int w = C > 3 * D ? C : 3 * D;
  return w > kMC ? w : kMC;
}

__host__ __device__ inline size_t common_smem(int C, int D, int tsize,
                                              bool tc) {
  const int bs_width = C > kMC ? C : kMC;
  return align_up(size_t(kBM) * a_stride(C, tsize, tc) * tsize)  // A
         + (tc ? align_up(size_t(kBM) * y_width(C, D) * 4)        // y tile
               : align_up(size_t(kBK) * bs_width * 4))            // W tile
         + align_up(size_t(kBM) * 2 * 4)                          // stats
         + align_up(size_t(kBM) * 16 * 4);                        // partials
}

__host__ __device__ inline size_t mlp_scratch(int tsize) {
  return align_up(size_t(kBM) * kMC * tsize);
}

__host__ __device__ inline size_t attn_scratch(int D, int L, int tsize) {
  return align_up(size_t(kBM) * 3 * D * tsize)
         + align_up(size_t(kBM) * L * 4) + align_up(size_t(kBM) * D * tsize);
}

inline size_t ln_mlp_smem_bytes(int C, int M, int tsize) {
  return common_smem(C, 0, tsize, use_tc(tsize, C, 16, M))
         + mlp_scratch(tsize);
}

inline size_t block_smem_bytes(int C, int H, int L, int M, int tsize) {
  const int D = C / H;
  const size_t a = attn_scratch(D, L, tsize), m = mlp_scratch(tsize);
  return common_smem(C, D, tsize, use_tc(tsize, C, D, M)) + (a > m ? a : m);
}

// Rows one block of the whole-block kernel owns: whole tracks of L rows.
inline int block_rows(int L) { return (kBM / L) * L; }

// 0 when the kernels take these shapes, else a negative code naming the
// first violated limit.
inline int check_mlp_shape(int R, int C, int M) {
  if (R < 1) return -1;
  if (C < 16 || C > kMaxC || C % 16 != 0) return -2;
  if (M < 1) return -3;
  return 0;
}

inline int check_block_shape(int R, int C, int M, int L, int H) {
  const int e = check_mlp_shape(R, C, M);
  if (e) return e;
  if (L < 1 || L > kMaxL) return -4;
  if (R % L != 0) return -5;
  if (H < 1 || C % H != 0 || C / H > kMaxD) return -6;
  return 0;
}

// -------------------------------------------------------------- device side

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(
    __nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);
}

// v rounded through the working dtype (a cast to T and back)
template <typename T> __device__ __forceinline__ float round_t(float v) {
  return to_f<T>(from_f<T>(v));
}

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
}

// CUDA-core product: acc[i][j] += sum_k A[r][k] * W[n][k] for
// r = ty + 16 i, n = tx + 16 j: a (64 x K) tile in shared memory times the
// transpose of N rows of a row-major (out, in) weight in global memory. W
// points at element [0][0] of the slice and ldw is its row stride. Bs
// stages kBK-deep tiles of W as f32, laid out [k][n]. Begins with a
// barrier, so callers need none between writing A and calling.
template <typename T, int NJ>
__device__ __forceinline__ void gemm_nt(float (&acc)[kRI][NJ],
                                        const T* A, int lda,
                                        const T* __restrict__ W, int ldw,
                                        int N, int K, float* Bs) {
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  for (int k0 = 0; k0 < K; k0 += kBK) {
    const int kb = K - k0 < kBK ? K - k0 : kBK;
    __syncthreads();  // A is written and the previous tile is consumed
    for (int idx = tid; idx < N * kBK; idx += kThreads) {
      const int n = idx / kBK, kk = idx - n * kBK;
      Bs[kk * N + n] = kk < kb ? to_f<T>(W[size_t(n) * ldw + k0 + kk]) : 0.f;
    }
    __syncthreads();
    for (int kk = 0; kk < kb; ++kk) {
      float a[kRI];
#pragma unroll
      for (int i = 0; i < kRI; ++i)
        a[i] = to_f<T>(A[(ty + 16 * i) * lda + k0 + kk]);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int n = tx + 16 * j;
        if (n < N) {
          const float b = Bs[kk * N + n];
#pragma unroll
          for (int i = 0; i < kRI; ++i) acc[i][j] = fmaf(a[i], b, acc[i][j]);
        }
      }
    }
  }
}

// Tensor-core product into shared memory:
//   Y[r][n] = sum_k A[r][k] * W[row(n)][k],  r < 64, n < N,
// Y f32 row-major with stride ldy, A bf16 in shared memory (lda % 8 == 0),
// W bf16 row-major (out, in) in global memory with row stride ldw. Column n
// reads weight row (n / seg) * seg_stride + n % seg, so one call can gather
// q|k|v rows of one head (seg = D, seg_stride = C); seg = N for a plain
// slice. N, K and seg are multiples of 16; every fragment origin is
// 32-byte aligned. Each warp owns 32 x 16 output tiles. Begins and ends
// with a barrier.
template <typename T>
__device__ __forceinline__ void gemm_tc(float* Y, int ldy, const T* A,
                                        int lda, const T* __restrict__ W,
                                        int ldw, int N, int K, int seg,
                                        int seg_stride) {
  using namespace nvcuda;
  const int warp = threadIdx.x / 32;
  __syncthreads();  // A is written and Y's previous contents consumed
  for (int t = warp; t < 2 * (N / 16); t += kWarps) {
    const int i0 = (t & 1) * 2;  // first of the two 16-row tiles
    const int n0 = (t >> 1) * 16;
    const T* Wt = W + size_t((n0 / seg) * seg_stride + n0 % seg) * ldw;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c0, c1;
    wmma::fill_fragment(c0, 0.0f);
    wmma::fill_fragment(c1, 0.0f);
    for (int k = 0; k < K; k += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> b;
      wmma::load_matrix_sync(b, Wt + k, ldw);
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a0, a1;
      wmma::load_matrix_sync(a0, A + (16 * i0) * lda + k, lda);
      wmma::load_matrix_sync(a1, A + (16 * i0 + 16) * lda + k, lda);
      wmma::mma_sync(c0, a0, b, c0);
      wmma::mma_sync(c1, a1, b, c1);
    }
    wmma::store_matrix_sync(Y + (16 * i0) * ldy + n0, c0, ldy,
                            wmma::mem_row_major);
    wmma::store_matrix_sync(Y + (16 * i0 + 16) * ldy + n0, c1, ldy,
                            wmma::mem_row_major);
  }
  __syncthreads();
}

// acc += Y for the thread's slice of a 64 x C f32 tile
__device__ __forceinline__ void add_tile(float (&acc)[kRI][kNJ],
                                         const float* Y, int ldy, int C) {
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
#pragma unroll
  for (int i = 0; i < kRI; ++i)
#pragma unroll
    for (int j = 0; j < kNJ; ++j) {
      const int c = tx + 16 * j;
      if (c < C) acc[i][j] += Y[(ty + 16 * i) * ldy + c];
    }
}

// LayerNorm (no affine, eps 1e-6) of the register tile v (its first C
// columns) into the A operand xa, rounded to T. Leaves the f32 mean and
// rstd of row r in stat[2r], stat[2r+1]. Two passes, as jnp.var.
template <typename T>
__device__ __forceinline__ void layer_norm_tile(const float (&v)[kRI][kNJ],
                                                int C, T* xa, int lda,
                                                float* stat, float* red) {
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
#pragma unroll
  for (int i = 0; i < kRI; ++i) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < kNJ; ++j)
      if (tx + 16 * j < C) s += v[i][j];
    red[(ty + 16 * i) * 16 + tx] = s;
  }
  __syncthreads();
  if (tid < kBM) {
    float s = 0.f;
    for (int t = 0; t < 16; ++t) s += red[tid * 16 + t];
    stat[2 * tid] = s / C;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kRI; ++i) {
    const float mean = stat[2 * (ty + 16 * i)];
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < kNJ; ++j)
      if (tx + 16 * j < C) {
        const float d = v[i][j] - mean;
        s += d * d;
      }
    red[(ty + 16 * i) * 16 + tx] = s;
  }
  __syncthreads();
  if (tid < kBM) {
    float s = 0.f;
    for (int t = 0; t < 16; ++t) s += red[tid * 16 + t];
    stat[2 * tid + 1] = rsqrtf(s / C + 1e-6f);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kRI; ++i) {
    const int r = ty + 16 * i;
    const float mean = stat[2 * r], rstd = stat[2 * r + 1];
#pragma unroll
    for (int j = 0; j < kNJ; ++j) {
      const int c = tx + 16 * j;
      if (c < C) xa[r * lda + c] = from_f<T>((v[i][j] - mean) * rstd);
    }
  }
}

// Rows [row0, row0 + rows) of the (R, C) input into the register tile;
// rows past the end read as 0.
template <typename T>
__device__ __forceinline__ void load_tile(float (&v)[kRI][kNJ],
                                          const T* __restrict__ x, int row0,
                                          int rows, int C) {
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
#pragma unroll
  for (int i = 0; i < kRI; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < kNJ; ++j) {
      const int c = tx + 16 * j;
      v[i][j] = (r < rows && c < C) ? to_f<T>(x[size_t(row0 + r) * C + c])
                                    : 0.f;
    }
  }
}

template <typename T>
__device__ __forceinline__ void store_tile(const float (&v)[kRI][kNJ],
                                           const T* __restrict__ bias,
                                           T* __restrict__ out, int row0,
                                           int rows, int C) {
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
#pragma unroll
  for (int i = 0; i < kRI; ++i) {
    const int r = ty + 16 * i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < kNJ; ++j) {
      const int c = tx + 16 * j;
      if (c < C)
        out[size_t(row0 + r) * C + c] = from_f<T>(v[i][j] + to_f<T>(bias[c]));
    }
  }
}

struct Smem {
  void* xa;       // [kBM][lda] A operand (normalized activations)
  float* Y;       // tensor cores: [kBM][y_width] product tile;
                  // CUDA cores: [kBK][max(C, kMC)] staged weight tile
  float* stat;    // [kBM][2]
  float* red;     // [kBM][16]
  unsigned char* scratch;
};

template <typename T, bool TC>
__device__ __forceinline__ Smem carve(unsigned char* smem, int C, int D) {
  const int tsize = sizeof(T);
  const int bs_width = C > kMC ? C : kMC;
  Smem s;
  unsigned char* p = smem;
  s.xa = p;
  p += align_up(size_t(kBM) * a_stride(C, tsize, TC) * tsize);
  s.Y = reinterpret_cast<float*>(p);
  p += TC ? align_up(size_t(kBM) * y_width(C, D) * 4)
          : align_up(size_t(kBK) * bs_width * 4);
  s.stat = reinterpret_cast<float*>(p);
  p += align_up(size_t(kBM) * 2 * 4);
  s.red = reinterpret_cast<float*>(p);
  p += align_up(size_t(kBM) * 16 * 4);
  s.scratch = p;
  return s;
}

// The MLP half shared by both kernels: acc holds the residual base
// (f32, one row per tile row); on return it holds
// base + fc2(gelu(fc1(LN(base)))) without the fc2 bias.
template <typename T, bool TC>
__device__ __forceinline__ void mlp_half(float (&acc)[kRI][kNJ], int C,
                                         int M, const T* __restrict__ w1,
                                         const T* __restrict__ b1,
                                         const T* __restrict__ w2,
                                         const Smem& s) {
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  T* xa = static_cast<T*>(s.xa);
  const int lda = a_stride(C, sizeof(T), TC);
  T* hb = reinterpret_cast<T*>(s.scratch);  // [kBM][kMC]
  layer_norm_tile<T>(acc, C, xa, lda, s.stat, s.red);
  for (int m0 = 0; m0 < M; m0 += kMC) {
    const int mc = M - m0 < kMC ? M - m0 : kMC;
    if constexpr (TC) {
      gemm_tc<T>(s.Y, kMC, xa, lda, w1 + size_t(m0) * C, C, mc, C, mc, 0);
      for (int idx = tid; idx < kBM * mc; idx += kThreads) {
        const int r = idx / mc, n = idx - r * mc;
        hb[r * kMC + n] =
            from_f<T>(gelu_erf(s.Y[r * kMC + n] + to_f<T>(b1[m0 + n])));
      }
      gemm_tc<T>(s.Y, C, hb, kMC, w2 + m0, M, C, mc, C, 0);
      add_tile(acc, s.Y, C, C);
    } else {
      float h[kRI][kMC / 16];
#pragma unroll
      for (int i = 0; i < kRI; ++i)
#pragma unroll
        for (int j = 0; j < kMC / 16; ++j) h[i][j] = 0.f;
      gemm_nt<T, kMC / 16>(h, xa, lda, w1 + size_t(m0) * C, C, mc, C, s.Y);
#pragma unroll
      for (int i = 0; i < kRI; ++i)
#pragma unroll
        for (int j = 0; j < kMC / 16; ++j) {
          const int n = tx + 16 * j;
          if (n < mc)
            hb[(ty + 16 * i) * kMC + n] =
                from_f<T>(gelu_erf(h[i][j] + to_f<T>(b1[m0 + n])));
        }
      gemm_nt<T, kNJ>(acc, hb, kMC, w2 + m0, M, C, mc, s.Y);
    }
  }
}

// fused_ln_mlp: out = x + fc2(gelu(fc1(LN(x)))) on rows of (R, C).
// w1 (M, C), b1 (M), w2 (C, M), b2 (C): torch Linear layout (out, in).
template <typename T, bool TC>
__device__ __forceinline__ void ln_mlp_body(
    const T* __restrict__ x, const T* __restrict__ w1,
    const T* __restrict__ b1, const T* __restrict__ w2,
    const T* __restrict__ b2, T* __restrict__ out, int R, int C, int M,
    unsigned char* smem) {
  const Smem s = carve<T, TC>(smem, C, 0);
  const int row0 = blockIdx.x * kBM;
  const int rows = R - row0 < kBM ? R - row0 : kBM;
  float acc[kRI][kNJ];
  load_tile<T>(acc, x, row0, rows, C);
  mlp_half<T, TC>(acc, C, M, w1, b1, w2, s);
  store_tile<T>(acc, b2, out, row0, rows, C);
}

// fused_transformer_block on rows of (R, C), attention within each group
// of L consecutive rows (one track):
//   xn = LN(x); x1 = xn + out_proj(MHA(xn)); out = x1 + MLP(LN(x1)).
// w_in (3C, C) packed q|k|v, b_in (3C), w_out (C, C), b_out (C) as
// torch.nn.MultiheadAttention; w1, b1, w2, b2 as ln_mlp_body.
template <typename T, bool TC>
__device__ __forceinline__ void block_body(
    const T* __restrict__ x, const T* __restrict__ w_in,
    const T* __restrict__ b_in, const T* __restrict__ w_out,
    const T* __restrict__ b_out, const T* __restrict__ w1,
    const T* __restrict__ b1, const T* __restrict__ w2,
    const T* __restrict__ b2, T* __restrict__ out, int R, int C, int M,
    int L, int H, unsigned char* smem) {
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int D = C / H;
  const Smem s = carve<T, TC>(smem, C, D);
  const int BMr = (kBM / L) * L;
  const int row0 = blockIdx.x * BMr;
  const int rows = R - row0 < BMr ? R - row0 : BMr;
  const int lda = a_stride(C, sizeof(T), TC);
  T* xa = static_cast<T*>(s.xa);
  T* qkv = reinterpret_cast<T*>(s.scratch);  // [kBM][3D]
  float* sc = reinterpret_cast<float*>(
      s.scratch + align_up(size_t(kBM) * 3 * D * sizeof(T)));  // [kBM][L]
  T* oh = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(sc)
                               + align_up(size_t(kBM) * L * 4));  // [kBM][D]
  const float scale = 1.0f / sqrtf(float(D));

  float acc[kRI][kNJ];
  load_tile<T>(acc, x, row0, rows, C);
  layer_norm_tile<T>(acc, C, xa, lda, s.stat, s.red);
  // x1 starts as the f32 normalized input plus the out-proj bias (the
  // residual base is the NORMALIZED input)
#pragma unroll
  for (int i = 0; i < kRI; ++i) {
    const int r = ty + 16 * i;
    const float mean = s.stat[2 * r], rstd = s.stat[2 * r + 1];
#pragma unroll
    for (int j = 0; j < kNJ; ++j) {
      const int c = tx + 16 * j;
      if (c < C) acc[i][j] = (acc[i][j] - mean) * rstd + to_f<T>(b_out[c]);
    }
  }

  for (int h = 0; h < H; ++h) {
    // q | k | v of head h -> qkv[:, 0:D | D:2D | 2D:3D], rounded to T
    if constexpr (TC) {
      gemm_tc<T>(s.Y, 3 * D, xa, lda, w_in + size_t(h) * D * C, C, 3 * D, C,
                 D, C);
      for (int idx = tid; idx < kBM * 3 * D; idx += kThreads) {
        const int n = idx % (3 * D);
        const int wrow = (n / D) * C + h * D + n % D;
        qkv[idx] = from_f<T>(s.Y[idx] + to_f<T>(b_in[wrow]));
      }
    } else {
      for (int part = 0; part < 3; ++part) {
        float t[kRI][kNJD];
#pragma unroll
        for (int i = 0; i < kRI; ++i)
#pragma unroll
          for (int j = 0; j < kNJD; ++j) t[i][j] = 0.f;
        const int wrow = part * C + h * D;
        gemm_nt<T, kNJD>(t, xa, lda, w_in + size_t(wrow) * C, C, D, C, s.Y);
#pragma unroll
        for (int i = 0; i < kRI; ++i)
#pragma unroll
          for (int j = 0; j < kNJD; ++j) {
            const int n = tx + 16 * j;
            if (n < D)
              qkv[(ty + 16 * i) * 3 * D + part * D + n] =
                  from_f<T>(t[i][j] + to_f<T>(b_in[wrow + n]));
          }
      }
    }
    __syncthreads();
    // scores within each track, f32
    for (int idx = tid; idx < rows * L; idx += kThreads) {
      const int r = idx / L, j = idx - r * L;
      const int kr = (r / L) * L + j;
      const T* q = qkv + r * 3 * D;
      const T* k = qkv + kr * 3 * D + D;
      float d = 0.f;
      for (int e = 0; e < D; ++e) d = fmaf(to_f<T>(q[e]), to_f<T>(k[e]), d);
      sc[r * L + j] = d * scale;
    }
    __syncthreads();
    // softmax over each row, probabilities rounded to T
    for (int r = tid; r < rows; r += kThreads) {
      float* p = sc + r * L;
      float mx = p[0];
      for (int j = 1; j < L; ++j) mx = fmaxf(mx, p[j]);
      float sum = 0.f;
      for (int j = 0; j < L; ++j) {
        p[j] = expf(p[j] - mx);
        sum += p[j];
      }
      const float inv = 1.0f / sum;
      for (int j = 0; j < L; ++j) p[j] = round_t<T>(p[j] * inv);
    }
    __syncthreads();
    // P V, rounded to T; rows past the block's tracks are zero (the
    // tensor cores read all 64 rows)
    for (int idx = tid; idx < kBM * D; idx += kThreads) {
      const int r = idx / D, e = idx - r * D;
      float o = 0.f;
      if (r < rows) {
        const int base = (r / L) * L;
        const float* p = sc + r * L;
        for (int j = 0; j < L; ++j)
          o = fmaf(p[j], to_f<T>(qkv[(base + j) * 3 * D + 2 * D + e]), o);
      }
      oh[r * D + e] = from_f<T>(o);
    }
    // x1 += o_h @ w_out[:, hD:(h+1)D]^T
    if constexpr (TC) {
      gemm_tc<T>(s.Y, C, oh, D, w_out + h * D, C, C, D, C, 0);
      add_tile(acc, s.Y, C, C);
    } else {
      gemm_nt<T, kNJ>(acc, oh, D, w_out + h * D, C, C, D, s.Y);
    }
  }

  mlp_half<T, TC>(acc, C, M, w1, b1, w2, s);
  store_tile<T>(acc, b2, out, row0, rows, C);
}

}  // namespace vf
