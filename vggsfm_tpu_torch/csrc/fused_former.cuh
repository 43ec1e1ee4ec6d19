// Device code of the fused former kernels: a whole pre-LN transformer block,
// the LN -> MLP -> residual tail, and the LN -> attention -> residual half.
//
// Replaces vggsfm_tpu/ops/fused_mlp.py:
//   fused_transformer_block (_block_kernel) -> block_body below,
//   fused_ln_mlp (_kernel)                  -> ln_mlp_body below,
//   fused_ln_attn (_attn_kernel)            -> attn_*_body below.
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
//   * one block of 256 threads owns a tile of whole rows: 64 rows (C <= 384)
//     or 32 rows (C <= 768) of the MLP tail; up to 64 rows = whole tracks
//     (64 / L tracks of L rows) of the block kernel, so attention never
//     leaves the block;
//   * the residual stream (x1, then the MLP output) stays in registers, each
//     thread holding a fixed (rows / 16) x (C / 16) slice of the tile: 96
//     f32 values at both tile shapes; tensor-core products land in a shared
//     f32 tile and are added into it;
//   * attention runs head by head: q/k/v of one head (64 x 3D), its L x L
//     scores and its output are the only per-head state in shared memory,
//     and the out-projection accumulates into the register x1;
//   * the MLP streams the hidden width in 64-wide chunks
//     (fc1 chunk -> GELU -> accumulate fc2), so the 4C hidden never exists;
//   * weights are read from global memory (L2-resident): straight into
//     tensor-core fragments, or in 16-deep k-tiles staged through shared
//     memory on the CUDA-core path.
// Shared memory peaks at ~190 KB per block (block kernel, C=384, L=64),
// inside the 227 KB a Hopper block may take.
//
// The attention half (attn_*_body) takes C up to 768 and heads up to 128
// wide, where a C-wide f32 register tile no longer fits. It runs as three
// kernels over tiles of 16, 32 or 64 rows of whole tracks: the LayerNorm
// writes the normalized rows (rounded to the working dtype) to a scratch
// tile in global memory (L2-resident); one block per (row tile, head)
// computes that head's q|k|v and attention into a second scratch tile; one
// block per (row tile, 128-column chunk) runs the out-projection, adds the
// f32 normalized residual recomputed from x and the row statistics, and
// writes the output. So the camera trunk (R = 64: four 16-row tiles) runs
// 4 x 8 and 4 x 6 blocks instead of four blocks walking every head.
//
// Dtype contract (fused_mlp.py:58-137): LN statistics, every accumulation,
// softmax and x1 are f32; the normalized input, q/k/v, the probabilities,
// the per-head outputs and the GELU output are rounded to the working dtype.
//
// Apart from the wmma calls the code uses only threadIdx/blockIdx,
// __syncthreads, shared and global memory (no warp shuffles), so host_emu.h
// can run it on the CPU for testing.
#pragma once

#ifdef __CUDACC__
#include <cuda_bf16.h>
#include <mma.h>
#endif

namespace vf {

constexpr int kThreads = 256;        // 16 x 16 thread grid, 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kBK = 16;              // k-depth of one staged weight tile
constexpr int kMC = 64;              // MLP hidden chunk
constexpr int kMaxC = 384;           // widest C of the 64-row register tile
constexpr int kMaxWideC = 768;       // widest C of the 32-row register tile
constexpr int kMaxD = 64;            // widest head of the block kernel
constexpr int kNJD = kMaxD / 16;
constexpr int kMaxL = 64;            // longest attention group (rows/track)
constexpr int kAttnMaxD = 128;       // widest head of the attention half
constexpr int kAttnNJQ = 3 * kAttnMaxD / 16;  // q|k|v columns per thread
constexpr int kAttnNC = 128;         // out-projection column chunk

// A block's row tile and the register tile holding its residual stream:
// thread (ty, tx) of the 16 x 16 grid owns rows ty + 16 i (i < RI) and
// columns tx + 16 j (j < NJ).
template <int BM_, int MAXC_>
struct Tile {
  static constexpr int BM = BM_;
  static constexpr int RI = BM_ / 16;
  static constexpr int MAXC = MAXC_;
  static constexpr int NJ = MAXC_ / 16;
};
using NarrowTile = Tile<64, kMaxC>;     // block kernel; ln_mlp at C <= 384
using WideTile = Tile<32, kMaxWideC>;   // ln_mlp at 384 < C <= 768

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

// f32 tile the tensor-core products land in: BM x max(C, 3D, kMC)
__host__ __device__ inline int y_width(int C, int D) {
  int w = C > 3 * D ? C : 3 * D;
  return w > kMC ? w : kMC;
}

__host__ __device__ inline size_t common_smem(int BM, int C, int D, int tsize,
                                              bool tc) {
  const int bs_width = C > kMC ? C : kMC;
  return align_up(size_t(BM) * a_stride(C, tsize, tc) * tsize)  // A
         + (tc ? align_up(size_t(BM) * y_width(C, D) * 4)        // y tile
               : align_up(size_t(kBK) * bs_width * 4))           // W tile
         + align_up(size_t(BM) * 2 * 4)                          // stats
         + align_up(size_t(BM) * 16 * 4);                        // partials
}

__host__ __device__ inline size_t mlp_scratch(int BM, int tsize) {
  return align_up(size_t(BM) * kMC * tsize);
}

__host__ __device__ inline size_t attn_scratch(int BM, int D, int L,
                                               int tsize) {
  return align_up(size_t(BM) * 3 * D * tsize)
         + align_up(size_t(BM) * L * 4) + align_up(size_t(BM) * D * tsize);
}

// Rows of one ln_mlp block: the 64-row tile up to C = 384, else 32 rows.
inline int ln_mlp_rows(int C) {
  return C <= kMaxC ? NarrowTile::BM : WideTile::BM;
}

inline size_t ln_mlp_smem_bytes(int C, int M, int tsize) {
  const int BM = ln_mlp_rows(C);
  return common_smem(BM, C, 0, tsize, use_tc(tsize, C, 16, M))
         + mlp_scratch(BM, tsize);
}

inline size_t block_smem_bytes(int C, int H, int L, int M, int tsize) {
  const int D = C / H;
  const int BM = NarrowTile::BM;
  const size_t a = attn_scratch(BM, D, L, tsize), m = mlp_scratch(BM, tsize);
  return common_smem(BM, C, D, tsize, use_tc(tsize, C, D, M))
         + (a > m ? a : m);
}

// Rows a block of a whole-track kernel owns out of a BM-row tile.
__host__ __device__ inline int block_rows(int L, int BM = NarrowTile::BM) {
  return (BM / L) * L;
}

// Row tile of the attention half's kernels: the smallest of 16, 32 and 64
// rows that holds a whole track (L = 8: two tracks), so a short input
// still spreads over many blocks.
__host__ __device__ inline int attn_tile_rows(int L) {
  return L <= 16 ? 16 : L <= 32 ? 32 : 64;
}

// Rows of each of the attention half's scratch arrays (xs, os): one
// attn_tile_rows(L)-row tile per block of block_rows(L, BM) input rows.
inline long attn_scratch_rows(int R, int L) {
  const int BM = attn_tile_rows(L), br = block_rows(L, BM);
  return long((R + br - 1) / br) * BM;
}

// Shared memory of one block of any of the attention half's kernels
// (attn_carve): statistics, one head's q|k|v, its scores, and the
// tensor-core product tile or the staged weight and A tiles.
inline size_t attn_smem_bytes(int C, int H, int L, int tsize) {
  const int D = C / H, BM = attn_tile_rows(L);
  const bool tc = use_tc(tsize, C, D, 16);
  const int yw = 3 * D > kAttnNC ? 3 * D : kAttnNC;
  return align_up(size_t(BM) * 2 * 4) + align_up(size_t(BM) * 16 * 4)
         + align_up(size_t(BM) * 3 * D * tsize) + align_up(size_t(BM) * L * 4)
         + (tc ? align_up(size_t(BM) * yw * 4)
               : align_up(size_t(kBK) * yw * 4) + align_up(size_t(BM) * kBK * 4));
}

// 0 when the kernels take these shapes, else a negative code naming the
// first violated limit.
inline int check_mlp_shape(int R, int C, int M) {
  if (R < 1) return -1;
  if (C < 16 || C > kMaxWideC || C % 16 != 0) return -2;
  if (M < 1) return -3;
  return 0;
}

inline int check_block_shape(int R, int C, int M, int L, int H) {
  const int e = check_mlp_shape(R, C, M);
  if (e) return e;
  if (C > kMaxC) return -2;
  if (L < 1 || L > kMaxL) return -4;
  if (R % L != 0) return -5;
  if (H < 1 || C % H != 0 || C / H > kMaxD) return -6;
  return 0;
}

inline int check_attn_shape(int R, int C, int L, int H) {
  if (R < 1) return -1;
  if (C < 16 || C > kMaxWideC || C % 16 != 0) return -2;
  if (L < 1 || L > kMaxL) return -4;
  if (R % L != 0) return -5;
  if (H < 1 || C % H != 0 || C / H > kAttnMaxD) return -6;
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
// r = ty + 16 i, n = tx + 16 j: a (16 RI x K) tile (shared or global memory)
// times the transpose of N rows of a row-major (out, in) weight in global
// memory. W points at element [0][0] of the slice and ldw is its row stride;
// with seg > 0, column n reads weight row (n / seg) * seg_stride + n % seg
// (as gemm_tc). Bs stages kBK-deep tiles of W as f32, laid out [k][n]; with
// STAGE_A (A in global memory) As stages the matching (16 RI x kBK) tile of
// A, so the inner loop reads no global memory. Begins with a barrier, so
// callers need none between writing A and calling.
template <typename T, int RI, int NJ, bool STAGE_A = false>
__device__ __forceinline__ void gemm_nt(float (&acc)[RI][NJ], const T* A,
                                        int lda, const T* __restrict__ W,
                                        int ldw, int N, int K, float* Bs,
                                        int seg = 0, int seg_stride = 0,
                                        float* As = nullptr) {
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  for (int k0 = 0; k0 < K; k0 += kBK) {
    const int kb = K - k0 < kBK ? K - k0 : kBK;
    __syncthreads();  // A is written and the previous tile is consumed
    for (int idx = tid; idx < N * kBK; idx += kThreads) {
      const int n = idx / kBK, kk = idx - n * kBK;
      const int wr = seg ? (n / seg) * seg_stride + n % seg : n;
      Bs[kk * N + n] = kk < kb ? to_f<T>(W[size_t(wr) * ldw + k0 + kk]) : 0.f;
    }
    if constexpr (STAGE_A)
      for (int idx = tid; idx < 16 * RI * kBK; idx += kThreads) {
        const int r = idx / kBK, kk = idx - r * kBK;
        As[idx] = kk < kb ? to_f<T>(A[size_t(r) * lda + k0 + kk]) : 0.f;
      }
    __syncthreads();
    for (int kk = 0; kk < kb; ++kk) {
      float a[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i)
        a[i] = STAGE_A ? As[(ty + 16 * i) * kBK + kk]
                       : to_f<T>(A[size_t(ty + 16 * i) * lda + k0 + kk]);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int n = tx + 16 * j;
        if (n < N) {
          const float b = Bs[kk * N + n];
#pragma unroll
          for (int i = 0; i < RI; ++i) acc[i][j] = fmaf(a[i], b, acc[i][j]);
        }
      }
    }
  }
}

// Tensor-core product into shared memory:
//   Y[r][n] = sum_k A[r][k] * W[row(n)][k],  r < BM, n < N,
// Y f32 row-major with stride ldy, A bf16 (shared or global memory,
// lda % 8 == 0), W bf16 row-major (out, in) in global memory with row stride
// ldw. Column n reads weight row (n / seg) * seg_stride + n % seg, so one
// call can gather q|k|v rows of one head (seg = D, seg_stride = C); seg = N
// for a plain slice. N, K and seg are multiples of 16; every fragment origin
// is 32-byte aligned. Each warp owns 32 x 16 output tiles (16 x 16 when
// BM = 16). Begins and ends with a barrier.
template <typename T, int BM>
__device__ __forceinline__ void gemm_tc(float* Y, int ldy, const T* A,
                                        int lda, const T* __restrict__ W,
                                        int ldw, int N, int K, int seg,
                                        int seg_stride) {
  using namespace nvcuda;
  constexpr int RT = BM >= 32 ? 2 : 1;  // 16-row tiles per warp task
  constexpr int NRT = BM / (16 * RT);   // row groups
  const int warp = threadIdx.x / 32;
  __syncthreads();  // A is written and Y's previous contents consumed
  for (int t = warp; t < NRT * (N / 16); t += kWarps) {
    const int i0 = (t % NRT) * RT;  // first of the task's 16-row tiles
    const int n0 = (t / NRT) * 16;
    const T* Wt = W + size_t((n0 / seg) * seg_stride + n0 % seg) * ldw;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i) wmma::fill_fragment(c[i], 0.0f);
    for (int k = 0; k < K; k += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> b;
      wmma::load_matrix_sync(b, Wt + k, ldw);
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
        wmma::load_matrix_sync(a, A + size_t(16 * (i0 + i)) * lda + k, lda);
        wmma::mma_sync(c[i], a, b, c[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < RT; ++i)
      wmma::store_matrix_sync(Y + (16 * (i0 + i)) * ldy + n0, c[i], ldy,
                              wmma::mem_row_major);
  }
  __syncthreads();
}

// acc += Y for the thread's slice of a BM x C f32 tile
template <class TL>
__device__ __forceinline__ void add_tile(float (&acc)[TL::RI][TL::NJ],
                                         const float* Y, int ldy, int C) {
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
#pragma unroll
  for (int i = 0; i < TL::RI; ++i)
#pragma unroll
    for (int j = 0; j < TL::NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < C) acc[i][j] += Y[(ty + 16 * i) * ldy + c];
    }
}

// Row statistics of a BM-row tile: given each thread's partial sums part[i]
// of rows ty + 16 i, leaves the row sums divided by C in stat[2r + slot].
template <int BM>
__device__ __forceinline__ void row_reduce(const float* part, int C,
                                           float* stat, int slot, float* red) {
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
#pragma unroll
  for (int i = 0; i < BM / 16; ++i) red[(ty + 16 * i) * 16 + tx] = part[i];
  __syncthreads();
  if (tid < BM) {
    float s = 0.f;
    for (int t = 0; t < 16; ++t) s += red[tid * 16 + t];
    stat[2 * tid + slot] = s / C;
  }
  __syncthreads();
}

// LayerNorm (no affine, eps 1e-6) of the register tile v (its first C
// columns) into the A operand xa, rounded to T. Leaves the f32 mean and
// rstd of row r in stat[2r], stat[2r+1]. Two passes, as jnp.var.
template <typename T, class TL>
__device__ __forceinline__ void layer_norm_tile(
    const float (&v)[TL::RI][TL::NJ], int C, T* xa, int lda, float* stat,
    float* red) {
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  float part[TL::RI];
#pragma unroll
  for (int i = 0; i < TL::RI; ++i) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < TL::NJ; ++j)
      if (tx + 16 * j < C) s += v[i][j];
    part[i] = s;
  }
  row_reduce<TL::BM>(part, C, stat, 0, red);
#pragma unroll
  for (int i = 0; i < TL::RI; ++i) {
    const float mean = stat[2 * (ty + 16 * i)];
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < TL::NJ; ++j)
      if (tx + 16 * j < C) {
        const float d = v[i][j] - mean;
        s += d * d;
      }
    part[i] = s;
  }
  row_reduce<TL::BM>(part, C, stat, 1, red);
  if (tid < TL::BM) stat[2 * tid + 1] = rsqrtf(stat[2 * tid + 1] + 1e-6f);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < TL::RI; ++i) {
    const int r = ty + 16 * i;
    const float mean = stat[2 * r], rstd = stat[2 * r + 1];
#pragma unroll
    for (int j = 0; j < TL::NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < C) xa[r * lda + c] = from_f<T>((v[i][j] - mean) * rstd);
    }
  }
}

// Rows [row0, row0 + rows) of the (R, C) input into the register tile;
// rows past the end read as 0.
template <typename T, class TL>
__device__ __forceinline__ void load_tile(float (&v)[TL::RI][TL::NJ],
                                          const T* __restrict__ x, int row0,
                                          int rows, int C) {
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
#pragma unroll
  for (int i = 0; i < TL::RI; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < TL::NJ; ++j) {
      const int c = tx + 16 * j;
      v[i][j] = (r < rows && c < C) ? to_f<T>(x[size_t(row0 + r) * C + c])
                                    : 0.f;
    }
  }
}

template <typename T, class TL>
__device__ __forceinline__ void store_tile(const float (&v)[TL::RI][TL::NJ],
                                           const T* __restrict__ bias,
                                           T* __restrict__ out, int row0,
                                           int rows, int C) {
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
#pragma unroll
  for (int i = 0; i < TL::RI; ++i) {
    const int r = ty + 16 * i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < TL::NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < C)
        out[size_t(row0 + r) * C + c] = from_f<T>(v[i][j] + to_f<T>(bias[c]));
    }
  }
}

struct Smem {
  void* xa;       // [BM][lda] A operand (normalized activations)
  float* Y;       // tensor cores: [BM][y_width] product tile;
                  // CUDA cores: [kBK][max(C, kMC)] staged weight tile
  float* stat;    // [BM][2]
  float* red;     // [BM][16]
  unsigned char* scratch;
};

template <typename T, bool TC, class TL>
__device__ __forceinline__ Smem carve(unsigned char* smem, int C, int D) {
  const int tsize = sizeof(T);
  const int bs_width = C > kMC ? C : kMC;
  Smem s;
  unsigned char* p = smem;
  s.xa = p;
  p += align_up(size_t(TL::BM) * a_stride(C, tsize, TC) * tsize);
  s.Y = reinterpret_cast<float*>(p);
  p += TC ? align_up(size_t(TL::BM) * y_width(C, D) * 4)
          : align_up(size_t(kBK) * bs_width * 4);
  s.stat = reinterpret_cast<float*>(p);
  p += align_up(size_t(TL::BM) * 2 * 4);
  s.red = reinterpret_cast<float*>(p);
  p += align_up(size_t(TL::BM) * 16 * 4);
  s.scratch = p;
  return s;
}

// The MLP half shared by both kernels: acc holds the residual base
// (f32, one row per tile row); on return it holds
// base + fc2(gelu(fc1(LN(base)))) without the fc2 bias.
template <typename T, bool TC, class TL>
__device__ __forceinline__ void mlp_half(float (&acc)[TL::RI][TL::NJ], int C,
                                         int M, const T* __restrict__ w1,
                                         const T* __restrict__ b1,
                                         const T* __restrict__ w2,
                                         const Smem& s) {
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  T* xa = static_cast<T*>(s.xa);
  const int lda = a_stride(C, sizeof(T), TC);
  T* hb = reinterpret_cast<T*>(s.scratch);  // [BM][kMC]
  layer_norm_tile<T, TL>(acc, C, xa, lda, s.stat, s.red);
  for (int m0 = 0; m0 < M; m0 += kMC) {
    const int mc = M - m0 < kMC ? M - m0 : kMC;
    if constexpr (TC) {
      gemm_tc<T, TL::BM>(s.Y, kMC, xa, lda, w1 + size_t(m0) * C, C, mc, C,
                         mc, 0);
      for (int idx = tid; idx < TL::BM * mc; idx += kThreads) {
        const int r = idx / mc, n = idx - r * mc;
        hb[r * kMC + n] =
            from_f<T>(gelu_erf(s.Y[r * kMC + n] + to_f<T>(b1[m0 + n])));
      }
      gemm_tc<T, TL::BM>(s.Y, C, hb, kMC, w2 + m0, M, C, mc, C, 0);
      add_tile<TL>(acc, s.Y, C, C);
    } else {
      float h[TL::RI][kMC / 16];
#pragma unroll
      for (int i = 0; i < TL::RI; ++i)
#pragma unroll
        for (int j = 0; j < kMC / 16; ++j) h[i][j] = 0.f;
      gemm_nt<T, TL::RI, kMC / 16>(h, xa, lda, w1 + size_t(m0) * C, C, mc, C,
                                   s.Y);
#pragma unroll
      for (int i = 0; i < TL::RI; ++i)
#pragma unroll
        for (int j = 0; j < kMC / 16; ++j) {
          const int n = tx + 16 * j;
          if (n < mc)
            hb[(ty + 16 * i) * kMC + n] =
                from_f<T>(gelu_erf(h[i][j] + to_f<T>(b1[m0 + n])));
        }
      gemm_nt<T, TL::RI, TL::NJ>(acc, hb, kMC, w2 + m0, M, C, mc, s.Y);
    }
  }
}

// fused_ln_mlp: out = x + fc2(gelu(fc1(LN(x)))) on rows of (R, C), TL::BM
// rows per block. w1 (M, C), b1 (M), w2 (C, M), b2 (C): torch Linear
// layout (out, in).
template <typename T, bool TC, class TL>
__device__ __forceinline__ void ln_mlp_body(
    const T* __restrict__ x, const T* __restrict__ w1,
    const T* __restrict__ b1, const T* __restrict__ w2,
    const T* __restrict__ b2, T* __restrict__ out, int R, int C, int M,
    unsigned char* smem) {
  const Smem s = carve<T, TC, TL>(smem, C, 0);
  const int row0 = blockIdx.x * TL::BM;
  const int rows = R - row0 < TL::BM ? R - row0 : TL::BM;
  float acc[TL::RI][TL::NJ];
  load_tile<T, TL>(acc, x, row0, rows, C);
  mlp_half<T, TC, TL>(acc, C, M, w1, b1, w2, s);
  store_tile<T, TL>(acc, b2, out, row0, rows, C);
}

// One head's attention within each track of a BM-row tile: q|k|v of the
// head in qkv [BM][3D] (rounded to T), f32 scores in sc [BM][L]; the
// output, rounded to T, goes to o[r * ldo + e] (rows past the block's
// tracks get 0, as the tensor cores read all BM rows).
template <typename T, int BM>
__device__ __forceinline__ void head_attention(const T* qkv, float* sc,
                                               T* o, int ldo, int rows,
                                               int L, int D, float scale) {
  const int tid = threadIdx.x;
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
  // P V, rounded to T
  for (int idx = tid; idx < BM * D; idx += kThreads) {
    const int r = idx / D, e = idx - r * D;
    float acc = 0.f;
    if (r < rows) {
      const int base = (r / L) * L;
      const float* p = sc + r * L;
      for (int j = 0; j < L; ++j)
        acc = fmaf(p[j], to_f<T>(qkv[(base + j) * 3 * D + 2 * D + e]), acc);
    }
    o[size_t(r) * ldo + e] = from_f<T>(acc);
  }
}

// q | k | v of head h for the BM rows of A (lda) into qkv [BM][3D], rounded
// to T. Y: the tensor-core product tile or the staged weight tile. The
// CUDA-core path runs NP products of 3D / NP columns, NJ column slots per
// thread: three (q, k, v) in the register-tight block kernel, one in the
// attention half, whose A lies in global memory and is staged through As.
template <typename T, bool TC, int BM, int NP, int NJ>
__device__ __forceinline__ void head_qkv(T* qkv, const T* A, int lda,
                                         const T* __restrict__ w_in,
                                         const T* __restrict__ b_in, int C,
                                         int D, int h, float* Y,
                                         float* As = nullptr) {
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  if constexpr (TC) {
    gemm_tc<T, BM>(Y, 3 * D, A, lda, w_in + size_t(h) * D * C, C, 3 * D, C,
                   D, C);
    for (int idx = tid; idx < BM * 3 * D; idx += kThreads) {
      const int n = idx % (3 * D);
      const int wrow = (n / D) * C + h * D + n % D;
      qkv[idx] = from_f<T>(Y[idx] + to_f<T>(b_in[wrow]));
    }
  } else {
    const int N = 3 * D / NP;
    for (int part = 0; part < NP; ++part) {
      float t[BM / 16][NJ];
#pragma unroll
      for (int i = 0; i < BM / 16; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) t[i][j] = 0.f;
      // one product gathers the q|k|v rows of the head (as gemm_tc); three
      // read plain D-row slices
      const int wrow = part * C + h * D;
      gemm_nt<T, BM / 16, NJ, NP == 1>(t, A, lda, w_in + size_t(wrow) * C, C,
                                       N, C, Y, NP == 1 ? D : 0, C, As);
#pragma unroll
      for (int i = 0; i < BM / 16; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int n = tx + 16 * j;
          const int brow = NP == 1 ? (n / D) * C + h * D + n % D : wrow + n;
          if (n < N)
            qkv[(ty + 16 * i) * 3 * D + part * D + n] =
                from_f<T>(t[i][j] + to_f<T>(b_in[brow]));
        }
    }
  }
  __syncthreads();
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
  using TL = NarrowTile;
  constexpr int BM = TL::BM;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int D = C / H;
  const Smem s = carve<T, TC, TL>(smem, C, D);
  const int BMr = block_rows(L);
  const int row0 = blockIdx.x * BMr;
  const int rows = R - row0 < BMr ? R - row0 : BMr;
  const int lda = a_stride(C, sizeof(T), TC);
  T* xa = static_cast<T*>(s.xa);
  T* qkv = reinterpret_cast<T*>(s.scratch);  // [BM][3D]
  float* sc = reinterpret_cast<float*>(
      s.scratch + align_up(size_t(BM) * 3 * D * sizeof(T)));  // [BM][L]
  T* oh = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(sc)
                               + align_up(size_t(BM) * L * 4));  // [BM][D]
  const float scale = 1.0f / sqrtf(float(D));

  float acc[TL::RI][TL::NJ];
  load_tile<T, TL>(acc, x, row0, rows, C);
  layer_norm_tile<T, TL>(acc, C, xa, lda, s.stat, s.red);
  // x1 starts as the f32 normalized input plus the out-proj bias (the
  // residual base is the NORMALIZED input)
#pragma unroll
  for (int i = 0; i < TL::RI; ++i) {
    const int r = ty + 16 * i;
    const float mean = s.stat[2 * r], rstd = s.stat[2 * r + 1];
#pragma unroll
    for (int j = 0; j < TL::NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < C) acc[i][j] = (acc[i][j] - mean) * rstd + to_f<T>(b_out[c]);
    }
  }

  for (int h = 0; h < H; ++h) {
    head_qkv<T, TC, BM, 3, kNJD>(qkv, xa, lda, w_in, b_in, C, D, h, s.Y);
    head_attention<T, BM>(qkv, sc, oh, D, rows, L, D, scale);
    // x1 += o_h @ w_out[:, hD:(h+1)D]^T
    if constexpr (TC) {
      gemm_tc<T, BM>(s.Y, C, oh, D, w_out + h * D, C, C, D, C, 0);
      add_tile<TL>(acc, s.Y, C, C);
    } else {
      gemm_nt<T, TL::RI, TL::NJ>(acc, oh, D, w_out + h * D, C, C, D, s.Y);
    }
  }

  mlp_half<T, TC, TL>(acc, C, M, w1, b1, w2, s);
  store_tile<T, TL>(acc, b2, out, row0, rows, C);
}

// fused_ln_attn on rows of (R, C), attention within each group of L
// consecutive rows, in BM-row tiles of whole tracks ((BM / L) * L rows,
// BM = attn_tile_rows(L)):
//   xn = LN(x); out = xn + out_proj(MHA(xn)),
// as three kernels, so a short input still spreads over the card: the
// LayerNorm per row tile, then one block per (row tile, head), then one per
// (row tile, kAttnNC-column chunk of the out-projection). Weights as
// block_body. xs_all and os_all are scratch tiles in global memory (L2
// resident), BM x C each in T per row tile: the normalized rows (the A
// operand of the q|k|v products) and the concatenated head outputs (that of
// the out-projection). The f32 residual is recomputed from x and the row
// statistics, so no C-wide f32 tile is kept. All three share one carve of
// shared memory (AttnSmem).
struct AttnSmem {
  float* stat;  // [BM][2] row mean, rstd
  float* red;   // [BM][16] partial sums
  void* qkv;    // [BM][3D] one head's q|k|v
  float* sc;    // [BM][L] its scores
  float* Y;     // tensor cores: product tile; CUDA cores: staged weights
  float* As;    // CUDA cores: staged A tile
};

template <typename T, int BM>
__device__ __forceinline__ AttnSmem attn_carve(unsigned char* p, int D,
                                               int L) {
  const int yw = 3 * D > kAttnNC ? 3 * D : kAttnNC;
  AttnSmem s;
  s.stat = reinterpret_cast<float*>(p);
  p += align_up(size_t(BM) * 2 * 4);
  s.red = reinterpret_cast<float*>(p);
  p += align_up(size_t(BM) * 16 * 4);
  s.qkv = p;
  p += align_up(size_t(BM) * 3 * D * sizeof(T));
  s.sc = reinterpret_cast<float*>(p);
  p += align_up(size_t(BM) * L * 4);
  s.Y = reinterpret_cast<float*>(p);
  s.As = s.Y + align_up(size_t(kBK) * yw * 4) / 4;
  return s;
}

// Rows [row0, row0 + rows) of the tile and the LayerNorm statistics of x's
// rows there into s.stat (two passes over global memory; rows past the
// block's tracks read as 0).
template <typename T, int BM>
__device__ __forceinline__ void attn_row_stats(const T* __restrict__ x,
                                               int row0, int rows, int C,
                                               const AttnSmem& s) {
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  float part[BM / 16];
#pragma unroll
  for (int i = 0; i < BM / 16; ++i) {
    const int r = ty + 16 * i;
    float sum = 0.f;
    if (r < rows)
      for (int c = tx; c < C; c += 16)
        sum += to_f<T>(x[size_t(row0 + r) * C + c]);
    part[i] = sum;
  }
  row_reduce<BM>(part, C, s.stat, 0, s.red);
#pragma unroll
  for (int i = 0; i < BM / 16; ++i) {
    const int r = ty + 16 * i;
    const float mean = s.stat[2 * r];
    float sum = 0.f;
    for (int c = tx; c < C; c += 16) {
      const float v = r < rows ? to_f<T>(x[size_t(row0 + r) * C + c]) : 0.f;
      sum += (v - mean) * (v - mean);
    }
    part[i] = sum;
  }
  row_reduce<BM>(part, C, s.stat, 1, s.red);
  if (tid < BM) s.stat[2 * tid + 1] = rsqrtf(s.stat[2 * tid + 1] + 1e-6f);
  __syncthreads();
}

// Kernel 1 of fused_ln_attn, row tile blockIdx.x: the normalized rows,
// rounded to T, into its scratch tile of xs_all.
template <typename T, int BM>
__device__ __forceinline__ void attn_ln_body(const T* __restrict__ x,
                                             T* xs_all, int R, int C, int L,
                                             int H, unsigned char* smem) {
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const AttnSmem s = attn_carve<T, BM>(smem, C / H, L);
  const int BR = block_rows(L, BM);
  const int row0 = blockIdx.x * BR;
  const int rows = R - row0 < BR ? R - row0 : BR;
  T* xs = xs_all + size_t(blockIdx.x) * BM * C;
  attn_row_stats<T, BM>(x, row0, rows, C, s);
#pragma unroll
  for (int i = 0; i < BM / 16; ++i) {
    const int r = ty + 16 * i;
    const float mean = s.stat[2 * r], rstd = s.stat[2 * r + 1];
    for (int c = tx; c < C; c += 16) {
      const float v = r < rows ? to_f<T>(x[size_t(row0 + r) * C + c]) : 0.f;
      xs[size_t(r) * C + c] = from_f<T>((v - mean) * rstd);
    }
  }
}

// Kernel 2, row tile blockIdx.x and head h = blockIdx.y: q|k|v of the head
// from xs, attention within each track, the output into os[:, hD:(h+1)D].
template <typename T, bool TC, int BM>
__device__ __forceinline__ void attn_heads_body(
    const T* __restrict__ w_in, const T* __restrict__ b_in, const T* xs_all,
    T* os_all, int R, int C, int L, int H, unsigned char* smem) {
  const int D = C / H, h = blockIdx.y;
  const AttnSmem s = attn_carve<T, BM>(smem, D, L);
  const int BR = block_rows(L, BM);
  const int row0 = blockIdx.x * BR;
  const int rows = R - row0 < BR ? R - row0 : BR;
  const T* xs = xs_all + size_t(blockIdx.x) * BM * C;
  T* os = os_all + size_t(blockIdx.x) * BM * C;
  T* qkv = static_cast<T*>(s.qkv);
  head_qkv<T, TC, BM, 1, kAttnNJQ>(qkv, xs, C, w_in, b_in, C, D, h, s.Y,
                                   s.As);
  head_attention<T, BM>(qkv, s.sc, os + h * D, C, rows, L, D,
                        1.0f / sqrtf(float(D)));
}

// Kernel 3, row tile blockIdx.x and column chunk n0 = kAttnNC blockIdx.y of
// the output: out = xn32 + (os @ w_out^T + b_out).
template <typename T, bool TC, int BM>
__device__ __forceinline__ void attn_out_body(
    const T* __restrict__ x, const T* __restrict__ w_out,
    const T* __restrict__ b_out, T* __restrict__ out, const T* os_all,
    int R, int C, int L, int H, unsigned char* smem) {
  constexpr int RI = BM / 16;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const AttnSmem s = attn_carve<T, BM>(smem, C / H, L);
  const int BR = block_rows(L, BM);
  const int row0 = blockIdx.x * BR;
  const int rows = R - row0 < BR ? R - row0 : BR;
  const T* os = os_all + size_t(blockIdx.x) * BM * C;
  const int n0 = blockIdx.y * kAttnNC;
  const int nc = C - n0 < kAttnNC ? C - n0 : kAttnNC;
  attn_row_stats<T, BM>(x, row0, rows, C, s);
  if constexpr (TC) {
    gemm_tc<T, BM>(s.Y, kAttnNC, os, C, w_out + size_t(n0) * C, C, nc, C, nc,
                   0);
    for (int idx = tid; idx < rows * nc; idx += kThreads) {
      const int r = idx / nc, n = idx - r * nc, c = n0 + n;
      const float xn = (to_f<T>(x[size_t(row0 + r) * C + c]) - s.stat[2 * r])
                       * s.stat[2 * r + 1];
      out[size_t(row0 + r) * C + c] =
          from_f<T>(xn + (s.Y[r * kAttnNC + n] + to_f<T>(b_out[c])));
    }
  } else {
    float t[RI][kAttnNC / 16];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < kAttnNC / 16; ++j) t[i][j] = 0.f;
    gemm_nt<T, RI, kAttnNC / 16, true>(t, os, C, w_out + size_t(n0) * C, C,
                                       nc, C, s.Y, 0, 0, s.As);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = ty + 16 * i;
      if (r >= rows) continue;
      const float mean = s.stat[2 * r], rstd = s.stat[2 * r + 1];
#pragma unroll
      for (int j = 0; j < kAttnNC / 16; ++j) {
        const int n = tx + 16 * j, c = n0 + n;
        if (n < nc) {
          const float xn = (to_f<T>(x[size_t(row0 + r) * C + c]) - mean)
                           * rstd;
          out[size_t(row0 + r) * C + c] =
              from_f<T>(xn + (t[i][j] + to_f<T>(b_out[c])));
        }
      }
    }
  }
}

}  // namespace vf
