// Device code of the fused former kernels: a whole pre-LN transformer block,
// the LN -> MLP -> residual tail, and the LN -> attention -> residual half.
//
// Replaces vggsfm_tpu/ops/fused_mlp.py:
//   fused_transformer_block (_block_kernel) -> block_body below,
//   fused_ln_mlp (_kernel)                  -> ln_mlp_body below; at
//       384 < C <= 768 in bf16: ln_rows_body + tc_gemm_body (three kernels),
//       in f32: ln_rows_body + cc_gemm_body (three kernels),
//   fused_ln_attn (_attn_kernel)            -> ln_rows_body, cc_gemm_body,
//       attn_core_body, cc_gemm_body (four kernels).
//
// What bounds them on an H100: at the tracker's shapes the block is ~3.5
// MFLOP per row against ~1.5 KB of row traffic, far above the card's ~295
// FLOP/B ridge, so it is bound by operations: the matrix products (0.12 ms
// for the coarse time block, R = 33280, at the bf16 peak). Next comes the
// L2 traffic of weights every block re-reads: 3.54 MB per 64-row block at
// C = 384, 1.84 GB per launch at R = 33280, ~0.3 ms at the L2's rate.
// The block and ln_mlp at C <= 384 keep every intermediate on-chip, which
// is what the TPU kernel is for:
//   * one block of 256 threads (8 warps) owns a tile of 64 whole rows of
//     the MLP tail; up to 64 rows = whole tracks (64 / L tracks of L rows)
//     of the block kernel, so attention never leaves the block;
//   * the residual stream (x1, then the MLP output) stays in registers;
//   * attention runs head by head: q/k/v of one head (64 x 3D), its L x L
//     scores and its output are the only per-head state in shared memory,
//     and the out-projection accumulates into x1;
//   * the MLP streams the hidden width in chunks (fc1 chunk -> GELU ->
//     accumulate fc2), so the 4C hidden never exists.
//
// The ring path: the block kernel and ln_mlp at C <= 384 (the tracker's),
// block_body and ln_mlp_body below. Both take bf16 only, with C, the head
// width D and the hidden size M multiples of the 16-wide mma tile
// (check_*_shape); f32 blocks run as the attention half's and the f32 MLP
// path's kernels, other shapes plain (ops/fused_mlp.py). Against the
// operations it runs every product on
// the tensor cores with mma.sync m16n8k16 (bf16 operands, f32
// accumulation, the TPU kernel's preferred_element_type=f32 dots), both
// operands from shared memory by ldmatrix, warps split so that every
// product at C = 256 and 384 divides evenly over the 8 warps; x1 is the
// accumulator of the out-projections and of fc2, so no product lands in a
// shared f32 tile. Against the L2 latency the weights stream through a
// ring of kStages k-slabs filled by cp.async, two slabs in flight ahead of
// the one the tensor cores read, across product boundaries (the
// out-projection's slabs arrive while attention runs), one barrier per
// slab. Each weight byte enters a block once; sharing slabs across blocks
// (clusters, TMA multicast) is what would cut the L2 traffic itself.
//
// The wide MLP path: ln_mlp in bf16 at 384 < C <= 768 (the camera's
// cross-attention tails, R = 32312, C = 768, M = 3072: 305 GFLOP, 0.31 ms
// at the bf16 peak, bound by operations). A whole-row tile there holds 32
// rows at most, and every 32-row block would re-read all 9.4 MB of weights
// (9.5 GB of L2 reads per launch). So the op runs as three kernels with the
// TPU kernel's rounding points: ln_rows_body writes xn = bf16(LN(x));
// tc_gemm_body writes h = bf16(gelu(xn w1^T + b1)), then out = bf16(x +
// (h w2^T + b2)). Each GEMM block computes a 128 x 128 output tile (warp
// tile 64 x 32 on mma.sync m16n8k16, accumulators in registers to the
// epilogue) with both operands streamed through a three-stage cp.async
// ring of 64-deep k-slabs and read by ldmatrix: 64 FLOP per byte staged,
// every weight byte read once per 128 rows (2.4 GB of L2 weight reads per
// launch). Each thread finds its copies' source rows once (SlabCopy): the
// copies the compute warps issue per slab are then a cp.async and an add
// each. h (R x M bf16, 199 MB at the camera's shape) goes through device
// memory once each way, 0.12 ms at its rate.
//
// The attention half (fused_ln_attn, C <= 768, heads up to 128 wide): at
// the camera trunk (R = 64, L = 8, C = 768, f32) it is 0.3 GFLOP against
// 9.4 MB of f32 weights, so what bounds it is spreading the weight stream
// over the card and keeping it in flight. Four kernels: ln_rows_body (xs =
// LN(x) rounded to T, and the f32 row statistics); cc_gemm_body for qkv =
// T(xs w_in^T + b_in); attn_core_body, one block per (row tile of whole
// tracks, head), softmax(q k^T / sqrt(D)) v into os; cc_gemm_body for out =
// T(LN(x) + (os w_out^T + b_out)). cc_gemm_body is an f32 CUDA-core GEMM
// (f32 sums of products of f32 or widened bf16 values: no TF32) whose block
// owns a row tile and a narrow column slice; 16-byte cp.async copies bring
// the next 256-byte-deep k-slab of both operands while the current one is
// read (SlabCopy). The tile (64 x
// 64, 64 x 16 or 16 x 16) is the largest that still gives every SM of the
// card a block (cc_tile): at R = 64 the q|k|v product runs 144 blocks of 16
// columns and the out-projection 192 of 16 x 16, each weight byte read by
// one (four) blocks; at R = 4096, 64 x 64 tiles.
//
// The f32 MLP path: fused_ln_mlp in f32 runs the wide path's three steps
// with cc_gemm_body for the two products (ln_rows_body, then h = gelu(xn
// w1^T + b1) and out = x + (h w2^T + b2) through f32 scratch), so that an
// f32 block (the tracker's f32 precision) runs hand-written kernels end to
// end without a second body of the ring path.
//
// Shared memory peaks at 201,216 bytes per block (ring path, C = 384,
// D = 64, L = 64), inside the 232,448 a Hopper block may take.
//
// Dtype contract (fused_mlp.py:58-137): LN statistics, every accumulation,
// softmax and x1 are f32; the normalized input, q/k/v, the probabilities,
// the per-head outputs and the GELU output are rounded to the working dtype.
//
// Apart from cp.async, ldmatrix and mma.sync the code uses only
// threadIdx/blockIdx, __syncthreads, shared and global memory (no warp
// shuffles: row statistics meet in shared memory), so host_emu.h, which
// emulates those three calls too, runs it on the CPU for testing.
#pragma once

#ifdef __CUDACC__
#include <cuda_bf16.h>
#endif

namespace vf {

using bf = __nv_bfloat16;  // the ring and wide paths' working dtype

constexpr int kThreads = 256;        // 16 x 16 thread grid, 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxC = 384;           // widest C of the 64-row register tile
constexpr int kMaxWideC = 768;       // widest C of the wide MLP path and of
                                     // the attention half
constexpr int kMaxD = 64;            // widest head of the block kernel
constexpr int kMaxL = 64;            // longest attention group (rows/track)
constexpr int kAttnMaxD = 128;       // widest head of the attention half

// The row tile of the ring path (the block kernel; ln_mlp at C <= 384):
// 64 rows of up to kMaxC columns.
struct NarrowTile {
  static constexpr int BM = 64;
};

// ---------------------------------------------------------------- host side

// shared-memory regions start on 128-byte boundaries
__host__ __device__ inline size_t align_up(size_t n) {
  return (n + 127) & ~size_t(127);
}

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// Constants and shared memory of the ring path (the block kernel and
// ln_mlp at C <= 384; see "the ring path" below).
constexpr int kStages = 3;             // weight ring: stages of k-slabs
constexpr int kRC = 128;               // MLP hidden chunk of the ring path
constexpr int kPad = 8;                // bf16 padding of shared-memory rows
constexpr int kRingBK = 32;            // slab depth a stage holds at its widest
constexpr int kXT = kMaxC / 64;        // x1 column tiles (n8) per warp
constexpr int kQT = 3 * kMaxD / 16;    // q|k|v column tiles per warp
constexpr int kHT = kRC / 16;          // fc1 column tiles per warp

// Weight rows of the widest product (C, 3D or the hidden chunk).
__host__ __device__ inline int ring_rows(int C, int D) {
  const int r = C > 3 * D ? C : 3 * D;
  return r > kRC ? r : kRC;
}

__host__ __device__ inline size_t ring_stage_bytes(int C, int D) {
  return align_up(size_t(ring_rows(C, D)) * (kRingBK + kPad) * 2);
}

// Depth of the slabs of a product with N weight rows: the deepest of 128,
// 64 and 32 k-columns whose padded rows fit a stage.
__host__ __device__ inline int slab_depth(int N, size_t stage) {
  for (int bk = 128; bk > kRingBK; bk /= 2)
    if (size_t(N) * (bk + kPad) * 2 <= stage) return bk;
  return kRingBK;
}

// the A tile xa, the ring, the row statistics and their partials
__host__ __device__ inline size_t ring_common(int C, int D) {
  const size_t BM = NarrowTile::BM;
  return align_up(BM * (C + kPad) * 2) + kStages * ring_stage_bytes(C, D)
         + align_up(BM * 2 * 4) + align_up(BM * 32 * 4);
}

// one head's q|k|v, scores and output; the GELU chunk (they alias)
__host__ __device__ inline size_t ring_attn_scratch(int D, int L) {
  const size_t BM = NarrowTile::BM;
  return align_up(BM * 3 * D * 2) + align_up(BM * L * 4)
         + align_up(BM * (D + kPad) * 2);
}

__host__ __device__ inline size_t ring_mlp_scratch() {
  return align_up(size_t(NarrowTile::BM) * (kRC + kPad) * 2);
}

// The tensor-core GEMM of the wide MLP path (tc_gemm_body): 128 x 128
// output tiles, kGStages stages of 64-deep slabs of both operands, two
// blocks per SM.
constexpr int kGM = 128;               // rows of a tile
constexpr int kGN = 128;               // columns of a tile
constexpr int kGK = 64;                // k-depth of a slab
constexpr int kGStages = 3;            // slabs in the ring
constexpr int kGBlocksPerSM = 2;       // the kernel's __launch_bounds__
constexpr int kGLd = kGK + kPad;       // padded slab row, bf16 elements
constexpr int kGNT = kGN / 32;         // n8 column tiles of a warp (4 x 2)

__host__ __device__ inline size_t tc_gemm_smem_bytes() {
  return size_t(kGStages) * (kGM + kGN) * kGLd * 2;
}

// Whether fused_ln_mlp in a working dtype of tsize bytes runs as three
// kernels (the LayerNorm pass, then two GEMMs): in bf16 above C = 384 (the
// wide path's tensor-core GEMMs) and in f32 at every width (the attention
// half's CUDA-core GEMM); the ring path's one kernel otherwise.
inline bool split_mlp(int tsize, int C) { return tsize == 4 || C > kMaxC; }

inline int ln_mlp_kernels(int tsize, int C) {
  return split_mlp(tsize, C) ? 3 : 1;
}

// The three-kernel path's scratch, one array of the working dtype: xn
// (R, C), then h (R, M).
inline size_t split_mlp_scratch_bytes(int tsize, int R, int C, int M) {
  return split_mlp(tsize, C) ? size_t(R) * (C + M) * tsize : 0;
}

// The LayerNorm pass (ln_rows_body): one warp per row, its partial sums
// meeting in shared memory.
constexpr int kLnRows = kWarps;

inline size_t ln_rows_smem_bytes() { return size_t(2) * kThreads * 4; }

// The CUDA-core GEMM of the attention half (cc_gemm_body): RT x CT outputs
// per thread of the 16 x 16 grid, so a 16 RT x 16 CT tile per block; a ring
// of two 256-byte-deep slabs of both operands, rows padded by 16 bytes
// (deeper rings measured no faster, and slower at R = 4096 where the
// smaller carve fits more blocks per SM: tools/ablate_camera.py).
constexpr int kCStages = 2;
constexpr int kCSlabBytes = 256;
constexpr int kCLdBytes = kCSlabBytes + 16;

__host__ __device__ inline size_t cc_gemm_smem_bytes(int rt, int ct) {
  return size_t(kCStages) * 16 * (rt + ct) * kCLdBytes;
}

// The tile of an (R x N) cc_gemm_body product, as 10 RT + CT: the largest
// of 64 x 64, 64 x 16 and 16 x 16 that still gives each of the card's
// `sms` SMs a block (two for 64 x 64).
inline int cc_tile(int R, int N, int sms) {
  if (long(cdiv(R, 64)) * cdiv(N, 64) >= 2L * sms) return 44;
  if (long(cdiv(R, 64)) * cdiv(N, 16) >= sms) return 41;
  return 11;
}

// In bf16 (f32 takes cc_gemm_body's tiles, as the attention half).
inline size_t ln_mlp_smem_bytes(int C) {
  return split_mlp(2, C) ? tc_gemm_smem_bytes()
                     : ring_common(C, 0) + ring_mlp_scratch();
}

inline size_t block_smem_bytes(int C, int H, int L) {
  const int D = C / H;
  const size_t a = ring_attn_scratch(D, L), m = ring_mlp_scratch();
  return ring_common(C, D) + (a > m ? a : m);
}

// Rows a block of a whole-track kernel owns out of a BM-row tile.
__host__ __device__ inline int block_rows(int L, int BM = NarrowTile::BM) {
  return (BM / L) * L;
}

// Row tile of attn_core_body: the smallest of 16, 32 and 64 rows that
// holds a whole track (L = 8: two tracks), so a short input still spreads
// over many blocks.
__host__ __device__ inline int attn_tile_rows(int L) {
  return L <= 16 ? 16 : L <= 32 ? 32 : 64;
}

// Shared memory of one attn_core_body block: one head's q|k|v, its scores
// and its output.
inline size_t attn_core_smem_bytes(int C, int H, int L, int tsize) {
  const int D = C / H, BM = attn_tile_rows(L);
  return align_up(size_t(BM) * 3 * D * tsize) + align_up(size_t(BM) * L * 4)
         + align_up(size_t(BM) * D * tsize);
}

// The attention half's scratch, one array: xs (R, C), qkv (R, 3C) and os
// (R, C) of the working dtype, then the f32 row statistics (R, 2). Every
// part starts 32-byte aligned (C % 16 == 0).
inline size_t attn_scratch_bytes(int R, int C, int tsize) {
  return size_t(R) * C * tsize * 5 + size_t(R) * 8;
}

struct AttnScratch {
  void* xs;
  void* qkv;
  void* os;
  float* stats;
};

inline AttnScratch attn_scratch_carve(void* p, int R, int C, int tsize) {
  unsigned char* b = static_cast<unsigned char*>(p);
  const size_t part = size_t(R) * C * tsize;
  return {b, b + part, b + 4 * part, reinterpret_cast<float*>(b + 5 * part)};
}

// The most shared memory any block of the attention half's kernels takes.
inline size_t attn_smem_bytes(int C, int H, int L, int tsize) {
  const size_t core = attn_core_smem_bytes(C, H, L, tsize);
  const size_t gemm = cc_gemm_smem_bytes(4, 4);  // the largest tile
  return core > gemm ? core : gemm;
}

// 0 when the kernels take these shapes, else a negative code naming the
// first violated limit; -8: a head width or hidden size that the 16-wide
// mma tiles do not divide.
inline int check_mlp_shape(int R, int C, int M) {
  if (R < 1) return -1;
  if (C < 16 || C > kMaxWideC || C % 16 != 0) return -2;
  if (M < 1) return -3;
  if (M % 16 != 0) return -8;
  return 0;
}

inline int check_block_shape(int R, int C, int M, int L, int H) {
  if (R < 1) return -1;
  if (C < 16 || C > kMaxC || C % 16 != 0) return -2;
  if (M < 1) return -3;
  if (L < 1 || L > kMaxL) return -4;
  if (R % L != 0) return -5;
  if (H < 1 || C % H != 0 || C / H > kMaxD) return -6;
  if ((C / H) % 16 != 0 || M % 16 != 0) return -8;
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

#ifdef __CUDACC__
// The warp-level PTX of the ring path (host_emu.h emulates the same five
// calls on the CPU).
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1
__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// waits until at most N committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four / two 8x8 bf16 matrices; lanes 8i..8i+7 address the rows of matrix i
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x2(unsigned (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p))
               : "memory");
}

// d += a b: a 16x16 bf16 A fragment, a 16x8 bf16 B fragment, f32 d
__device__ __forceinline__ void mma_16816(float (&d)[4],
                                          const unsigned (&a)[4],
                                          const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
#endif

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

// ------------------------------------------------------------ the ring path
//
// The block kernel and ln_mlp at C <= 384, bf16 (64-row tiles). Warp w of
// 8, lane l, g = l / 4, t = l % 4.
//
// Every product reads its weight operand from a ring of kStages k-slabs in
// shared memory: N weight rows (a torch Linear's (out, in) rows are
// k-contiguous) x bk k-columns, rows padded by kPad so ldmatrix reads them
// without bank conflicts. A block's slabs form one stream (WeightStream):
// per head the q|k|v product and the out-projection, then per hidden chunk
// fc1 and fc2. All threads fill slab g + kStages - 1 with 16-byte
// cp.async copies while the tensor cores (mma.sync m16n8k16, fragments by
// ldmatrix) consume slab g, across product boundaries too; one barrier per
// slab.

// The weight-slab stream of a block, in the order the block reads it; slab
// g lives in ring stage g % kStages.
template <typename T>
struct WeightStream {
  const T* w_in;
  const T* w_out;
  const T* w1;
  const T* w2;
  unsigned char* ring;
  size_t stage;          // bytes of one ring stage
  int C, D, M;
  int bq, bo, b1, b2;    // slab depths: q|k|v, out-projection, fc1, fc2
  int nq, no, n1, n2;    // slabs per product
  int nhead;             // slabs of the attention half: H (nq + no)
  int total;

  __device__ __forceinline__ T* slab(int g) const {
    return reinterpret_cast<T*>(ring + size_t(g % kStages) * stage);
  }

  // Issues the copies of slab g (none past the end of the stream) and
  // commits them as one group.
  __device__ __forceinline__ void issue(int g) const {
    if (g < total) {
      const T* W;
      int ldw, N, K, bk, k0, row0 = 0, col0 = 0, seg = 0;
      if (g < nhead) {
        const int h = g / (nq + no), s = g - h * (nq + no);
        if (s < nq) {  // q|k|v rows of head h: three D-row segments
          W = w_in; ldw = C; N = 3 * D; K = C; bk = bq; k0 = s * bq;
          row0 = h * D; seg = D;
        } else {       // all C rows, the head's D columns
          W = w_out; ldw = C; N = C; K = D; bk = bo; k0 = (s - nq) * bo;
          col0 = h * D;
        }
      } else {
        const int c = (g - nhead) / (n1 + n2), s = g - nhead - c * (n1 + n2);
        const int m0 = c * kRC, mc = M - m0 < kRC ? M - m0 : kRC;
        if (s < n1) {  // the chunk's mc rows of fc1
          W = w1; ldw = C; N = mc; K = C; bk = b1; k0 = s * b1; row0 = m0;
        } else {       // all C rows of fc2, the chunk's mc columns
          W = w2; ldw = M; N = C; K = mc; bk = b2; k0 = (s - n1) * b2;
          col0 = m0;
        }
      }
      const int kb = K - k0 < bk ? K - k0 : bk;  // <= 0: an empty slab
      if (kb > 0) {
        // thread t copies 16-byte chunk t % cpr of rows t / cpr + i step
        const int cpr = kb / 8, step = kThreads / cpr;
        if (int(threadIdx.x) < step * cpr) {
          const int c8 = threadIdx.x % cpr;
          T* dst = slab(g) + c8 * 8;
          const T* src = W + col0 + k0 + c8 * 8;
          // the q|k|v segments lie C - D rows apart in w_in
          const int skip = C - seg;
          for (int n = threadIdx.x / cpr; n < N; n += step) {
            const int wr = row0 + n
                           + (seg ? ((n >= seg) + (n >= 2 * seg)) * skip : 0);
            cp_async_16(dst + n * (bk + kPad), src + size_t(wr) * ldw);
          }
        }
      }
    }
    cp_async_commit();
  }
};

// The stream of a block kernel (H heads of width D) or, with H = D = 0, of
// ln_mlp. Every hidden chunk has the same slab count, so the last, shorter
// chunk ends in empty slabs.
template <typename T>
__device__ __forceinline__ WeightStream<T> make_stream(
    const T* w_in, const T* w_out, const T* w1, const T* w2,
    unsigned char* ring, int C, int D, int H, int M) {
  WeightStream<T> ws;
  ws.w_in = w_in; ws.w_out = w_out; ws.w1 = w1; ws.w2 = w2;
  ws.ring = ring;
  ws.stage = ring_stage_bytes(C, D);
  ws.C = C; ws.D = D; ws.M = M;
  const int mc = M < kRC ? M : kRC;
  ws.bq = slab_depth(3 * D, ws.stage);
  ws.bo = slab_depth(C, ws.stage);
  ws.b1 = slab_depth(mc, ws.stage);
  ws.b2 = ws.bo;
  ws.nq = cdiv(C, ws.bq);
  ws.no = cdiv(D, ws.bo);
  ws.n1 = cdiv(C, ws.b1);
  ws.n2 = cdiv(mc, ws.b2);
  ws.nhead = H * (ws.nq + ws.no);
  ws.total = ws.nhead + cdiv(M, kRC) * (ws.n1 + ws.n2);
  return ws;
}

// acc += A B^T over the next nslab slabs of the stream (one product; g
// advances past them): A bf16 in shared memory with row stride lda (an odd
// multiple of 16 bytes: ldmatrix without bank conflicts), B the product's
// weight slabs, bk deep, K deep in all. The warp computes the m16 row tiles
// mt0 .. mt0 + MT - 1 and the n8 column tiles nt0 .. nt0 + nT - 1 (nT <=
// NT); acc[i][j] is the m16n8 fragment of row tile mt0 + i and column tile
// nt0 + j. Each slab begins with the wait for it and one barrier; then the
// slab kStages - 1 ahead goes into the stage read last, so callers need no
// barrier between writing A and calling. The copies are issued whole, at
// once: spread over the slab's 16-deep steps they hold back the ldmatrix
// loads that share the load/store path, 1.4x slower (tools/ablate_ring.py).
template <int MT, int NT, typename T>
__device__ __forceinline__ void ring_product(float (&acc)[MT][NT][4],
                                             const T* A, int lda, int mt0,
                                             int nt0, int nT, int K, int bk,
                                             int nslab, int& g,
                                             const WeightStream<T>& ws) {
  static_assert(NT % 2 == 0, "column tiles go in pairs");
  const int lane = threadIdx.x & 31;
  const int ldb = bk + kPad;
  for (int s = 0; s < nslab; ++s, ++g) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int k0 = s * bk;
    const int kb = K - k0 < bk ? K - k0 : bk;
    const T* B = ws.slab(g);
    ws.issue(g + kStages - 1);
    for (int kk = 0; kk < kb; kk += 16) {
      // A: matrices (rows +0/+8) x (k +0/+8); B: (k +0/+8) x (tiles j, j+1)
      unsigned a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldsm_x4(a[i], A + (16 * (mt0 + i) + (lane & 15)) * lda + k0 + kk
                          + (lane >> 4) * 8);
      const T* bp = B + (8 * nt0 + (lane & 7)) * ldb + kk
                    + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        if (j + 1 < nT) {
          unsigned b[4];
          ldsm_x4(b, bp + (8 * j + (lane >> 4) * 8) * ldb);
          const unsigned lo[2] = {b[0], b[1]}, hi[2] = {b[2], b[3]};
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            mma_16816(acc[i][j], a[i], lo);
            mma_16816(acc[i][j + 1], a[i], hi);
          }
        } else if (j < nT) {
          unsigned b[2];
          ldsm_x2(b, bp + 8 * j * ldb);
#pragma unroll
          for (int i = 0; i < MT; ++i) mma_16816(acc[i][j], a[i], b);
        }
      }
    }
  }
}

// 8 bf16 from 16-byte aligned shared memory, widened to f32
struct alignas(16) Pack8 {
  unsigned w[4];
};

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&f)[8]) {
  const Pack8 u = *reinterpret_cast<const Pack8*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u.w[i] << 16);
    f[2 * i + 1] = __uint_as_float(u.w[i] & 0xffff0000u);
  }
}

// 16 bytes of T as f32 values, and back (rounded to T)
template <typename T>
__device__ __forceinline__ void load_pack(const T* p,
                                          float (&f)[16 / sizeof(T)]) {
  if constexpr (sizeof(T) == 4) {
    const Pack8 u = *reinterpret_cast<const Pack8*>(p);
#pragma unroll
    for (int i = 0; i < 4; ++i) f[i] = __uint_as_float(u.w[i]);
  } else {
    load8(p, f);
  }
}

template <typename T>
__device__ __forceinline__ void store_pack(T* p,
                                           const float (&f)[16 / sizeof(T)]) {
  Pack8 u;
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i) u.w[i] = __float_as_uint(f[i]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      u.w[i] = unsigned(__bfloat16_as_ushort(from_f<T>(f[2 * i])))
               | unsigned(__bfloat16_as_ushort(from_f<T>(f[2 * i + 1])))
                     << 16;
  }
  *reinterpret_cast<Pack8*>(p) = u;
}

// head_attention with 16-byte loads, for the ring path (bf16, D % 16 == 0)
// and the attention core (D % 8 == 0): the same sums in the same order,
// with q, k and v read V = 16 / sizeof(T) values per load, so the loops
// are not held up by one shared-memory load per product. Each P V item is
// V output columns of one row.
template <typename T, int BM>
__device__ __forceinline__ void ring_head_attention(const T* qkv, float* sc,
                                                    T* o, int ldo, int rows,
                                                    int L, int D,
                                                    float scale) {
  constexpr int V = 16 / sizeof(T);
  const int tid = threadIdx.x, ld = 3 * D;
  for (int idx = tid; idx < rows * L; idx += kThreads) {
    const int r = idx / L, j = idx - r * L;
    const T* q = qkv + r * ld;
    const T* k = qkv + ((r / L) * L + j) * ld + D;
    float d = 0.f;
    for (int e0 = 0; e0 < D; e0 += V) {
      float qv[V], kv[V];
      load_pack<T>(q + e0, qv);
      load_pack<T>(k + e0, kv);
#pragma unroll
      for (int e = 0; e < V; ++e) d = fmaf(qv[e], kv[e], d);
    }
    sc[r * L + j] = d * scale;
  }
  __syncthreads();
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
  const int groups = D / V;
  for (int idx = tid; idx < BM * groups; idx += kThreads) {
    const int r = idx / groups, e0 = (idx - r * groups) * V;
    float acc[V];
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = 0.f;
    if (r < rows) {
      const int base = (r / L) * L;
      const float* p = sc + r * L;
      for (int j = 0; j < L; ++j) {
        float v[V];
        load_pack<T>(qkv + (base + j) * ld + 2 * D + e0, v);
#pragma unroll
        for (int e = 0; e < V; ++e) acc[e] = fmaf(p[j], v[e], acc[e]);
      }
    }
#pragma unroll
    for (int e = 0; e < V; ++e) o[r * ldo + e0 + e] = from_f<T>(acc[e]);
  }
}

// The register tile x1 of the ring path: 64 rows x C f32 as m16n8
// fragments, warp w holding all four row tiles of the column tiles
// nt0 .. nt0 + nT - 1 (C / 8 tiles in even shares: 6 per warp at C = 384).
// Element e of x1[i][j] is row 16 i + g + 8 (e / 2), column
// 8 (nt0 + j) + 2 t + e % 2.
using XAcc = float[4][kXT][4];

struct XTile {
  int nt0, nT;
};

__device__ __forceinline__ XTile x_tile(int C) {
  const int per = cdiv(C / 8, kWarps), w = threadIdx.x >> 5;
  const int n = C / 8 - w * per;
  return {w * per, n < 0 ? 0 : n < per ? n : per};
}

template <typename T>
__device__ __forceinline__ void ring_load(XAcc& v, XTile xt,
                                          const T* __restrict__ x, int row0,
                                          int rows, int C) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kXT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 16 * i + (lane >> 2) + 8 * (e >> 1);
        const int c = 8 * (xt.nt0 + j) + 2 * (lane & 3) + (e & 1);
        v[i][j][e] = (j < xt.nT && r < rows)
                         ? to_f<T>(x[size_t(row0 + r) * C + c]) : 0.f;
      }
}

template <typename T>
__device__ __forceinline__ void ring_store(const XAcc& v, XTile xt,
                                           const T* __restrict__ bias,
                                           T* __restrict__ out, int row0,
                                           int rows, int C) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kXT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 16 * i + (lane >> 2) + 8 * (e >> 1);
        const int c = 8 * (xt.nt0 + j) + 2 * (lane & 3) + (e & 1);
        if (j < xt.nT && r < rows)
          out[size_t(row0 + r) * C + c] = from_f<T>(v[i][j][e]
                                                    + to_f<T>(bias[c]));
      }
}

// Row sums of the x1 tile, given each thread's partial sums part[i][h] of
// its rows 16 i + g + 8 h, divided by C into stat[2 r + slot]: a row's 32
// partials (4 lanes x 8 warps) meet in red [64][32].
__device__ __forceinline__ void ring_row_reduce(const float (&part)[4][2],
                                                int C, float* stat, int slot,
                                                float* red) {
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      red[(16 * i + 8 * h + (lane >> 2)) * 32 + 4 * w + (lane & 3)] =
          part[i][h];
  __syncthreads();
  if (tid < 64) {
    float s = 0.f;
    for (int p = 0; p < 32; ++p) s += red[tid * 32 + p];
    stat[2 * tid + slot] = s / C;
  }
  __syncthreads();
}

// LayerNorm (no affine, eps 1e-6) of the x1 tile into the A tile xa,
// rounded to T; the f32 mean and rstd of row r in stat[2r], stat[2r+1].
// Two passes, as jnp.var.
template <typename T>
__device__ __forceinline__ void ring_layer_norm(const XAcc& v, XTile xt,
                                                int C, T* xa, int lda,
                                                float* stat, float* red) {
  const int lane = threadIdx.x & 31;
  float part[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < kXT; ++j)
        if (j < xt.nT) s += v[i][j][2 * h] + v[i][j][2 * h + 1];
      part[i][h] = s;
    }
  ring_row_reduce(part, C, stat, 0, red);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float mean = stat[2 * (16 * i + 8 * h + (lane >> 2))];
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < kXT; ++j)
        if (j < xt.nT) {
          const float d0 = v[i][j][2 * h] - mean, d1 = v[i][j][2 * h + 1] - mean;
          s += d0 * d0 + d1 * d1;
        }
      part[i][h] = s;
    }
  ring_row_reduce(part, C, stat, 1, red);
  if (threadIdx.x < 64)
    stat[2 * threadIdx.x + 1] = rsqrtf(stat[2 * threadIdx.x + 1] + 1e-6f);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kXT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 16 * i + (lane >> 2) + 8 * (e >> 1);
        const int c = 8 * (xt.nt0 + j) + 2 * (lane & 3) + (e & 1);
        if (j < xt.nT)
          xa[r * lda + c] = from_f<T>((v[i][j][e] - stat[2 * r])
                                      * stat[2 * r + 1]);
      }
}

// The MLP half of the ring path: on return x1 holds
// x1 + fc2(gelu(fc1(LN(x1)))) without the fc2 bias. fc1 of each kRC-wide
// hidden chunk runs on a 4 x 2 warp grid (16 rows x mc / 2 columns per
// warp) into the GELU chunk hb; fc2 accumulates into x1.
template <typename T>
__device__ __forceinline__ void ring_mlp(XAcc& x1, XTile xt, int C, int M,
                                         const T* __restrict__ b1, T* xa,
                                         int lda, T* hb, float* stat,
                                         float* red, int& g,
                                         const WeightStream<T>& ws) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  constexpr int ldh = kRC + kPad;
  ring_layer_norm<T>(x1, xt, C, xa, lda, stat, red);
  for (int m0 = 0; m0 < M; m0 += kRC) {
    const int mc = M - m0 < kRC ? M - m0 : kRC, hT = mc / 16;
    float h[1][kHT][4];
#pragma unroll
    for (int j = 0; j < kHT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) h[0][j][e] = 0.f;
    ring_product<1, kHT>(h, xa, lda, w & 3, (w >> 2) * hT, hT, C, ws.b1,
                         ws.n1, g, ws);
#pragma unroll
    for (int j = 0; j < kHT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 16 * (w & 3) + (lane >> 2) + 8 * (e >> 1);
        const int n = 8 * ((w >> 2) * hT + j) + 2 * (lane & 3) + (e & 1);
        if (j < hT)
          hb[r * ldh + n] =
              from_f<T>(gelu_erf(h[0][j][e] + to_f<T>(b1[m0 + n])));
      }
    ring_product<4, kXT>(x1, hb, ldh, 0, xt.nt0, xt.nT, mc, ws.b2, ws.n2, g,
                         ws);
  }
}

// fused_transformer_block on rows of (R, C), attention within each group
// of L consecutive rows (one track), on the ring path:
//   xn = LN(x); x1 = xn + out_proj(MHA(xn)); out = x1 + MLP(LN(x1)).
// w_in (3C, C) packed q|k|v, b_in (3C), w_out (C, C), b_out (C) as
// torch.nn.MultiheadAttention; w1, b1, w2, b2 as ln_mlp_body.
__device__ __forceinline__ void block_body(
    const bf* __restrict__ x, const bf* __restrict__ w_in,
    const bf* __restrict__ b_in, const bf* __restrict__ w_out,
    const bf* __restrict__ b_out, const bf* __restrict__ w1,
    const bf* __restrict__ b1, const bf* __restrict__ w2,
    const bf* __restrict__ b2, bf* __restrict__ out, int R, int C, int M,
    int L, int H, unsigned char* smem) {
  constexpr int BM = NarrowTile::BM;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int D = C / H, lda = C + kPad, ldo = D + kPad;
  unsigned char* p = smem;
  bf* xa = reinterpret_cast<bf*>(p);
  p += align_up(size_t(BM) * lda * 2);
  unsigned char* ring = p;
  p += kStages * ring_stage_bytes(C, D);
  float* stat = reinterpret_cast<float*>(p);
  p += align_up(size_t(BM) * 2 * 4);
  float* red = reinterpret_cast<float*>(p);
  p += align_up(size_t(BM) * 32 * 4);
  bf* qkv = reinterpret_cast<bf*>(p);  // [BM][3D]
  float* sc = reinterpret_cast<float*>(p + align_up(size_t(BM) * 3 * D * 2));
  bf* oh = reinterpret_cast<bf*>(reinterpret_cast<unsigned char*>(sc)
                               + align_up(size_t(BM) * L * 4));  // [BM][ldo]
  bf* hb = reinterpret_cast<bf*>(p);  // [BM][kRC + kPad], aliases them

  const WeightStream<bf> ws =
      make_stream<bf>(w_in, w_out, w1, w2, ring, C, D, H, M);
  for (int s = 0; s < kStages - 1; ++s) ws.issue(s);

  const int BMr = block_rows(L);
  const int row0 = blockIdx.x * BMr;
  const int rows = R - row0 < BMr ? R - row0 : BMr;
  const XTile xt = x_tile(C);
  XAcc x1;
  ring_load<bf>(x1, xt, x, row0, rows, C);
  ring_layer_norm<bf>(x1, xt, C, xa, lda, stat, red);
  // x1 starts as the f32 normalized input plus the out-proj bias (the
  // residual base is the NORMALIZED input)
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kXT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 16 * i + (lane >> 2) + 8 * (e >> 1);
        const int c = 8 * (xt.nt0 + j) + 2 * (lane & 3) + (e & 1);
        if (j < xt.nT)
          x1[i][j][e] = (x1[i][j][e] - stat[2 * r]) * stat[2 * r + 1]
                        + to_f<bf>(b_out[c]);
      }

  int g = 0;
  const int qT = 3 * D / 16;  // q|k|v column tiles per warp, 4 x 2 grid
  const float scale = 1.0f / sqrtf(float(D));
  for (int h = 0; h < H; ++h) {
    float q[1][kQT][4];
#pragma unroll
    for (int j = 0; j < kQT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) q[0][j][e] = 0.f;
    ring_product<1, kQT>(q, xa, lda, w & 3, (w >> 2) * qT, qT, C, ws.bq,
                         ws.nq, g, ws);
#pragma unroll
    for (int j = 0; j < kQT; ++j) {
      // columns n, n + 1 lie in one of the q, k, v segments (D is even)
      const int n = 8 * ((w >> 2) * qT + j) + 2 * (lane & 3);
      const int part = n / D, brow = part * C + h * D + n - part * D;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 16 * (w & 3) + (lane >> 2) + 8 * (e >> 1);
        if (j < qT)
          qkv[r * 3 * D + n + (e & 1)] =
              from_f<bf>(q[0][j][e] + to_f<bf>(b_in[brow + (e & 1)]));
      }
    }
    __syncthreads();
    ring_head_attention<bf, BM>(qkv, sc, oh, ldo, rows, L, D, scale);
    // x1 += o_h @ w_out[:, hD:(h+1)D]^T
    ring_product<4, kXT>(x1, oh, ldo, 0, xt.nt0, xt.nT, D, ws.bo, ws.no, g,
                         ws);
  }

  ring_mlp<bf>(x1, xt, C, M, b1, xa, lda, hb, stat, red, g, ws);
  ring_store<bf>(x1, xt, b2, out, row0, rows, C);
}

// fused_ln_mlp on the ring path: out = x + fc2(gelu(fc1(LN(x)))) on rows
// of (R, C), C <= 384, NarrowTile::BM rows per block. w1 (M, C), b1 (M),
// w2 (C, M), b2 (C): torch Linear layout (out, in). (384 < C <= 768 is the
// wide path's three kernels instead.)
__device__ __forceinline__ void ln_mlp_body(
    const bf* __restrict__ x, const bf* __restrict__ w1,
    const bf* __restrict__ b1, const bf* __restrict__ w2,
    const bf* __restrict__ b2, bf* __restrict__ out, int R, int C, int M,
    unsigned char* smem) {
  constexpr int BM = NarrowTile::BM;
  const int lda = C + kPad;
  unsigned char* p = smem;
  bf* xa = reinterpret_cast<bf*>(p);
  p += align_up(size_t(BM) * lda * 2);
  unsigned char* ring = p;
  p += kStages * ring_stage_bytes(C, 0);
  float* stat = reinterpret_cast<float*>(p);
  p += align_up(size_t(BM) * 2 * 4);
  float* red = reinterpret_cast<float*>(p);
  p += align_up(size_t(BM) * 32 * 4);
  bf* hb = reinterpret_cast<bf*>(p);

  const WeightStream<bf> ws =
      make_stream<bf>(nullptr, nullptr, w1, w2, ring, C, 0, 0, M);
  for (int s = 0; s < kStages - 1; ++s) ws.issue(s);

  const int row0 = blockIdx.x * BM;
  const int rows = R - row0 < BM ? R - row0 : BM;
  const XTile xt = x_tile(C);
  XAcc x1;
  ring_load<bf>(x1, xt, x, row0, rows, C);
  int g = 0;
  ring_mlp<bf>(x1, xt, C, M, b1, xa, lda, hb, stat, red, g, ws);
  ring_store<bf>(x1, xt, b2, out, row0, rows, C);
}

// ------------------------------------------- the wide MLP and attention paths
//
// Kernels that each run one step of the op over the whole input, meeting
// in scratch arrays the wrapper allocates: the LayerNorm pass, the GEMMs
// with their fused epilogues, and the attention core.

// The LayerNorm pass: xn = LN(x) (no affine, eps 1e-6, two passes as
// jnp.var) rounded to T, rows of (R, C); with stats, also the f32 mean and
// rstd of row r in stats[2r], stats[2r + 1]. Warp w of block b takes row
// kLnRows b + w, each lane the 16-byte packs lane, lane + 32, ... (24
// values at most); the lanes' partial sums meet in shared memory. x and
// xn 16-byte aligned.
template <typename T>
__device__ __forceinline__ void ln_rows_body(const T* __restrict__ x,
                                             T* __restrict__ xn,
                                             float* __restrict__ stats, int R,
                                             int C, unsigned char* smem) {
  constexpr int V = 16 / sizeof(T), P = kMaxWideC / (32 * V);
  float* red = reinterpret_cast<float*>(smem);  // [2][kThreads]
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int r = blockIdx.x * kLnRows + w;
  const int np = r < R ? C / V : 0;  // packs this lane's row has
  float v[P][V];
  float s = 0.f;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int c = (lane + 32 * p) * V;
    if (lane + 32 * p < np) {
      load_pack<T>(x + size_t(r) * C + c, v[p]);
#pragma unroll
      for (int e = 0; e < V; ++e) s += v[p][e];
    }
  }
  red[threadIdx.x] = s;
  __syncthreads();
  float mean = 0.f;
  for (int i = 0; i < 32; ++i) mean += red[32 * w + i];
  mean /= C;
  s = 0.f;
#pragma unroll
  for (int p = 0; p < P; ++p)
    if (lane + 32 * p < np)
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float d = v[p][e] - mean;
        s += d * d;
      }
  red[kThreads + threadIdx.x] = s;
  __syncthreads();
  float var = 0.f;
  for (int i = 0; i < 32; ++i) var += red[kThreads + 32 * w + i];
  const float rstd = rsqrtf(var / C + 1e-6f);
#pragma unroll
  for (int p = 0; p < P; ++p)
    if (lane + 32 * p < np) {
#pragma unroll
      for (int e = 0; e < V; ++e) v[p][e] = (v[p][e] - mean) * rstd;
      store_pack<T>(xn + size_t(r) * C + (lane + 32 * p) * V, v[p]);
    }
  if (stats && np && lane == 0) {
    stats[2 * r] = mean;
    stats[2 * r + 1] = rstd;
  }
}

// What a GEMM body does with its f32 sum y of output (r, c) before storing
// it to out[r * ldo + c], rounded to T; v = y + bias[c]:
//   kEpiBias: v;  kEpiGelu: gelu(v);  kEpiResid: res[r][c] + v;
//   kEpiNormResid: (res[r][c] - mean_r) rstd_r + v (the normalized
//   residual of the attention half, from the LayerNorm pass's statistics).
// res has out's row stride.
enum { kEpiBias, kEpiGelu, kEpiResid, kEpiNormResid };

template <typename T>
struct Epi {
  const T* bias;
  const T* res;
  const float* stats;
  T* out;
  int ldo;
};

template <int KIND, typename T>
__device__ __forceinline__ float epi_value(const Epi<T>& e, float y, int r,
                                           int c) {
  const float v = y + to_f<T>(e.bias[c]);
  if constexpr (KIND == kEpiGelu) {
    return gelu_erf(v);
  } else if constexpr (KIND == kEpiResid) {
    return to_f<T>(e.res[size_t(r) * e.ldo + c]) + v;
  } else if constexpr (KIND == kEpiNormResid) {
    return (to_f<T>(e.res[size_t(r) * e.ldo + c]) - e.stats[2 * r])
               * e.stats[2 * r + 1] + v;
  } else {
    return v;
  }
}

// The 16-byte cp.async copies that fill one stage of a GEMM block's ring:
// RA rows of A, then RB rows of W, CPR 16-byte chunks deep, as padded rows
// of LD elements. Thread t copies chunk t % CPR of rows t / CPR + p
// kThreads / CPR; its source rows are found once, rows past R (N) clamped
// to the last one (their results are not stored).
template <typename T, int RA, int RB, int CPR, int LD>
struct SlabCopy {
  static constexpr int kStep = kThreads / CPR;
  static constexpr int kPasses = (RA + RB) / kStep;
  static_assert((RA + RB) % kStep == 0, "whole passes");
  const T* src[kPasses];
  int dst, c;

  __device__ __forceinline__ SlabCopy(const T* A, int lda, int row0, int R,
                                      const T* W, int ldw, int col0, int N) {
    const int r0 = threadIdx.x / CPR;
    c = (threadIdx.x % CPR) * int(16 / sizeof(T));
    dst = r0 * LD + c;
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      const int row = r0 + p * kStep;
      if (row < RA) {
        const int gr = row0 + row < R ? row0 + row : R - 1;
        src[p] = A + size_t(gr) * lda + c;
      } else {
        const int gn = col0 + row - RA < N ? col0 + row - RA : N - 1;
        src[p] = W + size_t(gn) * ldw + c;
      }
    }
  }

  // k-columns [k0, k0 + kb) into `stage`
  __device__ __forceinline__ void issue(T* stage, int k0, int kb) const {
    if (c < kb) {
#pragma unroll
      for (int p = 0; p < kPasses; ++p)
        cp_async_16(stage + dst + p * kStep * LD, src[p] + k0);
    }
    cp_async_commit();  // one group per slab, empty past the last (kb <= 0)
  }
};

// Y = A W^T on the tensor cores, then the epilogue: A (R, K) bf16 with row
// stride lda, W (N, K) bf16 (a torch Linear's (out, in) weight) with row
// stride ldw; K, N, lda and ldw multiples of 8 and the arrays 16-byte
// aligned. Block (blockIdx.x, blockIdx.y) computes the 128 x 128 tile of
// columns kGN blockIdx.x and rows kGM blockIdx.y; warp w the 64 x 32
// sub-tile (w / 4, w % 4): 4 x 4 m16n8 accumulators, in registers until
// the epilogue. Slab s (32 k-columns of the tile's 128 A rows and 128 W
// rows, padded rows) goes to stage s % kGStages by 16-byte cp.async,
// kGStages - 1 slabs ahead of the one the tensor cores read, one barrier
// per slab. Rows past R (columns past N) read row R - 1 (N - 1) and are
// not stored.
template <int KIND>
__device__ __forceinline__ void tc_gemm_body(
    const __nv_bfloat16* __restrict__ A, int lda,
    const __nv_bfloat16* __restrict__ W, int ldw, int R, int N, int K,
    const Epi<__nv_bfloat16>& epi, unsigned char* smem) {
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int wm = w >> 2, wn = w & 3;
  const int row0 = blockIdx.y * kGM, col0 = blockIdx.x * kGN;
  bf* ring = reinterpret_cast<bf*>(smem);  // [kGStages][kGM + kGN][kGLd]
  constexpr int kStage = (kGM + kGN) * kGLd;
  const int nk = cdiv(K, kGK);
  const SlabCopy<bf, kGM, kGN, kGK / 8, kGLd> copy(A, lda, row0, R, W, ldw,
                                                   col0, N);
  auto issue = [&](int s) {
    copy.issue(ring + (s % kGStages) * kStage, s * kGK,
               K - s * kGK < kGK ? K - s * kGK : kGK);
  };

  float acc[4][kGNT][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kGNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  for (int s = 0; s < kGStages - 1; ++s) issue(s);
  for (int s = 0; s < nk; ++s) {
    cp_async_wait<kGStages - 2>();
    __syncthreads();  // slab s landed for all; slab s - 1 consumed
    issue(s + kGStages - 1);
    const bf* a = ring + (s % kGStages) * kStage + (64 * wm) * kGLd;
    const bf* b = ring + (s % kGStages) * kStage
                  + (kGM + 8 * kGNT * wn) * kGLd;
    const int kb = K - s * kGK < kGK ? K - s * kGK : kGK;
#pragma unroll
    for (int kk = 0; kk < kGK; kk += 16) {
      if (kk >= kb) break;  // a short last slab
      // A: matrices (rows +0/+8) x (k +0/+8); B: (k +0/+8) x (tiles j, j+1)
      unsigned fa[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldsm_x4(fa[i], a + (16 * i + (lane & 15)) * kGLd + kk
                           + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < kGNT; j += 2) {
        unsigned fb[4];
        ldsm_x4(fb, b + (8 * j + (lane & 7) + (lane >> 4) * 8) * kGLd + kk
                        + ((lane >> 3) & 1) * 8);
        const unsigned lo[2] = {fb[0], fb[1]}, hi[2] = {fb[2], fb[3]};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          mma_16816(acc[i][j], fa[i], lo);
          mma_16816(acc[i][j + 1], fa[i], hi);
        }
      }
    }
  }
  cp_async_wait<0>();
  // element e of acc[i][j]: row 16 i + g + 8 (e / 2), column 8 j + 2 t + e % 2
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kGNT; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = row0 + 64 * wm + 16 * i + (lane >> 2) + 8 * hh;
        const int c = col0 + 8 * kGNT * wn + 8 * j + 2 * (lane & 3);
        if (r < R && c < N) {  // N even: c + 1 < N too
          const bf lo = from_f<bf>(epi_value<KIND>(epi, acc[i][j][2 * hh], r,
                                                   c));
          const bf hi = from_f<bf>(epi_value<KIND>(epi, acc[i][j][2 * hh + 1],
                                                   r, c + 1));
          *reinterpret_cast<unsigned*>(epi.out + size_t(r) * epi.ldo + c) =
              unsigned(__bfloat16_as_ushort(lo))
              | unsigned(__bfloat16_as_ushort(hi)) << 16;
        }
      }
}

// Y = A W^T on the CUDA cores in f32, then the epilogue: A (R, K) and W (N,
// K) of T, row strides lda and ldw, K, lda, ldw multiples of 16 bytes /
// sizeof(T), arrays 16-byte aligned. Block (blockIdx.x, blockIdx.y) owns
// the 16 RT x 16 CT tile of rows 16 RT blockIdx.y and columns 16 CT
// blockIdx.x; thread (ty, tx) of the 16 x 16 grid its rows ty + 16 i
// (i < RT) and columns tx + 16 j (j < CT). Slab s (kCSlabBytes of k per
// row of both operands, rows padded to kCLdBytes so the 16 W rows a
// quarter-warp reads fall in distinct banks) goes to stage s % S (S =
// kCStages) by 16-byte cp.async, S - 1 slabs ahead, one barrier per
// slab. Each sum runs over k in order; bf16 values are widened exactly,
// so products are exact either way. Rows past R (columns past N) read row
// R - 1 (N - 1) and are not stored.
template <typename T, int RT, int CT, int KIND>
__device__ __forceinline__ void cc_gemm_body(const T* __restrict__ A,
                                             int lda,
                                             const T* __restrict__ W,
                                             int ldw, int R, int N, int K,
                                             const Epi<T>& epi,
                                             unsigned char* smem) {
  constexpr int V = 16 / sizeof(T);                 // values per pack
  constexpr int SK = kCSlabBytes / sizeof(T);       // slab depth
  constexpr int LD = kCLdBytes / sizeof(T);         // padded row
  constexpr int BR = 16 * RT, BN = 16 * CT, S = kCStages;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int row0 = blockIdx.y * BR, col0 = blockIdx.x * BN;
  T* ring = reinterpret_cast<T*>(smem);  // [S][BR + BN][LD]
  constexpr int kStage = (BR + BN) * LD;
  const int nk = cdiv(K, SK);
  const SlabCopy<T, BR, BN, kCSlabBytes / 16, LD> copy(A, lda, row0, R, W,
                                                       ldw, col0, N);
  auto issue = [&](int s) {
    copy.issue(ring + (s % S) * kStage, s * SK,
               K - s * SK < SK ? K - s * SK : SK);
  };

  float acc[RT][CT];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < CT; ++j) acc[i][j] = 0.f;
  for (int s = 0; s < S - 1; ++s) issue(s);
  for (int s = 0; s < nk; ++s) {
    cp_async_wait<S - 2>();
    __syncthreads();  // slab s landed for all; slab s - 1 consumed
    issue(s + S - 1);
    const T* a = ring + (s % S) * kStage + ty * LD;
    const T* b = ring + (s % S) * kStage + (BR + tx) * LD;
    const int kb = K - s * SK < SK ? K - s * SK : SK;
    for (int kk = 0; kk < kb; kk += V) {
      float av[RT][V], bv[CT][V];
#pragma unroll
      for (int i = 0; i < RT; ++i) load_pack<T>(a + 16 * i * LD + kk, av[i]);
#pragma unroll
      for (int j = 0; j < CT; ++j) load_pack<T>(b + 16 * j * LD + kk, bv[j]);
#pragma unroll
      for (int e = 0; e < V; ++e)
#pragma unroll
        for (int i = 0; i < RT; ++i)
#pragma unroll
          for (int j = 0; j < CT; ++j)
            acc[i][j] = fmaf(av[i][e], bv[j][e], acc[i][j]);
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < CT; ++j) {
      const int r = row0 + ty + 16 * i, c = col0 + tx + 16 * j;
      if (r < R && c < N)
        epi.out[size_t(r) * epi.ldo + c] =
            from_f<T>(epi_value<KIND>(epi, acc[i][j], r, c));
    }
}

// The attention core of fused_ln_attn, row tile blockIdx.x (block_rows(L,
// BM) rows of whole tracks, BM = attn_tile_rows(L)) and head h =
// blockIdx.y: the head's q|k|v from qkv_all (R, 3C), softmax(q k^T /
// sqrt(D)) v within each track (head_attention; with 16-byte loads where D
// % 8 == 0), into os (R, C) at columns
// hD .. (h + 1) D, rounded to T.
template <typename T, int BM>
__device__ __forceinline__ void attn_core_body(const T* __restrict__ qkv_all,
                                               T* __restrict__ os, int R,
                                               int C, int L, int H,
                                               unsigned char* smem) {
  const int tid = threadIdx.x, D = C / H, h = blockIdx.y;
  const int BR = block_rows(L, BM);
  const int row0 = blockIdx.x * BR;
  const int rows = R - row0 < BR ? R - row0 : BR;
  T* qkv = reinterpret_cast<T*>(smem);  // [BM][3D]
  float* sc = reinterpret_cast<float*>(smem
                                       + align_up(size_t(BM) * 3 * D
                                                  * sizeof(T)));  // [BM][L]
  T* o = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(sc)
                              + align_up(size_t(BM) * L * 4));  // [BM][D]
  for (int idx = tid; idx < rows * 3 * D; idx += kThreads) {
    const int r = idx / (3 * D), n = idx - r * 3 * D, part = n / D;
    qkv[idx] = qkv_all[size_t(row0 + r) * 3 * C + part * C + h * D + n
                       - part * D];
  }
  __syncthreads();
  if (D % 8 == 0)  // 16-byte aligned rows of q|k|v and o
    ring_head_attention<T, BM>(qkv, sc, o, D, rows, L, D,
                               1.0f / sqrtf(float(D)));
  else
    head_attention<T, BM>(qkv, sc, o, D, rows, L, D, 1.0f / sqrtf(float(D)));
  __syncthreads();
  for (int idx = tid; idx < rows * D; idx += kThreads) {
    const int r = idx / D, e = idx - r * D;
    os[size_t(row0 + r) * C + h * D + e] = o[idx];
  }
}

}  // namespace vf
