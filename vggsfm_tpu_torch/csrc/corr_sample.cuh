// Device code of the correlation-sampling kernel: per track and pyramid
// level, the dots of the track's feature with the (2r+2)^2 integer-grid
// cells around floor(position / 2^level), combined bilinearly into the
// (2r+1)^2 taps and scaled by 1/sqrt(C). One launch covers every level of
// a call.
//
// Replaces vggsfm_tpu/ops/corr_pallas.py:
//   corr_sample_pallas (:85, _corr_kernel) and
//   corr_sample_pallas_smallc (:255, _corr_smallc_kernel),
// and the routes the JAX tracker sends to XLA on a TPU (the full-map GEMM
// plus one-hot window matmuls for N >= 64 tracks, the flat channel-first
// fine path): on this card one kernel serves every route.
//
// What bounds it on an H100, at the tracker's two main-path calls:
//   * the coarse call (8 frames x 4096 tracks, 5 levels of 128^2..8^2
//     cells, C = 128, r = 4, bf16 maps): 3.4 GFLOP of f32 FMAs against
//     80 MB of distinct map cells, so f32 FMAs at 67 TFLOP/s bound it
//     (0.051 ms; bytes alone 0.024 ms). Read window by window the call
//     moves 3.3 GB: neighbouring tracks share most of their cells, which
//     the warps re-read from L1/L2; on the H100 the call reads its windows
//     at about L2's rate, and staging shared tiles of the map is the next
//     step (ROADMAP.md);
//   * the fine call (32,768 track-frames, each its own 31^2, 15^2 and 7^2
//     patch, C = 32, r = 3, channel-first): 0.40 GFLOP against 372 MB of
//     window cells, so bytes bound it (0.111 ms). Every track-frame has
//     its own map, so what matters is to read the window's cells and no
//     other.
// No tensor cores: each track's dots are the product of one vector with
// its own window, about one operation per byte moved; an mma would use
// one column of its tile.
//
// Design:
//   * one warp per (track, level): no block-wide barrier anywhere; the
//     warps of a block are consecutive tracks of one frame, at one level;
//   * the level table (pointer, H, W and strides of each level) goes by
//     value; positions come at level-0 scale and are divided by 2^level
//     (exact); each track writes its taps to its own slot of the final
//     (F, N, L (2r+1)^2) output in f32 or bf16 (one rounding);
//   * maps are read in their own dtype (f32 or bf16, any 1 <= C <= 2048);
//     products are exact in f32 (bf16 widened on load), every sum f32;
//   * two layouts, chosen by the strides: channel stride 1 (NHWC) and
//     column stride 1 (channel-first, the flat fine pyramid);
//   * NHWC: G lanes share a cell (G a power of two, G * V values covering
//     C), V values per 16-byte load where the alignment allows it and C
//     fits one load per lane (element loads otherwise). A lane
//     keeps its slice of the feature in registers, issues the loads of
//     kCells cells before their FMAs, and the G partial sums of the
//     kCells cells meet in a butterfly of warp shuffles: about one shuffle
//     per cell where a plain reduction takes log2(G);
//   * channel-first: a lane per cell (a window row's cells are contiguous
//     but start anywhere: no alignment is assumed), the feature in the
//     warp's shared memory read by broadcast; a lane issues kFlatCells x
//     kFlatChannels loads before their FMAs;
//   * an NHWC lane walks its cells by additions (no division per cell);
//     item indices stay 32-bit: a 64-bit division is a subroutine call,
//     whose stack frame showed up as spills;
//   * the warp's dots go through its own shared memory (a __syncwarp, not
//     a barrier) to the bilinear combine;
//   * cells outside the map read as 0 wherever the window lies.
//
// The code uses threadIdx/blockIdx, shared and global memory, __syncwarp
// and __shfl_xor_sync with all 32 lanes converged, so host_emu.h runs it
// on the CPU.
#pragma once

#ifdef __CUDACC__
#include <cuda_bf16.h>
#endif

#include <cmath>
#include <cstddef>
#include <cstdint>

namespace vcorr {

constexpr int kMaxLevels = 8;
constexpr int kMaxRadius = 7;    // (2r+2)^2 <= 256 cells
constexpr int kMaxC = 2048;
constexpr int kMaxSide = 1 << 20;
constexpr int kWarpsPerBlock = 4;
constexpr int kCells = 4;        // NHWC: cells a lane loads before its FMAs
constexpr int kFlatCells = 1;     // channel-first: cells per lane and pass
constexpr int kFlatChannels = 16; // channel-first: channels loaded at once
constexpr unsigned kFull = 0xffffffffu;

// One pyramid level: element (f, y, x, c) at
// ptr + f sF + y sY + x sX + c sC (in elements).
struct Level {
  const void* ptr;
  long long sF, sY, sX, sC;
  int H, W;
};

struct Args {
  Level lv[kMaxLevels];
  const float* coords;  // (F, N, 2) xy at level-0 scale, contiguous
  const void* feats;    // (F, N, C) in the maps' dtype, channel stride 1
  long long sfF, sfN;   // its frame and track strides
  void* out;            // (F, N, L (2r+1)^2), contiguous
  int L, F, N, C, radius, out_bf16;
  int wpb;      // warps per block
  float scale;  // 1/sqrt(C), from the host: no IEEE division or square
                // root (and their slow-path calls) in the kernel
};

enum Variant { kFlat = 0, kVecOne, kScalarOne, kScalarMulti };

// V map values loaded at once, as raw bits (V * sizeof(T) bytes)
template <typename T, int V>
struct Raw;

template <int V>
struct alignas(4 * V) Raw<float, V> {
  unsigned w[V];
  __device__ __forceinline__ float get(int i) const {
    return __uint_as_float(w[i]);
  }
};

template <>
struct alignas(16) Raw<__nv_bfloat16, 8> {
  unsigned w[4];
  // element 2k is the low half of word k
  __device__ __forceinline__ float get(int i) const {
    return __uint_as_float(i & 1 ? w[i >> 1] & 0xffff0000u : w[i >> 1] << 16);
  }
};

template <>
struct Raw<__nv_bfloat16, 1> {
  unsigned short w[1];
  __device__ __forceinline__ float get(int) const {
    return __uint_as_float(unsigned(w[0]) << 16);
  }
};

template <typename T, int V>
__device__ __forceinline__ Raw<T, V> load(const T* p) {
  return *reinterpret_cast<const Raw<T, V>*>(p);
}

template <typename T>
__device__ __forceinline__ float load1(const T* p) {
  return load<T, 1>(p).get(0);
}

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// Lanes per NHWC cell: the smallest power of two whose `vec`-wide loads
// cover C in one step, at most 32.
__host__ __device__ inline int lanes_per_cell(int C, int vec) {
  int g = 1;
  while (g < 32 && g * vec < C) g *= 2;
  return g;
}

// A warp's shared floats: the dots of its window, and on the channel-first
// path the f32 feature padded to whole channel groups (both multiples of 4).
__host__ __device__ inline int warp_floats(int C, int radius, bool flat) {
  const int P = (2 * radius + 2) * (2 * radius + 2);
  const int dots = cdiv(P, 4) * 4;
  return flat ? dots + cdiv(C, kFlatChannels) * kFlatChannels : dots;
}

inline int warps_per_block(int C, int radius, bool flat) {
  const int per = warp_floats(C, radius, flat) * 4;
  int wpb = kWarpsPerBlock;
  while (wpb > 1 && size_t(wpb) * per > 48 * 1024) wpb /= 2;
  return wpb;
}

// The launch: one warp per item, blocks of a.wpb warps (set here); returns
// the block count and the dynamic shared memory per block.
inline unsigned geometry(Args& a, bool flat, size_t* smem) {
  a.wpb = warps_per_block(a.C, a.radius, flat);
  const long long items = (long long)a.L * a.F * a.N;
  *smem = size_t(a.wpb) * warp_floats(a.C, a.radius, flat) * sizeof(float);
  return unsigned((items + a.wpb - 1) / a.wpb);
}

// 0 when the kernel takes these shapes, else a negative code naming the
// first violated limit.
inline int check_shape(int L, int F, int N, int C, int radius,
                       const int* hw) {
  if (F < 1 || N < 1) return -1;
  if (C < 1 || C > kMaxC) return -2;
  if (radius < 1 || radius > kMaxRadius) return -3;
  if (L < 1 || L > kMaxLevels) return -7;
  for (int i = 0; i < L; ++i) {
    const int H = hw[2 * i], W = hw[2 * i + 1];
    if (H < 1 || W < 1 || H > kMaxSide || W > kMaxSide) return -4;
  }
  if (int64_t(L) * F * N > 0x7fffffffLL - kWarpsPerBlock) return -5;
  return 0;
}

// The level table and the variant the launch takes: NHWC when every
// level's channel stride is 1, else channel-first when every column
// stride is 1 (-6 otherwise); on NHWC 16-byte loads when C is a multiple
// of a pack and every level's base and cell, row and frame strides are
// 16-byte aligned. tsize: bytes per map value.
inline int plan(Args& a, const long long* ptrs, const int* hw,
                const long long* strides, int tsize, Variant* variant) {
  bool nhwc = true, flat = true, aligned = true;
  const int vec = 16 / tsize;
  for (int i = 0; i < a.L; ++i) {
    Level& l = a.lv[i];
    l.ptr = reinterpret_cast<const void*>(ptrs[i]);
    l.H = hw[2 * i];
    l.W = hw[2 * i + 1];
    l.sF = strides[4 * i];
    l.sY = strides[4 * i + 1];
    l.sX = strides[4 * i + 2];
    l.sC = strides[4 * i + 3];
    nhwc = nhwc && (l.sC == 1 || a.C == 1);
    flat = flat && (l.sX == 1 || l.W == 1);
    aligned = aligned && ptrs[i] % 16 == 0 && (l.sF * tsize) % 16 == 0
              && (l.sY * tsize) % 16 == 0 && (l.sX * tsize) % 16 == 0;
  }
  if (nhwc) {
    for (int i = 0; i < a.L; ++i) a.lv[i].sC = 1;
    // maps wider than one 16-byte chunk per lane (C > 128 f32, > 256
    // bf16) take element loads: no map of the tracker is that wide, and
    // ptxas spilled a 16-byte multi-chunk instantiation
    const bool vec_ok = aligned && a.C % vec == 0 && a.C <= 32 * vec;
    const int v = vec_ok ? vec : 1;
    *variant = vec_ok ? kVecOne
                      : (a.C <= lanes_per_cell(a.C, v) * v ? kScalarOne
                                                           : kScalarMulti);
    return 0;
  }
  if (!flat) return -6;
  for (int i = 0; i < a.L; ++i) a.lv[i].sX = 1;
  *variant = kFlat;
  return 0;
}

// The arguments of one call, checked (check_shape, the dtype code: 0 =
// float32, 1 = bfloat16) and planned; 0 or the first negative code.
inline int make_args(Args& a, Variant* v, int dtype, int out_bf16, int L,
                     const long long* ptrs, const int* hw,
                     const long long* strides, const void* coords,
                     const void* feats, long long sfF, long long sfN,
                     void* out, int F, int N, int C, int radius) {
  const int bad = check_shape(L, F, N, C, radius, hw);
  if (bad) return bad;
  if (dtype != 0 && dtype != 1) return -100;
  a = Args{};
  a.coords = static_cast<const float*>(coords);
  a.feats = feats;
  a.sfF = sfF;
  a.sfN = sfN;
  a.out = out;
  a.L = L;
  a.F = F;
  a.N = N;
  a.C = C;
  a.radius = radius;
  a.out_bf16 = out_bf16 != 0;
  a.scale = 1.0f / sqrtf(float(C));
  return plan(a, ptrs, hw, strides, dtype == 0 ? 4 : 2, v);
}

struct Window {
  int x0, y0;  // top-left cell
  float fx, fy;
};

// floor of the position at this level and the sub-cell offset, both f32;
// a position far outside (or not finite) is clamped before the int
// conversion: every cell of its window is outside the map either way
__device__ __forceinline__ Window window_at(const float* xy, int level,
                                            int radius) {
  const float s = __uint_as_float(unsigned(127 - level) << 23);  // 2^-level
  const float cx = xy[0] * s;
  const float cy = xy[1] * s;
  const float bx = floorf(cx);
  const float by = floorf(cy);
  const float lim = float(2 * kMaxSide);
  Window w;
  w.x0 = int(fminf(fmaxf(bx, -lim), lim)) - radius;
  w.y0 = int(fminf(fmaxf(by, -lim), lim)) - radius;
  w.fx = cx - bx;
  w.fy = cy - by;
  return w;
}

// A lane's walk over the window's cells c, c + step, c + 2 step, ...: the
// cell's window row and column and its map offset, advanced by additions
// (no division per cell), and whether it lies in the map.
struct CellWalk {
  int ay, ax;      // window row, column
  int y0, x0, w;   // the window's top-left cell and side
  long long off;   // (y0 + ay) sY + (x0 + ax) sX
  int step;
  long long dx, wrap;  // step sX; sY - w sX

  __device__ __forceinline__ CellWalk(const Level& lv, const Window& win,
                                      int w_, int first, int step_)
      : ay(first / w_), ax(first % w_), y0(win.y0), x0(win.x0), w(w_),
        step(step_) {
    off = (long long)(y0 + ay) * lv.sY + (long long)(x0 + ax) * lv.sX;
    dx = step * lv.sX;
    wrap = lv.sY - w * lv.sX;
  }
  __device__ __forceinline__ bool inside(const Level& lv) const {
    return unsigned(y0 + ay) < unsigned(lv.H)
           && unsigned(x0 + ax) < unsigned(lv.W);
  }
  __device__ __forceinline__ void next() {
    ax += step;
    off += dx;
    while (ax >= w) {
      ax -= w;
      ++ay;
      off += wrap;
    }
  }
};

// The G partial sums of each of a lane's CNT cells, summed over the lane
// group: a butterfly while a lane holds more than one cell (the lane with
// bit o set keeps the upper half of its cells and sends the lower half);
// acc[0] then holds the group sum of cell ub (counted from its first).
template <int CNT>
__device__ __forceinline__ void butterfly(float* acc, int q, int o, int& ub) {
  const bool up = (q & o) != 0;
  ub += up ? CNT / 2 : 0;
#pragma unroll
  for (int k = 0; k < CNT / 2; ++k) {
    const float send = up ? acc[k] : acc[k + CNT / 2];
    const float keep = up ? acc[k + CNT / 2] : acc[k];
    acc[k] = keep + __shfl_xor_sync(kFull, send, o);
  }
  if constexpr (CNT > 2) butterfly<CNT / 2>(acc, q, o >> 1, ub);
}

// NHWC: the (2r+2)^2 dots of one window into `dots`.
template <typename T, int V, bool ONE>
__device__ __forceinline__ void nhwc_dots(const Level& lv, const T* map,
                                          const T* feat, const Window& win,
                                          int C, int radius, float* dots,
                                          int lane) {
  constexpr int U = kCells;
  const int G = lanes_per_cell(C, V);
  const int CPW = 32 / G;  // cells per warp and load
  const int j = lane / G;
  const int q = lane % G;
  const int w = 2 * radius + 2;
  const int P = w * w;
  const int KV = ONE ? 1 : cdiv(C, G * V);

  float fr[V];
  if constexpr (ONE) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int c = q * V + i;
      fr[i] = c < C ? load1(feat + c) : 0.0f;
    }
  }
  CellWalk walk(lv, win, w, j, CPW);
  for (int cb = 0; cb < P; cb += CPW * U) {
    long long off[U];
    bool in[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      in[u] = cb + u * CPW + j < P && walk.inside(lv);
      off[u] = walk.off;
      walk.next();
    }
    float acc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) acc[u] = 0.0f;
#pragma unroll 1
    for (int kk = 0; kk < KV; ++kk) {
      const int c0 = q * V + kk * G * V;
      Raw<T, V> m[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        m[u] = in[u] && c0 < C ? load<T, V>(map + off[u] + c0) : Raw<T, V>{};
      if constexpr (!ONE) {
#pragma unroll
        for (int i = 0; i < V; ++i)
          fr[i] = c0 + i < C ? load1(feat + c0 + i) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int i = 0; i < V; ++i) acc[u] = fmaf(m[u].get(i), fr[i], acc[u]);
    }
    if (G >= U) {
      int ub = 0;
      butterfly<U>(acc, q, G >> 1, ub);
      for (int o = G / (2 * U); o >= 1; o >>= 1)
        acc[0] += __shfl_xor_sync(kFull, acc[0], o);
      const int cell = cb + ub * CPW + j;
      if ((q & (G / U - 1)) == 0 && cell < P) dots[cell] = acc[0];
    } else {  // a plain xor-reduction of each cell
      for (int o = G >> 1; o >= 1; o >>= 1)
#pragma unroll
        for (int u = 0; u < U; ++u)
          acc[u] += __shfl_xor_sync(kFull, acc[u], o);
      if (q == 0) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int cell = cb + u * CPW + j;
          if (cell < P) dots[cell] = acc[u];
        }
      }
    }
  }
}

// Channel-first: a lane per cell, the f32 feature in `fs` (the warp's
// shared memory, zero-padded to whole channel groups).
template <typename T>
__device__ __forceinline__ void flat_dots(const Level& lv, const T* map,
                                          const T* feat, const Window& win,
                                          int C, int radius, float* fs,
                                          float* dots, int lane) {
  constexpr int U = kFlatCells;
  constexpr int K = kFlatChannels;
  const int w = 2 * radius + 2;
  const int P = w * w;
  const int Cp = cdiv(C, K) * K;
  for (int c = lane; c < Cp; c += 32) fs[c] = c < C ? load1(feat + c) : 0.0f;
  __syncwarp();
  for (int cb = 0; cb < P; cb += 32 * U) {
    const T* src[U];
    bool in[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {  // a division per cell, not per load
      const int cell = cb + u * 32 + lane;
      const int iy = win.y0 + cell / w;
      const int ix = win.x0 + cell % w;
      in[u] = cell < P && unsigned(iy) < unsigned(lv.H)
              && unsigned(ix) < unsigned(lv.W);
      src[u] = map + (in[u] ? iy * lv.sY + ix : 0);
    }
    float acc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) acc[u] = 0.0f;
    for (int c0 = 0; c0 < C; c0 += K) {
      float m[U][K];
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int k = 0; k < K; ++k)
          m[u][k] = in[u] && c0 + k < C ? load1(src[u] + (c0 + k) * lv.sC)
                                        : 0.0f;
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int k = 0; k < K; ++k) acc[u] = fmaf(m[u][k], fs[c0 + k], acc[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int cell = cb + u * 32 + lane;
      if (cell < P) dots[cell] = acc[u];
    }
  }
}

// One (track, level) item: its dots into the warp's shared memory, then
// the bilinear combine into its slot of the output.
template <typename T, int V, bool ONE, bool FLAT>
__device__ __forceinline__ void corr_item(const Args& a, int item,
                                          float* dots, int lane) {
  const int n = item % a.N;  // 32-bit: a 64-bit division is a call
  const int f = item / a.N % a.F;
  const int level = item / a.N / a.F;
  const size_t track = size_t(f) * a.N + n;
  const Level& lv = a.lv[level];
  const int r = a.radius;
  const Window win = window_at(a.coords + 2 * track, level, r);
  const T* map = static_cast<const T*>(lv.ptr) + f * lv.sF;
  const T* feat = static_cast<const T*>(a.feats) + f * a.sfF + n * a.sfN;
  if constexpr (FLAT) {
    float* fs = dots + warp_floats(a.C, r, false);
    flat_dots<T>(lv, map, feat, win, a.C, r, fs, dots, lane);
  } else {
    nhwc_dots<T, V, ONE>(lv, map, feat, win, a.C, r, dots, lane);
  }
  __syncwarp();

  const int w = 2 * r + 2;
  const int W1 = w - 1;
  const int T1 = W1 * W1;
  const float fx = win.fx, fy = win.fy;
  const size_t o = (track * a.L + level) * T1;
  for (int t = lane; t < T1; t += 32) {
    const float* d = dots + (t / W1) * w + t % W1;
    const float v = ((1.0f - fy) * (1.0f - fx) * d[0]
                     + (1.0f - fy) * fx * d[1]
                     + fy * (1.0f - fx) * d[w]
                     + fy * fx * d[w + 1]) * a.scale;
    if (a.out_bf16)
      static_cast<__nv_bfloat16*>(a.out)[o + t] = __float2bfloat16(v);
    else
      static_cast<float*>(a.out)[o + t] = v;
  }
}

// Warp w of block b takes item b wpb + w = (level * F + f) * N + n:
// track n of frame f, at one level.
template <typename T, int V, bool ONE, bool FLAT>
__device__ __forceinline__ void corr_body(const Args& a, float* smem) {
  const int lane = int(threadIdx.x) % 32;
  const int warp = int(threadIdx.x) / 32;
  const int item = int(blockIdx.x) * a.wpb + warp;  // < 2^31 (check_shape)
  if (item >= a.L * a.F * a.N) return;  // the whole warp
  float* dots = smem + size_t(warp) * warp_floats(a.C, a.radius, FLAT);
  corr_item<T, V, ONE, FLAT>(a, item, dots, lane);
}

}  // namespace vcorr
