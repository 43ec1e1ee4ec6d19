// Device code of the correlation-sampling kernel: per track and pyramid
// level, the dots of the track's feature with the (2r+2)^2 integer-grid
// cells around it, combined bilinearly into the (2r+1)^2 taps and scaled by
// 1/sqrt(C).
//
// Replaces vggsfm_tpu/ops/corr_pallas.py:
//   corr_sample_pallas (_corr_kernel)               -> corr_body<float>,
//   corr_sample_pallas_smallc (_corr_smallc_kernel) -> corr_body<float> or
//                                                      corr_body<bf16>
// (the small-C contract keeps the map's dtype; both accumulate in f32).
//
// What bounds it on an H100: one track reads (2r+2)^2 * C map values once
// and does two operations on each, so it sits far below the card's ridge
// and is bound by bytes; the maps of a few-track call (at most 63 tracks
// per frame) fit the L2, and at those sizes the launch itself is most of
// the time. The design therefore only has to keep the loads wide and
// coalesced and every intermediate on-chip:
//   * one block of 256 threads per (frame, track); the track's feature is
//     widened to f32 into shared memory once;
//   * a cell's C values are contiguous (NHWC), and the cells of one window
//     row are contiguous too: groups of G lanes (G a power of two with
//     G * 16 bytes covering the cell, at most 32) each take one cell, every
//     lane loading 16 bytes at a time, so a warp reads 512 contiguous bytes;
//   * zero padding is a bounds check per cell (no padded copy of the map,
//     no clipping of the window: a cell outside the map contributes 0);
//   * the G partial sums of a cell meet in shared memory, then one thread
//     per tap combines its four neighbours with the sub-cell weights and
//     writes the scaled result: the (2r+2)^2 dots never leave the block.
// Products are exact in f32 (bf16 operands are widened on load) and every
// sum is f32.
//
// The code uses only threadIdx/blockIdx, __syncthreads, shared and global
// memory (no warp shuffles), so host_emu.h can run it on the CPU.
#pragma once

#ifdef __CUDACC__
#include <cuda_bf16.h>
#endif

#include <cstddef>
#include <cstdint>

namespace vcorr {

constexpr int kThreads = 256;
constexpr int kMaxLanes = 32;    // lanes sharing one cell's dot
constexpr int kMaxRadius = 7;    // (2r+2)^2 <= 256 cells
constexpr int kMaxC = 2048;      // feature + partials stay under 48 KB
constexpr int kMaxSide = 1 << 20;

// 16 bytes of the map, loaded at once
template <typename T>
struct alignas(16) Pack {
  T v[16 / sizeof(T)];
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Lanes per cell: the smallest power of two whose `vec`-wide loads cover C
// in one step, at most kMaxLanes.
__host__ __device__ inline int lanes_per_cell(int C, int vec) {
  int g = 1;
  while (g < kMaxLanes && g * vec < C) g *= 2;
  return g;
}

// Shared memory of one block: the f32 feature, the per-lane partial sums
// (row stride G + 1: conflict-free) and the dots.
inline size_t smem_bytes(int C, int radius, int vec) {
  const int P = (2 * radius + 2) * (2 * radius + 2);
  const int G = lanes_per_cell(C, vec);
  return size_t(C + P * (G + 1) + P) * 4;
}

// 0 when the kernel takes these shapes, else a negative code naming the
// first violated limit.
inline int check_shape(int S, int N, int H, int W, int C, int radius) {
  if (S < 1 || N < 1) return -1;
  if (C < 1 || C > kMaxC) return -2;
  if (radius < 1 || radius > kMaxRadius) return -3;
  if (H < 1 || W < 1 || H > kMaxSide || W > kMaxSide) return -4;
  if (int64_t(S) * N > 0x7fffffff) return -5;
  return 0;
}

// fmap (S, H, W, C), coords (S, N, 2) xy in cells, feats (S, N, C) ->
// out (S, N, (2r+1)^2) f32. Block b is track b = s * N + n. VEC: the map
// is read in 16-byte packs (C a multiple of the pack, the base aligned),
// else element by element.
template <typename T, bool VEC>
__device__ void corr_body(const T* fmap, const float* coords, const T* feats,
                          float* out, int N, int H, int W, int C, int radius,
                          unsigned char* smem_raw) {
  constexpr int kVec = VEC ? int(16 / sizeof(T)) : 1;
  const int tid = int(threadIdx.x);
  const int track = int(blockIdx.x);
  const int s = track / N;
  const int w = 2 * radius + 2;
  const int P = w * w;
  const int W1 = w - 1;
  const int G = lanes_per_cell(C, kVec);

  float* feat = reinterpret_cast<float*>(smem_raw);
  float* part = feat + C;
  float* dots = part + P * (G + 1);

  const T* f = feats + size_t(track) * C;
  for (int c = tid; c < C; c += kThreads) feat[c] = widen(f[c]);

  // floor of the position and the sub-cell offset, both f32; a position
  // far outside (or not finite) is clamped before the int conversion:
  // every cell of its window is outside the map either way
  const float cx = coords[2 * size_t(track)];
  const float cy = coords[2 * size_t(track) + 1];
  const float bx = floorf(cx);
  const float by = floorf(cy);
  const float lim = float(2 * kMaxSide);
  const int x0 = int(fminf(fmaxf(bx, -lim), lim)) - radius;
  const int y0 = int(fminf(fmaxf(by, -lim), lim)) - radius;
  __syncthreads();

  const int lane = tid % G;
  const int group = tid / G;
  const int groups = kThreads / G;
  const T* map = fmap + size_t(s) * H * W * C;
  for (int cell = group; cell < P; cell += groups) {
    const int iy = y0 + cell / w;
    const int ix = x0 + cell % w;
    float acc = 0.0f;
    if (iy >= 0 && iy < H && ix >= 0 && ix < W) {
      const T* p = map + (size_t(iy) * W + ix) * C;
      for (int c = lane * kVec; c < C; c += G * kVec) {
        if constexpr (VEC) {
          const Pack<T> m = *reinterpret_cast<const Pack<T>*>(p + c);
#pragma unroll
          for (int k = 0; k < kVec; k += 4) {
            const Pack<float> q =
                *reinterpret_cast<const Pack<float>*>(feat + c + k);
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc = fmaf(widen(m.v[k + j]), q.v[j], acc);
          }
        } else {
          acc = fmaf(widen(p[c]), feat[c], acc);
        }
      }
    }
    part[cell * (G + 1) + lane] = acc;
  }
  __syncthreads();

  for (int cell = tid; cell < P; cell += kThreads) {
    float sum = 0.0f;
    for (int g = 0; g < G; ++g) sum += part[cell * (G + 1) + g];
    dots[cell] = sum;
  }
  __syncthreads();

  const float fx = cx - bx;
  const float fy = cy - by;
  const float scale = 1.0f / sqrtf(float(C));
  float* o = out + size_t(track) * W1 * W1;
  for (int t = tid; t < W1 * W1; t += kThreads) {
    const int a = t / W1;
    const int b = t % W1;
    const float* d = dots + a * w + b;
    const float v = (1.0f - fy) * (1.0f - fx) * d[0]
                    + (1.0f - fy) * fx * d[1]
                    + fy * (1.0f - fx) * d[w]
                    + fy * fx * d[w + 1];
    o[t] = v * scale;
  }
}

}  // namespace vcorr
