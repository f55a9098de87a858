// FAST-N segment test + SAD score + 3x3 non-max suppression, fused, over
// every level of an image pyramid in one launch.
//
// Replaces the Pallas TPU kernel fast_score_map_pallas / _fast_nms_kernel
// (trackingbench_slam_tpu/ops/pallas/fast_kernel.py:126), which the reference
// calls once per level. Semantics are those of ops/fast.py fast_score_map +
// nms3x3, which the Pallas kernel reproduces exactly:
//   * 16 taps on the radius-3 Bresenham circle; a pixel is a corner when a
//     circular run of >= arc taps is all brighter (diff > th) or all darker
//     (diff < -th);
//   * score = max(sum max(diff - th, 0), sum max(-diff - th, 0)) over the 16
//     taps, summed in tap order; pixels within 3 px of the border score 0;
//   * NMS: a neighbour earlier in raster order suppresses when >=, a later
//     one when >; the output keeps scores > 0 that survive.
//
// What bounds it on this card: each pixel is read once and written once
// (8 bytes a pixel, ~3.6 MB at 1226x370) against ~260 operations a pixel,
// so the function is bound by operations at a couple of microseconds a
// level. What costs time around that is launch latency and redundant work
// at the tile edges: 32x8 tiles score a 34x10 ring and stage 40x16 pixels
// for 256 outputs, a dependent run counter takes 24 steps a score, and a
// launch per level pays its latency on images as small as 237x785. Here:
//   * 32x32 output tiles, 256 threads: the tile scores its 34x34 ring
//     (1.13 scores an output) from a 40x40 staged block (1.56 pixels an
//     output); each thread then suppresses a 4-row column strip;
//   * the arc test runs on 16-bit brighter / darker masks built from the 16
//     compares: a log-step shift-and-and finds a circular run of >= arc,
//     and the whole score is branch-free (border and non-corners masked at
//     the end), so the scheduler overlaps the scores' shared loads;
//   * the SAD sums are added in tap order, as the plain version adds them,
//     so the output is exact;
//   * one launch covers every level: the grid is the levels' tiles laid end
//     to end, and each block finds its level in a small table (image, output,
//     shape, tiles a row, first block) built by the wrapper.

#include <cuda_runtime.h>

#define TILE 32
#define HALO 4                      // 3 for the circle, 1 for NMS
#define SR (TILE + 2)               // scored rows / columns
#define IR (TILE + 2 * HALO)        // staged rows / columns
#define THREADS 256
#define STRIP (TILE * TILE / THREADS)  // output rows a thread suppresses
#define FAST_MAX_LEVELS 8

struct FastLevel {
  const float* img;
  float* out;
  int h, w, tiles_x, first;
};

struct FastArgs {
  FastLevel lv[FAST_MAX_LEVELS];
  int levels;
  float th;
  int arc;
};

// A circular run of >= arc set bits in the 16-bit mask m, branch-free:
// lg = floor(log2(arc)), rest = arc - 2^lg. Doubling the mask to 32 bits
// makes the run circular; r_k has bit i set iff bits i..i+k-1 are set.
__device__ __forceinline__ bool has_arc(unsigned m, int lg, int rest) {
  const unsigned r1 = m | (m << 16);
  const unsigned r2 = r1 & (r1 >> 1);
  const unsigned r4 = r2 & (r2 >> 2);
  const unsigned r8 = r4 & (r4 >> 4);
  const unsigned r16 = r8 & (r8 >> 8);
  const unsigned y = lg == 0 ? r1 : lg == 1 ? r2 : lg == 2 ? r4
                   : lg == 3 ? r8 : r16;
  return (y & (y >> rest)) != 0u;
}

__global__ void __launch_bounds__(THREADS) fast_nms_kernel(const FastArgs a) {
  __shared__ float tile[IR * IR];
  __shared__ float score[SR * SR];
  FastLevel L = a.lv[0];
#pragma unroll
  for (int l = 1; l < FAST_MAX_LEVELS; ++l)
    if (l < a.levels && (int)blockIdx.x >= a.lv[l].first) L = a.lv[l];
  const int t = (int)blockIdx.x - L.first;
  const int y0 = (t / L.tiles_x) * TILE, x0 = (t % L.tiles_x) * TILE;
  const int tid = threadIdx.x;

#pragma unroll
  for (int p = tid; p < IR * IR; p += THREADS) {
    const int gy = y0 - HALO + p / IR, gx = x0 - HALO + p % IR;
    tile[p] = (gy >= 0 && gy < L.h && gx >= 0 && gx < L.w)
                  ? __ldg(L.img + gy * L.w + gx)
                  : 0.0f;
  }
  __syncthreads();

  const float th = a.th;
  const int lg = 31 - __clz(a.arc), rest = a.arc - (1 << lg);
  const int dy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
  const int dx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
#pragma unroll
  for (int p = tid; p < SR * SR; p += THREADS) {
    const int sr = p / SR, sc = p % SR;
    const int gy = y0 - 1 + sr, gx = x0 - 1 + sc;
    // branch-free: every ring pixel's circle lies inside the staged tile;
    // the border and the non-corners are masked at the end
    const float* c = tile + (sr + HALO - 1) * IR + (sc + HALO - 1);
    const float center = c[0];
    unsigned mb = 0u, md = 0u;
    float sb = 0.0f, sd = 0.0f;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const float diff = c[dy[k] * IR + dx[k]] - center;
      mb |= (unsigned)(diff > th) << k;
      md |= (unsigned)(diff < -th) << k;
      sb = sb + fmaxf(diff - th, 0.0f);
      sd = sd + fmaxf(-diff - th, 0.0f);
    }
    const bool keep = (gy >= 3) & (gy < L.h - 3) & (gx >= 3) &
                      (gx < L.w - 3) &
                      (has_arc(mb, lg, rest) | has_arc(md, lg, rest));
    const float s = keep ? fmaxf(sb, sd) : 0.0f;
    score[p] = s;
  }
  __syncthreads();

  const int cx = tid % TILE, r0 = (tid / TILE) * STRIP;
  const int gx = x0 + cx;
  if (gx >= L.w) return;
#pragma unroll
  for (int j = 0; j < STRIP; ++j) {
    const int gy = y0 + r0 + j;
    if (gy >= L.h) break;
    const float* m = score + (r0 + j + 1) * SR + (cx + 1);
    const float mid = m[0];
    const bool suppressed = m[-SR - 1] >= mid || m[-SR] >= mid ||
                            m[-SR + 1] >= mid || m[-1] >= mid ||
                            m[1] > mid || m[SR - 1] > mid || m[SR] > mid ||
                            m[SR + 1] > mid;
    L.out[gy * L.w + gx] = (mid > 0.0f && !suppressed) ? mid : 0.0f;
  }
}

// imgs/outs: `levels` pointers; table: per level (h, w, tiles_x, first
// block); blocks: the total tile count.
extern "C" int fast_score_nms(const void* const* imgs, void* const* outs,
                              const int* table, int levels, int blocks,
                              float threshold, int arc, void* stream) {
  if (blocks <= 0) return 0;
  if (arc < 1 || arc > 16 || levels < 1 || levels > FAST_MAX_LEVELS)
    return (int)cudaErrorInvalidValue;
  FastArgs a;
  for (int l = 0; l < FAST_MAX_LEVELS; ++l) {
    const int k = l < levels ? l : 0;
    const int* e = table + 4 * k;
    a.lv[l] = FastLevel{(const float*)imgs[k], (float*)outs[k], e[0], e[1],
                        e[2], e[3]};
  }
  a.levels = levels;
  a.th = threshold;
  a.arc = arc;
  fast_nms_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
