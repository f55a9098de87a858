// FAST-N segment test + SAD score + 3x3 non-max suppression, fused.
//
// Replaces the Pallas TPU kernel fast_score_map_pallas / _fast_nms_kernel
// (trackingbench_slam_tpu/ops/pallas/fast_kernel.py). Semantics are those of
// ops/fast.py fast_score_map + nms3x3, which the Pallas kernel reproduces
// exactly:
//   * 16 taps on the radius-3 Bresenham circle; a pixel is a corner when a
//     circular run of >= arc taps is all brighter (diff > th) or all darker
//     (diff < -th), tested over the doubled sequence of 16 + arc - 1 taps;
//   * score = max(sum max(diff - th, 0), sum max(-diff - th, 0)) over the 16
//     taps, summed in tap order; pixels within 3 px of the border score 0;
//   * NMS: a neighbour earlier in raster order suppresses when >=, a later
//     one when >; the output keeps scores > 0 that survive.
//
// Design: one thread per output pixel over a 32x8 tile. The tile's image
// block plus a 4-pixel halo (3 for the circle, 1 for NMS) is staged in shared
// memory once; scores for the tile and its 1-pixel ring are computed into
// shared memory, then each thread runs NMS from there. Bound on the card:
// each pixel is read once and written once (8 bytes/pixel, ~3.6 MB at
// 1226x370) against ~400 ops/pixel (29 tap steps of compare/select/add), so
// the kernel is bound by operations at a few microseconds either way; the
// halo re-reads (1.8x) stay in shared memory.

#include <cuda_runtime.h>

#define TW 32
#define TH 8
#define HALO 4

__constant__ int kCircle[16][2] = {
    {-3, 0}, {-3, 1}, {-2, 2}, {-1, 3}, {0, 3},  {1, 3},  {2, 2},  {3, 1},
    {3, 0},  {3, -1}, {2, -2}, {1, -3}, {0, -3}, {-1, -3}, {-2, -2}, {-3, -1}};

__global__ void __launch_bounds__(TW * TH)
fast_nms_kernel(const float* __restrict__ img, float* __restrict__ out, int h,
                int w, float th, int arc) {
  __shared__ float tile[TH + 2 * HALO][TW + 2 * HALO];
  __shared__ float score[TH + 2][TW + 2];
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const int tid = threadIdx.y * TW + threadIdx.x;
  const int nthreads = TW * TH;

  for (int p = tid; p < (TH + 2 * HALO) * (TW + 2 * HALO); p += nthreads) {
    int r = p / (TW + 2 * HALO), c = p % (TW + 2 * HALO);
    int gy = y0 - HALO + r, gx = x0 - HALO + c;
    tile[r][c] = (gy >= 0 && gy < h && gx >= 0 && gx < w) ? img[gy * w + gx]
                                                          : 0.0f;
  }
  __syncthreads();

  for (int p = tid; p < (TH + 2) * (TW + 2); p += nthreads) {
    int sr = p / (TW + 2), sc = p % (TW + 2);
    int gy = y0 - 1 + sr, gx = x0 - 1 + sc;
    float s = 0.0f;
    if (gy >= 3 && gy < h - 3 && gx >= 3 && gx < w - 3) {
      const int cr = sr + 3, cc = sc + 3;  // tile coords of the pixel
      const float center = tile[cr][cc];
      int run_b = 0, run_d = 0, best_b = 0, best_d = 0;
      float sb = 0.0f, sd = 0.0f;
      for (int k = 0; k < 16 + arc - 1; ++k) {
        const int kk = k & 15;
        const float diff = tile[cr + kCircle[kk][0]][cc + kCircle[kk][1]] - center;
        run_b = diff > th ? run_b + 1 : 0;
        run_d = diff < -th ? run_d + 1 : 0;
        best_b = max(best_b, run_b);
        best_d = max(best_d, run_d);
        if (k < 16) {
          sb = sb + fmaxf(diff - th, 0.0f);
          sd = sd + fmaxf(-diff - th, 0.0f);
        }
      }
      if (best_b >= arc || best_d >= arc) s = fmaxf(sb, sd);
    }
    score[sr][sc] = s;
  }
  __syncthreads();

  const int gx = x0 + threadIdx.x, gy = y0 + threadIdx.y;
  if (gx >= w || gy >= h) return;
  const int r = threadIdx.y + 1, c = threadIdx.x + 1;
  const float mid = score[r][c];
  bool suppressed = false;
  for (int dy = -1; dy <= 1; ++dy) {
    for (int dx = -1; dx <= 1; ++dx) {
      if (dy == 0 && dx == 0) continue;
      const float nb = score[r + dy][c + dx];
      const bool earlier = dy < 0 || (dy == 0 && dx < 0);
      suppressed = suppressed || (earlier ? nb >= mid : nb > mid);
    }
  }
  out[gy * w + gx] = (mid > 0.0f && !suppressed) ? mid : 0.0f;
}

extern "C" int fast_score_nms(const float* img, float* out, int h, int w,
                              float threshold, int arc, void* stream) {
  if (h <= 0 || w <= 0) return 0;
  if (arc < 1 || arc > 16) return (int)cudaErrorInvalidValue;
  dim3 block(TW, TH);
  dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH);
  fast_nms_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(img, out, h, w,
                                                            threshold, arc);
  return (int)cudaGetLastError();
}
