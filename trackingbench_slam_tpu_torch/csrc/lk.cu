// Inverse-compositional 3-parameter patch alignment (LK), one thread block
// per point.
//
// Replaces the Pallas TPU kernel patch_align_pallas / _lk_kernel
// (trackingbench_slam_tpu/ops/pallas/lk_kernel.py). Semantics are the Pallas
// kernel's, point for point:
//   * both images are read as if zero-padded to (hp, wp) = (round_up(max(h,
//     WIN),8), round_up(max(w,384),128)), with (h, w) the TEMPLATE image's
//     shape (the anchored caller's template is the 2048^2 atlas and its
//     search image the smaller frame); each point iterates in coordinates local
//     to a window whose base is aligned down to 8 rows / 128 columns
//     (base_of), computed separately for the template and the search start;
//   * travel bounds lo = half+1, hi_y = WIN-SLICE+half-1, hi_x = 256-half-4:
//     a point whose template or start lies outside never runs (err = 1e9,
//     xy = init); a raw step outside them fails the point (and the position
//     is clipped);
//   * the template and its central-difference gradients come from ONE
//     bilinear (P+2)^2 sample at origin (t - half - 1);
//   * H = J^T J + 1e-6 I, inverted by cofactors with |det| >= 1e-10;
//   * converged when |d|^2 < eps^2; err = mean |cur - tpl + md|;
//   * with fb_iters > 0 a back-track from the solution (template cut from
//     cur at the solution, search in prev from t) gives fb_conv, fb_d2.
// The final in-image check at level resolution is left to the wrapper.
// The TPU exits 8 points jointly; frozen points do not move, so the per-
// point exit here gives the same answer.
//
// Bound on the card: per point the work is ~iters x P^2 x ~15 flops on a
// patch that stays in L1/L2, and the bytes are the pixels under the
// templates and search patches plus 2000 points, so the kernel is
// latency-bound (block reductions each iteration), far from both roofs.
// This first version keeps the template,
// gradients and reduction partials in shared memory and reads the search
// patch through the cache; staging the search window in shared memory and
// batching several points per block is later work.

#include <cuda_runtime.h>

#define LK_MAX_HALF 15
#define LK_MAXP (2 * LK_MAX_HALF + 1)
#define LK_THREADS 128
#define LK_WARPS (LK_THREADS / 32)
#define WIN_LANES 256
#define MARGIN 12

struct Geo {
  const float* img;
  int h, w;
  int by, bx;  // window base (global)
};

__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}

__device__ __forceinline__ float read_px(const Geo& g, int gy, int gx) {
  return (gy >= 0 && gy < g.h && gx >= 0 && gx < g.w) ? g.img[gy * g.w + gx]
                                                       : 0.0f;
}

// Window base for a level position (base_of, lk_kernel.py:376-383).
__device__ void base_of(float x, float y, int half, int win_rows, int hp,
                        int wp, int* by, int* bx) {
  int ix = (int)rintf(x) - half - MARGIN;
  int iy = (int)rintf(y) - half - MARGIN;
  ix = floordiv(ix, 128) * 128;
  iy = floordiv(iy, 8) * 8;
  *bx = min(max(ix, 0), wp - WIN_LANES);
  *by = min(max(iy, 0), hp - win_rows);
}

// Sum K per-thread values over the block; every thread gets the totals,
// summed in the same order, so the scalars derived from them agree.
template <int K>
__device__ void block_sum(float (&v)[K], float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float s = v[k];
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) red[warp * K + k] = s;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float s = 0.0f;
    for (int wi = 0; wi < LK_WARPS; ++wi) s += red[wi * K + k];
    v[k] = s;
  }
  __syncthreads();
}

struct Tap {
  int iy, ix;
  float fy, fx;
};

// Bilinear grid origin for window-local (u, v): the Pallas sample_batched
// index math, including its slice clamps.
__device__ __forceinline__ Tap tap_of(float u, float v, int half, int P,
                                      int win_rows, int slice_rows) {
  Tap t;
  float vtop = v - (float)half;
  float utop = u - (float)half;
  float fiy = floorf(vtop), fix = floorf(utop);
  t.fy = vtop - fiy;
  t.fx = utop - fix;
  t.iy = min(max((int)fiy, 0), win_rows - slice_rows);
  t.ix = min(max((int)fix, 0), WIN_LANES - P - 2);
  return t;
}

__device__ __forceinline__ float bilerp(const Geo& g, const Tap& t, int r,
                                        int c) {
  int gy = g.by + t.iy + r, gx = g.bx + t.ix + c;
  float t00 = read_px(g, gy, gx), t01 = read_px(g, gy, gx + 1);
  float t10 = read_px(g, gy + 1, gx), t11 = read_px(g, gy + 1, gx + 1);
  float top = t00 + t.fx * (t01 - t00);
  float bot = t10 + t.fx * (t11 - t10);
  return top + t.fy * (bot - top);
}

struct Shared {
  float S[(LK_MAXP + 2) * (LK_MAXP + 2)];
  float tpl[LK_MAXP * LK_MAXP];
  float gx[LK_MAXP * LK_MAXP];
  float gy[LK_MAXP * LK_MAXP];
  float red[LK_WARPS * 5];
};

struct Cof {
  float c00, c01, c02, c11, c12, c22, inv_det, h02, h12, h22;
};

// Template + gradients at window-local (x, y) of g (make_template).
__device__ Cof make_template(Shared& sm, const Geo& g, float x, float y,
                             int half, int P, int win_rows, int slice_rows) {
  const int n = P + 2;
  Tap t = tap_of(x - 1.0f, y - 1.0f, half, P, win_rows, slice_rows);
  for (int p = threadIdx.x; p < n * n; p += blockDim.x)
    sm.S[p] = bilerp(g, t, p / n, p % n);
  __syncthreads();
  float acc[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  for (int p = threadIdx.x; p < P * P; p += blockDim.x) {
    int r = p / P, c = p % P;
    float tp = sm.S[(r + 1) * n + c + 1];
    float gxv = 0.5f * (sm.S[(r + 1) * n + c + 2] - sm.S[(r + 1) * n + c]);
    float gyv = 0.5f * (sm.S[(r + 2) * n + c + 1] - sm.S[r * n + c + 1]);
    sm.tpl[p] = tp;
    sm.gx[p] = gxv;
    sm.gy[p] = gyv;
    acc[0] += gxv * gxv;
    acc[1] += gxv * gyv;
    acc[2] += gxv;
    acc[3] += gyv * gyv;
    acc[4] += gyv;
  }
  block_sum<5>(acc, sm.red);
  float h00 = acc[0] + 1e-6f, h01 = acc[1], h02 = acc[2];
  float h11 = acc[3] + 1e-6f, h12 = acc[4];
  float h22 = (float)(P * P) + 1e-6f;
  Cof k;
  k.c00 = h11 * h22 - h12 * h12;
  k.c01 = h02 * h12 - h01 * h22;
  k.c02 = h01 * h12 - h02 * h11;
  k.c11 = h00 * h22 - h02 * h02;
  k.c12 = h01 * h02 - h00 * h12;
  k.c22 = h00 * h11 - h01 * h01;
  float det = h00 * k.c00 + h01 * k.c01 + h02 * k.c02;
  if (fabsf(det) < 1e-10f) det = 1e-10f;
  k.inv_det = 1.0f / det;
  k.h02 = h02;
  k.h12 = h12;
  k.h22 = h22;
  return k;
}

struct Track {
  float u, v, md;
  bool active, failed;
};

// Iterate from window-local (u0, v0) in g against the template in sm.
__device__ Track run_lk(Shared& sm, const Geo& g, const Cof& k, float u0,
                        float v0, int n_iters, float eps2, int half, int P,
                        int win_rows, int slice_rows) {
  const float lo = (float)(half + 1);
  const float hi_y = (float)(win_rows - slice_rows + half - 1);
  const float hi_x = (float)(WIN_LANES - half - 4);
  Track s{u0, v0, 0.0f, true, false};
  for (int it = 0; it < n_iters && s.active; ++it) {
    Tap t = tap_of(s.u, s.v, half, P, win_rows, slice_rows);
    float acc[3] = {0.f, 0.f, 0.f};
    for (int p = threadIdx.x; p < P * P; p += blockDim.x) {
      float r = bilerp(g, t, p / P, p % P) - sm.tpl[p];
      acc[0] += r * sm.gx[p];
      acc[1] += r * sm.gy[p];
      acc[2] += r;
    }
    block_sum<3>(acc, sm.red);
    float b0 = acc[0] + s.md * k.h02;
    float b1 = acc[1] + s.md * k.h12;
    float b2 = acc[2] + s.md * k.h22;
    float du = -(k.c00 * b0 + k.c01 * b1 + k.c02 * b2) * k.inv_det;
    float dv = -(k.c01 * b0 + k.c11 * b1 + k.c12 * b2) * k.inv_det;
    float dm = -(k.c02 * b0 + k.c12 * b1 + k.c22 * b2) * k.inv_det;
    float u_raw = s.u + du, v_raw = s.v + dv;
    if (u_raw < lo || u_raw > hi_x || v_raw < lo || v_raw > hi_y)
      s.failed = true;
    float u_new = fminf(fmaxf(u_raw, lo), hi_x);
    float v_new = fminf(fmaxf(v_raw, lo), hi_y);
    s.u = s.u + (u_new - s.u);
    s.v = s.v + (v_new - s.v);
    s.md = s.md + dm;
    bool small = (du * du + dv * dv) < eps2;
    s.active = !small && !s.failed;
  }
  return s;
}

__global__ void __launch_bounds__(LK_THREADS)
lk_kernel(const float* __restrict__ prev, const float* __restrict__ cur,
          const float* __restrict__ pts, const float* __restrict__ init,
          const unsigned char* __restrict__ valid, float* __restrict__ xy,
          unsigned char* __restrict__ conv, float* __restrict__ err,
          unsigned char* __restrict__ fb_conv, float* __restrict__ fb_d2,
          int h, int w, int hc, int wc, int half, int iters, float eps2,
          int fb_iters, int win_rows, int slice_rows, int hp, int wp) {
  __shared__ Shared sm;
  const int i = blockIdx.x;
  const int P = 2 * half + 1;
  int by_t, bx_t, by_c, bx_c;
  base_of(pts[2 * i], pts[2 * i + 1], half, win_rows, hp, wp, &by_t, &bx_t);
  base_of(init[2 * i], init[2 * i + 1], half, win_rows, hp, wp, &by_c,
          &bx_c);
  const float tx = pts[2 * i] - (float)bx_t, ty = pts[2 * i + 1] - (float)by_t;
  const float ux0 = init[2 * i] - (float)bx_c;
  const float uy0 = init[2 * i + 1] - (float)by_c;
  const float lo = (float)(half + 1);
  const float hi_y = (float)(win_rows - slice_rows + half - 1);
  const float hi_x = (float)(WIN_LANES - half - 4);
  const bool in_bounds = ty >= lo && ty <= hi_y && tx >= lo && tx <= hi_x &&
                         uy0 >= lo && uy0 <= hi_y && ux0 >= lo && ux0 <= hi_x;
  const bool run = valid[i] != 0 && in_bounds;
  if (!run) {
    if (threadIdx.x == 0) {
      xy[2 * i] = ux0 + (float)bx_c;
      xy[2 * i + 1] = uy0 + (float)by_c;
      conv[i] = 0;
      err[i] = 1e9f;
      if (fb_iters > 0) {
        fb_conv[i] = 0;
        fb_d2[i] = 1e9f;
      }
    }
    return;
  }
  const Geo gp{prev, h, w, by_t, bx_t};
  const Geo gc{cur, hc, wc, by_c, bx_c};
  Cof k = make_template(sm, gp, tx, ty, half, P, win_rows, slice_rows);
  Track s = run_lk(sm, gc, k, ux0, uy0, iters, eps2, half, P, win_rows,
                   slice_rows);
  const bool converged = !s.active && !s.failed;

  Tap t = tap_of(s.u, s.v, half, P, win_rows, slice_rows);
  float acc[1] = {0.f};
  for (int p = threadIdx.x; p < P * P; p += blockDim.x)
    acc[0] += fabsf(bilerp(gc, t, p / P, p % P) - sm.tpl[p] + s.md);
  block_sum<1>(acc, sm.red);
  const float e = acc[0] / (float)(P * P);

  bool fbc = false;
  float fbd = 1e9f;
  if (fb_iters > 0 && converged) {
    Cof kb = make_template(sm, gc, s.u, s.v, half, P, win_rows, slice_rows);
    Track b = run_lk(sm, gp, kb, tx, ty, fb_iters, eps2, half, P, win_rows,
                     slice_rows);
    fbc = !b.active && !b.failed;
    if (fbc) fbd = (b.u - tx) * (b.u - tx) + (b.v - ty) * (b.v - ty);
  }
  if (threadIdx.x == 0) {
    xy[2 * i] = s.u + (float)bx_c;
    xy[2 * i + 1] = s.v + (float)by_c;
    conv[i] = converged ? 1 : 0;
    err[i] = e;
    if (fb_iters > 0) {
      fb_conv[i] = fbc ? 1 : 0;
      fb_d2[i] = fbd;
    }
  }
}

extern "C" int lk_align(const float* prev, const float* cur, const float* pts,
                        const float* init, const unsigned char* valid,
                        float* xy, unsigned char* conv, float* err,
                        unsigned char* fb_conv, float* fb_d2, int n, int h,
                        int w, int hc, int wc, int half, int iters,
                        float eps2, int fb_iters, int win_rows,
                        int slice_rows, int hp, int wp, void* stream) {
  if (n <= 0) return 0;
  if (half < 1 || half > LK_MAX_HALF) return (int)cudaErrorInvalidValue;
  lk_kernel<<<n, LK_THREADS, 0, (cudaStream_t)stream>>>(
      prev, cur, pts, init, valid, xy, conv, err, fb_conv, fb_d2, h, w, hc, wc,
      half, iters, eps2, fb_iters, win_rows, slice_rows, hp, wp);
  return (int)cudaGetLastError();
}
