// Pyramidal inverse-compositional 3-parameter patch alignment (LK): one warp
// per point, all pyramid levels of a call in one launch.
//
// Replaces the Pallas TPU kernel patch_align_pallas / _lk_kernel
// (trackingbench_slam_tpu/ops/pallas/lk_kernel.py:347), which the reference
// calls once per pyramid level (trackingbench_slam_tpu/ops/align.py:196-227).
// Semantics are the Pallas kernel's, point for point, at every level:
//   * both images are read as if zero-padded to (hp, wp) = (round_up(max(h,
//     WIN),8), round_up(max(w,384),128)), with (h, w) the TEMPLATE image's
//     shape (the anchored caller's template is the 2048^2 atlas and its
//     search image the smaller frame); pixels outside an image's own shape
//     read 0. Each point iterates in coordinates local to a window whose
//     base is aligned down to 8 rows / 128 columns (base_of), computed
//     separately for the template and the search start;
//   * travel bounds lo = half+1, hi_y = WIN-SLICE+half-1, hi_x = 256-half-4:
//     a point whose template or start lies outside never runs (err = 1e9,
//     xy = start - base + base in float32); a raw step outside them fails
//     the point (and the position is clipped);
//   * the template and its central-difference gradients come from ONE
//     bilinear (P+2)^2 sample at origin (t - half - 1);
//   * H = J^T J + 1e-6 I, inverted by cofactors with |det| >= 1e-10;
//   * converged when |d|^2 < eps^2; err = mean |cur - tpl + md|;
//   * with fb_iters > 0 a back-track at level 0 from the solution (template
//     cut from cur at the solution, search in prev from t) gives fb_conv and
//     fb_d2.
// The level loop is ops/align.py's lk_pyramidal: start = (start + offset) *
// start_scale, template at pts * scale^l, `valid` gates every level, xy /
// scale between levels in float32, and after level 0 the in-image check
// against the template image's level-0 shape (lk_kernel.py:423-428).
//
// What bounds it on this card: per point and level the work is ~iters x P^2
// x ~15 flops on a patch of a few KB, so both roofs are far away (the bound
// is microseconds, chip_smoke.py). The time is the dependent chain of the
// slowest points: 30 iterations a level, each a sample, a reduction and a
// 3x3 solve. A block per point pays, in every iteration, a block reduction
// with two __syncthreads and four bounds-checked loads a pixel through L1,
// and a launch per level adds a wrapper's worth of torch ops. Here:
//   * one warp per point, 4 points a block; H, b and the error are summed
//     with __shfl_xor_sync butterflies, so every lane holds the same totals
//     bit for bit, solves the 3x3 system itself and takes the same exit: no
//     block barrier anywhere;
//   * template, gradients and each lane's tile offsets live in registers
//     (K = ceil(P^2/32) pixels a lane, sized by the call's half: 3 / 14 /
//     31), and the pixel loops are branch-free, so the compiler overlaps one
//     pixel's tile loads with another's arithmetic;
//   * the pixels a point reads are staged by its warp into its own shared
//     tile with cp.async (TR x TC around the footprint, zero-filled outside
//     the image, all loads in flight at once); the warp restages only when a
//     bilinear footprint leaves the tile or the image changes. The tile's
//     rows are P + TC floats apart, so pixel p of the patch sits at offset
//     p + TC * (p / P) and the 32 lanes of every tap read 32 banks;
//   * all levels (and the back-track) run inside the one launch;
//   * a batch of sequences runs in the same launch: point i belongs to
//     sequence i / n_per, whose images sit at each level's base pointer plus
//     that many batch strides, so a point walks its own sequence's level
//     chain (dp_eval's batched steps make one launch for all sequences).
// The tile must reproduce exactly the pixels the window-local tap reads
// (tap_of's slice clamps), so the staged region is addressed in global
// coordinates: row by + iy + r, column bx + ix + c, each image bounded by
// its own shape. The TPU exits 8 points jointly; frozen points do not move, so the
// per-point exit gives the same answer. Float contraction (FMA) is on: the
// agreement with the plain version stays within the tolerance chip_smoke.py
// checks (PERF.md).

#include <cuda_runtime.h>

#define LK_MAX_HALF 15
#define LK_MAX_LEVELS 4
#define WIN_LANES 256
#define MARGIN 12
#define FULL_MASK 0xffffffffu

struct LkLevel {
  const float* prev;  // template image of this level (sequence 0)
  const float* cur;   // search image of this level (sequence 0)
  long long prev_bs, cur_bs;  // floats from one sequence's image to the next
  int h, w;           // prev's shape
  int hc, wc;         // cur's shape
  int hp, wp;         // prev's padded shape at this half
  float s;            // scale ** level
};

struct LkArgs {
  LkLevel lv[LK_MAX_LEVELS];
  const float* pts;     // (N, 2) level-0 template positions
  const float* start;   // (N, 2) level-0 start positions
  const float* offset;  // (N, 2) added to start, or null
  const unsigned char* valid;
  float* xy;
  unsigned char* conv;
  float* err;
  unsigned char* fb_conv;
  float* fb_d2;
  int n, n_per, levels, half, iters, fb_iters, win_rows, slice_rows;
  float eps2, scale, start_scale;
};

__device__ __forceinline__ LkLevel level_of(const LkArgs& a, int l) {
  LkLevel r = a.lv[0];
#pragma unroll
  for (int k = 1; k < LK_MAX_LEVELS; ++k)
    if (l == k) r = a.lv[k];
  return r;
}

__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}

// Window base for a level position (base_of, lk_kernel.py:376-383).
__device__ __forceinline__ void base_of(float x, float y, int half,
                                        int win_rows, int hp, int wp, int* by,
                                        int* bx) {
  const float lim = 1073741824.0f;  // 2^30, as the plain version clamps
  int ix = (int)rintf(fminf(fmaxf(x, -lim), lim)) - half - MARGIN;
  int iy = (int)rintf(fminf(fmaxf(y, -lim), lim)) - half - MARGIN;
  ix = floordiv(ix, 128) * 128;
  iy = floordiv(iy, 8) * 8;
  *bx = min(max(ix, 0), wp - WIN_LANES);
  *by = min(max(iy, 0), hp - win_rows);
}

template <int K>
__device__ __forceinline__ void warp_sum(float (&v)[K]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] += __shfl_xor_sync(FULL_MASK, v[k], off);
  }
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

// The warp's shared tile: TR x TC pixels of `src` from global (y0, x0).
struct View {
  const float* src;
  int y0, x0;
};

// One 4-byte cp.async, zero-filled where `ok` is false (src is then only a
// valid address, not read).
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
}

// Stage TR rows x TC columns of img from global (y0, x0) into the tile, rows
// S floats apart, zero outside the image: all loads in flight at once.
template <int TR, int TC>
__device__ __forceinline__ void stage(float* T, int S,
                                      const float* __restrict__ img, int h,
                                      int w, int y0, int x0, int lane) {
  __syncwarp();
#pragma unroll
  for (int c = lane; c < TC; c += 32) {
    const int gx = x0 + c;
    const bool col_ok = gx >= 0 && gx < w;
    const float* src = img + (long long)y0 * w + gx;
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      const bool ok = col_ok && y0 + r >= 0 && y0 + r < h;
      cp_async4(T + r * S + c, ok ? src : img, ok);
      src += w;
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncwarp();
}

// Tile offset of global pixel (gy, gx), restaging the tile around the
// nr x nc footprint at (gy, gx) when the footprint is not inside it.
template <int TR, int TC>
__device__ __forceinline__ int view_at(float* T, int S, View& vw,
                                       const float* img, int h, int w, int gy,
                                       int gx, int nr, int nc, int lane) {
  if (vw.src != img || gy < vw.y0 || gx < vw.x0 || gy + nr > vw.y0 + TR ||
      gx + nc > vw.x0 + TC) {
    vw.src = img;
    vw.y0 = gy - (TR - nr) / 2;
    vw.x0 = gx - (TC - nc) / 2;
    stage<TR, TC>(T, S, img, h, w, vw.y0, vw.x0, lane);
  }
  return (gy - vw.y0) * S + (gx - vw.x0);
}

__device__ __forceinline__ float bilerp(const float* T, int S, int o,
                                        float fx, float fy) {
  const float t00 = T[o], t01 = T[o + 1];
  const float t10 = T[o + S], t11 = T[o + S + 1];
  const float top = t00 + fx * (t01 - t00);
  const float bot = t10 + fx * (t11 - t10);
  return top + fy * (bot - top);
}

struct Cof {
  float c00, c01, c02, c11, c12, c22, inv_det, h02, h12, h22;
};

// Per-lane template state: pixel p = lane + 32 k of the P x P patch, its
// tile offset r * S + c, template value and gradients.
template <int K>
struct Patch {
  int off[K];
  float tpl[K], gx[K], gy[K];
};

struct Geo {
  const float* img;
  int h, w;    // the image's own shape
  int by, bx;  // window base (global)
};

struct Shape {
  int half, P, PP, win_rows, slice_rows, lane;
  int S;  // tile row stride, P + TC: pixel p of the patch sits at tile
          // offset p + TC * (p / P), so 32 consecutive pixels hit 32 banks
};

// Template + gradients at window-local (x, y) of g (make_template).
template <int K, int TR, int TC>
__device__ __forceinline__ Cof make_template(float* T, View& vw,
                                             Patch<K>& pa, const Geo& g,
                                             float x, float y,
                                             const Shape& sh) {
  const Tap t = tap_of(x - 1.0f, y - 1.0f, sh.half, sh.P, sh.win_rows,
                       sh.slice_rows);
  const int o0 = view_at<TR, TC>(T, sh.S, vw, g.img, g.h, g.w, g.by + t.iy,
                                 g.bx + t.ix, sh.P + 3, sh.P + 3, sh.lane);
  const int S = sh.S;
  float acc[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  // branch-free over the lane's pixels, so the scheduler can overlap one
  // pixel's tile loads with another's arithmetic: a lane past the patch
  // reads the tile at offset 0 and keeps zeros, which add nothing
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const bool in = sh.lane + 32 * k < sh.PP;
    // grid value (r', c') = bilerp at o0 + r' * S + c'; this pixel is the
    // grid's (r+1, c+1)
    const int o = o0 + pa.off[k];
    const float tp = bilerp(T, S, o + S + 1, t.fx, t.fy);
    const float gxv = 0.5f * (bilerp(T, S, o + S + 2, t.fx, t.fy) -
                              bilerp(T, S, o + S, t.fx, t.fy));
    const float gyv = 0.5f * (bilerp(T, S, o + 2 * S + 1, t.fx, t.fy) -
                              bilerp(T, S, o + 1, t.fx, t.fy));
    pa.tpl[k] = in ? tp : 0.0f;
    pa.gx[k] = in ? gxv : 0.0f;
    pa.gy[k] = in ? gyv : 0.0f;
    acc[0] += pa.gx[k] * pa.gx[k];
    acc[1] += pa.gx[k] * pa.gy[k];
    acc[2] += pa.gx[k];
    acc[3] += pa.gy[k] * pa.gy[k];
    acc[4] += pa.gy[k];
  }
  warp_sum<5>(acc);
  const float h00 = acc[0] + 1e-6f, h01 = acc[1], h02 = acc[2];
  const float h11 = acc[3] + 1e-6f, h12 = acc[4];
  const float h22 = (float)sh.PP + 1e-6f;
  Cof c;
  c.c00 = h11 * h22 - h12 * h12;
  c.c01 = h02 * h12 - h01 * h22;
  c.c02 = h01 * h12 - h02 * h11;
  c.c11 = h00 * h22 - h02 * h02;
  c.c12 = h01 * h02 - h00 * h12;
  c.c22 = h00 * h11 - h01 * h01;
  float det = h00 * c.c00 + h01 * c.c01 + h02 * c.c02;
  if (fabsf(det) < 1e-10f) det = 1e-10f;
  c.inv_det = 1.0f / det;
  c.h02 = h02;
  c.h12 = h12;
  c.h22 = h22;
  return c;
}

struct Track {
  float u, v, md;
  bool active, failed;
};

// Iterate from window-local (u0, v0) in g against the template in pa.
template <int K, int TR, int TC>
__device__ __forceinline__ Track run_lk(float* T, View& vw,
                                        const Patch<K>& pa, const Geo& g,
                                        const Cof& c, float u0, float v0,
                                        int n_iters, float eps2,
                                        const Shape& sh) {
  const float lo = (float)(sh.half + 1);
  const float hi_y = (float)(sh.win_rows - sh.slice_rows + sh.half - 1);
  const float hi_x = (float)(WIN_LANES - sh.half - 4);
  Track s{u0, v0, 0.0f, true, false};
  for (int it = 0; it < n_iters && s.active; ++it) {
    const Tap t = tap_of(s.u, s.v, sh.half, sh.P, sh.win_rows, sh.slice_rows);
    const int o0 = view_at<TR, TC>(T, sh.S, vw, g.img, g.h, g.w,
                                   g.by + t.iy, g.bx + t.ix, sh.P + 1,
                                   sh.P + 1, sh.lane);
    float acc[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < K; ++k) {   // branch-free, as in make_template
      const float d = bilerp(T, sh.S, o0 + pa.off[k], t.fx, t.fy) - pa.tpl[k];
      const float r = sh.lane + 32 * k < sh.PP ? d : 0.0f;
      acc[0] += r * pa.gx[k];
      acc[1] += r * pa.gy[k];
      acc[2] += r;
    }
    warp_sum<3>(acc);
    const float b0 = acc[0] + s.md * c.h02;
    const float b1 = acc[1] + s.md * c.h12;
    const float b2 = acc[2] + s.md * c.h22;
    const float du = -(c.c00 * b0 + c.c01 * b1 + c.c02 * b2) * c.inv_det;
    const float dv = -(c.c01 * b0 + c.c11 * b1 + c.c12 * b2) * c.inv_det;
    const float dm = -(c.c02 * b0 + c.c12 * b1 + c.c22 * b2) * c.inv_det;
    const float u_raw = s.u + du, v_raw = s.v + dv;
    if (u_raw < lo || u_raw > hi_x || v_raw < lo || v_raw > hi_y)
      s.failed = true;
    const float u_new = fminf(fmaxf(u_raw, lo), hi_x);
    const float v_new = fminf(fmaxf(v_raw, lo), hi_y);
    s.u = s.u + (u_new - s.u);
    s.v = s.v + (v_new - s.v);
    s.md = s.md + dm;
    const bool small = (du * du + dv * dv) < eps2;
    s.active = !small && !s.failed;
  }
  return s;
}

// mean |cur - tpl + md| at window-local (u, v) of g.
template <int K, int TR, int TC>
__device__ __forceinline__ float error_at(float* T, View& vw,
                                          const Patch<K>& pa, const Geo& g,
                                          float u, float v, float md,
                                          const Shape& sh) {
  const Tap t = tap_of(u, v, sh.half, sh.P, sh.win_rows, sh.slice_rows);
  const int o0 = view_at<TR, TC>(T, sh.S, vw, g.img, g.h, g.w, g.by + t.iy,
                                 g.bx + t.ix, sh.P + 1, sh.P + 1, sh.lane);
  float acc[1] = {0.f};
#pragma unroll
  for (int k = 0; k < K; ++k) {   // branch-free, as in make_template
    const float e =
        fabsf(bilerp(T, sh.S, o0 + pa.off[k], t.fx, t.fy) - pa.tpl[k] + md);
    acc[0] += sh.lane + 32 * k < sh.PP ? e : 0.0f;
  }
  warp_sum<1>(acc);
  return acc[0] / (float)sh.PP;
}

// K pixels a lane, a TR x TC tile with rows up to TC + PMAX floats apart,
// WARPS points a block, at least MINB blocks an SM.
template <int K, int TR, int TC, int PMAX, int WARPS, int MINB>
__global__ void __launch_bounds__(32 * WARPS, MINB) lk_kernel(const LkArgs a) {
  __shared__ float tiles[WARPS][TR * (TC + PMAX)];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i = blockIdx.x * WARPS + warp;
  if (i >= a.n) return;  // warp-uniform
  float* T = tiles[warp];
  const int half = a.half, P = 2 * half + 1;
  const Shape sh{half, P, P * P, a.win_rows, a.slice_rows, lane, P + TC};
  Patch<K> pa;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int p = lane + 32 * k;
    pa.off[k] = p < sh.PP ? p + TC * (p / P) : 0;
  }
  const long long seq = i / a.n_per;
  const float px = a.pts[2 * i], py = a.pts[2 * i + 1];
  float x = a.start[2 * i], y = a.start[2 * i + 1];
  if (a.offset != nullptr) {
    x = x + a.offset[2 * i];
    y = y + a.offset[2 * i + 1];
  }
  x = x * a.start_scale;
  y = y * a.start_scale;
  const bool valid = a.valid[i] != 0;
  const float lo = (float)(half + 1);
  const float hi_y = (float)(a.win_rows - a.slice_rows + half - 1);
  const float hi_x = (float)(WIN_LANES - half - 4);
  View vw{nullptr, 0, 0};
  bool converged = false, fbc = false;
  float e = 1e9f, fbd = 1e9f;
  for (int l = a.levels - 1; l >= 0; --l) {
    const LkLevel L = level_of(a, l);
    const float tgx = px * L.s, tgy = py * L.s;
    int by_t, bx_t, by_c, bx_c;
    base_of(tgx, tgy, half, a.win_rows, L.hp, L.wp, &by_t, &bx_t);
    base_of(x, y, half, a.win_rows, L.hp, L.wp, &by_c, &bx_c);
    const float tx = tgx - (float)bx_t, ty = tgy - (float)by_t;
    const float ux0 = x - (float)bx_c, uy0 = y - (float)by_c;
    const bool run = valid && ty >= lo && ty <= hi_y && tx >= lo &&
                     tx <= hi_x && uy0 >= lo && uy0 <= hi_y && ux0 >= lo &&
                     ux0 <= hi_x;
    float u = ux0, v = uy0;
    converged = false;
    e = 1e9f;
    if (run) {
      const Geo gp{L.prev + seq * L.prev_bs, L.h, L.w, by_t, bx_t};
      const Geo gc{L.cur + seq * L.cur_bs, L.hc, L.wc, by_c, bx_c};
      const Cof c = make_template<K, TR, TC>(T, vw, pa, gp, tx, ty, sh);
      const Track s = run_lk<K, TR, TC>(T, vw, pa, gc, c, ux0, uy0, a.iters,
                                        a.eps2, sh);
      converged = !s.active && !s.failed;
      u = s.u;
      v = s.v;
      if (l == 0) {
        e = error_at<K, TR, TC>(T, vw, pa, gc, u, v, s.md, sh);
        if (a.fb_iters > 0 && converged) {
          const Cof cb = make_template<K, TR, TC>(T, vw, pa, gc, u, v, sh);
          const Track b = run_lk<K, TR, TC>(T, vw, pa, gp, cb, tx, ty,
                                            a.fb_iters, a.eps2, sh);
          fbc = !b.active && !b.failed;
          if (fbc) fbd = (b.u - tx) * (b.u - tx) + (b.v - ty) * (b.v - ty);
        }
      }
    }
    x = u + (float)bx_c;
    y = v + (float)by_c;
    if (l > 0) {
      x = x / a.scale;
      y = y / a.scale;
    }
  }
  const LkLevel L0 = level_of(a, 0);
  const bool inb = x >= (float)half && x < (float)(L0.w - half) &&
                   y >= (float)half && y < (float)(L0.h - half);
  const bool conv = converged && inb && valid;
  if (lane == 0) {
    a.xy[2 * i] = x;
    a.xy[2 * i + 1] = y;
    a.conv[i] = conv ? 1 : 0;
    a.err[i] = e;
    if (a.fb_iters > 0) {
      a.fb_conv[i] = (fbc && conv) ? 1 : 0;
      a.fb_d2[i] = fbd;
    }
  }
}

// prev/cur: `levels` image pointers (sequence 0), level 0 first; bstrides:
// per level the prev and cur batch strides in floats; shapes: per level
// (h, w, hc, wc, hp, wp); scales: per level scale ** level; n points in
// sequences of n_per.
extern "C" int lk_align(const void* const* prev, const void* const* cur,
                        const long long* bstrides, const int* shapes,
                        const float* scales, int levels,
                        const float* pts, const float* start,
                        const float* offset, const unsigned char* valid,
                        float* xy, unsigned char* conv, float* err,
                        unsigned char* fb_conv, float* fb_d2, int n,
                        int n_per, int half,
                        int iters, float eps2, int fb_iters, int win_rows,
                        int slice_rows, float scale, float start_scale,
                        void* stream) {
  if (n <= 0) return 0;
  if (half < 1 || half > LK_MAX_HALF || levels < 1 ||
      levels > LK_MAX_LEVELS || n_per < 1 || n % n_per != 0)
    return (int)cudaErrorInvalidValue;
  LkArgs a;
  for (int l = 0; l < LK_MAX_LEVELS; ++l) {
    const int k = l < levels ? l : 0;
    const int* sh = shapes + 6 * k;
    a.lv[l] = LkLevel{(const float*)prev[k], (const float*)cur[k],
                      bstrides[2 * k], bstrides[2 * k + 1], sh[0], sh[1],
                      sh[2], sh[3], sh[4], sh[5], scales[k]};
  }
  a.pts = pts;
  a.start = start;
  a.offset = offset;
  a.valid = valid;
  a.xy = xy;
  a.conv = conv;
  a.err = err;
  a.fb_conv = fb_conv;
  a.fb_d2 = fb_d2;
  a.n = n;
  a.n_per = n_per;
  a.levels = levels;
  a.half = half;
  a.iters = iters;
  a.fb_iters = fb_iters;
  a.win_rows = win_rows;
  a.slice_rows = slice_rows;
  a.eps2 = eps2;
  a.scale = scale;
  a.start_scale = start_scale;
  cudaStream_t st = (cudaStream_t)stream;
  // storage sized by the call's half: K = ceil(P^2 / 32) pixels a lane; the
  // tile holds the (P+3)^2 template footprint with room to travel. At half
  // 10, 3 blocks of 4 warps an SM (<= 168 registers) hold 1584 points, and
  // the rest start as the first finish: capped at 128 registers (one wave
  // for 2000 points) the compiler serialises the pixels' tile loads, which
  // measured slower.
  if (half <= 4)
    lk_kernel<3, 16, 32, 9, 4, 4><<<(n + 3) / 4, 128, 0, st>>>(a);
  else if (half <= 10)
    lk_kernel<14, 32, 32, 21, 4, 3><<<(n + 3) / 4, 128, 0, st>>>(a);
  else
    lk_kernel<31, 40, 64, 31, 2, 1><<<(n + 1) / 2, 64, 0, st>>>(a);
  return (int)cudaGetLastError();
}
