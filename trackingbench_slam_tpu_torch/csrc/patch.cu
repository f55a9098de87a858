// The two uses of the 32x32 keypoint patch crop, each fused with what
// consumes the crop so that no patch reaches device memory:
//   * orb_describe: IC angle on the raw crop, angle bin, 256 rBRIEF tests on
//     the blurred crop, packed bits, for every ORB level in one launch;
//   * anchor_cells: the 16x16 bilinear anchor cell of each wanted point,
//     written straight into its slot's cell of the anchor atlas.
//
// Replaces the Pallas TPU kernel extract_patches32 / _patch_kernel
// (trackingbench_slam_tpu/ops/pallas/patch_kernel.py:103) at its two call
// sites, with what the reference does to its output there: the moments,
// atan2, bin and selection-matrix BRIEF of ic_angle_from_patches /
// brief_from_patches (patch_kernel.py:162-217) for ORB, and the bilinear
// blend of bilinear_cell_patches_pallas plus the one-hot atlas write
// (trackingbench_slam_tpu/models/map.py:111-194) for the anchors.
//
// Crop semantics (both kernels): the Pallas window clamps amount to a crop
// whose top-left is (clamp(round(cy) - 15, 0, hp - 32), clamp(round(cx) - 15,
// 0, wp - 32)), round half to even, over the image zero-padded to (hp, wp) =
// (round_up(max(h,56),8), round_up(max(w,384),128)); pixels past the image
// read 0. Points near the border get a shifted crop, which both outputs must
// reproduce.
//
// What bounds them on this card: bytes. A described point reads its two
// 32x32 crops (8 KB, much of it shared with neighbouring points) and writes
// 36 bytes against ~3,000 operations; an anchor cell reads a 17x17 block and
// writes 1 KB against ~2,300. The crop kernel these replace wrote every 4 KB
// patch to device memory and the consumers read it back with ~30 launches a
// level (ORB) or several full copies of the 16 MB atlas (anchors).
//
// orb_describe design:
//   * one warp per keypoint, 4 a block, every ORB level in one launch: the
//     wrapper passes a small by-value table (images, shape, padded shape,
//     first row) and each warp finds its level from its row index;
//   * the warp stages its raw and its blurred crop into shared memory with
//     cp.async (lane = column, so each row is one coalesced 128-byte read),
//     as two commit groups issued up front; zero-filled past the image with
//     src-size 0, as lk.cu does;
//   * after the raw group lands, each lane sums its column over the radius-15
//     circle (mask computed arithmetically: a table read with 32 different
//     addresses would serialise), in double, and an xor butterfly gives every
//     lane the same moments; atan2f, then angle_bins' exact recipe (fmodf,
//     +2 pi where negative, IEEE division, rintf, mod 32);
//   * after the blurred group lands, 8 rounds of 32 tests: lane j reads its
//     two positions (one int32 holding two int16) from the (32 bins x 512)
//     table through L1, compares, and __ballot_sync yields word i;
//   * lanes 0-7 store the 8 words: one coalesced 32-byte store. Invalid rows
//     stage nothing and write angle 0 and zero words.
//
// anchor_cells design: one 256-thread block per point, one output pixel per
// thread; rows not wanted return at once. The four taps come from global
// memory through L1 (the 17x17 block is L1-resident). The blend is the plain
// expression in its order with __fmul_rn / __fadd_rn / __fsub_rn, so the
// library's FMA contraction cannot fuse it and the cells are bit-exact. The
// wrapper clones the atlas first: the input map's tensor is never written.

#include <cuda_runtime.h>

#define PATCH 32
#define ORB_WARPS 4
#define ORB_MAX_LEVELS 8
#define ANGLE_BINS 32
#define CELL 16
#define FULL_MASK 0xffffffffu

// top-left of the crop of a point at coordinate c, clamped as the Pallas
// window is; `padded` is the padded extent along that axis
__device__ __forceinline__ int crop_origin(float c, int padded) {
  const float lim = 1073741824.0f;  // 2^30, as the plain version clamps
  const int o = (int)fminf(fmaxf(rintf(c), -lim), lim) - (PATCH / 2 - 1);
  return min(max(o, 0), padded - PATCH);
}

// One 4-byte cp.async, zero-filled where `ok` is false (src is then only a
// valid address, not read).
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
}

// Stage the 32x32 crop at (r0, c0) of img (h x w) into T, lane = column,
// and commit it as one group.
__device__ __forceinline__ void stage_crop(float* T,
                                           const float* __restrict__ img,
                                           int h, int w, int r0, int c0,
                                           int lane) {
  const int gx = c0 + lane;
  const bool col_ok = gx < w;
  const float* src = img + (long long)r0 * w + gx;
#pragma unroll
  for (int r = 0; r < PATCH; ++r) {
    const bool ok = col_ok && r0 + r < h;
    cp_async4(T + r * PATCH + lane, ok ? src : img, ok);
    src += w;
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

struct OrbLevel {
  const float* raw;
  const float* blur;
  int h, w, hp, wp, first;
};

struct OrbArgs {
  OrbLevel lv[ORB_MAX_LEVELS];
  int levels, n;
  const float* xy;              // (N, 2) level coordinates
  const unsigned char* valid;   // (N,)
  const int* pairs;             // (32, 256): positions 2k | 2k+1 << 16
  float* angle;                 // (N,)
  int* desc;                    // (N, 8)
};

__global__ void __launch_bounds__(32 * ORB_WARPS) orb_describe_kernel(
    const OrbArgs a) {
  __shared__ float crops[ORB_WARPS][2][PATCH * PATCH];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i = blockIdx.x * ORB_WARPS + warp;
  if (i >= a.n) return;  // warp-uniform
  if (!a.valid[i]) {
    if (lane == 0) a.angle[i] = 0.0f;
    if (lane < 8) a.desc[8 * i + lane] = 0;
    return;
  }
  OrbLevel L = a.lv[0];
#pragma unroll
  for (int l = 1; l < ORB_MAX_LEVELS; ++l)
    if (l < a.levels && i >= a.lv[l].first) L = a.lv[l];
  const int r0 = crop_origin(a.xy[2 * i + 1], L.hp);
  const int c0 = crop_origin(a.xy[2 * i], L.wp);
  float* R = crops[warp][0];
  float* B = crops[warp][1];
  stage_crop(R, L.raw, L.h, L.w, r0, c0, lane);
  stage_crop(B, L.blur, L.h, L.w, r0, c0, lane);

  // IC angle: moments of the raw crop over the radius-15 circle at (15, 15)
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  __syncwarp();
  const int dx = lane - 15;
  double col = 0.0, m01 = 0.0;
#pragma unroll
  for (int r = 0; r < PATCH - 1; ++r) {
    const int dy = r - 15;
    const bool in = lane < PATCH - 1 && dx * dx + dy * dy <= 225;
    const double p = in ? (double)R[r * PATCH + lane] : 0.0;
    col += p;
    m01 += (double)dy * p;
  }
  double m10 = (double)dx * col;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    m10 += __shfl_xor_sync(FULL_MASK, m10, off);
    m01 += __shfl_xor_sync(FULL_MASK, m01, off);
  }
  const float ang = atan2f((float)m01, (float)m10);

  // angle_bins: round(mod(a, 2 pi) / 2 pi * 32) % 32
  const float two_pi = 6.28318548202514648f;  // float32(2 pi)
  float rem = fmodf(ang, two_pi);
  if (rem != 0.0f && rem < 0.0f) rem = __fadd_rn(rem, two_pi);
  const int bin =
      (int)rintf(__fmul_rn(__fdiv_rn(rem, two_pi), (float)ANGLE_BINS)) %
      ANGLE_BINS;

  // rBRIEF on the blurred crop: bit j of word k = test 32 k + j
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncwarp();
  const int* tab = a.pairs + bin * 256 + lane;
  unsigned mine = 0u;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int pr = __ldg(tab + 32 * k);
    const bool bit = B[pr & 0xffff] < B[(unsigned)pr >> 16];
    const unsigned word = __ballot_sync(FULL_MASK, bit);
    if (lane == k) mine = word;
  }
  if (lane == 0) a.angle[i] = ang;
  if (lane < 8) a.desc[8 * i + lane] = (int)mine;
}

// raw/blur: `levels` image pointers; table: per level (h, w, hp, wp, first
// row); pairs: (32, 512) int16 positions.
extern "C" int orb_describe(const void* const* raw, const void* const* blur,
                            const int* table, int levels, const float* xy,
                            const unsigned char* valid, const void* pairs,
                            float* angle, int* desc, int n, void* stream) {
  if (n <= 0) return 0;
  if (levels < 1 || levels > ORB_MAX_LEVELS)
    return (int)cudaErrorInvalidValue;
  OrbArgs a;
  for (int l = 0; l < ORB_MAX_LEVELS; ++l) {
    const int k = l < levels ? l : 0;
    const int* e = table + 5 * k;
    a.lv[l] = OrbLevel{(const float*)raw[k], (const float*)blur[k], e[0],
                       e[1], e[2], e[3], e[4]};
  }
  a.levels = levels;
  a.n = n;
  a.xy = xy;
  a.valid = valid;
  a.pairs = (const int*)pairs;
  a.angle = angle;
  a.desc = desc;
  orb_describe_kernel<<<(n + ORB_WARPS - 1) / ORB_WARPS, 32 * ORB_WARPS, 0,
                        (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

struct CellArgs {
  const float* img;
  int h, w, hp, wp;
  const float* xy;             // (N, 2)
  const int* slots;            // (N,)
  const unsigned char* want;   // (N,)
  float* atlas;                // (grid * CELL)^2
  int grid, capacity;
};

__global__ void __launch_bounds__(CELL * CELL) anchor_cells_kernel(
    const CellArgs a) {
  const int i = blockIdx.x;
  const int slot = a.slots[i];
  if (!a.want[i] || slot < 0 || slot >= a.capacity) return;  // block-uniform
  const float x = a.xy[2 * i], y = a.xy[2 * i + 1];
  const float x0 = floorf(x), y0 = floorf(y);
  // the crop centred at floor(kp) + 7 starts at floor(kp) - 8
  const int c0 = crop_origin(x0 + 7.0f, a.wp);
  const int r0 = crop_origin(y0 + 7.0f, a.hp);
  const float fx = __fsub_rn(x, x0), fy = __fsub_rn(y, y0);
  const int ty = threadIdx.x / CELL, tx = threadIdx.x % CELL;
  const int gy = r0 + ty, gx = c0 + tx;
  const bool y_in = gy < a.h, y1_in = gy + 1 < a.h;
  const bool x_in = gx < a.w, x1_in = gx + 1 < a.w;
  const float* p = a.img + (long long)gy * a.w + gx;
  const float t00 = (y_in && x_in) ? __ldg(p) : 0.0f;
  const float t01 = (y_in && x1_in) ? __ldg(p + 1) : 0.0f;
  const float t10 = (y1_in && x_in) ? __ldg(p + a.w) : 0.0f;
  const float t11 = (y1_in && x1_in) ? __ldg(p + a.w + 1) : 0.0f;
  const float ofx = __fsub_rn(1.0f, fx), ofy = __fsub_rn(1.0f, fy);
  const float top = __fadd_rn(__fmul_rn(ofx, t00), __fmul_rn(fx, t01));
  const float bot = __fadd_rn(__fmul_rn(ofx, t10), __fmul_rn(fx, t11));
  const float v = __fadd_rn(__fmul_rn(ofy, top), __fmul_rn(fy, bot));
  const int row = slot / a.grid, col = slot - row * a.grid;
  a.atlas[(long long)(row * CELL + ty) * (a.grid * CELL) + col * CELL + tx] =
      v;
}

// img: (h, w) level-0 image, zero-padded to (hp, wp) for the crop clamps;
// atlas: (grid * 16)^2, written in place at the wanted slots' cells.
extern "C" int anchor_cells(const float* img, int h, int w, int hp, int wp,
                            const float* xy, const int* slots,
                            const unsigned char* want, float* atlas, int grid,
                            int capacity, int n, void* stream) {
  if (n <= 0) return 0;
  CellArgs a{img, h, w, hp, wp, xy, slots, want, atlas, grid, capacity};
  anchor_cells_kernel<<<n, CELL * CELL, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
