// 32x32 integer patch crop per keypoint.
//
// Replaces the Pallas TPU kernel extract_patches32 / _patch_kernel
// (trackingbench_slam_tpu/ops/pallas/patch_kernel.py). The Pallas kernel cuts
// each patch out of a tile-aligned window of the image zero-padded to
// (hp, wp) = (round_up(max(h,56),8), round_up(max(w,384),128)); its window
// clamps amount to a patch whose top-left is
//   (clamp(round(cy) - 15, 0, hp - 32), clamp(round(cx) - 15, 0, wp - 32))
// with round half to even. Keypoints near the border therefore get a
// shifted patch, which ORB descriptors must reproduce to be bit-exact.
//
// Design: one 256-thread block per point, four pixels per thread, reads
// coalesced along rows. Bound on the card: bytes — each patch is 4 KB
// written (8 MB at N = 2000) and read from cache-resident image rows; the
// kernel has no arithmetic to speak of.

#include <cuda_runtime.h>

#define PATCH 32
#define PATCH_THREADS 256

__global__ void __launch_bounds__(PATCH_THREADS)
patch_kernel(const float* __restrict__ img, const float* __restrict__ centers,
             float* __restrict__ out, int h, int w, int hp, int wp) {
  const int i = blockIdx.x;
  const int top = (int)rintf(centers[2 * i + 1]) - (PATCH / 2 - 1);
  const int left = (int)rintf(centers[2 * i]) - (PATCH / 2 - 1);
  const int r0 = min(max(top, 0), hp - PATCH);
  const int c0 = min(max(left, 0), wp - PATCH);
  float* dst = out + (size_t)i * PATCH * PATCH;
  for (int p = threadIdx.x; p < PATCH * PATCH; p += PATCH_THREADS) {
    const int gy = r0 + p / PATCH, gx = c0 + p % PATCH;
    dst[p] = (gy < h && gx < w) ? img[gy * w + gx] : 0.0f;
  }
}

extern "C" int extract_patches(const float* img, const float* centers,
                               float* out, int n, int h, int w, int hp, int wp,
                               void* stream) {
  if (n <= 0) return 0;
  patch_kernel<<<n, PATCH_THREADS, 0, (cudaStream_t)stream>>>(img, centers,
                                                              out, h, w, hp, wp);
  return (int)cudaGetLastError();
}
