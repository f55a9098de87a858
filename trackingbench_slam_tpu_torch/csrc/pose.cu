// One round of the motion-only LM pose solve, for every sequence of a batch
// in one launch.
//
// Replaces no Pallas kernel: the JAX package leaves the solve
// (trackingbench_slam_tpu/solvers/pose_opt.py) to XLA, which fuses it on the
// TPU. Run eagerly on the card, one round was ~3,363 small PyTorch launches
// and a 4-round solve 13,351: their host cost was ~80% of a batched track
// step (PERF.md). What bounds this kernel is latency, not bytes or
// operations: a round reads ~26 bytes a point once and needs at most
// ~2,000 operations a point, ~3 us of the card's float32 rate at B 44 and
// N 2000 (chip_smoke.py `pose_round_ops`), while its eleven builds of
// (H, b, cost) are each a block-wide sum and its ten 6x6 solves a chain of
// dependent scalar operations (a round takes ~110 us there). The design keeps both short: one block a sequence (grid
// (B,)), the points in registers across the builds, and the solve on one
// thread between them.
//
// Semantics: ops/cuda/pose_kernel.py `pose_round_plain`, the LM loop of
// `lm_pose_iterations` (one build at the round's pose, then per iteration
// the damped 6x6 Cholesky solve with its 1e-12 floor, se3 exp and compose,
// the build at the new pose, accept if the cost fell, lambda x0.5 floored
// at 1e-9 or x4 capped at 1e6), se3.normalize's two Newton polar steps, and
// the round's inlier gate (valid, chi2 <= threshold, z > 0.05):
//   * a build sums 43 terms a point (H's 36 entries row by row, b's 6, the
//     cost) in ops/linalg.py `fixed_sum`'s order: zero-padded to
//     P = pow2(N) and halved, x[:h] + x[h:], to one. Thread t holds points
//     t + k * THREADS, k < PPT: the first halvings pair k and k + PPT / 2
//     inside the thread, the next ones pair threads through shared memory,
//     the last five a warp's lanes through __shfl_down_sync. Above
//     P = MAX_PPT * THREADS a thread runs `groups` virtual threads of
//     MAX_PPT points each, reading its points again at every build, and
//     their partial sums halve in global scratch first;
//   * every product and sum is rounded alone, in the plain code's order
//     (the library is built with -fmad=false); divisions and square roots
//     are IEEE; a division by a constant is a product with the constant's
//     float reciprocal and `delta / e` is (1 / e) * delta, as PyTorch's CUDA
//     ops compute them. The camera-frame points are the one exception:
//     fma(z, R2, fma(y, R1, x R0)) + t, the order of the cuBLAS product the
//     plain code runs there. On the card the kernel's poses then equal the
//     eager path's bit for bit, and chip_smoke.py holds them to that on
//     recorded battery and loop-closer inputs;
//   * Huber on or off, its delta, the iterations, lambda0 and the chi2 gate
//     are arguments: the track step, the loop closer and the other
//     trackers call it with their own N and solver configuration;
//   * a sequence reads and writes only its own rows, so a batch gives each
//     sequence the bits it gets alone.

#include <cuda_runtime.h>

#define THREADS 256
#define MAX_PPT 8     // points a thread holds in registers
#define NSUM 43       // H (36), b (6), cost
#define FULL 0xffffffffu

struct PoseArgs {
  const float* cam;     // (B, 9): fx fy cx cy k1 k2 p1 p2 k3, cam_bs apart
  const float* T_in;    // (B, 4, 4)
  const float* pts;     // (B, N, 3) world points
  const float* obs;     // (B, N, 2) observed pixels
  const float* inv_s2;  // (B, N)
  const bool* mask;     // (B, N) the round's weight mask (inliers so far)
  const bool* valid;    // (B, N) the solve's edges, for the gate
  float* T_out;         // (B, 4, 4)
  bool* inliers;        // (B, N)
  float* chi2;          // (B, N)
  float* scratch;       // (B, NSUM, groups * THREADS) when groups > 1
  long long cam_bs;
  int n, p, groups;
  int huber, iters;
  float delta, two_delta, delta_sq, init_lambda, chi2_thr;
};

struct Cam {
  float fx, fy, cx, cy, k1, k2, p1, p2, k3;
};

struct Pt {
  float x, y, z, u, v, s;
  bool m, ok;
};

// A point's terms at one pose: J0, J1 (d pixel / d xi, rows u and v), the
// weight, the residual and the robust cost. J0[1] and J1[0] are zero and
// are not kept. Padding points (i >= N) have every term zero.
struct Terms {
  float j0[5], j1[5], w, r0, r1, cost;
};

__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x != x ? x : (x < lo ? lo : x);   // torch.clamp keeps NaN
}

__device__ __forceinline__ float clamp_max(float x, float hi) {
  return x != x ? x : (x > hi ? hi : x);
}

__device__ __forceinline__ Pt load_point(const PoseArgs& a, int b, int i) {
  Pt q;
  const long long r = (long long)b * a.n + i;
  q.x = a.pts[3 * r];
  q.y = a.pts[3 * r + 1];
  q.z = a.pts[3 * r + 2];
  q.u = a.obs[2 * r];
  q.v = a.obs[2 * r + 1];
  q.s = a.inv_s2[r];
  q.m = a.mask[r];
  q.ok = a.valid[r];
  return q;
}

// se3.transform_points and camera.world2cam: the camera-frame point and
// the residual obs - pixel.
__device__ __forceinline__ void project(const Cam& c, const float* T,
                                        const Pt& q, float& px, float& py,
                                        float& pz, float& r0, float& r1) {
  px = fmaf(q.z, T[2], fmaf(q.y, T[1], q.x * T[0])) + T[3];
  py = fmaf(q.z, T[6], fmaf(q.y, T[5], q.x * T[4])) + T[7];
  pz = fmaf(q.z, T[10], fmaf(q.y, T[9], q.x * T[8])) + T[11];
  const float zs = fabsf(pz) < 1e-8f ? 1e-8f : pz;
  const float x = px / zs, y = py / zs;
  const float r2 = x * x + y * y;
  const float radial = 1.0f + r2 * (c.k1 + r2 * (c.k2 + r2 * c.k3));
  const float xd = (x * radial + ((2.0f * c.p1) * x) * y)
                   + c.p2 * (r2 + (2.0f * x) * x);
  const float yd = (y * radial + c.p1 * (r2 + (2.0f * y) * y))
                   + ((2.0f * c.p2) * x) * y;
  r0 = q.u - (c.fx * xd + c.cx);
  r1 = q.v - (c.fy * yd + c.cy);
}

// solvers/reprojection.py `normal_equations` for one point, up to the
// products.
__device__ __forceinline__ Terms point_terms(const PoseArgs& a, const Cam& c,
                                             const float* T, const Pt& q) {
  Terms o;
  float px, py, pz;
  project(c, T, q, px, py, pz, o.r0, o.r1);
  const bool behind = pz <= 0.05f;
  const float chi2 = (o.r0 * o.r0 + o.r1 * o.r1) * q.s;
  float w = (q.s * (q.m ? 1.0f : 0.0f)) * (behind ? 0.0f : 1.0f);
  const float chi2m = behind ? 0.0f : chi2;
  float rho = chi2m;
  if (a.huber) {
    const float e = sqrtf(clamp_min(chi2, 1e-12f));
    w = w * (e <= a.delta ? 1.0f : (1.0f / e) * a.delta);
    const float em = sqrtf(clamp_min(chi2m, 1e-12f));
    rho = em <= a.delta ? chi2m : a.two_delta * em - a.delta_sq;
  }
  o.w = w;
  o.cost = q.m ? rho : 0.0f;
  // camera.project_jacobian
  const float zs = fabsf(pz) < 1e-8f ? 1e-8f : pz;
  const float zi = 1.0f / zs;
  const float zi2 = zi * zi;
  o.j0[0] = c.fx * zi;
  o.j0[1] = ((-c.fx) * px) * zi2;
  o.j0[2] = (((-c.fx) * px) * py) * zi2;
  o.j0[3] = c.fx * (1.0f + (px * px) * zi2);
  o.j0[4] = ((-c.fx) * py) * zi;
  o.j1[0] = c.fy * zi;
  o.j1[1] = ((-c.fy) * py) * zi2;
  o.j1[2] = (-c.fy) * (1.0f + (py * py) * zi2);
  o.j1[3] = ((c.fy * px) * py) * zi2;
  o.j1[4] = (c.fy * px) * zi;
  return o;
}

__device__ __forceinline__ Terms zero_terms() {
  Terms o;
#pragma unroll
  for (int k = 0; k < 5; ++k) o.j0[k] = o.j1[k] = 0.0f;
  o.w = o.r0 = o.r1 = o.cost = 0.0f;
  return o;
}

// Row u's entry c of the Jacobian (J0[1] is zero), and row v's (J1[0]).
__device__ __forceinline__ float J0(const Terms& t, int c) {
  return c == 0 ? t.j0[0] : c == 1 ? 0.0f : t.j0[c - 1];
}

__device__ __forceinline__ float J1(const Terms& t, int c) {
  return c == 0 ? 0.0f : t.j1[c - 1];
}

// The PPT terms a thread holds, halved in fixed_sum's order.
template <int PPT>
__device__ __forceinline__ float halve(float* x) {
#pragma unroll
  for (int h = PPT / 2; h >= 1; h /= 2) {
#pragma unroll
    for (int k = 0; k < h; ++k) x[k] = x[k] + x[k + h];
  }
  return x[0];
}

// The 43 sums of a thread's PPT points, each written to out[q * stride].
template <int PPT>
__device__ __forceinline__ void thread_sums(const Terms* t, float* out,
                                            int stride) {
  float x[PPT];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float jw0[PPT], jw1[PPT];
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      jw0[k] = J0(t[k], i) * t[k].w;
      jw1[k] = J1(t[k], i) * t[k].w;
    }
#pragma unroll
    for (int j = 0; j < 6; ++j) {
#pragma unroll
      for (int k = 0; k < PPT; ++k)
        x[k] = jw0[k] * J0(t[k], j) + jw1[k] * J1(t[k], j);
      out[(i * 6 + j) * stride] = halve<PPT>(x);
    }
#pragma unroll
    for (int k = 0; k < PPT; ++k) x[k] = jw0[k] * t[k].r0 + jw1[k] * t[k].r1;
    out[(36 + i) * stride] = halve<PPT>(x);
  }
#pragma unroll
  for (int k = 0; k < PPT; ++k) x[k] = t[k].cost;
  out[42 * stride] = halve<PPT>(x);
}

// Halves the NSUM rows of `buf` (row q at buf + q * stride, `from` entries
// each) down to `to` entries, level by level, the block's threads sharing
// each level's adds.
__device__ __forceinline__ void halve_rows(float* buf, int stride, int from,
                                           int to) {
  for (int h = from / 2; h >= to; h /= 2) {
    const int sh = __ffs(h) - 1;
    for (int w = threadIdx.x; w < NSUM * h; w += THREADS) {
      const int q = w >> sh, t = w & (h - 1);
      float* row = buf + q * stride;
      row[t] = row[t] + row[t + h];
    }
    __syncthreads();
  }
}

struct Shared {
  float red[NSUM * THREADS];   // per-thread partial sums, row q at q * THREADS
  float sums[NSUM];
  float T[16];                 // the round's current pose
  float Tn[16];                // the pose a build evaluates
  float H[36], b[6], cost, lam;
};

// (H, b, cost) at the pose `T` (shared), into s.sums; block-wide.
template <int PPT, bool CACHED>
__device__ void build(const PoseArgs& a, const Cam& c, int b, const Pt* pts,
                      const float* Tsh, Shared& s) {
  float T[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) T[k] = Tsh[k];
  const int tid = threadIdx.x;
  Terms t[PPT];
  if constexpr (CACHED) {
#pragma unroll
    for (int k = 0; k < PPT; ++k)
      t[k] = tid + k * THREADS < a.n ? point_terms(a, c, T, pts[k])
                                     : zero_terms();
    thread_sums<PPT>(t, s.red + tid, THREADS);
    __syncthreads();
  } else {
    // virtual thread v = tid + g * THREADS holds points v + k * G * THREADS
    const int vt = a.groups * THREADS;
    float* scr = a.scratch + (long long)b * NSUM * vt;
    for (int g = 0; g < a.groups; ++g) {
      const int v = tid + g * THREADS;
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const int i = v + k * vt;
        t[k] = i < a.n ? point_terms(a, c, T, load_point(a, b, i))
                       : zero_terms();
      }
      thread_sums<PPT>(t, scr + v, vt);
    }
    __syncthreads();
    halve_rows(scr, vt, vt, THREADS);
    for (int w = tid; w < NSUM * THREADS; w += THREADS)
      s.red[w] = scr[(w / THREADS) * vt + (w % THREADS)];
    __syncthreads();
  }
  // the entries left after the in-thread halvings: one a thread, or P of
  // them when P < THREADS
  const int left = a.p < THREADS ? a.p : THREADS;
  halve_rows(s.red, THREADS, left, 32);
  const int lanes = left < 32 ? left : 32;
  const int lane = tid & 31;
  for (int q = tid >> 5; q < NSUM; q += THREADS / 32) {
    float v = lane < lanes ? s.red[q * THREADS + lane] : 0.0f;
    for (int off = lanes / 2; off >= 1; off /= 2)
      v = v + __shfl_down_sync(FULL, v, off);
    if (lane == 0) s.sums[q] = v;
  }
  __syncthreads();
}

// ops/linalg.py cholesky(H + lam I, 1e-12) and cholesky_apply, on one thread.
__device__ void chol6_solve(const float* H, float lam, const float* rhs,
                            float* x) {
  float L[6][6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float s[6];
#pragma unroll
    for (int r = j; r < 6; ++r) s[r] = H[r * 6 + j] + (r == j ? lam : 0.0f);
#pragma unroll
    for (int k = 0; k < j; ++k) {
#pragma unroll
      for (int r = j; r < 6; ++r) s[r] = s[r] - L[r][k] * L[j][k];
    }
    const float d = sqrtf(clamp_min(s[j], 1e-12f));
    L[j][j] = d;
#pragma unroll
    for (int r = j + 1; r < 6; ++r) L[r][j] = s[r] / d;
  }
#pragma unroll
  for (int k = 0; k < 6; ++k) x[k] = rhs[k];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    x[k] = x[k] / L[k][k];
#pragma unroll
    for (int r = k + 1; r < 6; ++r) x[r] = x[r] - L[r][k] * x[k];
  }
#pragma unroll
  for (int k = 5; k >= 0; --k) {
    x[k] = x[k] / L[k][k];
#pragma unroll
    for (int r = 0; r < k; ++r) x[r] = x[r] - L[k][r] * x[k];
  }
}

// small_matmul of (n x m) by (m x l), row-major, the products summed over
// the inner index in order.
template <int N, int M, int L>
__device__ __forceinline__ void matmul(const float* A, const float* B,
                                       float* C) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < L; ++j) {
      float acc = A[i * M] * B[j];
#pragma unroll
      for (int k = 1; k < M; ++k) acc = acc + A[i * M + k] * B[k * L + j];
      C[i * L + j] = acc;
    }
  }
}

// geometry/se3.py exp: (6,) [rho, phi] -> (4, 4).
__device__ void se3_exp(const float* xi, float* E) {
  const float* rho = xi;
  const float* phi = xi + 3;
  const float th2 = (phi[0] * phi[0] + phi[1] * phi[1]) + phi[2] * phi[2];
  const bool small = th2 < 1e-6f;
  float a, b, c;
  if (small) {
    a = 1.0f - th2 * (1.0f / 6.0f);
    b = 0.5f - th2 * (1.0f / 24.0f);
    c = (1.0f / 6.0f) - th2 * (1.0f / 120.0f);
  } else {
    const float t = sqrtf(th2);
    const float sn = sinf(t);
    a = sn / t;
    b = (1.0f - cosf(t)) / th2;
    c = (t - sn) / (th2 * t);
  }
  const float K[9] = {0.0f, -phi[2], phi[1], phi[2], 0.0f, -phi[0],
                      -phi[1], phi[0], 0.0f};
  float KK[9], R[9], V[9], t[3];
  matmul<3, 3, 3>(K, K, KK);
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const float eye = k % 4 == 0 ? 1.0f : 0.0f;
    R[k] = (eye + a * K[k]) + b * KK[k];
    V[k] = (eye + b * K[k]) + c * KK[k];
  }
  matmul<3, 3, 1>(V, rho, t);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) E[i * 4 + j] = R[i * 3 + j];
    E[i * 4 + 3] = t[i];
    E[12 + i] = 0.0f;
  }
  E[15] = 1.0f;
}

// geometry/se3.py normalize: two Newton polar steps on the rotation.
__device__ void se3_normalize(float* T) {
  float R[9], Rt[9], RtR[9], M[9];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) R[i * 3 + j] = T[i * 4 + j];
  }
#pragma unroll
  for (int it = 0; it < 2; ++it) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) Rt[i * 3 + j] = R[j * 3 + i];
    }
    matmul<3, 3, 3>(Rt, R, RtR);
#pragma unroll
    for (int k = 0; k < 9; ++k) M[k] = (k % 4 == 0 ? 3.0f : 0.0f) - RtR[k];
    matmul<3, 3, 3>(R, M, RtR);
#pragma unroll
    for (int k = 0; k < 9; ++k) R[k] = RtR[k] * 0.5f;
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) T[i * 4 + j] = R[i * 3 + j];
    T[12 + i] = 0.0f;
  }
  T[15] = 1.0f;
}

// The round's inlier gate for point i at the final pose: its chi2, and
// valid & (chi2 <= threshold) & (z > 0.05).
__device__ __forceinline__ void gate(const PoseArgs& a, const Cam& c,
                                     const float* T, const Pt& q, int b,
                                     int i) {
  float px, py, pz, r0, r1;
  project(c, T, q, px, py, pz, r0, r1);
  const float chi2 = (r0 * r0 + r1 * r1) * q.s;
  const long long r = (long long)b * a.n + i;
  a.chi2[r] = chi2;
  a.inliers[r] = q.ok && chi2 <= a.chi2_thr && pz > 0.05f;
}

template <int PPT, bool CACHED>
__global__ void __launch_bounds__(THREADS, 1)
    pose_round_kernel(const PoseArgs a) {
  __shared__ Shared s;
  const int b = blockIdx.x, tid = threadIdx.x;
  const float* cp = a.cam + (long long)b * a.cam_bs;
  const Cam c = {cp[0], cp[1], cp[2], cp[3], cp[4],
                 cp[5], cp[6], cp[7], cp[8]};
  Pt pts[CACHED ? PPT : 1];
  if constexpr (CACHED) {
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const int i = tid + k * THREADS;
      if (i < a.n) pts[k] = load_point(a, b, i);
    }
  }
  if (tid < 16) s.T[tid] = a.T_in[(long long)b * 16 + tid];
  __syncthreads();
  build<PPT, CACHED>(a, c, b, pts, s.T, s);
  if (tid == 0) {
#pragma unroll
    for (int k = 0; k < 36; ++k) s.H[k] = s.sums[k];
#pragma unroll
    for (int k = 0; k < 6; ++k) s.b[k] = s.sums[36 + k];
    s.cost = s.sums[42];
    s.lam = a.init_lambda;
  }
  for (int it = 0; it < a.iters; ++it) {
    if (tid == 0) {
      float dx[6], E[16];
      chol6_solve(s.H, s.lam, s.b, dx);
      se3_exp(dx, E);
      matmul<4, 4, 4>(E, s.T, s.Tn);
    }
    __syncthreads();
    build<PPT, CACHED>(a, c, b, pts, s.Tn, s);
    if (tid == 0) {
      const bool accept = s.sums[42] < s.cost;
      if (accept) {
#pragma unroll
        for (int k = 0; k < 16; ++k) s.T[k] = s.Tn[k];
#pragma unroll
        for (int k = 0; k < 36; ++k) s.H[k] = s.sums[k];
#pragma unroll
        for (int k = 0; k < 6; ++k) s.b[k] = s.sums[36 + k];
        s.cost = s.sums[42];
      }
      s.lam = accept ? clamp_min(s.lam * 0.5f, 1e-9f)
                     : clamp_max(s.lam * 4.0f, 1e6f);
    }
  }
  if (tid == 0) {
    se3_normalize(s.T);
#pragma unroll
    for (int k = 0; k < 16; ++k) a.T_out[(long long)b * 16 + k] = s.T[k];
  }
  __syncthreads();
  // the round's gate at the normalized pose
  float T[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) T[k] = s.T[k];
  if constexpr (CACHED) {
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const int i = tid + k * THREADS;
      if (i < a.n) gate(a, c, T, pts[k], b, i);
    }
  } else {
    for (int i = tid; i < a.n; i += THREADS)
      gate(a, c, T, load_point(a, b, i), b, i);
  }
}

template <int PPT, bool CACHED>
static void launch(const PoseArgs& a, int B, cudaStream_t stream) {
  pose_round_kernel<PPT, CACHED><<<B, THREADS, 0, stream>>>(a);
}

extern "C" int pose_round(const float* cam, long long cam_bs,
                          const float* T_in, const float* pts,
                          const float* obs, const float* inv_s2,
                          const bool* mask, const bool* valid, float* T_out,
                          bool* inliers, float* chi2, float* scratch, int B,
                          int n, int huber, float delta, float two_delta,
                          float delta_sq, int iters, float init_lambda,
                          float chi2_thr, void* stream) {
  PoseArgs a;
  a.cam = cam;
  a.cam_bs = cam_bs;
  a.T_in = T_in;
  a.pts = pts;
  a.obs = obs;
  a.inv_s2 = inv_s2;
  a.mask = mask;
  a.valid = valid;
  a.T_out = T_out;
  a.inliers = inliers;
  a.chi2 = chi2;
  a.scratch = scratch;
  a.n = n;
  int p = 1;
  while (p < n) p *= 2;
  a.p = p;
  const int ppt = p > THREADS ? p / THREADS : 1;
  a.groups = ppt > MAX_PPT ? ppt / MAX_PPT : 1;
  a.huber = huber;
  a.delta = delta;
  a.two_delta = two_delta;
  a.delta_sq = delta_sq;
  a.iters = iters;
  a.init_lambda = init_lambda;
  a.chi2_thr = chi2_thr;
  cudaStream_t st = (cudaStream_t)stream;
  switch (ppt) {
    case 1: launch<1, true>(a, B, st); break;
    case 2: launch<2, true>(a, B, st); break;
    case 4: launch<4, true>(a, B, st); break;
    case 8: launch<8, true>(a, B, st); break;
    default:
      if (scratch == nullptr) return (int)cudaErrorInvalidValue;
      launch<MAX_PPT, false>(a, B, st);
  }
  return (int)cudaGetLastError();
}

// Floats of scratch a batch of one sequence needs at N points (0: none).
extern "C" long long pose_scratch_floats(int n) {
  int p = 1;
  while (p < n) p *= 2;
  const int ppt = p > THREADS ? p / THREADS : 1;
  return ppt > MAX_PPT ? (long long)NSUM * (ppt / MAX_PPT) * THREADS : 0;
}
