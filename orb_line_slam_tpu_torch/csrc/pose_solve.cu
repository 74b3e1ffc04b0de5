// The per-frame pose solve for Hopper (sm_90a): motion-only bundle
// adjustment of one SE3 pose against M point and L line observations, the
// whole Levenberg-Marquardt schedule in one launch.  One thread block per
// solve; a batch of B solves (the batched multi-sequence step) is one
// launch of B blocks.
//
// Replaces orb_line_slam_tpu/backend/pose_opt.py::pose_optimize (jitted
// at :54-57, the LM scan body :93-138, the gating :146-152), which on the
// TPU is one XLA program with static iteration counts.  It computes:
//
//   for each of `rounds` rounds (Huber on rounds 0 and 1 only):
//     lam = 1e-3
//     `iters` times:
//       point i (p_in): r = (u - u_obs, v - v_obs, uR - uR_obs), the third
//         row 0 for mono (uR_obs <= 0), depth clamped |z| < 1e-9 -> 1e-9;
//         c = |r|^2 info_i, w = huber(c, 7.815) info_i (info_i on rounds 2+)
//       line l (l_in): r = the two endpoints' signed distances a u + b v + c
//         to the observed line, c = |r|^2 info_l, w = huber(c, 5.991) info_l
//       H = sum w J^T J, g = sum w J^T r (J w.r.t. the left tangent [rho, phi])
//       err0 = sum_points c huber(c) + sum_lines c      (lines unweighted)
//       xi = -(H + lam diag(H) + 1e-8 I)^-1 g   (float32 LU, partial pivoting)
//       (R2, t2) = exp(xi) * (R, t); err1 as err0 at (R2, t2)
//       err1 < err0: accept, lam *= 0.5; else lam *= 4; lam in [1e-9, 1e6]
//     p_in = valid & c <= (stereo ? 7.815 : 5.991); l_in = l_valid & c <= 5.991
//   n_in = |p_in| + |l_in|
//
// Each thread walks the observations with a stride of the block size and
// keeps its partial sums of the 21 upper entries of H, the 6 of g and err0
// in registers; the block reduces them in a fixed order (shuffles within a
// warp, then the warps in index order), so a rerun gives the same bits.
// Thread 0 solves the 6x6 system and forms the candidate pose; a second
// pass over the observations gives err1.  The inlier masks live in the
// output arrays between rounds: each thread reads and writes only its own
// rows.  sinf, cosf, sqrtf and divisions are the IEEE ones (no fast math).
// Against the plain version (backend/pose_opt.py::pose_solve_plain) only
// the order of the sums differs, so an accept/reject or gating decision
// can flip where it is decided by the last bits; the result is held to the
// pose contract (1e-3 rad, 5e-3 m, inlier counts within 3).
//
// What bounds it: latency, not bytes or operations.  A solve reads its
// observations (~28 bytes a point) once per pass, 2 passes per iteration,
// and each iteration waits on two block reductions and one thread's 6x6
// solve and exponential map.  What the design does about it: the whole
// schedule stays on the device in one launch (the plain version launches
// ~290 kernels an iteration), and a batch of solves runs one block each.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kAcc = 28;            // H upper (21), g (6), err0
constexpr float kChi2Mono = 5.991f;
constexpr float kChi2Stereo = 7.815f;
constexpr float kSqrtChi2Mono = 2.4476519f;    // float32(sqrt(5.991))
constexpr float kSqrtChi2Stereo = 2.7955322f;  // float32(sqrt(7.815))

struct Cam {
  float fx, fy, cx, cy, bf;
};

// IRLS weight of the Huber kernel: 1 inside delta, delta / |e| outside.
__device__ __forceinline__ float huber_weight(float chi2, float delta2, float delta) {
  const float e = sqrtf(fmaxf(chi2, 1e-12f));
  return chi2 <= delta2 ? 1.0f : (1.0f / e) * delta;
}

__device__ __forceinline__ void transform(const float* R, const float* t, const float* p, float* xc) {
  xc[0] = R[0] * p[0] + R[1] * p[1] + R[2] * p[2] + t[0];
  xc[1] = R[3] * p[0] + R[4] * p[1] + R[5] * p[2] + t[1];
  xc[2] = R[6] * p[0] + R[7] * p[1] + R[8] * p[2] + t[2];
}

__device__ __forceinline__ float clamp_depth(float z) { return fabsf(z) < 1e-9f ? 1e-9f : z; }

// Point residual (du, dv, duR) at (R, t); duR = 0 for mono.  Returns its
// camera-frame point in xc and 1 / z in inv_z.
__device__ __forceinline__ void point_residual(const Cam& cam, const float* R, const float* t, const float* p,
                                               const float* o, bool stereo, float* r, float* xc, float& inv_z) {
  transform(R, t, p, xc);
  inv_z = 1.0f / clamp_depth(xc[2]);
  const float u = cam.fx * xc[0] * inv_z + cam.cx;
  const float v = cam.fy * xc[1] * inv_z + cam.cy;
  r[0] = u - o[0];
  r[1] = v - o[1];
  r[2] = stereo ? (u - cam.bf * inv_z) - o[2] : 0.0f;
}

// Signed distance of one projected endpoint to the observed line (a, b, c);
// with J != nullptr also its row of the Jacobian w.r.t. [rho, phi].
__device__ __forceinline__ float line_endpoint(const Cam& cam, const float* R, const float* t, const float* p,
                                               const float* ln, float* J) {
  float xc[3];
  transform(R, t, p, xc);
  const float z = clamp_depth(xc[2]);
  const float u = cam.fx * xc[0] / z + cam.cx;
  const float v = cam.fy * xc[1] / z + cam.cy;
  if (J != nullptr) {
    const float a = ln[0] * cam.fx / z, b = ln[1] * cam.fy / z;
    const float d[3] = {a, b, -(a * xc[0] + b * xc[1]) / z};
    J[0] = d[0];
    J[1] = d[1];
    J[2] = d[2];
    J[3] = xc[1] * d[2] - xc[2] * d[1];   // cross(xc, d)
    J[4] = xc[2] * d[0] - xc[0] * d[2];
    J[5] = xc[0] * d[1] - xc[1] * d[0];
  }
  return ln[0] * u + ln[1] * v + ln[2];
}

// acc[H upper, g, err] += w J^T (J, r) for one residual row.
__device__ __forceinline__ void accumulate_row(float* acc, const float* J, float r, float w) {
  float wj[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) wj[i] = J[i] * w;
  int k = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = i; j < 6; ++j) acc[k++] += wj[i] * J[j];
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) acc[21 + i] += wj[i] * r;
}

// Sum of each of N per-thread values over the block, in a fixed order:
// a shuffle tree inside each warp, then the warps' sums in warp order.
// Every thread must call it; out[] (shared) holds the N sums afterwards.
template <int N, typename T>
__device__ __forceinline__ void block_sum(T* v, T* scratch, T* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < N; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v[k] += __shfl_down_sync(0xffffffffu, v[k], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) scratch[warp * N + k] = v[k];
  }
  __syncthreads();
  if (threadIdx.x < N) {
    T s = scratch[threadIdx.x];
    for (int w = 1; w < kWarps; ++w) s += scratch[w * N + threadIdx.x];
    out[threadIdx.x] = s;
  }
  __syncthreads();
}

// x = A^-1 b for a 6x6 A (row-major, overwritten): LU with partial
// pivoting (the first largest |pivot|, as LAPACK's getrf), then forward
// and back substitution.
__device__ void solve6(float* A, float* b) {
  for (int k = 0; k < 6; ++k) {
    int p = k;
    float best = fabsf(A[k * 6 + k]);
    for (int i = k + 1; i < 6; ++i) {
      const float m = fabsf(A[i * 6 + k]);
      if (m > best) {
        best = m;
        p = i;
      }
    }
    if (p != k) {
      for (int j = 0; j < 6; ++j) {
        const float s = A[k * 6 + j];
        A[k * 6 + j] = A[p * 6 + j];
        A[p * 6 + j] = s;
      }
      const float s = b[k];
      b[k] = b[p];
      b[p] = s;
    }
    const float inv = 1.0f / A[k * 6 + k];
    for (int i = k + 1; i < 6; ++i) {
      const float l = A[i * 6 + k] * inv;
      A[i * 6 + k] = l;
      for (int j = k + 1; j < 6; ++j) A[i * 6 + j] -= l * A[k * 6 + j];
    }
  }
  for (int i = 1; i < 6; ++i) {
    for (int j = 0; j < i; ++j) b[i] -= A[i * 6 + j] * b[j];
  }
  for (int i = 5; i >= 0; --i) {
    for (int j = i + 1; j < 6; ++j) b[i] -= A[i * 6 + j] * b[j];
    b[i] /= A[i * 6 + i];
  }
}

// (dR, dt) = exp(xi), xi = [rho, phi], with the small-angle branches of
// geometry/se3.py (theta^2 < 1e-12, eps = 1e-8); then (R2, t2) = (dR R, dR t + dt).
__device__ void retract(const float* xi, const float* R, const float* t, float* R2, float* t2) {
  const float p0 = xi[3], p1 = xi[4], p2 = xi[5];
  const float theta2 = p0 * p0 + p1 * p1 + p2 * p2;
  const float theta = sqrtf(theta2 + 1e-16f);
  const bool small = theta2 < 1e-12f;
  const float t2c = fmaxf(theta2, 1e-16f);
  const float s = sinf(theta), c = cosf(theta);
  const float a = small ? 1.0f - theta2 / 6.0f : s / theta;
  const float b = small ? 0.5f - theta2 / 24.0f : (1.0f - c) / t2c;
  const float cc = small ? 1.0f / 6.0f - theta2 / 120.0f : (theta - s) / (t2c * theta);
  const float K[9] = {0.0f, -p2, p1, p2, 0.0f, -p0, -p1, p0, 0.0f};
  float K2[9];
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) K2[i * 3 + j] = K[i * 3] * K[j] + K[i * 3 + 1] * K[3 + j] + K[i * 3 + 2] * K[6 + j];
  }
  float dR[9], Jl[9];
  for (int k = 0; k < 9; ++k) {
    const float eye = (k % 4 == 0) ? 1.0f : 0.0f;
    dR[k] = eye + a * K[k] + b * K2[k];
    Jl[k] = eye + b * K[k] + cc * K2[k];
  }
  float dt[3];
  for (int i = 0; i < 3; ++i) dt[i] = Jl[i * 3] * xi[0] + Jl[i * 3 + 1] * xi[1] + Jl[i * 3 + 2] * xi[2];
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) R2[i * 3 + j] = dR[i * 3] * R[j] + dR[i * 3 + 1] * R[3 + j] + dR[i * 3 + 2] * R[6 + j];
    t2[i] = dR[i * 3] * t[0] + dR[i * 3 + 1] * t[1] + dR[i * 3 + 2] * t[2] + dt[i];
  }
}

__global__ void __launch_bounds__(kThreads) pose_solve_kernel(
    const float* __restrict__ R0, const float* __restrict__ t0, const float* __restrict__ points,
    const float* __restrict__ obs, const float* __restrict__ p_info, const unsigned char* __restrict__ valid,
    const float* __restrict__ line_start, const float* __restrict__ line_end, const float* __restrict__ line_obs,
    const float* __restrict__ l_info, const unsigned char* __restrict__ l_valid, int M, int L, Cam cam, int rounds,
    int iters, float* __restrict__ R_out, float* __restrict__ t_out, unsigned char* __restrict__ p_in,
    unsigned char* __restrict__ l_in, int* __restrict__ n_in, unsigned char* __restrict__ steps) {
  __shared__ float s_R[9], s_t[3], s_R2[9], s_t2[3];
  __shared__ float s_scratch[kWarps * kAcc];
  __shared__ float s_sum[kAcc];
  __shared__ int s_iscratch[kWarps];
  __shared__ int s_isum[1];

  const int tid = threadIdx.x;
  const long long b = blockIdx.x;
  points += b * M * 3;
  obs += b * M * 3;
  p_info += b * M;
  valid += b * M;
  p_in += b * M;
  line_start += b * L * 3;
  line_end += b * L * 3;
  line_obs += b * L * 3;
  l_info += b * L;
  l_valid += b * L;
  l_in += b * L;
  steps += b * rounds * iters;

  if (tid < 9) s_R[tid] = R0[b * 9 + tid];
  if (tid < 3) s_t[tid] = t0[b * 3 + tid];
  for (int i = tid; i < M; i += kThreads) p_in[i] = valid[i];
  for (int l = tid; l < L; l += kThreads) l_in[l] = l_valid[l];
  __syncthreads();

  float lam = 1e-3f;   // thread 0's
  for (int rnd = 0; rnd < rounds; ++rnd) {
    const bool huber = rnd < 2;
    lam = 1e-3f;
    for (int it = 0; it < iters; ++it) {
      float R[9], t[3];
#pragma unroll
      for (int k = 0; k < 9; ++k) R[k] = s_R[k];
#pragma unroll
      for (int k = 0; k < 3; ++k) t[k] = s_t[k];

      // Pass 1: H, g and err0 at (R, t).
      float acc[kAcc];
#pragma unroll
      for (int k = 0; k < kAcc; ++k) acc[k] = 0.0f;
      for (int i = tid; i < M; i += kThreads) {
        if (!p_in[i]) continue;
        const float* p = points + 3 * i;
        const float* o = obs + 3 * i;
        const bool stereo = o[2] > 0.0f;
        float r[3], xc[3], inv_z;
        point_residual(cam, R, t, p, o, stereo, r, xc, inv_z);
        const float info = p_info[i];
        const float c = (r[0] * r[0] + r[1] * r[1] + r[2] * r[2]) * info;
        const float hw = huber ? huber_weight(c, kChi2Stereo, kSqrtChi2Stereo) : 1.0f;
        const float w = hw * info;
        acc[27] += c * hw;
        const float x_z = xc[0] * inv_z, y_z = xc[1] * inv_z;
        const float jx[3][3] = {
            {cam.fx * inv_z, 0.0f, -cam.fx * x_z * inv_z},
            {0.0f, cam.fy * inv_z, -cam.fy * y_z * inv_z},
            {cam.fx * inv_z, 0.0f, (-cam.fx * x_z + cam.bf * inv_z) * inv_z},
        };
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          if (d == 2 && !stereo) break;
          const float J[6] = {jx[d][0], jx[d][1], jx[d][2],
                              xc[1] * jx[d][2] - xc[2] * jx[d][1],     // cross(xc, jx)
                              xc[2] * jx[d][0] - xc[0] * jx[d][2],
                              xc[0] * jx[d][1] - xc[1] * jx[d][0]};
          accumulate_row(acc, J, r[d], w);
        }
      }
      for (int l = tid; l < L; l += kThreads) {
        if (!l_in[l]) continue;
        float J0[6], J1[6];
        const float* ln = line_obs + 3 * l;
        const float r0 = line_endpoint(cam, R, t, line_start + 3 * l, ln, J0);
        const float r1 = line_endpoint(cam, R, t, line_end + 3 * l, ln, J1);
        const float info = l_info[l];
        const float c = (r0 * r0 + r1 * r1) * info;
        const float w = huber ? huber_weight(c, kChi2Mono, kSqrtChi2Mono) * info : info;
        acc[27] += c;
        accumulate_row(acc, J0, r0, w);
        accumulate_row(acc, J1, r1, w);
      }
      block_sum<kAcc>(acc, s_scratch, s_sum);

      // Thread 0: the damped step and the candidate pose.
      if (tid == 0) {
        float H[36], g[6];
        int k = 0;
        for (int i = 0; i < 6; ++i) {
          for (int j = i; j < 6; ++j) {
            H[i * 6 + j] = s_sum[k];
            H[j * 6 + i] = s_sum[k];
            ++k;
          }
        }
        for (int i = 0; i < 6; ++i) {
          H[i * 6 + i] = H[i * 6 + i] + lam * H[i * 6 + i] + 1e-8f;
          g[i] = s_sum[21 + i];
        }
        solve6(H, g);
        float xi[6];
        for (int i = 0; i < 6; ++i) xi[i] = -g[i];
        retract(xi, s_R, s_t, s_R2, s_t2);
      }
      __syncthreads();

      // Pass 2: err1 at the candidate pose.
      float R2[9], t2[3];
#pragma unroll
      for (int k = 0; k < 9; ++k) R2[k] = s_R2[k];
#pragma unroll
      for (int k = 0; k < 3; ++k) t2[k] = s_t2[k];
      float err1[1] = {0.0f};
      for (int i = tid; i < M; i += kThreads) {
        if (!p_in[i]) continue;
        const float* o = obs + 3 * i;
        float r[3], xc[3], inv_z;
        point_residual(cam, R2, t2, points + 3 * i, o, o[2] > 0.0f, r, xc, inv_z);
        const float c = (r[0] * r[0] + r[1] * r[1] + r[2] * r[2]) * p_info[i];
        err1[0] += huber ? c * huber_weight(c, kChi2Stereo, kSqrtChi2Stereo) : c;
      }
      for (int l = tid; l < L; l += kThreads) {
        if (!l_in[l]) continue;
        const float* ln = line_obs + 3 * l;
        const float r0 = line_endpoint(cam, R2, t2, line_start + 3 * l, ln, nullptr);
        const float r1 = line_endpoint(cam, R2, t2, line_end + 3 * l, ln, nullptr);
        err1[0] += (r0 * r0 + r1 * r1) * l_info[l];
      }
      block_sum<1>(err1, s_scratch, s_sum);   // writes s_sum[0]; err0 stays in s_sum[27]

      if (tid == 0) {
        const bool accept = s_sum[0] < s_sum[27];
        if (accept) {
          for (int k = 0; k < 9; ++k) s_R[k] = s_R2[k];
          for (int k = 0; k < 3; ++k) s_t[k] = s_t2[k];
        }
        lam = fminf(fmaxf(accept ? lam * 0.5f : lam * 4.0f, 1e-9f), 1e6f);
        steps[rnd * iters + it] = accept ? 1 : 0;
      }
      __syncthreads();
    }

    // Gating at the round's pose.
    float R[9], t[3];
#pragma unroll
    for (int k = 0; k < 9; ++k) R[k] = s_R[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) t[k] = s_t[k];
    for (int i = tid; i < M; i += kThreads) {
      const float* o = obs + 3 * i;
      const bool stereo = o[2] > 0.0f;
      float r[3], xc[3], inv_z;
      point_residual(cam, R, t, points + 3 * i, o, stereo, r, xc, inv_z);
      const float c = (r[0] * r[0] + r[1] * r[1] + r[2] * r[2]) * p_info[i];
      p_in[i] = (valid[i] && c <= (stereo ? kChi2Stereo : kChi2Mono)) ? 1 : 0;
    }
    for (int l = tid; l < L; l += kThreads) {
      const float* ln = line_obs + 3 * l;
      const float r0 = line_endpoint(cam, R, t, line_start + 3 * l, ln, nullptr);
      const float r1 = line_endpoint(cam, R, t, line_end + 3 * l, ln, nullptr);
      l_in[l] = (l_valid[l] && (r0 * r0 + r1 * r1) * l_info[l] <= kChi2Mono) ? 1 : 0;
    }
    __syncthreads();
  }

  int count[1] = {0};
  for (int i = tid; i < M; i += kThreads) count[0] += p_in[i];
  for (int l = tid; l < L; l += kThreads) count[0] += l_in[l];
  block_sum<1>(count, s_iscratch, s_isum);
  if (tid < 9) R_out[b * 9 + tid] = s_R[tid];
  if (tid < 3) t_out[b * 3 + tid] = s_t[tid];
  if (tid == 0) n_in[b] = s_isum[0];
}

}  // namespace

// B solves, each on contiguous rows: R0 [B, 3, 3], t0 [B, 3], points and
// obs [B, M, 3] (obs = u, v, uR; uR <= 0 marks mono), p_info [B, M], valid
// [B, M] (bool bytes), line_start, line_end and line_obs [B, L, 3] (obs =
// a, b, c with a^2 + b^2 = 1), l_info and l_valid [B, L]; outputs R [B, 3,
// 3], t [B, 3], p_in [B, M], l_in [B, L] (bool bytes), n_in int32 [B],
// steps [B, rounds * iters] (1 where the LM step was accepted).  Launches
// B blocks on `stream`; returns cudaGetLastError().
extern "C" int pose_solve_launch(const float* R0, const float* t0, const float* points, const float* obs,
                                 const float* p_info, const unsigned char* valid, const float* line_start,
                                 const float* line_end, const float* line_obs, const float* l_info,
                                 const unsigned char* l_valid, int B, int M, int L, float fx, float fy, float cx,
                                 float cy, float bf, int rounds, int iters, float* R, float* t, unsigned char* p_in,
                                 unsigned char* l_in, int* n_in, unsigned char* steps, void* stream) {
  if (B > 0) {
    const Cam cam{fx, fy, cx, cy, bf};
    pose_solve_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        R0, t0, points, obs, p_info, valid, line_start, line_end, line_obs, l_info, l_valid, M, L, cam, rounds,
        iters, R, t, p_in, l_in, n_in, steps);
  }
  return static_cast<int>(cudaGetLastError());
}
