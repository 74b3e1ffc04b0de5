// The per-frame pose solve for Hopper (sm_90a): motion-only bundle
// adjustment of one SE3 pose against M point and L line observations, the
// whole Levenberg-Marquardt schedule in one launch.  One thread-block
// cluster of C CTAs per solve; a batch of B solves (the batched
// multi-sequence step) is one launch of B clusters.
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
// What bounds it: latency, not bytes or operations.  A 4x10 solve at the
// point cell (M = 2000) needs ~20 M float32 operations and reads ~60 KB,
// 0.3 us at the card's float32 rate; but it is a chain of 40 dependent LM
// steps, each a pass over every observation, a reduction of 28 sums over
// all of them, and a 6x6 solve and exponential map that nothing else can
// overlap.  The time is that chain's latency.  What the design does about it:
//
// 1. One cluster of C CTAs on neighbouring SMs per solve, grid B x C, the
//    cluster dimension (C, 1, 1) set at launch.  A CTA is 8 worker warps
//    (256 threads, a row each) and warp 0, which solves.  C = min(8,
//    ceil((M + L) / 256)): a worker holds one row up to 2,048 rows (8 CTAs
//    at the point cell's M = 2000, 6 and 5 at the point+line and loop
//    cells' 4x10), more above; 8 is the portable cluster size.  Each CTA
//    owns a contiguous share of the point rows and of the line rows.
// 2. Rows staged once: each CTA copies its share (points, observations,
//    information weights, valid flags, line endpoints and coefficients)
//    into shared memory with coalesced loads, and keeps the inlier masks
//    there.  Inside the LM schedule nothing touches global memory; the
//    outputs are written at the end.  Shared memory caps the rows:
//    pose_opt.py::_check_inputs refuses a shape whose share does not fit.
// 3. One pass and one reduction per LM iteration.  The pass at the
//    candidate pose computes err1 and also H, g and the error there (28
//    sums): on accept they are exactly the next iteration's H, g and err0
//    (the same arithmetic at the same pose bits, masks and Huber flag);
//    on reject the kept sums (shared memory) are solved again with lam x 4.
//    Each round starts with one pass at its pose that also does the
//    previous round's gating (the chi2 it needs is the pass's own); one
//    last gating pass counts the inliers.  A solve is rounds x (iters + 1)
//    + 1 passes (45 at 4x10, 19 at 2x8), where the one-block kernel this
//    replaces ran a second pass for err1 after each (88 at 4x10).
//    The reduction: a butterfly reduce-scatter inside each worker warp (31
//    shuffles for 32 slots, lane k ends with slot k), the 8 worker warps
//    in index order (warp 1, after the workers' named barrier), then one
//    cluster barrier, and warp 0 sums the C CTAs' partials pairwise by
//    rank through distributed shared memory.  Every CTA sums in the same
//    order, so all hold the same bits, solve the same 6x6 system to the
//    same candidate and need no broadcast; a rerun, or a solve's position
//    in a batch, gives the same bits.  The partials are double-buffered by
//    the reduction's parity, so one cluster barrier an iteration suffices
//    (a peer reads buffer p before it arrives at the next barrier, and
//    nobody writes p again before that barrier completes).  Which of the
//    equivalent orders this is matters only to chip_smoke.py's ATE
//    checks, which float detail decides (PERF.md §6).
// 4. The serial step, on lane 0 of warp 0 in each CTA: the 6x6 Gaussian
//    elimination with partial pivoting (the first largest |pivot|, as
//    LAPACK's getrf) fully unrolled in registers, its row swaps as
//    selects, back substitution, and the exponential map: ~1.0 us on the
//    card.  Most steps of a solve that has converged are rejected (on
//    chip_smoke.py's seeded problems 81-93% at 4x10 and 52-69% at 2x8, by
//    the plain version).  So while the workers run a pass, lane 0
//    forms the candidate that follows a rejection (the kept sums with
//    lam x 4, at the kept pose); after the reduction a rejected step only
//    copies it, and only an accepted one waits for a solve.  Warp 0
//    arrives at the cluster barrier before that work (it publishes
//    nothing) and waits there after it, so the workers never wait for it.
//    The same step spread over one warp (rows on lanes, pivot search and
//    swaps by shuffles) took ~1.9-2.0 us against one thread's ~1.0 and was
//    dropped.  chip_smoke.py --pose-split prints where an iteration's time
//    goes, from cycle counters built in with POSE_SOLVE_SPLIT=1; PERF.md
//    has the numbers.
// 5. The shared state is one struct behind one pointer (shared_base()),
//    and the barriers and cluster primitives are small functions
//    (worker_barrier, cluster_rank, cluster_arrive, cluster_wait,
//    peer_state): tests/test_torch_pose_solve.py compiles this source for
//    the host with its own versions of those and of the warp shuffles, one
//    host thread per CUDA thread and a shared state per CTA, and holds it
//    to the plain version.
//
// sinf, cosf, sqrtf and divisions are the IEEE ones (no fast math).
// Against the plain version (backend/pose_opt.py::pose_solve_plain) only
// the order of the sums differs, so an accept/reject or gating decision
// can flip where it is decided by the last bits; the result is held to the
// pose contract (1e-3 rad, 5e-3 m, inlier counts within 3).

#ifndef POSE_SOLVE_HOST
#include <cooperative_groups.h>
#include <cuda_runtime.h>

extern __shared__ __align__(16) unsigned char pose_solve_smem[];
#endif

namespace {

constexpr int kWorkers = 256;                // threads that own rows: warps 1..8
constexpr int kWarps = kWorkers / 32;        // worker warps
constexpr int kThreads = kWorkers + 32;      // and warp 0, which solves
constexpr int kMaxCluster = 8;               // the portable cluster size
constexpr int kAcc = 28;                     // H upper (21), g (6), err
constexpr int kErr = 27;
constexpr int kCount = 28;                   // the gating passes' inlier count
constexpr int kSlots = 32;                   // one per lane
constexpr int kHeaderBytes = 4096;           // the Shared struct, rows after it
constexpr int kMaxSharedBytes = 232448;      // 227 KB a block on Hopper
constexpr float kChi2Mono = 5.991f;
constexpr float kChi2Stereo = 7.815f;
constexpr float kSqrtChi2Mono = 2.4476519f;    // float32(sqrt(5.991))
constexpr float kSqrtChi2Stereo = 2.7955322f;  // float32(sqrt(7.815))

struct Cam {
  float fx, fy, cx, cy, bf;
};

// A CTA's shared state; its rows follow at kHeaderBytes.
struct Shared {
  float warp[kWarps][kSlots];   // each worker warp's sums, slot k on lane k
  float part[2][kSlots];        // the CTA's sums by reduction parity (peers read them)
  float keep[kAcc];             // H, g and err at the kept pose
  float R[9], t[3];             // the kept pose
  float R2[9], t2[3];           // the candidate pose
  float Rr[9], tr[3];           // the next candidate should this one be rejected
};
static_assert(sizeof(Shared) <= kHeaderBytes, "Shared outgrew its header");

// CTAs per solve and shared bytes per CTA (the launcher's and
// pose_opt.py's rule).
__host__ __device__ inline int cluster_size(int M, int L) {
  const int c = (M + L + kWorkers - 1) / kWorkers;
  return c < 1 ? 1 : (c > kMaxCluster ? kMaxCluster : c);
}

__host__ __device__ inline int shared_bytes(int M, int L, int C, int rounds, int iters) {
  const int np = (M + C - 1) / C, nl = (L + C - 1) / C;
  return kHeaderBytes + 30 * np + 42 * nl + rounds * iters;
}

#ifndef POSE_SOLVE_HOST
// The CTA's shared state, the workers' barrier, and the cluster
// primitives: this CTA's rank, the cluster barrier in its two halves (a
// thread arrives, then waits for every thread of the cluster to have
// arrived; arrive releases what the thread wrote, wait acquires what the
// others did), and a peer's copy of a shared variable.
__device__ __forceinline__ unsigned char* shared_base() { return pose_solve_smem; }
__device__ __forceinline__ void worker_barrier() { asm volatile("bar.sync 1, %0;" ::"n"(kWorkers) : "memory"); }
__device__ __forceinline__ int cluster_rank() {
  return static_cast<int>(cooperative_groups::this_cluster().block_rank());
}
__device__ __forceinline__ void cluster_arrive() { asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory"); }
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory"); }
template <typename T>
__device__ __forceinline__ T* peer_state(T* p, int rank) {
  return cooperative_groups::this_cluster().map_shared_rank(p, static_cast<unsigned>(rank));
}
#endif

// Where an LM iteration's time goes (built with POSE_SOLVE_SPLIT=1 only):
// cycles of CTA 0's thread 0 (the solving warp, the critical path) in the
// speculative step, the wait at the cluster barrier, the gather from the
// peers, the serial step and the broadcast of the candidate; then of a
// worker (thread 32) in its pass and in its sums up to its arrival; then
// the passes.
constexpr int kSplitSlots = 7;
#ifdef POSE_SOLVE_SPLIT
__device__ unsigned long long g_split[kSplitSlots + 1];
struct Split {
  bool on;
  long long t;
  unsigned long long c[kSplitSlots];
  __device__ void start(int tid) {
    on = blockIdx.x == 0 && threadIdx.x == tid;
    t = clock64();
    for (int k = 0; k < kSplitSlots; ++k) c[k] = 0;
  }
  __device__ void begin() {
    if (on) t = clock64();
  }
  __device__ void mark(int slot) {
    if (on) {
      const long long now = clock64();
      c[slot] += static_cast<unsigned long long>(now - t);
      t = now;
    }
  }
  __device__ void flush(int passes) {
    if (on) {
      for (int k = 0; k < kSplitSlots; ++k) atomicAdd(&g_split[k], c[k]);
      if (threadIdx.x == 0) atomicAdd(&g_split[kSplitSlots], static_cast<unsigned long long>(passes));
    }
  }
};
#else
struct Split {
  __device__ __forceinline__ void start(int) {}
  __device__ __forceinline__ void begin() {}
  __device__ __forceinline__ void mark(int) {}
  __device__ __forceinline__ void flush(int) {}
};
#endif

// This CTA's rows in shared memory.
struct Rows {
  int np, nl;
  float *pts, *obs, *p_info, *ls, *le, *lobs, *l_info;
  unsigned char *p_valid, *p_in, *l_valid, *l_in, *steps;
};

__device__ __forceinline__ Rows carve(unsigned char* base, int np_max, int nl_max, int np, int nl) {
  Rows r;
  r.np = np;
  r.nl = nl;
  float* f = reinterpret_cast<float*>(base + kHeaderBytes);
  r.pts = f;
  f += 3 * np_max;
  r.obs = f;
  f += 3 * np_max;
  r.p_info = f;
  f += np_max;
  r.ls = f;
  f += 3 * nl_max;
  r.le = f;
  f += 3 * nl_max;
  r.lobs = f;
  f += 3 * nl_max;
  r.l_info = f;
  f += nl_max;
  unsigned char* u = reinterpret_cast<unsigned char*>(f);
  r.p_valid = u;
  u += np_max;
  r.p_in = u;
  u += np_max;
  r.l_valid = u;
  u += nl_max;
  r.l_in = u;
  u += nl_max;
  r.steps = u;
  return r;
}

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

// Signed distance of one projected endpoint to the observed line (a, b, c)
// and its row of the Jacobian w.r.t. [rho, phi].
__device__ __forceinline__ float line_endpoint(const Cam& cam, const float* R, const float* t, const float* p,
                                               const float* ln, float* J) {
  float xc[3];
  transform(R, t, p, xc);
  const float z = clamp_depth(xc[2]);
  const float u = cam.fx * xc[0] / z + cam.cx;
  const float v = cam.fy * xc[1] / z + cam.cy;
  const float a = ln[0] * cam.fx / z, b = ln[1] * cam.fy / z;
  const float d[3] = {a, b, -(a * xc[0] + b * xc[1]) / z};
  J[0] = d[0];
  J[1] = d[1];
  J[2] = d[2];
  J[3] = xc[1] * d[2] - xc[2] * d[1];   // cross(xc, d)
  J[4] = xc[2] * d[0] - xc[0] * d[2];
  J[5] = xc[0] * d[1] - xc[1] * d[0];
  return ln[0] * u + ln[1] * v + ln[2];
}

// acc[H upper, g] += w J^T (J, r) for one residual row.
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

// One pass over a worker's rows (points, then lines, kWorkers apart) at
// (R, t), adding H, g and the error into acc.  kGate: first set the masks
// to valid & chi2 <= threshold at this pose, and count the inliers into
// acc[kCount]; kSums false: only that.
template <bool kGate, bool kSums>
__device__ __forceinline__ void pass(const Cam& cam, const Rows& rows, const float* R, const float* t, bool huber,
                                     float* acc) {
  for (int k = threadIdx.x - 32; k < rows.np + rows.nl; k += kWorkers) {
    if (k < rows.np) {
      const int i = k;
      if (!(kGate ? rows.p_valid[i] : rows.p_in[i])) {
        if (kGate) rows.p_in[i] = 0;
        continue;
      }
      const float* o = rows.obs + 3 * i;
      const bool stereo = o[2] > 0.0f;
      float r[3], xc[3], inv_z;
      point_residual(cam, R, t, rows.pts + 3 * i, o, stereo, r, xc, inv_z);
      const float info = rows.p_info[i];
      const float c = (r[0] * r[0] + r[1] * r[1] + r[2] * r[2]) * info;
      if (kGate) {
        const bool in = c <= (stereo ? kChi2Stereo : kChi2Mono);
        rows.p_in[i] = in ? 1 : 0;
        if (!in) continue;
        acc[kCount] += 1.0f;
      }
      if (!kSums) continue;
      const float hw = huber ? huber_weight(c, kChi2Stereo, kSqrtChi2Stereo) : 1.0f;
      const float w = hw * info;
      acc[kErr] += c * hw;
      const float x_z = xc[0] * inv_z, y_z = xc[1] * inv_z;
      const float jx[3][3] = {
          {cam.fx * inv_z, 0.0f, -cam.fx * x_z * inv_z},
          {0.0f, cam.fy * inv_z, -cam.fy * y_z * inv_z},
          {cam.fx * inv_z, 0.0f, (-cam.fx * x_z + cam.bf * inv_z) * inv_z},
      };
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        if (d == 2 && !stereo) continue;
        const float J[6] = {jx[d][0], jx[d][1], jx[d][2],
                            xc[1] * jx[d][2] - xc[2] * jx[d][1],     // cross(xc, jx)
                            xc[2] * jx[d][0] - xc[0] * jx[d][2],
                            xc[0] * jx[d][1] - xc[1] * jx[d][0]};
        accumulate_row(acc, J, r[d], w);
      }
    } else {
      const int l = k - rows.np;
      if (!(kGate ? rows.l_valid[l] : rows.l_in[l])) {
        if (kGate) rows.l_in[l] = 0;
        continue;
      }
      float J0[6], J1[6];
      const float* ln = rows.lobs + 3 * l;
      const float r0 = line_endpoint(cam, R, t, rows.ls + 3 * l, ln, J0);
      const float r1 = line_endpoint(cam, R, t, rows.le + 3 * l, ln, J1);
      const float info = rows.l_info[l];
      const float c = (r0 * r0 + r1 * r1) * info;
      if (kGate) {
        const bool in = c <= kChi2Mono;
        rows.l_in[l] = in ? 1 : 0;
        if (!in) continue;
        acc[kCount] += 1.0f;
      }
      if (!kSums) continue;
      const float w = huber ? huber_weight(c, kChi2Mono, kSqrtChi2Mono) * info : info;
      acc[kErr] += c;
      accumulate_row(acc, J0, r0, w);
      accumulate_row(acc, J1, r1, w);
    }
  }
}

// One step of the butterfly below: lanes exchange half their 2W slots
// with the lane W apart and keep the other half, summed.
template <int W>
__device__ __forceinline__ void butterfly_step(float* v, bool upper) {
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const float send = upper ? v[i] : v[i + W];
    const float kept = upper ? v[i + W] : v[i];
    v[i] = kept + __shfl_xor_sync(0xffffffffu, send, W);
  }
}

// Butterfly reduce-scatter of 32 slots over a warp: returns, on lane k,
// the warp's sum of slot k (31 shuffles; a fixed order of additions).
__device__ __forceinline__ float warp_reduce_scatter(float* v) {
  const int lane = threadIdx.x & 31;
  butterfly_step<16>(v, (lane & 16) != 0);
  butterfly_step<8>(v, (lane & 8) != 0);
  butterfly_step<4>(v, (lane & 4) != 0);
  butterfly_step<2>(v, (lane & 2) != 0);
  butterfly_step<1>(v, (lane & 1) != 0);
  return v[0];
}

// Pairwise sum of 8 values: ((v0 + v1) + (v2 + v3)) + ((v4 + v5) + (v6 + v7)).
__device__ __forceinline__ float pairwise8(const float* v) {
  return ((v[0] + v[1]) + (v[2] + v[3])) + ((v[4] + v[5]) + (v[6] + v[7]));
}

static_assert(kMaxCluster == 8, "pairwise8 sums the ranks' partials");

// The cluster's sum of every worker's 32 slots, in a fixed order: the
// butterfly within each warp, the 8 worker warps in index order, then the
// CTAs' partials pairwise by rank.  A worker adds its slots to the CTA's
// partial (warp 1 sums the worker warps), and arrives at the cluster
// barrier and waits there.
__device__ __forceinline__ void worker_sums(Shared* S, float* acc, int parity) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  S->warp[warp - 1][lane] = warp_reduce_scatter(acc);
  worker_barrier();
  if (warp == 1) {
    float s = S->warp[0][lane];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += S->warp[w][lane];
    S->part[parity][lane] = s;
  }
  cluster_arrive();
  cluster_wait();
}

// Warp 0, having arrived at the cluster barrier: waits there, then returns
// on lane k the cluster's sum of slot k, the same bits in every CTA.
__device__ __forceinline__ float gather(Shared* S, int parity, int C, Split& split) {
  const int lane = threadIdx.x & 31;
  __syncwarp();
  cluster_wait();
  split.mark(1);
  float v[kMaxCluster];
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r) v[r] = r < C ? peer_state(S, r)->part[parity][lane] : 0.0f;
  const float tot = pairwise8(v);   // the absent ranks' zeros add nothing
  split.mark(2);
  return tot;
}

// (dR, dt) = exp(xi), xi = [rho, phi], with the small-angle branches of
// geometry/se3.py (theta^2 < 1e-12, eps = 1e-8); then (R2, t2) = (dR R, dR t + dt).
__device__ __forceinline__ void retract(const float* xi, const float* R, const float* t, float* R2, float* t2) {
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
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) K2[i * 3 + j] = K[i * 3] * K[j] + K[i * 3 + 1] * K[3 + j] + K[i * 3 + 2] * K[6 + j];
  }
  float dR[9], Jl[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const float eye = (k % 4 == 0) ? 1.0f : 0.0f;
    dR[k] = eye + a * K[k] + b * K2[k];
    Jl[k] = eye + b * K[k] + cc * K2[k];
  }
  float dt[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) dt[i] = Jl[i * 3] * xi[0] + Jl[i * 3 + 1] * xi[1] + Jl[i * 3 + 2] * xi[2];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) R2[i * 3 + j] = dR[i * 3] * R[j] + dR[i * 3 + 1] * R[3 + j] + dR[i * 3 + 2] * R[6 + j];
    t2[i] = dR[i * 3] * t[0] + dR[i * 3 + 1] * t[1] + dR[i * 3 + 2] * t[2] + dt[i];
  }
}

// Index of H[i][j], i <= j, among the 21 upper entries (row-major).
__host__ __device__ constexpr int upper(int i, int j) { return i * (11 - i) / 2 + j; }

// A candidate on one thread: xi = -(H + lam diag(H) + 1e-8 I)^-1 g from
// the sums `keep` by Gaussian elimination with partial pivoting on
// [Hd | g] in registers (the first largest |pivot|; the swaps as selects),
// back substitution, then (R2, t2) = exp(xi) (R, t).
__device__ __forceinline__ void candidate(const float* keep, float lam, const float* R, const float* t, float* R2,
                                          float* t2) {
  float A[6][6], b[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = i; j < 6; ++j) {
      A[i][j] = keep[upper(i, j)];
      A[j][i] = A[i][j];
    }
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    A[i][i] = A[i][i] + lam * A[i][i] + 1e-8f;
    b[i] = keep[21 + i];
  }
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    int p = k;
    float best = fabsf(A[k][k]);
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      const float m = fabsf(A[i][k]);
      if (m > best) {
        best = m;
        p = i;
      }
    }
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      const bool swap = p == i;
#pragma unroll
      for (int j = k; j < 6; ++j) {
        const float x = A[k][j], y = A[i][j];
        A[k][j] = swap ? y : x;
        A[i][j] = swap ? x : y;
      }
      const float x = b[k], y = b[i];
      b[k] = swap ? y : x;
      b[i] = swap ? x : y;
    }
    const float inv = 1.0f / A[k][k];
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      const float l = A[i][k] * inv;
#pragma unroll
      for (int j = k + 1; j < 6; ++j) A[i][j] -= l * A[k][j];
      b[i] -= l * b[k];
    }
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
#pragma unroll
    for (int j = i + 1; j < 6; ++j) b[i] -= A[i][j] * b[j];
    b[i] /= A[i][i];
  }
  float xi[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) xi[i] = -b[i];
  retract(xi, R, t, R2, t2);
}

__device__ __forceinline__ void load_pose(const float* sR, const float* st, float* R, float* t) {
#pragma unroll
  for (int k = 0; k < 9; ++k) R[k] = sR[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) t[k] = st[k];
}

__global__ void __launch_bounds__(kThreads) pose_solve_kernel(
    const float* __restrict__ R0, const float* __restrict__ t0, const float* __restrict__ points,
    const float* __restrict__ obs, const float* __restrict__ p_info, const unsigned char* __restrict__ valid,
    const float* __restrict__ line_start, const float* __restrict__ line_end, const float* __restrict__ line_obs,
    const float* __restrict__ l_info, const unsigned char* __restrict__ l_valid, int M, int L, Cam cam, int rounds,
    int iters, float* __restrict__ R_out, float* __restrict__ t_out, unsigned char* __restrict__ p_in,
    unsigned char* __restrict__ l_in, int* __restrict__ n_in, unsigned char* __restrict__ steps, int C) {
  Shared* S = reinterpret_cast<Shared*>(shared_base());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = cluster_rank();
  const long long b = blockIdx.x / C;

  // Stage this CTA's share of the rows.
  const int np_max = (M + C - 1) / C, nl_max = (L + C - 1) / C;
  const int p0 = rank * np_max < M ? rank * np_max : M, l0 = rank * nl_max < L ? rank * nl_max : L;
  const int np = (M - p0 < np_max ? M - p0 : np_max), nl = (L - l0 < nl_max ? L - l0 : nl_max);
  const Rows rows = carve(shared_base(), np_max, nl_max, np, nl);
  {
    const long long pg = b * M + p0, lg = b * L + l0;
    for (int i = tid; i < 3 * np; i += kThreads) {
      rows.pts[i] = points[3 * pg + i];
      rows.obs[i] = obs[3 * pg + i];
    }
    for (int i = tid; i < np; i += kThreads) {
      rows.p_info[i] = p_info[pg + i];
      rows.p_valid[i] = valid[pg + i];
      rows.p_in[i] = valid[pg + i];
    }
    for (int i = tid; i < 3 * nl; i += kThreads) {
      rows.ls[i] = line_start[3 * lg + i];
      rows.le[i] = line_end[3 * lg + i];
      rows.lobs[i] = line_obs[3 * lg + i];
    }
    for (int i = tid; i < nl; i += kThreads) {
      rows.l_info[i] = l_info[lg + i];
      rows.l_valid[i] = l_valid[lg + i];
      rows.l_in[i] = l_valid[lg + i];
    }
    if (tid < 9) S->R[tid] = R0[b * 9 + tid];
    if (tid < 3) S->t[tid] = t0[b * 3 + tid];
  }
  __syncthreads();
  // Warp 0 solves: its lane 0 forms each candidate, and while the workers
  // run a pass it forms the one that follows should the pass's candidate
  // be rejected (the kept sums with lam x 4), so that a rejected step
  // costs no serial step.  It arrives at the cluster barrier before that
  // (it publishes nothing), so the workers never wait for it.  Workers
  // (warps 1..8) run the passes.
  Split split, worker_split;
  split.start(0);
  worker_split.start(32);
  const bool solver = lane == 0 && warp == 0;
  float lam = 1e-3f;   // warp 0's
  int parity = 0;
  float R[9], t[3], acc[kSlots];
  for (int rnd = 0; rnd < rounds; ++rnd) {
    const bool huber = rnd < 2;
    // The round's first pass, at its pose: the previous round's gating,
    // then H, g and err0 under the new masks.
    if (warp > 0) {
      worker_split.begin();
      load_pose(S->R, S->t, R, t);
#pragma unroll
      for (int k = 0; k < kSlots; ++k) acc[k] = 0.0f;
      if (rnd == 0) {
        pass<false, true>(cam, rows, R, t, huber, acc);
      } else {
        pass<true, true>(cam, rows, R, t, huber, acc);
      }
      worker_split.mark(5);
      worker_sums(S, acc, parity);
      worker_split.mark(6);
    } else {
      cluster_arrive();
      split.mark(0);
      const float tot = gather(S, parity, C, split);
      if (lane < kAcc) S->keep[lane] = tot;
      __syncwarp();
      lam = 1e-3f;
      if (solver) candidate(S->keep, lam, S->R, S->t, S->R2, S->t2);
      split.mark(3);
    }
    parity ^= 1;
    __syncthreads();
    split.mark(4);
    for (int it = 0; it < iters; ++it) {
      const bool more = it + 1 < iters;
      if (warp > 0) {
        // One pass at the candidate: err1, and H, g, err0 should it be kept.
        worker_split.begin();
        load_pose(S->R2, S->t2, R, t);
#pragma unroll
        for (int k = 0; k < kSlots; ++k) acc[k] = 0.0f;
        pass<false, true>(cam, rows, R, t, huber, acc);
        worker_split.mark(5);
        worker_sums(S, acc, parity);
        worker_split.mark(6);
      } else {
        cluster_arrive();
        if (solver && more) candidate(S->keep, fminf(fmaxf(lam * 4.0f, 1e-9f), 1e6f), S->R, S->t, S->Rr, S->tr);
        split.mark(0);
        const float tot = gather(S, parity, C, split);
        const bool accept = __shfl_sync(0xffffffffu, tot, kErr) < S->keep[kErr];
        __syncwarp();
        if (accept) {
          if (lane < kAcc) S->keep[lane] = tot;
          if (lane < 9) S->R[lane] = S->R2[lane];
          if (lane < 3) S->t[lane] = S->t2[lane];
        } else if (more) {
          if (lane < 9) S->R2[lane] = S->Rr[lane];
          if (lane < 3) S->t2[lane] = S->tr[lane];
        }
        __syncwarp();
        lam = fminf(fmaxf(accept ? lam * 0.5f : lam * 4.0f, 1e-9f), 1e6f);
        if (lane == 0) rows.steps[rnd * iters + it] = accept ? 1 : 0;
        if (solver && accept && more) candidate(S->keep, lam, S->R, S->t, S->R2, S->t2);
        split.mark(3);
      }
      parity ^= 1;
      __syncthreads();
      split.mark(4);
    }
  }

  // The last round's gating at its pose, and the inlier count.
  float count = 0.0f;
  if (warp > 0) {
    load_pose(S->R, S->t, R, t);
#pragma unroll
    for (int k = 0; k < kSlots; ++k) acc[k] = 0.0f;
    pass<true, false>(cam, rows, R, t, false, acc);
    worker_sums(S, acc, parity);
  } else {
    cluster_arrive();
    count = gather(S, parity, C, split);
  }
  __syncthreads();
  {
    const long long pg = b * M + p0, lg = b * L + l0;
    for (int i = tid; i < np; i += kThreads) p_in[pg + i] = rows.p_in[i];
    for (int i = tid; i < nl; i += kThreads) l_in[lg + i] = rows.l_in[i];
  }
  if (rank == 0) {
    if (tid < 9) R_out[b * 9 + tid] = S->R[tid];
    if (tid < 3) t_out[b * 3 + tid] = S->t[tid];
    if (tid == kCount) n_in[b] = static_cast<int>(count);
    for (int i = tid; i < rounds * iters; i += kThreads) steps[b * rounds * iters + i] = rows.steps[i];
  }
  split.flush(rounds * (iters + 1) + 1);
  worker_split.flush(0);
  // No CTA leaves while a peer may still read its partial sums.
  cluster_arrive();
  cluster_wait();
}

}  // namespace

// B solves, each on contiguous rows: R0 [B, 3, 3], t0 [B, 3], points and
// obs [B, M, 3] (obs = u, v, uR; uR <= 0 marks mono), p_info [B, M], valid
// [B, M] (bool bytes), line_start, line_end and line_obs [B, L, 3] (obs =
// a, b, c with a^2 + b^2 = 1), l_info and l_valid [B, L]; outputs R [B, 3,
// 3], t [B, 3], p_in [B, M], l_in [B, L] (bool bytes), n_in int32 [B],
// steps [B, rounds * iters] (1 where the LM step was accepted).  Launches
// B clusters of cluster_size(M, L) CTAs on `stream`; returns
// cudaErrorInvalidValue where a CTA's rows do not fit in shared memory,
// else the launch's error or cudaGetLastError().  Nothing falls back.
extern "C" int pose_solve_launch(const float* R0, const float* t0, const float* points, const float* obs,
                                 const float* p_info, const unsigned char* valid, const float* line_start,
                                 const float* line_end, const float* line_obs, const float* l_info,
                                 const unsigned char* l_valid, int B, int M, int L, float fx, float fy, float cx,
                                 float cy, float bf, int rounds, int iters, float* R, float* t, unsigned char* p_in,
                                 unsigned char* l_in, int* n_in, unsigned char* steps, void* stream) {
  if (B > 0) {
    const int C = cluster_size(M, L);
    const int bytes = shared_bytes(M, L, C, rounds, iters);
    if (bytes > kMaxSharedBytes) return static_cast<int>(cudaErrorInvalidValue);
    if (bytes > 48 * 1024) {
      const cudaError_t err =
          cudaFuncSetAttribute(pose_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(B * C, 1, 1);
    config.blockDim = dim3(kThreads, 1, 1);
    config.dynamicSmemBytes = bytes;
    config.stream = static_cast<cudaStream_t>(stream);
    config.attrs = attr;
    config.numAttrs = 1;
    const Cam cam{fx, fy, cx, cy, bf};
    const cudaError_t err = cudaLaunchKernelEx(&config, pose_solve_kernel, R0, t0, points, obs, p_info, valid,
                                               line_start, line_end, line_obs, l_info, l_valid, M, L, cam, rounds,
                                               iters, R, t, p_in, l_in, n_in, steps, C);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

#ifdef POSE_SOLVE_SPLIT
// The split counters since the last call (the kSplitSlots cycle counts of
// CTA 0's thread 0, then the passes), reset to 0.
extern "C" int pose_solve_split(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_split, sizeof(g_split));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long zero[kSplitSlots + 1] = {};
  return static_cast<int>(cudaMemcpyToSymbol(g_split, zero, sizeof(zero)));
}
#endif
