// Fused stereo SAD for Hopper (sm_90a): the 11x11 centre-normalised sum
// of absolute differences between a left keypoint's patch and eleven
// windows of the right image (slide -5..+5 px), one warp per keypoint,
// both patches cut straight from the pyramid atlases.  One launch covers
// a batch of stereo pairs: keypoint k of b * n belongs to pair k / n and
// reads that pair's two atlases.
//
// Replaces, together with orb_describe.cu, the TPU kernel
// orb_line_slam_tpu/ops/pallas_patches.py::extract_patch_tiles (body
// _patch_kernel, pallas_call at line 99) on the stereo path, where it was
// launched for the left tiles and again for the right strip
// (orb_line_slam_tpu/frontend/stereo.py:61-87, 153-165).  The plain
// version gathers a whole 32x32 tile on each side to use an 11x11 and a
// 12x22 window of it, and unfolds the strip into [N, 11, 11, 11].  Here:
//
//   left:  rows and columns 10..20 of the keypoint's clamped tile
//          (x0 = clip(x - 15, 0, W - 32), y0 = clip(y - 15, 0, H - 32),
//          so near a border the patch is not centred on the keypoint),
//          minus its centre pixel;
//   right: the clamped tile at (floor(cx), floor(cy)), blended bilinearly
//          with the four weights (1-fy)(1-fx), (1-fy)fx, fy(1-fx), fy fx in
//          that order, rows 10..20 and columns 5..25 of the blend;
//   sad[k] = sum |L - (R[:, k:k+11] - R[5, k+5])|, k = 0..10.
//
// Every product and difference is rounded on its own, as the plain
// version's tensor operations round them; only the order of the 121-term
// sum differs from theirs: a lane sums its elements lane, lane + 32, ... in
// ascending order, then lanes pair off by xor 16, 8, 4, 2, 1.  So the
// result is held to the plain version within 1e-5 relative + 1e-2, and to
// the earlier design of this kernel (one slide at a time, each with its
// own butterfly) bit for bit.
//
// What bounds it: bytes and latency.  A keypoint needs 121 + 264 atlas
// pixels (1.5 KB, scattered over 23 rows) and writes 44 bytes; a point
// cell's 2,000 keypoints are a single wave of warps, so its time is one
// warp's chain of dependent steps plus the launch.  What the design does
// about it:
//   - every atlas load of a keypoint (its four left-window pixels per
//     lane, the window's centre, and the nine pixels per lane of the
//     12 x 22 raw right window under the blend's four taps) is issued
//     before the first is used, right after the keypoint's coordinates;
//   - the raw right window goes to shared memory once and the blend reads
//     its four taps there (w00, w01, w10, w11, each product rounded, in
//     that order), so no pixel is loaded from device memory four times;
//   - the eleven slides' lane partials are independent chains, and they
//     are reduced together: a reduce-scatter over the lanes (16 slots, 11
//     used) halves the slots a lane holds at each of the xor distances 16,
//     8, 4 and 2, then one xor-1 exchange; 16 shuffles where one butterfly
//     per slide took 55 in one dependent line.  Each slot keeps its sum
//     tree: the values that meet at each step are the same partial sums
//     as in a butterfly, and float addition commutes, so the bits are the
//     same;
//   - lanes 0..10 write the eleven sums as one 44-byte row; a warp never
//     waits for another (only __syncwarp).

#ifndef STEREO_SAD_HOST
#include <cuda_runtime.h>
#endif

namespace {

constexpr int kTile = 32;
constexpr int kHalfPatch = 15;
constexpr int kSadW = 5;                       // 11x11 window
constexpr int kSlide = 5;                      // +-5 px
constexpr int kWin = 2 * kSadW + 1;            // 11
constexpr int kOffsets = 2 * kSlide + 1;       // 11
constexpr int kStripW = kWin + 2 * kSlide;     // 21
constexpr int kRawW = kStripW + 1;             // 22: the blend's right taps
constexpr int kRawH = kWin + 1;                // 12: and its lower ones
constexpr int kLeft = kWin * kWin;             // 121
constexpr int kStrip = kWin * kStripW;         // 231
constexpr int kRaw = kRawH * kRawW;            // 264
constexpr int kLeftPerLane = (kLeft + 31) / 32;     // 4
constexpr int kStripPerLane = (kStrip + 31) / 32;   // 8
constexpr int kRawPerLane = (kRaw + 31) / 32;       // 9
constexpr int kSlots = 16;                     // the reduce-scatter's slots: the 11 slides and 5 zeros
constexpr int kWarps = 4;                      // keypoints per block; 1, 2 and 8 measured the same
// Resident blocks an SM must hold: 8 caps a thread at 64 registers, so
// that a batched step's 8,000 warps take two waves (the compiler's own
// choice, 82 registers, gave 20 warps an SM and was slower there; 12 and
// 16 blocks spill: PERF.md).
constexpr int kMinBlocks = 8;
#ifndef STEREO_SAD_SPLIT
#define STEREO_SAD_SPLIT 0
#endif

#ifndef STEREO_SAD_HOST
// The block's shared memory: per warp the raw right window, then the strip.
__device__ __forceinline__ unsigned char* shared_base() {
  __shared__ __align__(16) unsigned char s[kWarps * (kRaw + kStrip) * 4];
  return s;
}
#endif

// Where a warp's time goes (built with -DSTEREO_SAD_SPLIT=1 only): lane
// 0's cycles in each part, summed over the warps; then the keypoints, the
// warps, their cycles and nanoseconds from start to end, and the first
// start and last end on the device's clock (ns).
constexpr int kSplitParts = 4;   // loads landed, blend, slides, reduction and store
constexpr int kSplitSlots = kSplitParts + 6;
#if STEREO_SAD_SPLIT && !defined(STEREO_SAD_HOST)
__device__ unsigned long long g_split[kSplitSlots];
__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
struct Split {
  unsigned long long part[kSplitParts] = {};
  unsigned long long keypoints = 0;
  long long t0 = 0, t = 0, ns0 = 0;
  __device__ void start() {
    t0 = t = clock64();
    ns0 = global_ns();
  }
  __device__ void mark(int slot) {
    __syncwarp();
    const long long now = clock64();
    part[slot] += now - t;
    t = now;
  }
  __device__ void keypoint() { ++keypoints; }
  __device__ void flush(int lane) {
    if (lane != 0) return;
    const long long ns = global_ns();
    for (int i = 0; i < kSplitParts; ++i) atomicAdd(&g_split[i], part[i]);
    atomicAdd(&g_split[kSplitParts], keypoints);
    atomicAdd(&g_split[kSplitParts + 1], 1ull);
    atomicAdd(&g_split[kSplitParts + 2], static_cast<unsigned long long>(clock64() - t0));
    atomicAdd(&g_split[kSplitParts + 3], static_cast<unsigned long long>(ns - ns0));
    atomicMin(&g_split[kSplitParts + 4], static_cast<unsigned long long>(ns0));
    atomicMax(&g_split[kSplitParts + 5], static_cast<unsigned long long>(ns));
  }
};
#else
struct Split {
  __device__ __forceinline__ void start() {}
  __device__ __forceinline__ void mark(int) {}
  __device__ __forceinline__ void keypoint() {}
  __device__ __forceinline__ void flush(int) {}
};
#endif

// A lane that holds slot s after the reduce-scatter: the lane's bits 4,
// 3, 2, 1 (the halves it kept at xor 16, 8, 4, 2) are the slot's bits 3,
// 2, 1, 0.
__device__ __forceinline__ int holder(int s) {
  return ((s >> 3) & 1) << 4 | ((s >> 2) & 1) << 3 | ((s >> 1) & 1) << 2 | (s & 1) << 1;
}

__global__ void __launch_bounds__(32 * kWarps, kMinBlocks) stereo_sad_kernel(
    const float* __restrict__ atlas_l, const int* __restrict__ xy_l, const float* __restrict__ atlas_r,
    const float* __restrict__ cx, const float* __restrict__ cy, int h, int w, int n, int total,
    float* __restrict__ sad) {
  Split split;
  split.start();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* raw = reinterpret_cast<float*>(shared_base()) + warp * (kRaw + kStrip);
  float* strip = raw + kRaw;

  for (int k = blockIdx.x * kWarps + warp; k < total; k += gridDim.x * kWarps) {
    const long long pair = static_cast<long long>(k / n) * h * w;
    const int xl = xy_l[2 * k], yl = xy_l[2 * k + 1];
    const float cxv = cx[k], cyv = cy[k];

    // Left patch: tile rows/columns 10..20; right: the raw 12 x 22 window
    // under the blend of rows 10..20, columns 5..25 of the tile at the
    // floored centre.  Every load issued here, before any is used.
    const int lx0 = min(max(xl - kHalfPatch, 0), w - kTile) + kHalfPatch - kSadW;
    const int ly0 = min(max(yl - kHalfPatch, 0), h - kTile) + kHalfPatch - kSadW;
    const float* pl = atlas_l + pair + static_cast<long long>(ly0) * w + lx0;
    const float xi = floorf(cxv), yi = floorf(cyv);
    const int rx0 = min(max(static_cast<int>(xi) - kHalfPatch, 0), w - kTile) + kHalfPatch - kSadW - kSlide;
    const int ry0 = min(max(static_cast<int>(yi) - kHalfPatch, 0), h - kTile) + kHalfPatch - kSadW;
    const float* pr = atlas_r + pair + static_cast<long long>(ry0) * w + rx0;
    float left[kLeftPerLane], right[kRawPerLane];
#pragma unroll
    for (int i = 0; i < kLeftPerLane; ++i) {
      const int e = lane + 32 * i;
      const int r = e / kWin, c = e - r * kWin;
      left[i] = e < kLeft ? pl[static_cast<long long>(r) * w + c] : 0.0f;
    }
    const float centre = pl[static_cast<long long>(kSadW) * w + kSadW];
#pragma unroll
    for (int i = 0; i < kRawPerLane; ++i) {
      const int e = lane + 32 * i;
      const int r = e / kRawW, c = e - r * kRawW;
      right[i] = e < kRaw ? pr[static_cast<long long>(r) * w + c] : 0.0f;
    }

    const float fx = __fsub_rn(cxv, xi), fy = __fsub_rn(cyv, yi);
    const float gx = __fsub_rn(1.0f, fx), gy = __fsub_rn(1.0f, fy);
    const float w00 = __fmul_rn(gy, gx), w01 = __fmul_rn(gy, fx);
    const float w10 = __fmul_rn(fy, gx), w11 = __fmul_rn(fy, fx);
#pragma unroll
    for (int i = 0; i < kRawPerLane; ++i) {
      const int e = lane + 32 * i;
      if (e < kRaw) raw[e] = right[i];
    }
    __syncwarp();
    split.mark(0);
#pragma unroll
    for (int i = 0; i < kStripPerLane; ++i) {
      const int e = lane + 32 * i;
      if (e < kStrip) {
        const int r = e / kStripW, c = e - r * kStripW;
        const float* q = raw + r * kRawW + c;
        float v = __fmul_rn(w00, q[0]);
        v = __fadd_rn(v, __fmul_rn(w01, q[1]));
        v = __fadd_rn(v, __fmul_rn(w10, q[kRawW]));
        v = __fadd_rn(v, __fmul_rn(w11, q[kRawW + 1]));
        strip[e] = v;
      }
    }
    __syncwarp();
    split.mark(1);

    // The lane's partial of each slide: its elements lane, lane + 32, ...
    // in ascending order, the eleven slides as independent chains.
    float acc[kSlots];
#pragma unroll
    for (int s = 0; s < kSlots; ++s) acc[s] = 0.0f;
#pragma unroll
    for (int i = 0; i < kLeftPerLane; ++i) {
      const int e = lane + 32 * i;
      if (e < kLeft) {
        const int r = e / kWin, c = e - r * kWin;
        const float l = __fsub_rn(left[i], centre);
        const float* row = strip + r * kStripW + c;
#pragma unroll
        for (int s = 0; s < kOffsets; ++s) {
          const float rv = __fsub_rn(row[s], strip[kSadW * kStripW + s + kSadW]);
          acc[s] = __fadd_rn(acc[s], fabsf(__fsub_rn(l, rv)));
        }
      }
    }

    split.mark(2);

    // Reduce-scatter: at distance m a lane keeps the upper half of its
    // slots if its m bit is set, else the lower, and adds its partner's
    // copy of the half it keeps.
#pragma unroll
    for (int m = 16, half = kSlots / 2; m > 1; m >>= 1, half >>= 1) {
      const bool upper = (lane & m) != 0;
#pragma unroll
      for (int j = 0; j < half; ++j) {
        const float send = upper ? acc[j] : acc[j + half];
        const float keep = upper ? acc[j + half] : acc[j];
        acc[j] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, m));
      }
    }
    acc[0] = __fadd_rn(acc[0], __shfl_xor_sync(0xffffffffu, acc[0], 1));
    const float mine = __shfl_sync(0xffffffffu, acc[0], holder(lane < kOffsets ? lane : 0));
    if (lane < kOffsets) sad[static_cast<long long>(k) * kOffsets + lane] = mine;
    split.mark(3);
    split.keypoint();
  }
  split.flush(lane);
}

}  // namespace

// atlas_l, atlas_r: float32 [b, h, w] contiguous; xy_l: int32 [b, n, 2]
// (x, y) left atlas keypoints; cx, cy: float32 [b, n] right centres (atlas
// coordinates); sad: float32 [b, n, 11]; total = b * n.  Launches one
// warp per keypoint on `stream`; returns cudaGetLastError().
extern "C" int stereo_sad_launch(const float* atlas_l, const int* xy_l, const float* atlas_r, const float* cx,
                                 const float* cy, int h, int w, int n, int total, float* sad, void* stream) {
  if (total > 0) {
    stereo_sad_kernel<<<(total + kWarps - 1) / kWarps, 32 * kWarps, 0, static_cast<cudaStream_t>(stream)>>>(
        atlas_l, xy_l, atlas_r, cx, cy, h, w, n, total, sad);
  }
  return static_cast<int>(cudaGetLastError());
}

#if STEREO_SAD_SPLIT
// The split counters since the last call (kSplitSlots of them), reset.
extern "C" int stereo_sad_split(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_split, sizeof(g_split));
  if (err != cudaSuccess) return static_cast<int>(err);
  unsigned long long reset[kSplitSlots] = {};
  reset[kSplitSlots - 2] = ~0ull;              // the first start: a minimum
  return static_cast<int>(cudaMemcpyToSymbol(g_split, reset, sizeof(reset)));
}
#endif
