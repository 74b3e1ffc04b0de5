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
// sum differs (a lane sums elements lane, lane+32, ... in ascending order,
// then a butterfly of shuffles), which is why the result is held to the
// plain version within 1e-5 relative + 1e-2.
//
// What bounds it: bytes and launch latency.  A keypoint needs 121 + 264
// atlas pixels (1.5 KB, scattered over 23 rows) and writes 44 bytes.
// What the design does about it: both windows live in shared memory
// (1.4 KB a warp), a warp never waits for another (only __syncwarp), and
// lanes 0..10 write the eleven sums as one 44-byte row.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;
constexpr int kHalfPatch = 15;
constexpr int kSadW = 5;                       // 11x11 window
constexpr int kSlide = 5;                      // +-5 px
constexpr int kWin = 2 * kSadW + 1;            // 11
constexpr int kOffsets = 2 * kSlide + 1;       // 11
constexpr int kStripW = kWin + 2 * kSlide;     // 21
constexpr int kLeft = kWin * kWin;             // 121
constexpr int kStrip = kWin * kStripW;         // 231
constexpr int kPerLane = (kLeft + 31) / 32;    // 4
constexpr int kWarps = 4;                      // keypoints per block; 1, 2 and 8 measured the same

__global__ void stereo_sad_kernel(const float* __restrict__ atlas_l,
                                  const int* __restrict__ xy_l,
                                  const float* __restrict__ atlas_r,
                                  const float* __restrict__ cx,
                                  const float* __restrict__ cy, int h, int w, int n,
                                  int total, float* __restrict__ sad) {
  __shared__ float s_left[kWarps][kLeft];
  __shared__ float s_strip[kWarps][kStrip];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int k = blockIdx.x * kWarps + warp;
  if (k >= total) return;
  float* left = s_left[warp];
  float* strip = s_strip[warp];
  const long long pair = static_cast<long long>(k / n) * h * w;
  const float* atlas_lb = atlas_l + pair;
  const float* atlas_rb = atlas_r + pair;

  // Left patch: tile rows/columns 10..20, minus the centre (tile (15, 15)).
  {
    const int x0 = min(max(xy_l[2 * k] - kHalfPatch, 0), w - kTile) + kHalfPatch - kSadW;
    const int y0 = min(max(xy_l[2 * k + 1] - kHalfPatch, 0), h - kTile) + kHalfPatch - kSadW;
    const float* p = atlas_lb + static_cast<long long>(y0) * w + x0;
    const float centre = p[static_cast<long long>(kSadW) * w + kSadW];
    for (int e = lane; e < kLeft; e += 32) {
      const int r = e / kWin, c = e - r * kWin;
      left[e] = __fsub_rn(p[static_cast<long long>(r) * w + c], centre);
    }
  }
  // Right strip: blend rows 10..20, columns 5..25 of the tile at the
  // floored centre.
  {
    const float cxv = cx[k], cyv = cy[k];
    const float xi = floorf(cxv), yi = floorf(cyv);
    const float fx = __fsub_rn(cxv, xi), fy = __fsub_rn(cyv, yi);
    const float gx = __fsub_rn(1.0f, fx), gy = __fsub_rn(1.0f, fy);
    const float w00 = __fmul_rn(gy, gx), w01 = __fmul_rn(gy, fx);
    const float w10 = __fmul_rn(fy, gx), w11 = __fmul_rn(fy, fx);
    const int x0 = min(max(static_cast<int>(xi) - kHalfPatch, 0), w - kTile) + kHalfPatch - kSadW - kSlide;
    const int y0 = min(max(static_cast<int>(yi) - kHalfPatch, 0), h - kTile) + kHalfPatch - kSadW;
    const float* p = atlas_rb + static_cast<long long>(y0) * w + x0;
    for (int e = lane; e < kStrip; e += 32) {
      const int r = e / kStripW, c = e - r * kStripW;
      const float* q = p + static_cast<long long>(r) * w + c;
      float v = __fmul_rn(w00, q[0]);
      v = __fadd_rn(v, __fmul_rn(w01, q[1]));
      v = __fadd_rn(v, __fmul_rn(w10, q[w]));
      v = __fadd_rn(v, __fmul_rn(w11, q[w + 1]));
      strip[e] = v;
    }
  }
  __syncwarp();

  int base[kPerLane];     // strip index of this lane's elements at slide 0
  float mine_l[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int e = lane + 32 * i;
    const int r = e / kWin, c = e - r * kWin;
    base[i] = e < kLeft ? r * kStripW + c : -1;
    mine_l[i] = e < kLeft ? left[e] : 0.0f;
  }
  float mine = 0.0f;
  for (int s = 0; s < kOffsets; ++s) {
    const float centre = strip[kSadW * kStripW + s + kSadW];
    float acc = 0.0f;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      if (base[i] >= 0) {
        const float rv = __fsub_rn(strip[base[i] + s], centre);
        acc = __fadd_rn(acc, fabsf(__fsub_rn(mine_l[i], rv)));
      }
    }
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
    if (lane == s) mine = acc;
  }
  if (lane < kOffsets) sad[static_cast<long long>(k) * kOffsets + lane] = mine;
}

}  // namespace

// atlas_l, atlas_r: float32 [b, h, w] contiguous; xy_l: int32 [b, n, 2]
// (x, y) left atlas keypoints; cx, cy: float32 [b, n] right centres (atlas
// coordinates); sad: float32 [b, n, 11]; total = b * n.  Launches on
// `stream`; returns cudaGetLastError().
extern "C" int stereo_sad_launch(const float* atlas_l, const int* xy_l,
                                 const float* atlas_r, const float* cx,
                                 const float* cy, int h, int w, int n, int total,
                                 float* sad, void* stream) {
  if (total > 0) {
    stereo_sad_kernel<<<(total + kWarps - 1) / kWarps, 32 * kWarps, 0, static_cast<cudaStream_t>(stream)>>>(
        atlas_l, xy_l, atlas_r, cx, cy, h, w, n, total, sad);
  }
  return static_cast<int>(cudaGetLastError());
}
