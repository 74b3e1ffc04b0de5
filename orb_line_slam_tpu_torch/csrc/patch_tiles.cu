// Per-keypoint 32x32 patch-tile gather for Hopper (sm_90a).
//
// Replaces the TPU kernel orb_line_slam_tpu/ops/pallas_patches.py::
// extract_patch_tiles (body _patch_kernel, pallas_call at line 99).  It
// computes what that module's plain gather computes (gather_patch_tiles,
// lines 123-130), bit for bit: tile n holds img[y0 + r, x0 + c] for
// r, c in [0, 32) with x0 = clip(x - 15, 0, W - 32) and
// y0 = clip(y - 15, 0, H - 32), so the keypoint sits at tile (15, 15).
// There is no arithmetic, only a clamped copy.
//
// What bounds it: memory traffic and launch latency.  At the slice's
// KITTI shape (2000 keypoints per launch) it writes 2000 x 4 KB = 8 MB
// and reads as much from a ~8.6 MB pyramid atlas that mostly sits in the
// 50 MB L2, so one launch is a few microseconds of bandwidth and the
// fixed launch cost is of the same order.
//
// What the design does about it: one block per keypoint, 32 x 8
// threads; a warp copies one tile row, so every load and store is one
// coalesced 128-byte row, and each thread moves four rows.  The TPU
// kernel's aligned 40 x 256 superset DMA, lane roll and 8-way row
// select only work around Mosaic's (8, 128) alignment and are not
// carried over.  The stereo path no longer runs this kernel: there the
// same clamped tile is cut into shared memory and consumed in place by
// orb_describe.cu (shift + blur, IC moments, BRIEF) and stereo_sad.cu,
// so that tiles never reach device memory.  This gather stays for the
// single-image extractor, which returns tiles.

#include <cuda_runtime.h>

namespace {

constexpr int kPatch = 32;
constexpr int kRowsPerPass = 8;

__global__ void patch_tiles_kernel(const float* __restrict__ img, int h, int w,
                                   const int* __restrict__ xy,
                                   float* __restrict__ out) {
  const int n = blockIdx.x;
  const int half = kPatch / 2;
  int x0 = xy[2 * n] - (half - 1);
  int y0 = xy[2 * n + 1] - (half - 1);
  x0 = min(max(x0, 0), w - kPatch);
  y0 = min(max(y0, 0), h - kPatch);
  const int c = threadIdx.x;
  float* dst = out + static_cast<long long>(n) * kPatch * kPatch;
  for (int r = threadIdx.y; r < kPatch; r += kRowsPerPass) {
    dst[r * kPatch + c] = img[static_cast<long long>(y0 + r) * w + x0 + c];
  }
}

}  // namespace

// img: float32 [h, w] contiguous; xy: int32 [n, 2] (x, y); out: float32
// [n, 32, 32].  Launches on `stream`; returns cudaGetLastError().
extern "C" int patch_tiles_launch(const float* img, int h, int w,
                                  const int* xy, int n, float* out,
                                  void* stream) {
  if (n > 0) {
    dim3 block(kPatch, kRowsPerPass);
    patch_tiles_kernel<<<n, block, 0, static_cast<cudaStream_t>(stream)>>>(
        img, h, w, xy, out);
  }
  return static_cast<int>(cudaGetLastError());
}
