// Fused ORB describe for Hopper (sm_90a): clamped 32x32 tile -> sub-pixel
// shift + Gaussian blur -> intensity-centroid angle -> rotated BRIEF-256,
// one block per keypoint, the tile never leaving shared memory.
//
// Replaces, together with stereo_sad.cu, the TPU kernel
// orb_line_slam_tpu/ops/pallas_patches.py::extract_patch_tiles (body
// _patch_kernel, pallas_call at line 99) on the stereo path.  That kernel
// wrote one 4 KB tile per keypoint to device memory because Mosaic could
// not gather inside the consumers; plain tensor code then read the tiles
// back many times (six batched 32x32 products, two int64 copies, three
// moment sums, a 512-sample gather).  Here a block cuts the tile exactly
// as patch_tiles.cu addresses it (x0 = clip(x - 15, 0, W - 32),
// y0 = clip(y - 15, 0, H - 32)) and computes what the plain composition
// patch tiles -> shift_blur_tiles -> ic_angle_from_tiles ->
// brief_descriptors_from_tiles computes:
//
//   rows:    ty = wmy (Am T) + w0y (A0 T) + wpy (Ap T)
//   columns: tb = wmx (ty Am^T) + w0x (ty A0^T) + wpx (ty Ap^T)
//   q = round(16 tb) (half to even); m10, m01, m00 = exact integer moments
//   of q over the radius-15 disk; angle = atan2(m01, m10), 0 when the
//   centroid offset is below 0.5 px; bin = round(angle / 12 deg) mod 30;
//   bit k = q[p2_k(bin)] > q[p1_k(bin)], packed LSB first.
//
// Am, A0, Ap are the three static matrices of the plain version (the
// row-normalised zero-padded 7-tap Gaussian composed with the edge-clamped
// one-pixel shifts); row i is nonzero only in columns i-4..i+4, so they
// arrive as bands, row by row: [32][28] floats, the 27 coefficients of
// row i (matrix-major, offsets -4..+4) and one of padding.  Each product
// is a float32 dot product taken with fused multiply-adds in ascending
// column order; the weighted sums round every product and sum separately,
// as three tensor operations do.  Everything after the blurred tile is
// integer arithmetic or a single correctly rounded float operation, so
// equal blurred tiles give equal angles and descriptors.  (On an H100
// with CUDA 12.8 that order reproduces the library's batched products bit
// for bit; the library promises no order, so the kernel is held to the
// plain version by a tolerance.)
//
// What bounds it: bytes, narrowly.  The function needs the atlas pixels
// under some tile once and 36 bytes written per keypoint; its arithmetic
// could be one combined 9-tap band per axis (~20,000 multiply-adds per
// keypoint), which the card's float32 rate does in less time than the
// bytes take.  The kernel does ~2.4 times that arithmetic, because it keeps
// the plain version's three products per axis and their separate roundings
// so as to agree with it bit for bit, and runs well above the bound.  What the
// design does about it: the tile, the row-blurred tile (odd pitch, so
// that the column pass reads it transposed without bank conflicts) and
// the quantised tile stay in shared memory (~18 KB a block).  Instruction
// issue and shared-memory loads are the limit, not HBM: a row of 32
// outputs needs 9 tile loads, 27 coefficients and 27 multiply-adds.  So
// the coefficients of a row are fetched as seven 16-byte broadcast loads
// into registers, a warp takes two adjacent rows at a time (ten tile loads
// for both), and the tile carries four rows or columns of zeros on each
// side, so that no tap needs a range check (their coefficients are zero
// too, and a multiply-add of 0 x 0 leaves the sum as it is).  Moments by
// warp shuffles; descriptor bits by __ballot_sync, one 32-bit word per
// warp pass.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;
constexpr int kPitch = 33;
constexpr int kTaps = 9;            // band offsets -4..+4
constexpr int kPad = 4;             // zero rows / columns around a tile, so that no tap is out of range
constexpr int kPitchRows = kTile + 2 * kPad + 1;   // 41: odd, so a transposed read has no bank conflict
constexpr int kRowQuads = 7;        // 3 * 9 coefficients of a row + 1 pad, as float4
constexpr int kBins = 30;
constexpr int kThreads = 128;      // four warps per keypoint: 32, 64 and 256 threads measured slower
constexpr int kWarps = kThreads / 32;
constexpr int kHalfPatch = 15;
constexpr float kFixedScale = 16.0f;
constexpr float kIcMinOffsetPx = 0.5f;

// wm * a + w0 * b + wp * c as three tensor operations round it.
__device__ __forceinline__ float weighted3(float wm, float a, float w0, float b,
                                           float wp, float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(wm, a), __fmul_rn(w0, b)), __fmul_rn(wp, c));
}

// The 27 band coefficients of row i: cf[m * 9 + o] = A_m[i][i - 4 + o].
__device__ __forceinline__ void load_row(const float4* s_band, int i, float (&cf)[4 * kRowQuads]) {
#pragma unroll
  for (int q = 0; q < kRowQuads; ++q) {
    const float4 v = s_band[i * kRowQuads + q];
    cf[4 * q] = v.x;
    cf[4 * q + 1] = v.y;
    cf[4 * q + 2] = v.z;
    cf[4 * q + 3] = v.w;
  }
}

// One output of a blur pass: the three banded dot products of row i with
// the taps t[0..8] (columns i-4..i+4, zero where out of range, as their
// coefficients are), in ascending order, and their weighted sum.
__device__ __forceinline__ float blur3(const float4* s_band, int i, const float* t,
                                       float wm, float w0, float wp) {
  float cf[4 * kRowQuads];
  load_row(s_band, i, cf);
  float am = 0.0f, a0 = 0.0f, ap = 0.0f;
#pragma unroll
  for (int o = 0; o < kTaps; ++o) {
    am = fmaf(cf[o], t[o], am);
    a0 = fmaf(cf[kTaps + o], t[o], a0);
    ap = fmaf(cf[2 * kTaps + o], t[o], ap);
  }
  return weighted3(wm, am, w0, a0, wp, ap);
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
  return v;
}

__global__ void orb_describe_kernel(const float* __restrict__ atlas, int h, int w,
                                    const int* __restrict__ xy,
                                    const float* __restrict__ delta, int n_per_image,
                                    const float4* __restrict__ band,
                                    const short* __restrict__ rot, float inv_bin,
                                    float* __restrict__ angle,
                                    unsigned* __restrict__ desc) {
  __shared__ float4 s_band[kTile * kRowQuads];
  __shared__ float s_tile[(kTile + 2 * kPad) * kTile];   // tile rows -4..35
  __shared__ float s_rows[kTile * kPitchRows];           // row-blurred tile, columns -4..35
  __shared__ int s_fixed[kTile * kPitch];
  __shared__ int s_part[kWarps * 3];
  __shared__ int s_bin;

  const int k = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* img = atlas + static_cast<long long>(k / n_per_image) * h * w;
  const int x0 = min(max(xy[2 * k] - kHalfPatch, 0), w - kTile);
  const int y0 = min(max(xy[2 * k + 1] - kHalfPatch, 0), h - kTile);

  for (int i = threadIdx.x; i < kTile * kRowQuads; i += kThreads) s_band[i] = band[i];
  for (int r = warp; r < kTile; r += kWarps) {
    s_tile[(kPad + r) * kTile + lane] = img[static_cast<long long>(y0 + r) * w + x0 + lane];
  }
  for (int i = threadIdx.x; i < 2 * kPad * kTile; i += kThreads) {
    const int r = i / kTile;                               // rows -4..-1 and 32..35 of the tile
    s_tile[(r < kPad ? r : r + kTile) * kTile + i % kTile] = 0.0f;
    const int q = i % (2 * kPad);                          // columns -4..-1 and 32..35 of its rows
    s_rows[(i / (2 * kPad)) * kPitchRows + (q < kPad ? q : q + kTile)] = 0.0f;
  }
  const float dx = delta[2 * k];
  const float dy = delta[2 * k + 1];
  const float wmx = fmaxf(-dx, 0.0f), w0x = 1.0f - fabsf(dx), wpx = fmaxf(dx, 0.0f);
  const float wmy = fmaxf(-dy, 0.0f), w0y = 1.0f - fabsf(dy), wpy = fmaxf(dy, 0.0f);
  __syncthreads();

  // Rows: ty[i][c] = sum_j A[i][j] T[j][c]; a warp takes rows i0 and
  // i0 + 1, which share nine of their ten tile rows; lane = c.
  for (int i0 = 2 * warp; i0 < kTile; i0 += 2 * kWarps) {
    float t[kTaps + 1];
#pragma unroll
    for (int q = 0; q <= kTaps; ++q) t[q] = s_tile[(i0 + q) * kTile + lane];   // tile row i0 - 4 + q
#pragma unroll
    for (int d = 0; d < 2; ++d) {
      s_rows[(i0 + d) * kPitchRows + kPad + lane] = blur3(s_band, i0 + d, t + d, wmy, w0y, wpy);
    }
  }
  __syncthreads();

  // Columns: tb[r][i] = sum_j ty[r][j] A[i][j]; a warp takes columns i0
  // and i0 + 1, lane = r.  Quantise and take the moments of the disk on
  // the way.
  int m10 = 0, m01 = 0, m00 = 0;
  for (int i0 = 2 * warp; i0 < kTile; i0 += 2 * kWarps) {
    float t[kTaps + 1];
#pragma unroll
    for (int q = 0; q <= kTaps; ++q) t[q] = s_rows[lane * kPitchRows + i0 + q];   // column i0 - 4 + q
#pragma unroll
    for (int d = 0; d < 2; ++d) {
      const int i = i0 + d;
      const float v = blur3(s_band, i, t + d, wmx, w0x, wpx);
      const int q = __float2int_rn(__fmul_rn(v, kFixedScale));
      s_fixed[lane * kPitch + i] = q;
      const int u = i - kHalfPatch;
      const int vv = lane - kHalfPatch;
      if (i < 2 * kHalfPatch + 1 && lane < 2 * kHalfPatch + 1 &&
          u * u + vv * vv <= kHalfPatch * kHalfPatch) {
        m10 += q * u;
        m01 += q * vv;
        m00 += q;
      }
    }
  }
  m10 = warp_sum(m10);
  m01 = warp_sum(m01);
  m00 = warp_sum(m00);
  if (lane == 0) {
    s_part[warp * 3] = m10;
    s_part[warp * 3 + 1] = m01;
    s_part[warp * 3 + 2] = m00;
  }
  __syncthreads();

  if (threadIdx.x == 0) {
    int s10 = 0, s01 = 0, s00 = 0;
    for (int i = 0; i < kWarps; ++i) {
      s10 += s_part[i * 3];
      s01 += s_part[i * 3 + 1];
      s00 += s_part[i * 3 + 2];
    }
    const float f10 = __int2float_rn(s10);
    const float f01 = __int2float_rn(s01);
    const float f00 = __int2float_rn(s00);
    const float norm = __fsqrt_rn(__fadd_rn(__fmul_rn(f10, f10), __fmul_rn(f01, f01)));
    const float offset = __fdiv_rn(norm, fmaxf(f00, 1e-6f));
    const float a = offset >= kIcMinOffsetPx ? atan2f(f01, f10) : 0.0f;
    angle[k] = a;
    const int b = __float2int_rn(__fmul_rn(a, inv_bin));
    s_bin = ((b % kBins) + kBins) % kBins;
  }
  __syncthreads();

  // BRIEF: bit t = q[p2_t] > q[p1_t]; a warp pass gives one 32-bit word,
  // whose little-endian bytes are the LSB-first packing.
  const short* pattern = rot + s_bin * 512;
  for (int g = warp; g < 8; g += kWarps) {
    const int i1 = pattern[g * 32 + lane];
    const int i2 = pattern[256 + g * 32 + lane];
    const int v1 = s_fixed[(i1 >> 5) * kPitch + (i1 & 31)];
    const int v2 = s_fixed[(i2 >> 5) * kPitch + (i2 & 31)];
    const unsigned word = __ballot_sync(0xffffffffu, v2 > v1);
    if (lane == 0) desc[static_cast<long long>(k) * 8 + g] = word;
  }
}

}  // namespace

// atlas: float32 [b, h, w] contiguous; xy: int32 [b, n, 2] (x, y) atlas
// keypoints; delta: float32 [b, n, 2] sub-pixel offsets; band: float32
// [32, 28] band rows of the shift+blur matrices, 16-byte aligned; rot: int16 [30, 512] flat
// tile indices of the rotated test points; inv_bin: 1 / (2 pi / 30);
// angle: float32 [b * n]; desc: uint8 [b * n, 32].  Launches on `stream`;
// returns cudaGetLastError().
extern "C" int orb_describe_launch(const float* atlas, int b, int h, int w,
                                   const int* xy, const float* delta, int n,
                                   const float* band, const short* rot,
                                   float inv_bin, float* angle, unsigned char* desc,
                                   void* stream) {
  if (b * n > 0) {
    orb_describe_kernel<<<b * n, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        atlas, h, w, xy, delta, n, reinterpret_cast<const float4*>(band), rot, inv_bin, angle,
        reinterpret_cast<unsigned*>(desc));
  }
  return static_cast<int>(cudaGetLastError());
}
