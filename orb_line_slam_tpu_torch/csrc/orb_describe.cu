// Fused ORB describe for Hopper (sm_90a): clamped 32x32 tile -> sub-pixel
// shift + Gaussian blur -> intensity-centroid angle -> rotated BRIEF-256,
// the tile never leaving shared memory.
//
// Replaces, together with stereo_sad.cu, the TPU kernel
// orb_line_slam_tpu/ops/pallas_patches.py::extract_patch_tiles (body
// _patch_kernel, pallas_call at line 99) on the stereo path.  That kernel
// wrote one 4 KB tile per keypoint to device memory because Mosaic could
// not gather inside the consumers; plain tensor code then read the tiles
// back many times (six batched 32x32 products, two int64 copies, three
// moment sums, a 512-sample gather).  Here a warp cuts the tile exactly
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
// row-normalised zero-padded 7-tap Gaussian B composed with the
// edge-clamped one-pixel shifts: Am = B S-, A0 = B, Ap = B S+).  Each
// product is a float32 dot product taken with fused multiply-adds in
// ascending column order, over the taps of the row that lie in the tile;
// the weighted sums round every product and sum separately, as three
// tensor operations do.  Everything after the blurred tile is integer
// arithmetic or a single correctly rounded float operation (the angle's
// sqrt, division and atan2f on one lane), so equal blurred tiles give
// equal angles and descriptors.  (On an H100 with CUDA 12.8 that order
// reproduces the library's batched products bit for bit; the library
// promises no order, so the kernel is held to the plain version by a
// tolerance, and to its own earlier design, and a numpy emulation of it,
// bit for bit.)
//
// Row reuse.  In the interior B is Toeplitz, so Am's row i is A0's row
// i - 1 for i = 4..28 and Ap's row i is A0's row i + 1 for i = 3..27,
// element for element (kAmReuse*, kApReuse* below; the test
// test_shift_blur_row_reuse_identity derives both ranges from the
// matrices and holds these constants to them).  The same nonzero
// coefficients then meet the same tile values in the same ascending
// order, so (Am T)[i] = (A0 T)[i - 1] to the bit; a zero coefficient adds
// an exact zero, so taps that are zero in every row of a matrix are
// dropped (A0 keeps offsets -3..+3, Am -4..+2, Ap -2..+4).  Per axis a
// lane computes 32 A0 products and the 14 edge products of Am (rows 0-3,
// 29-31) and Ap (rows 0-2, 28-31) from their own bands: 46 products of 7
// taps, where the earlier design took 96 of 9.  For the same reason A0's
// rows 3..28 hold one band, bit for bit (kA0Interior*; the same test), so
// a lane keeps those seven coefficients in registers and loads only the
// 20 edge rows' from shared memory, one broadcast load a tap in the tile.
//
// What bounds it: bytes, narrowly, on paper.  The function needs the atlas
// pixels under some tile once and 36 bytes written per keypoint; the
// float32 work of one combined band per axis takes the card less time
// than those bytes.  The kernel keeps the plain version's three products
// per axis and their separate roundings so as to agree with it bit for
// bit, so in practice instruction issue and shared-memory traffic bound
// it, not HBM.  What the design does about it:
//   - persistent CTAs: the grid is the SM count times the CTAs an SM
//     holds, asked of the occupancy API at the first launch on a device
//     (one CTA of kWarps = 12 warps; 8 and 16 measured slower, PERF.md).
//     A CTA loads the 21 band rows it uses and the 30 x 512 int16
//     rotated-pattern table into shared memory once, then its warps walk
//     the keypoints with a stride;
//   - one keypoint per warp (a group of two warps splitting the rows and
//     columns, with a named barrier, was measured slower: PERF.md), with
//     __syncwarp and no __syncthreads per keypoint; moments, angle and bin
//     stay with the keypoint's warp;
//   - the row reuse above, with a lane's tile column (row pass) or row of
//     the row-blurred tile (column pass) in registers;
//   - prefetch: two tile stages a warp.  Once the row pass has read
//     keypoint k's tile into registers, the warp copies the tile of
//     keypoint k + 2 strides into that stage with 4-byte cp.async copies,
//     committed as one group and awaited at the start of that keypoint,
//     so a copy has about one keypoint and a half to land.  TMA does not
//     serve here: a tensor map needs a global row stride that is a
//     multiple of 16 bytes (the point cell's atlas row is 1241 x 4 = 4,964
//     bytes) and a tile's x0 is arbitrary;
//   - the row-blurred tile has an odd pitch (33), so that the row pass
//     (lane = column) writes it and the column pass (lane = row) reads it
//     without bank conflicts; the column pass quantises it in place (each
//     lane overwrites the row it has already read into registers), keeping
//     q as int32 bits, since a float32 atlas has no range the kernel may
//     assume.

#ifndef ORB_DESCRIBE_HOST
#include <cuda_runtime.h>

extern __shared__ __align__(16) unsigned char orb_describe_smem[];
#endif

#ifndef ORB_DESCRIBE_SPLIT
#define ORB_DESCRIBE_SPLIT 0
#endif

namespace {

constexpr int kTile = 32;
constexpr int kPitch = 33;                  // odd: read along a row or down a column without bank conflicts
constexpr int kBandRow = 28;                // band_rows(): [Am taps 0..8 | A0 taps 0..8 | Ap taps 0..8 | pad]
constexpr int kBandTaps = 9;                // offsets -4..+4 around the diagonal
constexpr int kUsed = 7;                    // taps that are nonzero in some row, per matrix
constexpr int kAmTap0 = 0;                  // Am: offsets -4..+2
constexpr int kA0Tap0 = 1;                  // A0: offsets -3..+3
constexpr int kApTap0 = 2;                  // Ap: offsets -2..+4
constexpr int kAmReuseFirst = 4;            // Am row i == A0 row i - 1 for i in [4, 28]
constexpr int kAmReuseLast = 28;
constexpr int kApReuseFirst = 3;            // Ap row i == A0 row i + 1 for i in [3, 27]
constexpr int kApReuseLast = 27;
constexpr int kA0InteriorFirst = 3;         // A0's rows 3..28 hold one band, bit for bit
constexpr int kA0InteriorLast = 28;
constexpr int kA0Edges = kA0InteriorFirst + (kTile - 1 - kA0InteriorLast);   // 6 rows of A0 with a band of their own
constexpr int kAmEdges = kAmReuseFirst + (kTile - 1 - kAmReuseLast);         // 7 of Am
constexpr int kApEdges = kApReuseFirst + (kTile - 1 - kApReuseLast);         // 7 of Ap
// The coefficient table: A0's edge rows, its interior band, Am's edge rows,
// Ap's; each row its used taps and one float of padding.
constexpr int kCoefRows = kA0Edges + 1 + kAmEdges + kApEdges;                // 21
constexpr int kCoefPitch = 8;
constexpr int kBins = 30;
constexpr int kPattern = 512;               // 256 test-point pairs: p1 at [0, 256), p2 at [256, 512)
constexpr int kWords = 8;                   // 256 bits
constexpr int kHalfPatch = 15;
constexpr float kFixedScale = 16.0f;
constexpr float kIcMinOffsetPx = 0.5f;
constexpr int kWarps = 12;                  // a CTA, one keypoint a warp; one CTA fits on an SM
constexpr int kThreads = 32 * kWarps;

// Shared memory: the CTA's two tables, then per warp two tile stages and
// the row-blurred (then quantised) tile.
constexpr int kCoefBytes = kCoefRows * kCoefPitch * 4;
constexpr int kRotBytes = kBins * kPattern * 2;
constexpr int kStage = kTile * kTile;
constexpr int kWarpFloats = 2 * kStage + kTile * kPitch;
constexpr int kSharedBytes = kCoefBytes + kRotBytes + kWarps * kWarpFloats * 4;
static_assert(kSharedBytes <= 232448, "227 KB a block on Hopper");

// Edge row i of a matrix whose rows [first, last] are taken elsewhere:
// its index among the edge rows, and back.
__host__ __device__ constexpr int edge_index(int i, int first, int last) { return i < first ? i : first + i - last - 1; }
__host__ __device__ constexpr int edge_row(int e, int first, int last) { return e < first ? e : last + 1 + e - first; }
// Table rows of A0's edge row i, of Am's and of Ap's.
__host__ __device__ constexpr int a0_slot(int i) { return edge_index(i, kA0InteriorFirst, kA0InteriorLast); }
__host__ __device__ constexpr int am_slot(int i) { return kA0Edges + 1 + edge_index(i, kAmReuseFirst, kAmReuseLast); }
__host__ __device__ constexpr int ap_slot(int i) {
  return kA0Edges + 1 + kAmEdges + edge_index(i, kApReuseFirst, kApReuseLast);
}

#ifndef ORB_DESCRIBE_HOST
__device__ __forceinline__ unsigned char* shared_base() { return orb_describe_smem; }

// One 4-byte asynchronous copy from device to shared memory.
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

// Closes the group of copies issued since the last call.
__device__ __forceinline__ void commit_copies() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Waits for every closed group but the newest: the tile of the keypoint
// at hand has landed, the next one may still be in flight.
__device__ __forceinline__ void wait_all_but_newest() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }
#endif

// wm * a + w0 * b + wp * c as three tensor operations round it.
__device__ __forceinline__ float weighted3(float wm, float a, float w0, float b, float wp, float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(wm, a), __fmul_rn(w0, b)), __fmul_rn(wp, c));
}

// Row i of a product: sum over the seven used taps, starting at band offset
// tap0, of coef[o] x line[j] (j = i - 4 + tap0 + o), in ascending j with
// fused multiply-adds; taps outside the tile have coefficient 0 and are
// skipped (they add an exact 0).  coef: the interior band in registers, or
// an edge row of the shared table (one broadcast load a used tap).
template <class Coef>
__device__ __forceinline__ float band_dot(const Coef& coef, int tap0, int i, const float (&line)[kTile]) {
  float acc = 0.0f;
#pragma unroll
  for (int o = 0; o < kUsed; ++o) {
    const int j = i - 4 + tap0 + o;
    if (j >= 0 && j < kTile) acc = fmaf(coef[o], line[j], acc);
  }
  return acc;
}

// One blur pass over this lane's line: out[i] = wm (Am line)[i] + w0 (A0
// line)[i] + wp (Ap line)[i], Am's and Ap's interior rows read off A0's
// products.  sink(i, out[i]) takes each.
template <class Sink>
__device__ __forceinline__ void blur_line(const float* s_coef, const float (&a0)[kUsed], const float (&line)[kTile],
                                          float wm, float w0, float wp, Sink sink) {
  float p0[kTile];
#pragma unroll
  for (int i = 0; i < kTile; ++i) {
    p0[i] = i >= kA0InteriorFirst && i <= kA0InteriorLast ? band_dot(a0, kA0Tap0, i, line)
                                                          : band_dot(s_coef + kCoefPitch * a0_slot(i), kA0Tap0, i, line);
  }
#pragma unroll
  for (int i = 0; i < kTile; ++i) {
    const float am = i >= kAmReuseFirst && i <= kAmReuseLast
                         ? p0[i > 0 ? i - 1 : 0]
                         : band_dot(s_coef + kCoefPitch * am_slot(i), kAmTap0, i, line);
    const float ap = i >= kApReuseFirst && i <= kApReuseLast
                         ? p0[i < kTile - 1 ? i + 1 : i]
                         : band_dot(s_coef + kCoefPitch * ap_slot(i), kApTap0, i, line);
    sink(i, weighted3(wm, am, w0, p0[i], wp, ap));
  }
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
  return v;
}

// Rows: lane = tile column c; ty[i][c] for every row i.
__device__ __forceinline__ void row_pass(const float* s_coef, const float (&a0)[kUsed], const float* tile,
                                         float* rows, int lane, float wm, float w0, float wp) {
  float line[kTile];
#pragma unroll
  for (int r = 0; r < kTile; ++r) line[r] = tile[r * kTile + lane];
  blur_line(s_coef, a0, line, wm, w0, wp, [&](int i, float v) { rows[i * kPitch + lane] = v; });
}

// Columns: lane = row r; tb[r][i] for every column i, quantised in place
// (the lane has read its row into registers), and the disk's moments of
// the row: (sum q u, sum q) with u = i - 15 (m01 is v times the sum, v =
// r - 15).
__device__ __forceinline__ void column_pass(const float* s_coef, const float (&a0)[kUsed], float* rows, int lane,
                                            float wm, float w0, float wp, int& m10, int& m00) {
  float line[kTile];
  float* mine = rows + lane * kPitch;
#pragma unroll
  for (int j = 0; j < kTile; ++j) line[j] = mine[j];
  const int v = lane - kHalfPatch;
  blur_line(s_coef, a0, line, wm, w0, wp, [&](int i, float x) {
    const int q = __float2int_rn(__fmul_rn(x, kFixedScale));
    mine[i] = __int_as_float(q);
    const int u = i - kHalfPatch;
    if (i <= 2 * kHalfPatch && lane <= 2 * kHalfPatch && u * u + v * v <= kHalfPatch * kHalfPatch) {
      m10 += q * u;
      m00 += q;
    }
  });
}

// Where a warp's time goes (built with -DORB_DESCRIBE_SPLIT=1 only): lane
// 0's cycles in each part, summed over the warps; then the keypoints, the
// warps, their cycles and nanoseconds from start to end, and the first
// start and last end on the device's clock (ns).
constexpr int kSplitParts = 6;   // tables and first tile, tile wait, rows, columns, moments and angle, BRIEF
constexpr int kSplitSlots = kSplitParts + 6;
#if ORB_DESCRIBE_SPLIT && !defined(ORB_DESCRIBE_HOST)
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

__global__ void __launch_bounds__(kThreads) orb_describe_kernel(
    const float* __restrict__ atlas, int h, int w, const int* __restrict__ xy, const float* __restrict__ delta,
    int n_per_image, int total, const float* __restrict__ band, const short* __restrict__ rot, float inv_bin,
    float* __restrict__ angle, unsigned* __restrict__ desc) {
  Split split;
  split.start();
  unsigned char* smem = shared_base();
  float* s_coef = reinterpret_cast<float*>(smem);
  short* s_rot = reinterpret_cast<short*>(smem + kCoefBytes);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* stages = reinterpret_cast<float*>(smem + kCoefBytes + kRotBytes) + warp * kWarpFloats;
  float* rows = stages + 2 * kStage;
  const long long image = static_cast<long long>(h) * w;
  // Keypoint k goes to CTA k mod grid, so that a launch with fewer
  // keypoints than warps spreads them over every SM.
  const int stride = gridDim.x * kWarps;

  // A keypoint's tile into a stage, lane = column: each lane copies, and
  // later reads, its own column only.
  auto prefetch = [&](int k, int x, int y, float* stage) {
    const int x0 = min(max(x - kHalfPatch, 0), w - kTile);
    const int y0 = min(max(y - kHalfPatch, 0), h - kTile);
    const float* src = atlas + (k / n_per_image) * image + static_cast<long long>(y0) * w + x0 + lane;
#pragma unroll 4
    for (int r = 0; r < kTile; ++r) copy_async(stage + r * kTile + lane, src + static_cast<long long>(r) * w);
  };

  // Every load of the prologue first (the CTA's tables, the first two
  // keypoints' coordinates and this one's offsets), then the first two
  // tiles' copies, a group each, then the tables' stores: the tables' and
  // the coordinates' round trips overlap.  The tables: the used taps of
  // A0's edge rows and interior band and of Am's and Ap's edge rows, and
  // the rotated pattern (16-byte loads).
  static_assert(kCoefRows * kCoefPitch <= kThreads, "one coefficient a thread");
  float coef = 0.0f;
  if (threadIdx.x < kCoefRows * kCoefPitch) {
    const int row = threadIdx.x / kCoefPitch, o = threadIdx.x % kCoefPitch;
    int i, first;
    if (row <= kA0Edges) {
      i = row == kA0Edges ? kA0InteriorFirst : edge_row(row, kA0InteriorFirst, kA0InteriorLast);
      first = kBandTaps + kA0Tap0;
    } else if (row <= kA0Edges + kAmEdges) {
      i = edge_row(row - kA0Edges - 1, kAmReuseFirst, kAmReuseLast);
      first = kAmTap0;
    } else {
      i = edge_row(row - kA0Edges - 1 - kAmEdges, kApReuseFirst, kApReuseLast);
      first = 2 * kBandTaps + kApTap0;
    }
    if (o < kUsed) coef = band[i * kBandRow + first + o];
  }
  constexpr int kQuads = kRotBytes / 16;
  constexpr int kPerThread = (kQuads + kThreads - 1) / kThreads;
  int4 quads[kPerThread];
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const int t = threadIdx.x + r * kThreads;
    if (t < kQuads) quads[r] = reinterpret_cast<const int4*>(rot)[t];
  }
  int k = warp * gridDim.x + blockIdx.x;
  int x0 = 0, y0 = 0, x1 = 0, y1 = 0;
  float dx = 0.0f, dy = 0.0f;
  if (k < total) {
    x0 = xy[2 * k];
    y0 = xy[2 * k + 1];
    dx = delta[2 * k];
    dy = delta[2 * k + 1];
  }
  if (k + stride < total) {
    x1 = xy[2 * (k + stride)];
    y1 = xy[2 * (k + stride) + 1];
  }
  if (k < total) prefetch(k, x0, y0, stages);
  commit_copies();
  if (k + stride < total) prefetch(k + stride, x1, y1, stages + kStage);
  commit_copies();
  if (threadIdx.x < kCoefRows * kCoefPitch) s_coef[threadIdx.x] = coef;
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const int t = threadIdx.x + r * kThreads;
    if (t < kQuads) reinterpret_cast<int4*>(s_rot)[t] = quads[r];
  }
  __syncthreads();
  float a0[kUsed];                           // A0's interior band, for every keypoint
#pragma unroll
  for (int o = 0; o < kUsed; ++o) a0[o] = s_coef[kA0Edges * kCoefPitch + o];
  split.mark(0);

  // Tile k lands in stage it % 2; once the row pass has read it, the same
  // stage takes the tile two keypoints on, so a copy has about a keypoint
  // and a half to land.
  for (int it = 0; k < total; ++it, k += stride) {
    float* tile = stages + (it & 1) * kStage;
    const int kn = k + stride, kf = k + 2 * stride;
    float dxn = 0.0f, dyn = 0.0f;
    if (kn < total) {
      dxn = delta[2 * kn];
      dyn = delta[2 * kn + 1];
    }
    int xf = 0, yf = 0;
    if (kf < total) {
      xf = xy[2 * kf];
      yf = xy[2 * kf + 1];
    }
    wait_all_but_newest();
    split.mark(1);

    const float wmx = fmaxf(-dx, 0.0f), w0x = 1.0f - fabsf(dx), wpx = fmaxf(dx, 0.0f);
    const float wmy = fmaxf(-dy, 0.0f), w0y = 1.0f - fabsf(dy), wpy = fmaxf(dy, 0.0f);
    int m10 = 0, m00 = 0;
    row_pass(s_coef, a0, tile, rows, lane, wmy, w0y, wpy);
    __syncwarp();                             // the tile is read: its stage takes tile kf
    if (kf < total) prefetch(kf, xf, yf, tile);
    commit_copies();
    split.mark(2);
    column_pass(s_coef, a0, rows, lane, wmx, w0x, wpx, m10, m00);
    split.mark(3);
    const int m01 = warp_sum((lane - kHalfPatch) * m00);
    m10 = warp_sum(m10);
    m00 = warp_sum(m00);
    __syncwarp();                             // q complete

    int bin = 0;
    if (lane == 0) {
      const float f10 = __int2float_rn(m10);
      const float f01 = __int2float_rn(m01);
      const float f00 = __int2float_rn(m00);
      const float norm = __fsqrt_rn(__fadd_rn(__fmul_rn(f10, f10), __fmul_rn(f01, f01)));
      const float offset = __fdiv_rn(norm, fmaxf(f00, 1e-6f));
      const float a = offset >= kIcMinOffsetPx ? atan2f(f01, f10) : 0.0f;
      angle[k] = a;
      const int b = __float2int_rn(__fmul_rn(a, inv_bin));
      bin = ((b % kBins) + kBins) % kBins;
    }
    bin = __shfl_sync(0xffffffffu, bin, 0);
    split.mark(4);

    // BRIEF: bit t = q[p2_t] > q[p1_t]; a ballot gives one 32-bit word,
    // whose little-endian bytes are the LSB-first packing.  Lane g keeps
    // word g; the words go out as one row.
    const short* pattern = s_rot + bin * kPattern;
    unsigned word = 0;
#pragma unroll
    for (int g = 0; g < kWords; ++g) {
      const int t = g * 32 + lane;
      const int i1 = pattern[t];
      const int i2 = pattern[kPattern / 2 + t];
      const int v1 = __float_as_int(rows[(i1 >> 5) * kPitch + (i1 & 31)]);
      const int v2 = __float_as_int(rows[(i2 >> 5) * kPitch + (i2 & 31)]);
      const unsigned bits = __ballot_sync(0xffffffffu, v2 > v1);
      if (lane == g) word = bits;
    }
    if (lane < kWords) desc[static_cast<long long>(k) * kWords + lane] = word;
    __syncwarp();                             // q read: the next keypoint may overwrite it
    split.mark(5);
    split.keypoint();
    dx = dxn;
    dy = dyn;
  }
  split.flush(lane);
}

}  // namespace

// atlas: float32 [b, h, w] contiguous; xy: int32 [b, n, 2] (x, y) atlas
// keypoints; delta: float32 [b, n, 2] sub-pixel offsets; band: float32
// [32, 28] band rows of the shift+blur matrices (band_rows()); rot: int16
// [30, 512] flat tile indices of the rotated test points, 16-byte aligned;
// inv_bin: 1 / (2 pi / 30); angle: float32 [b * n]; desc: uint8 [b * n,
// 32], 4-byte aligned.  Launches min(SMs x resident CTAs, b * n)
// persistent CTAs on `stream` (the resident count from the occupancy API,
// asked once per device); returns the first CUDA error, else
// cudaGetLastError().
extern "C" int orb_describe_launch(const float* atlas, int b, int h, int w, const int* xy, const float* delta,
                                   int n, const float* band, const short* rot, float inv_bin, float* angle,
                                   unsigned char* desc, void* stream) {
  const int total = b * n;
  if (total > 0) {
    constexpr int kMaxDevices = 64;
    static int resident[kMaxDevices];         // SMs x CTAs per SM, per device; 0 until asked
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
    if (resident[dev] == 0) {
      err = cudaFuncSetAttribute(orb_describe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSharedBytes);
      if (err != cudaSuccess) return static_cast<int>(err);
      int per_sm = 0, sms = 0;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, orb_describe_kernel, kThreads, kSharedBytes);
      if (err != cudaSuccess) return static_cast<int>(err);
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (err != cudaSuccess) return static_cast<int>(err);
      if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
      resident[dev] = sms * per_sm;
    }
    const int grid = total < resident[dev] ? total : resident[dev];
    orb_describe_kernel<<<grid, kThreads, kSharedBytes, static_cast<cudaStream_t>(stream)>>>(
        atlas, h, w, xy, delta, n, total, band, rot, inv_bin, angle, reinterpret_cast<unsigned*>(desc));
  }
  return static_cast<int>(cudaGetLastError());
}

#if ORB_DESCRIBE_SPLIT
// The split counters since the last call (kSplitSlots of them), reset.
extern "C" int orb_describe_split(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_split, sizeof(g_split));
  if (err != cudaSuccess) return static_cast<int>(err);
  unsigned long long reset[kSplitSlots] = {};
  reset[kSplitSlots - 2] = ~0ull;              // the first start: a minimum
  return static_cast<int>(cudaMemcpyToSymbol(g_split, reset, sizeof(reset)));
}
#endif
