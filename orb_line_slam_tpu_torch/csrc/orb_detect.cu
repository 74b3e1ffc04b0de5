// Fused ORB keypoint detection for Hopper (sm_90a): FAST-9 score, 3x3
// non-maximum suppression, the interior mask, per-cell top-k, each
// level's top-N and the parabola's sub-pixel offsets, for every level of
// every image of a pyramid atlas, in two launches.
//
// Replaces no Pallas kernel.  It ports what the JAX package runs as one
// fused XLA program per level (orb_line_slam_tpu/frontend/orb_extractor.py
// ::_detect_level with ops/fast.py and ops/topk_grid.py) and what the plain
// version (ops/detect.py::detect_reference) runs as ~220 tensor operations a
// level: 16 rolled full-level copies and their arc windows, 8 more rolls
// for the NMS, two stable sorts over a padded permuted copy, 5 gathers.
// It computes exactly what that composition computes:
//
//   raw(p)   = max(max_s min_{j<9} d[(s+j) % 16], -(min_s max_{j<9} d[(s+j) % 16])),
//              d[i] = img(p + circle[i]) - img(p); 0 within 3 px of the border;
//   score(p) = raw(p) if raw(p) > raw(q) for the raster-earlier neighbours q
//              and raw(p) >= raw(q) for the later ones, else 0; 0 outside the
//              interior (edge_margin);
//   per 32x32 cell (the level zero-padded to whole cells): the k_per_cell
//   largest scores, ties to the lower in-cell raster index; a candidate is
//   valid when its score > min_th_fast and it lies in the level;
//   per level: the `quota` best valid candidates, ties to the lower
//   (cell, slot) index; sub-pixel offsets from the raw scores around each,
//   dx = 0.5 (dr - dl) / (2 s - dl - dr) where that denominator > 1e-6,
//   else 0, clamped to [-0.5, 0.5]; level-0 coordinates (x + dx) * scale.
//
// Every step is exact or a single IEEE operation (subtraction, min/max,
// comparisons, one multiply by 2 and one by 0.5, one division, one add,
// one multiply), taken here with the _rn intrinsics so that nothing is
// contracted, in the plain version's order; the scale is float32(s^l), as
// torch applies a Python scalar to a float32 tensor.  So the outputs
// equal the plain version's element for element.
//
// Two launches, with a per-level table passed by value (struct Levels,
// filled by ops/detect.py::level_table; nothing is uploaded per call):
//   1. cell pass: a CTA per (cell of any level, image).  It stages the
//      cell and a 4-px halo of its level in shared memory (each atlas pixel
//      is read by its cell and, in the halo, by its neighbours), computes
//      the raw score over the cell and a 1-px ring, and keeps the pixels
//      that survive the NMS and the mask with a score > min_th_fast
//      ("hot").  The NMS's tie rule makes hot pixels pairwise
//      non-adjacent, so a cell has at most 256.  Each hot pixel's rank in
//      the cell is counted against the others (score descending, index
//      ascending); ranks below k write a candidate (score, x, y and the
//      offsets, read off the raw scores in shared memory), the rest of the
//      cell's k slots an empty one (score -inf).  Pixels that are not hot
//      rank behind every hot one, since min_th_fast >= 0 (the wrapper
//      refuses a negative one) and a cell's padding scores 0, so they
//      never hold a valid slot.
//   2. select pass: a CTA per (level, image) sorts the level's n_cells x k
//      candidate keys (score descending, then slot index; empty slots last)
//      in shared memory by a bitonic network and writes the first `quota`
//      rows of all six outputs straight into the level's columns; a row
//      past the valid candidates is the plain version's invalid row (xy,
//      offsets and response 0, atlas xy (0, row offset), octave the level).
//
// What bounds it: not bytes.  A KITTI pair needs its 11.6 MB of level
// pixels read once and 33 bytes written a keypoint, 3.5 us at 3.35 TB/s;
// the cell pass reads each pixel about 1.56 times (the halo).  The FAST
// score takes ~200 float operations a pixel over every cell and its ring,
// ~0.7 G for that pair, ~10 us at the card's float32 rate, and the select
// pass is one CTA's sort of ~1,400 keys at level 0.  On an H100 the two
// passes take 57 and 24 us for that pair (PERF.md §6), against the
// plain version's 5.6 ms of device time in ~1,800 launches.  What the
// design does: one read of the atlas into shared memory, no intermediate
// map in device memory, and the candidates (16 bytes each, k a cell) as
// the only traffic between the passes.

#include <cmath>
#include <cstring>

#ifndef ORB_DETECT_HOST
#include <cuda_runtime.h>
#endif

namespace {

constexpr int kMaxLevels = 16;
constexpr int kCell = 32;
constexpr int kBorder = 3;                       // FAST's circle radius: the zeroed border
constexpr int kHalo = kBorder + 1;               // the circle around the ring's pixels
constexpr int kTileW = kCell + 2 * kHalo;        // 40: the staged level pixels
constexpr int kRawW = kCell + 2;                 // 34: raw scores of the cell and its ring
constexpr int kMaxHot = kCell * kCell / 4;       // pairwise non-adjacent pixels of a cell
constexpr int kCellThreads = 256;
constexpr int kSelectThreads = 1024;
constexpr int kMaxSort = 16384;                  // keys a level's select pass can sort
constexpr int kCellShared = (kTileW * kTileW + kRawW * kRawW + kMaxHot) * 4 + kMaxHot * 4 + 16;
constexpr int kMaxSelectShared = kMaxSort * 8;
static_assert(kMaxSelectShared <= 232448, "227 KB a block on Hopper");

// The per-level table, word for word ops/detect.py::_FIELDS (32-bit
// fields, no padding).  Cells are numbered level by level, row-major in
// each level's grid of ceil(h / 32) x ceil(w / 32); candidate slots the
// same, k_per_cell a cell; output columns level by level.
struct Levels {
  int n_levels;
  int total_cells;                 // cells of all levels: the cell pass's grid
  int total_cand;                  // candidate slots of all levels, per image
  int n_out;                       // output columns per image (sum of the quotas)
  int margin;                      // edge_margin
  float min_score;                 // min_th_fast, >= 0
  int row_off[kMaxLevels];         // the level's first atlas row
  int h[kMaxLevels];
  int w[kMaxLevels];
  int wc[kMaxLevels];              // cells across
  int first_cell[kMaxLevels];
  int n_cells[kMaxLevels];
  int k[kMaxLevels];               // k_per_cell
  int cand_start[kMaxLevels];
  int quota[kMaxLevels];
  int col_start[kMaxLevels];
  int sort_len[kMaxLevels];        // a power of two >= n_cells * k
  float scale[kMaxLevels];         // float32(scale_factor ** level)
};

#ifndef ORB_DETECT_HOST
extern __shared__ __align__(16) unsigned char orb_detect_smem[];
__device__ __forceinline__ unsigned char* shared_base() { return orb_detect_smem; }
__device__ __forceinline__ int shared_add(int* counter, int v) { return atomicAdd(counter, v); }
#endif

constexpr unsigned long long kEmptyKey = ~0ull;

// A candidate as 16 bytes: score (-inf when the slot is empty), x | y << 16
// in level pixels, and the two sub-pixel offsets.
__device__ __forceinline__ float4 candidate(float score, int x, int y, float dx, float dy) {
  float4 c;
  c.x = score;
  c.y = __int_as_float(x | (y << 16));
  c.z = dx;
  c.w = dy;
  return c;
}

// The parabola's offset along one axis from the raw scores s (centre), a
// (before) and b (after): torch.where(2 s - a - b > 1e-6, 0.5 (b - a) / (2 s
// - a - b), 0), clamped to [-0.5, 0.5].
__device__ __forceinline__ float parabola(float s, float a, float b) {
  const float den = __fsub_rn(__fsub_rn(__fmul_rn(2.0f, s), a), b);
  const float d = den > 1e-6f ? __fdiv_rn(__fmul_rn(0.5f, __fsub_rn(b, a)), den) : 0.0f;
  return fminf(fmaxf(d, -0.5f), 0.5f);
}

// FAST-9 score at tile pixel (ty, tx) of the staged level (pitch kTileW).
__device__ __forceinline__ float fast_score(const float* pix, int ty, int tx) {
  // Bresenham circle of radius 3, OpenCV pixel order (dx, dy): ops/fast.py.
  constexpr int kCircleX[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
  constexpr int kCircleY[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
  const float c = pix[ty * kTileW + tx];
  float d[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) d[i] = __fsub_rn(pix[(ty + kCircleY[i]) * kTileW + tx + kCircleX[i]], c);
  // Min and max over every circular window of 9 by doubling windows of
  // 2, 4 and 8, then the ninth element: min and max are exact, so any
  // order gives the plain version's values.
  float lo2[16], hi2[16], lo4[16], hi4[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    lo2[i] = fminf(d[i], d[(i + 1) & 15]);
    hi2[i] = fmaxf(d[i], d[(i + 1) & 15]);
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    lo4[i] = fminf(lo2[i], lo2[(i + 2) & 15]);
    hi4[i] = fmaxf(hi2[i], hi2[(i + 2) & 15]);
  }
  float bright = -INFINITY, dark_max = INFINITY;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float lo9 = fminf(fminf(lo4[i], lo4[(i + 4) & 15]), d[(i + 8) & 15]);
    const float hi9 = fmaxf(fmaxf(hi4[i], hi4[(i + 4) & 15]), d[(i + 8) & 15]);
    bright = fmaxf(bright, lo9);
    dark_max = fminf(dark_max, hi9);
  }
  return fmaxf(bright, -dark_max);
}

__global__ void __launch_bounds__(kCellThreads) orb_detect_cells(const float* __restrict__ atlas, int atlas_h,
                                                                 int atlas_w, Levels L, float4* __restrict__ cand) {
  unsigned char* smem = shared_base();
  float* pix = reinterpret_cast<float*>(smem);
  float* raw = pix + kTileW * kTileW;
  float* hot_score = raw + kRawW * kRawW;
  int* hot_index = reinterpret_cast<int*>(hot_score + kMaxHot);
  int* n_hot = hot_index + kMaxHot;

  const int image = blockIdx.y;
  const int g = blockIdx.x;
  int l = 0;
  while (l + 1 < L.n_levels && g >= L.first_cell[l + 1]) ++l;
  const int c = g - L.first_cell[l];
  const int h = L.h[l], w = L.w[l], k = L.k[l];
  const int y0 = (c / L.wc[l]) * kCell, x0 = (c % L.wc[l]) * kCell;
  const float* level = atlas + (static_cast<long long>(image) * atlas_h + L.row_off[l]) * atlas_w;
  const int tid = threadIdx.x;
  if (tid == 0) *n_hot = 0;

  // The cell and its halo; pixels outside the level read 0 and feed only
  // raw scores inside the zeroed border.
  for (int i = tid; i < kTileW * kTileW; i += kCellThreads) {
    const int y = y0 - kHalo + i / kTileW, x = x0 - kHalo + i % kTileW;
    pix[i] = (y >= 0 && y < h && x >= 0 && x < w) ? level[static_cast<long long>(y) * atlas_w + x] : 0.0f;
  }
  __syncthreads();

  // Raw scores of the cell and its ring; 0 in the border and outside the
  // level, as the plain version's border and its clamped gathers read.
  for (int i = tid; i < kRawW * kRawW; i += kCellThreads) {
    const int ry = i / kRawW, rx = i % kRawW;
    const int y = y0 - 1 + ry, x = x0 - 1 + rx;
    const bool inside = y >= kBorder && y < h - kBorder && x >= kBorder && x < w - kBorder;
    raw[i] = inside ? fast_score(pix, ry + kBorder, rx + kBorder) : 0.0f;
  }
  __syncthreads();

  // Hot pixels: the NMS (strict against the raster-earlier neighbours),
  // the interior mask and the threshold.
  const int m = L.margin;
  const float min_score = L.min_score;
  for (int i = tid; i < kCell * kCell; i += kCellThreads) {
    const int ly = i / kCell, lx = i % kCell;
    const int y = y0 + ly, x = x0 + lx;
    const float* r = raw + (ly + 1) * kRawW + lx + 1;
    const float s = r[0];
    if (!(s > min_score) || y < m || y >= h - m || x < m || x >= w - m) continue;
    const bool keep = s > r[-kRawW - 1] && s > r[-kRawW] && s > r[-kRawW + 1] && s > r[-1] && s >= r[1] &&
                      s >= r[kRawW - 1] && s >= r[kRawW] && s >= r[kRawW + 1];
    if (keep) {
      const int slot = shared_add(n_hot, 1);
      hot_score[slot] = s;
      hot_index[slot] = i;
    }
  }
  __syncthreads();

  // Each hot pixel's rank in the cell; the first k fill the cell's slots.
  const int n = *n_hot;
  float4* out = cand + static_cast<long long>(image) * L.total_cand + L.cand_start[l] + static_cast<long long>(c) * k;
  for (int j = tid; j < n; j += kCellThreads) {
    const float s = hot_score[j];
    const int idx = hot_index[j];
    int rank = 0;
    for (int q = 0; q < n; ++q) {
      const float o = hot_score[q];
      rank += (o > s || (o == s && hot_index[q] < idx)) ? 1 : 0;
    }
    if (rank < k) {
      const int ly = idx / kCell, lx = idx % kCell;
      const float* r = raw + (ly + 1) * kRawW + lx + 1;
      out[rank] = candidate(s, x0 + lx, y0 + ly, parabola(r[0], r[-1], r[1]), parabola(r[0], r[-kRawW], r[kRawW]));
    }
  }
  for (int j = n + tid; j < k; j += kCellThreads) out[j] = candidate(-INFINITY, 0, 0, 0.0f, 0.0f);
}

__global__ void __launch_bounds__(kSelectThreads) orb_detect_select(
    Levels L, const float4* __restrict__ cand, float* __restrict__ xy, int* __restrict__ axy,
    float* __restrict__ resp, int* __restrict__ octave, unsigned char* __restrict__ valid,
    float* __restrict__ delta) {
  unsigned long long* key = reinterpret_cast<unsigned long long*>(shared_base());
  const int l = blockIdx.x, image = blockIdx.y, tid = threadIdx.x;
  const int n = L.n_cells[l] * L.k[l], len = L.sort_len[l];
  const float4* c = cand + static_cast<long long>(image) * L.total_cand + L.cand_start[l];

  // Valid scores are > min_score >= 0, so their bits order as the scores
  // do: the key puts the larger score first, then the lower slot.
  for (int i = tid; i < len; i += kSelectThreads) {
    const float s = i < n ? c[i].x : -INFINITY;
    key[i] = s > 0.0f ? (static_cast<unsigned long long>(~__float_as_uint(s)) << 32) | static_cast<unsigned>(i)
                      : kEmptyKey;
  }
  __syncthreads();
  for (int size = 2; size <= len; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = tid; t < (len >> 1); t += kSelectThreads) {
        const int i = 2 * t - (t & (stride - 1));
        const unsigned long long a = key[i], b = key[i + stride];
        if ((a > b) == ((i & size) == 0)) {
          key[i] = b;
          key[i + stride] = a;
        }
      }
      __syncthreads();
    }
  }

  const int row_off = L.row_off[l];
  const float scale = L.scale[l];
  const long long base = static_cast<long long>(image) * L.n_out + L.col_start[l];
  for (int r = tid; r < L.quota[l]; r += kSelectThreads) {
    const unsigned long long kr = r < len ? key[r] : kEmptyKey;
    const long long o = base + r;
    octave[o] = l;
    if (kr != kEmptyKey) {
      const float4 p = c[static_cast<unsigned>(kr)];
      const int packed = __float_as_int(p.y);
      const int x = packed & 0xffff, y = packed >> 16;
      xy[2 * o] = __fmul_rn(__fadd_rn(__int2float_rn(x), p.z), scale);
      xy[2 * o + 1] = __fmul_rn(__fadd_rn(__int2float_rn(y), p.w), scale);
      axy[2 * o] = x;
      axy[2 * o + 1] = y + row_off;
      resp[o] = p.x;
      valid[o] = 1;
      delta[2 * o] = p.z;
      delta[2 * o + 1] = p.w;
    } else {
      xy[2 * o] = 0.0f;
      xy[2 * o + 1] = 0.0f;
      axy[2 * o] = 0;
      axy[2 * o + 1] = row_off;
      resp[o] = 0.0f;
      valid[o] = 0;
      delta[2 * o] = 0.0f;
      delta[2 * o + 1] = 0.0f;
    }
  }
}

}  // namespace

// atlas: float32 [b, atlas_h, atlas_w] contiguous; levels: the table's
// words (host memory, copied into the kernels' parameters); cand: float32
// [b, total_cand, 4] scratch; xy, delta: float32 [b, n_out, 2]; axy: int32
// [b, n_out, 2]; resp: float32 [b, n_out]; octave: int32 [b, n_out]; valid:
// bool [b, n_out].  Launches the cell pass and the select pass on `stream`;
// returns the first CUDA error, else cudaGetLastError().
extern "C" int orb_detect_launch(const float* atlas, int b, int atlas_h, int atlas_w, const void* levels,
                                 float* cand, float* xy, int* axy, float* resp, int* octave, unsigned char* valid,
                                 float* delta, void* stream) {
  Levels L;
  memcpy(&L, levels, sizeof(Levels));
  if (b <= 0 || L.n_out <= 0) return static_cast<int>(cudaGetLastError());
  int select_shared = 0;
  for (int l = 0; l < L.n_levels; ++l) select_shared = L.sort_len[l] * 8 > select_shared ? L.sort_len[l] * 8 : select_shared;
  if (select_shared > kMaxSelectShared) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kMaxDevices = 64;
  static bool ready[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(orb_detect_select, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSelectShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[dev] = true;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  orb_detect_cells<<<dim3(L.total_cells, b), kCellThreads, kCellShared, s>>>(
      atlas, atlas_h, atlas_w, L, reinterpret_cast<float4*>(cand));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  orb_detect_select<<<dim3(L.n_levels, b), kSelectThreads, select_shared, s>>>(
      L, reinterpret_cast<const float4*>(cand), xy, axy, resp, octave, valid, delta);
  return static_cast<int>(cudaGetLastError());
}
