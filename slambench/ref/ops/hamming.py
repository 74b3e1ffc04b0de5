# Frozen copy of orb_line_slam_tpu_torch/ops/hamming.py at commit d30c4f7 (the benchmark's plain reference).
"""Hamming distance on packed 256-bit binary descriptors.

Port of ``orb_line_slam_tpu/ops/hamming.py:32-119`` (unpack_bits,
pack_bits, hamming_matrix, knn2, mutual_best).  The JAX package's
``hamming_matrix`` is a ±1 int8 matmul shaped for the MXU; here it is
XOR + popcount on 64-bit words in integer arithmetic (no float, so no
TF32 hazard), row-chunked to bound the [N, M] temporaries.
Descriptors are uint8 [..., 32], LSB-first within each byte, as OpenCV.
"""

from __future__ import annotations

import functools

import torch

DESC_BYTES = 32
DESC_BITS = 256

# Matching thresholds mirrored from the reference family
# (ORBmatcher.cc: TH_LOW=50, TH_HIGH=100).
TH_LOW = 50
TH_HIGH = 100

# Elements per [rows, M] int64 temporary (~128 MB).
_CHUNK_ELEMS = 1 << 24


def unpack_bits(desc: torch.Tensor) -> torch.Tensor:
    """uint8[..., 32] -> uint8[..., 256] of {0,1}, LSB-first per byte."""
    shifts = torch.arange(8, dtype=torch.uint8, device=desc.device)
    bits = (desc[..., :, None] >> shifts) & 1
    return bits.reshape(*desc.shape[:-1], DESC_BITS)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """{0,1}[..., 256] -> packed uint8[..., 32], LSB-first per byte."""
    b = bits.reshape(*bits.shape[:-1], DESC_BYTES, 8).to(torch.uint8)
    shifts = torch.arange(8, dtype=torch.uint8, device=bits.device)
    return torch.sum(b << shifts, dim=-1).to(torch.uint8)


def _words(desc: torch.Tensor) -> torch.Tensor:
    """uint8 [..., 32] -> int64 [..., 4] (same bits: byte j of a word is
    bits 8j..8j+7, as a little-endian view gives them).  Built with shifts
    and a sum of disjoint bit fields rather than a dtype view, which
    torch.func.vmap cannot batch in every torch release."""
    b = desc.reshape(*desc.shape[:-1], DESC_BYTES // 8, 8).to(torch.int64)
    return torch.sum(b << _byte_shifts(desc.device), dim=-1)


@functools.lru_cache(maxsize=8)
def _byte_shifts(device: torch.device) -> torch.Tensor:
    return torch.arange(0, 64, 8, dtype=torch.int64, device=device)


def _popcount64(x: torch.Tensor) -> torch.Tensor:
    """Bit count of int64 words (SWAR, no overflow).  Arithmetic right
    shifts only smear bit 63, which every mask below clears."""
    x = x - ((x >> 1) & 0x5555555555555555)
    x = (x & 0x3333333333333333) + ((x >> 2) & 0x3333333333333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    x = x + (x >> 32)
    return x & 0x7F


def _hamming_words(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum over the 4 words of popcount(a ^ b), broadcasting a and b."""
    acc = _popcount64(a[..., 0] ^ b[..., 0])
    for w in range(1, 4):
        acc = acc + _popcount64(a[..., w] ^ b[..., w])
    return acc.to(torch.int32)


def hamming_matrix(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """All-pairs Hamming distance: uint8 [..., N, 32] x uint8 [..., M, 32]
    -> int32 [..., N, M] in [0, 256] (leading dims broadcast)."""
    a = _words(desc_a)
    b = _words(desc_b)
    n, m = a.shape[-2], b.shape[-2]
    batch = max(1, int(torch.broadcast_shapes(a.shape[:-2], b.shape[:-2]).numel()))
    rows = max(1, _CHUNK_ELEMS // max(1, batch * m))
    out = [
        _hamming_words(a[..., r0:r0 + rows, None, :], b[..., None, :, :])
        for r0 in range(0, max(n, 1), rows)
    ]
    return torch.cat(out, dim=-2) if len(out) > 1 else out[0]


def hamming_pairwise(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """Row-aligned Hamming distance: uint8[..., 32] x uint8[..., 32] -> int32[...]."""
    return _hamming_words(_words(desc_a), _words(desc_b))


def knn2(dist: torch.Tensor, valid_cols: torch.Tensor | None = None):
    """Best and second-best match per row of an int32 [..., N, M] distance
    matrix; invalid columns count as 512.  Ties go to the lower index
    (as argmin / lax.top_k).  Returns (best_idx int32, best_dist, second_dist)."""
    if valid_cols is not None:
        dist = torch.where(valid_cols, dist, torch.full_like(dist, 512))
    d1, i1 = torch.min(dist, dim=-1)
    cols = torch.arange(dist.shape[-1], device=dist.device)
    d2 = torch.where(cols == i1[..., None], torch.full_like(dist, 1 << 20), dist).amin(dim=-1)
    return i1.to(torch.int32), d1, d2


def mutual_best(dist: torch.Tensor) -> torch.Tensor:
    """Mutual nearest-neighbour mask from a distance matrix [N, M]."""
    best_ab = torch.argmin(dist, dim=1)
    best_ba = torch.argmin(dist, dim=0)
    return best_ba[best_ab] == torch.arange(dist.shape[0], device=dist.device)
