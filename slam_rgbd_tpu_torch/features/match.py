"""Brute-force Hamming matching of 256-bit descriptors.

Counterpart of `slam_rgbd_tpu/features/match.py`. Descriptors are sign
matrices in {-1, +1}; `match` applies the standard gates with fixed shapes:

  * best < `max_distance` (absolute Hamming threshold),
  * best < `ratio` * second-best (Lowe ratio, per row),
  * mutual cross-check (row argmin == column argmin).

The reference chooses between an XLA path and its fused kernel; the port has
one path, so `match` is `ops.hamming.match_kernel` under the name the
callers of this module know: its `hamming_top2` takes the hand-written kernel
for CUDA tensors and the plain version for CPU tensors.
"""

from __future__ import annotations

import torch

from slam_rgbd_tpu_torch.ops.hamming import (  # noqa: F401
    Matches, hamming_matrix, match_kernel,
)


match = match_kernel


def pack_to_signs(packed: torch.Tensor) -> torch.Tensor:
    """(K, 8) packed 32-bit words -> (K, 256) int8 sign matrix."""
    k = packed.shape[0]
    shifts = torch.arange(32, dtype=torch.int64, device=packed.device)
    bits = (packed.to(torch.int64)[:, :, None] >> shifts) & 1
    return torch.where(bits.reshape(k, -1) > 0, 1, -1).to(torch.int8)


def hamming_packed(packed1: torch.Tensor, packed2: torch.Tensor) -> torch.Tensor:
    """Popcount Hamming on packed descriptors (an oracle for tests)."""
    mask = 0xFFFFFFFF
    x = (packed1.to(torch.int64)[:, None, :] ^ packed2.to(torch.int64)[None, :, :]) & mask
    # SWAR popcount per 32-bit word
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = ((x * 0x01010101) & mask) >> 24
    return x.sum(dim=-1).to(torch.float32)
