"""Fused Hamming matching: plain torch versions + the two kernels.

Counterpart of `slam_rgbd_tpu/ops/hamming_pallas.py`. Descriptors are sign
matrices, (K, 256) int8 in {-1, +1}; the distance of a pair is the number of
positions where the signs differ, d = (256 - s1 . s2) / 2.

`hamming_top2`: per query the best and second-best distance over all columns
and the first index of the best. A pair with an invalid side reads 1e9. The
second best is the least over every column except the one argmin column, so
two columns at the best distance give second == best.

`gated_match`: one distance pass with two gated argmins, for map association.

  q_meta (K1, 8) float32: [u, v, z, valid, xw, yw, zw, |pw|^2]
  p_meta (K2, 8) float32: [pu, pv, z, ok, x, y, z, |p|^2]

Tier 1 keeps pairs with pixel distance^2 < px_radius^2 and
|z_q - z_p| < z_rel_tol * max(z_q, 0.3); tier 2 keeps pairs with 3-D
distance^2 < merge_radius * |merge_radius|, by |q|^2 + |p|^2 - 2 q.p (a
negative radius turns the tier off). The first index wins ties; a row with
nothing left returns 1e9 and index 0. Callers threshold on the distance.

Each wrapper dispatches on the device of its first argument: a CPU tensor
goes to the plain version (`*_reference`), a CUDA tensor to the hand-written
kernel in `csrc/hamming.cu`, and any error there raises. The kernels take
the same sign product on the int8 tensor cores from the rows as they are, so
every output equals the plain version's bit for bit, a valid row of zeros
included (it reads 128). On the card a call is one kernel launch and no
other device operation.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple

import numpy as np
import torch

from slam_rgbd_tpu_torch.ops.workspace import workspace

N_BITS = 256
META = 8
BIG = 1e9
# the frontend and the session's backend thread both launch; a counter's
# += is a read-modify-write
_count_lock = threading.Lock()


class Matches(NamedTuple):
    idx1: torch.Tensor  # (K,) int32: index into set 1 (identity)
    idx2: torch.Tensor  # (K,) int32: best match in set 2
    distance: torch.Tensor  # (K,) float32 Hamming distance
    valid: torch.Tensor  # (K,) bool


def _f32(x: float) -> float:
    """Round a Python float to the nearest float32, as the kernel sees it."""
    return float(np.float32(x))


def hamming_matrix(signs1: torch.Tensor, signs2: torch.Tensor) -> torch.Tensor:
    """(K1, 256) x (K2, 256) sign descriptors -> (K1, K2) float32 distances
    by the sign product; exact, since every value is a small integer."""
    s = signs1.to(torch.float32) @ signs2.to(torch.float32).T
    return 0.5 * (signs1.shape[-1] - s)


def _first_argmin(d: torch.Tensor):
    """Row-wise (min, first index of the min) of a (K1, K2) matrix."""
    best = d.min(dim=1, keepdim=True).values
    col = torch.arange(d.shape[1], device=d.device)
    idx = torch.where(d <= best, col, d.shape[1]).min(dim=1).values
    return best[:, 0], idx


def hamming_top2_reference(signs1, valid1, signs2, valid2):
    """Plain torch version of `hamming_top2`: the (K1, K2) matrix written
    out, then the selection. -> (best f32, second f32, idx i32), each (K1,)."""
    _check_top2(signs1, valid1, signs2, valid2)
    d = hamming_matrix(signs1, signs2)
    d = torch.where(valid1[:, None] & valid2[None, :], d, BIG)
    best, idx = _first_argmin(d)
    col = torch.arange(d.shape[1], device=d.device)
    second = torch.where(col == idx[:, None], BIG, d).min(dim=1).values
    return best, second, idx.to(torch.int32)


def gated_match_reference(signs1, q_meta, signs2, p_meta,
                          px_radius: float = 6.0, z_rel_tol: float = 0.08,
                          merge_radius: float = 0.05):
    """Plain torch version of `gated_match`, gate arithmetic op for op in the
    kernel's order. -> (d1 f32, i1 i32, d2 f32, i2 i32), each (K1,)."""
    _check_gated(signs1, q_meta, signs2, p_meta)
    px2, tol, mr2 = _gate_constants(px_radius, z_rel_tol, merge_radius)
    q = q_meta.unbind(1)
    p = p_meta.unbind(1)
    d = hamming_matrix(signs1, signs2)
    base_ok = (q[3][:, None] > 0.5) & (p[3][None, :] > 0.5)
    d = torch.where(base_ok, d, BIG)

    du = q[0][:, None] - p[0][None, :]
    dv = q[1][:, None] - p[1][None, :]
    z_ok = torch.abs(q[2][:, None] - p[2][None, :]) < (
        tol * torch.clamp_min(q[2], 0.3)[:, None]
    )
    d1 = torch.where((du * du + dv * dv < px2) & z_ok, d, BIG)

    # three explicit products summed left to right, not a matmul: the kernel
    # rounds them so
    cross = (q[4][:, None] * p[4][None, :] + q[5][:, None] * p[5][None, :]
             + q[6][:, None] * p[6][None, :])
    dist2 = q[7][:, None] + p[7][None, :] - 2.0 * cross
    d2 = torch.where(dist2 < mr2, d, BIG)

    b1, i1 = _first_argmin(d1)
    b2, i2 = _first_argmin(d2)
    return b1, i1.to(torch.int32), b2, i2.to(torch.int32)


def _gate_constants(px_radius: float, z_rel_tol: float, merge_radius: float):
    """(px_radius^2, z_rel_tol, signed merge_radius^2), each as float32."""
    return (_f32(px_radius * px_radius), _f32(z_rel_tol),
            _f32(merge_radius * abs(merge_radius)))


def _check_signs(name: str, fn: str, signs, ref) -> None:
    if signs.device != ref.device:
        raise ValueError(f"{fn}: {name} on {signs.device}, signs1 on {ref.device}")
    if signs.dtype != torch.int8 or signs.dim() != 2 or signs.shape[1] != N_BITS:
        raise ValueError(
            f"{fn}: {name} must be (K, {N_BITS}) int8, got "
            f"{tuple(signs.shape)} {signs.dtype}")
    if not signs.is_contiguous():
        raise ValueError(f"{fn}: {name} must be contiguous")


def _check_top2(signs1, valid1, signs2, valid2) -> None:
    fn = "hamming_top2"
    for name, s, v in (("1", signs1, valid1), ("2", signs2, valid2)):
        _check_signs("signs" + name, fn, s, signs1)
        if v.device != signs1.device or v.dtype != torch.bool or not v.is_contiguous():
            raise ValueError(
                f"{fn}: valid{name} must be a contiguous bool tensor on "
                f"{signs1.device}, got {v.dtype} on {v.device}")
        if v.shape != (s.shape[0],):
            raise ValueError(
                f"{fn}: valid{name} must be ({s.shape[0]},), got {tuple(v.shape)}")
    if signs1.shape[0] == 0 or signs2.shape[0] == 0:
        raise ValueError(f"{fn}: empty descriptor set")


def _check_gated(signs1, q_meta, signs2, p_meta) -> None:
    fn = "gated_match"
    for name, s, m in (("1", signs1, q_meta), ("2", signs2, p_meta)):
        _check_signs("signs" + name, fn, s, signs1)
        if m.device != signs1.device or m.dtype != torch.float32 or not m.is_contiguous():
            raise ValueError(
                f"{fn}: meta{name} must be contiguous float32 on "
                f"{signs1.device}, got {m.dtype} on {m.device}")
        if m.shape != (s.shape[0], META):
            raise ValueError(
                f"{fn}: meta{name} must be ({s.shape[0]}, {META}), got "
                f"{tuple(m.shape)}")
    if signs1.shape[0] == 0 or signs2.shape[0] == 0:
        raise ValueError(f"{fn}: empty descriptor set")


def _check_aligned(fn: str, *tensors) -> None:
    """The kernels read rows in 16-byte pieces."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{fn}: a {tuple(t.shape)} input is not 16-byte aligned")


@functools.lru_cache(maxsize=None)
def _workspace_size(k1: int, k2: int) -> tuple[int, int]:
    """(table words, ticket counters) a launch at (k1, k2) needs: the
    kernel library's own plan."""
    from slam_rgbd_tpu_torch.ops import _build

    words, counters = ctypes.c_long(), ctypes.c_int()
    _build.load().hamming_workspace(k1, k2, ctypes.byref(words), ctypes.byref(counters))
    return words.value, counters.value


def _scratch(k1: int, k2: int, dev):
    """(partial table, ticket counters, stream handle) of a launch at (k1, k2)
    on the current stream of `dev`."""
    stream = torch.cuda.current_stream(dev).cuda_stream
    return (*workspace(dev, stream, *_workspace_size(k1, k2)), stream)


def hamming_top2(signs1, valid1, signs2, valid2):
    """Per query (best, second, first index of best) against set 2.

    signs (K, 256) int8, valid (K,) bool; K1 and K2 are free. CPU tensors
    take `hamming_top2_reference`. CUDA tensors launch the kernel on the
    current stream (no host sync) and count one in `hamming_top2.launches`;
    a CUDA error raises.
    """
    if signs1.device.type == "cpu":
        return hamming_top2_reference(signs1, valid1, signs2, valid2)
    if signs1.device.type != "cuda":
        raise ValueError(f"hamming_top2: no kernel for device {signs1.device}")
    _check_top2(signs1, valid1, signs2, valid2)
    _check_aligned("hamming_top2", signs1, signs2)
    from slam_rgbd_tpu_torch.ops import _build

    lib = _build.load()
    dev = signs1.device
    k1, k2 = signs1.shape[0], signs2.shape[0]
    best = torch.empty(k1, dtype=torch.float32, device=dev)
    second = torch.empty(k1, dtype=torch.float32, device=dev)
    idx = torch.empty(k1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        table, counters, stream = _scratch(k1, k2, dev)
        err = lib.hamming_top2_launch(
            signs1.data_ptr(), valid1.data_ptr(), k1,
            signs2.data_ptr(), valid2.data_ptr(), k2,
            table.data_ptr(), counters.data_ptr(),
            best.data_ptr(), second.data_ptr(), idx.data_ptr(), stream,
        )
    _build.check(err, "hamming_top2 launch")
    with _count_lock:
        hamming_top2.launches += 1
    return best, second, idx


hamming_top2.launches = 0


def gated_match(signs1, q_meta, signs2, p_meta, px_radius: float = 6.0,
                z_rel_tol: float = 0.08, merge_radius: float = 0.05):
    """Two-tier gated matching -> (d1, i1, d2, i2), each (K1,).

    The radii are plain floats of the call. CPU tensors take
    `gated_match_reference`. CUDA tensors launch the kernel on the current
    stream (no host sync) and count one in `gated_match.launches`; a CUDA
    error raises.
    """
    if signs1.device.type == "cpu":
        return gated_match_reference(signs1, q_meta, signs2, p_meta,
                                     px_radius, z_rel_tol, merge_radius)
    if signs1.device.type != "cuda":
        raise ValueError(f"gated_match: no kernel for device {signs1.device}")
    _check_gated(signs1, q_meta, signs2, p_meta)
    _check_aligned("gated_match", signs1, q_meta, signs2, p_meta)
    from slam_rgbd_tpu_torch.ops import _build

    lib = _build.load()
    dev = signs1.device
    k1, k2 = signs1.shape[0], signs2.shape[0]
    px2, tol, mr2 = _gate_constants(px_radius, z_rel_tol, merge_radius)
    d1 = torch.empty(k1, dtype=torch.float32, device=dev)
    d2 = torch.empty(k1, dtype=torch.float32, device=dev)
    i1 = torch.empty(k1, dtype=torch.int32, device=dev)
    i2 = torch.empty(k1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        table, counters, stream = _scratch(k1, k2, dev)
        err = lib.gated_match_launch(
            signs1.data_ptr(), q_meta.data_ptr(), k1,
            signs2.data_ptr(), p_meta.data_ptr(), k2,
            px2, tol, mr2, table.data_ptr(), counters.data_ptr(),
            d1.data_ptr(), i1.data_ptr(), d2.data_ptr(), i2.data_ptr(), stream,
        )
    _build.check(err, "gated_match launch")
    with _count_lock:
        gated_match.launches += 1
    return d1, i1, d2, i2


gated_match.launches = 0


def match_kernel(signs1, valid1, signs2, valid2, max_distance: float = 64.0,
                 ratio: float = 0.9, cross_check: bool = True) -> Matches:
    """Mutual-nearest matching with the ratio test through `hamming_top2`.

    The cross-check runs the kernel once more with the operands swapped, so
    no column-wise pass over a (K1, K2) matrix is needed.
    """
    best, second, idx = hamming_top2(signs1, valid1, signs2, valid2)
    ok = (best < max_distance) & (best < ratio * second) & valid1
    k1 = signs1.shape[0]
    rows = torch.arange(k1, device=signs1.device)
    if cross_check:
        _, _, idx_rev = hamming_top2(signs2, valid2, signs1, valid1)
        ok = ok & (idx_rev[idx.long()] == rows)
    return Matches(idx1=rows.to(torch.int32), idx2=idx, distance=best, valid=ok)
