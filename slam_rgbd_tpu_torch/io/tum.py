"""TUM RGB-D dataset loader with depth / colour association.

Counterpart of `slam_rgbd_tpu/io/tum.py`, in numpy. A TUM sequence directory
holds:

    rgb.txt / depth.txt      "timestamp filename" lists
    groundtruth.txt          "timestamp tx ty tz qx qy qz qw"
    rgb/*.png, depth/*.png   16-bit depth PNGs scaled by 5000

`TUMSequence` pairs depth and colour by nearest timestamp (a `max_offset`
gate, as the TUM `associate.py` tool does) and has the loader protocol of
`SyntheticSequence`: `__len__`, `frame(i) -> (ts, depth_raw, rgb)` as host
arrays, `groundtruth()`. PNGs are decoded by PIL when it is installed, else
by the built-in decoder (zlib + numpy, non-interlaced 8/16-bit images),
which gives the same arrays.
"""

from __future__ import annotations

import logging
import os
import struct
import zlib

import numpy as np

from slam_rgbd_tpu_torch.core.config import CameraIntrinsics
from slam_rgbd_tpu_torch.eval.trajectory import matrix_to_quat, quat_to_matrix  # noqa: F401


log = logging.getLogger("slam_rgbd_tpu_torch.io.tum")

# --------------------------------------------------------------------- PNG IO
_WARNED_SLOW_PNG = False


def _read_png(path: str) -> np.ndarray:
    """PNG decode: PIL when available, else the built-in decoder."""
    try:
        import PIL.Image  # type: ignore
    except ImportError:
        global _WARNED_SLOW_PNG
        if not _WARNED_SLOW_PNG:
            _WARNED_SLOW_PNG = True
            log.warning(
                "PIL not available: using the built-in PNG decoder (none / up "
                "/ sub rows vectorized, average / paeth rows scanned a pixel "
                "at a time)"
            )
        return _read_png_builtin(path)
    with PIL.Image.open(path) as img:
        return np.asarray(img)


def _read_png_builtin(path: str) -> np.ndarray:
    """Minimal PNG decoder: 8-bit RGB/gray and 16-bit gray, non-interlaced.

    Pure zlib + numpy, no image-library dependency (tested bit-identical
    to PIL on the golden TUM frames in tests/data/tum_golden)."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n", f"not a PNG: {path}"
    pos = 8
    idat = b""
    width = height = bitdepth = colortype = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        ctype = data[pos + 4 : pos + 8]
        chunk = data[pos + 8 : pos + 8 + length]
        if ctype == b"IHDR":
            width, height, bitdepth, colortype = struct.unpack(">IIBB", chunk[:10])
            assert chunk[12] == 0, "interlaced PNG unsupported"
        elif ctype == b"IDAT":
            idat += chunk
        elif ctype == b"IEND":
            break
        pos += 12 + length
    raw = zlib.decompress(idat)
    channels = {0: 1, 2: 3, 4: 2, 6: 4}[colortype]
    bpp = channels * (bitdepth // 8)
    stride = width * bpp
    out = np.empty(height * stride, dtype=np.uint8)
    prev = np.zeros(stride, dtype=np.uint8)
    ptr = 0
    for y in range(height):
        ft = raw[ptr]
        line = np.frombuffer(raw, dtype=np.uint8, count=stride, offset=ptr + 1).copy()
        ptr += 1 + stride
        if ft == 0:
            pass
        elif ft == 2:  # up
            line = (line.astype(np.int32) + prev).astype(np.uint8)
        elif ft == 1:  # sub: per-byte-lane prefix sum (mod-256 cumsum)
            line = _unfilter_sub(line, bpp)
        elif ft in (3, 4):  # average / paeth: left-dependency, per-pixel scan
            line = _unfilter_scan(line, prev, bpp, ft)
        else:
            raise ValueError(f"bad filter {ft}")
        out[y * stride : (y + 1) * stride] = line
        prev = line
    img = out.reshape(height, stride)
    if bitdepth == 16:
        img = img.reshape(height, width, channels, 2)
        img = (img[..., 0].astype(np.uint16) << 8) | img[..., 1]
    else:
        img = img.reshape(height, width, channels)
    if channels == 1:
        img = img[..., 0]
    return img


def _unfilter_sub(line: np.ndarray, bpp: int) -> np.ndarray:
    """PNG 'sub' filter, vectorized: out[i] = (line[i] + out[i-bpp]) % 256
    is a prefix sum over each of the bpp interleaved byte lanes, and mod
    distributes over addition — one cumsum per row instead of a per-byte
    Python loop."""
    n = len(line)
    lanes = line[: n - n % bpp].reshape(-1, bpp).astype(np.int64)
    out = np.cumsum(lanes, axis=0) & 0xFF
    return out.astype(np.uint8).reshape(-1)[:n]


def _unfilter_scan(line: np.ndarray, prev: np.ndarray, bpp: int, ft: int) -> np.ndarray:
    """PNG 'average'/'paeth' filters: the left-neighbour dependency forces
    a sequential scan, but only over PIXELS — the bpp byte lanes of each
    pixel are independent and process as one numpy vector per step
    (bpp x fewer Python iterations than the old per-byte loop)."""
    n = len(line)
    n_pix = n // bpp
    out = line[: n_pix * bpp].reshape(n_pix, bpp).astype(np.int32)
    p = prev[: n_pix * bpp].reshape(n_pix, bpp).astype(np.int32)
    a = np.zeros(bpp, dtype=np.int32)  # left pixel (reconstructed)
    c = np.zeros(bpp, dtype=np.int32)  # upper-left pixel
    for i in range(n_pix):
        b = p[i]
        if ft == 3:
            out[i] = (out[i] + ((a + b) >> 1)) & 0xFF
        else:  # paeth
            pa = np.abs(b - c)
            pb = np.abs(a - c)
            pc = np.abs(a + b - 2 * c)
            pred = np.where(
                (pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c)
            )
            out[i] = (out[i] + pred) & 0xFF
        a = out[i]
        c = b
    return out.astype(np.uint8).reshape(-1)[:n]


# ------------------------------------------------------------------ TUM lists
def _read_list(path: str):
    """Parse a TUM 'timestamp data...' file -> list of (ts, fields)."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            rows.append((float(parts[0]), parts[1:]))
    return rows


def associate(a, b, max_offset: float = 0.02):
    """Greedy nearest-timestamp association between two (ts, ...) lists.

    Same contract as the TUM benchmark's associate.py: each entry used at
    most once, pairs sorted by |dt| then by time. Candidate generation is
    one numpy broadcast (a fr2-length sequence has ~9M timestamp pairs —
    a Python double loop took minutes; this takes milliseconds). Only the
    (short) mutual-exclusion sweep stays sequential, as it must: each
    acceptance invalidates later candidates.
    """
    ta = np.asarray([t for t, _ in a])
    tb = np.asarray([t for t, _ in b])
    if len(ta) == 0 or len(tb) == 0:
        return []
    dt = np.abs(ta[:, None] - tb[None, :])
    ii, jj = np.nonzero(dt < max_offset)
    dv = dt[ii, jj]
    order = np.lexsort((jj, ii, dv))  # sort by |dt|, then i, then j
    used_a = np.zeros(len(ta), dtype=bool)
    used_b = np.zeros(len(tb), dtype=bool)
    out = []
    for k in order:
        i, j = int(ii[k]), int(jj[k])
        if not used_a[i] and not used_b[j]:
            used_a[i] = True
            used_b[j] = True
            out.append((i, j))
    out.sort()
    return out


class TUMSequence:
    """A TUM RGB-D sequence directory, associated and ground-truth-aligned."""

    def __init__(self, root: str, cam: CameraIntrinsics, max_offset: float = 0.02):
        self.root = root
        self.cam = cam
        rgb_list = _read_list(os.path.join(root, "rgb.txt"))
        depth_list = _read_list(os.path.join(root, "depth.txt"))
        pairs = associate(depth_list, rgb_list, max_offset)
        self._depth_files = [os.path.join(root, depth_list[i][1][0]) for i, _ in pairs]
        self._rgb_files = [os.path.join(root, rgb_list[j][1][0]) for _, j in pairs]
        self.timestamps = np.array([depth_list[i][0] for i, _ in pairs])

        gt_path = os.path.join(root, "groundtruth.txt")
        self._gt = None
        if os.path.exists(gt_path):
            gt = _read_list(gt_path)
            gt_ts = np.array([t for t, _ in gt])
            poses = []
            for ts in self.timestamps:
                k = int(np.argmin(np.abs(gt_ts - ts)))
                tx, ty, tz, qx, qy, qz, qw = map(float, gt[k][1][:7])
                T = np.eye(4, dtype=np.float32)
                T[:3, :3] = quat_to_matrix(qx, qy, qz, qw)
                T[:3, 3] = (tx, ty, tz)
                poses.append(T)
            self._gt = np.stack(poses)

    def __len__(self) -> int:
        return len(self.timestamps)

    def frame(self, i: int):
        depth = _read_png(self._depth_files[i]).astype(np.uint16)
        rgb = _read_png(self._rgb_files[i])
        if rgb.ndim == 2:
            rgb = np.stack([rgb] * 3, axis=-1)
        return float(self.timestamps[i]), depth, rgb[..., :3].astype(np.uint8)

    def __iter__(self):
        for i in range(len(self)):
            yield self.frame(i)

    def groundtruth(self):
        return self._gt
