"""Frames from the host onto the session's device.

A frame from a file, a dataset or a camera is a numpy array. `upload_plain`
is the straightforward copy: `torch.tensor(x, device=cuda)` copies from
pageable memory, which waits for all device work queued before it on the
stream, so a session fed that way blocks once a frame. `PinnedStaging`
copies through a ring of page-locked buffers instead, with
`non_blocking=True` on the caller's current stream: the call returns while
the device is still busy. A slot is written again only after an event
recorded behind its last copy has passed, so a copy still in flight is
never overwritten. The first array of a shape and dtype allocates its ring
(page-locking memory may wait for the device); after that no call waits for
the stream. uint16 depth goes up as its bytes and is widened to int32 on the
device (torch has few uint16 kernels); the result equals `upload_plain`'s
bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch


def upload_plain(x, device) -> torch.Tensor:
    """The plain upload: uint16 becomes int32 on the host, then a
    synchronizing copy from pageable memory."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    x = np.asarray(x)
    if x.dtype == np.uint16:
        x = x.astype(np.int32)
    return torch.tensor(x, device=device)


class PinnedStaging:
    """A ring of `n_slots` page-locked buffers for each frame array shape
    and dtype, allocated at the first array of that kind."""

    def __init__(self, device: torch.device, n_slots: int = 2):
        if device.type != "cuda":
            raise ValueError(f"pinned staging is for a CUDA device, not {device}")
        if n_slots < 2:
            raise ValueError("pinned staging needs at least two slots")
        self.device = device
        self.n_slots = n_slots
        # (shape, dtype) -> [buffers, events, next slot]
        self._rings: dict = {}

    def upload(self, x: np.ndarray) -> torch.Tensor:
        """Copy `x` to the device on the current stream without waiting for
        it; returns the device tensor (uint16 widened to int32)."""
        x = np.ascontiguousarray(x)
        widen = x.dtype == np.uint16
        if widen:
            x = x.view(np.int16)
        key = (x.shape, x.dtype.str)
        ring = self._rings.get(key)
        if ring is None:
            dtype = torch.from_numpy(np.empty(0, x.dtype)).dtype
            ring = self._rings[key] = [
                [torch.empty(x.shape, dtype=dtype, pin_memory=True)
                 for _ in range(self.n_slots)],
                [torch.cuda.Event() for _ in range(self.n_slots)],
                0,
            ]
        bufs, events, i = ring
        ring[2] = (i + 1) % self.n_slots
        events[i].synchronize()  # the slot's previous copy has left it
        np.copyto(bufs[i].numpy(), x)
        out = bufs[i].to(self.device, non_blocking=True)
        events[i].record(torch.cuda.current_stream(self.device))
        if widen:
            out = out.to(torch.int32) & 0xFFFF
        return out
