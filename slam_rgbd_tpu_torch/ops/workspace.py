"""Scratch for kernels that sum or merge across thread blocks in one launch.

Such a kernel (`csrc/gn_reduce.cu`, `csrc/hamming.cu`) writes a partial a
block into a table, fences, and takes a ticket from a counter; the block
that draws the last ticket folds the table, writes the outputs and sets the
counter back to 0.

Invariant: the counters are zero between launches. A launch leaves them
zero once its last block has run; a launch that CUDA refuses never starts
and leaves them as they were. A kernel that aborts midway poisons the CUDA
context, after which no launch of the process succeeds anyway. So one
workspace serves every later launch of the same size on the same stream,
whichever kernel makes it: launches on one stream run in order, also where
a new stream has taken over a destroyed one's handle. Each stream has its
own workspace, so launches on the session's backend stream and on the
frontend's never share counters; the get-or-create is safe under several
threads.
"""

from __future__ import annotations

import threading

import torch

_workspaces: dict = {}
_lock = threading.Lock()


def workspace(device, stream: int, n_words: int, n_counters: int):
    """(table of `n_words` 32-bit words, `n_counters` zeroed int32 ticket
    counters) for launches on `stream` (the stream's handle) of `device`,
    made at the first such call and kept for the life of the process."""
    key = (device.index, stream, n_words, n_counters)
    with _lock:
        ws = _workspaces.get(key)
        if ws is None:
            ws = _workspaces[key] = (
                torch.empty(n_words, dtype=torch.int32, device=device),
                torch.zeros(n_counters, dtype=torch.int32, device=device),
            )
    return ws
