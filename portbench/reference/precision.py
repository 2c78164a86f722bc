"""Matrix products of the plain reference, in float32 or in TF32.

The configurations state float32 with TF32 off. Every matrix product of
the reference goes through `mm` / `einsum`, so that the output check's
control (the reference in the next precision below, TF32) is the same code
with the products' operands rounded to TF32's 10-bit mantissa, as the
tensor cores round them, and the products summed in float32. The rounding
is done here and not left to cuBLAS, which may or may not use its TF32
kernels for a small product.
"""

from __future__ import annotations

import contextlib
import threading

import torch


class _Mode(threading.local):
    tf32 = False


_MODE = _Mode()


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to the nearest TF32 value (10 mantissa bits,
    ties away from zero, as the conversion to TF32 rounds); other dtypes
    pass through."""
    if x.dtype != torch.float32:
        return x
    bits = x.contiguous().view(torch.int32)
    rounded = (bits + 0x1000) & ~0x1FFF
    out = rounded.view(torch.float32)
    return torch.where(torch.isfinite(x), out, x)


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`a @ b`, with both operands in TF32 under `tf32_products()`."""
    if _MODE.tf32:
        return to_tf32(a) @ to_tf32(b)
    return a @ b


def einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """`torch.einsum`, with every operand in TF32 under `tf32_products()`."""
    if _MODE.tf32:
        ops = tuple(to_tf32(o) for o in ops)
    return torch.einsum(eq, *ops)


@contextlib.contextmanager
def tf32_products():
    """The control: every product of the reference inside the block takes
    TF32 operands. Only the calling thread is affected."""
    _MODE.tf32 = True
    try:
        yield
    finally:
        _MODE.tf32 = False


def no_tf32() -> None:
    """Turn PyTorch's own TF32 paths off, so that `@` is float32 on a card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
