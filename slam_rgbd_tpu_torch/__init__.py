"""PyTorch + CUDA port of slam_rgbd_tpu: tracking, keyframes, relocalization,
the BA / loop / pose-graph backend and the multi-sequence batch session.

Mirrors the layout and names of `slam_rgbd_tpu` so that each module's
counterpart is easy to find. It imports nothing of the JAX package and never
imports jax: what it needs from there it keeps as its own copy (the
configuration tree, `core/config.py`). Kernels are CUDA C++ for Hopper under
`ops/csrc/`, built with nvcc at first use. Entry points run on the CUDA
device unless the caller asks for the CPU.
"""

from slam_rgbd_tpu_torch.core.config import (  # noqa: F401
    CameraIntrinsics,
    SLAMConfig,
    astra_default_config,
)
from slam_rgbd_tpu_torch.runtime.batch_session import BatchSession  # noqa: F401
from slam_rgbd_tpu_torch.runtime.session import (  # noqa: F401
    SLAMSession,
    TrackingSession,
)
