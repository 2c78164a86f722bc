"""PyTorch + CUDA port of slam_rgbd_tpu, tracking path first.

Mirrors the layout and names of `slam_rgbd_tpu` so that each module's
counterpart is easy to find. It shares the configuration tree with the JAX
package (`slam_rgbd_tpu.core.config`, which needs only numpy) and never
imports jax. Kernels are CUDA C++ for Hopper under `ops/csrc/`, built with
nvcc at first use.
"""

from slam_rgbd_tpu.core.config import (  # noqa: F401
    CameraIntrinsics,
    SLAMConfig,
    astra_default_config,
)
from slam_rgbd_tpu_torch.runtime.session import TrackingSession  # noqa: F401
