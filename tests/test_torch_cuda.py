"""The port on a CUDA card: the hand-written `gn_reduce` kernel against its
plain torch version, and the tracking session on the card against the same
session on the CPU.

Every test here needs a card and skips without one. The file imports no jax
(the machine with the card has none), so it runs there on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from slam_rgbd_tpu.core.config import CameraIntrinsics, ICPConfig, SLAMConfig
from slam_rgbd_tpu_torch import TrackingSession
from slam_rgbd_tpu_torch.core import camera
from slam_rgbd_tpu_torch.io.synthetic import SyntheticSequence, render_frame
from slam_rgbd_tpu_torch.odometry import icp
from slam_rgbd_tpu_torch.ops import gn_reduce as tg

CAM = CameraIntrinsics(fx=142.6, fy=142.6, cx=79.5, cy=59.5, width=160, height=120)


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("radius", [2, 4, 8])
def test_kernel_matches_reference_on_card(cuda_device, radius):
    """Kernel vs plain version on one rendered frame pair at each radius.
    Tolerances of tests/test_icp_pallas.py:60-71 (sums in another order);
    inliers exact, since per-pixel arithmetic rounds alike; repeated
    launches give identical output (no atomics)."""
    seq = SyntheticSequence(2, CAM, device=cuda_device)
    pyrs = []
    for pose in seq.poses:
        depth, rgb = render_frame(pose, CAM, device=cuda_device)
        pyrs.append(camera.build_frame_pyramid(depth, CAM, levels=1, rgb=rgb))
    T = torch.from_numpy(np.linalg.inv(seq.poses[0]) @ seq.poses[1]).to(cuda_device)
    src = icp.level_planes(pyrs[1][0])[: tg.SRC_CHANNELS].contiguous()
    tgt = icp.level_planes(pyrs[0][0])
    _, up, vp, _ = icp._project_level(T, pyrs[1][0]["vertices"], CAM)
    mu = icp.flow_shift(up, vp, CAM.height, CAM.width)
    cfg = ICPConfig()
    before = tg.gn_reduce.launches
    k1 = tg.gn_reduce(T, mu, src, tgt, CAM, cfg, radius)
    k2 = tg.gn_reduce(T, mu, src, tgt, CAM, cfg, radius)
    ref = tg.gn_reduce_reference(T, mu, src, tgt, CAM, cfg, radius)
    torch.cuda.synchronize()
    assert tg.gn_reduce.launches == before + 2
    for a, b in zip(k1, k2):
        assert torch.equal(a, b)
    H1, g1, i1, s1 = (x.cpu().numpy() for x in k1)
    H0, g0, i0, s0 = (x.cpu().numpy() for x in ref)
    assert int(i1) == int(i0) > 1000
    h_scale = max(1.0, float(np.abs(H0).max()))
    np.testing.assert_allclose(H1 / h_scale, H0 / h_scale, atol=2e-6)
    g_scale = max(1.0, float(np.abs(g0).max()))
    np.testing.assert_allclose(g1 / g_scale, g0 / g_scale, atol=5e-5)
    np.testing.assert_allclose(float(s1), float(s0), rtol=1e-4)


@pytest.mark.cuda
def test_kernel_rejects_bad_input_on_card(cuda_device):
    src = torch.zeros((8, 12, 16), device=cuda_device)
    tgt = torch.zeros((10, 12, 16), device=cuda_device)
    T = torch.eye(4, device=cuda_device)
    mu = torch.zeros(2, device=cuda_device)
    with pytest.raises(ValueError):
        tg.gn_reduce(T.cpu(), mu, src, tgt, CAM, ICPConfig(), 2)
    with pytest.raises(ValueError):
        tg.gn_reduce(T, mu, src[:, :, ::2], tgt, CAM, ICPConfig(), 2)
    H, g, inl, sq = tg.gn_reduce(T, mu, src, tgt, CAM, ICPConfig(), 2)
    assert int(inl) == 0 and float(sq) == 0.0 and not H.any()


@pytest.mark.cuda
def test_session_on_card_matches_cpu(cuda_device):
    """The default tracking path on the card: 42 kernel launches a tracked
    frame, and the poses of the same session on the CPU to 1e-4."""
    cfg = SLAMConfig(camera=CAM)
    seq = SyntheticSequence(6, CAM, sweep=True)
    frames = list(seq)
    out = {}
    for dev in ("cpu", cuda_device):
        sess = TrackingSession(cfg, device=dev)
        before = tg.gn_reduce.launches
        for f in frames:
            sess.process_frame(*f)
        out[str(dev)] = sess.poses()[1]
        assert sess.state.lost == 0
        launched = tg.gn_reduce.launches - before
        assert launched == (42 * (len(frames) - 1) if dev != "cpu" else 0)
    np.testing.assert_allclose(out[str(cuda_device)], out["cpu"], atol=1e-4)
