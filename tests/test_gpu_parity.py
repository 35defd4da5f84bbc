"""GPU-versus-CPU numerical parity of the main path (eval/parity.py).

Each test runs one device program on the GPU and on the host CPU in
this process and holds the two results to a contract.  The suite pins
JAX to the CPU unless JAX_PLATFORMS says otherwise, so these tests skip
there.  Run them on a machine with a GPU:

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/test_gpu_parity.py -v
"""

import jax
import pytest

from orb_line_slam_tpu.eval import parity

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def gpu():
    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("no GPU visible to JAX (the suite runs on the CPU)")
    return devices[0]


@pytest.fixture(scope="module")
def kitti_pair(gpu):
    import numpy as np

    cfg = parity.kitti_config()
    scene = parity.kitti_scene(cfg)
    iml, imr = scene.render_stereo(np.eye(3), np.zeros(3))
    return cfg, scene, iml, imr


def _assert_contract(checks):
    failed = [str(c) for c in checks if not c.ok]
    assert checks and not failed, "\n".join(failed)


def test_stereo_frame_parity(gpu, kitti_pair):
    cfg, _, iml, imr = kitti_pair
    _assert_contract(parity.frontend_checks(gpu, jax.devices("cpu")[0], cfg, iml, imr))


def test_line_frontend_parity(gpu, kitti_pair):
    cfg, _, iml, imr = kitti_pair
    _assert_contract(parity.line_checks(gpu, jax.devices("cpu")[0], cfg, iml, imr))


def test_pose_opt_parity(gpu):
    _assert_contract(parity.pose_opt_checks(gpu, jax.devices("cpu")[0]))


def test_track_step_parity(gpu, kitti_pair):
    cfg, scene, _, _ = kitti_pair
    _assert_contract(parity.track_step_checks(gpu, jax.devices("cpu")[0], cfg, scene))
