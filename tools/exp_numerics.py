"""Per-kernel device-vs-CPU numerics probe (drift-gap bisection).

Runs the geometry-critical kernels on the current platform with FIXED
inputs and dumps outputs to .npz; run once on the GPU and once on the
CPU, then compare:

  python tools/exp_numerics.py /tmp/gpu.npz
  JAX_PLATFORMS=cpu python tools/exp_numerics.py /tmp/cpu.npz
  python tools/exp_numerics.py --compare /tmp/cpu.npz /tmp/gpu.npz
"""
import os
import sys

os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    os.path.join(os.path.dirname(__file__), "..", ".jax_cache"),
)
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "1")
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

if os.environ.get("JAX_PLATFORMS") == "cpu":
    import jax

    jax.config.update("jax_platforms", "cpu")


def compare(a_path, b_path):
    A = np.load(a_path)
    B = np.load(b_path)
    for k in A.files:
        a, b = A[k], B[k]
        if a.dtype.kind in "iub":
            diff = (a != b).mean()
            print(f"{k:28s} mismatch_frac={diff:.5f}")
        else:
            d = np.abs(a.astype(np.float64) - b.astype(np.float64))
            scale = np.maximum(np.abs(a), 1e-9)
            print(
                f"{k:28s} max_abs={d.max():.3e} max_rel={(d / scale).max():.3e}"
                f" mean_abs={d.mean():.3e}"
            )


def main(out_path):
    import jax
    import jax.numpy as jnp

    from orb_line_slam_tpu.config import LineConfig, MapConfig, OrbConfig, SlamConfig
    from orb_line_slam_tpu.data.synthetic import SyntheticScene, loop_circuit_trajectory
    from orb_line_slam_tpu.geometry.camera import CameraIntrinsics
    from orb_line_slam_tpu.geometry.se3 import se3_apply
    from orb_line_slam_tpu.frontend.frame import build_stereo_frame

    print("platform:", jax.devices()[0].platform)
    rng = np.random.default_rng(11)
    out = {}

    # 1. se3_apply: K=3 einsum precision probe.
    R, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    R = R.astype(np.float32)
    t = rng.standard_normal(3).astype(np.float32)
    pts = rng.uniform(-30, 30, (4096, 3)).astype(np.float32)
    out["se3_apply"] = np.asarray(
        jax.jit(se3_apply)(jnp.asarray(R), jnp.asarray(t), jnp.asarray(pts))
    )

    # 2. Full stereo frame on a rendered scene: keypoints, depths, desc.
    vcam = CameraIntrinsics(fx=320.0, fy=320.0, cx=320.0, cy=160.0, bf=160.0,
                            width=640, height=320)
    cfg = SlamConfig(
        camera=vcam, orb=OrbConfig(n_features=1000, n_levels=4),
        lines=LineConfig(enabled=True, n_lines=64),
        map=MapConfig(max_keyframes=128, max_points=16384, max_lines=1024,
                      local_window=8, local_points=4096),
    )
    scene = SyntheticScene(vcam, n_points=1600, seed=5,
                           extent=((-24, 40), (-4, 4), (-32, 32)))
    poses = loop_circuit_trajectory(8, radius=8.0, laps=1.12)
    l0, r0 = scene.render_stereo(*poses[0])
    fr = build_stereo_frame(jnp.asarray(l0), jnp.asarray(r0), cfg)
    out["frame_xy"] = np.asarray(fr.xy)
    out["frame_depth"] = np.asarray(fr.depth)
    out["frame_desc"] = np.asarray(fr.desc)
    out["frame_response"] = np.asarray(fr.response)
    out["frame_valid"] = np.asarray(fr.valid)

    # 3. Pose optimize from rendered obs of frame 1 (exercise the full
    # motion-only solver on realistic data).
    from orb_line_slam_tpu.backend.pose_opt import pose_optimize

    R1, t1 = poses[1]
    N = 512
    w = rng.uniform(-10, 10, (N, 3)).astype(np.float32)
    w[:, 2] = np.abs(w[:, 2]) + 2.0
    pw = (w - t1[None, :]) @ R1  # world points in front of cam1
    xc = pw @ R1.T + t1
    obs = np.stack([
        vcam.fx * xc[:, 0] / xc[:, 2] + vcam.cx,
        vcam.fy * xc[:, 1] / xc[:, 2] + vcam.cy,
        vcam.fx * xc[:, 0] / xc[:, 2] + vcam.cx - vcam.bf / xc[:, 2],
    ], -1).astype(np.float32) + rng.normal(0, 0.3, (N, 3)).astype(np.float32)
    res = pose_optimize(
        jnp.asarray(R1.astype(np.float32)), jnp.asarray(t1.astype(np.float32)),
        jnp.asarray(pw.astype(np.float32)), jnp.asarray(obs),
        jnp.zeros(N, jnp.int32), jnp.ones(N, bool), vcam,
    )
    out["pose_R"] = np.asarray(res.R)
    out["pose_t"] = np.asarray(res.t)
    out["pose_inl"] = np.asarray(res.inliers)

    # 4. Triangulation between two rendered keyframe poses.
    from orb_line_slam_tpu.frontend.initializer import triangulate_two_view
    from orb_line_slam_tpu.geometry.se3 import se3_compose, se3_inverse

    R2, t2 = poses[4]
    pz = rng.uniform(-8, 8, (1024, 3)).astype(np.float32)
    pz[:, 2] = np.abs(pz[:, 2]) + 3.0
    c1 = pz @ R1.T + t1
    c2 = pz @ R2.T + t2

    def proj(xc):
        return np.stack([
            vcam.fx * xc[:, 0] / xc[:, 2] + vcam.cx,
            vcam.fy * xc[:, 1] / xc[:, 2] + vcam.cy,
        ], -1).astype(np.float32)

    Rrel, trel = se3_compose(
        jnp.asarray(R2.astype(np.float32)), jnp.asarray(t2.astype(np.float32)),
        *se3_inverse(jnp.asarray(R1.astype(np.float32)),
                     jnp.asarray(t1.astype(np.float32))),
    )
    tri = jax.jit(triangulate_two_view, static_argnames=())(
        Rrel, trel, jnp.asarray(vcam.K),
        jnp.asarray(proj(c1)), jnp.asarray(proj(c2)),
    )
    out["tri_pts"] = np.asarray(tri)

    # 5. Line front-end endpoints/descriptors on the rendered frame.
    from orb_line_slam_tpu.frontend.line_extractor import build_line_features

    lf = build_line_features(jnp.asarray(l0), jnp.asarray(r0), vcam, cfg.lines)
    out["line_p0"] = np.asarray(lf.p0)
    out["line_p1"] = np.asarray(lf.p1)
    out["line_valid"] = np.asarray(lf.valid)
    out["line_desc"] = np.asarray(lf.desc)
    out["line_depth0"] = np.asarray(lf.depth0)
    out["line_depth1"] = np.asarray(lf.depth1)

    np.savez(out_path, **out)
    print("wrote", out_path)


if __name__ == "__main__":
    if sys.argv[1] == "--compare":
        compare(sys.argv[2], sys.argv[3])
    else:
        main(sys.argv[1])
