"""Trajectory writers (TUM + KITTI formats) and ATE/RPE evaluation.

Rebuilds System::SaveTrajectoryTUM / SaveTrajectoryKITTI (src/System.cc,
SURVEY.md §3.5) and the external evaluation step the reference family
relies on (TUM evaluate_ate.py / evo, SURVEY.md §4): Umeyama alignment
+ RMSE of aligned translation errors.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..geometry.host import nquat_from_rotmat, nse3_inverse


def save_trajectory_kitti(path, trajectory):
    """trajectory: iterable of (frame_id, timestamp, R_cw, t_cw, lost).
    Writes camera-to-world 3x4 rows (KITTI convention).
    Host numpy throughout: a per-pose eager device op would cost a
    device round-trip per trajectory row."""
    lines = []
    for _, _, R_cw, t_cw, _ in trajectory:
        Rwc, twc = nse3_inverse(np.asarray(R_cw, np.float32), np.asarray(t_cw, np.float32))
        T = np.hstack([Rwc, twc[:, None]])
        lines.append(" ".join(f"{v:.9e}" for v in T.reshape(-1)))
    Path(path).write_text("\n".join(lines) + "\n")


def save_trajectory_tum(path, trajectory):
    """TUM format: timestamp tx ty tz qx qy qz qw (camera-to-world)."""
    lines = []
    for _, ts, R_cw, t_cw, _ in trajectory:
        Rwc, twc = nse3_inverse(np.asarray(R_cw, np.float32), np.asarray(t_cw, np.float32))
        q = nquat_from_rotmat(Rwc)
        lines.append(
            f"{ts:.6f} {twc[0]:.7f} {twc[1]:.7f} {twc[2]:.7f} "
            f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}"
        )
    Path(path).write_text("\n".join(lines) + "\n")


def umeyama_alignment(src: np.ndarray, dst: np.ndarray, with_scale: bool = False):
    """Least-squares similarity/rigid alignment src->dst ([N,3] each).
    Returns (s, R, t) with dst ~ s*R@src + t."""
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs**2).sum() / len(src)
        s = np.trace(np.diag(D) @ S) / var_s
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(est_positions: np.ndarray, gt_positions: np.ndarray,
             align: bool = True, with_scale: bool = False) -> float:
    """Absolute trajectory error RMSE after (optional) alignment."""
    est = np.asarray(est_positions, np.float64)
    gt = np.asarray(gt_positions, np.float64)
    assert est.shape == gt.shape
    if align:
        s, R, t = umeyama_alignment(est, gt, with_scale)
        est = (s * (R @ est.T)).T + t
    err = np.linalg.norm(est - gt, axis=-1)
    return float(np.sqrt((err**2).mean()))


def rpe_rmse(est_poses, gt_poses, delta: int = 1):
    """Relative pose error (translation RMSE) over frame gaps of `delta`.
    Poses are lists of (R_cw, t_cw)."""
    errs = []
    for i in range(len(est_poses) - delta):
        def rel(poses):
            R1, t1 = poses[i]
            R2, t2 = poses[i + delta]
            # T2 * T1^-1 in world->cam convention: motion between frames
            R = R2 @ R1.T
            t = t2 - R @ t1
            return R, t

        Re, te = rel(est_poses)
        Rg, tg = rel(gt_poses)
        dt = te - (Re @ Rg.T) @ tg
        errs.append(np.linalg.norm(te - tg))
    return float(np.sqrt(np.mean(np.square(errs))))
