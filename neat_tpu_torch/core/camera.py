"""Camera and ray math (port of neat_tpu/core/camera.py).

``uv`` is (x, y) pixel coordinates; ``pose`` is camera-to-world, a 4x4
matrix or a 7-vector [quat(wxyz), translation]; ``intrinsics`` is a 3x3 (or
4x4, top-left used) pinhole K with optional skew K[0,1].
"""

from __future__ import annotations

from typing import Tuple

import torch


def lift(x, y, z, intrinsics):
    """Unproject pixel coords at depth ``z`` to homogeneous camera coords.
    x, y, z: (..., N); intrinsics: (..., 3+, 3+). Returns (..., N, 4)."""
    fx = intrinsics[..., 0, 0][..., None]
    fy = intrinsics[..., 1, 1][..., None]
    cx = intrinsics[..., 0, 2][..., None]
    cy = intrinsics[..., 1, 2][..., None]
    sk = intrinsics[..., 0, 1][..., None]
    x_lift = (x - cx + cy * sk / fy - sk * y / fy) / fx * z
    y_lift = (y - cy) / fy * z
    return torch.stack([x_lift, y_lift, z, torch.ones_like(z)], dim=-1)


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Unit-normalized quaternion (w, i, j, k) -> rotation (..., 3, 3)."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    qr, qi, qj, qk = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r = torch.stack(
        [
            1 - 2 * (qj**2 + qk**2),
            2 * (qj * qi - qk * qr),
            2 * (qi * qk + qr * qj),
            2 * (qj * qi + qk * qr),
            1 - 2 * (qi**2 + qk**2),
            2 * (qj * qk - qi * qr),
            2 * (qk * qi - qj * qr),
            2 * (qj * qk + qi * qr),
            1 - 2 * (qi**2 + qj**2),
        ],
        dim=-1,
    )
    return r.reshape(*q.shape[:-1], 3, 3)


def pose_to_matrix(pose: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., 4, 4) or (..., 7) pose -> (cam2world 4x4, cam_loc)."""
    if pose.shape[-1] == 7:
        cam_loc = pose[..., 4:]
        p = torch.zeros((*pose.shape[:-1], 4, 4), dtype=pose.dtype, device=pose.device)
        p[..., :3, :3] = quat_to_rot(pose[..., :4])
        p[..., :3, 3] = cam_loc
        p[..., 3, 3] = 1.0
        return p, cam_loc
    return pose, pose[..., :3, 3]


def get_camera_params(uv, pose, intrinsics, normalize: bool = True):
    """Pixel coords -> (ray_dirs (..., N, 3), cam_loc (..., 3))."""
    p, cam_loc = pose_to_matrix(pose)
    x_cam = uv[..., 0]
    y_cam = uv[..., 1]
    pix_cam = lift(x_cam, y_cam, torch.ones_like(x_cam), intrinsics)
    world = torch.einsum("...ij,...nj->...ni", p, pix_cam)[..., :3]
    ray_dirs = world - cam_loc[..., None, :]
    if normalize:
        ray_dirs = ray_dirs / torch.linalg.norm(ray_dirs, dim=-1, keepdim=True)
    return ray_dirs, cam_loc


def project2d(k, r, t, points3d):
    """Project world points to 2D with the sign-safe perspective division
    (near-zero depths nudged by +/-1e-8). points3d: (..., 3) -> (..., 2)."""
    pts = points3d.reshape(-1, 3)
    t = t.reshape(3)
    x = (k @ (r @ pts.T + t[:, None])).T
    denom = x[:, -1:]
    sign = torch.where(denom >= 0, 1.0, -1.0).to(x.dtype)
    eps = torch.where(torch.abs(denom) < 1e-8, 1e-8, 0.0).to(x.dtype)
    x = x / (denom + eps * sign)
    return x[:, :2].reshape(*points3d.shape[:-1], 2)


def get_sphere_intersections(cam_loc, ray_dirs, radius: float = 1.0):
    """Near/far intersections (N, 2) with the bounding sphere, clamped >= 0.
    A miss clamps the discriminant to 0 (the reference hard-exits)."""
    ray_cam_dot = torch.sum(ray_dirs * cam_loc, dim=-1, keepdim=True)
    under_sqrt = ray_cam_dot**2 - (
        torch.sum(cam_loc**2, dim=-1, keepdim=True) - radius**2
    )
    root = torch.sqrt(torch.clamp(under_sqrt, min=0.0))
    sgn = torch.tensor([-1.0, 1.0], dtype=ray_dirs.dtype, device=ray_dirs.device)
    return torch.clamp(root * sgn - ray_cam_dot, min=0.0)


def psnr(img1, img2, normalize_rgb: bool = False):
    """Peak signal-to-noise ratio."""
    if normalize_rgb:
        img1 = (img1 + 1.0) / 2.0
        img2 = (img2 + 1.0) / 2.0
    mse = torch.mean((img1 - img2) ** 2)
    return -10.0 * torch.log(mse) / torch.log(torch.tensor(10.0, dtype=mse.dtype))


def load_k_rt_from_p(p):
    """Decompose a 3x4 projection matrix P = K [R | t] -> (intrinsics 4x4,
    cam2world 4x4), both float32 (numpy; the DTU loader's cameras). An RQ
    decomposition with a positive diagonal of K; the camera centre comes
    from P itself, -M^-1 p4, which no sign choice changes."""
    import numpy as np

    p = np.asarray(p, dtype=np.float64)[:3, :4]
    k, r = _rq3(p[:, :3])
    sgn = np.diag(np.sign(np.diag(k)))
    k = k @ sgn
    r = sgn @ r
    if np.linalg.det(r) < 0:
        r = -r
    c = -np.linalg.solve(p[:, :3], p[:, 3])
    k = k / k[2, 2]

    intrinsics = np.eye(4)
    intrinsics[:3, :3] = k
    pose = np.eye(4)
    pose[:3, :3] = r.T
    pose[:3, 3] = c
    return intrinsics.astype(np.float32), pose.astype(np.float32)


def _rq3(a):
    """RQ decomposition of a 3x3 matrix through a QR of its flipped
    transpose."""
    import numpy as np

    q, r = np.linalg.qr(np.flipud(a).T)
    r = np.flipud(r.T)[:, ::-1]
    q = np.flipud(q.T)
    return r, q
