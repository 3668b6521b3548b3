"""Splat projection: 3D covariance from quat/scale, EWA perspective splatting.

Standard 3DGS math:
Sigma_3D = R S S^T R^T;  Sigma_2D = J W Sigma_3D W^T J^T + dilation*I with the
0.3-pixel low-pass dilation; conic = Sigma_2D^{-1}.
Plain torch ops on the splats' device, differentiated by autograd.
"""

from __future__ import annotations

import torch

DILATION = 0.3


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """[N,4] wxyz (need not be normalized) -> [N,3,3]."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp_min(1e-12)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
        ],
        dim=1,
    )


def _matmul_small(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched product of small matrices [..., i, k] @ [..., k, j] as
    elementwise ops: a batched GEMM of 3x3 blocks runs far below the card's
    memory rate (about 9 ms of a 1M-splat forward as bmm)."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def covariance_3d(log_scale: torch.Tensor, quat: torch.Tensor) -> torch.Tensor:
    """Sigma = R S S R^T, S = diag(exp(log_scale)) [N,3,3]."""
    R = quat_to_rotmat(quat)
    S = torch.exp(log_scale)  # [N,3]
    RS = R * S[:, None, :]
    return _matmul_small(RS, RS.transpose(1, 2))


def project_gaussians(pos, log_scale, quat, cam):
    """Project to screen space.

    Returns dict with means2d [N,2], conic [N,3] (a,b,c of inverse cov),
    depth [N], radius [N], in_front [N] bool, and the camera-frame dirs [N,3]
    for SH evaluation.
    """
    R, t = cam.R, cam.t
    p_cam = pos @ R.T + t[None, :]
    z = p_cam[:, 2]
    in_front = z > 0.01
    zc = z.clamp_min(0.01)

    mean_x = cam.fx * p_cam[:, 0] / zc + cam.cx
    mean_y = cam.fy * p_cam[:, 1] / zc + cam.cy
    means2d = torch.stack([mean_x, mean_y], dim=1)

    # Jacobian of perspective projection (EWA), with 3DGS frustum clamping.
    lim_x = 1.3 * cam.cx / cam.fx
    lim_y = 1.3 * cam.cy / cam.fy
    tx = torch.clamp(p_cam[:, 0] / zc, -lim_x, lim_x) * zc
    ty = torch.clamp(p_cam[:, 1] / zc, -lim_y, lim_y) * zc
    zero = torch.zeros_like(zc)
    J = torch.stack([
        torch.stack([cam.fx / zc, zero, -cam.fx * tx / (zc * zc)], -1),
        torch.stack([zero, cam.fy / zc, -cam.fy * ty / (zc * zc)], -1),
    ], dim=1)  # [N,2,3]

    W = R[None, :, :]  # world->cam rotation
    cov3d = covariance_3d(log_scale, quat)
    T = _matmul_small(_matmul_small(J, _matmul_small(_matmul_small(W, cov3d),
                                                     W.transpose(1, 2))), J.transpose(1, 2))
    cov2d = T + DILATION * torch.eye(2, dtype=T.dtype, device=T.device)[None, :, :]

    det = cov2d[:, 0, 0] * cov2d[:, 1, 1] - cov2d[:, 0, 1] ** 2
    det = det.clamp_min(1e-12)
    conic = torch.stack(
        [cov2d[:, 1, 1] / det, -cov2d[:, 0, 1] / det, cov2d[:, 0, 0] / det], dim=1
    )

    mid = 0.5 * (cov2d[:, 0, 0] + cov2d[:, 1, 1])
    lam1 = mid + torch.sqrt((mid * mid - det).clamp_min(0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lam1))

    view_dir = pos - cam.position[None, :]
    view_dir = view_dir / torch.linalg.norm(view_dir, dim=1, keepdim=True).clamp_min(1e-12)

    return dict(
        means2d=means2d, conic=conic, depth=z, radius=radius,
        in_front=in_front, view_dir=view_dir,
    )
