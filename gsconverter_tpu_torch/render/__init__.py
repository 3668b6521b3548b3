from .camera import Camera
from .project import project_gaussians, covariance_3d, quat_to_rotmat
from .rasterizer import render, render_reference, psnr

__all__ = [
    "Camera",
    "project_gaussians",
    "covariance_3d",
    "quat_to_rotmat",
    "render",
    "render_reference",
    "psnr",
]
