"""Pinhole camera model for the differentiable rasterizer.

Conventions follow standard 3DGS: world-to-camera extrinsics, +z forward,
pixel coords with origin at the top-left.  The matrices live as float32
torch tensors on one device; ``Camera.to`` moves them (the renderer moves a
camera to its cloud's device; each copy to or from a card is a counted
wait of ``utils/transfer.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.transfer import upload


@dataclasses.dataclass
class Camera:
    world_to_cam: torch.Tensor  # [4,4] f32
    fx: torch.Tensor  # 0-d f32
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    width: int = 256
    height: int = 256

    @classmethod
    def from_numpy(cls, world_to_cam, fx, fy, cx, cy, width: int, height: int,
                   device: str | torch.device = "cpu") -> "Camera":
        """A camera from host arrays (e.g. the JAX package's ``Camera``
        fields through ``np.asarray``), as float32 tensors on ``device``."""

        def f32(a):
            return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)

        return cls(world_to_cam=f32(world_to_cam), fx=f32(fx), fy=f32(fy),
                   cx=f32(cx), cy=f32(cy), width=int(width), height=int(height))

    @classmethod
    def look_at(
        cls,
        eye,
        target,
        up=(0.0, 1.0, 0.0),
        fov_deg: float = 60.0,
        width: int = 256,
        height: int = 256,
        device: str | torch.device = "cpu",
    ) -> "Camera":
        # computed in numpy f32, step for step as the JAX package does, so
        # the two packages' matrices agree bit for bit
        eye = np.asarray(eye, np.float32)
        target = np.asarray(target, np.float32)
        up = np.asarray(up, np.float32)
        fwd = target - eye
        fwd = fwd / np.linalg.norm(fwd)
        right = np.cross(fwd, up)
        right = right / np.linalg.norm(right)
        down = np.cross(fwd, right)
        R = np.stack([right, down, fwd], axis=0)  # world->cam rows
        t = -R @ eye
        w2c = np.eye(4, dtype=np.float32)
        w2c[:3, :3] = R
        w2c[:3, 3] = t
        f = 0.5 * width / np.tan(np.radians(fov_deg) / 2)
        return cls.from_numpy(w2c, f, f, width / 2, height / 2, width, height,
                              device=device)

    @property
    def device(self) -> torch.device:
        return self.world_to_cam.device

    def to(self, device: str | torch.device) -> "Camera":
        """The same camera with its tensors on ``device``."""
        dev = torch.device(device)
        if self.world_to_cam.device == dev:
            return self
        return dataclasses.replace(
            self, world_to_cam=upload(self.world_to_cam, dev), fx=upload(self.fx, dev),
            fy=upload(self.fy, dev), cx=upload(self.cx, dev), cy=upload(self.cy, dev))

    @property
    def R(self) -> torch.Tensor:
        return self.world_to_cam[:3, :3]

    @property
    def t(self) -> torch.Tensor:
        return self.world_to_cam[:3, 3]

    @property
    def position(self) -> torch.Tensor:
        return -self.R.T @ self.t
