"""Splat optimization: fit a SplatCloud to a target image.

The training-step counterpart of the differentiable rasterizer: Adam on
every splat parameter through ``render``'s analytic compositing backward
(K6 on the card), quaternions renormalized after each step.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..cloud import SplatCloud
from .camera import Camera
from .rasterizer import _leaves_on, _render_device, render

TRAINABLE = ("pos", "sh_dc", "sh_rest", "opacity", "log_scale", "quat")


def params_of(cloud: SplatCloud) -> dict[str, torch.Tensor]:
    return {k: getattr(cloud, k) for k in TRAINABLE}


def cloud_with(cloud: SplatCloud, params: dict[str, torch.Tensor]) -> SplatCloud:
    return cloud.replace(**params)


def make_train_step(cloud: SplatCloud, cam: Camera, opt: torch.optim.Optimizer,
                    params: dict[str, torch.Tensor], **render_kw):
    """Returns ``step(target) -> loss``: one update of ``params`` (the
    leaf tensors ``opt`` optimizes) on the mean squared pixel error.  After
    a step each parameter's ``.grad`` holds that step's gradient."""

    def step(target: torch.Tensor) -> torch.Tensor:
        opt.zero_grad(set_to_none=True)
        img = render(cloud_with(cloud, params), cam, **render_kw)
        loss = torch.mean((img - target) ** 2)
        loss.backward()
        opt.step()
        with torch.no_grad():
            # keep quaternions normalized after the update
            q = params["quat"]
            q.div_(torch.linalg.norm(q, dim=-1, keepdim=True).clamp_min(1e-8))
        return loss.detach()

    return step


def fit(
    cloud: SplatCloud,
    cam: Camera,
    target,
    steps: int = 100,
    lr: float = 1e-2,
    device=None,
    **render_kw: Any,
) -> tuple[SplatCloud, list[float]]:
    """Optimize all splat parameters against one target image with Adam
    (optax's ``adam`` update: betas 0.9 / 0.999, eps 1e-8 outside the
    root).  Runs where ``render`` would; returns the fitted cloud (tensor
    leaves on that device) and the loss of every step."""
    dev = _render_device(cloud, device)
    base = _leaves_on(cloud, dev)
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in params_of(base).items()}
    opt = torch.optim.Adam(list(params.values()), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    if not isinstance(target, torch.Tensor):
        target = torch.from_numpy(np.array(target, dtype=np.float32))  # a copy: writable
    target = target.to(device=dev, dtype=torch.float32)
    step = make_train_step(base, cam, opt, params, **render_kw)
    losses = [float(step(target)) for _ in range(steps)]
    return cloud_with(base, {k: v.detach() for k, v in params.items()}), losses
