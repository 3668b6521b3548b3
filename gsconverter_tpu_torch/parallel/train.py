"""The sharded training step: image row bands over the mesh, gradients
all-reduced, the same Adam step on every rank.

The counterpart of the JAX package's ``dryrun_multichip`` step, where GSPMD
splits one jitted render and its gradient over the devices.  Here every rank
holds the whole (replicated) cloud and parameters, renders only its row
band of the image (``render(rows=)``: the whole image's projection and
binning, compositing of the band's tiles alone, K5 forward and K6 backward
on the card), and the ranks sum their gradients by one all-reduce of a
flat buffer, so that every rank takes the same optimizer step.

``python -m gsconverter_tpu_torch.parallel.train [--device cpu]`` runs
``dryrun_multichip`` on the default group (start it under ``torchrun``) or,
without one, on one device.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..cloud import SplatCloud
from ..render import rasterizer as rz
from ..render.camera import Camera
from ..render.train import cloud_with, make_train_step
from .distributed import _all_reduce
from .mesh import Mesh, init_multihost, make_mesh


def make_sharded_train_step(cloud: SplatCloud, cam: Camera, opt: torch.optim.Optimizer,
                            params: dict[str, torch.Tensor], mesh: Mesh, **render_kw):
    """Returns ``step(target) -> loss``: ``render/train.py::make_train_step``
    over the mesh.  Rank r renders image rows [r * H / size, (r + 1) * H /
    size) of ``cloud_with(cloud, params)`` (``render(rows=)``: each tile
    gets the candidates it gets in the whole image, so the gradients differ
    from one device's only in their summation order); its loss share is
    the band's squared error over H * W * 3, so the shares add up to the
    mean.  Every
    parameter's gradient (the ranks' sum, by one all-reduce of a flat
    buffer) is left in its ``.grad``; the loss is all-reduced too.  Every
    rank then takes the same ``opt`` step and renormalizes ``quat``.  H
    must split into whole 16-row tiles a rank."""
    h, w = cam.height, cam.width
    if h % (rz.TILE * mesh.size):
        raise ValueError(f"make_sharded_train_step: {h} image rows do not split into "
                         f"whole {rz.TILE}-row tiles over {mesh.size} ranks")
    rows_per = h // mesh.size
    lo = mesh.rank * rows_per
    names = list(params)
    numel = float(h * w * 3)

    def step(target: torch.Tensor) -> torch.Tensor:
        opt.zero_grad(set_to_none=True)
        band = rz.render(cloud_with(cloud, params), cam, rows=(lo, lo + rows_per),
                         **render_kw)
        loss = torch.sum((band - target[lo:lo + rows_per]) ** 2) / numel
        loss.backward()
        # a parameter outside the graph (e.g. sh_rest at SH degree 0) is
        # outside it on every rank: it keeps no gradient, as in
        # make_train_step, and takes no room in the buffer
        live = [params[k] for k in names if params[k].grad is not None]
        flat = _all_reduce(torch.cat([p.grad.reshape(-1) for p in live]), mesh)
        off = 0
        for p in live:
            p.grad = flat[off:off + p.numel()].view_as(p)
            off += p.numel()
        loss = _all_reduce(loss.detach().reshape(1), mesh)[0]
        opt.step()
        with torch.no_grad():
            q = params["quat"]
            q.div_(torch.linalg.norm(q, dim=-1, keepdim=True).clamp_min(1e-8))
        return loss

    return step


def tiny_scene(n: int = 256, width: int = 32, height: int = 32):
    """``__graft_entry__.py::_tiny_scene``'s cloud (numpy, seed 0) and its
    camera, here ``width`` x ``height``: (host cloud, camera)."""
    r = np.random.default_rng(0)
    quat = r.normal(0, 1, (n, 4)).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    cloud = SplatCloud(
        pos=r.normal(0, 1.0, (n, 3)).astype(np.float32),
        sh_dc=r.normal(0, 0.5, (n, 3)).astype(np.float32),
        sh_rest=r.normal(0, 0.05, (n, 3, 15)).astype(np.float32),
        opacity=r.normal(0, 1.0, (n,)).astype(np.float32),
        log_scale=np.clip(r.normal(-3.5, 0.3, (n, 3)), -5, -2).astype(np.float32),
        quat=quat,
        normal=np.zeros((n, 3), np.float32),
        active_sh_degree=3,
    )
    cam = Camera.look_at(eye=(0, 0, -6), target=(0, 0, 0), width=width, height=height)
    return cloud, cam


def dryrun_multichip(mesh: Mesh | None = None) -> dict:
    """One sharded training step of the tiny scene (16 splats a rank, 32
    wide, 32 rows or 16 a rank: whole tiles a band), Adam at lr 1e-3
    towards a black image, then the same step on one device from the same
    parameters.  Raises unless the losses and the updated positions agree
    within 1e-5 (``__graft_entry__.py``'s bars).  Returns the losses and
    both differences."""
    mesh = make_mesh() if mesh is None else mesh
    cloud, cam = tiny_scene(n=16 * mesh.size, width=32, height=max(32, 16 * mesh.size))
    base = rz._leaves_on(cloud, mesh.device)
    target = torch.zeros(cam.height, cam.width, 3, device=mesh.device)
    kw = dict(max_per_tile=64, tile_chunk=2)

    def one_step(make):
        params = {k: getattr(base, k).detach().clone().requires_grad_(True)
                  for k in ("pos", "sh_dc", "sh_rest", "opacity", "log_scale", "quat")}
        opt = torch.optim.Adam(list(params.values()), lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
        return float(make(opt, params)(target)), params

    loss, params = one_step(lambda opt, p: make_sharded_train_step(base, cam, opt, p, mesh,
                                                                   **kw))
    loss1, params1 = one_step(lambda opt, p: make_train_step(base, cam, opt, p, **kw))
    d_loss = abs(loss - loss1)
    d_pos = float((params["pos"] - params1["pos"]).detach().abs().max())
    if not d_loss < 1e-5:
        raise RuntimeError(f"sharded/single loss mismatch: {d_loss}")
    if not d_pos < 1e-5:
        raise RuntimeError(f"sharded/single param mismatch: {d_pos}")
    if mesh.rank == 0:
        print(f"dryrun_multichip({mesh.size}): one sharded train step OK, loss={loss:.6f} "
              f"(single-device loss={loss1:.6f}, |dloss|={d_loss:.2e}, "
              f"|dparam|={d_pos:.2e})")
    return dict(world=mesh.size, loss=loss, single_loss=loss1, d_loss=d_loss, d_pos=d_pos)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=dryrun_multichip.__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cpu for gloo ranks on the CPU; default: the card (NCCL)")
    args = ap.parse_args()
    backend = "gloo" if args.device == "cpu" else "nccl"
    started = init_multihost(backend=backend)
    try:
        dryrun_multichip(make_mesh(device=args.device))
    finally:
        if started:
            torch.distributed.destroy_process_group()
