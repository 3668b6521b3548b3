"""Filter engine — functions SplatCloud -> SplatCloud.

Replacement for the reference's mutating ``DataProcessor``
(processing/data_processor.py): every filter computes a keep-mask over the
cloud and compacts it.  Exact parameter semantics preserved.  bbox, alpha
and density run where the cloud's leaves live (host numpy for a cloud fresh
from a reader, tensors on their device for a device cloud), and so does SOR
on a device cloud; a host cloud's SOR runs on the ``device`` it is given.
A device cloud is compacted on its device (``compaction.compact``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..cloud import SplatCloud
from ..utils.log import debug_print, status_print
from . import density as density_ops
from . import sor as sor_ops


def _apply_mask(cloud: SplatCloud, mask, name: str) -> SplatCloud:
    n0 = cloud.n
    out = cloud.compact(mask)
    status_print(f"After {name}, retained {out.n} out of {n0} vertices.")
    return out


def crop_by_bbox(cloud: SplatCloud, bbox) -> SplatCloud:
    """Keep splats inside [min,max] box (reference data_processor.py:215-231)."""
    if cloud.is_host:
        lo = np.asarray(bbox[:3], np.float32)
        hi = np.asarray(bbox[3:], np.float32)
        mask = np.all((cloud.pos >= lo) & (cloud.pos <= hi), axis=1)
    else:
        lo = torch.tensor(bbox[:3], dtype=torch.float32, device=cloud.pos.device)
        hi = torch.tensor(bbox[3:], dtype=torch.float32, device=cloud.pos.device)
        mask = torch.all((cloud.pos >= lo) & (cloud.pos <= hi), dim=1)
    return _apply_mask(cloud, mask, "cropping")


def alpha_filter(cloud: SplatCloud, min_opacity_u8: int) -> SplatCloud:
    """Threshold in logit space (reference data_processor.py:184-213)."""
    limit = int(min_opacity_u8)
    if limit <= 0:
        return cloud
    if limit >= 255:
        status_print("Alpha Filter: min 255 removes all splats.")
        return cloud.compact(np.zeros(cloud.n, bool))
    t = np.clip(limit / 255.0, 1e-6, 1.0 - 1e-6)
    logit_thresh = float(np.log(t / (1.0 - t)))
    # numpy compare on host leaves, torch on tensor leaves
    mask = cloud.opacity >= logit_thresh
    return _apply_mask(cloud, mask, f"alpha filter (min {limit})")


def density_filter(
    cloud: SplatCloud,
    voxel_size: float = 1.0,
    threshold_percentage: float = 0.32,
    sensitivity: float | None = None,
    keep_multicluster: bool = False,
) -> SplatCloud:
    """Voxel density + largest-cluster filter (reference data_processor.py:11-117)."""
    if sensitivity is not None:
        voxel_size, threshold_percentage = density_ops.sensitivity_to_params(sensitivity)
    debug_print(
        f"Density Filter Params: Voxel={voxel_size:.4f}, "
        f"Thresh={threshold_percentage:.4f}%, MultiCluster={keep_multicluster}"
    )
    if cloud.n == 0:
        return cloud
    mask = density_ops.density_mask(
        cloud.pos, voxel_size, threshold_percentage, keep_multicluster=keep_multicluster
    )
    return _apply_mask(cloud, mask, "density filter")


def remove_flyers(
    cloud: SplatCloud,
    k: int = 25,
    threshold_factor: float = 10.5,
    intensity: float | None = None,
    device: str | torch.device = "cuda",
) -> SplatCloud:
    """SOR filter (reference data_processor.py:119-182; intended-mask semantics).

    ``sor_mask`` runs where a device cloud's positions live; a host cloud's
    positions go to ``device`` (kernel K1 on a CUDA device) and the keep-mask
    comes back as numpy for its compaction.  Under a mesh of more than one
    rank, and more splats than ranks, the mask comes from the halo-exchange
    ``parallel.distributed.sharded_sor_mask`` (each rank's kernel work on
    the mesh's device), which equals ``sor_mask``'s.
    """
    if intensity is not None:
        k, threshold_factor = sor_ops.intensity_to_params(intensity)
    debug_print(f"SOR Filter (Remove Flyers) Params: K={k}, Sigma={threshold_factor:.2f}")
    if cloud.n == 0:
        return cloud
    from ..parallel.mesh import multi_rank_mesh

    pos = cloud.pos
    if cloud.is_host:
        # writable contiguous f32 (leaves may be read-only views of the file)
        pos = torch.from_numpy(np.require(pos, np.float32, ["C", "W"])).to(device)
    mesh = multi_rank_mesh()
    if mesh is not None and cloud.n > mesh.size:
        from ..parallel.distributed import sharded_sor_mask

        debug_print(f"SOR: dispatching to {mesh.size}-rank mesh")
        mask = sharded_sor_mask(pos, mesh, k=int(k), sigma=float(threshold_factor))
    else:
        mask = sor_ops.sor_mask(pos, int(k), float(threshold_factor))
    if cloud.is_host:
        mask = mask.cpu().numpy()
    return _apply_mask(cloud, mask, "removing flyers")


def auto_bbox(cloud: SplatCloud) -> SplatCloud:
    """Report-only tight bbox (reference data_processor.py:335-354)."""
    if cloud.n == 0:
        status_print("Auto-BBox: No points remaining. Bounding box is undefined.")
        return cloud
    if cloud.is_host:
        mins, maxs = cloud.pos.min(axis=0), cloud.pos.max(axis=0)
    else:
        # reduced on the device; six floats come back
        mins, maxs = torch.aminmax(cloud.pos, dim=0)
        mins, maxs = mins.cpu().numpy(), maxs.cpu().numpy()
    status_print(
        f"Auto-BBox Applied: [{mins[0]:.4f}, {mins[1]:.4f}, {mins[2]:.4f}] "
        f"to [{maxs[0]:.4f}, {maxs[1]:.4f}, {maxs[2]:.4f}]"
    )
    return cloud
