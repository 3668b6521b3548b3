"""Numeric sanity guards.

Under ``--debug`` the converter validates the canonical cloud after each
stage: non-finite values, quaternions off unit norm, extreme log-scales.
A tensor cloud is reduced on its device; only the counts and the largest
|log-scale| come back.  The
quaternion and log-scale checks skip a leaf with no columns: the converter's
deferred-compaction proxy carries only positions and opacities through the
filters (the JAX package's check raises on that proxy's empty log-scale).
"""

from __future__ import annotations

import numpy as np
import torch

from ..cloud import SplatCloud
from .log import status_print


def _problems_host(checks: dict, quat, log_scale, n: int) -> list[str]:
    problems = []
    for name, a in checks.items():
        bad = int(np.sum(~np.isfinite(a)))
        if bad:
            problems.append(f"{name}: {bad} non-finite values")
    if n and quat.shape[-1]:
        qn = np.linalg.norm(quat, axis=-1)
        off = int(np.sum(np.abs(qn - 1.0) > 0.01))
        if off:
            problems.append(f"quat: {off} not unit-norm (|q| off by >1%)")
    if n and log_scale.shape[-1]:
        ls = float(np.max(np.abs(log_scale)))
        if ls > 30:
            problems.append(f"log_scale: extreme magnitude {ls:.1f}")
    return problems


def _problems_torch(checks: dict, quat, log_scale, n: int) -> list[str]:
    names = list(checks)
    vals = [(~torch.isfinite(a)).sum().to(torch.float64) for a in checks.values()]
    check_quat = bool(n and quat.shape[-1])
    check_scale = bool(n and log_scale.shape[-1])
    if check_quat:
        qn = torch.linalg.vector_norm(quat, dim=-1)
        vals.append(((qn - 1.0).abs() > 0.01).sum().to(torch.float64))
    if check_scale:
        vals.append(log_scale.abs().amax().to(torch.float64))
    got = torch.stack(vals).cpu().tolist()  # the one read back
    problems = [f"{name}: {int(bad)} non-finite values"
                for name, bad in zip(names, got) if bad]
    if check_quat and got[len(names)]:
        problems.append(f"quat: {int(got[len(names)])} not unit-norm (|q| off by >1%)")
    if check_scale and got[-1] > 30:
        problems.append(f"log_scale: extreme magnitude {got[-1]:.1f}")
    return problems


def validate_cloud(cloud: SplatCloud, where: str = "") -> list[str]:
    """Returns a list of problems found (empty = healthy)."""
    checks = dict(
        pos=cloud.pos, sh_dc=cloud.sh_dc, sh_rest=cloud.sh_rest,
        opacity=cloud.opacity, log_scale=cloud.log_scale, quat=cloud.quat,
    )
    find = _problems_host if cloud.is_host else _problems_torch
    problems = find(checks, cloud.quat, cloud.log_scale, cloud.n)
    for p in problems:
        status_print(f"[validate{':' + where if where else ''}] {p}")
    return problems
