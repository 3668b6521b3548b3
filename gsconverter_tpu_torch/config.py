"""Global configuration for gsconverter_tpu_torch.

The reference keeps one module-level DEBUG flag and threads every other
option through ``Converter.run(**kwargs)``.  The same two module flags stay
for CLI parity, with a typed ``ConvertOptions`` dataclass as the single
source of truth for the pipeline configuration, and ``resolve_device`` as
the one place that turns a caller's ``device=`` into a torch device.
"""

from __future__ import annotations

import dataclasses

import torch

# Module-level flags, set by the CLI (parity with reference utils/config.py).
DEBUG: bool = False
TIMING: bool = False


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The device a conversion runs its device stages on.

    ``None`` means the card ("cuda").  A CUDA device on a machine without
    one raises: the pipeline never carries on quietly on the CPU; callers
    that want the CPU pass ``device="cpu"``.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "gsconverter_tpu_torch runs on a CUDA device by default, and "
            "torch.cuda.is_available() is False here; pass device='cpu' "
            "(CLI: --device cpu) to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


@dataclasses.dataclass
class ConvertOptions:
    """All pipeline options, mirroring the reference CLI flag surface."""

    # Filters
    bbox: tuple[float, float, float, float, float, float] | None = None
    auto_bbox: bool = False
    min_opacity: int | None = None
    # Density filter (explicit params or sensitivity slider)
    density_voxel_size: float | None = None
    density_threshold: float | None = None
    density_sensitivity: float | None = None
    keep_multicluster: bool = False
    # SOR filter (explicit params or intensity slider)
    sor_k: int | None = None
    sor_sigma: float | None = None
    sor_intensity: float | None = None
    # SH handling
    sh_level: int | None = None
    crop_sh: bool = False
    # RGB synthesis
    rgb: bool = False
    # Format-specific
    compression_level: int = 0
    bucket_size: int | None = None
    block_size: float | None = None
    # Extra PLY element policy
    maintain_extra_elements: bool = False
