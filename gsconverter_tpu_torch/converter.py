"""Converter — the detect -> read -> cap-SH -> filter -> rgb -> write pipeline.

Behavior parity with the reference orchestrator and with gsconverter_tpu:
format detection by extension + PLY-header sniffing, SH capping policy
final = min(source_active, requested, format limit), filter ordering
bbox -> alpha -> density -> SOR -> auto-bbox, auto-RGB for {cc, splat,
ksplat, sog}, extras preserve/strip policy, and the progress milestones
(5/25/30/40).

``device`` (default: the card, "cuda") is where SOR runs; the cloud itself
stays host-resident from read to write.  Without a GPU, pass
``device="cpu"``: the default never falls back to the CPU on its own.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from . import config as config_mod
from .cloud import SplatCloud
from .config import ConvertOptions, resolve_device
from .formats import NOT_PORTED, get_handler
from .formats.base import BaseFormat
from .ops import filters, sh
from .utils import ply as ply_io
from .utils.log import StageTimer, debug_print, progress, status_print

VALID_FORMATS = ["3dgs", "cc", "parquet", "splat", "ksplat", "spz", "sog", "compressed_ply"]

# Per-format SH caps (reference converter.py:154-163).
FORMAT_MAX_SH = {
    "3dgs": 3, "cc": 3, "parquet": 3, "ksplat": 2,
    "splat": 0, "spz": 3, "sog": 3, "compressed_ply": 3,
}
FORMATS_NEEDING_RGB = ("cc", "splat", "ksplat", "sogs", "sog")

EXT_MAP = {
    "3dgs": ".ply", "cc": ".ply", "compressed_ply": ".ply",
    "sog": ".sog", "splat": ".splat", "ksplat": ".ksplat",
    "spz": ".spz", "parquet": ".parquet",
}


def detect_format(path: str) -> str | None:
    """Extension + content detection (reference converter.py:27-61)."""
    p = path.lower()
    for ext, fmt in ((".parquet", "parquet"), (".splat", "splat"),
                     (".ksplat", "ksplat"), (".spz", "spz"), (".sog", "sog")):
        if p.endswith(ext):
            return fmt
    # PLY flavor sniffing
    try:
        header = ply_io.sniff_header_text(path)
    except OSError as e:
        debug_print(f"[DEBUG] Error identifying PLY flavor: {e}")
        return None
    if "element chunk" in header:
        return "compressed_ply"
    if "property float f_dc_0" in header:
        return "3dgs"
    if ("property float scal_f_dc_0" in header
            or "property float scalar_scal_f_dc_0" in header
            or "property float scalar_f_dc_0" in header):
        return "cc"
    return None


class Converter:
    """Public API entry (reference converter.py:12-25)."""

    def __init__(self, input_path: str, output_path: str, target_format: str,
                 device: str | torch.device | None = None):
        self.input_path = input_path
        self.output_path = output_path
        self.target_format = target_format.lower()
        if self.target_format not in VALID_FORMATS:
            raise ValueError(
                f"Unknown target format '{self.target_format}'. "
                f"Supported: {', '.join(VALID_FORMATS)}"
            )
        if self.target_format in NOT_PORTED:
            get_handler(self.target_format)  # raises NotImplementedError
        self.device = resolve_device(device)
        self.cloud: SplatCloud | None = None
        self.processed_cloud: SplatCloud | None = None  # pre-RGB, post-filter
        self.source_format: str | None = None
        self.source_handler: BaseFormat | None = None
        self.timer = StageTimer()

    # ------------------------------------------------------------------ load
    def load_source_only(self) -> SplatCloud:
        self.source_format = detect_format(self.input_path)
        if not self.source_format:
            raise ValueError("Could not detect source format")
        debug_print(f"[DEBUG] Detected source format: {self.source_format}")
        self.source_handler = get_handler(self.source_format)
        self.cloud = self.source_handler.read(self.input_path)
        return self.cloud

    # ------------------------------------------------------------------- run
    def run(self, **kwargs: Any) -> SplatCloud:
        """Full pipeline.  ``checkpoint_dir=`` is not supported yet."""
        if kwargs.get("checkpoint_dir"):
            raise NotImplementedError(
                "checkpoint_dir= is not ported to gsconverter_tpu_torch yet "
                "(ROADMAP queue 1, checkpoint / resume / validate / transfer)"
            )
        # timing is module state (utils/log reads it at call time); scope it
        # to this conversion so library callers don't inherit it.
        prev_timing = config_mod.TIMING
        if kwargs.get("timing"):
            config_mod.TIMING = True
        try:
            return self._run_inner(**kwargs)
        finally:
            config_mod.TIMING = prev_timing

    def _run_inner(self, **kwargs: Any) -> SplatCloud:
        opts = _opts_from_kwargs(kwargs)
        with progress(100, "Converting",
                      "{desc}: {percentage:3.0f}% |{bar}| {n_fmt}/{total_fmt}") as pbar:
            # 1. detect
            self.source_format = detect_format(self.input_path)
            if not self.source_format:
                raise ValueError("Could not detect source format")
            debug_print(f"[DEBUG] Detected source format: {self.source_format}")
            pbar.update(5)

            # 2. read
            pbar.set_description("Reading Source")
            self.source_handler = get_handler(self.source_format)
            with self.timer.stage("read"):
                cloud = self.source_handler.read(self.input_path)
            pbar.update(25)

            def run_stage(name, fn, cloud):
                with self.timer.stage(name, cloud.n):
                    return fn(cloud)

            # 3. SH capping: min(source_active, requested, format limit)
            pbar.set_description("Processing")
            with self.timer.stage("sh_cap_detect", cloud.n):
                # structural upper bound: the reader sets active_sh_degree
                # from the source's column count, so higher bands are zero
                # by construction and the content scan skips them
                source_deg = sh.detect_active_degree(
                    cloud, max_degree=cloud.active_sh_degree
                )
                target_limit = FORMAT_MAX_SH.get(self.target_format, 3)
                final_deg = source_deg
                if opts.sh_level is not None:
                    if opts.sh_level > target_limit:
                        status_print(
                            f"Warning: Requested SH degree {opts.sh_level} exceeds limit "
                            f"for '{self.target_format}' ({target_limit}). Capping to {target_limit}."
                        )
                    if opts.sh_level > source_deg:
                        status_print(
                            f"Warning: Requested SH degree {opts.sh_level} exceeds source "
                            f"data degree ({source_deg}). Capping to {source_deg}."
                        )
                    final_deg = min(final_deg, opts.sh_level)
                final_deg = min(final_deg, target_limit)
                if final_deg < source_deg:
                    status_print(f"SH Reduction: Source degree {source_deg} -> Target degree {final_deg}")
            if final_deg < source_deg:
                cloud = run_stage("sh_cap", lambda c: sh.cap_degree(c, final_deg), cloud)
            else:
                # content already within the target degree; just sync metadata
                cloud = cloud.replace(
                    active_sh_degree=min(cloud.active_sh_degree, final_deg)
                )
            pbar.update(5)

            # 4. filters (order: bbox -> alpha -> density -> SOR -> auto-bbox)
            pbar.set_description("Filtering")
            run_density = (
                (opts.density_voxel_size is not None and opts.density_threshold is not None)
                or opts.density_sensitivity is not None
            )
            run_sor = (
                (opts.sor_k is not None and opts.sor_sigma is not None)
                or opts.sor_intensity is not None
            )
            run_bbox = bool(opts.bbox)
            run_alpha = opts.min_opacity is not None and opts.min_opacity > 0
            any_filter = run_bbox or run_alpha or run_density or run_sor

            # Deferred compaction: the geometric filters only read
            # pos/opacity, but a per-stage compaction gathers EVERY leaf.
            # The chain runs on a proxy cloud whose only full-size leaves
            # are pos/opacity plus a row-index extra; the surviving indices
            # gather the real cloud ONCE after the chain.
            full_cloud = None
            if cloud.is_host and any_filter:
                full_cloud = cloud
                n0 = cloud.n
                empty = np.zeros((n0, 0), np.float32)
                cloud = SplatCloud(
                    pos=cloud.pos, opacity=cloud.opacity,
                    sh_dc=empty, sh_rest=np.zeros((n0, 0, 0), np.float32),
                    log_scale=empty, quat=empty, normal=empty,
                    extras={"__orig_idx__": np.arange(n0, dtype=np.int64)},
                    active_sh_degree=full_cloud.active_sh_degree,
                )

            if run_bbox:
                cloud = run_stage("bbox", lambda c: filters.crop_by_bbox(c, opts.bbox), cloud)
            if run_alpha:
                cloud = run_stage("alpha", lambda c: filters.alpha_filter(c, opts.min_opacity), cloud)
            if run_density:
                cloud = run_stage(
                    "density",
                    lambda c: filters.density_filter(
                        c,
                        voxel_size=(1.0 if opts.density_voxel_size is None
                                    else float(opts.density_voxel_size)),
                        threshold_percentage=(0.32 if opts.density_threshold is None
                                              else float(opts.density_threshold)),
                        sensitivity=opts.density_sensitivity,
                        keep_multicluster=opts.keep_multicluster,
                    ),
                    cloud,
                )
            pbar.update(10)
            if run_sor:
                pbar.set_description("Filtering (SOR)")
                cloud = run_stage(
                    "sor",
                    lambda c: filters.remove_flyers(
                        c,
                        k=25 if opts.sor_k is None else int(opts.sor_k),
                        threshold_factor=(10.5 if opts.sor_sigma is None
                                          else float(opts.sor_sigma)),
                        intensity=opts.sor_intensity,
                        device=self.device,
                    ),
                    cloud,
                )
            pbar.update(10)
            if opts.auto_bbox:
                cloud = filters.auto_bbox(cloud)

            if full_cloud is not None:
                # one gather applies the whole surviving-row composition
                idx = cloud.extras["__orig_idx__"]
                with self.timer.stage("compact", full_cloud.n):
                    if len(idx) == full_cloud.n:
                        cloud = full_cloud
                    else:
                        cloud = full_cloud.select(idx)

            self.processed_cloud = cloud

            # 5 + 6. RGB synthesis + write (with extras policy)
            cloud = self._finalize_write(cloud, opts, kwargs, pbar)

        status_print(f"Conversion completed: Saved to {self.output_path}")
        return cloud

    def _finalize_write(self, cloud: SplatCloud, opts: ConvertOptions,
                        kwargs: dict, pbar) -> SplatCloud:
        """RGB policy + extras policy + target write (run() steps 5-6)."""
        if (self.target_format in FORMATS_NEEDING_RGB and not cloud.has_rgb) or opts.rgb:
            if not cloud.has_rgb:
                status_print(
                    f"Target format '{self.target_format}' requires RGB. "
                    "Auto-calculating from SH..."
                )
                cloud = sh.add_rgb(cloud)
        pbar.update(5)
        self.cloud = cloud

        pbar.set_description(f"Writing {self.target_format.upper()}")
        write_kwargs = dict(kwargs)
        extras = getattr(self.source_handler, "extra_elements", ()) if self.source_handler else ()
        if opts.maintain_extra_elements:
            if extras:
                write_kwargs["extra_elements"] = extras
                handler_cls = get_handler(self.target_format)
                if not handler_cls.supports_extra_elements:
                    status_print(
                        f"Warning: Target format '{self.target_format}' does not support "
                        "preserving extra elements. These will be ignored."
                    )
            else:
                status_print("Warning: --extra_elements passed but no extra elements found in source.")
        elif extras:
            status_print(
                f"Stripping {len(extras)} extra PLY elements "
                "(use --extra_elements to preserve)."
            )

        target_handler = get_handler(self.target_format)
        # the pipeline already scanned content for the SH degree and synced
        # the metadata; the hint lets codecs skip their own full re-scan
        write_kwargs.setdefault("sh_content_degree", cloud.active_sh_degree)
        with self.timer.stage("write", cloud.n):
            target_handler.write(cloud, self.output_path, **write_kwargs)
        pbar.update(40)
        pbar.refresh()
        pbar.set_description("Completed")
        return cloud


def _opts_from_kwargs(kwargs: dict) -> ConvertOptions:
    fields = {f.name for f in dataclasses.fields(ConvertOptions)}
    known = {k: v for k, v in kwargs.items() if k in fields and v is not None}
    opts = ConvertOptions(**known)
    if "keep_multicluster" not in known:
        opts.keep_multicluster = bool(kwargs.get("keep_multicluster", False))
    return opts


def convert(input_path: str, output_path: str, target_format: str,
            device: str | torch.device | None = None, **kwargs: Any) -> SplatCloud:
    """One-shot functional API; ``device`` defaults to the card ("cuda")."""
    return Converter(input_path, output_path, target_format, device=device).run(**kwargs)
