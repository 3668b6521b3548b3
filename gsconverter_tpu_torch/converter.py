"""Converter — the detect -> read -> cap-SH -> filter -> rgb -> write pipeline.

Behavior parity with the reference orchestrator and with gsconverter_tpu:
format detection by extension + PLY-header sniffing, SH capping policy
final = min(source_active, requested, format limit), filter ordering
bbox -> alpha -> density -> SOR -> auto-bbox, auto-RGB for {cc, splat,
ksplat, sog}, extras preserve/strip policy, and the progress milestones
(5/25/30/40).

``device`` (default: the card, "cuda") is where a host cloud's device
stages run: SOR and the SOG writer's palette fit; the cloud itself stays
host-resident from read to write.  A cloud of tensors (``SplatCloud.device``)
runs every stage where its tensors live, through ``write_processed`` or the
filters.  Without a GPU, pass ``device="cpu"``: the default never falls back
to the CPU on its own.

``run(checkpoint_dir=...)`` snapshots the cloud after each filter stage
(``utils/checkpoint.py``) and resumes a rerun after the last complete one;
with ``config.DEBUG`` set, each stage's output is validated
(``utils/validate.py``).

Under a mesh of more than one rank (``parallel.mesh``: one process per
device), every rank runs the same conversion on the whole cloud; the
device stages run on the mesh's device, SOR and the K-Means behind SOG
take their sharded paths (each rank's share of the kernel work), and rank
0 alone writes the output while the others wait at a barrier.

Tracing (``utils/log.py``): ``run`` is the span ``convert`` and
``write_processed`` the span ``export``, each the root of its stages
(``StageTimer``'s) and of the writer's spans.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from . import config as config_mod
from .cloud import SplatCloud
from .config import ConvertOptions, resolve_device
from .formats import get_handler
from .formats.base import BaseFormat
from .ops import filters, sh
from .parallel.mesh import multi_rank_mesh
from .utils import checkpoint
from .utils import ply as ply_io
from .utils.log import StageTimer, debug_print, progress, span, status_print
from .utils.validate import validate_cloud

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
        """Full pipeline; ``checkpoint_dir=`` snapshots each filter stage and
        resumes after the last complete snapshot."""
        # timing is module state (utils/log reads it at call time); scope it
        # to this conversion so library callers don't inherit it.
        prev_timing = config_mod.TIMING
        if kwargs.get("timing"):
            config_mod.TIMING = True
        try:
            with span("convert"):
                return self._run_inner(**kwargs)
        finally:
            config_mod.TIMING = prev_timing

    def _run_inner(self, **kwargs: Any) -> SplatCloud:
        opts = _opts_from_kwargs(kwargs)
        ckpt_dir = kwargs.get("checkpoint_dir")
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

            # multi-device: every rank holds the whole cloud; SOR and the
            # SOG palette dispatch to the sharded paths
            mesh, device = self._mesh_and_device()
            if mesh is not None:
                status_print(f"Sharding {cloud.n} splats over {mesh.size} devices.")

            # resumable stages: restart after the last complete snapshot
            stage_order = ["sh_cap", "bbox", "alpha", "density", "sor"]
            resume_idx = -1
            if ckpt_dir:
                done = checkpoint.latest_stage(ckpt_dir, stage_order)
                if done is not None:
                    resume_idx = stage_order.index(done)
                    status_print(f"Resuming from checkpointed stage '{done}'.")
                    with self.timer.stage("checkpoint_load"):
                        cloud = checkpoint.load(ckpt_dir, done)

            def run_stage(name, fn, cloud):
                if stage_order.index(name) <= resume_idx:
                    return cloud  # already restored from the snapshot
                with self.timer.stage(name, cloud.n):
                    cloud = fn(cloud)
                if config_mod.DEBUG:
                    validate_cloud(cloud, where=name)
                if ckpt_dir:
                    with self.timer.stage(f"checkpoint_save.{name}", cloud.n):
                        checkpoint.save(cloud, ckpt_dir, name)
                return cloud

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
            # gather the real cloud ONCE after the chain.  Snapshots need
            # every leaf after each stage, so checkpointing compacts per
            # stage, and so does a mesh, as in the JAX package.
            defer_compact = ckpt_dir is None and cloud.is_host and mesh is None
            full_cloud = None
            if defer_compact and any_filter:
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
                        device=device,
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
                        kwargs: dict, pbar=None) -> SplatCloud:
        """RGB policy + extras policy + target write (run() steps 5-6)."""
        if (self.target_format in FORMATS_NEEDING_RGB and not cloud.has_rgb) or opts.rgb:
            if not cloud.has_rgb:
                status_print(
                    f"Target format '{self.target_format}' requires RGB. "
                    "Auto-calculating from SH..."
                )
                cloud = sh.add_rgb(cloud)
        if pbar:
            pbar.update(5)
        self.cloud = cloud

        if pbar:
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
        mesh, device = self._mesh_and_device()
        write_kwargs["device"] = device  # codecs without device stages ignore it
        with self.timer.stage("write", cloud.n):
            # under a mesh rank 0 writes; the other ranks join a writer's
            # collectives only (the SOG palette fit), then wait for rank 0
            if mesh is None or mesh.rank == 0 or target_handler.collective_write:
                target_handler.write(cloud, self.output_path, **write_kwargs)
            if mesh is not None:
                mesh.barrier()
        if pbar:
            pbar.update(40)
            pbar.refresh()
            pbar.set_description("Completed")
        return cloud

    def _mesh_and_device(self):
        """(the multi-rank mesh or None, the device of the device stages):
        the mesh's device under a mesh, whose kind must be the one asked for."""
        mesh = multi_rank_mesh()
        if mesh is None:
            return None, self.device
        if mesh.device.type != self.device.type:
            raise ValueError(f"the active mesh runs on {mesh.device}, and this "
                             f"conversion was asked for {self.device}")
        return mesh, mesh.device

    def write_processed(self, cloud: SplatCloud, source_handler=None,
                        **kwargs: Any) -> SplatCloud:
        """Write an already filtered cloud (``processed_cloud`` of another
        converter's ``run``) to this converter's target — the batch fast
        path: one read and filter chain per scene, N format writes.

        Applies this format's own SH cap (min(content, requested, format
        limit)) and its RGB and extras policies, so the output is identical
        to a full ``run()`` on the same source.  As ``run()`` does, a cloud
        whose metadata degree lies above its content (one fresh from a
        reader) takes the content's degree; the JAX package's
        ``write_processed`` keeps the metadata and writes its zero bands.
        """
        with span("export"):
            opts = _opts_from_kwargs(kwargs)
            if source_handler is not None:
                self.source_handler = source_handler
            source_deg = sh.detect_active_degree(cloud)
            final_deg = min(
                source_deg,
                FORMAT_MAX_SH.get(self.target_format, 3),
                3 if opts.sh_level is None else int(opts.sh_level),
            )
            if final_deg < source_deg:
                cloud = sh.cap_degree(cloud, final_deg)
            else:
                cloud = cloud.replace(active_sh_degree=min(cloud.active_sh_degree, final_deg))
            out = self._finalize_write(cloud, opts, kwargs)
        status_print(f"Conversion completed: Saved to {self.output_path}")
        return out


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
