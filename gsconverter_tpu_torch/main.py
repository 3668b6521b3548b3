"""CLI — the flag surface of ``gsconverter_tpu``'s CLI, plus ``--device``.

Entry point: ``python -m gsconverter_tpu_torch``.  Supports --info
inspection with glob, auto-output path and extension derivation with
collision suffixes, the no-op conversion guard, overwrite confirmation
unless --force, and before/after file info reports.  ``--device`` (default
``cuda``) is where the device stages (SOR, the SOG palette fit) run; without a GPU, pass
``--device cpu``.

Under ``torchrun --nproc_per_node N -m gsconverter_tpu_torch ...`` the N
processes form a process group (NCCL on ``--device cuda``, gloo on
``--device cpu``) and the conversion takes the multi-device paths; rank 0
writes the output.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

import torch

from . import __version__, config
from .converter import EXT_MAP, VALID_FORMATS, Converter
from .parallel.mesh import init_multihost, multi_rank_mesh
from .utils import ply as ply_io


class AboutAction(argparse.Action):
    def __call__(self, parser, namespace, values, option_string=None):
        print(f"3D Gaussian Splatting Converter (PyTorch/CUDA) v{__version__}")
        print("PyTorch/CUDA port of gsconverter_tpu with 3dgsconverter capabilities")
        parser.exit()


def check_source_extras(path: str) -> bool:
    """Header-only scan for non-vertex/face PLY elements (reference main.py:26-54)."""
    try:
        if path.lower().endswith(".ply"):
            for name in ply_io.header_elements(path):
                if name not in ("vertex", "face"):
                    return True
    except (OSError, ValueError, KeyError):
        pass
    return False


def report_info(input_path: str) -> None:
    """File inspection report (reference main.py:56-254).  Reads only, so it
    runs on the host whatever ``--device`` says."""
    import numpy as np

    abs_path = os.path.abspath(input_path)
    print(f"\n{'-' * 60}")
    print(f"File: {abs_path}")
    try:
        size_mb = os.path.getsize(abs_path) / (1024 * 1024)
        print(f"Size: {size_mb:.2f} MB")

        conv = Converter(abs_path, "dummy_out.ply", "3dgs", device="cpu")
        cloud = conv.load_source_only()

        extras = [el.name for el in getattr(conv.source_handler, "extra_elements", ())]
        if extras:
            print(f"Extra Elements: {', '.join(extras)}")

        if conv.source_format == "ksplat":
            meta = conv.source_handler.metadata
            if meta:
                print(f"KSplat Version: {meta.get('v_major')}.{meta.get('v_minor')}")
                print(f"Compression Level: {meta.get('compression_level')}")
                if meta.get("compression_level", 0) >= 1 and meta.get("sections"):
                    s0 = meta["sections"][0]
                    print(f"Bucket Size: {s0.get('bucketSize')}")
                    print(f"Block Size: {s0.get('bucketBlockSize')}")
                if "min_sh" in meta:
                    print(f"SH Range: [{meta['min_sh']:.2f}, {meta['max_sh']:.2f}]")
        if conv.source_format == "compressed_ply":
            meta = conv.source_handler.metadata
            print("Quantization: Chunk-based (256 splats/chunk)")
            print(f"Chunks: {meta.get('chunks', 0):,}")
            print("Position/Scale Packing: 11-10-11 bit")
            print("Rotation Packing: 2-10-10-10 bit")
            print("Color Packing: 8-8-8-8 bit")
            if meta.get("sh_degree", 0) > 0:
                print("SH Quantization: 8-bit ([-4, 4] range)")

        print(f"Format Detected: {conv.source_format.upper()}")
        n = cloud.n
        print(f"Points: {n:,}")
        if n:
            pos = np.asarray(cloud.pos)
            mins, maxs = pos.min(axis=0), pos.max(axis=0)
            print(f"Bounds Min: [{mins[0]:.4f}, {mins[1]:.4f}, {mins[2]:.4f}]")
            print(f"Bounds Max: [{maxs[0]:.4f}, {maxs[1]:.4f}, {maxs[2]:.4f}]")

        attrs = []
        if cloud.has_rgb:
            attrs.append("RGB")
        attrs += ["Opacity", "Scale", "Rotation"]
        print(f"Attributes: {', '.join(attrs)}")

        # SH analysis: header degree (schema width) vs active degree (content)
        from .ops.sh import detect_active_degree

        header_deg = cloud.active_sh_degree
        n_coeffs = {0: 0, 1: 9, 2: 24, 3: 45}[header_deg]
        active_deg = detect_active_degree(cloud, max_degree=header_deg)
        header_msg = f"Degree {header_deg} ({n_coeffs} coeffs)" if n_coeffs else "Degree 0 (DC)"
        active_msg = f"Degree {active_deg}"
        if active_deg < header_deg:
            active_msg += " (Cropped/Zeroed)"
        print(f"SH Headers: {header_msg}")
        print(f"SH Content: {active_msg}")
    except Exception as e:
        print(f"Error reading info for {input_path}: {e}")
    print(f"3D Gaussian Splatting Converter (PyTorch/CUDA): {__version__}")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description=(
            "Universal 3D Gaussian Splatting Converter (PyTorch/CUDA). Supports: "
            "3DGS (.ply), CloudCompare (.ply), KSplat (.ksplat), Splat (.splat), "
            "SPZ (.spz), SOG (.sog), Parquet (.parquet), Compressed PLY (.ply)."
        )
    )
    parser.add_argument("--input", "-i", required=True, help="Path to the source point cloud file.")
    parser.add_argument("--output", "-o", help="Path to save the converted point cloud file.")
    parser.add_argument("--target_format", "-f",
                        help="Target format (3dgs, cc, ksplat, splat, spz, sog, parquet, compressed_ply).")
    parser.add_argument("--info", "-I", action="store_true",
                        help="Print file metadata and statistics without converting")
    parser.add_argument("--debug", "-d", action="store_true", help="Enable debug prints.")
    parser.add_argument("--timing", action="store_true", help="Print per-stage timing/throughput.")
    parser.add_argument("--about", action=AboutAction, nargs=0, help="Show version info")
    parser.add_argument("--force", action="store_true", help="Force overwrite of existing output file.")
    parser.add_argument("--rgb", action="store_true", help="Add RGB values based on f_dc values.")
    parser.add_argument("--bbox", nargs=6, type=float,
                        metavar=("minX", "minY", "minZ", "maxX", "maxY", "maxZ"),
                        help="3D bounding box to crop the point cloud.")
    parser.add_argument("--auto_bbox", action="store_true",
                        help="Calculate and report a tight bounding box after filtering.")
    parser.add_argument("--extra_elements", action="store_true",
                        help="Preserve extra PLY elements when converting between 3DGS/CC formats.")
    # Hidden expert flags (reference main.py:276-287)
    parser.add_argument("--density_voxel_size", type=float, help=argparse.SUPPRESS)
    parser.add_argument("--density_threshold", type=float, help=argparse.SUPPRESS)
    parser.add_argument("--sor_k", type=float, help=argparse.SUPPRESS)
    parser.add_argument("--sor_sigma", type=float, help=argparse.SUPPRESS)
    parser.add_argument("--bucket_size", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--block_size", type=float, help=argparse.SUPPRESS)
    parser.add_argument("--crop_sh", action="store_true",
                        help="Crop SH coefficients to those present in the source (no 45-coeff padding).")
    parser.add_argument("--sh_level", type=int,
                        help="Target SH degree (0-3), capped by source data and format limits.")
    parser.add_argument("--density_sensitivity", type=float,
                        help="Density filter sensitivity (0.0-1.0).")
    parser.add_argument("--sor_intensity", type=float,
                        help="SOR filter intensity (1.0-10.0).")
    parser.add_argument("--min_opacity", type=int,
                        help="Minimum opacity threshold (0-255) to keep a splat.")
    parser.add_argument("--keep_multicluster", action="store_true",
                        help="Density filter keeps all clusters >= 5%% of the largest.")
    parser.add_argument("--compression_level", type=int, default=0,
                        help="Compression level (0-9); format specific (KSplat/SPZ/SOG).")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="Device of the device stages (SOR, the SOG palette "
                             "fit). Default: cuda; without a GPU pass --device cpu.")
    return parser


def main(argv: list[str] | None = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    started = init_multihost(backend="nccl" if args.device == "cuda" else "gloo")
    try:
        return _main(parser, args)
    finally:
        if started:
            torch.distributed.destroy_process_group()


def _main(parser: argparse.ArgumentParser, args: argparse.Namespace) -> int:
    config.DEBUG = args.debug
    config.TIMING = args.timing

    # --- validation (reference main.py:304-322) ---
    if args.density_sensitivity is not None and not (0.0 <= args.density_sensitivity <= 1.0):
        print(f"Error: --density_sensitivity must be between 0.0 and 1.0. Got {args.density_sensitivity}.")
        return 1
    if args.sor_intensity is not None and not (1.0 <= args.sor_intensity <= 10.0):
        print(f"Error: --sor_intensity must be between 1.0 and 10.0. Got {args.sor_intensity}.")
        return 1
    if args.min_opacity is not None and not (0 <= args.min_opacity <= 255):
        print(f"Error: --min_opacity must be between 0 and 255. Got {args.min_opacity}.")
        return 1
    if not (0 <= args.compression_level <= 9):
        print(f"Error: --compression_level must be between 0 and 9. Got {args.compression_level}.")
        return 1

    # --- info mode ---
    if args.info:
        files = glob.glob(args.input)
        if not files:
            print(f"Error: No input files found matching '{args.input}'")
            return 1
        for p in files:
            report_info(p)
        return 0

    # --- conversion mode ---
    if not args.target_format:
        parser.error("--target_format is required for conversion mode.")
    if args.target_format.lower() not in VALID_FORMATS:
        print(f"Error: Unknown target format '{args.target_format}'. "
              f"Supported: {', '.join(VALID_FORMATS)}")
        return 1

    # auto-output with collision suffix (reference main.py:349-371)
    if not args.output:
        base, in_ext = os.path.splitext(args.input)
        target_ext = EXT_MAP.get(args.target_format, "." + args.target_format)
        suffix = ""
        if in_ext.lower() == target_ext.lower():
            suffix = {"cc": "_cc", "compressed_ply": "_compressed",
                      "3dgs": "_3dgs"}.get(args.target_format, "_processed")
        args.output = f"{base}{suffix}{target_ext}"
        print(f"Auto-Output: Destination set to {args.output}")

    # no-op guard (reference main.py:373-442)
    in_ext = os.path.splitext(args.input)[1].lower()
    has_source_extras = check_source_extras(args.input)
    is_stripping = has_source_extras and not args.extra_elements
    filters_active = any([
        args.density_voxel_size, args.density_threshold,
        args.sor_k, args.sor_sigma, args.crop_sh,
        args.sh_level is not None, args.min_opacity,
        args.keep_multicluster, args.density_sensitivity is not None,
        args.sor_intensity is not None, args.bbox is not None,
        is_stripping,
    ])
    same_ext = in_ext == os.path.splitext(args.output)[1].lower()
    if (same_ext and args.target_format == "3dgs" and not filters_active
            and args.compression_level == 0 and not args.force):
        print("\n[INFO] Target is generic 3DGS PLY (same as input extension) and no filters are active.")
        if args.extra_elements and has_source_extras:
            print("       (You are maintaining extra elements, so the output would be identical to input).")
        print("       Refer to --help to apply filters or remove --extra_elements to strip data.")
        print("       Operation aborted to prevent redundant processing.")
        return 0

    # auto-extension (reference main.py:444-453)
    if not os.path.splitext(args.output)[1]:
        args.output += EXT_MAP.get(args.target_format, "." + args.target_format)
        print(f"Auto-Extension: Appended extension, new output: {args.output}")

    out_dir = os.path.dirname(args.output)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)

    # overwrite prompt (reference main.py:460-466); under a mesh rank 0
    # alone asks, and every rank takes its answer
    mesh = multi_rank_mesh()
    lead = mesh is None or mesh.rank == 0
    proceed = True
    if lead and os.path.exists(args.output) and not args.force:
        print(f"Warning: Output file '{args.output}' already exists.")
        try:
            confirm = input("Overwrite? [y/N]: ").strip().lower()
        except EOFError:
            if mesh is None:
                raise
            confirm = ""  # no answer: the other ranks must still hear one
        proceed = confirm == "y"
        if not proceed:
            print("Operation cancelled.")
    if mesh is not None:
        box = [proceed]
        torch.distributed.broadcast_object_list(
            box, group=mesh.group, group_src=0,
            device=mesh.device if mesh.backend == "nccl" else None)
        proceed = box[0]
    if not proceed:
        return 0

    try:
        if lead:
            print("\n>>> SOURCE FILE INFO")
            report_info(args.input)

        converter = Converter(args.input, args.output, args.target_format,
                              device=args.device)
        converter.run(
            density_voxel_size=args.density_voxel_size,
            density_threshold=args.density_threshold,
            density_sensitivity=args.density_sensitivity,
            keep_multicluster=args.keep_multicluster,
            sor_k=args.sor_k,
            sor_sigma=args.sor_sigma,
            sor_intensity=args.sor_intensity,
            min_opacity=args.min_opacity,
            bbox=tuple(args.bbox) if args.bbox else None,
            rgb=args.rgb,
            sh_level=args.sh_level,
            bucket_size=args.bucket_size,
            block_size=args.block_size,
            crop_sh=args.crop_sh,
            auto_bbox=args.auto_bbox,
            compression_level=args.compression_level,
            maintain_extra_elements=args.extra_elements,
        )

        if lead:
            print("\n>>> TARGET FILE INFO")
            report_info(args.output)
    except Exception as e:
        print(f"Error: {e}")
        if config.DEBUG:
            raise
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
