"""Multi-scene batch conversion: every input to every target format.

One read and filter chain per scene, then one write per format: the format
with the loosest SH cap runs the full pipeline, and the others write its
processed cloud through ``Converter.write_processed``, each applying its own
cap, which commutes with the filters (they read only positions and
opacities).  Every output is byte-identical to a standalone conversion.
Scenes are shared round-robin between processes.
"""

from __future__ import annotations

import glob as globlib
import os

import torch

from .converter import EXT_MAP, FORMAT_MAX_SH, VALID_FORMATS, Converter
from .parallel.mesh import multi_rank_mesh
from .utils.log import status_print


def convert_batch(
    inputs: list[str] | str,
    out_dir: str,
    target_formats: list[str] | str,
    process_index: int = 0,
    process_count: int = 1,
    device: str | torch.device | None = None,
    **kwargs,
) -> list[tuple[str, str, str]]:
    """Convert every input to every target format (the N-to-N matrix).

    ``inputs`` may be a glob pattern; ``device`` (default: the card) goes to
    every ``Converter``.  Returns (input, format, output) for the
    conversions this process performed.  Under a multi-rank mesh every rank
    takes every scene (its conversions run over the mesh, rank 0 writing),
    so ``process_count`` must be 1.
    """
    if process_count > 1 and multi_rank_mesh() is not None:
        raise ValueError("convert_batch: under a multi-rank mesh every rank converts "
                         "every scene; process_count must be 1")
    if isinstance(inputs, str):
        inputs = sorted(globlib.glob(inputs))
    if isinstance(target_formats, str):
        target_formats = [target_formats]
    for fmt in target_formats:
        if fmt not in VALID_FORMATS:
            raise ValueError(f"Unknown target format '{fmt}'")
    os.makedirs(out_dir, exist_ok=True)

    # the loosest SH cap first: its processed cloud carries the most SH
    fmts = sorted(target_formats, key=lambda f: -FORMAT_MAX_SH.get(f, 3))
    n_jobs = len(inputs) * len(fmts)
    done = []
    # the unit of work is a whole scene when there are at least as many
    # scenes as processes; otherwise each (scene, format) job, so that every
    # process stays busy (each process then runs the full pipeline for its
    # first format of a scene; the subset keeps the loosest cap first)
    scene_rr = len(inputs) >= process_count
    for si, src in enumerate(inputs):
        if scene_rr and si % process_count != process_index:
            continue
        base = os.path.splitext(os.path.basename(src))[0]
        shared_cloud = None
        shared_handler = None
        for fi, fmt in enumerate(fmts):
            if not scene_rr and (si * len(fmts) + fi) % process_count != process_index:
                continue
            out = os.path.join(out_dir, f"{base}_{fmt}{EXT_MAP[fmt]}")
            status_print(f"[batch {si * len(fmts) + fi + 1}/{n_jobs}] {src} -> {out}")
            conv = Converter(src, out, fmt, device=device)
            if shared_cloud is None:
                conv.run(**kwargs)
                shared_cloud = conv.processed_cloud
                shared_handler = conv.source_handler
            else:
                conv.write_processed(shared_cloud, source_handler=shared_handler, **kwargs)
            done.append((src, fmt, out))
    return done
