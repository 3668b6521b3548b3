"""Faults of a loop of ``.sog`` conversions, in the port's SOG writer: half
of the splats left out, one position moved by two and a half u16 steps of
its axis, the palette fit stopped after one Lloyd step, or 1% of the
splats' palette labels moved to another entry of their chunk."""

from __future__ import annotations

import numpy as np
import torch

from gsbench.faults import in_writer

FAULTS = ("half_batch", "answer_altered", "fit_stalled", "labels_shifted")


def _moved(pos: np.ndarray) -> np.ndarray:
    """``pos`` with row 0's x moved by 2.5 steps of the u16 grid of the
    writer's log-space positions, inwards from a bound."""
    lp = np.sign(pos[:, 0].astype(np.float64)) * np.log1p(np.abs(pos[:, 0].astype(np.float64)))
    step = 2.5 * (lp.max() - lp.min()) / 65535.0
    v = lp[0] + (step if lp[0] + step < lp.max() else -step)
    out = pos.copy()
    out[0, 0] = np.float32(np.sign(v) * np.expm1(abs(v)))
    return out


def plant(cell, fault, patch):
    from gsconverter_tpu_torch.formats import get_handler, sog

    if fault == "half_batch":
        in_writer("sog", fault, patch)
    elif fault == "answer_altered":
        cls = type(get_handler("sog"))
        orig = cls.write

        def write(self, cloud, path, **kw):
            pos = cloud.pos if cloud.is_host else cloud.pos.cpu().numpy()
            moved = _moved(np.asarray(pos))
            return orig(self, cloud.replace(pos=moved if cloud.is_host else
                                            torch.from_numpy(moved).to(cloud.pos.device)),
                        path, **kw)
        patch(cls, "write", write)
    elif fault in ("fit_stalled", "labels_shifted"):
        orig = sog.kmeans_chunked

        def fit(data, num_chunks, k_per_chunk, *a, **kw):
            if fault == "fit_stalled":
                return orig(data, num_chunks, k_per_chunk, *a, **dict(kw, max_iter=1))
            c, labels = orig(data, num_chunks, k_per_chunk, *a, **kw)
            k = int(k_per_chunk)
            rows = torch.arange(0, labels.shape[0], 100, device=labels.device)
            base = labels[rows] // k * k
            labels = labels.clone()
            labels[rows] = (base + (labels[rows] - base + 1 + rows % (k - 1)) % k).to(labels.dtype)
            return c, labels
        patch(sog, "kmeans_chunked", fit)
    else:
        raise KeyError(fault)
