"""Faults of a loop of frames: half of each frame's rows blanked, or one
pixel altered, where the port's ``render`` returns it."""

from __future__ import annotations

FAULTS = ("half_batch", "answer_altered")


def plant(cell, fault, patch):
    from gsconverter_tpu_torch.render import rasterizer

    orig = rasterizer.render

    def render(*a, **k):
        img = orig(*a, **k).clone()
        if fault == "half_batch":
            img[img.shape[0] // 2:] = 0.0
        else:
            img[3, 5, 1] += 0.01
        return img
    if fault not in FAULTS:
        raise KeyError(fault)
    patch(rasterizer, "render", render)
