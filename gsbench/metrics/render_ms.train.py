"""Ms a step in the port's `render` span (project, SH color, binning, the bands)."""

from gsbench.spans import ms_per_root


def read(tr):
    return ms_per_root(("train_step",), "render")
