"""Ms a frame in the port's `render` span."""

from gsbench.spans import ms_per_root


def read(tr):
    return ms_per_root(("render",), "render")
