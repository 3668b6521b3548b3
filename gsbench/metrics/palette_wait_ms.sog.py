"""Ms a conversion in the SOG writer's stage sog.shN_fit+centroids_pull (waiting for the palette fit)."""

from gsbench.spans import ms_per_root


def read(tr):
    return ms_per_root(("convert",), "sog.shN_fit+centroids_pull")
