"""Ms a conversion in the SOG writer's stage sog.webp_flush (waiting for the WebP encodes, then the zip)."""

from gsbench.spans import ms_per_root


def read(tr):
    return ms_per_root(("convert",), "sog.webp_flush")
