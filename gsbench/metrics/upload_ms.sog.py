"""Ms a conversion in the SOG writer's stage sog.upload (a host cloud's fields copied to the card)."""

from gsbench.spans import ms_per_root


def read(tr):
    return ms_per_root(("convert",), "sog.upload")
