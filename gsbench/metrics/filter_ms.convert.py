"""Ms a conversion in the bbox, alpha and density stages."""

from gsbench.trace import stage_ms


def read(tr):
    return stage_ms(tr, ["bbox", "alpha", "density"])
