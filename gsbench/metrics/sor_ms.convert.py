"""Ms a conversion in the SOR stage."""

from gsbench.trace import stage_ms


def read(tr):
    return stage_ms(tr, ["sor"])
