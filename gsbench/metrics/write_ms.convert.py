"""Ms a conversion in the write stage."""

from gsbench.trace import stage_ms


def read(tr):
    return stage_ms(tr, ["write"])
