"""Ms a conversion in the compaction of the kept rows."""

from gsbench.trace import stage_ms


def read(tr):
    return stage_ms(tr, ["compact"])
