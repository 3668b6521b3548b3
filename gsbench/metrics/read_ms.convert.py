"""Ms a conversion in the read stage (the Converter's StageTimer)."""

from gsbench.trace import stage_ms


def read(tr):
    return stage_ms(tr, ["read"])
