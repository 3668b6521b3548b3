"""% of the traced steps' wall with nothing running on the device."""

from gsbench.trace import idle_share


def read(tr):
    return idle_share(tr)
