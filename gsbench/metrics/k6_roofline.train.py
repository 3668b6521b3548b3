"""K6's share of its roofline over the traced steps: the backward compositing the inputs need over K6's device time."""

from gsbench.trace import roofline_share


def read(tr):
    return roofline_share(tr, "composite_bwd_kernel", "composite_bwd", "k6")
