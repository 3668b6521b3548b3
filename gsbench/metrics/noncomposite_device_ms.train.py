"""Device ms a step of every kernel, copy and fill but K5 and K6."""

from gsbench.trace import device_ms_besides


def read(tr):
    return device_ms_besides(tr, {"composite_fwd_kernel": "composite_fwd", "composite_bwd_kernel": "composite_bwd"})
