"""Device ms a frame of every kernel, copy and fill but K5."""

from gsbench.trace import device_ms_besides


def read(tr):
    return device_ms_besides(tr, {"composite_fwd_kernel": "composite_fwd"})
