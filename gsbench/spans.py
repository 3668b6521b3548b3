"""The port's own spans of a traced stretch, for the readers of the
``program_span`` and ``program_counter`` metrics.

The port keeps its closed spans in a buffer (``gsconverter_tpu_torch/
utils/log.py``: ``spans()``); a span records only while a profiler or its
``--timing`` is on, and a run sets neither outside the traced stretch, so
the spans recorded under the profiler are the stretch's.  A port without
that buffer gives None, and so does every reader.
"""

from __future__ import annotations


def traced() -> list | None:
    """The spans the port recorded under the profiler, or None where the
    port keeps none (or recorded none)."""
    try:
        from gsconverter_tpu_torch.utils import log
    except ImportError:
        return None
    read = getattr(log, "spans", None)
    if read is None:
        return None
    out = [s for s in read() if getattr(s, "profiled", False)]
    return out or None


def roots(spans: list, names) -> list:
    """The root spans named one of ``names`` (a step, frame, conversion or
    export each)."""
    return [s for s in spans if s.parent is None and s.name in names]


def ms_per_root(root_names, name: str) -> float | None:
    """Mean ms an iteration of the spans ``name`` under the roots
    ``root_names``; None where there is no such root or span."""
    spans = traced()
    if spans is None:
        return None
    tops = roots(spans, root_names)
    ids = {r.id for r in tops}
    hits = [s for s in spans if s.name == name and s.root in ids]
    if not tops or not hits:
        return None
    return sum((s.end_ns - s.start_ns) for s in hits) * 1e-6 / len(tops)


def count_per_root(root_names, counter: str, scale: float = 1.0) -> float | None:
    """Mean of the counter ``counter`` of the roots ``root_names`` (0 where
    a root counted none), times ``scale``; None where there is no root."""
    spans = traced()
    if spans is None:
        return None
    tops = roots(spans, root_names)
    if not tops:
        return None
    return sum(r.counts.get(counter, 0) for r in tops) * scale / len(tops)
