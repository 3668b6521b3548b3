"""Logging, progress and tracing utilities.

Reproduces the user-facing reporting contract of the reference: a gated
``debug_print`` and an always-on, tqdm-safe ``status_print``.  tqdm is
optional: without it, progress is a no-op object and messages go to
``print``.

Tracing.  ``span(name, **counts)`` marks a piece of work where it happens
(a training step, a render's band, a writer's gzip).  It is on while a
``torch.profiler`` records or ``config.TIMING`` is set, and off otherwise,
where it costs one flag check and returns a shared no-op context.  An open
span is a ``gsconverter/<name>`` range in the profiler's trace; a closed
one is kept in a bounded buffer, which ``spans()`` returns as
``SpanRecord``s, with its start and end on the Unix clock: the clock of a
Chrome trace's ``ts`` plus its ``baseTimeNanoseconds``, so a span and its
range in an exported trace agree to the clock reads around the range.  The
range is the profiler's function-scope one (a ``cpu_op`` event, opened in
C++ in about 2 us) rather than ``record_function``'s user-scope annotation:
with the CUDA activity on, the profiler tags every CUDA call made inside an
open user-scope range for the device trace, about 1 us more a kernel
launch.  The buffer holds bytes, which Python's collector does not count:
kept objects it counted would set off a collection inside a traced stretch
(one pass over every young object of the process, tens of milliseconds).

Spans nest: each has a parent and the id of its root (a step, frame,
conversion or export).  A span opened on a thread with no open span of its
own (autograd's device thread in a backward, a writer's pool) takes as its
parent the innermost open span of the thread that opened a span last.
``count(**counts)`` adds to the counters of the open span and of each span
it lies in.  ``StageTimer`` (a conversion's stages, the SOG writer's
``sog.<tag>`` stages, and their ``--timing`` lines) is built on ``span``.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import struct
import threading
import time

import torch
from torch.autograd import profiler as _profiler

from .. import config


def debug_print(msg: str) -> None:
    """Print only when debug mode is on (mirrors reference debug_print)."""
    if config.DEBUG:
        _safe_write(msg)


def status_print(msg: str) -> None:
    """Always print, routed through tqdm.write when tqdm is installed."""
    _safe_write(msg)


def _safe_write(msg: str) -> None:
    try:
        from tqdm import tqdm
    except ImportError:
        print(msg)
        return
    tqdm.write(str(msg))


class _NoProgress:
    """Stand-in for a tqdm bar where tqdm is not installed."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def update(self, n: int = 1) -> None:
        pass

    def set_description(self, desc: str) -> None:
        pass

    def refresh(self) -> None:
        pass


def progress(total: int, desc: str, bar_format: str):
    """A tqdm progress bar, or a no-op one where tqdm is not installed."""
    try:
        from tqdm import tqdm
    except ImportError:
        return _NoProgress()
    return tqdm(total=total, desc=desc, bar_format=bar_format)


#: closed spans the buffer keeps (the oldest go first)
SPAN_BUFFER = 1 << 15

# closed spans, each as bytes: id, parent (0 at a root), root, start, end,
# profiled, then the name and each "key=value" count, NUL-separated
_BUFFER: collections.deque = collections.deque(maxlen=SPAN_BUFFER)
_HEAD = struct.Struct("<qqqqq?")
# a span's range in the profiler's trace: the function-scope range where
# this torch has it, else record_function's user-scope one
_RANGE = getattr(torch._C._profiler, "_RecordFunctionFast", None) or torch.profiler.record_function
_IDS = itertools.count(1)
_LOCAL = threading.local()
# the innermost open span of the thread that opened a span last (among the
# threads whose spans hang from a root of their own)
_LATEST = None
_WARM = False
# counts may arrive from several threads (autograd's, a writer's pool)
_COUNT_LOCK = threading.Lock()


class Span:
    """One piece of traced work.  ``start_ns`` / ``end_ns`` on the Unix
    clock (``time.time_ns``); ``parent`` and ``root`` are span ids (``parent``
    None at a root, whose ``root`` is its own id); ``counts`` its counters;
    ``profiled`` whether a torch profiler recorded while it opened."""

    __slots__ = ("name", "id", "parent", "root", "start_ns", "end_ns", "counts", "profiled",
                 "_up", "_range", "_leads")

    def __init__(self, name: str, counts: dict):
        self.name, self.counts = name, counts
        self.id = next(_IDS)
        self.end_ns = None

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6

    def __enter__(self):
        global _LATEST, _WARM
        stack = getattr(_LOCAL, "stack", None)
        if stack is None:
            stack = _LOCAL.stack = []
        up = stack[-1] if stack else _LATEST
        # a span on a thread whose spans hang from a root of its own leads:
        # a thread with no span open joins the span a leading one opened last
        self._leads = stack[0].parent is None if stack else up is None
        self._up = up
        self.parent = None if up is None else up.id
        self.root = self.id if up is None else up.root
        self.profiled = _profiler._is_profiler_enabled
        if not _WARM:
            # a process's first range sets up the profiler's hooks after
            # taking its timestamp (about 1.5 ms): spend it on a throwaway
            _WARM = True
            with _RANGE("gsconverter/_first"):
                pass
        self._range = _RANGE(f"gsconverter/{self.name}")
        self._range.__enter__()
        # read after the range's own timestamp, and the end after its end's:
        # both lie a few microseconds after the profiler's
        self.start_ns = time.time_ns()
        stack.append(self)
        if self._leads:
            _LATEST = self
        return self

    def __exit__(self, *exc):
        global _LATEST
        stack = _LOCAL.stack
        if stack and stack[-1] is self:
            stack.pop()
        if self._leads and _LATEST is self:
            _LATEST = self._up
        self._up = None
        self._range.__exit__(*exc)
        self._range = None
        self.end_ns = time.time_ns()
        tail = "\0".join([self.name] + [f"{k}={v}" for k, v in self.counts.items()])
        _BUFFER.append(_HEAD.pack(self.id, self.parent or 0, self.root, self.start_ns,
                                  self.end_ns, self.profiled) + tail.encode())
        return False


class _Off:
    """The context a span is while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str, **counts):
    """A traced piece of work named ``name`` with counters ``counts``
    (numbers); the shared no-op context while tracing is off."""
    if not (_profiler._is_profiler_enabled or config.TIMING):
        return _OFF
    return Span(name, counts)


def count(**counts) -> None:
    """Add ``counts`` to the innermost open span (this thread's, else the
    one a span opened here would take as its parent) and to each span it
    lies in; nothing while off."""
    if not (_profiler._is_profiler_enabled or config.TIMING):
        return
    stack = getattr(_LOCAL, "stack", None)
    sp = stack[-1] if stack else _LATEST
    with _COUNT_LOCK:
        while sp is not None:
            c = sp.counts
            for k, v in counts.items():
                c[k] = c.get(k, 0) + v
            sp = sp._up


#: a closed span as ``spans()`` returns it (the fields of ``Span``)
SpanRecord = collections.namedtuple(
    "SpanRecord", "name id parent root start_ns end_ns profiled counts")


def _number(text: str):
    try:
        return int(text)
    except ValueError:
        return float(text)


def spans() -> list:
    """The closed spans in the buffer as ``SpanRecord``s, in the order
    they closed (the buffer is not cleared: several readers read one
    stretch)."""
    out = []
    for rec in list(_BUFFER):
        id_, parent, root, start, end, profiled = _HEAD.unpack_from(rec)
        name, *counts = rec[_HEAD.size:].decode().split("\0")
        out.append(SpanRecord(name, id_, parent or None, root, start, end, profiled,
                              {k: _number(v) for k, v in (c.split("=", 1) for c in counts)}))
    return out


def clear_spans() -> None:
    _BUFFER.clear()


class StageTimer:
    """Per-stage wall-clock timing + throughput reporting.

    A stage's time is host wall-clock; stages that launch device work end
    in a host readback of their result, so the time covers the device work.
    Each stage is a span (``span``).
    """

    def __init__(self) -> None:
        self.records: list[tuple[str, float, int | None]] = []

    @contextlib.contextmanager
    def stage(self, name: str, n_items: int | None = None, sync=None, digits: int = 1):
        """Time the block as stage ``name`` of ``n_items`` splats.  With
        ``config.TIMING`` it ends in ``sync()`` when given (its device work
        counted in its time) and prints its line, the ms to ``digits``
        decimals."""
        t0 = time.perf_counter()
        try:
            with (span(name) if n_items is None else span(name, splats=n_items)):
                yield
                if sync is not None and config.TIMING:
                    sync()
        finally:
            dt = time.perf_counter() - t0
            self.records.append((name, dt, n_items))
            if config.TIMING:
                rate = f" ({n_items / dt / 1e6:.2f} Msplats/s)" if n_items else ""
                status_print(f"[timing] {name}: {dt * 1e3:.{digits}f} ms{rate}")

    def report(self) -> dict[str, float]:
        return {name: dt for name, dt, _ in self.records}
