"""The port's spans: named intervals of the training loop, the serve call
and the model's layers, recorded while a ``torch.profiler`` session runs.

    with trace.span("train.arrival", root=True):
        with trace.span("train.grad"):
            ...
    trace.records()  # the latest session's spans, as ``Record``s

Off (``torch.autograd._profiler_enabled()`` is False), ``span`` makes
that one C call and returns a shared no-op: nothing is recorded and no
CUDA event made.  On, a span records its name, parent and root, its host
start and end (``time.perf_counter_ns``) and its device start and end:
CUDA events on the current stream at its edges, read as ms from its
root's start event only in ``records()`` (on the CPU, where the device
is the host, the host times).  It also opens a ``record_function`` range
``rt.<name>``, which puts it on the profiler's timeline.  A root on the
card reads the caching allocator's ``num_device_alloc`` (``cudaMalloc``
calls) and ``num_alloc_retries`` (allocations that freed the cache and
tried again) at its entry and exit, outside its clocks, and records the
deltas.

Only whole roots are recorded: a root entered while the profiler is off
records nothing, nor does a span entered with no recorded root open.
The records belong to the latest session: a root entered, or
``records()`` read, while the profiler is off ends it, and the next root
entered under a profiler clears them.  Spans are entered from the thread
that runs the loop or the call.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import torch

PREFIX = "rt."
_profiler_enabled = torch.autograd._profiler_enabled


@dataclasses.dataclass
class Record:
    """One span.  ``parent`` and ``root`` index ``records()`` (a root's
    ``parent`` is None, its ``root`` its own index); device times are ms
    from the root's device start; ``device_allocs`` and ``alloc_retries``
    are set on a root on the card, else None."""
    name: str
    parent: Optional[int]
    root: int
    host_start_ns: int
    host_end_ns: int
    device_start_ms: float
    device_end_ms: float
    device_allocs: Optional[int] = None
    alloc_retries: Optional[int] = None

    @property
    def host_ms(self) -> float:
        return (self.host_end_ns - self.host_start_ns) / 1e6

    @property
    def device_ms(self) -> float:
        return self.device_end_ms - self.device_start_ms


class _Session:
    def __init__(self):
        self.spans: List[_Span] = []  # recorded, in entry order
        self.stack: List[_Span] = []  # the open ones
        self.ended = True  # the next recorded root starts a session


_SESSION = _Session()


class _Off:
    """A span entered while the profiler is off; a root's ends the
    session."""
    __slots__ = ("root",)

    def __init__(self, root: bool):
        self.root = root

    def __enter__(self):
        if self.root:
            _SESSION.ended = True
        return self

    def __exit__(self, *exc):
        return False


_OFF, _OFF_ROOT = _Off(False), _Off(True)


def _alloc_counts():
    # the allocator's own dict: ``memory_stats`` also flattens and sorts it
    stats = torch.cuda.memory_stats_as_nested_dict()
    return stats["num_device_alloc"], stats["num_alloc_retries"]


class _Span:
    __slots__ = ("name", "is_root", "index", "parent", "root", "on_card",
                 "range", "events", "t0", "t1", "allocs0", "allocs")

    def __init__(self, name: str, is_root: bool):
        self.name, self.is_root, self.index = name, is_root, None

    def __enter__(self):
        s = _SESSION
        if s.stack:
            top = s.stack[-1]
            self.parent, self.root, self.on_card = (top.index, top.root,
                                                    top.on_card)
        elif self.is_root:
            if s.ended:
                s.spans.clear()
                s.ended = False
            self.parent, self.root = None, len(s.spans)
            self.on_card = torch.cuda.is_initialized()
            self.allocs = None
            if self.on_card:
                self.allocs0 = _alloc_counts()
        else:
            return self
        self.index = len(s.spans)
        s.spans.append(self)
        s.stack.append(self)
        self.t1 = None
        self.range = torch.profiler.record_function(PREFIX + self.name)
        self.range.__enter__()
        if self.on_card:
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self.index is None:
            return False
        self.t1 = time.perf_counter_ns()
        if self.on_card:
            self.events[1].record()
        self.range.__exit__(*exc)
        _SESSION.stack.pop()
        if self.parent is None and self.on_card:
            self.allocs = tuple(b - a for a, b in
                                zip(self.allocs0, _alloc_counts()))
        return False


def span(name: str, root: bool = False):
    """A context manager: the span ``name``.  ``root``: it may start a
    record (an arrival, a call); any other span is recorded only inside
    a recorded root."""
    if not _profiler_enabled():
        return _OFF_ROOT if root else _OFF
    return _Span(name, root)


def _device_ms(sp: _Span, root: _Span):
    if not sp.on_card:
        return (sp.t0 - root.t0) / 1e6, (sp.t1 - root.t0) / 1e6
    start = root.events[0]
    return start.elapsed_time(sp.events[0]), start.elapsed_time(sp.events[1])


def records() -> List[Record]:
    """The latest session's spans of every root that has ended, in entry
    order.  Waits for the device to reach each root's end.  Read while
    the profiler is off, it ends the session."""
    s = _SESSION
    if not _profiler_enabled():
        s.ended = True
    spans = s.spans[:s.stack[0].index] if s.stack else s.spans
    out = []
    for sp in spans:
        root = spans[sp.root]
        if sp is root and sp.on_card:
            sp.events[1].synchronize()
        allocs = sp.allocs if sp is root and sp.allocs else (None, None)
        out.append(Record(sp.name, sp.parent, sp.root, sp.t0, sp.t1,
                          *_device_ms(sp, root), *allocs))
    return out
