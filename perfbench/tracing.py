"""Spans and the device trace of a traced run (``--trace 1``).

Spans come from the benchmark's own files: ``patched`` rebinds named
functions of a port module, for the length of a ``with`` block, to
wrappers (here, ``torch.profiler.record_function`` ranges named
``pb.<function>``).  ``Trace`` runs ``torch.profiler`` over the traced
window and reduces its chrome trace: each device operation (kernel,
copy, fill) is put under the innermost span whose host range holds the
call that launched it (CUDA's correlation ids tie the two), the busy
time is the union of the device operations' intervals, and the idle
gaps are labelled by the span and the host operation running when each
gap began.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

import torch

from perfbench.drivers import common

SPAN_PREFIX = "pb."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


@contextlib.contextmanager
def patched(module, wrappers: Dict[str, Callable[[Callable], Callable]]):
    """Rebind ``module.<name>`` to ``wrap(original)`` for each entry,
    and back on exit."""
    saved = {name: getattr(module, name) for name in wrappers}
    try:
        for name, wrap in wrappers.items():
            setattr(module, name, wrap(saved[name]))
        yield
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)


def span(name: str) -> Callable[[Callable], Callable]:
    """A wrapper factory: the call inside a ``pb.<name>`` range."""
    def wrap(fn):
        def inner(*args, **kwargs):
            with torch.profiler.record_function(SPAN_PREFIX + name):
                return fn(*args, **kwargs)
        return inner
    return wrap


class Trace:
    """``start()`` / ``stop()`` around the traced window, then
    ``summary()``."""

    def __init__(self, device):
        from torch.profiler import ProfilerActivity, profile
        self._device = device
        acts = [ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self.window_s = None
        self._t0 = None

    def start(self):
        common.sync(self._device)
        self._prof.start()
        self._t0 = time.perf_counter()

    def stop(self):
        common.sync(self._device)
        self.window_s = time.perf_counter() - self._t0
        self._prof.stop()

    def summary(self) -> "TraceSummary":
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        return TraceSummary(events, self.window_s)


def _intervals_union(iv: List[Tuple[float, float]]):
    iv = sorted(iv)
    out: List[List[float]] = []
    for a, b in iv:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class _Ranges:
    """Host ranges (start, end, name) of one kind, queried for the
    innermost one holding a time."""

    def __init__(self, ranges: List[Tuple[float, float, str]]):
        self.r = sorted(ranges)
        self.starts = [a for a, _, _ in self.r]

    def innermost(self, t: float) -> Optional[str]:
        i = bisect.bisect_right(self.starts, t)
        best = None
        # ranges nest: walk back over those that start before t
        for a, b, name in reversed(self.r[max(0, i - 64):i]):
            if a <= t <= b and (best is None or a >= best[0]):
                best = (a, name)
        return best[1] if best else None


class TraceSummary:
    """The traced window's device operations, reduced.

    ``ops``: [(name, start_us, dur_us, span)] of every device operation;
    ``busy_s``: the union of their intervals; ``window_s``: the window's
    length on the host's clock; ``span_s``: device seconds by innermost
    span (``None``: outside every span)."""

    def __init__(self, events: List[dict], window_s: float):
        self.window_s = window_s
        launch_ts: Dict[int, Tuple[float, int]] = {}
        spans, host_ops = [], []
        dev = []
        for e in events:
            cat = e.get("cat")
            if e.get("ph") != "X":
                continue
            if cat in DEVICE_CATS:
                dev.append(e)
            elif cat in LAUNCH_CATS:
                corr = (e.get("args") or {}).get("correlation")
                if corr is not None:
                    launch_ts[corr] = (float(e["ts"]), e.get("tid"))
            elif cat == "user_annotation" and e["name"].startswith(
                    SPAN_PREFIX):
                spans.append((float(e["ts"]), float(e["ts"]) + e["dur"],
                              e["name"][len(SPAN_PREFIX):]))
            elif cat == "cpu_op":
                host_ops.append((float(e["ts"]), float(e["ts"]) + e["dur"],
                                 e["name"]))
        span_ranges = _Ranges(spans)
        self._host_ops = _Ranges(host_ops)
        self._spans = span_ranges
        self.ops = []
        for e in dev:
            corr = (e.get("args") or {}).get("correlation")
            host = launch_ts.get(corr)
            sp = span_ranges.innermost(host[0]) if host else None
            self.ops.append((e["name"], float(e["ts"]), float(e["dur"]), sp))
        self._busy = _intervals_union([(ts, ts + d)
                                       for _, ts, d, _ in self.ops])
        self.busy_s = sum(b - a for a, b in self._busy) / 1e6
        self.span_s: Dict[Optional[str], float] = defaultdict(float)
        for _, _, d, sp in self.ops:
            self.span_s[sp] += d / 1e6

    def kernel(self, pattern: str) -> Tuple[float, int]:
        """(device seconds, count) of the operations whose name holds
        ``pattern``."""
        hits = [d for name, _, d, _ in self.ops if pattern in name]
        return sum(hits) / 1e6, len(hits)

    def top_ops(self, n: int = 10) -> List[List]:
        by: Dict[str, float] = defaultdict(float)
        for name, _, d, _ in self.ops:
            by[name] += d / 1e6
        return [[k[:160], v] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The ``n`` longest gaps between device operations, each as
        ["<span>/<host op>", seconds]: what the host was inside when
        the device went idle."""
        gaps = []
        for (a0, b0), (a1, _) in zip(self._busy, self._busy[1:]):
            sp = self._spans.innermost(b0) or "loop"
            op = self._host_ops.innermost(b0) or "python"
            gaps.append([f"{sp}/{op}"[:160], (a1 - b0) / 1e6])
        return sorted(gaps, key=lambda g: -g[1])[:n]
