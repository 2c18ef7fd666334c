"""Per-layer readings of the port's own spans (``repro_torch.common.trace``),
which the port records while the traced window's profiler runs.  Each
is a mean over the root spans of one name (``train.arrival``: the traced
arrivals; ``serve.call``: the traced calls), and None where the records
hold no such root: a port without the recorder, or a run that traced
none."""
from __future__ import annotations

from typing import Iterable, List, Optional

ARRIVAL = "train.arrival"
CALL = "serve.call"


def _records() -> List:
    try:
        from repro_torch.common import trace
    except ImportError:  # a port that records no spans
        return []
    return trace.records()


def device_ms(root: str, plus: Iterable[str],
              minus: Iterable[str] = ()) -> Optional[float]:
    """Device ms a ``root`` of the spans named ``plus``, less those named
    ``minus``, inside it."""
    recs = _records()
    roots = {i for i, r in enumerate(recs)
             if r.parent is None and r.name == root}
    if not roots:
        return None
    plus, minus = set(plus), set(minus)
    total = sum(r.device_ms * (1 if r.name in plus else -1) for r in recs
                if r.root in roots and (r.name in plus or r.name in minus))
    return total / len(roots)


def allocator(root: str, field: str) -> Optional[float]:
    """The mean of a root's allocator delta ``field`` (``device_allocs``,
    ``alloc_retries``): None off the card, where a root reads none."""
    got = [getattr(r, field) for r in _records()
           if r.parent is None and r.name == root]
    if not got or None in got:
        return None
    return sum(got) / len(got)
