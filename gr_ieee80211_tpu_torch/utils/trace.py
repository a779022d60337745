"""Counters and spans of the port's receive path.

**Counters** are one process-wide registry of named numbers, always on:
``count(name, n)`` adds to one, ``snapshot()`` returns a copy,
``reset()`` zeroes them all.  Every fact the port counts about itself
is one of them, counted where it happens; a reader takes the difference
of two snapshots around what it measures and never resets.

**Spans** are recorded only between ``enable()`` and ``disable()``.  Off,
``span(name)`` costs one flag test and returns a shared no-op context.
On, a span appends ``Span(name, parent, block, t0, t1, child_s)`` to a
bounded list (``spans()``; the oldest are dropped past ``MAX_SPANS``) and,
while a ``torch.profiler`` session records, opens a
``record_function("span:" + name)`` range, so the spans share the
device events' clock in the profiler's trace.  ``parent`` is the name of
the span open around it on the same thread, ``block`` the id of the
receive block it belongs to (``new_block()``, set by ``in_block``),
``child_s`` the seconds its child spans cover; ``summary()`` gives each
name's count, total and self time.

**Synchronizations**: ``sync(site, n)`` counts ``n`` host-device
synchronizations under ``sync.<site>`` and ``sync.total`` and, on, spans
the wait as ``sync.<site>``.  Wrap exactly the call that makes the host
wait for the device (a device-to-host copy, ``.item()``, ``nonzero``, a
boolean-mask index, an upload from pageable host memory) and nothing
else, so that the span's duration is the time the host sat blocked
there.  The count is kept whatever the device: on the CPU it counts the
places where a card would make the host wait.

Names are dotted: ``rx.*`` (the engine), ``decode.*`` (the decode
ladder), ``sync.*`` and ``kernel.*`` (``ops.cuda_lib.launch``: each
accepted launch as ``kernel.<wrapper>.launches`` and
``kernel.<wrapper>.at.<shape>``).
"""
from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import NamedTuple

import torch

#: spans kept in memory; beyond it the oldest are dropped
MAX_SPANS = 1 << 18

_on = False
_lock = threading.Lock()
_counts: dict[str, float] = {}
_spans: collections.deque = collections.deque(maxlen=MAX_SPANS)
_local = threading.local()
_block_ids = itertools.count()


class Span(NamedTuple):
    name: str
    parent: str | None
    block: int | None
    t0: float
    t1: float
    child_s: float

    @property
    def self_s(self) -> float:
        return self.t1 - self.t0 - self.child_s


# ---------------------------------------------------------------------------
# counters
# ---------------------------------------------------------------------------

def count(name: str, n: float = 1):
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


def snapshot() -> dict[str, float]:
    """A copy of every counter."""
    with _lock:
        return dict(_counts)


def reset():
    """Zero every counter and drop every recorded span."""
    with _lock:
        _counts.clear()
    _spans.clear()


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

def enable():
    global _on
    _on = True


def disable():
    global _on
    _on = False


def new_block() -> int:
    """A fresh receive-block id, unique in the process."""
    return next(_block_ids)


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _Open:
    """One span being recorded; open ones sit on the thread's stack."""
    __slots__ = ("name", "parent", "block", "rf", "t0", "child")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        st = _stack()
        self.parent = st[-1] if st else None
        st.append(self)
        self.block = getattr(_local, "block", None)
        self.rf = None
        if torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function("span:" + self.name)
            self.rf.__enter__()
        self.child = 0.0
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        _stack().pop()
        if self.parent is not None:
            self.parent.child += t1 - self.t0
        _spans.append(Span(self.name,
                           self.parent.name if self.parent else None,
                           self.block, self.t0, t1, self.child))
        return False


def span(name: str):
    """Context manager: the body as span ``name`` (a no-op while off)."""
    return _Open(name) if _on else _NULL


class _Block:
    __slots__ = ("bid", "prev")

    def __init__(self, bid: int):
        self.bid = bid

    def __enter__(self):
        self.prev = getattr(_local, "block", None)
        _local.block = self.bid
        return self

    def __exit__(self, *exc):
        _local.block = self.prev
        return False


def in_block(bid: int):
    """Context manager: spans opened in the body carry block id ``bid``."""
    return _Block(bid) if _on else _NULL


def sync(site: str, n: int = 1):
    """Count ``n`` synchronizations at ``site``; the body is their wait."""
    with _lock:
        key = "sync." + site
        _counts[key] = _counts.get(key, 0) + n
        _counts["sync.total"] = _counts.get("sync.total", 0) + n
    return _Open("sync." + site) if _on else _NULL


def spans() -> list[Span]:
    return list(_spans)


def summary() -> dict[str, dict]:
    """name -> {"count", "total_s", "self_s"} over the recorded spans."""
    out: dict[str, dict] = {}
    for s in list(_spans):
        d = out.setdefault(s.name, {"count": 0, "total_s": 0.0,
                                    "self_s": 0.0})
        d["count"] += 1
        d["total_s"] += s.t1 - s.t0
        d["self_s"] += s.self_s
    return out
