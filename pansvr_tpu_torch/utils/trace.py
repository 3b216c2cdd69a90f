"""Program spans of the fc_aln path, on the clock of the device trace.

One recorder (`Spans`) an engine. A span is

    with spans.span("prep_wait", "prep_wait", "host_submit", batch=bid):
        ...

and always adds its seconds to each counter it names in `prof` (the
engine's dict of numbers, which callers subtract key by key). The spans
of the thread that owns the recorder (the one that builds the engine and
drives its stream) also add the time from an outermost span's start to
its end to `main_traced_s`: outside them that thread runs Python glue
only.

While a torch profiler is active (`torch.profiler.profile`, fc_aln
--trace) a span also records itself in `ring`, a bounded deque of `Span`
records (name, batch id, retry count, thread, start and end in
perf_counter_ns, attributes); a span that names no batch takes the one
of the owner's span it runs inside. On the owning thread it is also a
profiler range `pansvr.<name>`, and those ranges never nest: a child's
range closes its parent's, which reopens when the child ends, so at any
moment the owner is under at most one range, its innermost phase. Each
range's perf_counter_ns stamps go into `ranges`. The profiler does not
see other threads (the prep worker): their spans reach its clock
through `match`, the median gap between the owner's ranges as the
profiler stamped them and as the recorder did.

With no profiler a span costs one check of the profiler's state and its
two clock reads: no record, no profiler range.
"""

from __future__ import annotations

import json
import os
import statistics
import threading
import time
from collections import deque
from typing import NamedTuple

import torch
# a profiler range of the function scope ("cpu_op" in a trace): a
# record_function range (the user scope) would also give each range that
# launches device work a "gpu_user_annotation" on the card's timeline,
# which a trace reader counts as device time
from torch._C._profiler import _RecordFunctionFast as _Range

PREFIX = "pansvr."
RING = 65536          # spans (and owner ranges) a recorder keeps
SHIFT = 8             # range / event misalignment `match` tries


class Span(NamedTuple):
    name: str
    batch: int | None
    retry: int
    thread: int        # native thread id
    main: bool         # on the recorder's owning thread
    t0: int            # perf_counter_ns
    t1: int
    attrs: dict | None


class Spans:
    """The recorder: `span(...)` contexts over one `prof` dict."""

    def __init__(self, prof: dict):
        self.prof = prof
        self.owner = threading.get_ident()
        self.ring: deque | None = None     # Span records, while recording
        # the owner's profiler ranges: (name, batch, retry, t0, t1, d0,
        # d1), t0 and t1 stamped right before the calls that open and
        # close the range, d0 and d1 the ns those calls took (the
        # profiler stamps the range inside them)
        self.ranges: deque | None = None
        self.on = False                    # recording
        self._lock = threading.Lock()
        self._depth = 0                    # owner spans open
        self._top = 0                      # start of the outermost
        self._open: list = []              # owner's recorded spans open

    def span(self, name: str, *keys: str, batch=None, retry=None, **attrs):
        """A context that adds its seconds to prof[k] for k in keys;
        `batch`, `retry` and `attrs` go into its record while a profiler
        is active. The context's `s` holds its seconds once it ends."""
        main = threading.get_ident() == self.owner
        if main:
            # the profiler's state is the owner thread's (another thread
            # reads it off), so other threads record when the owner does
            self.on = torch.autograd._profiler_enabled()
        if self.on:
            return _Recorded(self, keys, main, name, batch, retry, attrs)
        return _Timed(self, keys, main)

    def _rings(self) -> None:
        with self._lock:
            if self.ring is None:
                self.ring = deque(maxlen=RING)
                self.ranges = deque(maxlen=RING)


class _Timed:
    __slots__ = ("sp", "keys", "main", "t0", "s")

    def __init__(self, sp: Spans, keys: tuple, main: bool):
        self.sp = sp
        self.keys = keys
        self.main = main

    def __enter__(self):
        sp = self.sp
        self.t0 = t = time.perf_counter_ns()
        if self.main:
            if not sp._depth:
                sp._top = t
            sp._depth += 1
        return self

    def __exit__(self, *exc):
        self._count(time.perf_counter_ns())
        return False

    def _count(self, t: int) -> None:
        sp, prof = self.sp, self.sp.prof
        self.s = s = (t - self.t0) / 1e9
        for k in self.keys:
            prof[k] += s
        if self.main:
            sp._depth -= 1
            if not sp._depth:
                prof["main_traced_s"] += (t - sp._top) / 1e9

    def attr(self, **kw) -> None:
        """Attributes for the record (nothing to record here)."""


class _Recorded(_Timed):
    __slots__ = ("name", "batch", "retry", "attrs", "rf", "r0", "d0")

    def __init__(self, sp, keys, main, name, batch, retry, attrs):
        super().__init__(sp, keys, main)
        self.name = name
        self.batch = batch
        self.retry = retry
        self.attrs = attrs

    def __enter__(self):
        sp = self.sp
        if sp.ring is None:
            sp._rings()
        main = self.main
        self.t0 = t = time.perf_counter_ns()
        if main:
            if sp._open:
                parent = sp._open[-1]
                parent._close(t)
                if self.batch is None:
                    self.batch = parent.batch
                if self.retry is None:
                    self.retry = parent.retry
            if not sp._depth:
                sp._top = t
            sp._depth += 1
            sp._open.append(self)
            self._reopen()
        return self

    def __exit__(self, *exc):
        sp = self.sp
        t = time.perf_counter_ns()
        if self.main:
            self._close(t)
            sp._open.remove(self)
        sp.ring.append(Span(self.name, self.batch, self.retry or 0,
                            threading.get_native_id(), self.main, self.t0, t,
                            self.attrs or None))
        self._count(t)
        if self.main and sp._open:
            sp._open[-1]._reopen()
        return False

    def attr(self, **kw) -> None:
        self.attrs.update(kw)

    def _reopen(self) -> None:
        self.rf = _Range(PREFIX + self.name)
        self.r0 = time.perf_counter_ns()
        self.rf.__enter__()
        self.d0 = time.perf_counter_ns() - self.r0

    def _close(self, t: int) -> None:
        self.rf.__exit__(None, None, None)
        self.sp.ranges.append((self.name, self.batch, self.retry or 0,
                               self.r0, t, self.d0,
                               time.perf_counter_ns() - t))


# ---- the profiler's clock ---------------------------------------------
def match(spans: Spans, events: list):
    """(offset us, pairs): the owner's recorded ranges paired in order
    with the profiler's (`events`: (name, start us, ...) by start) and the
    median of (profiler start - perf_counter_ns / 1e3) over the pairs;
    (None, []) with nothing to pair. The ring keeps the newest ranges and
    the profile may hold a range or two more at either end, so the lists
    are aligned at their ends and then shifted by up to SHIFT places, the
    shift with most equal names kept."""
    ranges = list(spans.ranges or ())
    base = len(events) - len(ranges)
    best = []
    for k in range(-SHIFT, SHIFT + 1):
        pairs = [(r, events[i + base + k]) for i, r in enumerate(ranges)
                 if 0 <= i + base + k < len(events)
                 and events[i + base + k][0] == PREFIX + r[0]]
        if len(pairs) > len(best):
            best = pairs
    if not best:
        return None, []
    return statistics.median(e[1] - r[3] / 1e3 for r, e in best), best


def export(prof, spans: Spans, path: str) -> dict:
    """Write the profile's chrome trace to `path` with the batch id and
    retry count in the args of each `pansvr.*` range of the owner, and
    the spans of the other threads (the prep worker) on a track of their
    own, moved to the profile's clock. Returns what it wrote: owner
    ranges tagged, worker spans, the clock offset in us."""
    prof.export_chrome_trace(path)
    with open(path) as fh:
        doc = json.load(fh)
    evs = doc["traceEvents"]
    mine = sorted((e for e in evs if e.get("ph") == "X"
                   and e.get("cat") == "cpu_op"
                   and str(e.get("name", "")).startswith(PREFIX)),
                  key=lambda e: e["ts"])
    off, pairs = match(spans, [(e["name"], e["ts"], e) for e in mine])
    for (_, batch, retry, *_), (_, _, e) in pairs:
        e.setdefault("args", {}).update(batch=batch, retry=retry)
    n_worker = 0
    if off is not None:
        pid = mine[0]["pid"]
        named = set()
        for s in spans.ring or ():
            if s.main:
                continue
            if s.thread not in named:
                named.add(s.thread)
                evs.append({"ph": "M", "name": "thread_name", "pid": pid,
                            "tid": s.thread,
                            "args": {"name": f"pansvr worker {s.thread}"}})
            evs.append({"ph": "X", "cat": "pansvr", "name": PREFIX + s.name,
                        "pid": pid, "tid": s.thread,
                        "ts": s.t0 / 1e3 + off, "dur": (s.t1 - s.t0) / 1e3,
                        "args": dict(s.attrs or {}, batch=s.batch,
                                     retry=s.retry)})
            n_worker += 1
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(doc, fh)
    os.replace(tmp, path)
    return dict(ranges=len(pairs), worker_spans=n_worker, offset_us=off)
