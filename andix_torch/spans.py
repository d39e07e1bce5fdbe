"""Spans and counters of one CLI call, and the operator's phase file.

``ANDIX_PROF_FILE`` is the only switch, read once a CLI call by
``request()``.  Unset, ``span()`` returns the shared ``NULL`` span,
``count()`` returns at once and ``upload()``/``readback()`` are the plain
copies: no event, no allocation, no file.

Set, each ``span(name, device, **attrs)`` records its name (one of
``NAMES``), the request (CLI call) it belongs to, its parent (the
innermost open span of its thread, or the span ``parent=`` hands a worker
thread), thread, device, host start and end on ``time.perf_counter_ns``,
numeric attributes and counters.  ``upload`` counts ``h2d_bytes`` and the
host nanoseconds of the copy (``upload_ns``), ``readback`` the host
nanoseconds it blocks (``wait_ns``), on the innermost open span.

On a CUDA device a span also records an event on the device's current
stream at its start and end, and nothing waits for them during the call.
The device's first span of the request records an anchor event and waits
for it where the stream is idle (the previous call has read its output
back), which puts every later event on the host clock.  At the request's
end the last event of each stream is waited for; the CLI's output
readback has already waited for the work before it.

At the end, one line per phase span (``LABELS``: every phase runs on a
device) is appended to the file in one write, ``[<device>] <label>:
<seconds>s``.  The label is built from the span's attributes, its
``kind`` picking one of the phase's labels (``NO_LINE``: none).  The
seconds run from the later of the phase's host start and the previous
phase's completion in its thread to its completion, the later of its host
end and its end event's time.  The request goes to ``REQUESTS`` (the last
64) as a dict: ``id``, host ``t0`` and ``t1``, its ``spans`` (each a dict:
``id``, ``name``, ``parent``, ``thread``, ``device``, host ``t0``/``t1``
and device ``d0``/``d1`` in host nanoseconds, ``attrs``, ``counts``, and
for a phase ``label`` and ``seconds``) and the ``counts`` made outside any
span.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time

import torch

_clock = time.perf_counter_ns

# kinds of ``joint.lcp``, ``joint.walk`` and ``sx.walk``
LCP, LCP_OVERFLOW, HOST_LCP = 0, 1, 2
WALK_SEGMENTED, WALK_UNSEGMENTED, WALK_OVERFLOW, WALK_REPLAY = 0, 1, 2, 3
SX_WALKED, SX_STALLED = 0, 1
NO_LINE = -1


def _lcp_label(a):
    if a["kind"] == HOST_LCP:
        return "host LCP round trip"
    mode = "hybrid" if a["hybrid"] else "levels"
    return f"LCP {mode}" + (": level overflow" if a["kind"] == LCP_OVERFLOW
                            else "")


def _walk_label(a):
    return (f"segmented walk: {a['dispatches']} dispatches, "
            f"{a['probe_steps']} probe steps, {a['events']} events")


# each phase's labels by kind; a walk's dispatches and probe steps are its
# ``walk.dispatch`` spans and their ``walk.probe_steps``
LABELS = {
    "joint.upload": (lambda a: f"H2D text ({a['padded']} padded symbols)",),
    "joint.sa": (lambda a: f"SA doubling ({a['levels']} levels, buffer "
                 f"{a['buffer']})",),
    "joint.lcp": (_lcp_label,) * 3,
    "joint.tables": (lambda a: "block tables (segid+isa+tq+rmq)",),
    "joint.subject_tables": (lambda a: f"subject tables ({a['subjects']} "
                             "subj)",),
    "joint.walk": (
        _walk_label,
        lambda a: (f"anchor chain dispatch ({a['subjects']} subj, "
                   f"{a['loop_iters']} loop iters, {a['events']} events)"),
        lambda a: (f"event buffer of {a['cap']} overflowed: to the "
                   "count-in-loop replay"),
        lambda a: (f"count-in-loop replay ({a['subjects']} subj, "
                   f"{a['probe_steps']} probe steps)")),
    "count": (lambda a: f"host count from {a['events']} events",),
    "sx.query_words": (lambda a: "sx: query words H2D",),
    "sx.index": (lambda a: f"sx: index build ({a['subjects']} subj, "
                 f"{a['host_lcp']} host LCP round trips after a level "
                 "overflow)",),
    "sx.walk": (lambda a: "sx: " + _walk_label(a),
                lambda a: "sx: walk stalled at the chunk cap: to the joint "
                "schedule"),
    "sx.count": (lambda a: f"sx: host count from {a['events']} events",),
}
# host spans: every file's parse and normalize, one file's host read in
# join mode, the subjects' set-up, one subject the host makes, the padded
# texts, the subject schedule's plan, one segmented-driver dispatch, one
# worker thread; the FASTA read's counters of files read on the card and
# on the host, of the files joined on the card, and of the records and
# joiners of the files joined; the subjects' counters of those made on
# the host and from the card; the walk's counter of groups walked by the
# segmented driver; and the subject indexes' counters of texts made on
# the device and on the host
NAMES = frozenset(LABELS) | {"fasta.read", "ingest.join", "subjects",
                             "subjects.host", "joint.text", "sx.text",
                             "sx.plan", "walk.dispatch", "worker",
                             "ingest.device_files", "ingest.host_files",
                             "join.records", "join.joiners",
                             "join.device_files",
                             "subjects.host_rs", "subjects.device_rs",
                             "walk.driver_native", "sx.text_device",
                             "sx.text_host"}

REQUESTS: collections.deque = collections.deque(maxlen=64)

_req = None  # the open request
_ids = itertools.count(1)
_local = threading.local()  # each thread's open spans
_lock = threading.Lock()
_pool: dict[int, list] = {}  # free timing events by card


class _Null:
    """The one span of every call while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self):
        return False

    def set(self, **attrs):
        pass

    def end(self):
        pass


NULL = _Null()


class _Request:
    def __init__(self, path: str):
        self.path = path
        self.id = next(_ids)
        self.t0 = _clock()
        self.spans: list[Span] = []
        self.counts: dict[str, int] = {}
        self.anchors: dict[int, tuple] = {}  # card -> (event, host ns)
        self.last: dict[tuple, object] = {}  # (card, stream) -> event


class Span:
    """An open or ended span of the open request (``span()``)."""

    __slots__ = ("name", "id", "parent", "thread", "device", "attrs",
                 "counts", "t0", "t1", "ev0", "ev1", "_req")

    def __init__(self, req, name, device, parent, attrs):
        self._req = req
        self.name = name
        self.id = next(_ids)
        self.parent = parent.id if parent is not None else None
        self.thread = threading.get_ident()
        self.device = device
        self.attrs = attrs
        self.counts: dict[str, int] = {}
        self.t0 = _clock()
        self.t1 = None
        self.ev0 = self.ev1 = None
        if device is not None and device.type == "cuda":
            self.ev0 = _record(req, device)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.end()
        return False

    def set(self, **attrs):
        """Numeric attributes; a 0-d device tensor is read at the
        request's end."""
        self.attrs.update(attrs)

    def end(self):
        if self.t1 is not None:
            return
        self.t1 = _clock()
        if self.ev0 is not None:
            self.ev1 = _record(self._req, self.device)
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def _event(card: int):
    try:
        return _pool.setdefault(card, []).pop()
    except IndexError:
        return torch.cuda.Event(enable_timing=True)


def _record(req, device):
    card = device.index if device.index is not None else \
        torch.cuda.current_device()
    stream = torch.cuda.current_stream(card)
    if card not in req.anchors:
        with _lock:
            if card not in req.anchors:
                anchor = _event(card)
                anchor.record(stream)
                anchor.synchronize()  # the stream is idle here
                req.anchors[card] = (anchor, _clock())
    ev = _event(card)
    ev.record(stream)
    req.last[card, stream.cuda_stream] = ev
    return ev


def span(name: str, device=None, parent: Span | None = None, **attrs):
    """Open a span (``NULL`` while tracing is off); ``with`` or ``end()``
    closes it.  ``device`` is where its work runs (None: the host);
    ``parent`` (a worker thread's first span) defaults to the innermost
    open span of this thread."""
    req = _req
    if req is None:
        return NULL
    if name not in NAMES:
        raise ValueError(f"spans: no span is named {name!r}")
    stack = _stack()
    if parent is None and stack:
        parent = stack[-1]
    s = Span(req, name, torch.device(device) if device is not None
             else None, parent, attrs)
    stack.append(s)
    req.spans.append(s)
    return s


def current() -> Span | None:
    """The innermost open span of this thread (None while tracing is
    off)."""
    if _req is None:
        return None
    stack = _stack()
    return stack[-1] if stack else None


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` of the innermost open span of this
    thread (of the request, outside every span)."""
    req = _req
    if req is None:
        return
    stack = _stack()
    if stack:
        counts = stack[-1].counts
        counts[name] = counts.get(name, 0) + int(n)
    else:
        with _lock:
            req.counts[name] = req.counts.get(name, 0) + int(n)


def upload(a, device, out: torch.Tensor | None = None) -> torch.Tensor:
    """``a`` (a numpy array or a host tensor) on ``device`` (copied into
    ``out``, a tensor of its shape and type there, where given); counts
    the bytes and the host nanoseconds of a copy to a card."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(a)
    if _req is None:
        return t.to(device) if out is None else out.copy_(t)
    t0 = _clock()
    out = t.to(device) if out is None else out.copy_(t)
    if out.device.type != "cpu":
        count("upload_ns", _clock() - t0)
        count("h2d_bytes", t.nbytes)
    return out


def readback(t: torch.Tensor, out: torch.Tensor | None = None
             ) -> torch.Tensor:
    """``t`` on the host (copied into ``out``, a host tensor of its shape
    and type, where given); counts the host nanoseconds the call blocks.
    Every blocking read of a device tensor goes through here."""
    if _req is None:
        return t.cpu() if out is None else out.copy_(t)
    t0 = _clock()
    out = t.cpu() if out is None else out.copy_(t)
    count("wait_ns", _clock() - t0)
    return out


@contextlib.contextmanager
def request():
    """One CLI call: reads ``ANDIX_PROF_FILE``; when set, records the
    call's spans and, at its end, keeps them in ``REQUESTS`` and writes
    the phase lines.  Inside an open request it adds nothing."""
    global _req
    path = os.environ.get("ANDIX_PROF_FILE")
    if not path or _req is not None:
        yield
        return
    req = _req = _Request(path)
    _local.stack = []
    try:
        yield
    except BaseException:
        _req = None
        _local.stack = []
        raise
    _req = None
    _local.stack = []
    _finish(req)


def _finish(req: _Request) -> None:
    t1 = _clock()
    for ev in req.last.values():
        ev.synchronize()  # the end marker
    done = []
    for s in req.spans:
        d0 = d1 = None
        if s.ev0 is not None:
            card = s.device.index if s.device.index is not None else \
                torch.cuda.current_device()
            anchor, host = req.anchors[card]
            d0 = host + round(anchor.elapsed_time(s.ev0) * 1e6)
            if s.ev1 is not None:
                d1 = host + round(anchor.elapsed_time(s.ev1) * 1e6)
            _pool[card].extend(e for e in (s.ev0, s.ev1) if e is not None)
        done.append({
            "id": s.id, "name": s.name, "parent": s.parent,
            "thread": s.thread,
            "device": str(s.device) if s.device is not None else None,
            "t0": s.t0, "t1": s.t1 if s.t1 is not None else t1,
            "d0": d0, "d1": d1,
            "attrs": {k: int(v) if isinstance(v, torch.Tensor) else v
                      for k, v in s.attrs.items()},
            "counts": s.counts})
    for card, (anchor, _) in req.anchors.items():
        _pool[card].append(anchor)
    lines = _phases(done)
    REQUESTS.append({"id": req.id, "t0": req.t0, "t1": t1, "spans": done,
                     "counts": req.counts})
    if lines:
        with open(req.path, "a") as f:
            f.write("".join(lines))


def _phases(done: list[dict]) -> list[str]:
    """Label and time each phase span of a finished request (in place);
    its lines in order of completion."""
    by_id = {s["id"]: s for s in done}
    walks: dict[int, list] = {}
    for s in done:
        if s["name"] == "walk.dispatch":
            up = by_id.get(s["parent"])
            while up is not None and up["name"] not in LABELS:
                up = by_id.get(up["parent"])
            if up is not None:
                walks.setdefault(up["id"], []).append(s)
    ends = {}
    last: dict[int, int] = {}  # thread -> the previous phase's completion
    for s in done:
        if s["name"] not in LABELS:
            continue
        end = max(s["t1"], s["d1"] or 0)
        prev = last.get(s["thread"])
        start = s["t0"] if prev is None else max(s["t0"], prev)
        s["seconds"] = max(0, end - start) / 1e9
        last[s["thread"]] = end if prev is None else max(prev, end)
        kind = s["attrs"].get("kind", 0)
        dispatches = walks.get(s["id"], [])
        a = {"dispatches": len(dispatches),
             "probe_steps": sum(d["counts"].get("walk.probe_steps", 0)
                                for d in dispatches),
             **s["attrs"], "kind": kind}
        s["label"] = None if kind == NO_LINE else LABELS[s["name"]][kind](a)
        if s["label"] is not None:
            ends[s["id"]] = end
    return [f"[{by_id[i]['device']}] {by_id[i]['label']}: "
            f"{by_id[i]['seconds']:.6f}s\n"
            for i in sorted(ends, key=lambda i: (ends[i], by_id[i]["t0"]))]


def self_ns(spans: list[dict]) -> dict[int, int]:
    """Each span's host nanoseconds that none of its children covers (a
    finished request's ``spans``)."""
    kids: dict[int, list] = {}
    for s in spans:
        if s["parent"] is not None:
            kids.setdefault(s["parent"], []).append((s["t0"], s["t1"]))
    out = {}
    for s in spans:
        covered, reach = 0, s["t0"]
        for a, b in sorted(kids.get(s["id"], [])):
            a, b = max(a, reach), min(b, s["t1"])
            if b > a:
                covered += b - a
                reach = b
        out[s["id"]] = s["t1"] - s["t0"] - covered
    return out
