"""The device trace, reduced: kernels and copies on the device timeline,
the harness's spans, and the host's operations.

Reads the Chrome trace that ``torch.profiler`` exports (CUPTI activity:
kernels, copies, sets; the host's operators, the CUDA runtime calls and
the ``record_function`` spans).  Times are kept in microseconds of the
trace's clock, on which host and device events are aligned, and returned
in seconds.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")
LAUNCH_CATS = ("cuda_runtime",)


@dataclasses.dataclass
class Event:
    name: str
    ts: float
    end: float
    tid: object = None
    corr: int = -1

    @property
    def dur(self) -> float:
        return self.end - self.ts


class Trace:
    """``kernels`` and ``device`` (kernels, copies, sets) sorted by start;
    ``spans`` the harness's spans by name; ``host`` the host's operators
    and spans per thread; ``launches`` the runtime calls."""

    def __init__(self, events):
        self.kernels, self.device, self.launches = [], [], []
        self.spans = collections.defaultdict(list)
        self.host = collections.defaultdict(list)
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat = e.get("cat", "")
            ts = float(e["ts"])
            ev = Event(e.get("name", ""), ts, ts + float(e["dur"]),
                       e.get("tid"), int(e.get("args", {}).get(
                           "correlation", -1) or -1))
            if cat in DEVICE_CATS:
                self.device.append(ev)
                if cat == "kernel":
                    self.kernels.append(ev)
            elif cat in LAUNCH_CATS:
                self.launches.append(ev)
            elif cat in HOST_CATS:
                self.host[ev.tid].append(ev)
                if cat == "user_annotation":
                    self.spans[ev.name].append(ev)
        for seq in (self.kernels, self.device, self.launches,
                    *self.host.values()):
            seq.sort(key=lambda x: (x.ts, -x.end))
        self._kernel_ts = [k.ts for k in self.kernels]

    def span(self, name: str):
        """The first span of that name, or None."""
        got = self.spans.get(name)
        return got[0] if got else None

    def kernels_in(self, lo: float, hi: float, *names) -> list:
        """Kernels that start in [lo, hi] whose name holds one of
        ``names`` (all kernels when none is given)."""
        i = bisect.bisect_left(self._kernel_ts, lo)
        out = []
        for k in self.kernels[i:]:
            if k.ts > hi:
                break
            if not names or any(n in k.name for n in names):
                out.append(k)
        return out


def load(path: str) -> Trace:
    with open(path) as f:
        data = json.load(f)
    return Trace(data["traceEvents"] if isinstance(data, dict) else data)


def merged(events, lo: float, hi: float) -> list:
    """The union of the events' intervals clipped to [lo, hi], as sorted
    disjoint (start, end) pairs."""
    out = []
    for e in sorted(events, key=lambda x: x.ts):
        a, b = max(e.ts, lo), min(e.end, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy_s(trace: Trace, lo: float, hi: float) -> float:
    """Seconds of [lo, hi] in which the device ran an operation."""
    return sum(b - a for a, b in merged(trace.device, lo, hi)) * 1e-6


def gaps(trace: Trace, lo: float, hi: float) -> list:
    """The idle intervals of the device in [lo, hi]."""
    out, t = [], lo
    for a, b in merged(trace.device, lo, hi):
        if a > t:
            out.append((t, a))
        t = b
    if hi > t:
        out.append((t, hi))
    return out


def short(name: str) -> str:
    """A kernel's name without its return type, template and argument
    lists."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    cut = min((i for i in (name.find("<"), name.find("(")) if i > 0),
              default=len(name))
    return name[:cut].strip() or name


def top_device_ops(trace: Trace, lo: float, hi: float, n: int = 10) -> list:
    """The ``n`` device operations (by short name) that took most time."""
    tot = collections.Counter()
    for e in trace.device:
        a, b = max(e.ts, lo), min(e.end, hi)
        if b > a:
            tot[short(e.name)] += (b - a) * 1e-6
    return [[k, v] for k, v in tot.most_common(n)]


def _innermost(events, points) -> list:
    """For sorted ``points``, the innermost of the properly nested
    ``events`` (sorted by start, longest first) that contains each: a
    sweep with a stack of open intervals."""
    out, stack, j = [], [], 0
    for p in points:
        while j < len(events) and events[j].ts <= p:
            e = events[j]
            while stack and stack[-1].end < e.ts:
                stack.pop()
            stack.append(e)
            j += 1
        while stack and stack[-1].end < p:
            stack.pop()
        out.append(stack[-1] if stack else None)
    return out


def idle_gaps(trace: Trace, lo: float, hi: float, n: int = 10) -> list:
    """The device's idle time in [lo, hi] by what the host was doing
    meanwhile: each gap named by the innermost host operation or span
    around its midpoint (over all threads, the shortest), summed by name;
    the ``n`` largest."""
    gs = gaps(trace, lo, hi)
    mids = [(a + b) / 2 for a, b in gs]
    found = [_innermost(evs, mids) for evs in trace.host.values()]
    tot = collections.Counter()
    for k, (a, b) in enumerate(gs):
        cands = [f[k] for f in found if f[k] is not None]
        name = min(cands, key=lambda e: e.dur).name if cands else "host"
        tot[name] += (b - a) * 1e-6
    return [[k, v] for k, v in tot.most_common(n)]
