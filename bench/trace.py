"""Reduction of a ``torch.profiler`` device trace of part of the window to
the device's busy time, its operations and its idle gaps, each gap named
by what the host was doing in it.

The profiler records the device's activity alone (kernels, copies, fills,
and the CUDA runtime calls that launched them), not every host operator:
recording each of the tens of thousands of host operators a query makes
would slow the host several times over and inflate the very idle time
this measures.  The host side comes from the benchmark's own spans, timed
by ``time.time_ns``, the clock kineto stamps its events with.  The raw
kineto events are read (``prof.profiler.kineto_results``), not the
profiler's ``FunctionEvent`` tree, which takes minutes to build for a
window of a million events.

A stage of the program (``msj.probe``, ...) gets the device time of the
operations launched inside its span: each device event carries the
correlation id of the CUDA runtime call that launched it, and that call
lies inside the span on the host.  The stages run with no barrier between
them, so a stage's operations may run after its span has closed; they
are its own all the same.
"""
from __future__ import annotations

from bisect import bisect_left, bisect_right
from collections import defaultdict

TOP = 10


def _events(prof):
    """Host and device events as ``(start_ns, end_ns, name, correlation)``."""
    from torch.autograd import DeviceType

    host, dev = [], []
    for e in prof.profiler.kineto_results.events():
        start, dur = e.start_ns(), e.duration_ns()
        ev = (start, start + dur, e.name(), e.correlation_id())
        (dev if e.device_type() == DeviceType.CUDA else host).append(ev)
    return host, dev


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def _innermost(points, intervals):
    """For each time in ``points`` (ascending), the name of the latest-
    starting interval open there, or None."""
    events = sorted(intervals)
    out, stack, i = [], [], 0
    for m in points:
        while i < len(events) and events[i][0] <= m:
            stack.append(events[i])
            i += 1
        live = [e for e in stack if e[1] >= m]
        stack = live
        out.append(live[-1][2] if live else None)
    return out


def stage_device(host, dev, stages) -> tuple[dict, dict, dict]:
    """Seconds, count and the longest three by name of the device
    operations that each stage name of ``stages`` (``(start_ns, end_ns,
    name)`` spans) launched: those whose
    runtime call starts inside one of its spans (the innermost, where
    spans nest)."""
    if not stages:
        return {}, {}, {}
    calls = sorted((a, corr) for a, _, _, corr in host if corr)
    starts = [a for a, _ in calls]
    owner = {}
    for s0, s1, name in sorted(stages, key=lambda st: st[0] - st[1]):
        for k in range(bisect_left(starts, s0), bisect_right(starts, s1)):
            owner[calls[k][1]] = name
    seconds, ops, by_op = defaultdict(int), defaultdict(int), defaultdict(int)
    for a, b, op, corr in dev:
        name = owner.get(corr)
        if name is not None:
            seconds[name] += b - a
            ops[name] += 1
            by_op[name, op] += b - a
    top = {name: _top({op: t for (n, op), t in by_op.items() if n == name})[:3]
           for name in seconds}
    return {k: v / 1e9 for k, v in seconds.items()}, dict(ops), top


def _top(d: dict) -> list:
    return [[k[:160], v / 1e9] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]


def reduce_profile(prof, window_ns: tuple, spans: list, stages: list = ()) -> dict:
    """``{"window_s", "busy_s", "device_ops", "device_op_s", "idle_gaps",
    "misaligned", "stage_s", "stage_ops", "stage_top"}`` of the window ``window_ns``
    (``time.time_ns`` at its two ends, the device idle at both); ``spans``
    are the benchmark's host spans and ``stages`` the program's, each
    ``(start_ns, end_ns, name)``.  ``misaligned`` counts device events
    outside the window, which should be none; ``stage_s`` and
    ``stage_ops`` and ``stage_top`` are :func:`stage_device` by stage name."""
    host, dev = _events(prof)
    w0, w1 = window_ns
    stage_s, stage_ops, stage_top = stage_device(host, dev, stages)
    host = [(a, b, n) for a, b, n, _ in host]
    inside = [(max(a, w0), min(b, w1), n) for a, b, n, _ in dev if b > w0 and a < w1]
    by_name = defaultdict(int)
    for a, b, n in inside:
        by_name[n] += b - a
    busy = _merge([(a, b) for a, b, _ in inside])
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2) if edges[k + 1] > edges[k]]
    mids = [(a + b) // 2 for a, b in gaps]
    idle = defaultdict(int)
    for (a, b), span, call in zip(gaps, _innermost(mids, spans), _innermost(mids, host)):
        idle[f"{span or 'between steps'} / {call or 'host code'}"] += b - a
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": sum(b - a for a, b in busy) / 1e9,
        "device_ops": len(inside),
        "device_op_s": _top(by_name),
        "idle_gaps": _top(idle),
        "misaligned": len(dev) - len(inside),
        "stage_s": stage_s,
        "stage_ops": stage_ops,
        "stage_top": stage_top,
    }
