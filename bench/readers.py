"""Helpers of the metric readers in ``bench/metrics/``: the record a run
hands each reader, and sums over it.

A record holds ``device``, ``P``, ``setup_s``, ``window_s`` (the window of
an untraced run), ``served`` (queries answered in the window),
``peak_mem_bytes``, ``steps`` and ``profile``.  Each step holds ``served``,
``traced`` (True where the program's tracer put a device barrier after
each stage), ``profiled`` (True where it ran under the profiler, its
stages stamped), ``spans`` (the benchmark's own span seconds by name:
``plan``, ``execute``, ``answer``) and ``reports`` (each with
``bytes_shuffled`` and its jobs' ``stats`` and ``phases``, the latter as
``(name, seconds, args)``).  ``profile`` is the ``torch.profiler``
window's reduction (``bench/trace.py``: busy time, operations, idle gaps,
device seconds by the program's stage) with the queries it served, or
None off the card.
"""
from __future__ import annotations

import json
from pathlib import Path


def traced_steps(record: dict) -> list:
    return [s for s in record["steps"] if s["traced"]]


def jobs(step: dict):
    for rep in step["reports"]:
        yield from rep["jobs"]


def phase_s(step: dict, prefix: str = "") -> float:
    """Seconds of the step's phase spans whose name starts with ``prefix``."""
    return sum(d for job in jobs(step) for name, d, _ in job["phases"] if name.startswith(prefix))


def has_phase(record: dict, prefix: str) -> bool:
    return any(name.startswith(prefix) for s in traced_steps(record) for job in jobs(s)
               for name, _, _ in job["phases"])


def span_self_per_query(record: dict, span: str) -> float | None:
    """The benchmark's span ``span`` less the phase spans inside it, per
    query served, over the traced steps."""
    steps = [s for s in traced_steps(record) if span in s["spans"]]
    served = sum(s["served"] for s in steps)
    if not served:
        return None
    return sum(s["spans"][span] - phase_s(s) for s in steps) / served


def phases_per_query(record: dict, prefix: str) -> float | None:
    steps = traced_steps(record)
    served = sum(s["served"] for s in steps)
    if not served or not has_phase(record, prefix):
        return None
    return sum(phase_s(s, prefix) for s in steps) / served


def peak(record: dict, key: str) -> float | None:
    """The card's published peak ``key`` (``bench/peaks.json``), or None
    for a device the table does not hold."""
    table = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())
    return table.get(record["device"]["kind"], {}).get(key)


def window_per_query(record: dict) -> float | None:
    """Seconds of an untraced window per query answered in it."""
    return record["window_s"] / record["served"] if record["served"] else None


def shuffled_gb_per_query(record: dict) -> float | None:
    served = sum(s["served"] for s in record["steps"])
    total = sum(r["bytes_shuffled"] for s in record["steps"] for r in s["reports"])
    return total / served / 1e9 if served else None


def device_ops_per_query(record: dict) -> float | None:
    prof = record["profile"]
    if not prof or not prof["served"] or not prof["device_ops"]:
        return None
    return prof["device_ops"] / prof["served"]


def idle_percent(record: dict) -> float | None:
    prof = record["profile"]
    if not prof or not prof["busy_s"]:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])


def probe_roofline_percent(record: dict) -> float | None:
    """The ``msj.probe`` stage's least time over its device time, in %.
    The least time reads the valid received rows of both sides once
    (``recv_fwd`` messages of the width the forward exchange sent:
    ``bytes_fwd`` less the count exchange's ``P * P * 4`` bytes, over
    ``sent_fwd``) and writes the route-back rows once (``bytes_bwd``), at
    the card's HBM bandwidth, from the profiled steps' job counters; the
    device time is that of the operations launched inside the stage's
    spans in the same steps (``bench/trace.py``)."""
    bandwidth = peak(record, "hbm_bytes_per_s")
    took = ((record["profile"] or {}).get("stage_s") or {}).get("msj.probe")
    if not bandwidth or not took:
        return None
    count_bytes = record["P"] * record["P"] * 4
    need = 0.0
    for step in record["steps"]:
        if not step.get("profiled"):
            continue
        for job in jobs(step):
            names = [name for name, _, _ in job["phases"]]
            st = job["stats"]
            if "msj.probe" not in names or not st.get("sent_fwd"):
                continue
            sent = st["bytes_fwd"] - (count_bytes if "msj.count" in names else 0)
            need += st["recv_fwd"] * sent / st["sent_fwd"] + st["bytes_bwd"]
    return 100.0 * need / bandwidth / took if need else None
