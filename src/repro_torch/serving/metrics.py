"""Latency/throughput summaries of the serving layers.

Port of ``repro.serving.metrics``: the rescoring service reports
per-request wall-clock latency as p50/p99 over completed requests, with
the same percentile convention as the reference package.
"""
from __future__ import annotations


def percentile(values, q: float) -> float:
    """Linear-interpolation percentile (q in [0, 100]) of a sequence.
    Returns ``nan`` for an empty sequence — a serving run that completed
    nothing has no latency, and silently reporting 0.0 would read as an
    impossibly good tail."""
    vals = sorted(float(v) for v in values)
    if not vals:
        return float("nan")
    if len(vals) == 1:
        return vals[0]
    pos = (len(vals) - 1) * (q / 100.0)
    lo = int(pos)
    hi = min(lo + 1, len(vals) - 1)
    return vals[lo] + (vals[hi] - vals[lo]) * (pos - lo)


def latency_summary(latencies_s) -> dict:
    """The metric keys every serving loop reports: p50/p99 seconds."""
    return {
        "latency_p50_s": percentile(latencies_s, 50.0),
        "latency_p99_s": percentile(latencies_s, 99.0),
    }
