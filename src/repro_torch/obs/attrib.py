"""Deadline-miss attribution from span segments (a copy of the
reference's ``obs/attrib.py``; host code on Python ints).

A deadline miss is a *symptom*; the span's cycle segments say *why*.
Every completed span decomposes into integer queued / executing /
preempted cycles (:mod:`repro_torch.obs.spans` — the three sum to latency by
construction), so each miss classifies by its **dominant segment**:

``queued``
    The request mostly waited for an engine slot — admission capacity is
    short.  More shards (or a better router) is the fix.
``preempted``
    The request mostly sat admitted-but-not-running — other classes'
    quanta, its own class's backlog.  Shares/policy is the fix.
``service``
    The request's own execution dominates — the work itself is too slow
    for the deadline.  A cheaper plane schedule (tuned plan) is the fix.
``overdraft``
    A forced-progress overdraft clamped the completion stamp (negative
    residual; ``Span.overdrafted``) — the single-step cost exceeds the
    round budget, so no amount of fleet fixes it.

Ties resolve ``queued > preempted > service`` (deterministic: the
upstream cause wins), so the classification is a pure integer function
of the span — the online :class:`~repro_torch.obs.slo.SloMonitor` applies the
same function to its streaming segments and the two histograms are
gated *equal*, not approximately equal.
"""
from __future__ import annotations

#: Attribution classes, fixed order (histograms serialize in this order).
ATTRIB_CLASSES = ("queued", "preempted", "service", "overdraft")


def classify_segments(queued: int, executing: int, preempted: int) -> str:
    """Dominant-segment class from integer cycle segments (docstring
    order; ties resolve queued > preempted > service)."""
    if preempted < 0:
        return "overdraft"
    if queued >= preempted and queued >= executing:
        return "queued"
    if preempted >= executing:
        return "preempted"
    return "service"


def classify(span) -> str:
    """Classify one completed :class:`~repro_torch.obs.spans.Span`."""
    if not span.done or span.queued is None:
        raise ValueError(
            f"cannot classify an incomplete span (rid={span.rid}, "
            f"done={span.done})"
        )
    return classify_segments(span.queued, span.executing, span.preempted)


def _missed(span) -> bool:
    return (
        span.done
        and span.deadline is not None
        and span.finished > span.deadline
    )


def span_misses(spans) -> dict[str, int]:
    """Per-class deadline-miss counts from assembled spans — the offline
    truth the online :class:`~repro_torch.obs.slo.SloMonitor` counts are gated
    integer-exactly against."""
    out: dict[str, int] = {}
    for s in spans:
        if _missed(s):
            out[s.qos] = out.get(s.qos, 0) + 1
    return out


def attribute(spans) -> dict[str, dict[str, int]]:
    """Per-class attribution histogram over the spans that missed their
    deadline: ``{qos: {queued: n, preempted: n, service: n,
    overdraft: n}}`` (every class key present, zero-filled)."""
    out: dict[str, dict[str, int]] = {}
    for s in spans:
        if not _missed(s):
            continue
        hist = out.setdefault(s.qos, {c: 0 for c in ATTRIB_CLASSES})
        if s.queued is None:
            # a miss with no admit event cannot be decomposed — impossible
            # for gateway-emitted streams (completion implies admission)
            raise ValueError(
                f"missed span rid={s.rid} has no admission record"
            )
        hist[classify(s)] += 1
    return out


def attribution_shares(hist: dict[str, int]) -> dict[str, float]:
    """One class's histogram as fractional shares (all zeros when the
    class has no misses — a share of nothing is zero, not NaN)."""
    total = sum(hist.get(c, 0) for c in ATTRIB_CLASSES)
    if total <= 0:
        return {c: 0.0 for c in ATTRIB_CLASSES}
    return {c: hist.get(c, 0) / total for c in ATTRIB_CLASSES}
