"""What the per-layer readers take from the program's own wall-clock
recorder (``repro_torch.obs.timeline``), which records while the profiler
does.  A program without the recorder, or a recording without the span or
counter, reads as None: the metric is left out of the line."""


def recording():
    """The program's most recent recording, or None."""
    try:
        from repro_torch.obs import timeline
    except ImportError:
        return None
    return timeline.last()


def mean_ms(span: str) -> float | None:
    """The mean length in ms of the recording's spans named ``span``."""
    rec = recording()
    ms = rec.ms(span) if rec is not None else []
    return sum(ms) / len(ms) if ms else None


def ms_per_step(span: str, step: str) -> float | None:
    """The summed length in ms of the spans ``span`` over the number of
    spans ``step``."""
    rec = recording()
    if rec is None:
        return None
    steps, ms = rec.named(step), rec.ms(span)
    return sum(ms) / len(steps) if steps and ms else None


def ratio(count: str, per: str) -> float | None:
    """The counter ``count`` over the counter ``per``."""
    rec = recording()
    if rec is None or not rec.counts.get(per):
        return None
    return rec.counts.get(count, 0) / rec.counts[per]
