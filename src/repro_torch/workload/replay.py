"""Open-loop trace replay against the serving gateway.

The harness walks a :class:`~repro_torch.workload.trace.Trace` on the gateway's
modeled cycle clock: each round, the arrivals stamped inside that round's
cycle span are handed to :meth:`Gateway.step_round`, which injects them
*mid-round* at their exact offsets (execution runs to the stamp, the
request is submitted with ``arrival_cycle`` set, a mid-round admission
pass runs, execution resumes).  Arrivals never wait for completions —
the load is open-loop, so queueing delay shows up as latency instead of
silently throttling the generator.

Payloads are materialized from each request's compact spec and the trace
seed (deterministic per request index), so replaying the same trace twice
— or on different machines — submits bit-identical prompts and images.

The same harness drives a :class:`~repro_torch.serve.fabric.Fabric`: the
fabric exposes the gateway surface (``clock``/``round_budget``/``step_round``/
``pending``/``stats``), its ``step_round`` routes each injected arrival
to a shard, and the shard then sees the identical open-loop contract a
single gateway does — arrivals at exact mid-round offsets, never waiting
on completions.  Scheduling currency is the lock-step fleet clock, so
one trace replays against one chip or N without edits.

``replay`` returns a summary in the shared bench-tracker schema: one row
per QoS class (modeled p50/p99 latency) plus the aggregate GOPS/W row,
and the raw per-class stats dict for programmatic gates.
"""
from __future__ import annotations

from repro_torch.core import cycle_model as cm

from .trace import Trace, TraceRequest


# ----------------------------------------------------------- materializers
#
# A materializer turns a TraceRequest's payload *spec* into the engine-
# native payload plus submit() keyword arguments.  Determinism contract:
# the result is a pure function of (trace seed, request index, spec).


def _rng(trace_seed: int, index: int):
    import numpy as np

    return np.random.default_rng((int(trace_seed), int(index)))


def lm_materializer(vocab: int):
    """Prompts of ``prompt_len`` uniform tokens from a ``vocab``."""

    def mat(treq: TraceRequest, trace_seed: int, index: int):
        spec = treq.payload
        prompt = _rng(trace_seed, index).integers(
            0, vocab, size=int(spec["prompt_len"])
        )
        return prompt, dict(max_new=int(spec["max_new"]))

    return mat


def seg_materializer(in_ch: int):
    """Synthetic phantom images at the spec's (h, w) geometry."""

    def mat(treq: TraceRequest, trace_seed: int, index: int):
        from repro_torch.segserve.synth import phantom_image

        spec = treq.payload
        # phantom_image seeds its own rng; fold the request index in so
        # every image differs but replays identically
        return phantom_image(
            int(spec["h"]), int(spec["w"]), in_ch,
            seed=int(trace_seed) * 100_003 + index,
        ), {}

    return mat


# ----------------------------------------------------------------- replay


def replay(
    gateway,
    trace: Trace,
    materializers: dict,
    *,
    max_rounds: int = 100_000,
    capture=None,
) -> dict:
    """Drive ``gateway`` through ``trace`` open-loop; returns the summary.

    ``gateway`` is a single :class:`~repro_torch.serve.gateway.Gateway` or a
    :class:`~repro_torch.serve.fabric.Fabric` (routing happens inside the
    fabric's ``step_round``, at arrival injection).  ``materializers``
    maps adapter kind to a materializer (see :func:`lm_materializer` /
    :func:`seg_materializer`; modeled adapters use
    :func:`repro_torch.serve.modeled.modeled_materializer`).  Every QoS class
    the trace carries must be declared in the gateway's ``shares``.

    ``capture`` (a :class:`repro_torch.obs.capture.CaptureSink`) records the
    replayed arrivals back into trace schema v1 as they happen — the
    capture→replay round-trip.  It is armed *in addition to* any sink the
    gateway already carries (teed), and the combined sink is left armed.
    """
    if capture is not None:
        from repro_torch.obs.events import NULL_SINK, TeeSink

        prior = getattr(gateway, "sink", NULL_SINK)
        gateway.set_sink(
            capture if prior is NULL_SINK else TeeSink([prior, capture])
        )
    missing = set(trace.kinds) - set(gateway.adapters)
    if missing:
        raise ValueError(
            f"trace {trace.name!r} needs adapters for kinds "
            f"{sorted(missing)}"
        )
    undeclared = set(trace.qos_classes) - set(gateway.shares)
    if undeclared:
        raise ValueError(
            f"trace {trace.name!r} carries QoS classes {sorted(undeclared)} "
            f"not declared in gateway shares {sorted(gateway.shares)}"
        )
    feed = []
    for idx, treq in enumerate(trace.requests):
        payload, prep_kw = materializers[treq.kind](treq, trace.seed, idx)
        kw = dict(qos=treq.qos, **prep_kw)
        if treq.deadline_cycles is not None:
            kw["deadline_cycles"] = treq.deadline_cycles
        feed.append((treq.arrival_cycle, treq.kind, payload, kw))

    i = 0
    while i < len(feed) or gateway.pending():
        if gateway.rounds >= max_rounds:
            raise RuntimeError(
                f"replay of {trace.name!r} did not drain within "
                f"{max_rounds} rounds"
            )
        window_end = gateway.clock + gateway.round_budget
        due = []
        while i < len(feed) and feed[i][0] < window_end:
            due.append(feed[i])
            i += 1
        gateway.step_round(arrivals=due)
    return summarize(gateway, trace)


def replay_stream(gateway, feed, *, label: str = "stream",
                  max_rounds: int = 1_000_000) -> dict:
    """Open-loop replay from a *lazy* arrival feed — the streaming twin
    of :func:`replay` for workloads too large to materialize.

    ``feed`` is a sorted iterable of ``(cycle, kind, payload, kw)``
    tuples, e.g. :func:`repro_torch.workload.diurnal.stream_requests` over
    generator arrivals: only one round's window of arrivals is ever held
    in memory, so a million-request day streams through in O(in-flight)
    space.  Payloads must already be engine-native (modeled adapters
    take spec dicts directly — the capacity planner's path).

    Returns the :func:`summarize` schema with a ``stream`` block
    (``label`` + fed count) in place of ``trace``.
    """
    it = iter(feed)
    nxt = next(it, None)
    fed = 0
    while nxt is not None or gateway.pending():
        if gateway.rounds >= max_rounds:
            raise RuntimeError(
                f"stream replay {label!r} did not drain within "
                f"{max_rounds} rounds"
            )
        window_end = gateway.clock + gateway.round_budget
        due = []
        while nxt is not None and nxt[0] < window_end:
            due.append(nxt)
            fed += 1
            nxt = next(it, None)
        gateway.step_round(arrivals=due)
    out = _summary(gateway, f"stream/{label}")
    out["stream"] = dict(label=label, n_requests=fed)
    return out


def _summary(gateway, row_prefix: str) -> dict:
    """The shared summary core (:func:`summarize` adds the trace block,
    :func:`replay_stream` the stream block).  Percentiles inherit the
    stack-wide exact-order-statistic semantics
    (:func:`repro_torch.serve.clock.exact_percentile`) from ``gateway.stats()``;
    the ``overall`` aggregate applies the same helper across every
    completed request regardless of class."""
    from repro_torch.serve.clock import exact_percentile

    st = gateway.stats()
    all_lats = [g.latency_ms for g in gateway.requests if g.done]
    overall_p50 = exact_percentile(all_lats, 50)
    overall_p99 = exact_percentile(all_lats, 99)
    rows = []
    for qos, pc in st["per_class"].items():
        if pc["n"] == 0 or not pc["completed"]:
            continue
        rows.append(
            (
                f"{row_prefix}/{gateway.policy}/{qos}",
                (pc["p99_ms"] or 0.0) * 1e3,  # modeled us, like segserve
                f"n={pc['n']};completed={pc['completed']};"
                f"p50_ms={pc['p50_ms']:.3f};p99_ms={pc['p99_ms']:.3f};"
                f"misses={pc['deadline_misses']}",
            )
        )
    out = dict(
        policy=gateway.policy,
        rounds=st["rounds"],
        clock_cycles=st["clock_cycles"],
        time_ms=st["clock_cycles"] / cm.FREQ_HZ * 1e3,
        total_ops=st["total_ops"],
        gops=st["gops"],
        gops_w=st["gops_w"],
        per_class=st["per_class"],
        overall=dict(
            completed=len(all_lats),
            p50_ms=None if overall_p50 is None else float(overall_p50),
            p99_ms=None if overall_p99 is None else float(overall_p99),
        ),
        # fleet/gateway total, reconciled with the per-class counters
        # gateway.stats() derives and the SloMonitor's online counts
        deadline_misses=sum(
            pc.get("deadline_misses", 0)
            for pc in st["per_class"].values()
        ),
        forced=st["forced"],
        rows=rows,
    )
    if "slo" in st:
        out["slo"] = st["slo"]
    if "energy" in st:
        out["energy"] = st["energy"]
    return out


def summarize(gateway, trace: Trace) -> dict:
    """The replay summary in the shared bench-tracker schema."""
    out = _summary(gateway, f"replay/{trace.name}")
    out["trace"] = dict(
        name=trace.name,
        version=trace.version,
        seed=trace.seed,
        n_requests=len(trace),
        span_cycles=trace.span_cycles,
        qos_classes=trace.qos_classes,
    )
    return out
