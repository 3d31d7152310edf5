"""Precision-speculative decoding benchmark of the port: the twin of
``benchmarks/specdecode.py``, returning the dict that bench writes to
``BENCH_specdecode.json``.

One model, two precisions: the draft runs the same weights and KV cache
at a truncated plane budget, the verifier at the plan's full one
(:mod:`repro_torch.serve.specdecode`).  On the model it is given,
:func:`run`

1. extends a pinned full-digit LM plan with
   :func:`repro_torch.autotune.tune_spec` on the bench's trimmed grid
   (draft planes 2 and 4 x depth 2 and 4);
2. serves every prompt through a greedy ``Engine`` and a ``SpecEngine``,
   and raises unless the streams are token-identical, every round's
   ``useful + wasted`` cycles close to its total integer-exactly, and the
   modeled speedup is at least ``MIN_SPEEDUP``;
3. serves the prompts again through ``Gateway`` + ``SpecLMAdapter`` with a
   ``RecordingSink``, and raises unless exec attribution reconciles with
   the round clock (:func:`repro_torch.obs.spans.reconcile`), the draft,
   verify and accept events are present and the streams equal greedy.

Cycles and speedups are relation (2), the paper's FPGA model, not a card
number.  The model is the caller's, on :func:`bench_config`: the
reference's ``_build_model()`` weights (the smoke transformer deepened,
its tied embedding table a sharpened identity, so greedy repeats its input
token with a wide margin), carried over with
``transformer.params_from_jax``.  Everything runs on ``device``: the card
unless ``'cpu'``.
"""
from __future__ import annotations

import functools

N_LAYERS = 8  # deep enough that one pipeline interval << one full step
VOCAB = 128  # == d_model, so the tied identity table reads channels out
EMBED_SHARPEN = 64.0  # token-attractor gain on the tied embedding table
BATCH = 4
MAX_SEQ = 48
MAX_NEW = 24
N_PROMPTS = 6
PROMPT_LEN = 4
MIN_SPEEDUP = 1.5
ROUND_BUDGET = 100_000_000
# the bench's trimmed tune_spec grid: 2 draft budgets x 2 depths
PLANE_CANDIDATES = (2, 4)
K_CANDIDATES = (2, 4)


def bench_config():
    """The bench transformer's config: the minitron_4b smoke config
    deepened to ``N_LAYERS`` with tied embeddings over ``VOCAB`` tokens."""
    from repro_torch.configs import get_smoke_config

    return get_smoke_config("minitron_4b").replace(
        n_layers=N_LAYERS, tie_embeddings=True, vocab=VOCAB
    )


def _pinned_plan(cfg, params):
    """A pinned full-digit LM plan (certified by construction — zero
    truncation error at 8 planes) for ``tune_spec`` to extend, bound to the
    served weights by their fingerprint."""
    from repro_torch.autotune.calibrate import params_fingerprint
    from repro_torch.autotune.plan import TunedPlan

    return TunedPlan(
        workload="lm",
        geometry=dict(family=cfg.family, n_layers=cfg.n_layers,
                      d_model=cfg.d_model),
        planes=(8,) * cfg.n_layers,
        target_rel_err=0.05,
        certificate=dict(
            cert=0.0, note="pinned full-digit bench plan (exact by "
            "construction: no planes truncated)",
        ),
        fingerprint="bench-pinned-" + "0" * 51,
        params_fingerprint=params_fingerprint(params),
    )


def _prompts(vocab):
    import numpy as np

    rng = np.random.default_rng(7)
    return [
        rng.integers(0, vocab, size=PROMPT_LEN).astype(np.int32)
        for _ in range(N_PROMPTS)
    ]


def _drain(eng, prompts, step):
    """Serve ``prompts`` through ``eng`` (FIFO admission, ``step(eng,
    slots)`` per round); the requests in prompt order."""
    from repro_torch.serve.engine import Request

    pending = [Request(rid=i, prompt=p, max_new=MAX_NEW) for i, p in enumerate(prompts)]
    reqs = list(pending)
    while pending or eng.ready_slots():
        while pending and eng.admit(pending[0]):
            pending.pop(0)
        slots = eng.ready_slots()
        if not slots:
            break
        step(eng, slots)
    return reqs


def _run_greedy(qcfg, params, prompts, device):
    """Non-speculative reference: the token streams."""
    from repro_torch.serve.engine import Engine

    eng = Engine(qcfg, params, batch=BATCH, max_seq=MAX_SEQ, device=device)
    reqs = _drain(eng, prompts, lambda e, _: e.step())
    return [list(r.out) for r in reqs]


def _run_spec(qcfg, params, prompts, *, draft_schedule, k, full_step, spec_price, device):
    """Speculative run: token streams + the full cycle ledger (draft,
    verify, useful, wasted — every round priced before acceptance is
    known, exactly as the serving adapter charges it)."""
    from repro_torch.serve.specdecode import SpecEngine

    eng = SpecEngine(qcfg, params, batch=BATCH, max_seq=MAX_SEQ,
                     draft_schedule=draft_schedule, k=k, device=device)
    ledger = dict(cycles=0, useful=0, wasted=0, emitted=0, accepted=0,
                  drafted=0, rounds=0, greedy_rounds=0)

    def step(eng, slots):
        _, rec = eng.spec_step()
        if rec is None:  # no speculation headroom: plain greedy round
            ledger["cycles"] += full_step * len(slots)
            ledger["useful"] += full_step * len(slots)
            ledger["emitted"] += len(slots)
            ledger["greedy_rounds"] += 1
            return
        ledger["rounds"] += 1
        for s in rec["slots"]:
            acct = spec_price(k=rec["k"], accepted=s["accepted"])
            if acct["useful_cycles"] + acct["wasted_cycles"] != acct["total_cycles"]:
                raise RuntimeError(
                    f"spec cycle account does not close: useful "
                    f"{acct['useful_cycles']} + wasted "
                    f"{acct['wasted_cycles']} != total "
                    f"{acct['total_cycles']}"
                )
            ledger["cycles"] += acct["total_cycles"]
            ledger["useful"] += acct["useful_cycles"]
            ledger["wasted"] += acct["wasted_cycles"]
        ledger["emitted"] += rec["emitted"]
        ledger["accepted"] += rec["accepted"]
        ledger["drafted"] += rec["drafted"]

    reqs = _drain(eng, prompts, step)
    return [list(r.out) for r in reqs], ledger


def _serve_through_gateway(qcfg, params, plan, prompts, device):
    """The tuned operating point behind the gateway, with the telemetry
    reconcile gate live."""
    from repro_torch.obs import RecordingSink, assemble, breakdown, reconcile
    from repro_torch.serve import Gateway, SpecLMAdapter

    sink = RecordingSink()
    gw = Gateway(
        [SpecLMAdapter(qcfg, params, batch=BATCH, max_seq=MAX_SEQ,
                       plan=plan, device=device)],
        policy="fair",
        round_budget=ROUND_BUDGET,
        sink=sink,
    )
    for p in prompts:
        gw.submit("lm", p, max_new=MAX_NEW)
    gw.drain()
    rec = reconcile(sink.events, [gw.round_clock])
    if not rec["holds"]:
        raise RuntimeError(
            f"span execution attribution does not reconcile with the "
            f"round clock: {rec['total_exec']} exec-event cycles vs "
            f"{rec['total_worked']} worked cycles"
        )
    etypes: dict[str, int] = {}
    for ev in sink.events:
        etypes[ev.etype] = etypes.get(ev.etype, 0) + 1
    for required in ("draft", "verify", "accept"):
        if not etypes.get(required):
            raise RuntimeError(
                f"speculative lifecycle event {required!r} missing from "
                f"the gateway telemetry stream (saw {sorted(etypes)})"
            )
    streams = [list(g.handle.out) for g in gw.requests]
    return dict(
        rounds=gw.rounds,
        clock_cycles=gw.clock,
        total_ops=sum(a.total_ops for a in gw.adapters.values()),
        events=len(sink.events),
        spec_events={e: etypes.get(e, 0)
                     for e in ("draft", "verify", "accept", "rollback")},
        spans=breakdown(assemble(sink.events)),
        reconcile=rec,
    ), streams


def run(cfg, params, *, device=None) -> dict:
    """The bench on ``(cfg, params)``: the dict ``benchmarks/specdecode.py``
    writes to ``BENCH_specdecode.json``.  Raises where that bench raises."""
    from repro_torch.autotune.api import apply_plan_lm, tune_spec
    from repro_torch.core import cycle_model as cm
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    base_plan = _pinned_plan(cfg, params)
    prompts = _prompts(cfg.vocab)

    # --- tune: the real search, on a trimmed grid ------------------------
    plan = tune_spec(
        params, cfg, prompts[:2], plan=base_plan,
        batch=BATCH, max_seq=MAX_SEQ, max_new=8,
        k_candidates=K_CANDIDATES, plane_candidates=PLANE_CANDIDATES,
        device=dev,
    )
    draft_schedule = plan.spec_planes
    k = plan.spec_k

    qcfg = apply_plan_lm(cfg, plan)
    kw = dict(
        n_heads=cfg.n_heads, head_dim=cfg.hd, n_kv_heads=cfg.n_kv_heads,
        context=MAX_SEQ, n_experts=cfg.moe.n_experts, top_k=cfg.moe.top_k,
    )
    full_step = cm.lm_step_cycles(
        cfg.d_model, cfg.d_ff, cfg.n_layers, tuple(plan.planes), **kw
    )
    spec_price = functools.partial(
        cm.lm_spec_step_cycles, cfg.d_model, cfg.d_ff, cfg.n_layers,
        draft_schedule=draft_schedule, schedule=tuple(plan.planes), **kw
    )

    # --- headline: speculative vs greedy, engine level -------------------
    greedy_streams = _run_greedy(qcfg, params, prompts, dev)
    spec_streams, ledger = _run_spec(
        qcfg, params, prompts, draft_schedule=draft_schedule, k=k,
        full_step=full_step, spec_price=spec_price, device=dev,
    )

    # Gate 1: bit-identical emitted streams.
    if spec_streams != greedy_streams:
        bad = [i for i, (a, b) in
               enumerate(zip(spec_streams, greedy_streams)) if a != b]
        raise RuntimeError(
            f"speculative decode diverged from greedy on prompt(s) {bad}: "
            f"acceptance must be an exact-prefix property, never a "
            f"numerics coin flip"
        )

    # Gate 2: modeled decode throughput.
    baseline_cycles = ledger["emitted"] * full_step
    speedup = baseline_cycles / ledger["cycles"]
    if speedup < MIN_SPEEDUP:
        raise RuntimeError(
            f"speculative decode speedup {speedup:.3f}x under the "
            f"{MIN_SPEEDUP}x gate (draft@{list(draft_schedule)} k={k}, "
            f"acceptance {ledger['accepted']}/{ledger['drafted']})"
        )
    accept_rate = (ledger["accepted"] / ledger["drafted"]
                   if ledger["drafted"] else 0.0)

    # --- serving integration: gateway + telemetry gates ------------------
    served, served_streams = _serve_through_gateway(qcfg, params, plan, prompts, dev)
    if served_streams != greedy_streams:
        raise RuntimeError(
            "gateway-served speculative streams diverged from greedy — "
            "adapter chunking must not change what is computed"
        )

    return dict(
        bench="specdecode",
        model=dict(
            name=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
            vocab=cfg.vocab, tie_embeddings=cfg.tie_embeddings,
            embed_sharpen=EMBED_SHARPEN,
        ),
        geometry=dict(batch=BATCH, max_seq=MAX_SEQ, max_new=MAX_NEW,
                      n_prompts=N_PROMPTS, prompt_len=PROMPT_LEN),
        plan=dict(
            planes=list(plan.planes),
            spec_planes=list(plan.spec_planes),
            spec_k=plan.spec_k,
            version=plan.version,
            tune_grid=plan.modeled["spec"]["grid"],
        ),
        ledger=ledger,
        gateway=dict(
            rounds=served["rounds"],
            clock_cycles=served["clock_cycles"],
            total_ops=served["total_ops"],
            events=served["events"],
            spec_events=served["spec_events"],
        ),
        spans=dict(
            per_class=served["spans"],
            reconcile=served["reconcile"],
            events=served["events"],
        ),
        gate=dict(
            min_speedup=MIN_SPEEDUP,
            speedup=speedup,
            accept_rate=accept_rate,
            baseline_cycles=int(baseline_cycles),
            spec_cycles=int(ledger["cycles"]),
            wasted_cycles=int(ledger["wasted"]),
            token_identical=True,  # gated above (raise on mismatch)
            gateway_token_identical=True,
            cycle_account_closes=True,
            holds=bool(speedup >= MIN_SPEEDUP),
        ),
    )
