"""The port's certified tuning (``repro_torch.autotune``) and plan serving
(``SegEngine(plan=...)``) against the JAX package, on the CPU.

Same weights (built by the reference, carried over with
``unet.params_from_jax``), same numpy images, ``tests/test_autotune.py``'s
small fixtures.  The port runs both ``impl="horner"`` and
``impl="kernel"`` (the kernel's plain version runs here); the reference
runs ``impl="xla"``.

Tolerances:
  * exact — anything counted or pure Python: weights fingerprints, octave
    histograms, class thresholds and counts, plane schedules, tiles,
    halos, repairs, measure calls, cycles, pJ, and every int8 activation
    and int32 conv output of a served tile;
  * ``REL_TOL`` = 1e-5 relative — float statistics read off the logits or
    the activations: the reference computes them under ``jax.jit``, where
    XLA may reassociate ``acc * (x_scale * w_scale)`` and sum the float
    head in another order, so they differ from the port's in the last
    float32 bits (measured: at most 2e-6 relative on these fixtures);
  * ``LOGIT_ATOL`` = 1e-5 absolute — served logits, as in
    ``tests/test_torch_segserve.py``.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

import repro.kernels.ops as jops
from repro import autotune as jat
from repro.checkpoint import load_json as jload_json
from repro.checkpoint import save_json_atomic as jsave_json
from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke_config
from repro.models import unet as junet
from repro_torch import autotune as tat
from repro_torch.autotune import search
from repro_torch.checkpoint import load_json, save_json_atomic
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels import ops
from repro_torch.models import unet
from repro_torch.segserve import SegEngine
from repro_torch.segserve.synth import phantom_image

REL_TOL = 1e-5
LOGIT_ATOL = 1e-5
IMPLS = ["horner", "kernel"]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    torch.set_num_threads(2)


@functools.lru_cache(maxsize=None)
def _jnet(depth=1, base=4, in_ch=3, n_classes=3, cps=1):
    """The reference net of ``tests/test_autotune.py`` (``_qnet``)."""
    cfg = junet.UNetConfig(
        hw=16, in_ch=in_ch, base=base, depth=depth, convs_per_stage=cps,
        n_classes=n_classes, quant_mode="mma_int8", impl="xla",
    )
    return cfg, junet.init_params(jax.random.PRNGKey(0), cfg)


def _tnet(impl, **kw):
    """The port's twin of :func:`_jnet`: same geometry and weights."""
    jcfg, jparams = _jnet(**kw)
    cfg = unet.UNetConfig(
        hw=jcfg.hw, in_ch=jcfg.in_ch, base=jcfg.base, depth=jcfg.depth,
        convs_per_stage=jcfg.convs_per_stage, n_classes=jcfg.n_classes,
        quant_mode="mma_int8", impl=impl,
    )
    return cfg, unet.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


def _calib_image(seed=0, h=48, w=40, c=3):
    rng = np.random.default_rng(seed)
    img = rng.normal(0.0, 0.01, (h, w, c))
    img[4:16, 4:16] += rng.normal(0.0, 1.0, (12, 12, c))
    return img.astype(np.float32)


CALIB_IMAGES = [_calib_image(0), _calib_image(1)]


@functools.lru_cache(maxsize=None)
def _jcalibration():
    cfg, params = _jnet()
    return jat.calibrate_unet(params, cfg, CALIB_IMAGES)


@functools.lru_cache(maxsize=None)
def _jtuned(target_milli):
    cfg, params = _jnet()
    return jat.tune_unet(params, cfg, [_calib_image()], target_rel_err=target_milli / 1000)


def _close(a, b, what):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, what
    np.testing.assert_allclose(a, b, rtol=REL_TOL, atol=0, err_msg=what)


# ------------------------------------------------------------ fingerprints


def test_params_fingerprint_equals_reference():
    """Same digest over the same weights: the leaves walked in
    ``jax.tree.leaves`` order (sorted dict keys, lists in order), each
    hashed as a numpy view of the same dtype and shape."""
    _, jparams = _jnet()
    _, tparams = _tnet("horner")
    assert tat.params_fingerprint(tparams) == jat.calibrate.params_fingerprint(jparams)
    # two convs per stage: nested lists of more than one conv, as numpy
    deep = unet.init_params(3, unet.UNetConfig(in_ch=2, base=3, depth=2, convs_per_stage=2),
                            device="cpu")
    as_numpy = jax.tree.map(lambda t: t.numpy(), deep)
    assert tat.params_fingerprint(deep) == jat.calibrate.params_fingerprint(as_numpy)
    # any change of the weights changes it
    tparams["head"]["b"] = tparams["head"]["b"] + 1e-3
    assert tat.params_fingerprint(tparams) != jat.calibrate.params_fingerprint(jparams)


def test_calibration_deterministic():
    cfg, params = _tnet("kernel")
    a = tat.calibrate_unet(params, cfg, CALIB_IMAGES, device="cpu")
    assert a == tat.calibrate_unet(params, cfg, CALIB_IMAGES, device="cpu")
    c = tat.calibrate_unet(params, cfg, [_calib_image(2)], device="cpu")
    assert c.fingerprint != a.fingerprint
    for row in a.sensitivity:
        assert row[-1] == 0.0  # 8 planes == reference
    assert sum(a.class_counts) == sum(a.octave_hist)
    with pytest.raises(ValueError, match="mma_int8"):
        tat.calibrate_unet(params, dataclasses.replace(cfg, quant_mode="none"),
                           CALIB_IMAGES, device="cpu")
    with pytest.raises(ValueError, match="at least one image"):
        tat.calibrate_unet(params, cfg, [], device="cpu")


# ------------------------------------------------------------- calibration


@pytest.mark.parametrize("impl", IMPLS)
def test_calibration_equals_reference(impl):
    cfg, params = _tnet(impl)
    want = _jcalibration()
    got = tat.calibrate_unet(params, cfg, CALIB_IMAGES, device="cpu")
    for field in ("n_images", "tile", "max_class", "class_thresholds", "octave_hist",
                  "class_counts"):
        assert getattr(got, field) == getattr(want, field), field
    for field in ("layer_amax", "layer_gain", "sensitivity", "class_ratios"):
        _close(getattr(got, field), getattr(want, field), field)


def test_validator_and_sound_bound_equal_reference():
    jcfg, jparams = _jnet()
    cfg, params = _tnet("kernel")
    plan = _jtuned(100)
    for planes in ([8, 8, 8], [5, 8, 3], [1, 2, 1]):
        _close(tat.calibrate.measured_rel_err(params, cfg, CALIB_IMAGES, planes, device="cpu"),
               jat.calibrate.measured_rel_err(jparams, jcfg, CALIB_IMAGES, planes), planes)
    with pytest.raises(ValueError, match="schedule shape"):
        tat.calibrate.measured_rel_err(params, cfg, CALIB_IMAGES, [8, 8], device="cpu")
    tplan = tat.TunedPlan.from_json(plan.to_json())
    for image in CALIB_IMAGES:
        _close(tat.tiled_sound_bound(params, cfg, image, tplan, device="cpu"),
               jat.tiled_sound_bound(jparams, jcfg, image, plan), "sound bound")


# ------------------------------------------------------------------ search


def test_search_equals_reference():
    """The search is pure Python over the cycle model: on the reference's
    calibration it makes the same choices."""
    jcfg, _ = _jnet()
    cfg, _ = _tnet("kernel")
    jcal = _jcalibration()
    cal = tat.Calibration(**dataclasses.asdict(jcal))
    for target in (0.2, 0.1, 0.05):
        assert search.greedy_schedule(cal, cfg.conv_layers(), target) == \
            jat.search.greedy_schedule(jcal, jcfg.conv_layers(), target)
        assert search.predicted_err(cal, (4, 5, 6)) == jat.search.predicted_err(jcal, (4, 5, 6))
    assert search.repair_sequence([2, 3, 1], cal.sensitivity, 100) == \
        jat.search.repair_sequence([2, 3, 1], jcal.sensitivity, 100)
    steps = [1.0, 0.9, 0.5, 0.2, 0.04, 0.01]
    assert search.bisect_repair(lambda t: steps[t], 5, 0.05) == \
        jat.search.bisect_repair(lambda t: steps[t], 5, 0.05)
    images = CALIB_IMAGES + [phantom_image(37, 61, 3)]
    assert search.tile_candidates(cfg, images) == jat.search.tile_candidates(jcfg, images)
    jplan = _jtuned(100)
    plan = tat.TunedPlan.from_json(jplan.to_json())
    for tile in (16, 24, 48):
        assert search.plan_cycles(cfg, images[2], tile, plan.classify, plan.class_schedule) == \
            jat.search.plan_cycles(jcfg, images[2], tile, jplan.classify, jplan.class_schedule)
    assert search.search_tile(cfg, images, plan.classify, plan.class_schedule) == \
        jat.search.search_tile(jcfg, images, jplan.classify, jplan.class_schedule)


# --------------------------------------------------------------- tune_unet


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("target_milli", [100, 50])
def test_tune_unet_equals_reference(target_milli, impl):
    cfg, params = _tnet(impl)
    want = _jtuned(target_milli)
    got = tat.tune_unet(params, cfg, [_calib_image()], target_rel_err=target_milli / 1000,
                        device="cpu")
    for field in ("workload", "planes", "class_planes", "tile", "halo", "class_thresholds",
                  "target_rel_err", "params_fingerprint", "modeled", "version"):
        assert getattr(got, field) == getattr(want, field), field
    for key in ("repairs", "measure_calls", "holds", "n_images", "margin", "slack"):
        assert got.certificate[key] == want.certificate[key], key
    for key in ("measured_rel_err", "cert", "sound_bound"):
        _close(got.certificate[key], want.certificate[key], key)
    _close(got.layer_bounds, want.layer_bounds, "layer_bounds")
    _close(got.layer_gain, want.layer_gain, "layer_gain")
    cert = got.certificate
    assert cert["measured_rel_err"] <= cert["cert"] <= got.target_rel_err
    assert got.geometry == dict(want.geometry, impl=impl)


def test_tune_unet_rejects_bad_budget_split():
    cfg, params = _tnet("kernel")
    with pytest.raises(ValueError, match="margin"):
        tat.tune_unet(params, cfg, [_calib_image()], target_rel_err=0.1, margin=0.9,
                      device="cpu")
    with pytest.raises(ValueError, match="slack"):
        tat.tune_unet(params, cfg, [_calib_image()], target_rel_err=0.1, slack=0.9,
                      device="cpu")


# --------------------------------------------------------- plan round trip


def test_plan_json_interchanges_with_reference(tmp_path):
    """A reference plan loads in the port and a port plan in the reference;
    both round-trip unchanged through each package's atomic JSON."""
    jplan = _jtuned(100)
    tplan = tat.TunedPlan.from_json(jplan.to_json())
    assert tplan.to_json() == jplan.to_json()
    tplan.save(tmp_path / "port" / "plan.json")
    assert jat.TunedPlan.load(tmp_path / "port" / "plan.json") == jplan
    jplan.save(tmp_path / "ref" / "plan.json")
    assert tat.TunedPlan.load(tmp_path / "ref" / "plan.json") == tplan
    cfg, params = _tnet("kernel")
    mine = tat.tune_unet(params, cfg, [_calib_image()], target_rel_err=0.1, device="cpu")
    back = jat.TunedPlan.from_json(load_json(save_json_atomic(tmp_path / "p.json",
                                                              mine.to_json())))
    assert back.to_json() == mine.to_json()
    assert tat.TunedPlan.from_json(mine.to_json()) == mine
    assert mine.describe() == jat.TunedPlan.from_json(mine.to_json()).describe()


def test_plan_validation_equals_reference():
    """The same malformed plans are refused, with the same messages."""
    plan = tat.TunedPlan.from_json(_jtuned(100).to_json())
    bad = [
        dict(planes=(0,) * len(plan.planes)),
        dict(workload="vae"),
        dict(class_thresholds=(0.5,) + plan.class_thresholds[1:]),
        dict(tile=2 * plan.halo),
        dict(class_planes=None),
        dict(spec_planes=(2,) * len(plan.planes), spec_k=2),
        dict(spec_planes=(2,) * len(plan.planes)),
        dict(target_rel_err=0.0),
    ]
    for change in bad:
        with pytest.raises(ValueError) as got:
            dataclasses.replace(plan, **change)
        with pytest.raises(ValueError) as want:
            dataclasses.replace(_jtuned(100), **change)
        assert str(got.value) == str(want.value), change
    newer = dict(plan.to_json(), version=plan.version + 1)
    with pytest.raises(ValueError, match="newer"):
        tat.TunedPlan.from_json(newer)
    v1 = {k: v for k, v in plan.to_json().items()
          if k not in ("params_fingerprint", "spec_planes", "spec_k")}
    v1["version"] = 1
    old = tat.TunedPlan.from_json(v1)
    assert old.params_fingerprint is None and old.version == 1
    assert old.to_json() == jat.TunedPlan.from_json(v1).to_json()


def test_apply_plan_and_reference_plan_equal_reference():
    jplan = _jtuned(100)
    plan = tat.TunedPlan.from_json(jplan.to_json())
    cfg, _ = _tnet("kernel")
    assert tat.apply_plan(cfg, plan).plane_schedule == jat.apply_plan(_jnet()[0], jplan).plane_schedule
    assert tat.reference_plan(plan).to_json() == jat.reference_plan(jplan).to_json()
    lm = dataclasses.replace(plan, workload="lm", tile=None, halo=None,
                             class_thresholds=None, class_planes=None)
    with pytest.raises(ValueError, match="cannot apply"):
        tat.apply_plan(cfg, lm)


# ----------------------------------------------------------- plan serving


def _record_port_engine(monkeypatch):
    """Every forward the port's engine runs: (input batch, class config,
    per-conv int8 activations, per-conv int32 outputs)."""
    calls = []
    forward, conv = unet.forward, ops.mma_conv2d

    def recording_conv(x, w, **kw):
        out = conv(x, w, **kw)
        calls[-1][2].append(x.clone())
        calls[-1][3].append(out.clone())
        return out

    def recording_forward(params, x, cfg, **kw):
        calls.append((np.array(x), cfg, [], []))
        return forward(params, x, cfg, **kw)

    monkeypatch.setattr(unet, "forward", recording_forward)
    monkeypatch.setattr(ops, "mma_conv2d", recording_conv)
    return calls


def _reference_tile(jparams, jcfg, tile, planes, monkeypatch):
    """The reference's eager forward of one tile alone: per-conv int8
    activations and int32 outputs."""
    xs, outs = [], []
    conv = jops.mma_conv2d

    def recording(x, w, **kw):
        out = conv(x, w, **kw)
        xs.append(np.asarray(x))
        outs.append(np.asarray(out))
        return out

    monkeypatch.setattr(jops, "mma_conv2d", recording)
    try:
        junet.forward(jparams, tile[None], dataclasses.replace(jcfg, plane_schedule=planes))
    finally:
        monkeypatch.setattr(jops, "mma_conv2d", conv)
    return xs, outs


@pytest.mark.parametrize("impl", IMPLS)
def test_plan_served_through_both_engines(impl, monkeypatch):
    """The reference's plan served by both engines: equal accounting,
    logits within ``LOGIT_ATOL``; and every tile of every micro-batch the
    port runs has the int8 activations and int32 conv outputs of the
    reference's forward of that tile alone (its own activation scale)."""
    jcfg, jparams = _jnet()
    cfg, params = _tnet(impl)
    jplan = _jtuned(50)
    plan = tat.TunedPlan.from_json(jplan.to_json())
    images = [_calib_image(3), phantom_image(61, 45, 3, seed=4), _calib_image(5, 30, 70)]
    want = jat.engine_from_plan(jcfg, jparams, jplan).run(images)
    calls = _record_port_engine(monkeypatch)
    eng = tat.engine_from_plan(cfg, params, plan, device="cpu")
    assert (eng.tile, eng.halo, eng.per_tile_quant) == (plan.tile, plan.halo, True)
    got = eng.run(images)
    monkeypatch.undo()
    for g, w in zip(got, want):
        assert (g.cycles, g.ops, g.pj, g.n_tiles, g.class_counts) == \
            (w.cycles, w.ops, w.pj, w.n_tiles, w.class_counts)
        np.testing.assert_allclose(g.logits, w.logits, atol=LOGIT_ATOL, rtol=0)
    n_rows = 0
    for x, ccfg, txs, touts in calls:
        assert len(txs) == len(cfg.conv_layers())
        for b in range(x.shape[0]):
            jxs, jouts = _reference_tile(jparams, jcfg, x[b], ccfg.plane_schedule, monkeypatch)
            for l, (tx, jx, to, jo) in enumerate(zip(txs, jxs, touts, jouts)):
                np.testing.assert_array_equal(tx[b : b + 1].numpy(), jx, err_msg=f"int8 x, conv {l}")
                np.testing.assert_array_equal(to[b : b + 1].numpy(), jo, err_msg=f"int32, conv {l}")
            n_rows += 1
    assert n_rows == eng.batch * len(calls) and n_rows >= sum(r.n_tiles for r in got)


@pytest.mark.parametrize("impl", IMPLS)
def test_per_sample_scale_makes_rows_independent(impl, monkeypatch):
    """``forward(per_sample_scale=True)``: each batch row's conv outputs are
    those of that row alone, bit for bit, in one batched call; the default
    (one scale per tensor) ties a quiet row to a loud batch mate."""
    cfg, params = _tnet(impl, depth=2, base=4)
    rng = np.random.default_rng(7)
    x = rng.normal(0.0, 1.0, (3, 16, 16, 3)).astype(np.float32)
    x[1] *= 1e-3  # a quiet tile among loud ones

    def convs(xin, **kw):
        seen = []
        conv = ops.mma_conv2d

        def recording(*a, **k):
            out = conv(*a, **k)
            seen.append(out)
            return out

        monkeypatch.setattr(ops, "mma_conv2d", recording)
        logits = unet.forward(params, xin, cfg, device="cpu", **kw)
        monkeypatch.setattr(ops, "mma_conv2d", conv)
        return logits, seen

    batched_logits, batched = convs(x, per_sample_scale=True)
    _, shared = convs(x)
    for b in range(x.shape[0]):
        alone_logits, alone = convs(x[b : b + 1], per_sample_scale=True)
        for l, (a, c) in enumerate(zip(alone, batched)):
            assert torch.equal(a[0], c[b]), (b, l)
        np.testing.assert_allclose(batched_logits[b].numpy(), alone_logits[0].numpy(),
                                   atol=LOGIT_ATOL, rtol=0)
        # one row alone: one scale either way
        assert torch.equal(convs(x[b : b + 1])[0], alone_logits)
    assert not all(torch.equal(a[1], c[1]) for a, c in zip(shared, batched))


def test_engine_plan_guards():
    cfg, params = _tnet("kernel")
    plan = tat.TunedPlan.from_json(_jtuned(100).to_json())
    lm = dataclasses.replace(plan, workload="lm", tile=None, halo=None,
                             class_thresholds=None, class_planes=None)
    with pytest.raises(ValueError, match="cannot serve a 'lm' plan"):
        SegEngine(cfg, params, plan=lm, device="cpu")
    deeper, deeper_params = _tnet("kernel", depth=2)
    with pytest.raises(ValueError, match="plan covers 3 convs"):
        SegEngine(deeper, deeper_params, plan=plan, device="cpu")
    bad = plan.to_json()
    bad["tile"] = 2 * plan.halo
    with pytest.raises(ValueError, match="minimum viable tile"):
        tat.TunedPlan.from_json(bad)
    flat = dataclasses.replace(plan, class_thresholds=None, class_planes=None)
    eng = SegEngine(cfg, params, plan=flat, device="cpu")
    assert not eng.adaptive and eng.per_tile_quant
    float_eng = SegEngine(dataclasses.replace(cfg, quant_mode="none"), params, plan=plan,
                          device="cpu")
    assert not float_eng.per_tile_quant and float_eng.tile == plan.tile


def test_entry_points_default_to_the_card(monkeypatch):
    """Without ``device='cpu'`` every entry point asks for the CUDA card,
    and raises where there is none."""
    cfg, params = _tnet("kernel")
    plan = tat.TunedPlan.from_json(_jtuned(100).to_json())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (
        lambda: tat.tune_unet(params, cfg, [_calib_image()], target_rel_err=0.1),
        lambda: tat.calibrate_unet(params, cfg, [_calib_image()]),
        lambda: tat.engine_from_plan(cfg, params, plan),
        lambda: SegEngine(cfg, params, plan=plan),
    ):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            call()


# ----------------------------------------------------- configs, checkpoint


def test_unet_configs_equal_reference():
    for mine, ref in ((get_config("unet"), jget_config("unet")),
                      (get_smoke_config("unet"), jget_smoke_config("unet"))):
        got = dataclasses.asdict(mine)
        want = dataclasses.asdict(ref)
        assert got.pop("impl") == "kernel" and want.pop("impl") == "xla"
        assert got == want


def test_json_documents_interchange_with_reference(tmp_path):
    doc = {"b": [1, 2.5, None], "a": {"x": "y"}}
    path = save_json_atomic(tmp_path / "deep" / "doc.json", doc)
    assert load_json(path) == jload_json(path) == doc
    assert not list(path.parent.glob("*.tmp"))
    jpath = jsave_json(tmp_path / "ref.json", doc)
    assert load_json(jpath) == doc
    assert path.read_text() == jpath.read_text()
