"""The port's core library against the JAX reference on the same numpy
inputs: quantization, bit planes, the MMA datapaths, early termination,
plane schedules, the cycle and pJ models — all equal, bit for bit where the
arithmetic is integer — and the port's import isolation."""
import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitplane as jbp
from repro.core import cycle_model as jcm
from repro.core import early_term as jet
from repro.core import energy_model as jem
from repro.core import mma as jmma
from repro.core import quant as jq
from repro.core.plane_schedule import PlaneSchedule as JSchedule
from repro_torch.core import bitplane, cycle_model, early_term, energy_model, mma, quant
from repro_torch.core.plane_schedule import PlaneSchedule
from repro_torch.serve.queue import FifoQueue, SlotTable

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    torch.set_num_threads(2)


def _i8(seed, shape):
    return np.random.default_rng(seed).integers(-128, 128, shape).astype(np.int8)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ----------------------------------------------------------- quantization


@pytest.mark.parametrize("batch_axis", [None, 0, -1])
def test_quantize_acts_bitwise(batch_axis):
    x = np.random.default_rng(1).normal(size=(3, 5, 7)).astype(np.float32)
    x[0, 0, 0] = 0.5 * np.abs(x).max()  # a value on a rounding tie's doorstep
    got = quant.quantize_acts(_t(x), batch_axis=batch_axis)
    want = jq.quantize_acts(jnp.asarray(x), batch_axis=batch_axis)
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    np.testing.assert_array_equal(quant.dequantize(got).numpy(), np.asarray(jq.dequantize(want)))


@pytest.mark.parametrize("channel_axis", [-1, 0])
def test_quantize_weights_bitwise(channel_axis):
    w = np.random.default_rng(2).normal(size=(3, 3, 4, 6)).astype(np.float32)
    got = quant.quantize_weights(_t(w), channel_axis=channel_axis)
    want = jq.quantize_weights(jnp.asarray(w), channel_axis=channel_axis)
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    xs = quant.quantize_acts(_t(w)).scale
    np.testing.assert_array_equal(
        quant.quantized_matmul_scale(xs, got.scale).numpy(),
        np.asarray(jq.quantized_matmul_scale(jnp.asarray(xs.numpy()), want.scale)),
    )


def test_round_half_to_even_like_reference():
    x = np.array([0.5, 1.5, 2.5, -0.5, -2.5, 127.0], np.float32)
    got = quant.quantize_acts(_t(x)).values.numpy()
    np.testing.assert_array_equal(got, np.asarray(jq.quantize_acts(jnp.asarray(x)).values))


# ------------------------------------------------------------- bit planes


@pytest.mark.parametrize("signed", [True, False])
def test_decompose_recombine(signed):
    x = _i8(3, (4, 9))
    got = bitplane.decompose(_t(x), signed=signed)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jbp.decompose(jnp.asarray(x),
                                                                        signed=signed)))
    np.testing.assert_array_equal(
        bitplane.recombine(got, signed=signed).numpy(),
        np.asarray(jbp.recombine(jnp.asarray(got.numpy()), signed=signed)),
    )


@pytest.mark.parametrize("planes", range(1, 9))
def test_truncate_to_planes(planes):
    x = _i8(4, (6, 10))
    want = np.asarray(jbp.truncate_to_planes(jnp.asarray(x), planes))
    np.testing.assert_array_equal(bitplane.truncate_to_planes(_t(x), planes).numpy(), want)
    as_tensor = bitplane.truncate_to_planes(_t(x), torch.tensor(planes, dtype=torch.int32))
    np.testing.assert_array_equal(as_tensor.numpy(), want)


def test_normalize_planes_validates():
    x = _t(_i8(5, (2, 3)))
    for bad in (0, 9):
        with pytest.raises(ValueError):
            bitplane.normalize_planes(x, bad)
    xt, p = bitplane.normalize_planes(x, torch.tensor(3))
    assert p == 8
    np.testing.assert_array_equal(xt.numpy(), bitplane.truncate_to_planes(x, 3).numpy())


@pytest.mark.parametrize("planes", [8, 6, 3, 1])
@pytest.mark.parametrize("correction", ["none", "midpoint"])
@pytest.mark.parametrize("signed", [True, False])
def test_bitplane_matmul(planes, correction, signed):
    x, w = _i8(6, (2, 5, 33)), _i8(7, (33, 12))
    got = bitplane.bitplane_matmul(_t(x), _t(w), planes=planes, signed=signed,
                                   correction=correction)
    want = jbp.bitplane_matmul(jnp.asarray(x), jnp.asarray(w), planes=planes, signed=signed,
                               correction=correction)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("planes", [8, 5, 2])
def test_cascade(planes):
    x, w = _i8(8, (9, 40)), _i8(9, (40, 7))
    got = bitplane.bitplane_matmul_cascade(_t(x), _t(w), planes=planes)
    want = jbp.bitplane_matmul_cascade(jnp.asarray(x), jnp.asarray(w), planes=planes)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------------ mma


@pytest.mark.parametrize("impl,jimpl", [
    ("kernel", "xla"), ("horner", "xla"), ("cascade", "cascade"), ("int8", "int8"),
])
@pytest.mark.parametrize("planes", [8, 4])
def test_mma_dot_impls(impl, jimpl, planes):
    x, w = _i8(10, (24, 96)), _i8(11, (96, 48))
    got = mma.mma_dot(_t(x), _t(w), planes=planes, impl=impl)
    want = jmma.mma_dot(jnp.asarray(x), jnp.asarray(w), planes=planes, impl=jimpl)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError):
        mma.mma_dot(_t(x), _t(w), impl="pallas")


def test_mma_linear_and_its_straight_through_gradient():
    rng = np.random.default_rng(12)
    x = rng.normal(size=(4, 32)).astype(np.float32)
    w = (rng.normal(size=(32, 16)) * 0.1).astype(np.float32)
    xt = _t(x).requires_grad_(True)
    got = mma.mma_linear(xt, _t(w), planes=6, batch_axis=0)
    want = jmma.mma_linear(jnp.asarray(x), jnp.asarray(w), planes=6, batch_axis=0)
    # the quantized forward is integer up to one float32 scale multiply;
    # the STE adds and subtracts the float product (1-ulp rounding each)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    got.sum().backward()
    # d sum(x @ w) / dx = rows of w summed: float32 sums in another order
    np.testing.assert_allclose(xt.grad.numpy(), np.broadcast_to(w.sum(1), (4, 32)), rtol=1e-5)


# ------------------------------------------------- early termination, schedules


@pytest.mark.parametrize("planes", [1, 4, 7, 8])
@pytest.mark.parametrize("midpoint", [True, False])
def test_truncation_bounds(planes, midpoint):
    w = _i8(13, (50, 9))
    np.testing.assert_array_equal(
        early_term.truncation_bound(_t(w), planes, midpoint=midpoint).numpy(),
        np.asarray(jet.truncation_bound(jnp.asarray(w), planes, midpoint=midpoint)),
    )
    np.testing.assert_array_equal(early_term.output_scale_bound(_t(w)).numpy(),
                                  np.asarray(jet.output_scale_bound(jnp.asarray(w))))
    for tgt in (0.001, 0.02, 0.3):
        assert early_term.choose_planes(_t(w), tgt, midpoint=midpoint) == \
            jet.choose_planes(jnp.asarray(w), tgt, midpoint=midpoint)


def test_empirical_rel_err():
    a = np.random.default_rng(14).integers(-1000, 1000, (8, 8)).astype(np.int32)
    b = a + np.random.default_rng(15).integers(-3, 4, (8, 8)).astype(np.int32)
    np.testing.assert_allclose(
        float(early_term.empirical_rel_err(_t(a), _t(b))),
        float(jet.empirical_rel_err(jnp.asarray(a), jnp.asarray(b))), rtol=1e-7,
    )


@pytest.mark.parametrize("target", [0.01, 0.05, 0.2])
def test_schedule_from_weights_and_refine(target):
    rng = np.random.default_rng(16)
    ws = [rng.integers(-127, 128, (3, 3, c, 8)).astype(np.int8) for c in (2, 8, 16)]
    ws[1][..., :4] //= 16  # a low-range layer
    got = PlaneSchedule.from_weights([_t(w) for w in ws], target)
    want = JSchedule.from_weights([jnp.asarray(w) for w in ws], target)
    assert got.planes == want.planes
    assert got.layer_bounds == want.layer_bounds
    assert got.rel_err_bound() == want.rel_err_bound()
    assert got.describe() == want.describe()
    for r in (1.0, 0.5, 0.3, 0.01, 0.0, [0.5, 0.25, 0.1]):
        assert dataclasses.astuple(got.refine(r)) == dataclasses.astuple(want.refine(r))
    np.testing.assert_array_equal(got.as_array().numpy(), np.asarray(want.as_array()))


def test_schedule_builders_and_validation():
    s = PlaneSchedule.from_list([8, 5, 3])
    j = JSchedule.from_list([8, 5, 3])
    assert (s.planes_for(7), s.arithmetic_fraction(), s.rel_err_bound(), s.describe()) == \
        (j.planes_for(7), j.arithmetic_fraction(), j.rel_err_bound(), j.describe())
    assert PlaneSchedule.uniform(6, 4).planes == JSchedule.uniform(6, 4).planes
    for bad in ([], [0], [9]):
        with pytest.raises(ValueError):
            PlaneSchedule.from_list(bad)
    for bad in (float("nan"), float("inf"), 1.5, [0.5, 0.5]):
        with pytest.raises(ValueError):
            s.refine(bad)


# ------------------------------------------------- cycle and energy models


def test_cycle_and_energy_models_equal_reference():
    assert energy_model.calibration() == jem.calibration()
    for geo in [dict(hw=80, in_ch=4, base=48, depth=3, convs_per_stage=1),
                dict(hw=(56, 72), in_ch=4, base=48, depth=3, convs_per_stage=1),
                dict(hw=32, in_ch=3, base=8, depth=2, convs_per_stage=2)]:
        layers = cycle_model.unet_conv_layers(**geo)
        assert [dataclasses.astuple(l) for l in layers] == \
            [dataclasses.astuple(l) for l in jcm.unet_conv_layers(**geo)]
        for sched in [(8,), (6, 5, 4, 5, 7, 8, 3), (2,)]:
            for mode in ("pipelined", "as_printed"):
                assert cycle_model.schedule_cycles(layers, sched, mode=mode) == \
                    jcm.schedule_cycles(layers, sched, mode=mode)
                assert energy_model.schedule_layer_pj(layers, sched, mode=mode) == \
                    jem.schedule_layer_pj(layers, sched, mode=mode)
        assert cycle_model.model_ops(layers) == jcm.model_ops(layers)
        args = tuple(geo.values())
        assert cycle_model.unet_window_cycles(*args, (7, 6, 5)) == \
            jcm.unet_window_cycles(*args, (7, 6, 5))
    assert cycle_model.calibrate_unet()[0] == jcm.calibrate_unet()[0]
    assert cycle_model.CALIBRATED_UNET == jcm.CALIBRATED_UNET


# ------------------------------------------------------- queue and slots


def test_fifo_queue_and_slot_table():
    q = FifoQueue(range(5))
    slots = SlotTable(3)
    admitted = []
    assert q.pump(slots, lambda r: admitted.append(r) or slots.occupy(r) is not None) == 3
    assert admitted == [0, 1, 2] and len(q) == 2 and q.peek() == 3
    assert slots.free_count() == 0 and slots.release(1) == 1
    assert slots.free_index() == 1
    assert q.pop_at(-1) == 4 and list(q) == [3]
    with pytest.raises(KeyError):
        slots.release(1)
    with pytest.raises(ValueError):
        SlotTable(0)


# ------------------------------------------------------- import isolation


def test_port_imports_neither_jax_nor_the_reference():
    """With jax made unimportable, every module of the port imports, and
    none of them pulls in the reference package."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "assert len(names) >= 67, names\n"
        "need = ['obs.attrib', 'obs.slo', 'obs.energy', 'obs.capture', 'obs.timeline',\n"
        "        'serve.modeled', 'serve.fabric', 'bench.fabric', 'bench.capacity',\n"
        "        'bench.energy', 'models.moe', 'checkpoint.ckpt', 'configs.olmoe_1b_7b',\n"
        "        'configs.dbrx_132b']\n"
        "missing = [n for n in need if 'repro_torch.' + n not in names]\n"
        "assert not missing, missing\n"
        "print(len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
