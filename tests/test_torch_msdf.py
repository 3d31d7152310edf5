"""The port's cycle-level MSDF model (``repro_torch.core.msdf``) and its
Table 1 twin (``repro_torch.bench.table1``) against the JAX package.

Both msdf models are integer arithmetic on Python ints and numpy, so every
digit stream, value and cycle count must be equal, not close.  The Table 1
twin's model and paper rows must equal ``benchmarks/table1.py``'s string
for string.  Inputs are drawn with numpy from fixed seeds over the ranges
``tests/test_msdf.py`` draws from.
"""
import numpy as np
import pytest
import torch

from benchmarks import table1 as jtable1
from repro.core import msdf as jmsdf
from repro_torch.bench import table1
from repro_torch.core import msdf


def _operands(seed: int, shape):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, shape).astype(np.uint8)
    w = rng.integers(-128, 128, shape).astype(np.int64)
    return a, w


def test_constants_equal_reference():
    assert (msdf.DELTA_MMA, msdf.DELTA_ADD) == (jmsdf.DELTA_MMA, jmsdf.DELTA_ADD)
    assert msdf.OnlineAdder.GROWTH == jmsdf.OnlineAdder.GROWTH


def _unit_trace(mod, a, w, t_n):
    unit = mod.MMAUnit(w, t_n=t_n)
    val, cycles = unit.run(a)
    return val, cycles, list(unit.ogf.digits), unit.ogf.max_abs_residual, unit.p_out


@pytest.mark.parametrize("seed", range(8))
def test_mma_unit_stream_equals_reference(seed):
    a, w = _operands(seed, (32,))
    got = _unit_trace(msdf, a, w, 32)
    assert got == _unit_trace(jmsdf, a, w, 32)
    assert got[0] == int(np.dot(a.astype(np.int64), w))
    assert got[1] == msdf.DELTA_MMA + got[4]


@pytest.mark.parametrize("t_n", [2, 3, 5, 8, 13, 16])
def test_mma_unit_other_tn_equals_reference(t_n):
    a, w = _operands(100 + t_n, (t_n,))
    got = _unit_trace(msdf, a, w, t_n)
    assert got == _unit_trace(jmsdf, a, w, t_n)
    assert got[0] == int(np.dot(a.astype(np.int64), w))


def test_online_serializer_msdf_order_equals_reference():
    """The reference test's ramp operands: the same MSB-first digits, and
    every prefix within the weight of the digits still to come."""
    w = np.arange(-16, 16, dtype=np.int64)
    a = np.arange(32, dtype=np.uint8) * 8
    val, _, digits, _, p_out = _unit_trace(msdf, a, w, 32)
    assert digits == _unit_trace(jmsdf, a, w, 32)[2]
    msb = p_out - 1
    for k in range(1, len(digits)):
        assert abs(val - msdf.sd_to_int(digits[:k], msb)) < 2 ** (msb - k + 1)
    assert msdf.sd_to_int(digits, msb) == val


@pytest.mark.parametrize("seed", range(3))
def test_online_adder_stream_equals_reference(seed):
    """Two MMA units' digit streams through one online adder, cycle by
    cycle: the same output digit (or idle cycle) at every cycle."""
    a, w = _operands(200 + seed, (2, 32))

    def streams(mod):
        units = [mod.MMAUnit(w[j], t_n=32) for j in range(2)]
        tls = []
        for u, acts in zip(units, a):
            tl = [u.step((acts.astype(np.int64) >> b) & 1) for b in range(7, -1, -1)]
            while not u.ogf.done:
                tl.append(u.step(None))
            tls.append(tl)
        f = next(i for i, d in enumerate(tls[0]) if d is not None)
        adder = mod.OnlineAdder(units[0].p_out - 1, units[0].p_out, start=f)
        out = []
        for t in range(len(tls[0]) + units[0].p_out + 8):
            out.append(adder.step(tls[0][t] if t < len(tls[0]) else None,
                                  tls[1][t] if t < len(tls[1]) else None))
        return out, adder.out.value()

    got, val = streams(msdf)
    assert (got, val) == streams(jmsdf)
    assert val == int(np.sum(a.astype(np.int64) * w))


@pytest.mark.parametrize("seed", range(4))
def test_kpb_equals_reference(seed):
    a, w = _operands(300 + seed, (9, 8))
    got = msdf.kpb_inner_product(a, w)
    assert got == jmsdf.kpb_inner_product(a, w)
    assert got[0] == int(np.sum(a.astype(np.int64) * w))


@pytest.mark.parametrize("a_v,w_v", [(255, 127), (255, -128), (0, -128), (128, 127)])
def test_kpb_extremes_equal_reference(a_v, w_v):
    a = np.full((9, 32), a_v, np.uint8)
    w = np.full((9, 32), w_v, np.int64)
    got = msdf.kpb_inner_product(a, w)
    assert got == jmsdf.kpb_inner_product(a, w)
    assert got[0] == int(np.sum(a.astype(np.int64) * w))


# ------------------------------------------------------- the Table 1 twin


def test_table1_model_rows_equal_reference():
    rows = table1.model_rows()
    assert rows == jtable1.model_rows()
    # the calibrated model against the paper's printed 15.14 GOPS/W, 186.2 mJ
    assert "gops_w=14.94;e_mj=188.0" in rows[0][2]


def test_table1_paper_rows_equal_reference():
    assert table1.paper_rows() == jtable1.paper_rows()


def test_table1_measured_rows_need_the_card(monkeypatch):
    """No CPU time is reported under the card's row names: without a card
    the measured rows raise, and on the CPU they refuse."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        table1.measured_rows()
    with pytest.raises(ValueError, match="CUDA card"):
        table1.measured_rows(device="cpu")
