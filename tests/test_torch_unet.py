"""The port's U-Net against the JAX reference, with the reference's weights
carried over by ``params_from_jax`` and the same numpy inputs.

Quantized forwards: every 3x3 conv is integer-exact and every scale is the
same float32 computation, so each conv's activation re-quantizes to the
same int8 values; the logits differ only by the float 1x1 head, which sums
channels in another order (hence ``LOGIT_ATOL``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jq
from repro.models import unet as junet
from repro_torch.core import quant
from repro_torch.models import unet
from repro_torch.obs import timeline

# Float 1x1 head over <= 8 channels of O(1) activations, summed in another
# order than XLA's: a few float32 ulps.  Float-mode convs add the same kind
# of reordering over 9*Cin terms.
LOGIT_ATOL = 1e-5

SCHEDULES = [None, (6, 5, 4, 5, 7)]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def net():
    jcfg = junet.UNetConfig(hw=16, in_ch=3, base=8, depth=2, quant_mode="mma_int8", impl="xla")
    jparams = junet.init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = unet.UNetConfig(hw=16, in_ch=3, base=8, depth=2, quant_mode="mma_int8")
    tparams = unet.params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    x = np.random.default_rng(0).normal(size=(2, 16, 16, 3)).astype(np.float32)
    return jcfg, jparams, tcfg, tparams, x


def _with(cfg, **kw):
    return dataclasses.replace(cfg, **kw)


def test_params_carry_over_and_seeded_init(net):
    _, jparams, tcfg, tparams, _ = net
    jl = jax.tree.leaves(jparams)
    tl = jax.tree.leaves(tparams)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    own = unet.init_params(0, tcfg, device="cpu")
    assert [t.shape for t in jax.tree.leaves(own)] == [t.shape for t in tl]
    again = unet.init_params(0, tcfg, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(jax.tree.leaves(own), jax.tree.leaves(again)))
    assert all(float(torch.max(torch.abs(t))) <= 2.0 for t in jax.tree.leaves(own))


@pytest.mark.parametrize("pad_mode", ["zero", "edge", "reflect"])
def test_float_forward(net, pad_mode):
    jcfg, jparams, tcfg, tparams, x = net
    want = junet.forward(jparams, jnp.asarray(x), _with(jcfg, quant_mode="none",
                                                        pad_mode=pad_mode))
    got = unet.forward(tparams, x, _with(tcfg, quant_mode="none", pad_mode=pad_mode),
                       device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_ATOL)


@pytest.mark.parametrize("sched", SCHEDULES)
@pytest.mark.parametrize("jimpl", ["pallas", "xla"])
def test_quantized_forward_every_conv_equal(net, sched, jimpl):
    jcfg, jparams, tcfg, tparams, x = net
    jtaps, ttaps = [], []
    want = junet.forward(jparams, jnp.asarray(x), _with(jcfg, plane_schedule=sched, impl=jimpl),
                         taps=jtaps)
    got = unet.forward(tparams, x, _with(tcfg, plane_schedule=sched), taps=ttaps, device="cpu")
    assert len(jtaps) == len(ttaps) == 5
    for a, b in zip(jtaps, ttaps):
        qa, qb = jq.quantize_acts(a), quant.quantize_acts(b)
        np.testing.assert_array_equal(qb.values.numpy(), np.asarray(qa.values))
        np.testing.assert_array_equal(qb.scale.numpy(), np.asarray(qa.scale))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_ATOL)


@pytest.mark.parametrize("impl", ["horner", "cascade", "int8"])
def test_quantized_datapaths_agree(net, impl):
    _, _, tcfg, tparams, x = net
    cfg = _with(tcfg, plane_schedule=(7, 3, 5, 8, 2))
    want = unet.forward(tparams, x, cfg, device="cpu")
    got = unet.forward(tparams, x, _with(cfg, impl=impl), device="cpu")
    assert torch.equal(got, want)


def test_planes_arr_hook(net):
    jcfg, jparams, tcfg, tparams, x = net
    budgets = [7, 4, 6, 3, 8]
    jtaps, ttaps = [], []
    want = junet.forward(jparams, jnp.asarray(x), jcfg,
                         planes_arr=jnp.asarray(budgets, jnp.int32), taps=jtaps)
    got = unet.forward(tparams, x, tcfg, planes_arr=torch.tensor(budgets, dtype=torch.int32),
                       taps=ttaps, device="cpu")
    for a, b in zip(jtaps, ttaps):
        np.testing.assert_array_equal(quant.quantize_acts(b).values.numpy(),
                                      np.asarray(jq.quantize_acts(a).values))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_ATOL)
    static = unet.forward(tparams, x, _with(tcfg, plane_schedule=tuple(budgets)), device="cpu")
    assert torch.equal(got, static)


def test_forward_with_error_bound(net):
    jcfg, jparams, tcfg, tparams, x = net
    sched = (6, 5, 4, 5, 7)
    jo_s, jo_f, jbound = junet.forward_with_error_bound(
        jparams, jnp.asarray(x), _with(jcfg, plane_schedule=sched))
    to_s, to_f, tbound = unet.forward_with_error_bound(
        tparams, x, _with(tcfg, plane_schedule=sched), device="cpu")
    assert jbound > 0
    # every term is the same float32 or Python-float computation except the
    # head's column L1 sum and max|out_full|, which see the head's rounding
    assert abs(tbound - jbound) <= 1e-6 * jbound
    np.testing.assert_allclose(to_s.numpy(), np.asarray(jo_s), atol=LOGIT_ATOL)
    np.testing.assert_allclose(to_f.numpy(), np.asarray(jo_f), atol=LOGIT_ATOL)
    assert float(torch.max(torch.abs(to_s - to_f))) <= tbound * float(torch.max(torch.abs(to_f)))


@pytest.mark.parametrize("target", [0.01, 0.05])
def test_schedule_from_params(net, target):
    _, jparams, _, tparams, _ = net
    got = unet.schedule_from_params(tparams, target)
    want = junet.schedule_from_params(jparams, target)
    assert (got.planes, got.layer_bounds) == (want.planes, want.layer_bounds)
    assert len(unet.conv_weights_in_order(tparams)) == len(junet.conv_weights_in_order(jparams))


def test_loss_fn(net):
    jcfg, jparams, tcfg, tparams, x = net
    mask = np.random.default_rng(1).integers(0, 4, x.shape[:3])
    want, _ = junet.loss_fn(jparams, {"image": jnp.asarray(x), "mask": jnp.asarray(mask)}, jcfg)
    got, aux = unet.loss_fn(tparams, {"image": x, "mask": mask}, tcfg, device="cpu")
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert aux["nll"] is got


def test_config_geometry_checks_match_reference(net):
    jcfg, _, tcfg, tparams, x = net
    assert tcfg.min_viable_tile() == jcfg.min_viable_tile()
    for tile in (4, 6, 24, 32):
        try:
            want = jcfg.validate_tile(tile)
        except ValueError:
            with pytest.raises(ValueError):
                tcfg.validate_tile(tile)
        else:
            assert tcfg.validate_tile(tile) == want
    with pytest.raises(ValueError):
        _with(tcfg, plane_schedule=(8, 8)).schedule()
    with pytest.raises(ValueError):
        unet.forward(tparams, x[:, :14], tcfg, device="cpu")
    assert unet.UNetConfig().impl == "kernel"
    assert [dataclasses.astuple(c) for c in unet.UNetConfig().conv_layers()] == \
        [dataclasses.astuple(c) for c in junet.UNetConfig().conv_layers()]


def test_forward_without_device_raises_without_a_card(net):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    _, _, tcfg, tparams, x = net
    with pytest.raises(RuntimeError, match="CUDA card"):
        unet.forward(tparams, x, tcfg)
    with pytest.raises(RuntimeError, match="CUDA card"):
        unet.init_params(0, tcfg)


# ------------------------------------------------------- the graph cache


@pytest.mark.parametrize("per_sample_scale", [False, True])
def test_a_graph_cache_off_the_card_leaves_the_forward_eager(net, per_sample_scale):
    """On the CPU a cache changes nothing: every forward runs eagerly, equal
    to one without it; only ``unet.graph_forwards`` counts."""
    _, _, tcfg, tparams, x = net
    cfg = _with(tcfg, plane_schedule=SCHEDULES[1])
    want = unet.forward(tparams, x, cfg, per_sample_scale=per_sample_scale, device="cpu")
    graphs = unet.ForwardGraphs()
    with timeline.recording() as rec:
        for _ in range(3):
            got = unet.forward(tparams, x, cfg, per_sample_scale=per_sample_scale, device="cpu",
                               graphs=graphs)
            assert torch.equal(got, want)
    assert rec.counts == {"unet.graph_forwards": 3}
    assert len(graphs) == 0


def test_the_graph_key_separates_signatures_and_merges_equal_schedules(net):
    _, _, tcfg, _, _ = net
    key, shape = unet.ForwardGraphs.key, (2, 16, 16, 3)
    n = len(tcfg.conv_layers())
    base = key(shape, tcfg, False)
    # one schedule spelled two ways, or at another nominal size: one graph
    assert key(shape, _with(tcfg, plane_schedule=(8,) * n), False) == base
    assert key(shape, _with(tcfg, hw=32), False) == base
    others = [key((2, 16, 8, 3), tcfg, False), key((4, 16, 16, 3), tcfg, False),
              key(shape, _with(tcfg, plane_schedule=SCHEDULES[1]), False),
              key(shape, _with(tcfg, planes=5), False), key(shape, tcfg, True),
              key(shape, _with(tcfg, pad_mode="edge"), False)]
    assert len({base, *others}) == 1 + len(others)


def test_a_graph_cache_refuses_another_parameter_tree(net):
    _, _, tcfg, tparams, x = net
    graphs = unet.ForwardGraphs()
    unet.forward(tparams, x, tcfg, device="cpu", graphs=graphs)
    # the same tensors in another dict are the same parameters
    unet.forward(unet.params_to(tparams, "cpu"), x, tcfg, device="cpu", graphs=graphs)
    other = unet.init_params(1, tcfg, device="cpu")
    with pytest.raises(ValueError, match="another parameter tree"):
        unet.forward(other, x, tcfg, device="cpu", graphs=graphs)
