"""Remat in the ssm, hybrid and encdec families' forwards, on the CPU: the
port rematerialises exactly the bodies the reference wraps in
``jax.checkpoint`` under ``cfg.remat == "full"`` (one RWKV6 block; one
Mamba2 layer of a Zamba2 group or of the tail, not the shared block; one
Whisper encoder block and one decoder block), only where a gradient is
taken, and the gradients are bit-equal with remat on and off, on the bf16
route and on the Horner route of ``mma_int8``.  On the Horner route both
equal the reference's (``jax.value_and_grad`` of its loss, remat on, compiled as
its source reads) within ``test_torch_train_families.py``'s bounds for
these families: the loss within ``LOSS_REL`` and the gradients' global norm
within ``NORM_REL``, relative.  (Leaf by leaf they part by bf16 roundings:
up to 2e-2 of a leaf's largest element on RWKV6 and Whisper, 6e-2 on
Zamba2, whose int8 levels at S = 256 move with single roundings; see
``test_torch_zamba2.py``.)

Models: each family's smoke config with the reference's weights carried
over (``layers.params_from_numpy``); the batch is the data pipeline's (S = 256 for
Zamba2's SSD chunk, Whisper's frames as an extra).
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke_config
from repro.configs.base import QuantConfig as JQuantConfig
from repro.models import build as jbuild
from repro_torch.checkpoint.ckpt import tree_leaves
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import QuantConfig
from repro_torch.models import layers, mamba2, rwkv6, whisper
from repro_torch.train import train_step as ts

from test_torch_lm import _exact_jit
from test_torch_train_families import LOSS_REL, NORM_REL, _batch

ARCHS = ["rwkv6_3b", "zamba2_7b", "whisper_large_v3"]
# the reference's quant impl for each of the port's
ROUTES = {"none": ("none", "horner", "xla"), "horner": ("mma_int8", "horner", "xla")}
# the rematerialised bodies: (module, function) and their count per forward
BODIES = {"rwkv6_3b": [(rwkv6, "block")], "zamba2_7b": [(mamba2, "mamba_forward")],
          "whisper_large_v3": [(whisper, "enc_block"), (whisper, "dec_block")]}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    torch.set_num_threads(2)


def _cfgs(arch, route):
    mode, impl, jimpl = ROUTES[route]
    return (jget_smoke_config(arch).replace(quant=JQuantConfig(mode=mode, impl=jimpl)),
            get_smoke_config(arch).replace(quant=QuantConfig(mode=mode, impl=impl)))


def _bodies_per_forward(cfg) -> int:
    if cfg.family == "encdec":
        return cfg.enc_layers + cfg.n_layers
    return cfg.n_layers  # every Zamba2 layer is a Mamba2 layer


@pytest.mark.parametrize("route", ["none", "horner"])
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gradients_are_bit_equal_and_equal_the_reference(arch, route, monkeypatch):
    jcfg, tcfg = _cfgs(arch, route)
    jmod = jbuild(jcfg)
    key = jax.random.PRNGKey(0)
    jparams = (jmod.init_params(key, jcfg, max_dec_pos=512) if jcfg.family == "encdec"
               else jmod.init_params(key, jcfg))
    batch = _batch(tcfg)
    assert jcfg.remat == tcfg.remat == "full"

    calls = []
    for mod, name in BODIES[arch]:
        inner = getattr(mod, name)

        def counting(*a, inner=inner, **kw):
            calls.append(torch.is_grad_enabled())
            return inner(*a, **kw)

        monkeypatch.setattr(mod, name, counting)
    tparams = layers.params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    n = _bodies_per_forward(tcfg)
    with torch.no_grad():
        plain, _ = ts.make_loss_fn(tcfg, device="cpu")(tparams, batch)
    assert len(calls) == n
    calls.clear()
    got = {}
    for remat in ("full", "none"):
        loss_fn = ts.make_loss_fn(tcfg.replace(remat=remat), device="cpu")
        got[remat] = ts.value_and_grad(loss_fn, tparams, batch)
        # remat: the forward, then the backward's recompute of each body
        assert len(calls) == (2 * n if remat == "full" else n), (remat, len(calls))
        calls.clear()
    (loss, _), grads = got["full"]
    (loss_nr, _), grads_nr = got["none"]
    assert torch.equal(loss, loss_nr) and torch.equal(loss, plain)
    for a, b in zip(tree_leaves(grads), tree_leaves(grads_nr)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    if route == "none":  # the reference's compile is the slow part: one route is held
        return
    jvg = _exact_jit(jax.value_and_grad(partial(jmod.loss_fn, cfg=jcfg), has_aux=True))
    (jloss, _), jgrads = jvg(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_REL)
    norm = sum(float(torch.sum(g.float() ** 2)) for g in tree_leaves(grads)) ** 0.5
    jnorm = sum(float(jnp.sum(jnp.asarray(g, jnp.float32) ** 2))
                for g in jax.tree.leaves(jgrads)) ** 0.5
    np.testing.assert_allclose(norm, jnorm, rtol=NORM_REL)
