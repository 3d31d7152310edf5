"""One train step of every LM family against the reference's, on the CPU,
as ``tests/test_archs.py`` runs the reference's (one step per arch at its
smoke config): dense (Yi-6B), moe (OLMoE-1B-7B), vlm (InternVL2, with
patches) and encdec (Whisper, with frames) here; ssm (RWKV6) and hybrid
(Zamba2, S = 256 for the SSD chunks) in ``test_torch_train_recurrent.py``.

The reference's weights come across with ``layers.params_from_numpy``
(each leaf its own dtype); the batch is the data pipeline's (the same in
both packages); the reference step is compiled as its source reads
(``_exact_jit``).  Held: the loss within ``LOSS_REL`` relative, the grad
norm within ``NORM_REL`` relative, the bound ``test_torch_train.py`` holds
each gradient leaf to (the packages part by bf16 roundings; measured: 1.6e-4
to 8.4e-4, and 7.8e-3 on RWKV6, whose float32 ``u`` gradient, a sum over
every step of the recurrence, dominates its norm and takes the bf16
roundings of r, k and v upstream; its WKV gradients alone agree to 2e-7),
the lr exactly, and the float32 master weights moved.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke_config
from repro.models import build as jbuild
from repro.optim import adamw as jadamw
from repro.train import train_step as jts
from repro_torch.checkpoint.ckpt import tree_leaves
from repro_torch.configs import get_smoke_config
from repro_torch.data import pipeline as dp
from repro_torch.models import layers
from repro_torch.optim import adamw
from repro_torch.train import train_step as ts

from test_torch_lm import _exact_jit

LOSS_REL = 1e-3
NORM_REL = 2e-2
ARCHS = ["yi_6b", "olmoe_1b_7b", "internvl2_76b", "whisper_large_v3"]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    torch.set_num_threads(2)


def _batch(cfg):
    extras = {}
    if cfg.family == "vlm":
        extras["patches"] = (cfg.vlm_patches, cfg.d_model)
    if cfg.family == "encdec":
        extras["frames"] = (cfg.enc_seq, cfg.d_model)
    s = 256 if cfg.family == "hybrid" else 64  # the SSD's chunk divisibility
    return dp.get_batch(dp.DataConfig(vocab=cfg.vocab, seq_len=s, global_batch=2, seed=0,
                                      extras=extras or None), 0)


def check_train_step(arch):
    """One step of ``arch``'s smoke config in both packages, held as the
    module's docstring says."""
    jcfg, tcfg = jget_smoke_config(arch), get_smoke_config(arch)
    assert tcfg.family == jcfg.family
    key = jax.random.PRNGKey(0)
    jmod = jbuild(jcfg)
    jparams = (jmod.init_params(key, jcfg, max_dec_pos=512) if jcfg.family == "encdec"
               else jmod.init_params(key, jcfg))
    batch = _batch(tcfg)
    jnew, jm = _exact_jit(lambda st, b: jts.train_step(st, b, jcfg))(
        {"params": jparams, "opt": jadamw.init(jparams)},
        {k: jnp.asarray(v) for k, v in batch.items()})

    tparams = layers.params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    state = {"params": tparams, "opt": adamw.init(tparams)}
    master0 = [t.clone() for t in tree_leaves(state["opt"].master)]
    new, m = ts.train_step(state, batch, tcfg, device="cpu")

    assert np.isfinite(float(m["loss"]))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=LOSS_REL)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=NORM_REL)
    assert float(m["lr"]) == float(jm["lr"])
    moved = [float((a - b).abs().max()) for a, b in zip(tree_leaves(new["opt"].master), master0)]
    assert max(moved) > 0
    for got, want in zip(tree_leaves(new["params"]), jax.tree.leaves(jnew["params"])):
        assert str(got.dtype).removeprefix("torch.") == str(want.dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_equals_the_reference(arch):
    check_train_step(arch)
