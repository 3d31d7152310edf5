"""The port's training path against the reference's, on the CPU: gradients
through the dense LM on every quant route, the train step with and without
microbatches, the trainer's restart, the launcher, and gradients through the
short-query attention.

Model: Yi-6B's smoke config widened as ``test_torch_lm.py`` widens it
(d_model 256, d_ff 512, 4 heads, 2 KV heads, 2 layers, vocab 512), with the
reference's weights carried over through ``transformer.params_from_jax``.
Quant routes: ``none`` (bf16 products), ``mma_int8`` Horner (the
reference's ``xla``) and ``mma_int8`` kernel (the reference's ``pallas`` in
interpret mode; the port's plain version on the CPU).  The reference is
compiled as its source reads (``_exact_jit``).

Tolerances: the loss within ``LOSS_REL`` relative; each gradient leaf within
``GRAD_REL`` of that leaf's largest magnitude.  The packages part by bf16
roundings (RMSNorm's float32 reduction order and XLA's approximate
``rsqrt``, see ``test_torch_lm.py``), which the int8 requantization can turn
into a whole quantization level of one activation; a gradient leaf's
largest elements then move by up to a few parts in a thousand.
"""
import os
import shutil
import subprocess
import sys
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget_smoke_config
from repro.configs.base import QuantConfig as JQuantConfig
from repro.models import layers as jlayers
from repro.models import transformer as jtransformer
from repro.optim import adamw as jadamw
from repro.train import train_step as jts
from repro_torch.checkpoint.ckpt import tree_leaves
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import QuantConfig
from repro_torch.data import pipeline as dp
from repro_torch.launch import train as launch_train
from repro_torch.models import layers, transformer
from repro_torch.optim import adamw
from repro_torch.train import train_step as ts
from repro_torch.train import trainer

from test_torch_lm import WIDE, _exact_jit, _np_tree

LOSS_REL = 1e-3
GRAD_REL = 2e-2
# the reference's quant impl for each of the port's
ROUTES = {"none": ("none", "horner", "xla"), "horner": ("mma_int8", "horner", "xla"),
          "kernel": ("mma_int8", "kernel", "pallas")}
SEQ, BATCH = 64, 2
SRC = Path(__file__).resolve().parent.parent / "src"


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    torch.set_num_threads(2)


def _cfgs(route, **kw):
    mode, impl, jimpl = ROUTES[route]
    jcfg = jget_smoke_config("yi_6b").replace(**WIDE, **kw,
                                              quant=JQuantConfig(mode=mode, impl=jimpl))
    tcfg = get_smoke_config("yi_6b").replace(**WIDE, **kw, quant=QuantConfig(mode=mode, impl=impl))
    return jcfg, tcfg


@pytest.fixture(scope="module")
def weights():
    jparams = jtransformer.init_params(jax.random.PRNGKey(0), _cfgs("none")[0])
    return jparams, _np_tree(jparams)


def _tparams(weights):
    return transformer.params_from_jax(weights[1], device="cpu")


def _batch(microbatches=1, step=0):
    return dp.get_batch(dp.DataConfig(vocab=WIDE["vocab"], seq_len=SEQ,
                                      global_batch=BATCH * microbatches,
                                      microbatches=microbatches, seed=0), step)


def _f32(a) -> np.ndarray:
    return np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a, np.float32)


def _close_leaves(got: list, want: list, rel=GRAD_REL):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g = (g.float() if g.dtype == torch.bfloat16 else g).numpy()
        w = _f32(w)
        assert g.shape == w.shape and np.isfinite(g).all(), i
        scale = float(np.abs(w).max())
        assert scale > 0, i
        err = float(np.abs(g - w).max())
        assert err <= rel * scale, (i, err, scale)


# ------------------------------------------------------ loss and gradients


@pytest.mark.parametrize("route", ["none", "horner", "kernel"])
def test_loss_and_gradients_equal_the_reference(weights, route):
    jcfg, tcfg = _cfgs(route)
    batch = _batch()
    jvg = _exact_jit(jax.value_and_grad(partial(jtransformer.loss_fn, cfg=jcfg), has_aux=True))
    (jloss, jmetrics), jgrads = jvg(weights[0], {"tokens": jnp.asarray(batch["tokens"])})
    tparams = _tparams(weights)
    (loss, metrics), grads = ts.value_and_grad(ts.make_loss_fn(tcfg, device="cpu"), tparams, batch)
    assert not loss.requires_grad and sorted(metrics) == sorted(jmetrics)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_REL)
    leaves = tree_leaves(grads)
    for g, p in zip(leaves, tree_leaves(tparams)):
        assert g.dtype == p.dtype == torch.bfloat16 and g.shape == p.shape
    _close_leaves(leaves, jax.tree.leaves(jgrads))


def test_kernel_route_gradients_equal_the_horner_route(weights):
    """Both routes produce the same int32 products, and the backward is the
    float product's on either: loss and gradients bit for bit."""
    batch, tparams = _batch(), _tparams(weights)
    got = [ts.value_and_grad(ts.make_loss_fn(_cfgs(r)[1], device="cpu"), tparams, batch)
           for r in ("kernel", "horner")]
    assert torch.equal(got[0][0][0], got[1][0][0])
    for a, b in zip(tree_leaves(got[0][1]), tree_leaves(got[1][1])):
        assert torch.equal(a, b)


def test_remat_only_under_grad(weights, monkeypatch):
    """``cfg.remat == "full"`` recomputes each block in the backward when a
    parameter requires grad, and never otherwise; values are the same."""
    calls = []
    inner = transformer._block

    def counting(*a, **kw):
        calls.append(torch.is_grad_enabled())
        return inner(*a, **kw)

    monkeypatch.setattr(transformer, "_block", counting)
    _, tcfg = _cfgs("horner")
    batch, tparams = _batch(), _tparams(weights)
    loss_fn = ts.make_loss_fn(tcfg, device="cpu")
    with torch.no_grad():
        plain, _ = loss_fn(tparams, batch)
    assert len(calls) == tcfg.n_layers
    calls.clear()
    plain_grad, _ = loss_fn(tparams, batch)  # grad mode on, but no leaf requires grad
    assert len(calls) == tcfg.n_layers
    calls.clear()
    (loss, _), grads = ts.value_and_grad(loss_fn, tparams, batch)
    assert len(calls) == 2 * tcfg.n_layers  # forward, then the backward's recompute
    calls.clear()
    (loss_nr, _), grads_nr = ts.value_and_grad(ts.make_loss_fn(tcfg.replace(remat="none"),
                                                               device="cpu"), tparams, batch)
    assert len(calls) == tcfg.n_layers
    assert torch.equal(plain, loss) and torch.equal(plain_grad, loss) and torch.equal(loss, loss_nr)
    for a, b in zip(tree_leaves(grads), tree_leaves(grads_nr)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------- step


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_equals_the_reference(weights, microbatches):
    jcfg, tcfg = _cfgs("kernel", microbatches=microbatches)
    batch = _batch(microbatches)
    jstate = {"params": weights[0], "opt": jadamw.init(weights[0])}
    jnew, jm = _exact_jit(lambda st, b: jts.train_step(st, b, jcfg))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tparams = _tparams(weights)
    state = {"params": tparams, "opt": adamw.init(tparams)}
    master0 = [t.clone() for t in tree_leaves(state["opt"].master)]
    new, m = ts.train_step(state, batch, tcfg, device="cpu")
    assert sorted(m) == ["grad_norm", "loss", "lr"]
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=LOSS_REL)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=GRAD_REL)
    assert float(m["lr"]) == float(jm["lr"])
    assert int(new["opt"].step) == 1
    moved = [float((a - b).abs().max()) for a, b in zip(tree_leaves(new["opt"].master), master0)]
    assert max(moved) > 0
    for p in tree_leaves(new["params"]):
        assert p.dtype == torch.bfloat16
    # the update's size is the reference's: lr-sized steps on the same leaves
    jmoved = [float(jnp.max(jnp.abs(a - b))) for a, b in zip(
        jax.tree.leaves(jnew["opt"].master), jax.tree.leaves(jadamw.init(weights[0]).master))]
    np.testing.assert_allclose(moved, jmoved, rtol=GRAD_REL, atol=1e-7)


def test_microbatch_accumulation_is_float32_then_averaged(weights):
    """Two microbatches: the step's gradient is the float32 sum of each
    microbatch's bf16 gradients, divided by 2 (checked through the
    optimizer's first moment, (1 - b1) * g at step 1, unclipped)."""
    _, tcfg = _cfgs("horner", microbatches=2)
    batch, tparams = _batch(2), _tparams(weights)
    loss_fn = ts.make_loss_fn(tcfg, device="cpu")
    parts = [ts.value_and_grad(loss_fn, tparams, {k: v[i] for k, v in batch.items()})
             for i in range(2)]
    grads = [(a.float() + b.float()) / 2 for a, b in zip(tree_leaves(parts[0][1]),
                                                         tree_leaves(parts[1][1]))]
    state = {"params": tparams, "opt": adamw.init(tparams)}
    new, m = ts.train_step(state, batch, tcfg, device="cpu")
    assert torch.equal(m["loss"], (parts[0][0][0] + parts[1][0][0]) / 2)
    assert torch.equal(m["grad_norm"], adamw.global_norm(grads))
    scale = torch.clamp(1.0 / torch.clamp(m["grad_norm"], min=1e-9), max=1.0)
    for mom, g in zip(tree_leaves(new["opt"].m), grads):
        assert torch.equal(mom, (g * scale) * (1 - 0.9))


# -------------------------------------------------------------- trainer


def _fresh_state(cfg):
    params = transformer.init_params(0, cfg, device="cpu")
    return {"params": params, "opt": adamw.init(params)}


@pytest.mark.parametrize("route", ["none", "kernel"])
def test_trainer_restart_is_bit_deterministic(tmp_path, route):
    """As ``tests/test_checkpoint.py`` holds the reference's: 6 uninterrupted
    steps against 3 steps, a resume from the checkpoint, then 3 more."""
    mode, impl, _ = ROUTES[route]
    cfg = get_smoke_config("yi_6b").replace(quant=QuantConfig(mode=mode, impl=impl))
    dcfg = dp.DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4, seed=11)

    def step_fn(st, b):
        return ts.train_step(st, b, cfg, device="cpu")

    def tc(steps):
        return trainer.TrainerConfig(total_steps=steps, ckpt_every=3, log_every=100,
                                     ckpt_dir=str(tmp_path / "ck"))

    final_a, ma = trainer.train(_fresh_state(cfg), step_fn, dcfg, tc(6), log=lambda *a: None)
    shutil.rmtree(tmp_path / "ck")
    half, _ = trainer.train(_fresh_state(cfg), step_fn, dcfg, tc(3), log=lambda *a: None)
    resumed, start = trainer.resume(half, tc(6))
    assert start == 3 and int(resumed["opt"].step) == 3
    for a, b in zip(tree_leaves(resumed), tree_leaves(half)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    final_b, mb = trainer.train(resumed, step_fn, dcfg, tc(6), start_step=start,
                                log=lambda *a: None)
    assert len(ma["losses"]) == 6 and ma["losses"][3:] == mb["losses"]
    for a, b in zip(tree_leaves(final_a), tree_leaves(final_b)):
        assert torch.equal(a, b)


def test_resume_fresh_and_with_shardings(tmp_path):
    """A fresh start, then a resume onto a mesh (of one rank here; several
    ranks: ``test_torch_distributed.py``)."""
    from repro_torch.checkpoint.ckpt import Checkpointer
    from repro_torch.parallel.sharding import Mesh, NamedSharding, P

    tcfg = trainer.TrainerConfig(ckpt_dir=str(tmp_path / "none"))
    assert trainer.resume({"w": torch.zeros(2)}, tcfg) == (None, 0)
    w = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    Checkpointer(tcfg.ckpt_dir).save(5, {"state": {"w": w}})
    one = NamedSharding(Mesh({"data": 1, "model": 1}, device="cpu"), P("data", "model"))
    got, step = trainer.resume({"w": torch.empty(2, 3, device="meta")}, tcfg,
                               shardings={"w": one})
    assert step == 5 and torch.equal(got["w"], w)


def test_straggler_detection():
    t = trainer.StepTimer()
    for i in range(10):
        t.record(i, 0.1, factor=3.0)
    assert t.record(10, 0.5, factor=3.0) is True
    assert t.record(11, 0.11, factor=3.0) is False
    assert t.flagged == [10]


def test_trainer_flags_a_straggler(tmp_path):
    """A step that takes more than ``watchdog_factor`` x the trailing median
    is logged and returned.  The steps run on a fake clock that each step
    advances by its delay, so the verdict does not depend on the host's load."""
    dcfg = dp.DataConfig(vocab=16, seq_len=4, global_batch=2)
    delays = [0.0] * 6 + [0.05] + [0.0]
    lines = []
    now = [0.0]

    def step_fn(st, b):
        now[0] += delays[int(st["n"])] + 0.002
        return {"n": st["n"] + 1}, {"loss": torch.tensor(float(b["tokens"].sum()))}

    tcfg = trainer.TrainerConfig(total_steps=8, ckpt_every=100, log_every=4,
                                 ckpt_dir=str(tmp_path / "ck"))
    _, m = trainer.train({"n": torch.tensor(0)}, step_fn, dcfg, tcfg, log=lines.append,
                         clock=lambda: now[0])
    assert m["stragglers"] == [6]
    assert any(line.startswith("[straggler] step 6") for line in lines)
    assert m["losses"] == [float(dp.get_batch(dcfg, s)["tokens"].sum()) for s in range(8)]


# ------------------------------------------------- the embedding gradient


def test_embedding_gradient_sums_in_float32_where_the_reference_rounds_per_add():
    """A deliberate departure from the reference.  On a skewed batch (4,096
    Zipf tokens, one of them a quarter of the batch) the reference's gradient
    of ``jnp.take`` (a bf16 scatter-add) rounds after every add, bit-equal to
    torch's stock index backward, and lands a few percent from the exact
    sum.  The port's ``layers.embed`` sums each row in float32 and rounds
    once: within one bf16 rounding of the exact sum."""
    rng = np.random.default_rng(0)
    vocab, d, t = 64, 32, 4096
    tok = rng.zipf(1.3, size=t) % vocab
    tok[: t // 4] = 3
    rng.shuffle(tok)
    table = torch.tensor(rng.standard_normal((vocab, d)) * 0.02, dtype=torch.float32
                         ).to(torch.bfloat16)
    g = torch.tensor(rng.standard_normal((t, d)), dtype=torch.float32).to(torch.bfloat16)
    tok_t = torch.tensor(tok)

    def ref_loss(tb, tk, gb):
        return jnp.sum(jlayers.embed({"table": tb}, tk).astype(jnp.float32) * gb.astype(jnp.float32))

    to_j = lambda x: jnp.asarray(x.float().numpy(), jnp.bfloat16)  # noqa: E731
    ref = np.asarray(jax.jit(jax.grad(ref_loss))(to_j(table), jnp.asarray(tok), to_j(g))
                     .astype(jnp.float32))
    tp = table.clone().requires_grad_()
    (layers.embed({"table": tp}, tok_t).float() * g.float()).sum().backward()
    port = tp.grad.float().numpy()
    ts_ = table.clone().requires_grad_()
    (ts_[tok_t].float() * g.float()).sum().backward()
    stock = ts_.grad.float().numpy()

    exact = np.zeros((vocab, d))
    np.add.at(exact, tok, g.double().numpy())
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(exact), 1e-30))) - 7)  # bf16: 8 bits
    assert np.array_equal(ref, stock)  # the reference rounds per add
    assert np.all(np.abs(port - exact) <= 0.5 * ulp + 1e-6 * np.abs(exact))
    scale = np.abs(exact).max()
    assert np.abs(ref - exact).max() / scale > 1e-2
    assert np.abs(port - exact).max() / scale < 4e-3


# ------------------------------------------------------------- launcher


def test_launcher_runs_and_resumes_on_the_cpu(tmp_path, capsys):
    args = ["--smoke", "--device", "cpu", "--seq", "16", "--batch", "2", "--ckpt-every", "1",
            "--ckpt-dir", str(tmp_path / "ck")]
    launch_train.main(args + ["--steps", "2"])
    out = capsys.readouterr().out
    assert "step 0 loss" in out and "final loss" in out and "resumed" not in out
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "LATEST", "step_000000001", "step_000000002"]
    launch_train.main(args + ["--steps", "3", "--resume", "--quant", "mma_int8"])
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and "final loss" in out
    assert (tmp_path / "ck" / "LATEST").read_text() == "step_000000003"


def test_launcher_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        launch_train.main(["--smoke", "--steps", "1"])


def test_training_modules_import_no_jax():
    code = ("import sys; import repro_torch.data, repro_torch.optim, repro_torch.train, "
            "repro_torch.launch.train; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') or m == 'repro' "
            "or m.startswith('repro.')]; assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    subprocess.run([sys.executable, "-c", code], env=env, check=True, timeout=120)


# ------------------------------------------------- short-query attention


@pytest.mark.parametrize("offsets", [[5, 20], [5, 6]])
def test_short_query_attention_gradient_equals_the_reference(offsets):
    """s <= 8: gradients through the unchunked pass, the max held out of the
    gradient as the reference's ``stop_gradient`` holds it.  Offsets [5, 20]
    with a window of 3 leave batch row 1 with no key at all: its output is
    NaN in both packages, the loss reads only finite outputs, and q's and
    k's gradients have no NaN; v's is NaN on that row's keys exactly where
    the reference's is (its NaN probabilities times a zero gradient)."""
    rng = np.random.default_rng(0)
    b, s, h, kv, d, t = 2, 4, 4, 2, 16, 8
    q, w = rng.standard_normal((b, s, h, d)), rng.standard_normal((b, s, h, d))
    k, v = rng.standard_normal((b, t, kv, d)), rng.standard_normal((b, t, kv, d))
    q, k, v, w = (a.astype(np.float32) for a in (q, k, v, w))
    off = np.asarray(offsets, np.int32)

    def jloss(q, k, v):
        o = jlayers.flash_attention(q, k, v, window=3, q_offset=jnp.asarray(off))
        return jnp.sum(jnp.where(jnp.isnan(o), 0.0, o) * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = layers.flash_attention(tq, tk, tv, window=3, q_offset=torch.from_numpy(off))
    assert bool(torch.isnan(o[1]).all()) == (offsets[1] == 20)
    got = torch.autograd.grad(torch.sum(torch.where(torch.isnan(o), 0.0, o) * torch.from_numpy(w)),
                              (tq, tk, tv))
    for name, g, jg in zip("qkv", got, want):
        g, jg = g.numpy(), np.asarray(jg)
        np.testing.assert_array_equal(np.isnan(g), np.isnan(jg))
        if name != "v":
            assert not np.isnan(g).any()
        np.testing.assert_allclose(np.nan_to_num(g), np.nan_to_num(jg), rtol=0, atol=2e-6)
