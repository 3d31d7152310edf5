"""Moonlight-16B-A3B (DeepSeek-V3's block) in the port against the plain
reference ``tests/_ref_mla_moe.py``, on seeded random weights at the smoke
size (d_model 128, 4 heads, latent 32, 16 experts top-4 with 2 shared, one
leading dense layer of 3): latent attention, the held-expert layer
(routing, dropless dispatch, the shares of an expert-parallel deployment),
the balance loss, the selection bias's update and two train steps.

The program and the reference make the same roundings in the same order
up to the order of a few sums, so losses and logits come out equal here.
Gradients are held per leaf to 3e-2 of the reference's norm: each package
builds its own backward graph, and the bf16 gradients flowing between
layers are rounded at other places (0.3-1.5% seen); one layer's weight
gradients, with no bf16 gradient between, are held to 1e-6.
"""
from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.checkpoint.ckpt import tree_leaves
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.configs.base import QuantConfig
from repro_torch.models import layers, moe, transformer
from repro_torch.obs import timeline
from repro_torch.optim import adamw
from repro_torch.train import train_step as ts

TESTS = Path(__file__).resolve().parent
sys.path.insert(0, str(TESTS))
import _ref_mla_moe as ref  # noqa: E402

ROUTES = [("none", "horner"), ("mma_int8", "horner")]


def smoke(mode="none", impl="horner", **moe_kw):
    cfg = get_smoke_config("moonlight_16b_a3b").replace(quant=QuantConfig(mode=mode, impl=impl))
    return cfg.replace(moe=dataclasses.replace(cfg.moe, **moe_kw)) if moe_kw else cfg


def arch_of(cfg) -> dict:
    """The reference's arguments for a port config."""
    m = cfg.moe
    return dict(n_layers=cfg.n_layers, first_dense=m.first_dense, d_model=cfg.d_model,
                n_heads=cfg.n_heads, kv_lora_rank=cfg.kv_lora_rank, qk_nope_dim=cfg.qk_nope_dim,
                qk_rope_dim=cfg.qk_rope_dim, v_head_dim=cfg.v_head_dim,
                rope_theta=cfg.rope_theta, norm_eps=cfg.norm_eps, n_experts=m.n_experts,
                top_k=m.top_k, held=m.held, held_first=m.held_first,
                routed_scale=m.routed_scale, aux_coef=m.aux_coef, bias_rate=m.bias_rate,
                attn_block=cfg.attn_chunk)


def qmax_of(cfg):
    return None if cfg.quant.mode == "none" else 127


def tokens(cfg, b=2, s=64, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab, (b, s + 1), generator=g)


def bias_of(cfg, seed=1, scale=0.01):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((cfg.n_layers - cfg.moe.first_dense, cfg.moe.n_experts), generator=g) * scale


def rel(a, b) -> float:
    b = b.to(torch.float32)
    return float((a.to(torch.float32) - b).norm() / b.norm().clamp(min=1e-30))


# ------------------------------------------------------------------- config


def test_config_is_the_published_model():
    cfg = get_config("moonlight_16b_a3b")
    assert "moonlight_16b_a3b" in ARCH_IDS
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.vocab, cfg.d_ff) == (
        27, 2048, 16, 163_840, 11_264)
    assert (cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim) == (
        512, 128, 64, 128)
    m = cfg.moe
    assert (m.n_experts, m.top_k, m.expert_ff, m.n_shared, m.first_dense) == (64, 6, 1408, 2, 1)
    assert (m.routed_scale, m.held, m.held_first) == (2.446, 64, 0)
    assert (m.aux_coef, m.bias_rate, cfg.rope_theta, cfg.norm_eps) == (0.001, 0.001, 5e4, 1e-5)


def test_one_cards_share_holds_2_78_billion_parameters():
    """8 of 64 experts and an eighth of the vocabulary (the benchmark's
    cut), counted on the meta device."""
    cfg = get_config("moonlight_16b_a3b")
    cfg = cfg.replace(vocab=20_480, moe=dataclasses.replace(cfg.moe, held=8))
    p = transformer.init_params(0, cfg, device="meta")
    n = sum(t.numel() for t in tree_leaves(p))
    blk = layers.layer_params(p["blocks"], 0)
    attn = sum(t.numel() for t in tree_leaves(blk["attn"]))
    held = sum(blk["moe"][k].numel() for k in ("w_gate", "w_up", "w_down"))
    shared = sum(t.numel() for t in tree_leaves(blk["moe"]["shared"]))
    assert (attn, blk["moe"]["router"]["w"].numel(), held, shared) == (
        13_763_072, 131_072, 69_206_016, 17_301_504)
    assert p["blocks"]["moe"]["w_gate"].shape == (26, 8, 2048, 1408)
    assert p["dense_blocks"]["mlp"]["w_up"]["w"].shape == (1, 2048, 11_264)
    assert 2.77e9 < n < 2.79e9


# -------------------------------------------------------------- attention


@pytest.mark.parametrize("s, chunk", [(4, 16), (40, 16)])
def test_flash_attention_with_a_value_dim_of_its_own(s, chunk):
    """q and k of 24, v of 16 (MLA's 192 and 128): the short-query and the
    chunked paths against a plain softmax at 1/sqrt(24)."""
    g = torch.Generator().manual_seed(s)
    q, k = (torch.randn((2, s, 3, 24), generator=g).to(torch.bfloat16) for _ in range(2))
    v = torch.randn((2, s, 3, 16), generator=g).to(torch.bfloat16)
    out = layers.flash_attention(q, k, v, causal=True, chunk=chunk)
    sc = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) / 24 ** 0.5
    sc = sc.masked_fill(torch.ones(s, s, dtype=torch.bool).triu(1), -torch.inf)
    want = torch.einsum("bhst,bthd->bshd", torch.softmax(sc, -1), v.float())
    assert out.shape == (2, s, 3, 16)
    assert float((out.float() - want).abs().max()) < 2e-2


# ------------------------------------------------------------ whole model


@pytest.mark.parametrize("mode, impl", ROUTES)
def test_forward_logits_equal_the_reference(mode, impl):
    cfg = smoke(mode, impl)
    p = transformer.init_params(3, cfg, device="cpu")
    tok, bias = tokens(cfg)[:, :-1], bias_of(cfg)
    got = transformer.forward(p, tok, cfg, router_bias=bias, device="cpu").to(torch.float32)
    want, _, _ = ref.forward(p, tok, arch_of(cfg), bias, qmax_of(cfg))
    # one bf16 ulp of the largest logit: the two combine their experts'
    # outputs in other orders (float64 against float32)
    assert float((got - want).abs().max()) <= 2**-8 * float(want.abs().max())


@pytest.mark.parametrize("mode, impl", ROUTES)
def test_loss_and_every_gradient_equal_the_reference(mode, impl):
    cfg = smoke(mode, impl)
    p = transformer.init_params(4, cfg, device="cpu")
    tok, bias = tokens(cfg, seed=2), bias_of(cfg, seed=3)
    (loss, metrics), grads = ts.value_and_grad(
        ts.make_loss_fn(cfg, device="cpu", router_bias=bias), p, {"tokens": tok})
    live = [t.detach().requires_grad_() for t in tree_leaves(p)]
    with torch.enable_grad():
        want, counts = ref.loss(ref.unflatten(p, live), tok, arch_of(cfg), bias, qmax_of(cfg))
        wgrads = torch.autograd.grad(want, live)
    assert abs(float(loss) - float(want)) <= 1e-5 * abs(float(want))
    assert torch.equal(metrics["expert_counts"], counts)
    assert float(metrics["aux"]) > 0
    for g, w in zip(tree_leaves(grads), wgrads):
        assert g.dtype == w.dtype == torch.bfloat16 and float(w.float().norm()) > 0
        assert rel(g, w) < 3e-2


@pytest.mark.parametrize("mode, impl", ROUTES)
def test_one_expert_layers_gradients_equal_the_reference(mode, impl):
    cfg = smoke(mode, impl)
    p = layers.layer_params(transformer.init_params(5, cfg, device="cpu")["blocks"], 0)["moe"]
    g = torch.Generator().manual_seed(6)
    x = torch.randn((2, 64, cfg.d_model), generator=g).to(torch.bfloat16)
    dy = torch.randn((2, 64, cfg.d_model), generator=g).to(torch.bfloat16)
    bias = bias_of(cfg)[0]

    def run(fn):
        live = [t.detach().requires_grad_() for t in tree_leaves(p)]
        with torch.enable_grad():
            y, bal, counts = fn(ref.unflatten(p, live), x)
            grads = torch.autograd.grad((y.float() * dy.float()).sum() + bal, live)
        return y, bal, counts, grads

    y, bal, counts, grads = run(lambda pp, xx: moe.moe_held(pp, xx, cfg, bias))
    wy, wbal, wcounts, wgrads = run(lambda pp, xx: ref.moe(pp, xx, bias, arch_of(cfg),
                                                          qmax_of(cfg)))
    assert torch.equal(counts, wcounts) and int(counts.sum()) == 2 * 64 * cfg.moe.top_k
    assert float(bal) == float(wbal)
    assert float((y.float() - wy.float()).abs().max()) <= 2**-8 * float(wy.float().abs().max())
    for a, b in zip(grads, wgrads):
        assert rel(a, b) < 1e-6


# ---------------------------------------------------------------- routing


def test_the_bias_selects_and_weighs_nothing():
    cfg = smoke()
    m = cfg.moe
    g = torch.Generator().manual_seed(7)
    logits = torch.randn((32, m.n_experts), generator=g)
    bias = torch.zeros(m.n_experts)
    bias[13] = 10.0  # every token picks expert 13
    scores, idx, gates = moe.route_sigmoid(logits, bias, m)
    assert bool((idx == 13).any(dim=1).all())
    want = torch.gather(torch.sigmoid(logits), 1, idx)
    assert torch.equal(gates, want / (want.sum(-1, keepdim=True) + 1e-20) * m.routed_scale)
    assert torch.allclose(gates.sum(-1), torch.full((32,), m.routed_scale))
    # the rest are the top-(k-1) by score alone
    plain = torch.sort(torch.sigmoid(logits).masked_fill(
        torch.arange(m.n_experts) == 13, -1.0), dim=-1, descending=True, stable=True)[1]
    assert torch.equal(idx[:, 1:], plain[:, :m.top_k - 1])
    rs, ridx, rg = ref.route(logits, torch.eye(m.n_experts), bias, arch_of(cfg))
    assert torch.equal(ridx, idx) and torch.equal(rg, gates) and torch.equal(rs, scores)


def test_ties_go_to_the_lower_index():
    m = smoke().moe
    logits = torch.zeros((5, m.n_experts))
    _, idx, gates = moe.route_sigmoid(logits, None, m)
    assert torch.equal(idx, torch.arange(m.top_k).expand(5, -1))
    assert torch.allclose(gates, torch.full((5, m.top_k), m.routed_scale / m.top_k))
    bias = torch.zeros(m.n_experts)
    bias[[9, 11]] = 0.5  # two equal winners, then the tie among the rest
    _, idx, _ = moe.route_sigmoid(logits, bias, m)
    assert idx[0].tolist() == [9, 11] + list(range(m.top_k - 2))


def test_no_assignment_is_dropped_under_imbalance():
    """Every token sent to two experts (a bias of 5): each held expert's
    products run at its real row count, and nothing is dropped."""
    cfg = smoke("mma_int8", "horner")
    p = layers.layer_params(transformer.init_params(8, cfg, device="cpu")["blocks"], 1)["moe"]
    x = torch.randn((1, 96, cfg.d_model), generator=torch.Generator().manual_seed(9)).to(
        torch.bfloat16)
    bias = torch.zeros(cfg.moe.n_experts)
    bias[[2, 5]] = 5.0
    with timeline.recording() as rec:
        y, _, counts = moe.moe_held(p, x, cfg, bias)
    assert counts[2] == counts[5] == 96
    c = rec.counts
    assert c["moe.dropped"] == 0 and c["moe.count_reads"] == 1 and c["moe.calls"] == 1
    assert c["moe.expert_rows"] == c["moe.held_assignments"] == c["moe.assignments"] == 96 * 4
    assert c["moe.expert_calls"] == int((counts > 0).sum())
    wy, _, _ = ref.moe(p, x, bias, arch_of(cfg), 127)
    assert float((y.float() - wy.float()).abs().max()) <= 2**-8 * float(wy.float().abs().max())


def test_the_bias_moves_by_the_sign_rule():
    counts = torch.tensor([[5, 3, 3, 1], [2, 2, 2, 2]])
    bias = torch.tensor([[0.5, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0]])
    out = ts.update_router_bias(bias, counts, 0.001)
    assert torch.equal(out, torch.tensor([[0.499, 0.0, 0.0, 0.001], [0.0, 0.0, 0.0, 0.0]]))
    assert torch.equal(out, ref.bias_update(bias, counts, 0.001))


# ------------------------------------------------------------ the shares


@pytest.mark.parametrize("mode, impl", ROUTES)
def test_eight_shares_add_up_to_the_whole_layer(mode, impl):
    """Each of 8 ranks holds 2 of the 16 experts: their routed parts, plus
    the shared experts once, give the uncut reference's whole layer."""
    whole = smoke(mode, impl)
    p = layers.layer_params(transformer.init_params(10, whole, device="cpu")["blocks"], 0)["moe"]
    x = torch.randn((2, 48, whole.d_model), generator=torch.Generator().manual_seed(11)).to(
        torch.bfloat16)
    bias = bias_of(whole)[1]
    total = layers.mlp(p["shared"], x, whole).to(torch.float32)
    for r in range(8):
        cfg = smoke(mode, impl, held=2, held_first=2 * r, n_shared=0)
        part = {"router": p["router"],
                **{k: p[k][2 * r:2 * r + 2] for k in ("w_gate", "w_up", "w_down")}}
        y, _, counts = moe.moe_held(part, x, cfg, bias)
        total = total + y.to(torch.float32)
    want, _, _ = ref.moe(p, x, bias, arch_of(whole), qmax_of(whole))
    # 8 partial outputs each rounded to bf16 once: a few ulps of the largest
    assert float((total - want.float()).abs().max()) <= 2**-6 * float(want.float().abs().max())


# ------------------------------------------------------------- training


def test_two_train_steps_equal_the_reference():
    cfg = smoke("mma_int8", "horner")
    p = transformer.init_params(12, cfg, device="cpu")
    start = [t.clone() for t in tree_leaves(p)]
    batches = [tokens(cfg, seed=20 + i) for i in range(2)]
    state = {"params": p, "opt": adamw.init(p),
             "router_bias": transformer.init_router_bias(cfg, device="cpu")}
    losses = []
    for b in batches:
        state, m = ts.train_step(state, {"tokens": b}, cfg, device="cpu")
        losses.append(float(m["loss"]))
    opt = dict(peak_lr=3e-4, warmup=100, total=10_000, b1=0.9, b2=0.95, eps=1e-8,
               weight_decay=0.1, clip_norm=1.0)
    want = ref.train(ref.unflatten(p, [t.clone() for t in start]), [b[None] for b in batches],
                     arch_of(cfg), opt)
    assert losses[0] == pytest.approx(want["losses"][0], rel=1e-6)
    assert losses[1] == pytest.approx(want["losses"][1], rel=1e-3)
    assert state["router_bias"].abs().max() == pytest.approx(2e-3)
    # step 2 routes on weights one step apart by rounding: a near tie may part
    differ = (state["router_bias"] != want["bias"]).float().mean()
    assert float(differ) <= 0.05
    for mast, s0, w in zip(tree_leaves(state["opt"].master), start, want["change"]):
        assert float((mast - s0.float()).norm()) == pytest.approx(w, rel=3e-2)


def test_the_launcher_trains_the_smoke_model(tmp_path, capsys):
    from repro_torch.launch import train

    train.main(["--arch", "moonlight_16b_a3b", "--smoke", "--steps", "2", "--seq", "32",
                "--batch", "2", "--device", "cpu", "--ckpt-dir", str(tmp_path),
                "--quant", "mma_int8"])
    assert "final loss" in capsys.readouterr().out


# ---------------------------------------------------------------- tracing


def test_spans_and_counters_fire_and_nothing_is_dropped():
    cfg = smoke("mma_int8", "horner")
    p = transformer.init_params(13, cfg, device="cpu")
    state = {"params": p, "opt": adamw.init(p),
             "router_bias": transformer.init_router_bias(cfg, device="cpu")}
    with timeline.recording() as rec:
        ts.train_step(state, {"tokens": tokens(cfg, b=1, s=48)}, cfg, device="cpu")
    names = {s.name for s in rec.spans}
    assert {"moe.route", "moe.dispatch", "moe.experts", "moe.shared", "moe.combine",
            "mla.attention"} <= names
    c, n_moe = rec.counts, cfg.n_layers - cfg.moe.first_dense
    # remat: each MoE layer's forward runs again in the backward
    assert c["moe.calls"] == c["moe.count_reads"] == 2 * n_moe
    assert c["moe.dropped"] == 0
    assert c["moe.assignments"] == 2 * n_moe * 48 * cfg.moe.top_k
    assert c["moe.expert_rows"] == c["moe.held_assignments"] == c["moe.assignments"]
    assert 0 < c["moe.expert_calls"] <= 2 * n_moe * cfg.moe.held
    assert len(rec.named("mla.attention")) == 2 * cfg.n_layers


def test_other_moe_configs_keep_their_layer(monkeypatch):
    """OLMoE's smoke model never reaches the held-expert layer and keeps
    its tree (no shared experts, no dense blocks, no bias)."""
    cfg = get_smoke_config("olmoe_1b_7b")
    assert cfg.moe.held == 0 and transformer.init_router_bias(cfg) is None
    p = transformer.init_params(0, cfg, device="cpu")
    assert "dense_blocks" not in p and "shared" not in p["blocks"]["moe"]

    def boom(*a, **kw):
        raise AssertionError("the held-expert layer ran")

    monkeypatch.setattr(moe, "moe_held", boom)
    transformer.loss_fn(p, {"tokens": tokens(cfg, b=1, s=16)}, cfg, device="cpu")


def test_the_benchmarks_reference_is_this_reference():
    frozen = TESTS.parent / "perfbench" / "reference" / "mla_moe_qat.py"
    assert frozen.read_bytes() == (TESTS / "_ref_mla_moe.py").read_bytes()
