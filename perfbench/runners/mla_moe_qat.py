"""Runner of quantization-aware training of a DeepSeek-V3 block model
(Moonlight-16B-A3B): latent attention, sigmoid-routed experts with shared
ones, of which the card holds its share of an expert-parallel deployment.

It drives the same loop as ``runners/lm_qat.py`` (set-up's checked steps,
the window's synchronised steps, the harness's span around the optimizer)
through ``repro_torch.train.train_step``, whose state here also holds the
selection bias.  The configuration file holds the published config's keys
as the catalog gives them, with the card's cut (``n_routed_experts``: the
experts held; ``vocab_size``: the slice) and the published counts beside
them under ``published``.

The experts' row counts depend on the routing, so a traced window records
the shapes of the MMA kernel's launches as they are made (the program's
``kernels.mma_matmul._launch``, wrapped while the window runs): they are
``mma_launches``, and a step's least time counts the held experts' routed
rows from them.

After the window the state is freed and the plain reference
(``reference/mla_moe_qat.py``) trains from the same weights on the same
tokens.
"""
from __future__ import annotations

import dataclasses
import gc

import torch

from perfbench.reference import mla_moe_qat as ref
from perfbench.roofline import (BF16_FLOPS_PER_S, F32_FLOPS_PER_S, INT8_OPS_PER_S,
                                mma_tc_horner_kernel as mma)
from perfbench.runners.lm_qat import LMQat, draw_leaf

#: What the program implements of the published config; another value is refused.
IMPLEMENTED = {"q_lora_rank": None, "scoring_func": "sigmoid", "topk_method": "noaux_tc",
               "norm_topk_prob": True, "hidden_act": "silu", "n_group": 1, "topk_group": 1,
               "moe_layer_freq": 1, "attention_bias": False, "tie_word_embeddings": False,
               "seq_aux": True, "num_nextn_predict_layers": 0}


def model_of(config: dict) -> dict:
    """The model's sizes under the program's names, from the published
    keys and the card's cut."""
    for k, v in IMPLEMENTED.items():
        if config[k] != v:
            raise ValueError(f"{k} = {config[k]!r}: the program implements {v!r}")
    if config["num_key_value_heads"] != config["num_attention_heads"]:
        raise ValueError("latent attention has one key and value per head")
    t = config["training"]
    return {
        "n_layers": config["num_hidden_layers"], "first_dense": config["first_k_dense_replace"],
        "d_model": config["hidden_size"], "n_heads": config["num_attention_heads"],
        "kv_lora_rank": config["kv_lora_rank"], "qk_nope_dim": config["qk_nope_head_dim"],
        "qk_rope_dim": config["qk_rope_head_dim"], "v_head_dim": config["v_head_dim"],
        "d_ff": config["intermediate_size"], "expert_ff": config["moe_intermediate_size"],
        "n_experts": config["published"]["n_routed_experts"],
        "held": config["n_routed_experts"], "held_first": config["held_first"],
        "top_k": config["num_experts_per_tok"], "n_shared": config["n_shared_experts"],
        "routed_scale": config["routed_scaling_factor"], "vocab": config["vocab_size"],
        "rope_theta": float(config["rope_theta"]), "norm_eps": config["rms_norm_eps"],
        "aux_coef": t["aux_coef"], "bias_rate": t["bias_rate"],
        "microbatches": t["microbatches"], "remat": t["remat"], "attn_chunk": t["attn_chunk"],
        "attn_block": t["attn_block"],
    }


def param_shapes(a: dict) -> dict:
    """The model's parameter tree of (shape, init) pairs (the program's
    tree): the leading dense layers and the MoE layers each stacked on
    axis 0."""
    d, h, nd = a["d_model"], a["n_heads"], a["first_dense"]
    n, e, f = a["n_layers"] - nd, a["held"], a["expert_ff"]
    dq, dv, r, dr = a["qk_nope_dim"] + a["qk_rope_dim"], a["v_head_dim"], a["kv_lora_rank"], \
        a["qk_rope_dim"]

    def lin(layers, k, m):
        return {"w": ((layers, k, m), "dense")}

    def attn(layers):
        return {"wq": lin(layers, d, h * dq), "wkv_a": lin(layers, d, r + dr),
                "kv_norm": {"scale": ((layers, r), "ones")},
                "wkv_b": lin(layers, r, h * (a["qk_nope_dim"] + dv)), "wo": lin(layers, h * dv, d)}

    def swiglu(layers, width):
        return {"w_gate": lin(layers, d, width), "w_up": lin(layers, d, width),
                "w_down": lin(layers, width, d)}

    def norms(layers):
        return {"ln1": {"scale": ((layers, d), "ones")}, "ln2": {"scale": ((layers, d), "ones")}}

    return {
        "embed": {"table": ((a["vocab"], d), "embed")},
        "dense_blocks": {**norms(nd), "attn": attn(nd), "mlp": swiglu(nd, a["d_ff"])},
        "blocks": {**norms(n), "attn": attn(n), "moe": {
            "router": lin(n, d, a["n_experts"]),
            "w_gate": ((n, e, d, f), "dense"), "w_up": ((n, e, d, f), "dense"),
            "w_down": ((n, e, f, d), "dense"),
            "shared": swiglu(n, a["n_shared"] * f)}},
        "ln_f": {"scale": ((d,), "ones")},
        "head": {"w": ((d, a["vocab"]), "dense")},
    }


def draw_params(arch: dict, seed: int, dev) -> dict:
    spec = param_shapes(arch)
    flat = [draw_leaf(seed, i, s, init, dev) for i, (s, init) in enumerate(ref.leaves(spec))]
    return ref.unflatten(spec, flat)


class MlaMoeQat(LMQat):
    def __init__(self, config: dict, mix: dict, seed: int, dev: torch.device, spans):
        self.arch, self.q, self.opt = model_of(config), config["quant"], config["optimizer"]
        self.limits, self.config = config["check"], config
        self.mix, self.seed, self.dev, self.spans = mix, int(seed), dev, spans
        self.first_steps = int(mix["checked_steps"])
        self.tokens_per_step = int(mix["global_batch"]) * int(mix["seq_len"])
        if int(mix["microbatches"]) != self.arch["microbatches"]:
            raise ValueError("the mix and the configuration split a step differently")

    def program_config(self):
        from repro_torch.configs import get_config
        from repro_torch.configs.base import QuantConfig

        a = self.arch
        cfg = get_config(self.config["arch"])
        cfg = cfg.replace(
            n_layers=a["n_layers"], d_model=a["d_model"], n_heads=a["n_heads"],
            n_kv_heads=a["n_heads"], d_ff=a["d_ff"], vocab=a["vocab"],
            kv_lora_rank=a["kv_lora_rank"], qk_nope_dim=a["qk_nope_dim"],
            qk_rope_dim=a["qk_rope_dim"], v_head_dim=a["v_head_dim"],
            rope_theta=a["rope_theta"], norm_eps=a["norm_eps"], act="swiglu",
            moe=dataclasses.replace(
                cfg.moe, n_experts=a["n_experts"], top_k=a["top_k"], expert_ff=a["expert_ff"],
                held=a["held"], held_first=a["held_first"], n_shared=a["n_shared"],
                routed_scale=a["routed_scale"],
                first_dense=a["first_dense"], aux_coef=a["aux_coef"],
                bias_rate=a["bias_rate"]),
            microbatches=a["microbatches"], remat=a["remat"], attn_chunk=a["attn_chunk"],
            quant=QuantConfig(mode=self.q["mode"], impl=self.q["impl"], planes=self.q["planes"]))
        if cfg.dtype != "bfloat16" or cfg.tie_embeddings or cfg.family != "moe":
            raise ValueError(f"the program's {self.config['arch']} is not the configuration's model")
        return cfg

    def step(self, i: int):
        from repro_torch.train.train_step import train_step

        o, tok = self.opt, self.batch(i)
        if self.cfg.microbatches == 1:  # the program's batch has no microbatch axis then
            tok = tok[0]
        self.state, m = train_step(self.state, {"tokens": tok}, self.cfg, peak_lr=o["peak_lr"],
                                   warmup=o["warmup"], total=o["total"], device=self.dev)
        return m

    def setup(self):
        from repro_torch.checkpoint.ckpt import tree_leaves
        from repro_torch.models import transformer
        from repro_torch.optim import adamw

        # the straight-through estimator's products in float32, as stated
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg = self.program_config()
        params = draw_params(self.arch, self.seed, self.dev)
        self.state = {"params": params, "opt": adamw.init(params),
                      "router_bias": transformer.init_router_bias(self.cfg, device=self.dev)}
        del params
        self.losses, self.counts, self.biases = [], [], []
        for i in range(self.first_steps):
            self.biases.append(self.state["router_bias"].cpu())
            m = self.step(i)
            self.losses.append(float(m["loss"]))
            self.counts.append(m["expert_counts"].cpu())
            if i == 0:
                b1 = self.opt["b1"]
                self.first_grad = [float(torch.linalg.vector_norm(t)) / (1 - b1)
                                   for t in tree_leaves(self.state["opt"].m)]
        self.change = []
        specs = ref.leaves(param_shapes(self.arch))
        for i, ((shape, init), mast) in enumerate(zip(specs,
                                                      tree_leaves(self.state["opt"].master))):
            start = draw_leaf(self.seed, i, shape, init, self.dev).to(torch.float32)
            self.change.append(float(torch.linalg.vector_norm(mast - start)))
            del start
        self.next_step = self.first_steps
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    # ------------------------------------------------------------- window

    def window(self, seconds: float, tracing: bool) -> dict:
        from repro_torch.kernels import mma_matmul as mk

        shapes, inner = [], mk._launch

        def launch(x, w, *a, **kw):
            before = mk.launches
            out = inner(x, w, *a, **kw)
            if mk.launches != before:
                shapes.append((x.shape[0], x.shape[1], w.shape[1]))
            return out

        if tracing:
            mk._launch = launch
        try:
            res = super().window(seconds, tracing)
        finally:
            mk._launch = inner
        if tracing:
            c = res["counters"]
            c["mma_launches"] = shapes
            c["mma_least_s"] = sum(mma.least_seconds_of(*s) for s in shapes)
            c["step_least_s"] = self.step_least_seconds(shapes, c["steps"])
        return res

    def launch_shapes(self) -> list:
        return []  # recorded in the window instead

    def step_least_seconds(self, shapes=(), steps: int = 1) -> float:
        """The least time of one step: the forward's linear products (2 M K
        N over the launches, a block's counted once though remat runs it
        twice; the held experts at their routed rows) at the int8 peak, the
        straight-through estimator's backward products (4 M K N) at the
        float32 peak, causal attention at the bf16 peak: 3 T S H (dq + dv)
        a layer (scores and weighted sum, forward and backward, half the
        square)."""
        a = self.arch
        remat = 2 if a["remat"] == "full" else 1
        macs = sum(m * k * n / (1 if n == a["vocab"] else remat) for m, k, n in shapes) / steps
        attn = 3 * self.tokens_per_step * int(self.mix["seq_len"]) * a["n_heads"] * (
            a["qk_nope_dim"] + a["qk_rope_dim"] + a["v_head_dim"]) * a["n_layers"]
        return 2 * macs / INT8_OPS_PER_S + 4 * macs / F32_FLOPS_PER_S + attn / BF16_FLOPS_PER_S

    # ------------------------------------------------------------- checks

    def reference(self, **fault) -> dict:
        params = draw_params(self.arch, self.seed, self.dev)
        batches = [torch.as_tensor(self.batch(i), device=self.dev)
                   for i in range(self.first_steps)]
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            out = ref.train(params, batches, self.arch, self.opt, **fault)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
            del params
            gc.collect()
            if self.dev.type == "cuda":
                torch.cuda.empty_cache()
        return out

    def program_record(self) -> dict:
        return {**super().program_record(), "counts": self.counts, "biases": self.biases}

    def numbers(self, got: dict, want: dict) -> dict:
        """``lm_qat``'s three numbers and the routing's two: ``count_gap``,
        over the checked steps and the MoE layers the widest share of the
        assignments placed with other experts than the reference placed them
        (half the L1 distance of the assignments per expert over T k); and
        ``pull_gap``, how much more or less the program's routing leans
        toward the experts its selection bias favours than the reference's,
        over the steps after the first (the bias is zero before): the mean
        over those steps and the layers of sum_i sign(b_i) (c'_i - c_i) / (T
        k), b the program's bias, c and c' the program's and the reference's
        assignments, taken whole.  A routing that ignores the bias moves ~1%
        of the assignments one way; rounding moves them either way, and
        they cancel."""
        out = super().numbers(got, want)
        per = self.tokens_per_step * self.arch["top_k"]
        out["count_gap"] = max(float((a - b).abs().sum(-1).max()) / (2 * per)
                               for a, b in zip(got["counts"], want["counts"]))
        pulls = [(torch.sign(bias) * (b - a).to(torch.float32)).sum(-1) / per
                 for a, b, bias in list(zip(got["counts"], want["counts"], got["biases"]))[1:]]
        out["pull_gap"] = abs(float(torch.cat(pulls).mean())) if pulls else 0.0
        return out

    def readings(self) -> dict:
        """The program's numbers and the control's and faults'
        (calibrate.py): the int4 control, the selection bias ignored, the
        shared experts left out."""
        want = self.reference()
        out = {"program": self.numbers(self.program_record(), want),
               "control_int4": self.numbers(self.reference(qmax=7), want),
               "fault_no_bias": self.numbers(self.reference(use_bias=False), want),
               "fault_no_shared": self.numbers(self.reference(shared=False), want)}
        return {f"{k}.{n}": v for k, d in out.items() for n, v in d.items()}


def make(config, mix, seed, dev, spans):
    return MlaMoeQat(config, mix, seed, dev, spans)
