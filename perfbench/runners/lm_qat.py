"""Runner of quantization-aware training (``repro_torch.train.train_step``).

Set-up draws the model's weights on the device from the seed (each leaf
from a generator of its own, so any leaf can be drawn again), builds the
training state (``optim.adamw`` master weights and moments) and drives it
through its first steps with ``train_step``, the window's own call, on
token batches drawn from the seed.  It keeps, for the check, each step's
loss, each leaf's norm of the first gradient as the optimizer took it (its
first moment after one step over 1 - beta1) and, after the last of those
steps, each leaf's change of its master weights.  The same state goes on
into the window, which runs ``train_step`` until the first step boundary
at or after ``--seconds`` (each step synchronised).

With ``tracing`` the harness records spans around ``train_step`` and
``optim.adamw.update``; the update's span is synchronised on both ends,
so the device operations inside it are the optimizer's.

After the window the state is freed and the plain reference
(``reference/lm_qat.py``) trains from the same weights on the same tokens.
"""
from __future__ import annotations

import gc
import math
import statistics
import time

import numpy as np
import torch

from perfbench import traffic
from perfbench.reference import lm_qat as ref
from perfbench.roofline import (BF16_FLOPS_PER_S, F32_FLOPS_PER_S, INT8_OPS_PER_S,
                                mma_tc_horner_kernel as mma)


def param_shapes(a: dict) -> dict:
    """The model's parameter tree of (shape, init) pairs, the layers
    stacked on axis 0 (the program's tree)."""
    d, f, v, n = a["d_model"], a["d_ff"], a["vocab"], a["n_layers"]
    hd = d // a["n_heads"]
    kv = a["n_kv_heads"] * hd

    def lin(k, m):
        return {"w": ((n, k, m), "dense")}

    return {
        "embed": {"table": ((v, d), "embed")},
        "blocks": {
            "ln1": {"scale": ((n, d), "ones")}, "ln2": {"scale": ((n, d), "ones")},
            "attn": {"wq": lin(d, d), "wk": lin(d, kv), "wv": lin(d, kv), "wo": lin(d, d)},
            "mlp": {"w_gate": lin(d, f), "w_up": lin(d, f), "w_down": lin(f, d)},
        },
        "ln_f": {"scale": ((d,), "ones")},
        "head": {"w": ((d, v), "dense")},
    }


def draw_leaf(seed: int, index: int, shape, init: str, dev) -> torch.Tensor:
    """Leaf ``index`` (in sorted-key order) as bf16 on ``dev``: normal
    clipped to [-2, 2] over sqrt(fan-in) for a dense weight, normal x 0.02
    for the embedding, ones for a norm's scale."""
    if init == "ones":
        return torch.ones(shape, dtype=torch.bfloat16, device=dev)
    g = torch.Generator(device=dev).manual_seed((int(seed) * 1_000_003 + index) % 2**63)
    t = torch.randn(shape, generator=g, device=dev)
    if init == "embed":
        t.mul_(0.02)
    else:
        t.clamp_(-2.0, 2.0).div_(math.sqrt(shape[-2]))
    return t.to(torch.bfloat16)


def draw_params(arch: dict, seed: int, dev) -> dict:
    spec = param_shapes(arch)
    flat = [draw_leaf(seed, i, s, init, dev) for i, (s, init) in enumerate(ref.leaves(spec))]
    return ref.unflatten(spec, flat)


def _leaf_specs(arch: dict) -> list:
    def walk(t):
        if isinstance(t, dict):
            return [x for k in sorted(t) for x in walk(t[k])]
        return [t]

    return walk(param_shapes(arch))


def worst_leaf(prog: list[float], reference: list[float], keep=None) -> float:
    """The widest gap between the program's per-leaf norm and the
    reference's, over the reference's norm of that leaf or of the median
    leaf, whichever is larger."""
    idx = [i for i in range(len(reference)) if keep is None or keep[i]]
    med = statistics.median(reference[i] for i in idx)
    return max(abs(prog[i] - reference[i]) / max(reference[i], med, 1e-30) for i in idx)


class LMQat:
    def __init__(self, config: dict, mix: dict, seed: int, dev: torch.device, spans):
        self.arch, self.q, self.opt = config["model"], config["quant"], config["optimizer"]
        self.limits, self.config = config["check"], config
        self.mix, self.seed, self.dev, self.spans = mix, int(seed), dev, spans
        self.first_steps = int(mix["checked_steps"])
        self.tokens_per_step = int(mix["global_batch"]) * int(mix["seq_len"])

    def batch(self, step: int) -> np.ndarray:
        return traffic.token_batch(self.mix, self.seed, step, self.arch["vocab"])

    # ------------------------------------------------------------- set-up

    def program_config(self):
        from repro_torch.configs import get_config
        from repro_torch.configs.base import QuantConfig

        a = self.arch
        cfg = get_config(self.config["arch"]).replace(
            n_layers=a["n_layers"], d_model=a["d_model"], n_heads=a["n_heads"],
            n_kv_heads=a["n_kv_heads"], d_ff=a["d_ff"], vocab=a["vocab"],
            rope_theta=a["rope_theta"], norm_eps=a["norm_eps"], act=a["act"],
            microbatches=a["microbatches"], remat=a["remat"], attn_chunk=a["attn_chunk"],
            quant=QuantConfig(mode=self.q["mode"], impl=self.q["impl"], planes=self.q["planes"]))
        if cfg.hd != a["d_model"] // a["n_heads"] or cfg.dtype != "bfloat16" or cfg.tie_embeddings:
            raise ValueError(f"the program's {self.config['arch']} is not the configuration's model")
        return cfg

    def step(self, i: int):
        from repro_torch.train.train_step import train_step

        o = self.opt
        self.state, m = train_step(self.state, {"tokens": self.batch(i)}, self.cfg,
                                   peak_lr=o["peak_lr"], warmup=o["warmup"], total=o["total"],
                                   device=self.dev)
        return m

    def setup(self):
        from repro_torch.checkpoint.ckpt import tree_leaves
        from repro_torch.optim import adamw

        # the straight-through estimator's products in float32, as stated
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg = self.program_config()
        params = draw_params(self.arch, self.seed, self.dev)
        self.state = {"params": params, "opt": adamw.init(params)}
        del params
        self.losses = []
        for i in range(self.first_steps):
            m = self.step(i)
            self.losses.append(float(m["loss"]))
            if i == 0:
                b1 = self.opt["b1"]
                self.first_grad = [float(torch.linalg.vector_norm(t)) / (1 - b1)
                                   for t in tree_leaves(self.state["opt"].m)]
        self.change = []
        for i, ((shape, init), mast) in enumerate(zip(_leaf_specs(self.arch),
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
        from repro_torch.optim import adamw

        sync = (lambda: torch.cuda.synchronize(self.dev)) if self.dev.type == "cuda" else (
            lambda: None)
        inner = adamw.update
        if tracing:
            def update(*a, **kw):
                sync()
                with self.spans.span("train.optimizer"):
                    out = inner(*a, **kw)
                    sync()
                return out

            adamw.update = update
        mk.launches = 0
        steps, losses = 0, []
        t0 = time.perf_counter()
        try:
            while True:
                with self.spans.span("train.step"):
                    m = self.step(self.next_step)
                    sync()
                self.next_step += 1
                steps += 1
                losses.append(m["loss"])
                if time.perf_counter() - t0 >= seconds:
                    break
        finally:
            adamw.update = inner
        elapsed = time.perf_counter() - t0
        failed = sum(1 for v in losses if not math.isfinite(float(v)))
        counters = {}
        if tracing:
            counters = {"steps": steps, "window_s": elapsed, "mma_launch_count": mk.launches,
                        "mma_launches": self.launch_shapes() * steps,
                        "step_least_s": self.step_least_seconds()}
            counters["mma_least_s"] = sum(mma.least_seconds_of(*s)
                                          for s in counters["mma_launches"])
        return {"metrics": {"train_tokens_per_s": steps * self.tokens_per_step / elapsed},
                "window_s": elapsed, "attempted": steps, "failed": failed, "counters": counters}

    def linear_shapes(self) -> list[tuple[int, int, int]]:
        """(K, N, count) of the linears: per layer wq, wk, wv, wo, w_gate,
        w_up, w_down, then the head."""
        a = self.arch
        d, f, kv = a["d_model"], a["d_ff"], a["n_kv_heads"] * (a["d_model"] // a["n_heads"])
        n = a["n_layers"]
        return [(d, d, 2 * n), (d, kv, 2 * n), (d, f, 2 * n), (f, d, n), (d, a["vocab"], 1)]

    def launch_shapes(self) -> list[tuple[int, int, int]]:
        """The unscaled kernel's launches of one step: each microbatch's
        linears at M = its tokens, a block's twice (remat recomputes it)."""
        mbs = int(self.arch["microbatches"])
        m = self.tokens_per_step // mbs
        per_mb = []
        for k, n, count in self.linear_shapes():
            per_mb += [(m, k, n)] * (count * (1 if n == self.arch["vocab"] else 2))
        return per_mb * mbs

    def step_least_seconds(self) -> float:
        """The least time of one step: forward linear products (2 N T) at
        the int8 peak, the straight-through estimator's backward products
        (4 N T) at the float32 peak, causal attention (the scores and the
        weighted sum, forward and backward: 6 B S^2 D per layer, half the
        square) at the bf16 peak.  Nothing for remat."""
        a, t = self.arch, self.tokens_per_step
        n_lin = sum(k * n * c for k, n, c in self.linear_shapes())
        attn = 6 * t * int(self.mix["seq_len"]) * a["d_model"] * a["n_layers"]
        return 2 * n_lin * t / INT8_OPS_PER_S + 4 * n_lin * t / F32_FLOPS_PER_S + \
            attn / BF16_FLOPS_PER_S

    # ------------------------------------------------------------- checks

    def release(self):
        del self.state
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

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

    def numbers(self, got: dict, want: dict) -> dict:
        """The three numbers compared: the widest step loss gap (relative),
        the worst leaf of the first gradient's norm, the worst leaf of the
        master weights' change, leaves whose reference gradient is under a
        thousandth of the median leaf's left out of the change."""
        med = statistics.median(want["first_grad"])
        keep = [g >= 1e-3 * med for g in want["first_grad"]]
        return {
            "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"])),
            "grad_norm_gap": worst_leaf(got["first_grad"], want["first_grad"]),
            "change_norm_gap": worst_leaf(got["change"], want["change"], keep),
        }

    def program_record(self) -> dict:
        return {"losses": self.losses, "first_grad": self.first_grad, "change": self.change}

    def check(self) -> list[dict]:
        nums = self.numbers(self.program_record(), self.reference())
        return [{"name": k, "value": v, "limit": self.limits[k]} for k, v in nums.items()]

    def readings(self) -> dict:
        """The program's numbers and the control's and faults'
        (calibrate.py): the int4 control, half of each microbatch's rows
        left out (the mean over the rest)."""
        want = self.reference()
        rows = int(self.mix["global_batch"]) // int(self.arch["microbatches"])
        out = {"program": self.numbers(self.program_record(), want),
               "control_int4": self.numbers(self.reference(qmax=7), want),
               "fault_half_batch": self.numbers(self.reference(rows=slice(0, rows // 2)), want)}
        return {f"{k}.{n}": v for k, d in out.items() for n, v in d.items()}


def make(config, mix, seed, dev, spans):
    return LMQat(config, mix, seed, dev, spans)
