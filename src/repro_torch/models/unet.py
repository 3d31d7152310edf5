"""U-Net (the paper's target application) with MMA-quantized 3x3 convs.

The network is trained in float, quantized FBGEMM-style to int8, and its
3x3 convolutions execute on the MSDF merged multiply-add datapath
(``kernels.ops.mma_conv2d``, the KPB folding the k*k taps into the
contraction dim).  2x2 pool/upsample and the final 1x1 conv run off the
accelerator datapath, as in the paper (Sec. 3.1).

Parameters are a plain dict of tensors with the reference's tree and HWIO
layout: ``{"enc": [[{"w", "b"}]], "bottleneck": [...], "dec": [...],
"head": {...}}``.  The default geometry is the Table-1-calibrated config
(``core.cycle_model.CALIBRATED_UNET``): 80x80x4 input, base 48, depth 3.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import quant
from repro_torch.core.bitplane import N_BITS
from repro_torch.core.cycle_model import CALIBRATED_UNET, ConvLayerSpec, unet_conv_layers
from repro_torch.core.plane_schedule import PlaneSchedule
from repro_torch.device import resolve_device
from repro_torch.kernels import ops


@dataclass(frozen=True)
class UNetConfig:
    hw: int = CALIBRATED_UNET["hw"]
    in_ch: int = CALIBRATED_UNET["in_ch"]
    base: int = CALIBRATED_UNET["base"]
    depth: int = CALIBRATED_UNET["depth"]
    convs_per_stage: int = CALIBRATED_UNET["convs_per_stage"]
    n_classes: int = 4
    quant_mode: str = "none"  # 'none' | 'mma_int8'
    planes: int = 8
    # Per-3x3-conv plane budgets, in forward order (enc, bottleneck, dec) —
    # same order as ``conv_layers()``.  None -> uniform ``planes``.
    plane_schedule: tuple[int, ...] | None = None
    impl: str = "kernel"  # mma impl: kernel | horner | cascade | int8
    # Border fill of every 3x3 conv: 'zero' (the SAME convention) or
    # 'edge' / 'reflect' — what halo-free image tiles use.
    pad_mode: str = "zero"
    family: str = "unet"

    def conv_layers(self) -> list[ConvLayerSpec]:
        return unet_conv_layers(self.hw, self.in_ch, self.base, self.depth,
                                self.convs_per_stage)

    def schedule(self) -> PlaneSchedule:
        """The active per-layer precision policy (explicit or uniform)."""
        n = len(self.conv_layers())
        if self.plane_schedule is not None:
            if len(self.plane_schedule) != n:
                raise ValueError(
                    f"plane_schedule has {len(self.plane_schedule)} entries "
                    f"but this geometry (depth={self.depth}, "
                    f"convs_per_stage={self.convs_per_stage}) has {n} 3x3 "
                    f"convs — one budget per conv, in forward order"
                )
            return PlaneSchedule.from_list(self.plane_schedule)
        return PlaneSchedule.uniform(self.planes, n)

    # ------------------------------------------------------- tile geometry

    def min_viable_tile(self) -> int:
        """Smallest core stride worth tiling at: the first multiple of
        ``2**depth`` strictly larger than twice the receptive-field halo."""
        from repro_torch.segserve.tiling import halo_for  # lazy: segserve imports us

        mult = 2**self.depth
        halo = halo_for(self.depth, self.convs_per_stage)
        return (2 * halo // mult + 1) * mult

    def validate_tile(self, tile: int, *, halo: int | None = None) -> int:
        """Reject core strides that are not multiples of ``2**depth`` or not
        larger than twice the halo (every window would be mostly halo).
        Returns ``tile``."""
        from repro_torch.segserve.tiling import halo_for  # lazy: segserve imports us

        mult = 2**self.depth
        if tile < mult or tile % mult:
            raise ValueError(
                f"tile {tile} must be a positive multiple of 2**depth = {mult}"
            )
        h = halo_for(self.depth, self.convs_per_stage) if halo is None else halo
        if h > 0 and tile <= 2 * h:
            min_viable = (2 * h // mult + 1) * mult
            raise ValueError(
                f"tile {tile} <= 2*halo = {2 * h} at depth {self.depth} "
                f"(convs_per_stage={self.convs_per_stage}): every interior "
                f"window would be mostly redundant halo context; the minimum "
                f"viable tile for this geometry is {min_viable}"
            )
        return tile


# ---------------------------------------------------------------- params


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def params_to(params, device) -> dict:
    """The same parameter tree with every tensor on ``device``."""
    return _tree_map(lambda t: t.to(device), params)


def params_from_jax(tree, *, device=None) -> dict:
    """Carry the reference's parameter tree (leaves as numpy arrays, e.g.
    ``jax.tree.map(np.asarray, params)``) into the port's: same tree, same
    shapes, HWIO layout, float32 tensors on ``device``."""
    dev = resolve_device(device)
    return _tree_map(
        lambda a: torch.tensor(np.asarray(a, np.float32), device=dev), tree
    )


def _conv_init(rng: np.random.Generator, kh, kw, cin, cout) -> dict:
    w = rng.standard_normal((kh, kw, cin, cout))
    bad = np.abs(w) > 2
    while bad.any():  # truncated normal on [-2, 2], by rejection
        w[bad] = rng.standard_normal(int(bad.sum()))
        bad = np.abs(w) > 2
    return {
        "w": (w / np.sqrt(kh * kw * cin)).astype(np.float32),
        "b": np.zeros((cout,), np.float32),
    }


def init_params(seed: int, cfg: UNetConfig, *, device=None) -> dict:
    """Seeded random parameters (numpy's generator; the reference's
    ``jax.random`` draws cannot be reproduced — carry those over with
    :func:`params_from_jax`)."""
    rng = np.random.default_rng(seed)
    p: dict = {"enc": [], "dec": []}
    ch = cfg.in_ch
    enc_ch = []
    for d in range(cfg.depth):
        c = cfg.base * (2**d)
        stage = [_conv_init(rng, 3, 3, ch, c)]
        for _ in range(cfg.convs_per_stage - 1):
            stage.append(_conv_init(rng, 3, 3, c, c))
        p["enc"].append(stage)
        enc_ch.append(c)
        ch = c
    c = cfg.base * (2**cfg.depth)
    p["bottleneck"] = [_conv_init(rng, 3, 3, ch, c)]
    for _ in range(cfg.convs_per_stage - 1):
        p["bottleneck"].append(_conv_init(rng, 3, 3, c, c))
    ch = c
    for d in reversed(range(cfg.depth)):
        c = enc_ch[d]
        stage = [_conv_init(rng, 3, 3, c + ch, c)]
        for _ in range(cfg.convs_per_stage - 1):
            stage.append(_conv_init(rng, 3, 3, c, c))
        p["dec"].append(stage)
        ch = c
    p["head"] = _conv_init(rng, 1, 1, ch, cfg.n_classes)
    return params_from_jax(p, device=device)


# --------------------------------------------------------------- forward


def conv3x3(
    p, x: torch.Tensor, cfg: UNetConfig, *, planes=None, per_sample_scale: bool = False
) -> torch.Tensor:
    """3x3 conv through the selected datapath (float or MMA int8), on
    ``x``'s device.  ``planes`` overrides ``cfg.planes`` for this layer —
    the hook the per-layer :class:`PlaneSchedule` drives.
    ``per_sample_scale`` quantizes the activations with one int8 scale per
    sample (batch row) instead of one for the whole tensor, so a sample's
    numerics never depend on its batch mates."""
    if planes is None:
        planes = cfg.planes
    if cfg.quant_mode == "mma_int8":
        xq = quant.quantize_acts(x, batch_axis=0 if per_sample_scale else None)
        wq = quant.quantize_weights(p["w"], channel_axis=-1)
        out = ops.mma_conv2d(
            xq.values, wq.values, planes=planes, impl=cfg.impl,
            pad_mode=cfg.pad_mode, device=x.device,
        )
        out = out.to(torch.float32) * quant.quantized_matmul_scale(xq.scale, wq.scale)
    else:
        xp = ops.pad_nhwc(x, 1, cfg.pad_mode)
        out = F.conv2d(xp.permute(0, 3, 1, 2), p["w"].permute(3, 2, 0, 1))
        out = out.permute(0, 2, 3, 1)
    return out + p["b"]


def _maxpool2(h: torch.Tensor) -> torch.Tensor:
    n, hh, ww, c = h.shape
    return h.reshape(n, hh // 2, 2, ww // 2, 2, c).amax(dim=(2, 4))


def _upsample2(h: torch.Tensor) -> torch.Tensor:
    """2x nearest upsample (off-accelerator op, like the paper's 2x2 path)."""
    return h.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def _head(params, h: torch.Tensor) -> torch.Tensor:
    w = params["head"]["w"]
    return torch.matmul(h, w.reshape(-1, w.shape[-1])) + params["head"]["b"]


def _prepare(params, x, device) -> tuple[dict, torch.Tensor]:
    dev = resolve_device(device)
    if dev.type == "cuda":
        # full float32 products, as the reference computes them: no TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    return params_to(params, dev), x


def forward(
    params, x, cfg: UNetConfig, *, planes_arr=None, taps=None, per_sample_scale: bool = False,
    device=None,
):
    """x: (N, H, W, Cin) -> logits (N, H, W, n_classes), on ``device``
    (the CUDA card unless ``device='cpu'``).

    3x3 convs are visited in ``cfg.conv_layers()`` order (encoder,
    bottleneck, decoder), so schedule entry ``l`` lines up with cycle-model
    layer ``l``.  Spatial dims need not equal ``cfg.hw`` but must divide by
    ``2**depth``.

    ``planes_arr``: per-conv plane budgets overriding ``cfg``'s schedule
    (quantized datapath only); tensor entries fold into the data via the
    exact bit-mask identity.  ``taps``: a list to append each post-ReLU
    conv activation to, in schedule order.  ``per_sample_scale``: quantize
    every conv's activations with one scale per sample, so one batched call
    computes what a forward of each sample alone computes (the per-tile
    quantization a tuned plan is served with).
    """
    params, x = _prepare(params, x, device)
    mult = 2**cfg.depth
    if x.shape[1] % mult or x.shape[2] % mult:
        raise ValueError(
            f"spatial dims {x.shape[1]}x{x.shape[2]} not divisible by "
            f"2**depth = {mult}; pad the input (segserve.tiling.plan_tiles "
            f"does this for arbitrary images)"
        )
    sched = cfg.schedule() if cfg.quant_mode == "mma_int8" else None
    li = 0

    def qconv(conv, h):
        nonlocal li
        if planes_arr is not None and cfg.quant_mode == "mma_int8":
            pl = planes_arr[li]
        else:
            pl = sched.planes_for(li) if sched is not None else None
        li += 1
        out = torch.relu(conv3x3(conv, h, cfg, planes=pl, per_sample_scale=per_sample_scale))
        if taps is not None:
            taps.append(out)
        return out

    skips = []
    h = x
    for stage in params["enc"]:
        for conv in stage:
            h = qconv(conv, h)
        skips.append(h)
        h = _maxpool2(h)
    for conv in params["bottleneck"]:
        h = qconv(conv, h)
    for d, stage in enumerate(params["dec"]):
        h = torch.cat([skips[-(d + 1)], _upsample2(h)], dim=-1)
        for conv in stage:
            h = qconv(conv, h)
    return _head(params, h)


def forward_with_error_bound(params, x, cfg: UNetConfig, *, device=None):
    """Scheduled forward plus a sound end-to-end error certificate.

    Returns ``(out_sched, out_full, advertised_rel_bound)`` with

        max|out_sched - out_full|  <=  advertised_rel_bound * max|out_full|

    by interval propagation through the forward graph: each truncated conv
    contributes its worst-case truncation error plus both paths'
    requantization jitter, and upstream error is amplified by the layer's
    L-inf operator norm.  ReLU / maxpool / upsample are 1-Lipschitz and
    concat takes the max of branch errors.
    """
    params, x = _prepare(params, x, device)
    sched = cfg.schedule()
    full_cfg = dataclasses.replace(cfg, plane_schedule=None, planes=8)
    out_full = forward(params, x, full_cfg, device=x.device)
    out_sched = forward(params, x, cfg, device=x.device)

    li = 0
    err = 0.0  # abs L-inf bound on (sched activation - full activation)

    def conv_err(p, h_ref, err_in):
        nonlocal li
        planes = sched.planes_for(li)
        li += 1
        wq = quant.quantize_weights(p["w"], channel_axis=-1)
        w2 = wq.values.reshape(-1, wq.values.shape[-1]).to(torch.int32)
        ws = torch.squeeze(wq.scale)
        col_l1 = torch.abs(w2).sum(dim=0, dtype=torch.int32).to(torch.float32) * ws
        opnorm = float(torch.max(col_l1))
        amax_ref = float(torch.max(torch.abs(h_ref)))
        s_ref = max(amax_ref, 1e-8) / 127.0
        s_sched = max(amax_ref + err_in, 1e-8) / 127.0
        dropped = N_BITS - planes
        if err_in == 0.0 and dropped == 0:
            return 0.0  # identical datapaths
        e = opnorm * (err_in + 0.5 * (s_ref + s_sched))
        if dropped:
            e += (2**dropped - 1) * opnorm * s_sched
        return e

    h = x
    skips = []
    skip_errs = []
    for stage in params["enc"]:
        for conv in stage:
            err = conv_err(conv, h, err)
            h = torch.relu(conv3x3(conv, h, full_cfg))
        skips.append(h)
        skip_errs.append(err)
        h = _maxpool2(h)
    for conv in params["bottleneck"]:
        err = conv_err(conv, h, err)
        h = torch.relu(conv3x3(conv, h, full_cfg))
    for d, stage in enumerate(params["dec"]):
        h = torch.cat([skips[-(d + 1)], _upsample2(h)], dim=-1)
        err = max(err, skip_errs[-(d + 1)])
        for conv in stage:
            err = conv_err(conv, h, err)
            h = torch.relu(conv3x3(conv, h, full_cfg))
    w_head = params["head"]["w"].reshape(-1, params["head"]["w"].shape[-1])
    err = err * float(torch.max(torch.abs(w_head).sum(dim=0)))

    denom = max(float(torch.max(torch.abs(out_full))), 1e-8)
    return out_sched, out_full, err / denom


def conv_weights_in_order(params) -> list[torch.Tensor]:
    """Float 3x3-conv weights in forward order (enc, bottleneck, dec)."""
    ws = []
    for stage in params["enc"]:
        ws += [conv["w"] for conv in stage]
    ws += [conv["w"] for conv in params["bottleneck"]]
    for stage in params["dec"]:
        ws += [conv["w"] for conv in stage]
    return ws


def schedule_from_params(params, target_rel_err: float) -> PlaneSchedule:
    """Per-layer precision policy from this net's weights: quantize each 3x3
    conv FBGEMM-style and pick the fewest planes whose analytic worst-case
    relative error meets ``target_rel_err``."""
    wq = [
        quant.quantize_weights(w, channel_axis=-1).values.reshape(-1, w.shape[-1])
        for w in conv_weights_in_order(params)
    ]
    return PlaneSchedule.from_weights(wq, target_rel_err)


def loss_fn(params, batch, cfg: UNetConfig, *, device=None):
    """Segmentation cross-entropy; batch = {"image": (N,H,W,C), "mask": (N,H,W)}."""
    logits = forward(params, batch["image"], cfg, device=device)
    mask = torch.as_tensor(batch["mask"], dtype=torch.int64, device=logits.device)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, mask[..., None])[..., 0]
    nll = (logz - gold).mean()
    return nll, {"nll": nll}
