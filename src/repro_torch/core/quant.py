"""Int8 quantization (FBGEMM-style symmetric) used by the MMA datapath.

Symmetric int8, per-output-channel scales for weights, a per-tensor (or
per-row) dynamic scale for activations; ``fake_quant`` is the
straight-through estimator for quantization-aware training.  The order of
operations matches the reference exactly — ``x / scale``, round half to
even, clip, int8 — so the same float input gives the same int8 values and
the same scale bits.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.obs import timeline

INT8_MAX = 127.0


class QTensor(NamedTuple):
    """A quantized tensor: ``values * scale ~= original`` (scale broadcasts)."""

    values: torch.Tensor  # int8
    scale: torch.Tensor  # float32, broadcastable against values


def quantize_amax(x: torch.Tensor, amax: torch.Tensor) -> QTensor:
    """Symmetric int8 on the grid of a given ``amax`` (broadcastable against
    ``x``): the step every quantizer here takes once its max is known — and
    the one a sharded caller takes once it has reduced its max over ranks."""
    scale = torch.clamp(amax, min=1e-8) / INT8_MAX
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return QTensor(q, scale.to(torch.float32))


def quantize_weights(w: torch.Tensor, *, channel_axis: int = -1) -> QTensor:
    """Symmetric per-channel int8 quantization (channel = output features)."""
    with timeline.span("quant.weights"):
        reduce_axes = tuple(a for a in range(w.ndim) if a != channel_axis % w.ndim)
        return quantize_amax(w, torch.amax(torch.abs(w), dim=reduce_axes, keepdim=True))


def quantize_acts(x: torch.Tensor, *, batch_axis: int | None = None) -> QTensor:
    """Symmetric dynamic int8 quantization of activations.

    Default is one per-tensor scale.  ``batch_axis`` switches to one scale
    per index along that axis (every other axis reduced), so one batch row's
    magnitudes never move another row's quantization grid.
    """
    with timeline.span("quant.acts"):
        if batch_axis is None:
            amax = torch.amax(torch.abs(x))
        else:
            reduce_axes = tuple(a for a in range(x.ndim) if a != batch_axis % x.ndim)
            amax = torch.amax(torch.abs(x), dim=reduce_axes, keepdim=True)
        return quantize_amax(x, amax)


def dequantize(q: QTensor) -> torch.Tensor:
    return q.values.to(torch.float32) * q.scale


def fake_quant(x: torch.Tensor, *, channel_axis: int | None = None) -> torch.Tensor:
    """Straight-through-estimator fake quantization for QAT: the forward is
    ``x`` quantized to int8 and back (per tensor, or per index along
    ``channel_axis``), the gradient passes through as the identity."""
    if channel_axis is None:
        amax = torch.amax(torch.abs(x))
    else:
        reduce_axes = tuple(a for a in range(x.ndim) if a != channel_axis % x.ndim)
        amax = torch.amax(torch.abs(x), dim=reduce_axes, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / INT8_MAX
    q = torch.clamp(torch.round(x / scale), -127, 127) * scale
    return x + (q - x).detach()


def quantized_matmul_scale(x_scale: torch.Tensor, w_scale: torch.Tensor) -> torch.Tensor:
    """Output scale of an int8 x int8 -> int32 matmul."""
    return x_scale * torch.squeeze(w_scale)


def quantize_params_int8(params, *, min_dim: int = 256):
    """Serving transform: replace every linear ``{'w': (…, K, N)}`` whose last
    two dims are >= ``min_dim`` with ``{'w_q': int8, 'w_scale': float32}``
    (per-output-channel scales over the contraction dim, kept as a
    ``(…, 1, N)`` axis).  Embeddings, norms, biases and small matrices stay
    as they are.  Halves the weight bytes of bf16, the dominant term of
    memory-bound decode."""

    def walk(node):
        if isinstance(node, dict):
            w = node.get("w")
            if isinstance(w, torch.Tensor) and w.ndim >= 2 \
                    and w.shape[-1] >= min_dim and w.shape[-2] >= min_dim:
                wf = w.to(torch.float32)
                q = quantize_amax(wf, torch.amax(torch.abs(wf), dim=-2, keepdim=True))
                out = {k: v for k, v in node.items() if k != "w"}
                out["w_q"] = q.values
                out["w_scale"] = q.scale
                return out
            return {k: walk(v) for k, v in node.items()}
        return node

    return walk(params)
