"""Public wrappers around the MMA kernel: device selection, arbitrary leading
dims, and the KPB-style conv mapping (the k*k taps fold into the
contraction dim, as the FPGA's Kernel Processing Block groups k*k MMA
units over one window).

Layouts match the reference at the public boundary: NHWC activations, HWIO
weights.  No padding to block multiples is needed: the kernel masks its
ragged edges itself.
"""
from __future__ import annotations

import torch

from repro_torch.core import bitplane
from repro_torch.device import resolve_device
from repro_torch.obs import timeline

from .mma_matmul import N_BITS, mma_matmul_kernel, mma_matmul_scaled_kernel


def _as_int8(a, device: torch.device) -> torch.Tensor:
    t = torch.as_tensor(a, device=device)
    if t.dtype != torch.int8:
        raise TypeError(f"expected int8, got {t.dtype}")
    return t


def mma_matmul(
    x,
    w,
    *,
    planes: int | torch.Tensor = N_BITS,
    signed: bool = True,
    device: str | torch.device | None = None,
) -> torch.Tensor:
    """(..., K) int8 @ (K, N) int8 -> (..., N) int32 via the fused kernel.

    Runs on the CUDA card unless ``device='cpu'`` (then the kernel's plain
    version runs).  A tensor ``planes`` folds into the data and runs the
    8-plane variant.
    """
    dev = resolve_device(device)
    x, w = _as_int8(x, dev), _as_int8(w, dev)
    x, planes = bitplane.normalize_planes(x, planes, signed=signed)
    lead, k, n = x.shape[:-1], x.shape[-1], w.shape[-1]
    out = mma_matmul_kernel(
        x.reshape(-1, k).contiguous(), w.contiguous(), planes=planes, signed=signed
    )
    return out.reshape(*lead, n)


def mma_matmul_scaled(
    x,
    w,
    x_scale,
    w_scale,
    *,
    planes: int | torch.Tensor = N_BITS,
    signed: bool = True,
    device: str | torch.device | None = None,
) -> torch.Tensor:
    """Quantized-serving matmul with the dequant epilogue fused in-kernel:
    (..., K) int8 @ (K, N) int8 -> (..., N) float32 scaled by
    ``x_scale * w_scale``.

    ``x_scale``: one float32 (per-tensor, dynamic); ``w_scale``: N float32
    (per-channel, any shape of N elements).  Runs on the CUDA card unless
    ``device='cpu'``; a tensor ``planes`` folds into the data and runs the
    8-plane variant.  No padding: the kernel masks its ragged edges.
    """
    dev = resolve_device(device)
    x, w = _as_int8(x, dev), _as_int8(w, dev)
    x, planes = bitplane.normalize_planes(x, planes, signed=signed)
    xs = torch.as_tensor(x_scale, dtype=torch.float32, device=dev).reshape(1)
    ws = torch.as_tensor(w_scale, dtype=torch.float32, device=dev).reshape(-1)
    lead, k, n = x.shape[:-1], x.shape[-1], w.shape[-1]
    out = mma_matmul_scaled_kernel(
        x.reshape(-1, k).contiguous(), w.contiguous(), xs.contiguous(), ws.contiguous(),
        planes=planes, signed=signed,
    )
    return out.reshape(*lead, n)


def _pad_index(size: int, pad: int, mode: str, device: torch.device) -> torch.Tensor:
    """Source index of every padded position along one axis, numpy-style."""
    i = torch.arange(-pad, size + pad, device=device)
    if mode == "edge":
        return i.clamp(0, size - 1)
    if size == 1:
        return torch.zeros_like(i)
    period = 2 * (size - 1)  # 'reflect': mirror about the edge rows
    i = i.remainder(period)
    return torch.where(i >= size, period - i, i)


def pad_nhwc(x: torch.Tensor, pad: int, pad_mode: str) -> torch.Tensor:
    """Pad H and W of an NHWC tensor by ``pad`` on each side.

    'zero' fills with 0; 'edge' / 'reflect' replicate / mirror the boundary
    rows (numpy's modes), by exact index gathers on any dtype and device.
    """
    n, h, w, c = x.shape
    if pad_mode == "zero":
        xp = torch.zeros((n, h + 2 * pad, w + 2 * pad, c), dtype=x.dtype, device=x.device)
        xp[:, pad : pad + h, pad : pad + w, :] = x
        return xp
    if pad_mode not in ("edge", "reflect"):
        raise ValueError(f"unknown pad_mode {pad_mode!r}")
    xp = x.index_select(1, _pad_index(h, pad, pad_mode, x.device))
    return xp.index_select(2, _pad_index(w, pad, pad_mode, x.device))


def mma_conv2d(
    x,
    w,
    *,
    stride: int = 1,
    pad: int = 1,
    pad_mode: str = "zero",
    planes: int | torch.Tensor = N_BITS,
    signed: bool = True,
    impl: str = "kernel",
    device: str | torch.device | None = None,
) -> torch.Tensor:
    """KPB conv: NHWC int8 x (kh, kw, Cin, Cout) int8 -> NHWC int32.

    Patches (n*oh*ow, kh*kw*cin) @ weights (kh*kw*cin, cout), taps in the
    order ``for i in kh: for j in kw`` concatenated on the channel axis.
    ``impl`` selects the datapath: 'kernel' (the fused CUDA kernel, or its
    plain version on the CPU), or any other ``core.mma`` path ('horner' |
    'cascade' | 'int8').  ``pad_mode`` fills the border ring: 'zero',
    'edge' or 'reflect'.
    """
    dev = resolve_device(device)
    x, w = _as_int8(x, dev), _as_int8(w, dev)
    n, h, w_, c = x.shape
    kh, kw, cin, cout = w.shape
    if c != cin:
        raise ValueError(f"input has {c} channels, weight expects {cin}")
    oh = (h + 2 * pad - kh) // stride + 1
    ow = (w_ + 2 * pad - kw) // stride + 1
    with timeline.span("conv.im2col"):
        xp = pad_nhwc(x, pad, pad_mode)
        patches = torch.cat(
            [
                xp[:, i : i + oh * stride : stride, j : j + ow * stride : stride, :]
                for i in range(kh)
                for j in range(kw)
            ],
            dim=-1,
        )
        pm = patches.reshape(-1, kh * kw * cin)
    wm = w.reshape(kh * kw * cin, cout)
    if impl == "kernel":
        out = mma_matmul(pm, wm, planes=planes, signed=signed, device=dev)
    else:
        from repro_torch.core import mma  # lazy: core.mma imports this module lazily

        out = mma.mma_dot(pm, wm, planes=planes, signed=signed, impl=impl)
    return out.reshape(n, oh, ow, cout)
