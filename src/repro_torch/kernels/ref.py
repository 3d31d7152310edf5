"""Oracles for the MMA kernel — independent of the kernel code.

Plane truncation oracle: consuming only the ``b`` MSB planes of the offset
activation ``u = x + 128`` equals masking off the low ``8-b`` bits of ``u``:

    S_b * 2^(8-b) = (u & ~(2^(8-b)-1)) @ w  -  128 * colsum(w)

so the oracle needs no Horner loop at all — one masked exact matmul (in
float64, exact for every integer partial sum below 2**53).
"""
from __future__ import annotations

import torch

N_BITS = 8


def mma_matmul_ref(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    planes: int = N_BITS,
    signed: bool = True,
    midpoint: bool = False,
) -> torch.Tensor:
    """Oracle for kernels.mma_matmul: (..., K) int8 @ (K, N) int8 -> int32."""
    u = x.to(torch.int64)
    if signed:
        u = u + 128
    dropped = N_BITS - planes
    u = u & ~((1 << dropped) - 1)
    out = torch.matmul(u.to(torch.float64), w.to(torch.float64)).to(torch.int64)
    colsum = w.to(torch.int64).sum(dim=0)
    if midpoint and dropped:
        out = out + ((2**dropped - 1) * colsum) // 2
    if signed:
        out = out - 128 * colsum
    return out.to(torch.int32)


def mma_conv2d_ref(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    stride: int = 1,
    pad: int = 1,
    planes: int = N_BITS,
    signed: bool = True,
) -> torch.Tensor:
    """Oracle for the KPB conv: NHWC int8 x (kh, kw, Cin, Cout) int8 -> NHWC
    int32, zero-padded.  Built from the matmul oracle via explicit patch
    extraction, sharing no code with the conv under test."""
    n, h, w_, c = x.shape
    kh, kw, cin, cout = w.shape
    if c != cin:
        raise ValueError(f"input has {c} channels, weight expects {cin}")
    xp = torch.zeros((n, h + 2 * pad, w_ + 2 * pad, c), dtype=x.dtype, device=x.device)
    xp[:, pad : pad + h, pad : pad + w_, :] = x
    oh = (h + 2 * pad - kh) // stride + 1
    ow = (w_ + 2 * pad - kw) // stride + 1
    patches = []
    for i in range(kh):
        for j in range(kw):
            patches.append(xp[:, i : i + oh * stride : stride, j : j + ow * stride : stride, :])
    patches = torch.cat(patches, dim=-1)
    out = mma_matmul_ref(
        patches.reshape(-1, kh * kw * cin), w.reshape(kh * kw * cin, cout),
        planes=planes, signed=signed,
    )
    return out.reshape(n, oh, ow, cout)
