"""Plain reference of the tiled U-Net segmentation service.

It works out again, from the weights and the images alone, everything the
served logits depend on:

* the receptive-field-exact halo tiling and the stitching of tile cores;
* the budget class of every tile (its window's amplitude against the
  image's, in octaves) and each class's plane schedule (the fewest MSB
  activation planes meeting the target error, refined per class);
* the packing of tiles into micro-batches as the closed-loop clients drive
  the service: a FIFO of images, a bounded number in flight, tiles grouped
  by (window shape, class, image amplitude octave), the lowest class first,
  short groups padded with zero tiles.  So each tile's batch mates, and the
  one activation scale per micro-batch that they and the padding share;
* the int8 forward: symmetric int8 activations (one scale per tensor) and
  weights (one per output channel), the 3x3 conv as an exact integer
  product of the plane-truncated activations, 2x2 max pool, nearest
  upsample, skip concat, the 1x1 head in float32.

Plain PyTorch and NumPy only: it imports nothing of the program.  The
integer products run in float64, exact for every sum here (below 2**53).
"""
from __future__ import annotations

import math
from collections import deque

import numpy as np
import torch

N_BITS = 8


# --------------------------------------------------------------- geometry


def conv_layers(h: int, w: int, in_ch: int, base: int, depth: int, cps: int):
    """The 3x3 convs of the U-Net at input (h, w), in forward order:
    ``(h, w, cin, cout)`` at each conv's resolution."""
    out, ch, enc = [], in_ch, []
    for d in range(depth):
        c = base * 2**d
        out += [(h, w, ch, c)] + [(h, w, c, c)] * (cps - 1)
        enc.append(c)
        ch, h, w = c, h // 2, w // 2
    c = base * 2**depth
    out += [(h, w, ch, c)] + [(h, w, c, c)] * (cps - 1)
    ch = c
    for d in reversed(range(depth)):
        h, w, c = h * 2, w * 2, enc[d]
        out += [(h, w, c + ch, c)] + [(h, w, c, c)] * (cps - 1)
        ch = c
    return out


def useful_ops(h: int, w: int, in_ch: int, base: int, depth: int, cps: int) -> int:
    """2 x the multiply-adds of every 3x3 conv over an (h, w) input."""
    return sum(2 * hh * ww * ci * co * 9 for hh, ww, ci, co in
               conv_layers(h, w, in_ch, base, depth, cps))


def halo(depth: int, cps: int) -> int:
    """Input pixels per side that make a tile cut invisible to its core:
    the walk of the wrong border through convs (+1), pools (ceil half),
    upsamples (x2) and skip concats (max), rounded up to 2**depth."""
    m, skips = 0, []
    for _ in range(depth):
        m += cps
        skips.append(m)
        m = -(-m // 2)
    m += cps
    for level in reversed(range(depth)):
        m = max(2 * m, skips[level]) + cps
    mult = 2**depth
    return -(-max(m, 1) // mult) * mult


def tiles_of(h: int, w: int, depth: int, tile: int, hal: int):
    """``(pad_h, pad_w, tiles)``: the canvas padded to 2**depth, and each
    tile's window ``(y0, x0, y1, x1)`` (its core grown by the halo, clipped
    to the canvas) with its core ``(cy0, cx0, cy1, cx1)``, row-major."""
    mult = 2**depth
    ph, pw = -(-h // mult) * mult, -(-w // mult) * mult
    tiles = []
    for cy in range(0, ph, tile):
        for cx in range(0, pw, tile):
            cy1, cx1 = min(ph, cy + tile), min(pw, cx + tile)
            tiles.append(((max(0, cy - hal), max(0, cx - hal), min(ph, cy1 + hal),
                           min(pw, cx1 + hal)), (cy, cx, cy1, cx1)))
    return ph, pw, tiles


# -------------------------------------------------------------- schedules


def base_planes(weights, target: float) -> list[int]:
    """Per conv, the fewest MSB planes whose worst-case truncation error
    (2**dropped - 1) * sum|w| stays within ``target`` of the full-scale
    output 255 * sum|w|, column by column."""
    out = []
    for w in weights:
        q = quantize_weights(w, 127)[0].reshape(-1, w.shape[-1]).to(torch.float64)
        l1 = q.abs().sum(dim=0)
        denom = torch.clamp(255 * l1, min=1.0)
        for b in range(1, N_BITS + 1):
            if float(torch.max((2 ** (N_BITS - b) - 1) * l1 / denom)) <= target:
                break
        out.append(b)
    return out


def class_planes(base: list[int], k: int) -> list[int]:
    """The planes of class ``k``: each layer drops the most further digits
    d' with (2**d' - 1) * 2**-k <= 2**d - 1, keeping at least one."""
    if k == 0:
        return list(base)
    r, out = 2.0**-k, []
    for b in base:
        d = N_BITS - b
        if d == 0:
            out.append(b)
            continue
        d2 = d
        while d2 < N_BITS - 1 and (2 ** (d2 + 1) - 1) * r <= 2**d - 1:
            d2 += 1
        out.append(N_BITS - d2)
    return out


def tile_class(window: np.ndarray, amax: float, max_class: int) -> int:
    if amax <= 0.0:
        return 0
    r = min(1.0, float(np.max(np.abs(window))) / float(amax))
    if r == 0.0:
        return max_class
    return min(max_class, max(0, int(math.floor(-math.log2(r)))))


# ----------------------------------------------------------------- packing


def pack(images, n_clients: int, serving: dict, geom: dict, want: set[int]):
    """The micro-batches the closed loop runs until every image in ``want``
    is done: a list of ``(in_h, in_w, klass, members)``, members being
    ``(image, tile)`` pairs in row order.  Also returns each image's tiling
    ``{image: (h, w, pad_h, pad_w, tiles, canvas)}`` for the images any
    listed micro-batch touches.

    ``images[i]`` is the i-th image sent: the clients send 0 .. n-1 first,
    then each finished image, in the order the micro-batches finish them,
    brings its client's next one.
    """
    depth, tile, batch = geom["depth"], serving["tile"], serving["batch"]
    hal = halo(depth, geom["convs_per_stage"])
    queue, active, groups = deque(range(n_clients)), 0, {}
    nxt, remaining, info, batches, left = n_clients, {}, {}, [], set(want)
    while left:
        while queue and active < serving["max_active"]:
            i = queue.popleft()
            img = images[i]
            h, w = img.shape[:2]
            ph, pw, tiles = tiles_of(h, w, depth, tile, hal)
            canvas = np.zeros((ph, pw, img.shape[2]), np.float32)
            canvas[:h, :w] = img
            amax = float(np.max(np.abs(canvas)))
            octave = int(math.floor(math.log2(amax))) if amax > 0 else 0
            for t, ((y0, x0, y1, x1), _) in enumerate(tiles):
                k = (tile_class(canvas[y0:y1, x0:x1], amax, serving["max_class"])
                     if serving["adaptive"] else 0)
                groups.setdefault((y1 - y0, x1 - x0, k, octave), []).append((i, t))
            info[i] = (h, w, ph, pw, tiles, canvas)
            remaining[i] = len(tiles)
            active += 1
        if not groups:
            raise RuntimeError("the closed loop ran dry before every wanted image was done")
        key = (min(groups, key=lambda g: g[2]) if serving["priority"] else next(iter(groups)))
        members, groups[key] = groups[key][:batch], groups[key][batch:]
        if not groups[key]:
            del groups[key]
        batches.append((key[0], key[1], key[2], members))
        for i, _ in members:
            remaining[i] -= 1
            if remaining[i] == 0:
                active -= 1
                left.discard(i)
                queue.append(nxt)
                nxt += 1
    touched = {i for *_, members in batches for i, _ in members}
    return batches, {i: info[i] for i in touched}


# ----------------------------------------------------------------- forward


def quantize_weights(w: torch.Tensor, qmax: int):
    s = torch.clamp(torch.amax(torch.abs(w), dim=(0, 1, 2), keepdim=True), min=1e-8) / qmax
    return torch.clamp(torch.round(w / s), -qmax, qmax), s


def qconv(x: torch.Tensor, p: dict, planes: int, qmax: int, per_row: bool = False):
    """One int8 3x3 conv with zero SAME padding, bias and ReLU.  With
    ``qmax`` 127 the activations keep their ``planes`` most significant
    bits of ``x + 128``; a smaller ``qmax`` (the lower-precision control)
    keeps every bit of its narrower grid.  ``per_row``: one activation
    scale per tile instead of one per micro-batch (a fault reading: the
    batch mates ignored)."""
    if per_row:
        xs = torch.clamp(torch.amax(torch.abs(x), dim=(1, 2, 3), keepdim=True), min=1e-8) / qmax
    else:
        xs = torch.clamp(torch.amax(torch.abs(x)), min=1e-8) / qmax
    xq = torch.clamp(torch.round(x / xs), -qmax, qmax)
    if qmax == 127 and planes < N_BITS:
        u = xq.to(torch.int64) + 128
        xq = (u & ~((1 << (N_BITS - planes)) - 1)) - 128
    wq, ws = quantize_weights(p["w"], qmax)
    n, h, w, c = x.shape
    xp = torch.zeros((n, h + 2, w + 2, c), dtype=torch.float64, device=x.device)
    xp[:, 1:h + 1, 1:w + 1] = xq.to(torch.float64)
    cols = torch.cat([xp[:, i:i + h, j:j + w] for i in range(3) for j in range(3)], dim=-1)
    acc = cols.reshape(n * h * w, 9 * c) @ wq.reshape(9 * c, -1).to(torch.float64)
    out = acc.to(torch.float32).reshape(n, h, w, -1) * (xs * ws.reshape(-1))
    return torch.relu(out + p["b"])


def forward(params: dict, x: torch.Tensor, planes: list[int], qmax: int = 127,
            per_row: bool = False) -> torch.Tensor:
    """(N, H, W, C) float32 -> (N, H, W, classes) logits; ``planes`` per conv
    in forward order (encoder, bottleneck, decoder)."""
    it = iter(planes)
    skips, h = [], x
    for stage in params["enc"]:
        for conv in stage:
            h = qconv(h, conv, next(it), qmax, per_row)
        skips.append(h)
        n, hh, ww, c = h.shape
        h = h.reshape(n, hh // 2, 2, ww // 2, 2, c).amax(dim=(2, 4))
    for conv in params["bottleneck"]:
        h = qconv(h, conv, next(it), qmax, per_row)
    for d, stage in enumerate(params["dec"]):
        up = h.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
        h = torch.cat([skips[-(d + 1)], up], dim=-1)
        for conv in stage:
            h = qconv(h, conv, next(it), qmax, per_row)
    wh = params["head"]["w"]
    return h @ wh.reshape(-1, wh.shape[-1]) + params["head"]["b"]


def conv_weights(params: dict) -> list[torch.Tensor]:
    ws = [c["w"] for s in params["enc"] for c in s] + [c["w"] for c in params["bottleneck"]]
    return ws + [c["w"] for s in params["dec"] for c in s]


def served_logits(params: dict, images, n_clients: int, serving: dict, geom: dict,
                  want: set[int], *, qmax: int = 127, per_row: bool = False,
                  shift: int = 0) -> dict[int, np.ndarray]:
    """The stitched (h, w, classes) logits of every image in ``want``, as
    the service computes them; ``qmax`` 7 is the int4 control.  Only the
    micro-batches that hold a tile of a wanted image are computed.  Fault
    readings: ``per_row`` ignores the batch mates, ``shift`` runs every
    micro-batch that many classes lower in precision."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        base = base_planes(conv_weights(params), serving["target_rel_err"])
        batches, info = pack(images, n_clients, serving, geom, want)
        dev = params["head"]["w"].device
        outs = {i: np.zeros((info[i][2], info[i][3], params["head"]["w"].shape[-1]), np.float32)
                for i in want}
        for in_h, in_w, k, members in batches:
            if not any(i in want for i, _ in members):
                continue
            x = np.zeros((serving["batch"], in_h, in_w, geom["in_ch"]), np.float32)
            for b, (i, t) in enumerate(members):
                y0, x0, y1, x1 = info[i][4][t][0]
                x[b] = info[i][5][y0:y1, x0:x1]
            with torch.no_grad():
                out = forward(params, torch.from_numpy(x).to(dev),
                              class_planes(base, k + shift), qmax, per_row).cpu().numpy()
            for b, (i, t) in enumerate(members):
                if i in want:
                    (y0, x0, _, _), (cy0, cx0, cy1, cx1) = info[i][4][t]
                    outs[i][cy0:cy1, cx0:cx1] = out[b, cy0 - y0:cy1 - y0, cx0 - x0:cx1 - x0]
        return {i: outs[i][:info[i][0], :info[i][1]] for i in want}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
