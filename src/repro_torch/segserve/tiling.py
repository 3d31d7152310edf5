"""Receptive-field-exact halo tiling of arbitrary images for the U-Net.

The paper's target deployment segments medical images whose sizes have
nothing to do with the calibrated 80x80 geometry.  DSLR-CNN streams CNN
compute over spatial tiles; the original U-Net paper's "overlap-tile"
strategy makes tiling *exact* by giving each tile enough surrounding
context that its core region is unaffected by the artificial cut.  This
module is that strategy for the SAME-padded U-Net in ``models.unet``:

  * :func:`halo_for` — the exact invalid-margin width of an artificial
    tile boundary, from a worst-case walk of the forward graph;
  * :func:`plan_tiles` — a core grid over the (2**depth-aligned, padded)
    canvas, each core dilated by the halo and *clipped to the canvas*, so
    a tile edge that coincides with a real image edge keeps SAME-padding
    semantics and stays bit-comparable to the whole-image forward;
  * :func:`stitch` — writes each tile's valid core back into one canvas;
  * :func:`tiled_forward` — the single-shot reference path the serving
    engine (and the equivalence tests) are built on.

Alignment is the load-bearing invariant: core stride, halo, clip edges and
canvas dims are all multiples of ``2**depth``, so every tile start is
pool-aligned at every level of the ladder and maxpool windows, nearest-
upsample sources and skip concats coincide with the whole-image run.

Invalid-margin recurrence (per artificial side, in pixels at the current
resolution; ``c`` convs per stage): a SAME conv widens the wrong border by
one row (``m += 1`` per conv), a 2x2/2 maxpool keeps a pooled row wrong if
its window touches a wrong row (``m = ceil(m/2)``), nearest upsample
doubles it (``m = 2m``), and skip concat takes the worse branch
(``m = max(m, skip)``).  The input halo must cover the final margin.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def _ceil_to(v: int, mult: int) -> int:
    return -(-v // mult) * mult


def halo_for(depth: int, convs_per_stage: int = 1) -> int:
    """Exact halo width (input pixels per side) that makes an artificial
    tile boundary invisible to the core region, rounded up to a multiple of
    ``2**depth`` so clipped tiles stay pool-aligned.

    E.g. depth=3, one conv per stage (the calibrated geometry): the margin
    walk gives 23 wrong border pixels, so the halo is 24.
    """
    if depth < 0:
        raise ValueError(f"depth {depth} < 0")
    if convs_per_stage < 1:
        raise ValueError(f"convs_per_stage {convs_per_stage} < 1")
    m = 0
    skip_margins = []
    for _ in range(depth):
        m += convs_per_stage  # encoder convs
        skip_margins.append(m)
        m = -(-m // 2)  # 2x2/2 maxpool: ceil
    m += convs_per_stage  # bottleneck convs
    for level in reversed(range(depth)):
        m = 2 * m  # nearest upsample
        m = max(m, skip_margins[level])  # skip concat
        m += convs_per_stage  # decoder convs
    return _ceil_to(max(m, 1), 2**depth)


@dataclass(frozen=True)
class TileSpec:
    """One tile: its input window and its valid core, in canvas coords.

    The input window is the core dilated by the halo and clipped to the
    canvas — where clipping bites, the tile edge *is* an image edge and
    SAME padding there is the real thing, not an artifact.
    """

    y0: int
    x0: int
    y1: int
    x1: int
    core_y0: int
    core_x0: int
    core_y1: int
    core_x1: int

    @property
    def in_h(self) -> int:
        return self.y1 - self.y0

    @property
    def in_w(self) -> int:
        return self.x1 - self.x0

    @property
    def in_shape(self) -> tuple[int, int]:
        return (self.in_h, self.in_w)

    @property
    def crop(self) -> tuple[slice, slice]:
        """Slices selecting the valid core inside this tile's output."""
        return (
            slice(self.core_y0 - self.y0, self.core_y1 - self.y0),
            slice(self.core_x0 - self.x0, self.core_x1 - self.x0),
        )


@dataclass(frozen=True)
class TilePlan:
    """Tiling of one image: padded canvas geometry + the tile set."""

    h: int  # original image dims
    w: int
    pad_h: int  # canvas dims (multiples of 2**depth)
    pad_w: int
    depth: int
    tile: int
    halo: int
    tiles: tuple[TileSpec, ...]

    @property
    def n_tiles(self) -> int:
        return len(self.tiles)

    def halo_overhead(self) -> float:
        """Input pixels computed / canvas pixels — the price of exactness."""
        total = sum(t.in_h * t.in_w for t in self.tiles)
        return total / (self.pad_h * self.pad_w)


def plan_tiles(
    h: int,
    w: int,
    *,
    depth: int,
    convs_per_stage: int = 1,
    tile: int = 32,
    halo: int | None = None,
) -> TilePlan:
    """Plan an exact tiling of an ``h x w`` image.

    The canvas pads ``h, w`` up to multiples of ``2**depth`` (the forward
    needs it; the pad strip rides the bottom/right tiles and is cropped off
    after stitching).  Cores of ``tile x tile`` (smaller at the far edges)
    stride the canvas; ``halo`` defaults to the exact :func:`halo_for`
    width and may be overridden — smaller halos (down to 0, typically with
    ``pad_mode='edge'``) buy cycles at the price of seam error.
    """
    if h < 1 or w < 1:
        raise ValueError(f"image dims {h}x{w} must be positive")
    mult = 2**depth
    if tile < mult or tile % mult:
        raise ValueError(
            f"tile {tile} must be a positive multiple of 2**depth = {mult}"
        )
    if halo is None:
        halo = halo_for(depth, convs_per_stage)
    elif halo < 0:
        raise ValueError(f"halo {halo} < 0")
    else:
        halo = _ceil_to(halo, mult) if halo else 0
    pad_h, pad_w = _ceil_to(h, mult), _ceil_to(w, mult)
    tiles = []
    for cy in range(0, pad_h, tile):
        core_h = min(tile, pad_h - cy)
        for cx in range(0, pad_w, tile):
            core_w = min(tile, pad_w - cx)
            tiles.append(
                TileSpec(
                    y0=max(0, cy - halo),
                    x0=max(0, cx - halo),
                    y1=min(pad_h, cy + core_h + halo),
                    x1=min(pad_w, cx + core_w + halo),
                    core_y0=cy,
                    core_x0=cx,
                    core_y1=cy + core_h,
                    core_x1=cx + core_w,
                )
            )
    return TilePlan(
        h=h, w=w, pad_h=pad_h, pad_w=pad_w, depth=depth, tile=tile,
        halo=halo, tiles=tuple(tiles),
    )


def pad_canvas(image: np.ndarray, plan: TilePlan) -> np.ndarray:
    """(H, W, C) image -> (pad_h, pad_w, C) canvas (zero pad bottom/right)."""
    if image.shape[:2] != (plan.h, plan.w):
        raise ValueError(
            f"image {image.shape[:2]} does not match plan {(plan.h, plan.w)}"
        )
    return np.pad(
        image,
        ((0, plan.pad_h - plan.h), (0, plan.pad_w - plan.w), (0, 0)),
    )


def stitch(plan: TilePlan, outputs: list[np.ndarray]) -> np.ndarray:
    """Assemble per-tile outputs into the (h, w, C) result.

    ``outputs[i]`` is the full forward output of ``plan.tiles[i]``'s input
    window; only its valid core is kept.  Cores partition the canvas, so
    stitching is a plain scatter — no blending, no seams.
    """
    if len(outputs) != plan.n_tiles:
        raise ValueError(f"{len(outputs)} outputs for {plan.n_tiles} tiles")
    c = outputs[0].shape[-1]
    canvas = np.zeros((plan.pad_h, plan.pad_w, c), outputs[0].dtype)
    for spec, out in zip(plan.tiles, outputs):
        if out.shape[:2] != spec.in_shape:
            raise ValueError(
                f"tile output {out.shape[:2]} does not match input window "
                f"{spec.in_shape}"
            )
        cy, cx = spec.crop
        canvas[spec.core_y0 : spec.core_y1, spec.core_x0 : spec.core_x1] = (
            out[cy, cx]
        )
    return canvas[: plan.h, : plan.w]


def tiled_forward(params, image: np.ndarray, cfg, *, tile: int = 32,
                  halo: int | None = None, device=None):
    """Whole-image-equivalent segmentation of one (H, W, C) image, tile by
    tile — the single-shot reference the serving engine micro-batches.

    With the default exact halo and ``cfg.quant_mode='none'`` this matches
    ``unet.forward`` on the padded canvas to float tolerance.  Quantized
    runs differ slightly by design: activation scales are dynamic per tile
    batch, not per image.
    """
    from repro_torch.models import unet

    plan = plan_tiles(
        image.shape[0], image.shape[1], depth=cfg.depth,
        convs_per_stage=cfg.convs_per_stage, tile=tile, halo=halo,
    )
    canvas = pad_canvas(np.asarray(image), plan)
    outs = []
    for spec in plan.tiles:
        xin = canvas[spec.y0 : spec.y1, spec.x0 : spec.x1][None]
        outs.append(unet.forward(params, xin, cfg, device=device)[0].cpu().numpy())
    return stitch(plan, outs), plan
