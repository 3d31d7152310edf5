"""The one traffic generator: reads a mix file of ``perfbench/traffic/`` and
draws its requests from the seed.

A mix is data only (JSON).  ``kind`` says which request stream it describes:

* ``closed_loop_images``: ``clients`` callers, each sending one image and
  waiting for its result before it sends the next.  ``image`` sets the
  images' shape: a canvas of ``height`` x ``width`` pixels (each drawn
  uniformly from its ``[lo, hi]``), or, with ``crop_to_brain``, the brain's
  bounding box of that size; ``modalities`` channels; the brain ellipse's
  semi-axes as shares of the canvas; one tumour of radius ``tumour_radius``
  px with the per-modality contrasts of its core, enhancing rim and oedema.
  The clients send a fixed pool of ``pool_images`` such slices, drawn from
  ``pool_seed``, over and over, in an order drawn from the run's seed.
* ``train_batches``: token batches of ``global_batch`` rows of ``seq_len`` +
  1 tokens, split into ``microbatches`` (see ``runners/lm_qat.py``).

The images of a closed loop are one fixed set, drawn from the mix's own
``pool_seed``, and the run's seed draws the order in which the clients
send them: every seed sends the same slices, so a seed moves the work
only by the order, through the packing, and not by the slices it drew.
Image ``i`` of stream ``s`` is the pool's ``order[i mod pool_images]``-th,
a pure function of ``(pool_seed, s)`` and ``(seed, s, i mod
pool_images)``, so any run, and the reference after it, can draw any one
of them again.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

TRAFFIC_DIR = Path(__file__).resolve().parent / "traffic"

#: Streams of one seed: the measured window's images, and the warm-up's.
WINDOW, WARMUP = 0, 1


def load(name: str, root: Path | None = None) -> dict:
    """The mix file ``traffic/<name>.json``."""
    d = TRAFFIC_DIR if root is None else Path(root) / "perfbench" / "traffic"
    return json.loads((d / f"{name}.json").read_text())


def rng_for(seed: int, stream: int, index: int) -> np.random.Generator:
    """The generator of one request: a pure function of its three numbers."""
    return np.random.default_rng(np.random.SeedSequence([int(seed) % 2**64, stream, index]))


def _draw(rng: np.random.Generator, lo_hi) -> float:
    lo, hi = lo_hi
    return float(lo) if lo == hi else float(rng.uniform(lo, hi))


def _draw_int(rng: np.random.Generator, lo_hi) -> int:
    lo, hi = (int(v) for v in lo_hi)
    return lo if lo == hi else int(rng.integers(lo, hi + 1))


#: Side of the square bank of white noise that slices take their noise
#: from, at an offset drawn per slice: one large draw per run, not one per
#: slice, keeps the client's share of the host loop small.
NOISE_BANK = 512


def noise_bank(seed: int, stream: int, channels: int) -> np.ndarray:
    return rng_for(seed, stream, -1 % 2**32).standard_normal(
        (NOISE_BANK, NOISE_BANK, channels), dtype=np.float32)


def brain_slice(spec: dict, rng: np.random.Generator, bank: np.ndarray) -> np.ndarray:
    """One BraTS-shaped (H, W, modalities) float32 slice: a brain ellipse on
    a zero background, tissue texture and noise, one tumour (core,
    enhancing rim, oedema) with per-modality contrasts, every modality
    z-scored inside the brain as BraTS preprocessing does (its mean and
    deviation taken on every fourth row and column)."""
    h, w = _draw_int(rng, spec["height"]), _draw_int(rng, spec["width"])
    c = int(spec["modalities"])
    if spec.get("crop_to_brain"):
        # the slice is the brain's bounding box: the ellipse touches each edge
        cy, cx, ay, ax = (h - 1) / 2, (w - 1) / 2, h / 2, w / 2
    else:
        ay = h * _draw(rng, spec["brain_semi_axis_y"])
        ax = w * _draw(rng, spec["brain_semi_axis_x"])
        jit = float(spec["brain_jitter"])
        cy = (h - 1) / 2 + _draw(rng, (-jit, jit))
        cx = (w - 1) / 2 + _draw(rng, (-jit, jit))
    y = np.arange(h, dtype=np.float32)[:, None]
    x = np.arange(w, dtype=np.float32)[None, :]
    brain = ((y - cy) / ay) ** 2 + ((x - cx) / ax) ** 2 <= 1.0
    # the tumour's centre inside the brain, at up to 0.6 of its radius
    r, phi = 0.6 * np.sqrt(rng.uniform()), rng.uniform(0, 2 * np.pi)
    ty, tx = cy + r * ay * np.sin(phi), cx + r * ax * np.cos(phi)
    rt = _draw(rng, spec["tumour_radius"])
    d2 = ((y - ty) ** 2 + (x - tx) ** 2) / np.float32(rt * rt)
    # 0 tissue, 1 core, 2 enhancing rim, 3 oedema
    label = (d2 <= 2.25).astype(np.int8) * 3
    label[d2 <= 1.0] = 2
    label[d2 <= 0.5] = 1
    table = np.zeros((4, c), np.float32)
    for i, k in enumerate(("core", "rim", "oedema"), start=1):
        table[i] = spec["contrast"][k]
    # tissue: one low-frequency pattern per modality, white noise, the tumour
    fy, fx = rng.uniform(0.02, 0.08, size=(2, c)).astype(np.float32)
    py, px = rng.uniform(0, 2 * np.pi, size=(2, c)).astype(np.float32)
    oy, ox = (int(v) for v in rng.integers(0, NOISE_BANK - np.array([h, w]) + 1))
    img = np.cos(y[..., None] * fy + py) * (float(spec["texture"]) * np.cos(x[..., None] * fx + px))
    img += float(spec["noise"]) * bank[oy:oy + h, ox:ox + w]
    img += table[label]
    sample = img[::4, ::4][brain[::4, ::4]]
    mean, inv = sample.mean(axis=0), 1.0 / sample.std(axis=0)
    return np.where(brain[..., None], (img - mean) * inv, np.float32(0)).astype(np.float32)


class ImageStream:
    """Image ``i`` of one stream of one seed: the pool's ``order[i mod
    pool_images]``-th, where the pool is the mix's fixed set of images
    (drawn from ``pool_seed``) and ``order`` a permutation drawn from the
    seed.  The pool is drawn once (:meth:`draw`, in set-up), so that the
    clients' drawing is not part of the window's host work."""

    def __init__(self, mix: dict, seed: int, stream: int = WINDOW):
        if mix["kind"] != "closed_loop_images":
            raise ValueError(f"mix {mix.get('name')!r} is {mix['kind']!r}, not closed_loop_images")
        self.spec, self.stream = mix["image"], stream
        self.pool_seed = int(mix["pool_seed"])
        self.pool = int(mix["pool_images"])
        self.order = rng_for(seed, stream, -2 % 2**32).permutation(self.pool)
        self.bank = noise_bank(self.pool_seed, stream, int(self.spec["modalities"]))
        self.drawn: dict[int, np.ndarray] = {}

    def draw(self) -> None:
        for i in range(self.pool):
            self[i]

    def __getitem__(self, i: int) -> np.ndarray:
        j = int(self.order[i % self.pool])
        if j not in self.drawn:
            self.drawn[j] = brain_slice(self.spec, rng_for(self.pool_seed, self.stream, j),
                                        self.bank)
        return self.drawn[j]


def token_batch(mix: dict, seed: int, step: int, vocab: int) -> np.ndarray:
    """Step ``step``'s tokens, (microbatches, rows, seq_len + 1) int64: a
    Zipf-like stream (exponent ``zipf``) folded into the vocabulary, so
    frequent tokens dominate as in text and the loss moves."""
    rng = rng_for(seed, WINDOW, step)
    b, s, mb = int(mix["global_batch"]), int(mix["seq_len"]), int(mix["microbatches"])
    toks = rng.zipf(float(mix["zipf"]), size=(b, s + 1)).astype(np.int64) % vocab
    return toks.reshape(mb, b // mb, s + 1)
