"""Collective bytes, an op census and roofline terms, as the reference's
``launch/hlo_analysis.py`` computes them.

``collective_stats`` parses compiled (per-device) HLO text and sums the
operand bytes of every all-gather / all-reduce / reduce-scatter / all-to-all
/ collective-permute.  The port compiles no HLO: its dry run
(``launch.dryrun``) counts the same kinds with their operand bytes by
running one rank's step on ``meta`` tensors
(``parallel.collectives.collective_stats`` returns this layout).  The
parser is kept for HLO text from elsewhere.

Roofline convention: every term is *seconds per step per chip*,

    compute_s    = FLOPs (per chip)            / peak_flops
    memory_s     = HBM bytes (per chip)        / hbm_bw
    collective_s = collective bytes (per chip) / link_bw

with the peaks given by the caller; the defaults are the NVIDIA H100 SXM
data sheet's (``H100_PEAK_FLOPS`` etc.).
"""
from __future__ import annotations

import re
from collections import defaultdict

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core peak, HBM3 bandwidth,
# NVLink (4th generation) bandwidth per GPU.
H100_PEAK_FLOPS = 989e12
H100_HBM_BW = 3.35e12
H100_LINK_BW = 900e9

_DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1,
    "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16,
    "token": 0, "opaque": 0,
}

_DEF_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*\(?([a-z0-9]+)\[([\d,]*)\]"
)
_COLL_KINDS = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)


def _bytes_of(dtype: str, dims: str) -> int:
    n = 1
    if dims:
        for d in dims.split(","):
            n *= int(d)
    return n * _DTYPE_BYTES.get(dtype, 4)


def collective_stats(hlo_text: str) -> dict:
    """Sum operand bytes per collective kind from post-SPMD HLO text."""
    sizes: dict[str, int] = {}
    for line in hlo_text.splitlines():
        m = _DEF_RE.match(line)
        if m:
            sizes[m.group(1)] = _bytes_of(m.group(2), m.group(3))
    per_kind: dict[str, int] = defaultdict(int)
    counts: dict[str, int] = defaultdict(int)
    for line in hlo_text.splitlines():
        stripped = line.strip()
        m = _DEF_RE.match(line)
        for kind in _COLL_KINDS:
            # match the op invocation (e.g. "= bf16[...] all-gather("), not
            # "-done"/"-start" suffixes twice: count -start OR the sync form.
            if re.search(rf"\b{kind}(-start)?\(", stripped):
                if f"{kind}-done" in stripped:
                    continue
                args = stripped.split(f"{kind}(", 1)[-1] if f"{kind}(" in stripped \
                    else stripped.split(f"{kind}-start(", 1)[-1]
                args = args.split(")", 1)[0]
                ops = re.findall(r"%([\w.\-]+)", args)
                nbytes = sum(sizes.get(o, 0) for o in ops)
                if nbytes == 0 and m:
                    # fallback: result size (all-reduce result == operand)
                    nbytes = _bytes_of(m.group(2), m.group(3))
                per_kind[kind] += nbytes
                counts[kind] += 1
                break
    return {
        "bytes_by_kind": dict(per_kind),
        "counts_by_kind": dict(counts),
        "total_bytes": int(sum(per_kind.values())),
        "total_count": int(sum(counts.values())),
    }


def remat_census(hlo_text: str) -> dict:
    """Rough remat/redundancy signal: counts of dot/convolution ops."""
    dots = len(re.findall(r"\bdot\(", hlo_text))
    fusions = len(re.findall(r"\bfusion\(", hlo_text))
    return {"dot_ops": dots, "fusions": fusions}


def analytic_hbm_bytes(
    kind: str,
    *,
    w_bytes: float,          # sharded bf16 param bytes per chip
    opt_bytes: float = 0.0,  # sharded f32 master+m+v bytes per chip
    resid_bytes: float = 0.0,  # one layer's residual activation per chip
    n_layers: int = 0,
    logits_bytes: float = 0.0,  # per-chip logits tensor bytes (f32, sharded)
    cache_bytes: float = 0.0,  # per-chip KV-cache/state bytes
    microbatches: int = 1,
) -> dict:
    """Analytic per-chip HBM traffic per step (bytes).

    Summing every op's operand bytes ignores fusion, a >10x upper bound on
    real HBM traffic.  This model counts what crosses HBM in a fused
    program:

    train:   weights read 3x per microbatch (fwd, remat-recompute, bwd)
             + grad accumulators rw per microbatch (f32, 2x param bytes each
               way) + optimizer update (read grads+master+m+v, write all)
             + saved residuals (write fwd, read bwd, write recompute)
             + logits (write fwd, read bwd, write dlogits)
    prefill: weights once, residual stream 2x, cache write, logits write
    decode:  weights once + full cache read (+ small vectors) — the classic
             bandwidth-bound regime
    """
    if kind == "train":
        grads = 2 * w_bytes  # f32 copy of every param
        weights_traffic = 3 * w_bytes * microbatches
        grad_traffic = 2 * grads * microbatches  # accumulate rw
        opt_traffic = grads + 2 * opt_bytes + w_bytes  # read g, rw opt, write w
        act_traffic = 3 * n_layers * resid_bytes
        logit_traffic = 3 * logits_bytes
        total = weights_traffic + grad_traffic + opt_traffic + act_traffic + logit_traffic
        parts = dict(weights=weights_traffic, grads=grad_traffic, opt=opt_traffic,
                     activations=act_traffic, logits=logit_traffic)
    elif kind == "prefill":
        act_traffic = 2 * n_layers * resid_bytes
        total = w_bytes + act_traffic + cache_bytes + logits_bytes
        parts = dict(weights=w_bytes, activations=act_traffic,
                     cache=cache_bytes, logits=logits_bytes)
    else:  # decode
        total = w_bytes + cache_bytes + logits_bytes
        parts = dict(weights=w_bytes, cache=cache_bytes, logits=logits_bytes)
    return {"total": total, "parts": parts}


def roofline(flops: float, bytes_accessed: float, coll_bytes: float, *,
             peak_flops: float = H100_PEAK_FLOPS, hbm_bw: float = H100_HBM_BW,
             link_bw: float = H100_LINK_BW) -> dict:
    """The three terms of one step on one chip, the dominant one and the
    step's lower bound (the largest term).  The default peaks are the H100
    SXM data sheet's: bf16 dense 989e12 FLOP/s, HBM3 3.35e12 B/s, NVLink
    900e9 B/s."""
    compute_s = flops / peak_flops
    memory_s = bytes_accessed / hbm_bw
    collective_s = coll_bytes / link_bw
    terms = {"compute_s": compute_s, "memory_s": memory_s, "collective_s": collective_s}
    dom = max(terms, key=terms.get)
    bound = max(terms.values())
    total = max(bound, 1e-30)
    return {
        **terms,
        "dominant": dom.replace("_s", ""),
        "step_time_lower_bound_s": bound,
        "roofline_fraction_of_dominant": {
            k: (v / total) for k, v in terms.items()
        },
    }
