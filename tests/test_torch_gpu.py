"""The port's CUDA kernels on the card, held against their plain PyTorch
versions, and the two serving engines on the card against the CPU.

Every test here needs a CUDA card and skips without one.  The file imports
no jax (the machine with the card has none), so it runs there with

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest``: the suite's shared conftest imports jax).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import autotune
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import QuantConfig
from repro_torch.core import quant
from repro_torch.kernels import mma_matmul as mk
from repro_torch.kernels import ops
from repro_torch.models import transformer, unet
from repro_torch.obs.events import RecordingSink
from repro_torch.segserve import SegEngine
from repro_torch.serve import Engine, Gateway, LMAdapter, Request, SegAdapter
from repro_torch.segserve.synth import phantom_image

SWEEP = [
    (4, 32, 8), (32, 128, 32), (128, 512, 128), (37, 100, 65),
    (1, 7, 3), (256, 1024, 256), (64, 300, 90),
]

# The seven 3x3 convs of the calibrated U-Net (80x80x4, base 48, depth 3)
# at one 80x80 window: (M, K = 9*Cin, N).
LAYER_SHAPES = [
    (6400, 36, 48), (1600, 432, 96), (400, 864, 192), (100, 1728, 384),
    (400, 5184, 192), (1600, 2592, 96), (6400, 1296, 48),
]

# Yi-6B's linears at batched decode (M = 4 slots): wq/wo, wk/wv, w_gate/w_up,
# w_down, the head.
DECODE_SHAPES = [(4, 4096, 4096), (4, 4096, 512), (4, 4096, 11008),
                 (4, 11008, 4096), (4, 4096, 64000)]

# minitron_4b's linears (K, N): wq/wo, wk/wv, w_gate/w_up, w_down, the head.
# The gateway serves it at batch 20: one pass of three n8 fragments.
MINITRON_SHAPES = [(3072, 3072), (3072, 1024), (3072, 9216), (9216, 3072), (3072, 256000)]
# Their K splits on 132 SMs at up to 32 rows (one row tile).
MINITRON_SPLITS = {(3072, 3072): 6, (3072, 1024): 12, (3072, 9216): 2, (9216, 3072): 6,
                   (3072, 256000): 1}

# Bf16 logits of the small LM, card against CPU, relative to the call's
# largest logit.  The integer products and the scaled epilogue are equal and
# most calls agree bit for bit, but a float op between them (an RMSNorm
# mean, an exp) now and then rounds the other way; the next linear's
# per-tensor activation scale then moves every int8 level of the tensor,
# and the difference rides the KV cache into later calls.  On this model at
# 8 planes that stays near 0.03 of the largest logit; with plane truncation
# one moved level weighs 2**(8 - planes) as much.
LM_LOGIT_REL = 0.05


@pytest.fixture
def cuda():
    """The CUDA device, or a skip where there is no card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _kernel_vs_plain(dev, m, k, n, planes, signed=True, seed=0, scaled=False, bm=None,
                     offset=0, splits=None):
    """``bm`` forces the unscaled kernel's block height, ``splits`` the
    scaled kernel's K splits; ``offset`` makes x and w views that many bytes
    into their storage."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(-128, 128, (m * k + offset,), dtype=torch.int8, generator=g)
    w = torch.randint(-128, 128, (k * n + offset,), dtype=torch.int8, generator=g)
    x, w = x.to(dev)[offset:].view(m, k), w.to(dev)[offset:].view(k, n)
    if bm is not None:
        got = mk._launch(x, w, planes, signed, bm=bm)
        want = mk.mma_matmul_plain(x, w, planes=planes, signed=signed)
    elif scaled:
        xs = (torch.rand(1, generator=g) * 0.1 + 1e-3).to(dev)
        ws = (torch.rand(n, generator=g) * 0.01 + 1e-4).to(dev)
        got = (mk.mma_matmul_scaled_kernel(x, w, xs, ws, planes=planes, signed=signed)
               if splits is None else mk._launch_scaled(x, w, xs, ws, planes, signed, splits=splits))
        want = mk.mma_matmul_scaled_plain(x, w, xs, ws, planes=planes, signed=signed)
    else:
        got = mk.mma_matmul_kernel(x, w, planes=planes, signed=signed)
        want = mk.mma_matmul_plain(x, w, planes=planes, signed=signed)
    torch.cuda.synchronize()
    assert torch.equal(got, want), (m, k, n, planes, signed, scaled)


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", SWEEP)
@pytest.mark.parametrize("planes", [8, 5, 2])
def test_gpu_kernel_vs_plain_sweep(cuda, m, k, n, planes):
    _kernel_vs_plain(cuda, m, k, n, planes)


@pytest.mark.gpu
@pytest.mark.parametrize("planes", range(1, 9))
@pytest.mark.parametrize("signed", [True, False])
def test_gpu_kernel_vs_plain_every_variant(cuda, planes, signed):
    _kernel_vs_plain(cuda, 67, 129, 70, planes, signed=signed)


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", LAYER_SHAPES)
def test_gpu_kernel_vs_plain_layer_shapes(cuda, m, k, n):
    _kernel_vs_plain(cuda, 4 * m, k, n, 8)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [7, 36, 129, 300, 5184])
@pytest.mark.parametrize("n", [3, 48, 70, 192])
def test_gpu_kernel_staging_paths(cuda, k, n):
    """Each operand's staging path: 16-byte copies (K 5184; N 48, 192),
    4-byte copies (K 36, 300) and byte loads (K 7, 129; N 3, 70)."""
    _kernel_vs_plain(cuda, 67, k, n, 8)


@pytest.mark.gpu
@pytest.mark.parametrize("offset,width", [(1, 1), (4, 4)])
def test_gpu_kernel_misaligned_views(cuda, offset, width):
    """Contiguous views 1 or 4 bytes into their storage: the 16-byte path
    is refused for both operands, and the result is the same."""
    x = torch.zeros(300 * 48 + offset, dtype=torch.int8, device=cuda)[offset:]
    assert mk.copy_width(x.data_ptr(), 48) == width
    _kernel_vs_plain(cuda, 67, 300, 48, 8, offset=offset)
    _kernel_vs_plain(cuda, 45, 5184, 192, 5, offset=offset)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 15, 16, 17, 33])
@pytest.mark.parametrize("bm", [32, 64])
def test_gpu_kernel_ragged_rows_on_both_tiles(cuda, m, bm):
    _kernel_vs_plain(cuda, m, 256, 80, 8, bm=bm)


@pytest.mark.gpu
@pytest.mark.parametrize("planes", range(1, 9))
@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("bm", [32, 64])
def test_gpu_kernel_every_variant_on_both_tiles(cuda, planes, signed, bm):
    _kernel_vs_plain(cuda, 33, 256, 80, planes, signed=signed, bm=bm)


@pytest.mark.gpu
def test_gpu_one_launch_per_call(cuda):
    """The merged path is one kernel launch per call, whatever ``planes``."""
    x = torch.ones((32, 128), dtype=torch.int8, device=cuda)
    w = torch.ones((128, 32), dtype=torch.int8, device=cuda)
    before = mk.launches
    for planes in (8, 3):
        ops.mma_matmul(x, w, planes=planes, device=cuda)
    torch.cuda.synchronize()
    assert mk.launches == before + 2


@pytest.mark.gpu
def test_gpu_engine_equals_cpu_engine(cuda):
    """A small U-Net served on the card through the kernel gives the CPU
    plain path's accounting and, up to the float head, its logits."""
    cfg = unet.UNetConfig(hw=16, in_ch=3, base=8, depth=2, quant_mode="mma_int8",
                          plane_schedule=(6, 5, 4, 5, 7))
    params = unet.init_params(0, cfg, device="cpu")
    images = [phantom_image(48, 40, 3, seed=0), phantom_image(24, 24, 3, seed=1)]
    before = mk.launches
    got = SegEngine(cfg, params, tile=16, device=cuda).run(images)
    assert mk.launches > before
    want = SegEngine(cfg, params, tile=16, device="cpu").run(images)
    for a, b in zip(got, want):
        assert (a.cycles, a.pj, a.class_counts) == (b.cycles, b.pj, b.class_counts)
        np.testing.assert_allclose(a.logits, b.logits, atol=1e-5)


# ------------------------------------------------------- the scaled kernel


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", SWEEP + [(16, 96, 40), (64, 256, 128), (3, 50, 7)])
@pytest.mark.parametrize("planes", [8, 5, 2])
def test_gpu_scaled_kernel_vs_plain_sweep(cuda, m, k, n, planes):
    _kernel_vs_plain(cuda, m, k, n, planes, scaled=True)


@pytest.mark.gpu
@pytest.mark.parametrize("planes", range(1, 9))
@pytest.mark.parametrize("signed", [True, False])
def test_gpu_scaled_kernel_vs_plain_every_variant(cuda, planes, signed):
    _kernel_vs_plain(cuda, 67, 129, 70, planes, signed=signed, scaled=True)
    _kernel_vs_plain(cuda, 3, 129, 70, planes, signed=signed, scaled=True)  # one n8 fragment


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", DECODE_SHAPES)
def test_gpu_scaled_kernel_vs_plain_decode_shapes(cuda, m, k, n):
    for planes in (8, 5):
        _kernel_vs_plain(cuda, m, k, n, planes, scaled=True)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 3, 4, 8, 9, 15, 16])
@pytest.mark.parametrize("k", [7, 129, 4096, 11008])
@pytest.mark.parametrize("n", [3, 70, 512, 4096])
def test_gpu_decode_kernel_vs_plain(cuda, m, k, n):
    """The scaled kernel at decode shapes (M <= 16) on one and two n8
    fragments, 16-byte, 4-byte and byte staging, one to 86 K tiles, its
    chosen splits."""
    _kernel_vs_plain(cuda, m, k, n, 8, scaled=True)


@pytest.mark.gpu
@pytest.mark.parametrize("planes", range(1, 9))
@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("m", [4, 9])
def test_gpu_decode_kernel_every_variant(cuda, planes, signed, m):
    _kernel_vs_plain(cuda, m, 129, 70, planes, signed=signed, scaled=True)
    _kernel_vs_plain(cuda, m, 4096, 512, planes, signed=signed, scaled=True)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 4, 16])
@pytest.mark.parametrize("k", [129, 4096, 11008])
@pytest.mark.parametrize("n", [70, 4096])
def test_gpu_decode_kernel_forced_splits(cuda, m, k, n):
    """The split sum is exact at 1, 2 and the most splits the chooser gives."""
    for splits in sorted({1, min(2, -(-k // mk.SCALED_BK)), mk.max_splits(k)}):
        _kernel_vs_plain(cuda, m, k, n, 5, scaled=True, splits=splits)


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [1, 4])
def test_gpu_decode_kernel_misaligned_views(cuda, offset):
    for m, k, n in ((4, 4096, 512), (9, 129, 70), (16, 11008, 4096)):
        _kernel_vs_plain(cuda, m, k, n, 5, scaled=True, offset=offset)


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(4, 4096, 512), (9, 11008, 4096)])
def test_gpu_decode_kernel_graph_replayed_twice(cuda, m, k, n):
    """A split call captured in a CUDA graph zeroes its workspace at every
    replay: two replays give equal outputs, equal to the plain version."""
    assert mk.split_k(m, k, n, torch.cuda.get_device_properties(0).multi_processor_count) > 1
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randint(-128, 128, (m, k), dtype=torch.int8, device=cuda, generator=g)
    w = torch.randint(-128, 128, (k, n), dtype=torch.int8, device=cuda, generator=g)
    xs = torch.rand(1, device=cuda, generator=g) * 0.1 + 1e-3
    ws = torch.rand(n, device=cuda, generator=g) * 0.01 + 1e-4
    mk.mma_matmul_scaled_kernel(x, w, xs, ws, planes=5)  # build and load outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = mk.mma_matmul_scaled_kernel(x, w, xs, ws, planes=5)
    outs = []
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        outs.append(out.clone())
    assert torch.equal(outs[0], outs[1])
    assert torch.equal(outs[0], mk.mma_matmul_scaled_plain(x, w, xs, ws, planes=5))


@pytest.mark.gpu
def test_gpu_decode_kernel_refuses_bad_splits(cuda):
    x = torch.zeros((4, 300), dtype=torch.int8, device=cuda)
    w = torch.zeros((300, 70), dtype=torch.int8, device=cuda)
    xs, ws = torch.ones(1, device=cuda), torch.ones(70, device=cuda)
    for splits in (0, 4):  # 300 is 3 K tiles
        with pytest.raises(RuntimeError, match="launch failed"):
            mk._launch_scaled(x, w, xs, ws, 8, True, splits=splits)
    with pytest.raises(RuntimeError, match="launch failed"):  # above 16 rows too
        mk._launch_scaled(torch.zeros((17, 300), dtype=torch.int8, device=cuda), w, xs, ws, 8,
                          True, splits=4)


@pytest.mark.gpu
def test_gpu_scaled_one_launch_per_call(cuda):
    """One launch of the scaled kernel per call, the unscaled one untouched;
    the activation scale stays on the card (no host round trip)."""
    x = torch.ones((2, 3, 128), dtype=torch.int8, device=cuda)
    w = torch.ones((128, 32), dtype=torch.int8, device=cuda)
    xs, ws = torch.tensor(0.5, device=cuda), torch.full((1, 32), 0.25, device=cuda)
    before = (mk.launches, mk.scaled_launches)
    for planes in (8, 3):
        out = ops.mma_matmul_scaled(x, w, xs, ws, planes=planes, device=cuda)
    torch.cuda.synchronize()
    assert (mk.launches, mk.scaled_launches) == (before[0], before[1] + 2)
    assert out.shape == (2, 3, 32) and out.dtype == torch.float32


@pytest.mark.gpu
def test_gpu_lm_engine_equals_cpu_engine(cuda):
    """A small quantized LM served through ``Engine`` on the card (both
    kernels: wq/wo/MLP/head are int8, wk/wv stay bf16) gives the CPU plain
    path's tokens, and its logits within ``LM_LOGIT_REL`` at every call.
    Should a greedy token differ, it must be a near tie: every call up to
    the first one whose argmax differs is held to the tolerance (so the
    parting top-2 margin is within twice it), and after it the two engines
    see different tokens."""
    cfg = get_smoke_config("yi_6b").replace(
        d_model=256, d_ff=512, n_heads=4, n_kv_heads=2, head_dim=64, vocab=512,
        quant=QuantConfig(mode="mma_int8", impl="kernel"))
    params = quant.quantize_params_int8(transformer.init_params(0, cfg, device="cpu"))
    runs = []
    for dev in (cuda, "cpu"):
        rng = np.random.default_rng(0)
        reqs = [Request(i, rng.integers(0, 512, n).astype(np.int32), max_new=4)
                for i, n in enumerate((3, 6, 4, 5))]
        eng = Engine(cfg, params, batch=2, max_seq=32, device=dev)
        logits, inner = [], eng.decode_fn

        def decode(*a, inner=inner, logits=logits):
            out = inner(*a)
            logits.append(out[0][:, -1].to(torch.float32).cpu())
            return out

        eng.decode_fn = decode
        before = (mk.launches, mk.scaled_launches)
        done = eng.run(reqs)
        torch.cuda.synchronize()
        launched = (mk.launches - before[0], mk.scaled_launches - before[1])
        runs.append(([r.out for r in done], logits, launched))
    (tok_g, lg_g, launched_g), (tok_c, lg_c, launched_c) = runs
    # per call: wk, wv unscaled in each of 2 layers; wq, wo, 3 MLP x 2 + head scaled
    assert launched_g == (4 * len(lg_g), 11 * len(lg_g)) and launched_c == (0, 0)
    assert len(lg_g) == len(lg_c)
    for i, (a, b) in enumerate(zip(lg_g, lg_c)):
        rel = float((a - b).abs().max() / b.abs().max())
        assert rel <= LM_LOGIT_REL, f"decode call {i}: logits differ by {rel} of the largest"
        if not torch.equal(a.argmax(-1), b.argmax(-1)):
            break
    else:
        assert tok_g == tok_c


@pytest.mark.gpu
@pytest.mark.parametrize("m", [17, 20, 32])
@pytest.mark.parametrize("k,n", MINITRON_SHAPES)
def test_gpu_scaled_kernel_vs_plain_minitron_shapes(cuda, m, k, n):
    """The scaled kernel above 16 rows (three or four n8 fragments in one
    pass; the gateway's batch 20) on every minitron_4b linear, at the K
    splits the chooser gives."""
    assert mk.split_k(m, k, n, 132) == MINITRON_SPLITS[(k, n)]
    _kernel_vs_plain(cuda, m, k, n, 5, scaled=True)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [17, 20, 24, 25, 32, 33, 64, 100, 512])
@pytest.mark.parametrize("k", [7, 129, 3072, 9216])
@pytest.mark.parametrize("n", [3, 70, 1024, 4096])
def test_gpu_row_tiled_kernel_vs_plain(cuda, m, k, n):
    """The scaled kernel above 16 rows: three and four n8 fragments in one
    pass, row tiles of 32 (a ragged last tile at 33 and 100 rows), every
    staging path, one to 72 K tiles, its chosen splits."""
    _kernel_vs_plain(cuda, m, k, n, 8, scaled=True)


@pytest.mark.gpu
@pytest.mark.parametrize("planes", range(1, 9))
@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("m", [20, 40])
def test_gpu_row_tiled_kernel_every_variant(cuda, planes, signed, m):
    _kernel_vs_plain(cuda, m, 129, 70, planes, signed=signed, scaled=True)
    _kernel_vs_plain(cuda, m, 3072, 1024, planes, signed=signed, scaled=True)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [17, 20, 33, 64])
@pytest.mark.parametrize("k", [129, 3072, 9216])
@pytest.mark.parametrize("n", [70, 1024])
def test_gpu_row_tiled_kernel_forced_splits(cuda, m, k, n):
    """The split sum is exact per row tile at 1, 2 and the most splits the
    chooser gives."""
    for splits in sorted({1, min(2, -(-k // mk.SCALED_BK)), mk.max_splits(k)}):
        _kernel_vs_plain(cuda, m, k, n, 5, scaled=True, splits=splits)


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [1, 4])
def test_gpu_row_tiled_kernel_misaligned_views(cuda, offset):
    for m, k, n in ((20, 3072, 1024), (25, 129, 70), (40, 9216, 3072)):
        _kernel_vs_plain(cuda, m, k, n, 5, scaled=True, offset=offset)


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(20, 3072, 1024), (40, 9216, 3072)])
def test_gpu_row_tiled_kernel_graph_replayed_twice(cuda, m, k, n):
    """A split call above 16 rows captured in a CUDA graph (the wrapper's
    once-per-device preparation runs at the first call, before the
    capture): two replays give equal outputs, equal to the plain version."""
    assert mk.split_k(m, k, n, torch.cuda.get_device_properties(0).multi_processor_count) > 1
    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randint(-128, 128, (m, k), dtype=torch.int8, device=cuda, generator=g)
    w = torch.randint(-128, 128, (k, n), dtype=torch.int8, device=cuda, generator=g)
    xs = torch.rand(1, device=cuda, generator=g) * 0.1 + 1e-3
    ws = torch.rand(n, device=cuda, generator=g) * 0.01 + 1e-4
    mk.mma_matmul_scaled_kernel(x, w, xs, ws, planes=5)  # build, load and prepare first
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = mk.mma_matmul_scaled_kernel(x, w, xs, ws, planes=5)
    outs = []
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        outs.append(out.clone())
    assert torch.equal(outs[0], outs[1])
    assert torch.equal(outs[0], mk.mma_matmul_scaled_plain(x, w, xs, ws, planes=5))


@pytest.mark.gpu
@pytest.mark.parametrize("m", [20, 40])
def test_gpu_row_tiled_kernel_refuses_bad_splits(cuda, m):
    x = torch.zeros((m, 300), dtype=torch.int8, device=cuda)
    w = torch.zeros((300, 70), dtype=torch.int8, device=cuda)
    xs, ws = torch.ones(1, device=cuda), torch.ones(70, device=cuda)
    for splits in (0, 4, 70000):  # 300 is 3 K tiles
        with pytest.raises(RuntimeError, match="launch failed"):
            mk._launch_scaled(x, w, xs, ws, 8, True, splits=splits)


def _gateway_run(dev, lm, seg):
    """A small mixed gateway (fair, preemptive, traced): five LM requests in
    two QoS classes at batch 20, two seg images under a plan."""
    from repro_torch.obs.events import RecordingSink

    sink = RecordingSink()
    (cfg, params), (ucfg, uparams, plan) = lm, seg
    gw = Gateway([LMAdapter(cfg, params, batch=20, max_seq=24, device=dev),
                  SegAdapter(ucfg, uparams, plan=plan, batch=2, device=dev)],
                 policy="fair", round_budget=300_000,
                 shares={"lm": 0.3, "fast": 0.3, "seg": 0.3}, sink=sink)
    rng = np.random.default_rng(0)
    for i in range(5):
        gw.submit("lm", rng.integers(0, cfg.vocab, 3 + i), max_new=4,
                  qos="fast" if i % 2 else None)
    for s in (0, 1):
        gw.submit("seg", phantom_image(40, 48, ucfg.in_ch, seed=s))
    before = (mk.launches, mk.scaled_launches)
    gw.drain(max_rounds=1_000)
    torch.cuda.synchronize()
    return gw, sink, (mk.launches - before[0], mk.scaled_launches - before[1])


@pytest.mark.gpu
def test_gpu_gateway_serves_mixed_real_traffic(cuda):
    """Both adapters on the card behind one gateway: every request done,
    15 scaled launches per LM decode call (M = 20), 5 unscaled per seg
    micro-batch, and the event stream byte for byte a ``device='cpu'`` run's
    (every event counts work, none depends on a float value)."""
    cfg = get_smoke_config("minitron_4b").replace(quant=QuantConfig(mode="mma_int8",
                                                                    impl="kernel"))
    params = transformer.init_params(0, cfg, device="cpu", int8_min_dim=64)
    ucfg, uparams, images = _tuning_net()
    plan = autotune.tune_unet(uparams, ucfg, images, target_rel_err=0.2, tile=32, device="cpu")
    runs = [_gateway_run(dev, (cfg, params), (ucfg, uparams, plan)) for dev in (cuda, "cpu")]
    (gw, sink, launched), (gw_c, sink_c, launched_c) = runs
    assert all(g.done for g in gw.requests) and len(gw.requests) == 7
    assert all(len(g.handle.out) == 4 for g in gw.requests if g.kind == "lm")
    calls = sum(e.data["tokens"] for e in sink.events if e.etype == "lm-prefill") + \
        sum(1 for e in sink.events if e.etype == "lm-step")
    batches = sum(1 for e in sink.events if e.etype == "seg-batch")
    assert launched == (5 * batches, 15 * calls) and launched_c == (0, 0)
    assert sink.canonical_bytes() == sink_c.canonical_bytes()
    assert gw.stats() == gw_c.stats()
    for g, c in zip(gw.requests, gw_c.requests):
        if g.kind == "seg":
            np.testing.assert_allclose(g.handle.result.logits, c.handle.result.logits,
                                       atol=1e-4, rtol=0)


# ------------------------------------------------------- certified tuning


def _tuning_net():
    """A small quantized U-Net (depth 2, 5 convs) and two phantom images of
    the calibrated set's kind."""
    cfg = unet.UNetConfig(hw=16, in_ch=3, base=8, depth=2, quant_mode="mma_int8")
    params = unet.init_params(0, cfg, device="cpu")
    images = [phantom_image(96, 80, 3, seed=0), phantom_image(96, 80, 3, seed=1)]
    return cfg, params, images


def _tune(cfg, params, images, dev):
    """At this target and tile the plan drops planes and has two classes,
    and each image has 9 tiles."""
    return autotune.tune_unet(params, cfg, images, target_rel_err=0.2, tile=32, device=dev)


@pytest.mark.gpu
def test_gpu_tune_unet_kernel_equals_plain(cuda):
    """``tune_unet`` through the kernel on the card gives the plan the plain
    path gives there: the int32 datapath is bit-exact, so the measurements
    the search reads are equal and so are its choices."""
    cfg, params, images = _tuning_net()
    before = mk.launches
    got = _tune(cfg, params, images, cuda)
    assert mk.launches > before
    launched = mk.launches
    want = _tune(dataclasses.replace(cfg, impl="horner"), params, images, cuda)
    assert mk.launches == launched  # the plain path launches no kernel
    for field in ("planes", "class_planes", "tile", "halo", "class_thresholds", "modeled"):
        assert getattr(got, field) == getattr(want, field), field
    for key in ("repairs", "measure_calls"):
        assert got.certificate[key] == want.certificate[key], key
    assert abs(got.certificate["measured_rel_err"] - want.certificate["measured_rel_err"]) <= 1e-6


@pytest.mark.gpu
def test_gpu_plan_engine_kernel_vs_plain(cuda):
    """A tuned plan served through ``SegEngine(plan=...)`` on the card: one
    kernel launch per conv per micro-batch, the plain path's accounting and,
    up to the float head, its logits."""
    cfg, params, images = _tuning_net()
    plan = _tune(cfg, params, images, cuda)
    assert min(plan.planes) < 8 and plan.n_classes > 1
    eng = autotune.engine_from_plan(cfg, params, plan, device=cuda)
    eng.obs = RecordingSink()
    before = mk.launches
    got = eng.run(images)
    torch.cuda.synchronize()
    assert len(eng.obs) > 0
    assert mk.launches - before == len(cfg.conv_layers()) * len(eng.obs)
    plain = autotune.engine_from_plan(dataclasses.replace(cfg, impl="horner"), params, plan,
                                      device=cuda).run(images)
    for a, b in zip(got, plain):
        assert (a.cycles, a.pj, a.class_counts) == (b.cycles, b.pj, b.class_counts)
        np.testing.assert_allclose(a.logits, b.logits, atol=1e-5)


@pytest.mark.gpu
def test_gpu_per_tile_conv_outputs_independent_of_batch_mates(cuda, monkeypatch):
    """Under per-sample scales each tile's int32 conv outputs on the card
    are the same alone and among other tiles, in one launch per conv."""
    cfg, params, _ = _tuning_net()
    params = unet.params_to(params, cuda)
    rng = np.random.default_rng(3)
    x = rng.normal(0.0, 1.0, (4, 32, 32, 3)).astype(np.float32)
    x[2] *= 1e-3

    def convs(xin):
        seen = []
        conv = ops.mma_conv2d

        def recording(*a, **kw):
            out = conv(*a, **kw)
            seen.append(out)
            return out

        monkeypatch.setattr(ops, "mma_conv2d", recording)
        before = mk.launches
        unet.forward(params, xin, cfg, per_sample_scale=True, device=cuda)
        torch.cuda.synchronize()
        monkeypatch.setattr(ops, "mma_conv2d", conv)
        assert mk.launches - before == len(cfg.conv_layers())
        return seen

    batched = convs(x)
    for b in range(x.shape[0]):
        for l, (alone, mate) in enumerate(zip(convs(x[b : b + 1]), batched)):
            assert torch.equal(alone[0], mate[b]), (b, l)


# ------------------------------------------------ speculative decoding


def _spec_lm(int8: bool, impl: str):
    """The minitron_4b smoke LM (2 layers) on the int8 datapath at 8 planes:
    float weights through ``mma_linear`` (per-row activation scales), or
    every linear int8 (``w_q``, the scaled kernel on ``impl='kernel'``)."""
    cfg = get_smoke_config("minitron_4b")
    cfg = cfg.replace(quant=QuantConfig(mode="mma_int8", impl=impl,
                                        plane_schedule=(8,) * cfg.n_layers))
    params = transformer.init_params(0, cfg, device="cpu", int8_min_dim=64 if int8 else None)
    return cfg, params


def _spec_prompts(n=3):
    rng = np.random.default_rng(4)
    return [rng.integers(0, 512, 3 + i).astype(np.int32) for i in range(n)]


@pytest.mark.gpu
def test_gpu_spec_engine_horner_equals_greedy(cuda):
    """``SpecEngine`` on the card, Horner route (per-row activation scales):
    streams equal the greedy engine's, and after the last round each slot's
    length and live cache rows equal greedy's bit for bit."""
    from repro_torch.serve import SpecEngine

    cfg, params = _spec_lm(int8=False, impl="horner")
    runs = []
    for spec in (False, True):
        eng = (SpecEngine(cfg, params, batch=3, max_seq=32, draft_schedule=(2, 2), k=2,
                          device=cuda) if spec
               else Engine(cfg, params, batch=3, max_seq=32, device=cuda))
        reqs = [Request(i, p, max_new=8) for i, p in enumerate(_spec_prompts())]
        for r in reqs:
            assert eng.admit(r)
        while eng.ready_slots():
            eng.spec_step() if spec else eng.step()
        runs.append((eng, [r.out for r in reqs]))
    (g, gout), (s, sout) = runs
    assert sout == gout and all(len(o) == 8 for o in sout)
    assert np.array_equal(s.lengths, g.lengths)
    for i, n in enumerate(g.lengths):
        for key in ("k", "v"):
            assert torch.equal(s.cache[key][:, i, :n], g.cache[key][:, i, :n])


@pytest.mark.gpu
def test_gpu_spec_draft_call_kernel_route_vs_plain(cuda, monkeypatch):
    """The kernel route: every linear of a draft call at 2 planes is one
    scaled-kernel launch (the head at 8 planes) equal to the plain version
    bit for bit."""
    from repro_torch.serve import SpecEngine

    cfg, params = _spec_lm(int8=True, impl="kernel")
    eng = SpecEngine(cfg, params, batch=3, max_seq=32, draft_schedule=(2, 2), k=2, device=cuda)
    for i, p in enumerate(_spec_prompts()):
        assert eng.admit(Request(i, p, max_new=6))
    calls, draft, scaled = [], eng.draft_fn, ops.mma_matmul_scaled

    def recording(x, w, xs, ws, **kw):
        out = scaled(x, w, xs, ws, **kw)
        calls.append((x, w, xs, ws, kw["planes"], out))
        return out

    def first_draft(*a):
        if calls:
            return draft(*a)
        monkeypatch.setattr(ops, "mma_matmul_scaled", recording)
        try:
            return draft(*a)
        finally:
            monkeypatch.setattr(ops, "mma_matmul_scaled", scaled)

    eng.draft_fn = first_draft
    mk.scaled_variant_launches.clear()
    eng.spec_step()
    torch.cuda.synchronize()
    per_call = 7 * cfg.n_layers + 1
    assert len(calls) == per_call
    assert sorted(p for *_, p, _ in calls) == [2] * (per_call - 1) + [8]
    for x, w, xs, ws, planes, out in calls:
        x2 = x.reshape(-1, w.shape[0])
        want = mk.mma_matmul_scaled_plain(x2, w, xs, ws, planes=planes)
        assert torch.equal(out.reshape(-1, w.shape[1]), want), (tuple(w.shape), planes)
    # 2 draft calls at 2 planes, 3 verify calls at 8; every head at 8
    layers = 7 * cfg.n_layers
    assert mk.scaled_variant_launches == {(2, True): 2 * layers, (8, True): 3 * layers + 5}


@pytest.mark.gpu
def test_gpu_spec_adapter_serves_through_the_gateway(cuda):
    """``SpecLMAdapter`` behind ``Gateway`` on the card, kernel route: every
    request done with its budget, 15 scaled launches per decode call
    (prefill, draft and verify alike), the draft/verify/accept events
    present, and the exec cycles equal to the round clock's worked cycles
    (``obs.spans.reconcile``)."""
    from repro_torch.obs import reconcile
    from repro_torch.serve import SpecLMAdapter

    cfg, params = _spec_lm(int8=True, impl="kernel")
    sink = RecordingSink()
    ad = SpecLMAdapter(cfg, params, batch=3, max_seq=32, draft_schedule=(2, 2), k=2,
                       device=cuda)
    gw = Gateway([ad], policy="fair", round_budget=2 * 3 * ad._spec_slot_cycles(2), sink=sink)
    reqs = [gw.submit("lm", p, max_new=8) for p in _spec_prompts()]
    before = mk.scaled_launches
    gw.drain(max_rounds=1_000)
    torch.cuda.synchronize()
    launched = mk.scaled_launches - before
    assert all(r.done and len(r.handle.out) == 8 for r in reqs) and gw.rounds > 1
    calls = sum(e.data["tokens"] for e in sink.events if e.etype == "lm-prefill") + \
        sum(2 * e.data["k"] + 1 for e in sink.events if e.etype == "lm-spec") + \
        sum(1 for e in sink.events if e.etype == "lm-step")
    assert launched == 15 * calls
    assert {"draft", "verify", "accept"} <= {e.etype for e in sink.events}
    rec = reconcile(sink.events, [gw.round_clock])
    assert rec["holds"] and rec["total_exec"] == gw.round_clock.worked_total > 0


# ------------------------------------------------ the fabric and telemetry


def _fabric_run(dev, lm, seg):
    """A 2-shard fabric of small mixed gateways (``deficit`` routing,
    stealing on) with a recording sink, an ``SloMonitor`` and an
    ``EnergyMeter`` teed: twelve LM requests in two QoS classes with
    deadlines, arriving over three rounds, and two seg images."""
    from repro_torch.core import energy_model as em
    from repro_torch.obs import EnergyMeter, SloMonitor, SloSpec, TeeSink
    from repro_torch.serve import Fabric

    (cfg, params), (ucfg, uparams, plan) = lm, seg
    rec = RecordingSink()
    mon = SloMonitor([SloSpec("fast", latency_target_ms=1.0, miss_budget=0.1),
                      SloSpec("lm", miss_budget=0.2)], windows=(600_000, 3_000_000))
    meter = EnergyMeter({"lm": em.active_rate_pj(8), "seg": em.active_rate_pj(max(plan.planes))})
    shards = [Gateway([LMAdapter(cfg, params, batch=20, max_seq=24, device=dev),
                       SegAdapter(ucfg, uparams, plan=plan, batch=2, device=dev)],
                      policy="fair", round_budget=300_000,
                      shares={"lm": 0.3, "fast": 0.3, "seg": 0.3}) for _ in range(2)]
    fab = Fabric(shards, router="deficit", seed=0, steal=True, sink=TeeSink([rec, mon, meter]))
    rng = np.random.default_rng(0)
    arrivals = [[(r * 300_000 + 1_000 * i, "lm", rng.integers(0, cfg.vocab, 3 + i % 4),
                  dict(max_new=4, qos="fast" if i % 2 else None, deadline_cycles=200_000))
                 for i in range(4)] for r in range(3)]
    arrivals[0] += [(5_000 + s, "seg", phantom_image(40, 48, ucfg.in_ch, seed=s), {})
                    for s in (0, 1)]
    before = (mk.launches, mk.scaled_launches)
    for due in arrivals:
        fab.step_round(arrivals=due)
    fab.drain(max_rounds=1_000)
    torch.cuda.synchronize()
    return fab, rec, mon, meter, (mk.launches - before[0], mk.scaled_launches - before[1])


@pytest.mark.gpu
def test_gpu_fabric_of_real_shards_equals_the_cpu(cuda):
    """Two real shards on the card behind a ``Fabric``: every request done,
    15 scaled launches per LM decode call and 5 unscaled per seg
    micro-batch, the event stream byte for byte a ``device='cpu'`` run's,
    fleet and shard ``stats()`` (with ``slo`` and ``energy`` blocks) equal,
    and the fleet ledger, spans, SLO misses and picojoules reconcile."""
    from repro_torch.obs import assemble, attach_joules, reconcile

    cfg = get_smoke_config("minitron_4b").replace(quant=QuantConfig(mode="mma_int8",
                                                                    impl="kernel"))
    params = transformer.init_params(0, cfg, device="cpu", int8_min_dim=64)
    ucfg, uparams, images = _tuning_net()
    plan = autotune.tune_unet(uparams, ucfg, images, target_rel_err=0.2, tile=32, device="cpu")
    runs = [_fabric_run(dev, (cfg, params), (ucfg, uparams, plan)) for dev in (cuda, "cpu")]
    (fab, rec, mon, meter, launched), (fab_c, rec_c, _, _, launched_c) = runs
    assert all(g.done for g in fab.requests) and len(fab.requests) == 14
    assert all(len(g.handle.out) == 4 for g in fab.requests if g.kind == "lm")
    calls = sum(e.data["tokens"] for e in rec.events if e.etype == "lm-prefill") + \
        sum(1 for e in rec.events if e.etype == "lm-step")
    batches = sum(1 for e in rec.events if e.etype == "seg-batch")
    assert launched == (5 * batches, 15 * calls) and launched_c == (0, 0)
    assert rec.canonical_bytes() == rec_c.canonical_bytes()
    assert fab.stats() == fab_c.stats()
    assert [g.stats() for g in fab.shards] == [g.stats() for g in fab_c.shards]
    assert all({"slo", "energy"} <= set(g.stats()) for g in fab.shards)
    assert fab.additivity()["holds"]
    assert reconcile(rec.events, [g.round_clock for g in fab.shards], ledger=fab.ledger)["holds"]
    spans = attach_joules(assemble(rec.events), meter)
    assert mon.reconcile(spans)["holds"] and meter.reconcile(spans)["holds"]


@pytest.mark.gpu
def test_gpu_spec_adapter_energy_account_closes(cuda):
    """``SpecLMAdapter`` behind ``Gateway`` on the card with an
    ``EnergyMeter`` pricing drafts at the 2-plane rate: useful + wasted pJ
    equal draft + verify pJ, the slot-level cycles equal the round-level
    ones, and the whole ledger holds to the picojoule (the paper's FPGA
    energy model: the account depends on what was accepted, not on the
    card's time)."""
    from repro_torch.core import energy_model as em
    from repro_torch.obs import EnergyMeter, TeeSink, assemble, attach_joules
    from repro_torch.serve import SpecLMAdapter

    cfg, params = _spec_lm(int8=True, impl="kernel")
    sink = RecordingSink()
    meter = EnergyMeter({"lm": em.active_rate_pj(8)}, draft_rates={"lm": em.active_rate_pj(2)})
    ad = SpecLMAdapter(cfg, params, batch=3, max_seq=32, draft_schedule=(2, 2), k=2,
                       device=cuda)
    gw = Gateway([ad], policy="fair", round_budget=2 * 3 * ad._spec_slot_cycles(2),
                 sink=TeeSink([sink, meter]))
    reqs = [gw.submit("lm", p, max_new=8) for p in _spec_prompts()]
    gw.drain(max_rounds=1_000)
    torch.cuda.synchronize()
    assert all(r.done for r in reqs)
    s = meter.spec_summary()
    assert s["rounds"] > 0 and s["draft_pj"] > 0
    assert s["useful_pj"] + s["wasted_pj"] == s["draft_pj"] + s["verify_pj"]
    out = meter.reconcile(attach_joules(assemble(sink.events), meter))
    assert out["holds"] and all(v["cycles_close"] and v["pj_close"] for v in out["spec"].values())
    assert gw.stats()["energy"]["spec"] == s
