"""The port's CUDA kernels on the card, held against their plain PyTorch
versions, and the two serving engines on the card against the CPU.

Every test here needs a CUDA card and skips without one.  The file imports
no jax (the machine with the card has none), so it runs there with

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest``: the suite's shared conftest imports jax).
"""

import collections
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
from repro_torch.obs import timeline
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

# RWKV6-3B's scaled-kernel linears (K, N): time-mix wr/wk/wv/wg/wo and
# channel-mix wr, channel-mix wk, channel-mix wv, the head.
RWKV6_SHAPES = [(2560, 2560), (2560, 8960), (8960, 2560), (2560, 65536)]
# Zamba2-7B's: z_proj, xbc_proj, out_proj, the shared block's wq/wk/wv/wo
# and proj, the head.  dt_proj (3584 x 112) takes the unscaled kernel.
ZAMBA2_SHAPES = [(3584, 7168), (3584, 7296), (7168, 3584), (7168, 7168), (3584, 32000)]
DT_PROJ = (3584, 112)
# Whisper-large-v3's linears (K, N): the attention projections (self and
# cross), the MLP's up and down.  The decoder runs them at M = 4 (batch 4),
# the encoder and the cross K/V projection at M = 6000 (4 x 1500 frames).
WHISPER_SHAPES = [(1280, 1280), (1280, 5120), (5120, 1280)]

# Bf16 logits of the small LM, card against CPU, relative to the call's
# largest logit.  The integer products and the scaled epilogue are equal and
# most calls agree bit for bit, but a float op between them (an RMSNorm
# mean, an exp) now and then rounds the other way; the next linear's
# per-tensor activation scale then moves every int8 level of the tensor,
# and the difference rides the KV cache into later calls.  On this model at
# 8 planes that stays near 0.03 of the largest logit; with plane truncation
# one moved level weighs 2**(8 - planes) as much.
LM_LOGIT_REL = 0.05
# The recurrent families' smoke models, card against CPU: the same drift,
# carried forward by the recurrent state through every later call (RWKV6's
# WKV state, Zamba2's SSM states and its shared block's KV cache), where
# Zamba2's 7 Mamba2 / attention block boundaries each requantize per
# tensor; 0.0526 at Zamba2's seventh call (the card, 8 planes).
RECURRENT_LOGIT_REL = 0.1


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


# ------------------------------------------- the U-Net forward's graphs

# Window shapes of the calibrated U-Net (depth 3: multiples of 8) and two
# plane schedules of its 7 convs.
GRAPH_WINDOWS = [(80, 80), (56, 80), (40, 40)]
GRAPH_SCHEDULES = [(8,) * 7, (6, 5, 4, 3, 4, 5, 6)]


def _graph_net(cuda, schedule=GRAPH_SCHEDULES[1]):
    cfg = unet.UNetConfig(quant_mode="mma_int8", plane_schedule=schedule)
    return cfg, unet.init_params(0, cfg, device=cuda)


def _windows(shape, seed, n=8):
    """``n`` windows of ``shape`` whose amplitude moves with the seed, so
    the activation scales differ from call to call."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, *shape, 4)) * (1 + seed % 5)).astype(np.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("per_sample_scale", [False, True])
@pytest.mark.parametrize("schedule", GRAPH_SCHEDULES)
def test_gpu_graphed_forward_equals_eager(cuda, schedule, per_sample_scale):
    """Each window shape's forwards (eager, capture, replays) through a
    cache equal the eager forward bit for bit."""
    cfg, params = _graph_net(cuda, schedule)
    graphs = unet.ForwardGraphs()
    for i, shape in enumerate(GRAPH_WINDOWS):
        for j in range(4):
            x = _windows(shape, 10 * i + j)
            want = unet.forward(params, x, cfg, per_sample_scale=per_sample_scale, device=cuda)
            got = unet.forward(params, x, cfg, per_sample_scale=per_sample_scale, device=cuda,
                               graphs=graphs)
            assert torch.equal(got, want), (shape, j)
    assert len(graphs) == len(GRAPH_WINDOWS)


@pytest.mark.gpu
def test_gpu_graph_replays_interleaved_across_signatures(cuda):
    """Replays of one signature between another's, all on the cache's one
    pool: every output equals the eager forward's."""
    cfg, params = _graph_net(cuda)
    other = dataclasses.replace(cfg, plane_schedule=GRAPH_SCHEDULES[0])
    sigs = [((80, 80), cfg, False), ((40, 40), other, True), ((56, 80), cfg, True),
            ((80, 80), other, False)]
    graphs = unet.ForwardGraphs()
    order = [0, 1, 2, 3] * 2 + [0, 1, 0, 2, 3, 3, 1, 0, 2, 1]
    for n, s in enumerate(order):
        shape, scfg, pss = sigs[s]
        x = _windows(shape, 100 + n)
        want = unet.forward(params, x, scfg, per_sample_scale=pss, device=cuda)
        got = unet.forward(params, x, scfg, per_sample_scale=pss, device=cuda, graphs=graphs)
        assert torch.equal(got, want), (n, s)
    assert len(graphs) == len(sigs)


@pytest.mark.gpu
def test_gpu_graph_launch_counts_equal_eager(cuda):
    """An eager forward, a capture and two more replays count the kernel
    launches of four eager forwards, by variant; the capture itself none."""
    cfg, params = _graph_net(cuda)
    x = _windows((56, 80), 7)
    mk.launches = 0
    mk.variant_launches.clear()
    for _ in range(4):
        unet.forward(params, x, cfg, device=cuda)
    eager = (mk.launches, collections.Counter(mk.variant_launches))
    assert eager[0] == 4 * len(cfg.conv_layers())
    mk.launches = 0
    mk.variant_launches.clear()
    graphs = unet.ForwardGraphs()
    with timeline.recording() as rec:
        for n in range(4):
            unet.forward(params, x, cfg, device=cuda, graphs=graphs)
            assert mk.launches == (n + 1) * len(cfg.conv_layers())
    torch.cuda.synchronize()
    assert (mk.launches, mk.variant_launches) == eager
    assert set(mk.variant_launches) == set(eager[1])
    assert rec.counts == {"unet.graph_forwards": 4, "unet.graph_replays": 3,
                          "unet.graph_captures": 1}


@pytest.mark.gpu
def test_gpu_engine_graphs_serve_the_eager_engines_logits(cuda):
    """A ``SegEngine`` on the card (its graph cache) serves four 240x240x4
    slices twice with the logits of an engine without a cache, bit for
    bit, the second time mostly from replays."""
    base = unet.UNetConfig(quant_mode="mma_int8")
    params = unet.init_params(0, base, device=cuda)
    cfg = dataclasses.replace(base, plane_schedule=unet.schedule_from_params(params, 0.05).planes)
    images = [phantom_image(240, 240, 4, seed=s) for s in range(4)]
    kw = dict(tile=32, batch=32, max_active=8, device=cuda)
    eager = SegEngine(cfg, params, **kw)
    eager.graphs = None
    want = eager.run(images)
    eng = SegEngine(cfg, params, **kw)
    assert isinstance(eng.graphs, unet.ForwardGraphs)
    first = eng.run(images)
    with timeline.recording() as rec:
        second = eng.run(images)
    for runs in (first, second):
        for a, b in zip(runs, want):
            assert np.array_equal(a.logits, b.logits)
            assert (a.cycles, a.pj, a.class_counts) == (b.cycles, b.pj, b.class_counts)
    assert len(eng.graphs) > 0
    assert rec.counts["unet.graph_replays"] > rec.counts["unet.graph_forwards"] // 2


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


# The MoE block on the card against the CPU, relative to the block's largest
# output: the routing is held exactly (the CPU dispatches on the card's
# router logits), so what differs is the bf16 expert products' summation
# order on the two devices, a few bf16 ulps of the output.
MOE_REL = 1e-2


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["decode", "drops"])
def test_gpu_moe_ffn_equals_the_cpu(cuda, case):
    """``moe_ffn`` on the card at decode (T = 4, dropless by the floor of 4)
    and at T = 32 with capacity factor 0.5 (cap 4 for 64 assignments over
    8 experts: drops at capacity): given the card's router logits the CPU's
    expert ids, positions, kept mask, token order and ``cap`` equal the
    card's exactly; the output is within ``MOE_REL`` of the CPU's
    ``moe_ffn`` pieces on that routing."""
    from repro_torch.models import moe

    cfg = get_smoke_config("olmoe_1b_7b")
    shape = (4, 1) if case == "decode" else (2, 16)
    if case == "drops":
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=0.5))
    m, d = cfg.moe, cfg.d_model
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg, device="cpu")
    pg = transformer.params_to(p, cuda)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(shape + (d,))
                         .astype(np.float32)).to(torch.bfloat16)
    t = x.numel() // d
    cap = moe.capacity(t, m)
    xg = x.to(cuda)
    y = moe.moe_ffn(pg, xg, cfg)
    logits = moe.router_logits(pg, xg.reshape(t, d))
    xe_g, meta_g = moe._local_dispatch(xg.reshape(t, d), logits, m.n_experts, m.top_k, cap,
                                       torch.bfloat16)
    xe_c, meta_c = moe._local_dispatch(x.reshape(t, d), logits.cpu(), m.n_experts, m.top_k, cap,
                                       torch.bfloat16)
    for i in (0, 1, 2, 4):
        assert torch.equal(meta_g[i].cpu(), meta_c[i]), i
    assert torch.equal(xe_g.cpu(), xe_c)
    want = moe._local_combine(moe.expert_ffn(p, xe_c), meta_c, t, cap, torch.bfloat16)
    got = y.cpu().reshape(t, d).to(torch.float32)
    rel = float((got - want.to(torch.float32)).abs().max() / want.to(torch.float32).abs().max())
    assert rel <= MOE_REL, rel
    if case == "drops":
        assert cap == 4 and bool((~meta_g[4]).any())  # drops at capacity
    else:
        assert bool(meta_g[4].all())


@pytest.mark.gpu
def test_gpu_moe_engine_with_drops_equals_cpu_engine(cuda):
    """OLMoE's smoke model (2 layers, 8 experts top-2; the attention linears
    and the head int8 on the kernel route, router and experts bf16) served
    by ``Engine`` at batch 8: every decode call routes the batch's 8 tokens
    at cap 4 of 16 assignments per block, and the steps drop (quirk 3: a
    token's drops depend on its batch mates).  Every block the card routes,
    the CPU routes alike on the card's router logits (kept mask, token x
    expert, equal).  Against the CPU engine, call by call: while every
    block chooses each token's experts as the CPU engine's does, its kept
    mask equals the CPU's and the logits are within ``LM_LOGIT_REL``; at
    the first block whose choice parts, its router logits on the card are
    within ``LM_LOGIT_REL`` of the largest of the CPU's (a choice that
    parts on nearly equal logits parts at a near tie), and the comparison
    stops there (a parting moves the drops of the expert it enters, and
    after it the engines see different caches).
    At least one step drops on the card and on the CPU."""
    from repro_torch.models import moe

    cfg = get_smoke_config("olmoe_1b_7b").replace(
        quant=QuantConfig(mode="mma_int8", impl="kernel"))
    params = quant.quantize_params_int8(transformer.init_params(0, cfg, device="cpu"),
                                        min_dim=128)
    batch, m = 8, cfg.moe
    runs = []
    for dev in (cuda, "cpu"):
        rng = np.random.default_rng(0)
        reqs = [Request(i, rng.integers(0, cfg.vocab, n).astype(np.int32), max_new=4)
                for i, n in enumerate(rng.integers(3, 7, batch))]
        eng = Engine(cfg, params, batch=batch, max_seq=32, device=dev)
        logits, blocks, inner, dispatch = [], [], eng.decode_fn, moe._local_dispatch

        def decode(*a, inner=inner, logits=logits):
            out = inner(*a)
            logits.append(out[0][:, -1].to(torch.float32).cpu())
            return out

        def recording(xf, lg, n_experts, top_k, cap, dtype, blocks=blocks):
            buf, meta = dispatch(xf, lg, n_experts, top_k, cap, dtype)
            eid_s, _, tok_s, _, keep = (t.cpu() for t in meta)
            chosen = torch.zeros((xf.shape[0], n_experts), dtype=torch.bool)
            chosen[tok_s, eid_s] = True
            kept = torch.zeros_like(chosen)
            kept[tok_s[keep], eid_s[keep]] = True
            blocks.append(dict(cap=cap, chosen=chosen, kept=kept, logits=lg.float().cpu()))
            return buf, meta

        eng.decode_fn, moe._local_dispatch = decode, recording
        try:
            done = eng.run(reqs)
            torch.cuda.synchronize()
        finally:
            moe._local_dispatch = dispatch
        steps = len(logits) - sum(len(r.prompt) for r in reqs)
        runs.append(([r.out for r in done], logits, blocks, steps))
    (tok_g, lg_g, blk_g, steps), (tok_c, lg_c, blk_c, steps_c) = runs
    n_layers = cfg.n_layers
    assert len(lg_g) == len(lg_c) and len(blk_g) == len(blk_c) == n_layers * len(lg_g)
    assert steps == steps_c > 0
    assert all(b["cap"] == 4 for b in blk_g)
    for blk in (blk_g, blk_c):  # drops at the steps: fewer than 16 kept in some block
        assert any(int(b["kept"].sum()) < batch * m.top_k for b in blk[-n_layers * steps:])
    for b in blk_g:  # the card's routing, as the CPU routes the card's logits
        _, meta = moe._local_dispatch(torch.zeros((batch, 1)), b["logits"], m.n_experts,
                                      m.top_k, b["cap"], torch.float32)
        kept = torch.zeros_like(b["kept"])
        kept[meta[2][meta[4]], meta[0][meta[4]]] = True
        assert torch.equal(kept, b["kept"])
    parted = False
    for i, (a, b) in enumerate(zip(lg_g, lg_c)):
        for bg, bc in zip(blk_g[i * n_layers:(i + 1) * n_layers],
                          blk_c[i * n_layers:(i + 1) * n_layers]):
            if not torch.equal(bg["chosen"], bc["chosen"]):
                # a choice that parts on nearly equal logits: the gap it
                # flips across is at most twice their difference
                gap = float((bg["logits"] - bc["logits"]).abs().max() / bc["logits"].abs().max())
                assert gap <= LM_LOGIT_REL, (i, gap)
                parted = True
                break
            assert torch.equal(bg["kept"], bc["kept"])  # equal expert sets drop alike
        if parted:
            break
        rel = float((a - b).abs().max() / b.abs().max())
        assert rel <= LM_LOGIT_REL, f"decode call {i}: logits differ by {rel} of the largest"
        if not torch.equal(a.argmax(-1), b.argmax(-1)):
            break
    else:
        assert tok_g == tok_c


@pytest.mark.gpu
def test_gpu_checkpointer_keeps_cuda_tensors(cuda, tmp_path):
    """``save_async`` of CUDA tensors, then ``restore`` into CUDA ``like``
    leaves: every leaf back on the card, bit-equal, bf16 kept."""
    from repro_torch.checkpoint import Checkpointer

    g = torch.Generator().manual_seed(0)
    state = {"params": {"w": torch.randn((64, 32), generator=g).to(torch.bfloat16),
                        "w_q": torch.randint(-128, 128, (32, 16), dtype=torch.int8, generator=g)},
             "opt": [torch.randn((5,), generator=g), torch.tensor(3, dtype=torch.int32)]}
    state = transformer.params_to({"params": state["params"]}, cuda) | {
        "opt": [a.to(cuda) for a in state["opt"]]}
    ck = Checkpointer(tmp_path)
    ck.save_async(3, state)
    ck.wait()
    like = {"params": {k: torch.zeros_like(v) for k, v in state["params"].items()},
            "opt": [torch.zeros_like(a) for a in state["opt"]]}
    restored, step = ck.restore(like)
    assert step == 3
    pairs = list(zip(restored["params"].values(), state["params"].values())) + \
        list(zip(restored["opt"], state["opt"]))
    for a, b in pairs:
        assert a.device.type == "cuda" and a.dtype == b.dtype and torch.equal(a, b)
    assert restored["params"]["w"].dtype == torch.bfloat16


@pytest.mark.gpu
@pytest.mark.parametrize("m", range(1, 9))
def test_gpu_kernel_vs_plain_at_dt_proj(cuda, m):
    """The unscaled kernel at Zamba2's ``dt_proj`` (K 3584, N 112, M =
    batch): N = 112 stages w with 16-byte copies, M <= 8 sits in a
    32-row block."""
    for planes in (8, 5):
        _kernel_vs_plain(cuda, m, *DT_PROJ, planes)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 4, 8])
@pytest.mark.parametrize("k,n", RWKV6_SHAPES + ZAMBA2_SHAPES)
def test_gpu_scaled_kernel_vs_plain_recurrent_shapes(cuda, m, k, n):
    _kernel_vs_plain(cuda, m, k, n, 5, scaled=True)


def _recurrent(name, dev):
    """A recurrent family's smoke model on ``dev`` through the kernel route:
    the linears of both dims >= 128 int8.  Returns (cfg, module, params,
    (unscaled, scaled) launches per decode call)."""
    from repro_torch import models

    cfg = get_smoke_config(name).replace(quant=QuantConfig(mode="mma_int8", impl="kernel"))
    mod = models.build(cfg)
    params = mod.init_params(0, cfg, device=dev, int8_min_dim=128)
    # rwkv6: 2 layers x (5 time-mix + 3 channel-mix) + the head, mix_lora_a
    # on the Horner route; zamba2: 5 layers x (z/xbc/out_proj) + 2 shared
    # blocks x 5 + the head scaled, dt_proj unscaled
    per_call = (0, 17) if name == "rwkv6_3b" else (5, 26)
    return cfg, mod, params, per_call


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["rwkv6_3b", "zamba2_7b"])
def test_gpu_recurrent_engine_equals_cpu_engine(cuda, name):
    """Five requests at batch 4 (one slot reused) through ``Engine`` on the
    card and on the CPU: the kernels' launches per decode call on the card
    (none on the CPU), logits within ``RECURRENT_LOGIT_REL`` of the CPU's at
    every call up to the first whose argmax differs, and equal tokens if
    none does (as ``test_gpu_lm_engine_equals_cpu_engine``)."""
    cfg, _, params, per_call = _recurrent(name, "cpu")
    runs = []
    for dev in (cuda, "cpu"):
        rng = np.random.default_rng(0)
        reqs = [Request(i, rng.integers(0, 512, n).astype(np.int32), max_new=4)
                for i, n in enumerate((3, 6, 4, 5, 2))]
        eng = Engine(cfg, params, batch=4, max_seq=32, device=dev)
        logits, inner = [], eng.decode_fn

        def decode(*a, inner=inner, logits=logits):
            out = inner(*a)
            logits.append(out[0][:, -1].to(torch.float32).cpu())
            return out

        eng.decode_fn = decode
        before = (mk.launches, mk.scaled_launches)
        done = eng.run(reqs)
        torch.cuda.synchronize()
        runs.append(([r.out for r in done], logits,
                     (mk.launches - before[0], mk.scaled_launches - before[1])))
    (tok_g, lg_g, launched_g), (tok_c, lg_c, launched_c) = runs
    assert launched_g == (per_call[0] * len(lg_g), per_call[1] * len(lg_g))
    assert launched_c == (0, 0) and len(lg_g) == len(lg_c)
    for i, (a, b) in enumerate(zip(lg_g, lg_c)):
        rel = float((a - b).abs().max() / b.abs().max())
        assert rel <= RECURRENT_LOGIT_REL, f"decode call {i}: logits differ by {rel} of the largest"
        if not torch.equal(a.argmax(-1), b.argmax(-1)):
            break
    else:
        assert tok_g == tok_c


@pytest.mark.gpu
def test_gpu_zamba2_decode_graph_replayed_twice(cuda):
    """Zamba2's decode call (both kernels, the Mamba2 recurrences, the shared
    block's KV write at a scalar index held on the card) captured in a CUDA
    graph: two replays give logits bit-equal to each other and to an eager
    call on the same state."""
    from repro_torch.models import zamba2
    from repro_torch.serve import serve_step

    cfg, _, params, _ = _recurrent("zamba2_7b", cuda)
    decode, _ = serve_step.make_decode(cfg, 4, 16, device=cuda)
    state = zamba2.init_state(cfg, 4, 16, device=cuda)
    toks = torch.randint(0, 512, (4, 1), device=cuda, generator=torch.Generator(
        device=cuda).manual_seed(1))
    for i in range(3):  # a nonzero state
        _, state = decode(params, toks, state, torch.tensor(i, device=cuda), {})
    idx = torch.tensor(3, device=cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture
        decode(params, toks, state, idx, {})
    torch.cuda.current_stream().wait_stream(side)
    want, _ = decode(params, toks, state, idx, {})
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got, _ = decode(params, toks, state, idx, {})
    outs = []
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        outs.append(got.clone())
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], want)



@pytest.mark.gpu
@pytest.mark.parametrize("m", [4, 6000])
@pytest.mark.parametrize("k,n", WHISPER_SHAPES)
def test_gpu_scaled_kernel_vs_plain_whisper_shapes(cuda, m, k, n):
    """The scaled kernel at Whisper's shapes, at the served 5 planes and at
    8: bit for bit against the plain version (tolerance 0: the same int32
    product and the same two float32 roundings of the epilogue)."""
    for planes in (5, 8):
        _kernel_vs_plain(cuda, m, k, n, planes, scaled=True, seed=planes)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [4, 6000])
def test_gpu_whisper_scaled_graph_replayed_twice(cuda, m):
    """Whisper's MLP down projection (K 5120, N 1280) at M = 4 (split K)
    and M = 6000 (188 row tiles) captured in one CUDA graph: two replays
    give outputs equal to each other and to the plain version (tolerance
    0)."""
    k, n = 5120, 1280
    g = torch.Generator(device=cuda).manual_seed(5)
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
def test_gpu_whisper_engine_equals_cpu_engine(cuda):
    """Whisper's smoke model (every linear int8 at ``min_dim=128``) on the
    kernel route at 8 planes (the basis of ``LM_LOGIT_REL``): the encoder on
    the card within ``LM_LOGIT_REL`` of the CPU's; then both engines serve
    from the same memory (the CPU's: a memory that differs by an ulp moves
    int8 levels of the cross K/V's per-tensor grid), with 2 x 2 scaled
    launches for the cross K/V and 2 x 8 per decode call on the card (none
    unscaled), three requests at batch 2 (one slot reused) with logits within
    ``LM_LOGIT_REL`` of the CPU's at every call up to the first whose argmax
    differs, and equal tokens if none does."""
    from repro_torch.models import whisper

    cfg = get_smoke_config("whisper_large_v3").replace(
        quant=QuantConfig(mode="mma_int8", impl="kernel", planes=8))
    params = whisper.init_params(0, cfg, device="cpu", int8_min_dim=128, max_dec_pos=64)
    frames = np.random.default_rng(0).standard_normal((2, cfg.enc_seq, cfg.d_model)).astype(
        np.float32)
    before = (mk.launches, mk.scaled_launches)
    mem_g = whisper.encode(params, frames, cfg, device=cuda)
    assert (mk.launches - before[0], mk.scaled_launches - before[1]) == (0, 2 * 6)
    mem_c = whisper.encode(params, frames, cfg, device="cpu")
    rel = float((mem_g.float().cpu() - mem_c.float()).abs().max() / mem_c.float().abs().max())
    assert rel <= LM_LOGIT_REL, f"encoder memory differs by {rel} of the largest"
    runs = []
    for dev in (cuda, "cpu"):
        rng = np.random.default_rng(1)
        reqs = [Request(i, rng.integers(0, 512, n).astype(np.int32), max_new=4)
                for i, n in enumerate((3, 5, 2))]
        before = (mk.launches, mk.scaled_launches)
        eng = Engine(cfg, params, batch=2, max_seq=32, extras={"memory": mem_c.clone()},
                     device=dev)
        launched_kv = (mk.launches - before[0], mk.scaled_launches - before[1])
        logits, inner = [], eng.decode_fn

        def decode(*a, inner=inner, logits=logits):
            out = inner(*a)
            logits.append(out[0][:, -1].to(torch.float32).cpu())
            return out

        eng.decode_fn = decode
        before = (mk.launches, mk.scaled_launches)
        done = eng.run(reqs)
        torch.cuda.synchronize()
        runs.append(([r.out for r in done], logits, launched_kv,
                     (mk.launches - before[0], mk.scaled_launches - before[1])))
    (tok_g, lg_g, kv_g, dec_g), (tok_c, lg_c, kv_c, dec_c) = runs
    assert kv_g == (0, 2 * 2) and dec_g == (0, 16 * len(lg_g))
    assert kv_c == dec_c == (0, 0) and len(lg_g) == len(lg_c)
    for i, (a, b) in enumerate(zip(lg_g, lg_c)):
        rel = float((a - b).abs().max() / b.abs().max())
        assert rel <= LM_LOGIT_REL, f"decode call {i}: logits differ by {rel} of the largest"
        if not torch.equal(a.argmax(-1), b.argmax(-1)):
            break
    else:
        assert tok_g == tok_c


# Yi-6B's linears at training shapes (M = 2 x 512 rows: one of Yi-6B's 4
# microbatches of 8 x 512 tokens): wq/wo, wk/wv, w_gate/w_up, w_down, the
# head.
TRAIN_SHAPES = [(1024, 4096, 4096), (1024, 4096, 512), (1024, 4096, 11008),
                (1024, 11008, 4096), (1024, 4096, 64000)]


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", TRAIN_SHAPES)
def test_gpu_kernel_vs_plain_training_shapes(cuda, m, k, n):
    _kernel_vs_plain(cuda, m, k, n, 8)


def _train_cfg(impl: str, microbatches: int = 2):
    """The widened Yi-6B smoke config of ``test_torch_train.py``, QAT on the
    given route."""
    return get_smoke_config("yi_6b").replace(
        d_model=256, d_ff=512, n_heads=4, n_kv_heads=2, head_dim=64, vocab=512,
        microbatches=microbatches, quant=QuantConfig(mode="mma_int8", impl=impl))


@pytest.mark.gpu
def test_gpu_train_step_kernel_route_equals_horner_route(cuda):
    """One train step (two microbatches) on the card: both routes produce
    the same int32 products and the backward is the float product's, so the
    loss, grad norm, new params and optimizer state are bit-equal."""
    from repro_torch.checkpoint.ckpt import tree_leaves
    from repro_torch.data.pipeline import DataConfig, get_batch
    from repro_torch.optim import adamw
    from repro_torch.train import train_step as ts

    batch = get_batch(DataConfig(vocab=512, seq_len=64, global_batch=4, microbatches=2, seed=0), 0)
    runs = []
    for impl in ("kernel", "horner"):
        cfg = _train_cfg(impl)
        params = transformer.init_params(0, cfg, device=cuda)
        before = mk.launches
        new, metrics = ts.train_step({"params": params, "opt": adamw.init(params)}, batch, cfg,
                                     device=cuda)
        torch.cuda.synchronize()
        runs.append((new, metrics, mk.launches - before))
    (new_k, m_k, n_k), (new_h, m_h, n_h) = runs
    assert n_k == 2 * (2 * 2 * 7 + 1) and n_h == 0
    assert bool(torch.isfinite(m_k["loss"])) and torch.equal(m_k["loss"], m_h["loss"])
    assert torch.equal(m_k["grad_norm"], m_h["grad_norm"])
    for a, b in zip(tree_leaves(new_k), tree_leaves(new_h)):
        assert a.device.type == "cuda" and torch.equal(a, b)


@pytest.mark.gpu
def test_gpu_trainer_restart_is_bit_deterministic(cuda, tmp_path):
    """As ``tests/test_checkpoint.py`` holds the reference's, on the card and
    the kernel route: 4 uninterrupted steps against 2, a resume, 2 more."""
    import shutil

    from repro_torch.checkpoint.ckpt import tree_leaves
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.optim import adamw
    from repro_torch.train import train_step as ts
    from repro_torch.train import trainer

    cfg = _train_cfg("kernel")
    dcfg = DataConfig(vocab=512, seq_len=64, global_batch=4, microbatches=2, seed=11)

    def fresh():
        params = transformer.init_params(0, cfg, device=cuda)
        return {"params": params, "opt": adamw.init(params)}

    def step_fn(st, b):
        return ts.train_step(st, b, cfg, device=cuda)

    def tc(steps):
        return trainer.TrainerConfig(total_steps=steps, ckpt_every=2, log_every=100,
                                     ckpt_dir=str(tmp_path / "ck"))

    final_a, ma = trainer.train(fresh(), step_fn, dcfg, tc(4), log=lambda *a: None)
    shutil.rmtree(tmp_path / "ck")
    half, _ = trainer.train(fresh(), step_fn, dcfg, tc(2), log=lambda *a: None)
    resumed, start = trainer.resume(half, tc(4))
    assert start == 2 and all(t.device.type == "cuda" for t in tree_leaves(resumed))
    final_b, mb = trainer.train(resumed, step_fn, dcfg, tc(4), start_step=start,
                                log=lambda *a: None)
    assert ma["losses"][2:] == mb["losses"]
    for a, b in zip(tree_leaves(final_a), tree_leaves(final_b)):
        assert torch.equal(a, b)


# InternVL2-76B's unscaled-kernel shapes in phase 16 of chip_smoke.py: one
# layer trained over (data 1, model 4), M = 768 rows (one row of 256 patches
# and 512 tokens per microbatch): wq, wk/wv, wo, w_gate/w_up, w_down, head.
INTERNVL2_TRAIN_SHAPES = [(768, 8192, 2048), (768, 8192, 256), (768, 2048, 8192),
                          (768, 8192, 7168), (768, 7168, 8192), (768, 8192, 32064)]
# Its column-parallel linears served over (data 2, model 2) in phase 17 (K, N):
# wq, wk/wv, w_gate/w_up, the head, at M = 2 rows per data rank.
INTERNVL2_DECODE_SHAPES = [(8192, 4096), (8192, 512), (8192, 14336), (8192, 64128)]


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", INTERNVL2_TRAIN_SHAPES)
def test_gpu_kernel_vs_plain_internvl2_training_shapes(cuda, m, k, n):
    _kernel_vs_plain(cuda, m, k, n, 8)


@pytest.mark.gpu
@pytest.mark.parametrize("k,n", INTERNVL2_DECODE_SHAPES)
def test_gpu_scaled_kernel_vs_plain_internvl2_decode_shapes(cuda, k, n):
    _kernel_vs_plain(cuda, 2, k, n, 8, scaled=True)


@pytest.mark.gpu
@pytest.mark.parametrize("s,t,chunk", [(100, 192, 64), (1104, 2048, 1024)])
def test_gpu_kv_seq_attention_over_several_chunks(cuda, s, t, chunk):
    """The sharded writing prefill's attention where the keys span several
    attention chunks (``sharded_lm.kv_seq_attention``), on one rank of a
    one-rank mesh (no collective): the unsharded chunked pass's running max
    and rescaling, each chunk's ``p @ v`` the unsharded product.  On the
    card against ``layers.flash_attention``, within one bf16 rounding of the
    largest output (cuBLAS may sum a chunk's view in another order)."""
    from repro_torch.models import layers
    from repro_torch.parallel import sharded_lm
    from repro_torch.parallel.sharding import Mesh

    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((2, s, 16, 128), generator=g, device=cuda).to(torch.bfloat16)
    k = torch.randn((2, t, 16, 128), generator=g, device=cuda).to(torch.bfloat16)
    v = torch.randn((2, t, 16, 128), generator=g, device=cuda).to(torch.bfloat16)
    mesh = Mesh({"data": 1, "model": 1}, device=cuda)
    got = sharded_lm.kv_seq_attention(q, k, v, torch.arange(s, device=cuda)[None],
                                      torch.arange(t, device=cuda), causal=True, window=0,
                                      chunk=chunk, mesh=mesh)
    want = layers.flash_attention(q, k, v, causal=True, chunk=chunk)
    assert got.shape == want.shape and bool(torch.isfinite(got.float()).all())
    assert float((got.float() - want.float()).abs().max()) <= 2 ** -8 * float(want.float().abs().max())


# Granite-20B's decode linears (K, N): wq/wo, wk/wv (MQA: one KV head of
# 128), w_up, w_down (K = 24,576), the head; H2O-Danube3-4B's (head_dim 120:
# K = 3840, wk/wv at N = 960); DBRX-132B's wk/wv and head (N = 100,352).
LAST_CONFIG_SHAPES = [(6144, 6144), (6144, 128), (6144, 24576), (24576, 6144), (6144, 49152),
                      (3840, 3840), (3840, 960), (3840, 10240), (10240, 3840), (3840, 32000),
                      (6144, 1024), (6144, 100352)]


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 4, 8])
@pytest.mark.parametrize("k,n", LAST_CONFIG_SHAPES)
def test_gpu_scaled_kernel_vs_plain_last_config_shapes(cuda, m, k, n):
    """The scaled kernel at Granite-20B's, H2O-Danube3-4B's and DBRX-132B's
    decode shapes, bit for bit against the plain version (tolerance 0)."""
    _kernel_vs_plain(cuda, m, k, n, 8, scaled=True, seed=m)


@pytest.mark.gpu
@pytest.mark.parametrize("q_offset,window", [(16_000, 1024), (700, 0), ([16_000, 9_000], 512)])
def test_gpu_chunked_attention_skips_masked_chunks_bit_exactly(cuda, q_offset, window,
                                                               monkeypatch):
    """The chunked pass over the live chunks alone (``layers._live_chunks``)
    against the pass over every chunk, on the card in bf16: bit-equal (a
    chunk every row masks leaves the running max, sum and accumulator as
    they were)."""
    from repro_torch.models import layers

    b = len(q_offset) if isinstance(q_offset, list) else 1
    g = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randn((b, 100, 8, 128), generator=g, device=cuda).to(torch.bfloat16)
    k = torch.randn((b, 16_500, 2, 128), generator=g, device=cuda).to(torch.bfloat16)
    v = torch.randn((b, 16_500, 2, 128), generator=g, device=cuda).to(torch.bfloat16)
    off = torch.tensor(q_offset, device=cuda)
    kw = dict(causal=True, window=window, chunk=1024, q_offset=off)
    got = layers.flash_attention(q, k, v, **kw)
    monkeypatch.setattr(layers, "_live_chunks", lambda off, s, t, chunk, *_: range(-(-t // chunk)))
    want = layers.flash_attention(q, k, v, **kw)
    assert bool(torch.isfinite(got.float()).all()) and torch.equal(got, want)
