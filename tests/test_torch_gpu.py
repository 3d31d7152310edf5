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
# The gateway serves it at batch 20, above the decode kernel's 16 rows.
MINITRON_SHAPES = [(3072, 3072), (3072, 1024), (3072, 9216), (9216, 3072), (3072, 256000)]

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
    _kernel_vs_plain(cuda, 3, 129, 70, planes, signed=signed, scaled=True)  # the decode kernel


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
    """The tensor-core decode kernel (M <= 16) on one and two n8 fragments,
    16-byte, 4-byte and byte staging, one to 86 K tiles, its chosen splits."""
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
    for splits in sorted({1, min(2, -(-k // mk.DECODE_BK)), mk.max_splits(k)}):
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
    with pytest.raises(RuntimeError, match="launch failed"):  # no split above 16 rows
        mk._launch_scaled(torch.zeros((17, 300), dtype=torch.int8, device=cuda), w, xs, ws, 8,
                          True, splits=2)


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
    """The scaled kernel above 16 rows (the CUDA-core branch the gateway's
    batch 20 takes) on every minitron_4b linear."""
    assert mk.split_k(m, k, n, 132) == 1
    _kernel_vs_plain(cuda, m, k, n, 5, scaled=True)


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
