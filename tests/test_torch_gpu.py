"""The port's CUDA kernel on the card, held against its plain PyTorch version.

Every test here needs a CUDA card and skips without one.  The file imports
no jax (the machine with the card has none), so it runs there with

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest``: the suite's shared conftest imports jax).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import mma_matmul as mk
from repro_torch.kernels import ops
from repro_torch.models import unet
from repro_torch.segserve import SegEngine
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


@pytest.fixture
def cuda():
    """The CUDA device, or a skip where there is no card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _kernel_vs_plain(dev, m, k, n, planes, signed=True, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(-128, 128, (m, k), dtype=torch.int8, generator=g).to(dev)
    w = torch.randint(-128, 128, (k, n), dtype=torch.int8, generator=g).to(dev)
    got = mk.mma_matmul_kernel(x, w, planes=planes, signed=signed)
    want = mk.mma_matmul_plain(x, w, planes=planes, signed=signed)
    torch.cuda.synchronize()
    assert torch.equal(got, want), (m, k, n, planes, signed)


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
