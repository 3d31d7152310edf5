"""The port's MMA kernel module and KPB conv against the JAX reference.

On the CPU the kernel wrapper runs its plain version (the tensor lies on
the CPU); it must agree bit for bit with the reference's Pallas kernel in
interpret mode and with its masked-matmul oracle, on the reference's own
sweep.  The CUDA kernel itself is held against the plain version on the card
in ``test_torch_gpu.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import mma_matmul as mk
from repro_torch.kernels import ops, ref
from repro_torch.models import unet

SWEEP = [
    (4, 32, 8), (32, 128, 32), (128, 512, 128), (37, 100, 65),
    (1, 7, 3), (256, 1024, 256), (64, 300, 90),
]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    torch.set_num_threads(2)


def _rand_i8(rng, shape):
    return rng.integers(-128, 128, shape).astype(np.int8)


@pytest.mark.parametrize("m,k,n", SWEEP)
@pytest.mark.parametrize("planes", [8, 5, 2])
def test_plain_matmul_vs_pallas_and_oracle(m, k, n, planes):
    rng = np.random.default_rng(m * 7919 + k * 31 + n + planes)
    x, w = _rand_i8(rng, (m, k)), _rand_i8(rng, (k, n))
    got = ops.mma_matmul(x, w, planes=planes, device="cpu").numpy()
    want_kernel = np.asarray(jops.mma_matmul(jnp.asarray(x), jnp.asarray(w), planes=planes,
                                             interpret=True))
    want_oracle = np.asarray(jref.mma_matmul_ref(jnp.asarray(x), jnp.asarray(w), planes=planes))
    np.testing.assert_array_equal(got, want_kernel)
    np.testing.assert_array_equal(got, want_oracle)


@pytest.mark.parametrize("planes", range(1, 9))
def test_plane_truncation_matches_oracles(planes):
    rng = np.random.default_rng(planes)
    x, w = _rand_i8(rng, (16, 64)), _rand_i8(rng, (64, 16))
    got = mk.mma_matmul_kernel(torch.from_numpy(x), torch.from_numpy(w), planes=planes)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jref.mma_matmul_ref(jnp.asarray(x), jnp.asarray(w), planes=planes))
    )
    np.testing.assert_array_equal(
        ref.mma_matmul_ref(torch.from_numpy(x), torch.from_numpy(w), planes=planes).numpy(),
        got.numpy(),
    )


def test_unsigned_mode_vs_pallas():
    rng = np.random.default_rng(3)
    u8 = rng.integers(0, 256, (16, 64)).astype(np.uint8)
    xi = u8.view(np.int8)  # the kernel takes the byte, read as uint8
    w = _rand_i8(rng, (64, 16))
    got = ops.mma_matmul(xi, w, signed=False, device="cpu").numpy()
    want = u8.astype(np.int64) @ w.astype(np.int64)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.asarray(jops.mma_matmul(jnp.asarray(xi), jnp.asarray(w), signed=False,
                                        interpret=True))
    )


def test_batched_leading_dims():
    rng = np.random.default_rng(4)
    x, w = _rand_i8(rng, (2, 3, 40)), _rand_i8(rng, (40, 16))
    got = ops.mma_matmul(x, w, device="cpu").numpy()
    want = np.asarray(jref.mma_matmul_ref(jnp.asarray(x.reshape(6, 40)), jnp.asarray(w)))
    np.testing.assert_array_equal(got, want.reshape(2, 3, 16))


def test_tensor_planes_fold_into_data():
    """A tensor budget (one entry of a budget array) runs the 8-plane
    variant on the truncated operand: same values as the static budget."""
    rng = np.random.default_rng(5)
    x, w = _rand_i8(rng, (24, 96)), _rand_i8(rng, (96, 48))
    for b in (3, 6):
        got = ops.mma_matmul(x, w, planes=torch.tensor(b, dtype=torch.int32), device="cpu")
        np.testing.assert_array_equal(
            got.numpy(), ops.mma_matmul(x, w, planes=b, device="cpu").numpy()
        )


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("planes", [8, 4])
def test_conv2d_vs_reference_oracle(stride, planes):
    rng = np.random.default_rng(10 * stride + planes)
    x, w = _rand_i8(rng, (2, 12, 12, 16)), _rand_i8(rng, (3, 3, 16, 24))
    got = ops.mma_conv2d(x, w, stride=stride, planes=planes, device="cpu").numpy()
    want = np.asarray(jref.mma_conv2d_ref(jnp.asarray(x), jnp.asarray(w), stride=stride,
                                          planes=planes))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        ref.mma_conv2d_ref(torch.from_numpy(x), torch.from_numpy(w), stride=stride,
                           planes=planes).numpy(),
        want,
    )


@pytest.mark.parametrize("pad_mode", ["zero", "edge", "reflect"])
@pytest.mark.parametrize("impl", ["kernel", "horner", "cascade", "int8"])
def test_conv2d_pad_modes_vs_reference(pad_mode, impl):
    rng = np.random.default_rng(11)
    x, w = _rand_i8(rng, (1, 7, 5, 8)), _rand_i8(rng, (3, 3, 8, 12))
    got = ops.mma_conv2d(x, w, pad_mode=pad_mode, planes=6, impl=impl, device="cpu").numpy()
    want = np.asarray(jops.mma_conv2d(jnp.asarray(x), jnp.asarray(w), pad_mode=pad_mode,
                                      planes=6, impl="xla"))
    np.testing.assert_array_equal(got, want)


def test_pad_nhwc_matches_numpy_on_tiny_axes():
    """Reflect padding of a 1- or 2-wide axis follows numpy (the reference
    pads with ``jnp.pad``): the U-Net's deepest level can be that small."""
    for h, w in [(1, 1), (2, 1), (3, 2)]:
        x = np.arange(h * w * 2, dtype=np.float32).reshape(1, h, w, 2)
        for mode in ("edge", "reflect"):
            got = ops.pad_nhwc(torch.from_numpy(x), 1, mode).numpy()
            np.testing.assert_array_equal(
                got, np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)), mode=mode)
            )
    with pytest.raises(ValueError):
        ops.pad_nhwc(torch.zeros(1, 2, 2, 1), 1, "wrap")


def test_plane_variants_are_cached():
    rng = np.random.default_rng(6)
    x, w = torch.from_numpy(_rand_i8(rng, (8, 32))), torch.from_numpy(_rand_i8(rng, (32, 8)))
    mk.mma_matmul_kernel(x, w, planes=7)
    before = mk.plane_variant.cache_info()
    for _ in range(3):
        mk.mma_matmul_kernel(x, w, planes=7)
    after = mk.plane_variant.cache_info()
    assert after.misses == before.misses
    assert after.hits == before.hits + 3
    assert mk.plane_variant(7, True).__name__ == "mma_matmul_p7"
    with pytest.raises(ValueError):
        mk.plane_variant(9)


def test_kernel_wrapper_checks_operands():
    x = torch.zeros((4, 8), dtype=torch.int8)
    w = torch.zeros((8, 3), dtype=torch.int8)
    with pytest.raises(TypeError):
        mk.mma_matmul_kernel(x.to(torch.int32), w)
    with pytest.raises(ValueError):
        mk.mma_matmul_kernel(x, w[:7])
    with pytest.raises(ValueError):
        mk.mma_matmul_kernel(torch.zeros((8, 4), dtype=torch.int8).t(), w)


def test_cpu_path_does_not_count_launches():
    rng = np.random.default_rng(8)
    before = mk.launches
    ops.mma_matmul(_rand_i8(rng, (4, 8)), _rand_i8(rng, (8, 4)), device="cpu")
    assert mk.launches == before


# ------------------------------------- the unscaled kernel's design, on the CPU

H100_SMS = 132


def test_tile_rows_on_the_unet_shapes():
    """The calibrated U-Net's convs at a 4-tile micro-batch: the three whose
    64 x 64 grid is under one wave of 132 SMs (enc2: 75 blocks, bottleneck:
    42, dec2: 75) take the 32-row block."""
    cfg = unet.UNetConfig(quant_mode="mma_int8")
    got = [mk.tile_rows(4 * c.out_h * c.out_w, c.cout, H100_SMS) for c in cfg.conv_layers()]
    assert got == [64, 64, 32, 32, 32, 64, 64]


@pytest.mark.parametrize("m,n,want", [
    (131 * 64, 64, 32),      # 131 blocks of 64 x 64: one short of a wave
    (131 * 64 + 1, 64, 64),  # the ragged last row block makes 132
    (132 * 64, 64, 64),
    (64, 131 * 64, 32),      # the same count along N
    (64, 132 * 64, 64),
    (1, 1, 32),
])
def test_tile_rows_at_the_wave_boundary(m, n, want):
    assert mk.tile_rows(m, n, H100_SMS) == want


@pytest.mark.parametrize("ptr,row_bytes,want", [
    (0, 5184, 16), (512, 48, 16),  # the U-Net's K and N: 16-byte cp.async
    (0, 36, 4), (0, 300, 4),       # enc0's K = 36: 4-byte cp.async
    (0, 7, 1), (0, 129, 1), (0, 70, 1), (0, 3, 1),
    (1, 5184, 1),                  # a view one byte into its storage
    (4, 5184, 4), (8, 5184, 4),
])
def test_copy_width(ptr, row_bytes, want):
    assert mk.copy_width(ptr, row_bytes) == want


def _tensor_core_emulation(x: torch.Tensor, w: torch.Tensor, planes: int,
                           signed: bool) -> torch.Tensor:
    """The unscaled CUDA kernel's arithmetic, emulated in torch: K in whole
    64-deep tiles, zero-filled past K as the cp.async ring fills it; the
    offset as an xor of four activation bytes in a 32-bit word; per tile an
    MSB-first Horner ``h = 2h + plane_b @ w`` whose planes are extracted
    from the words as ``(u >> b) & 0x01010101``, then ``acc += h << (8-P)``;
    colsum(w) as the all-ones activation times w."""
    m, k = x.shape
    kp = -(-k // 64) * 64
    xp = torch.zeros((m, kp), dtype=torch.int8)
    xp[:, :k] = x
    wp = torch.zeros((kp, w.shape[1]), dtype=torch.int64)
    wp[:k] = w.to(torch.int64)
    words = xp.view(torch.int32)
    if signed:
        words = words ^ torch.tensor(0x80808080 - 2**32, dtype=torch.int32)  # x + 128 per byte
    acc = torch.zeros((m, w.shape[1]), dtype=torch.int64)
    cs = torch.zeros((1, w.shape[1]), dtype=torch.int64)
    for k0 in range(0, kp, 64):
        u = words[:, k0 // 4:(k0 + 64) // 4].contiguous()
        wt = wp[k0:k0 + 64]
        cs += torch.ones((1, 64), dtype=torch.int64) @ wt
        h = torch.zeros_like(acc)
        for b in range(7, 7 - planes, -1):
            plane = ((u >> b) & 0x01010101).view(torch.uint8).to(torch.int64)
            h = h + h + plane @ wt
        acc += h << (8 - planes)
    return (acc - 128 * cs if signed else acc).to(torch.int32)


@pytest.mark.parametrize("m,k,n", [(37, 100, 65), (1, 7, 3), (64, 300, 90), (5, 129, 70),
                                   (33, 36, 48)])
@pytest.mark.parametrize("planes,signed", [(8, True), (5, True), (1, True), (8, False),
                                           (3, False)])
def test_tensor_core_decomposition_vs_plain_and_pallas(m, k, n, planes, signed):
    """The decomposition the CUDA kernel computes (``_tensor_core_emulation``)
    equals the plain version and the reference's Pallas kernel in interpret
    mode bit for bit, on ragged shapes."""
    rng = np.random.default_rng(m * 1009 + k * 17 + n + planes)
    x, w = _rand_i8(rng, (m, k)), _rand_i8(rng, (k, n))
    got = _tensor_core_emulation(torch.from_numpy(x), torch.from_numpy(w), planes, signed)
    plain = mk.mma_matmul_plain(torch.from_numpy(x), torch.from_numpy(w), planes=planes,
                                signed=signed)
    pallas = np.asarray(jops.mma_matmul(jnp.asarray(x), jnp.asarray(w), planes=planes,
                                        signed=signed, interpret=True))
    assert torch.equal(got, plain)
    np.testing.assert_array_equal(got.numpy(), pallas)


# --------------------------------------------------------- the scaled kernel


@pytest.mark.parametrize("m,k,n", [(16, 96, 40), (64, 256, 128), (3, 50, 7)])
@pytest.mark.parametrize("planes", [8, 5])
def test_scaled_plain_vs_pallas(m, k, n, planes):
    """The scaled kernel's plain version against the reference's fused
    epilogue in interpret mode: both compute (f32(acc) * x_scale) * w_scale
    with the same int32 acc, so bit for bit (the reference's own test allows
    rtol 1e-6 against int32-then-scale)."""
    rng = np.random.default_rng(m * 131 + k + n + planes)
    x, w = _rand_i8(rng, (m, k)), _rand_i8(rng, (k, n))
    xs = np.float32(0.0173)
    ws = rng.uniform(1e-3, 1e-2, n).astype(np.float32)
    got = ops.mma_matmul_scaled(x, w, xs, ws, planes=planes, device="cpu").numpy()
    want = np.asarray(jops.mma_matmul_scaled(jnp.asarray(x), jnp.asarray(w), jnp.float32(xs),
                                             jnp.asarray(ws), planes=planes, interpret=True))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    direct = mk.mma_matmul_scaled_kernel(torch.from_numpy(x), torch.from_numpy(w),
                                         torch.tensor(xs), torch.from_numpy(ws), planes=planes)
    np.testing.assert_array_equal(direct.numpy(), want)


def test_scaled_leading_dims_and_tensor_planes():
    rng = np.random.default_rng(12)
    x, w = _rand_i8(rng, (2, 3, 40)), _rand_i8(rng, (40, 16))
    ws = rng.uniform(1e-3, 1e-2, (1, 16)).astype(np.float32)  # a (1, N) scale row
    xs = torch.tensor(0.02, dtype=torch.float32)
    got = ops.mma_matmul_scaled(x, w, xs, ws, planes=5, device="cpu")
    want = mk.mma_matmul_scaled_plain(torch.from_numpy(x.reshape(6, 40)), torch.from_numpy(w),
                                      xs, torch.from_numpy(ws), planes=5)
    assert torch.equal(got, want.reshape(2, 3, 16))
    folded = ops.mma_matmul_scaled(x, w, xs, ws, planes=torch.tensor(5, dtype=torch.int32),
                                   device="cpu")
    assert torch.equal(folded, got)


def test_scaled_variants_are_cached_and_checked():
    rng = np.random.default_rng(13)
    x, w = torch.from_numpy(_rand_i8(rng, (8, 32))), torch.from_numpy(_rand_i8(rng, (32, 8)))
    xs, ws = torch.tensor([0.5]), torch.full((8,), 0.25)
    mk.mma_matmul_scaled_kernel(x, w, xs, ws, planes=6)
    before = mk.plane_variant.cache_info()
    for _ in range(2):
        mk.mma_matmul_scaled_kernel(x, w, xs, ws, planes=6)
    after = mk.plane_variant.cache_info()
    assert (after.misses, after.hits) == (before.misses, before.hits + 2)
    assert mk.plane_variant(6, True, scaled=True).__name__ == "mma_matmul_scaled_p6"
    assert mk.plane_variant(6, False, scaled=True).__name__ == "mma_matmul_scaled_p6u"
    with pytest.raises(TypeError):
        mk.mma_matmul_scaled_kernel(x, w, xs.double(), ws)
    with pytest.raises(ValueError):
        mk.mma_matmul_scaled_kernel(x, w, torch.tensor([0.5, 0.5]), ws)
    with pytest.raises(ValueError):
        mk.mma_matmul_scaled_kernel(x, w, xs, ws[:7])


# ---------------------------------- the scaled kernel's decode design, on the CPU

# Yi-6B's linears at batched decode (M = 4 slots): (name, K, N, K splits on
# 132 SMs).  64-column blocks: wq/wo and w_down give 64, wk/wv 8, w_gate/w_up
# 172, the head 1000.
YI_DECODE = [("wq/wo", 4096, 4096, 5), ("wk/wv", 4096, 512, 16),
             ("w_gate/w_up", 4096, 11008, 2), ("w_down", 11008, 4096, 5),
             ("head", 4096, 64000, 1)]


@pytest.mark.parametrize("name,k,n,want", YI_DECODE)
def test_split_k_on_the_yi_decode_shapes(name, k, n, want):
    """Two waves of 132 SMs: ceil(264 / column blocks) splits, at most one
    per two 128-deep K tiles; the head's 1000 blocks take none."""
    assert mk.split_k(4, k, n, H100_SMS) == want
    blocks = -(-n // mk.SCALED_BN)
    assert want == 1 or blocks * want >= 2 * H100_SMS or want == mk.max_splits(k)


@pytest.mark.parametrize("m,k,n,want", [
    (4, 7, 512, 1),              # K under one tile
    (4, 128, 512, 1),            # one tile
    (4, 256, 64, 1),             # two tiles: one split keeps both
    (4, 4096, 64, 16),           # one column block: capped at max_splits
    (4, 4096, 264 * 64, 1),      # 2 waves of column blocks
    (4, 4096, 132 * 64, 2),      # 1 wave
    (4, 4096, 132 * 64 + 1, 2),  # a ragged block past one wave
    (16, 4096, 4096, 5),         # two n8 fragments
    (17, 4096, 4096, 5),         # three n8 fragments, one row tile: the same rule
    (33, 4096, 4096, 3),         # two row tiles of 32: 128 blocks
    (512, 4096, 4096, 1),        # 16 row tiles x 64 column blocks: two waves
    (4, 0, 70, 1),               # empty contraction
])
def test_split_k_at_its_edges(m, k, n, want):
    assert mk.split_k(m, k, n, H100_SMS) == want


def test_max_splits_keeps_two_tiles_each():
    assert [mk.max_splits(k) for k in (0, 1, 128, 255, 256, 4096, 11008)] == [1, 1, 1, 1, 1, 16, 43]


# minitron_4b's linears at the gateway's batch (M = 20 rows, one row tile):
# (name, K, N, K splits on 132 SMs).  64-column blocks: wq/wo and w_down give
# 48, wk/wv 16, w_gate/w_up 144, the head 4000.
MINITRON_DECODE = [("wq/wo", 3072, 3072, 6), ("wk/wv", 3072, 1024, 12),
                   ("w_gate/w_up", 3072, 9216, 2), ("w_down", 9216, 3072, 6),
                   ("head", 3072, 256000, 1)]


@pytest.mark.parametrize("name,k,n,want", MINITRON_DECODE)
def test_split_k_on_the_minitron_shapes_at_20_rows(name, k, n, want):
    """The same two-wave rule above 16 rows; wk/wv's 16 column blocks are
    capped at max_splits (24 K tiles, 12 splits)."""
    assert mk.split_k(20, k, n, H100_SMS) == want
    blocks = -(-n // mk.SCALED_BN)
    assert want == 1 or blocks * want >= 2 * H100_SMS or want == mk.max_splits(k)


@pytest.mark.parametrize("m,want", [(1, 1), (16, 1), (20, 1), (32, 1), (33, 2), (64, 2),
                                    (65, 3), (512, 16)])
def test_row_tiles_of_32_rows(m, want):
    assert mk.row_tiles(m) == want


def _scaled_emulation(x: torch.Tensor, w: torch.Tensor, x_scale: torch.Tensor,
                      w_scale: torch.Tensor, planes: int, signed: bool, splits: int,
                      order: torch.Generator) -> torch.Tensor:
    """The scaled kernel's arithmetic, emulated in torch.  Rows: a pass
    stages the fewest n8 fragments (NF, 8 rows each, at most 4) that hold
    its row tile; above ``SCALED_TILE_M`` = 32 rows M is cut into tiles of 32,
    each with its own pass over w and its own arrival counter.  Staged bytes
    past M and K are 0 (offset to 128 when signed, as the xor does); the
    products of rows past M are computed and dropped.  Operands swapped:
    w^T (N x 64, s8) times the plane of x (64 x 8*NF, u8), giving the
    transposed product.  K in 128-deep staged tiles, cut into ``splits``
    runs of whole tiles as the kernel's grid cuts them; each tile is two
    64-deep halves with a Horner of their own.  Per split: sum of
    ``h << (8-P)`` minus its share of 128 * colsum(w), an int32 partial.
    Each row tile's partials are summed in an order drawn from ``order``
    (its blocks' arrival order), then the float epilogue runs once."""
    m, k = x.shape
    n = w.shape[1]
    ktiles = -(-k // mk.SCALED_BK)
    kp = ktiles * mk.SCALED_BK
    tiles = mk.row_tiles(m)
    xr = 8 * min(4, -(-m // 8))  # staged rows per pass
    xb = torch.zeros((max(tiles * mk.SCALED_TILE_M, xr), kp), dtype=torch.int64)
    xb[:m, :k] = x.to(torch.int64) & 0xFF
    u = xb ^ 0x80 if signed else xb
    wt = torch.zeros((n, kp), dtype=torch.int64)  # A = w^T
    wt[:, :k] = w.to(torch.int64).T
    rows = []
    for rt in range(tiles):
        ut = u[rt * mk.SCALED_TILE_M:rt * mk.SCALED_TILE_M + xr]
        partials = []
        for s in range(splits):
            kt0, kt1 = s * ktiles // splits, (s + 1) * ktiles // splits
            part = torch.zeros((n, xr), dtype=torch.int64)
            for k0 in range(kt0 * mk.SCALED_BK, kt1 * mk.SCALED_BK, 64):
                a = wt[:, k0:k0 + 64]
                h = torch.zeros_like(part)
                for b in range(7, 7 - planes, -1):
                    h = h + h + a @ ((ut[:, k0:k0 + 64] >> b) & 1).T  # B = the plane of x
                part += h << (8 - planes)
                if signed:
                    part -= 128 * (a @ torch.ones((64, 1), dtype=torch.int64))
            partials.append(part.to(torch.int32))
        acc = torch.zeros((n, xr), dtype=torch.int32)
        for i in torch.randperm(splits, generator=order).tolist():
            acc += partials[i]
        rows.append(acc.T[:min(mk.SCALED_TILE_M, m - rt * mk.SCALED_TILE_M)])
    acc = torch.cat(rows)
    return acc.to(torch.float32) * x_scale.reshape(()) * w_scale.reshape(-1)


def _decomposition_vs_plain_and_pallas(m, k, n, planes, signed, seed):
    """``_scaled_emulation`` equals the plain version bit for bit at split
    counts 1, all K tiles, ``max_splits`` and ``split_k``'s choice, twice
    each in shuffled arrival orders, and the reference's Pallas kernel in
    interpret mode."""
    rng = np.random.default_rng(seed)
    x, w = _rand_i8(rng, (m, k)), _rand_i8(rng, (k, n))
    xs = np.float32(rng.uniform(1e-3, 0.1))
    ws = rng.uniform(1e-4, 1e-2, n).astype(np.float32)
    tx, tw, txs, tws = (torch.from_numpy(x), torch.from_numpy(w), torch.tensor([xs]),
                        torch.from_numpy(ws))
    plain = mk.mma_matmul_scaled_plain(tx, tw, txs, tws, planes=planes, signed=signed)
    order = torch.Generator().manual_seed(planes)
    ktiles = -(-k // mk.SCALED_BK)
    for splits in sorted({1, ktiles, mk.max_splits(k), mk.split_k(m, k, n, H100_SMS)}):
        for _ in range(2):
            got = _scaled_emulation(tx, tw, txs, tws, planes, signed, splits, order)
            assert torch.equal(got, plain), splits
    pallas = np.asarray(jops.mma_matmul_scaled(jnp.asarray(x), jnp.asarray(w), jnp.float32(xs),
                                               jnp.asarray(ws), planes=planes, signed=signed,
                                               interpret=True))
    np.testing.assert_array_equal(got.numpy(), pallas)


@pytest.mark.parametrize("m,k,n", [(1, 7, 3), (4, 300, 70), (9, 520, 33), (16, 1000, 65)])
@pytest.mark.parametrize("planes", range(1, 9))
@pytest.mark.parametrize("signed", [True, False])
def test_decode_decomposition_vs_plain_and_pallas(m, k, n, planes, signed):
    """The decomposition the scaled kernel computes (``_scaled_emulation``)
    on one and two n8 fragments, on ragged decode shapes."""
    _decomposition_vs_plain_and_pallas(m, k, n, planes, signed,
                                       m * 7 + k * 3 + n + 17 * planes + signed)


# M above 16 rows: three and four n8 fragments in one pass (17-32 rows), and
# row tiles of 32 (33-70 rows: the last tile ragged), with ragged K and N.
ROW_TILED = [(17, 300, 70), (20, 1000, 65), (24, 129, 33), (25, 520, 70), (32, 7, 3),
             (33, 1000, 70), (64, 384, 40), (70, 640, 70)]


@pytest.mark.parametrize("m,k,n", ROW_TILED)
@pytest.mark.parametrize("planes", [1, 5, 8])
@pytest.mark.parametrize("signed", [True, False])
def test_row_tiled_decomposition_vs_plain_and_pallas(m, k, n, planes, signed):
    """The scaled kernel's decomposition above 16 rows: NF 3 and 4, and row
    tiles with a counter each."""
    _decomposition_vs_plain_and_pallas(m, k, n, planes, signed,
                                       m * 5 + k * 3 + n + 11 * planes + signed)


def test_cpu_scaled_path_does_not_count_launches():
    rng = np.random.default_rng(14)
    before = (mk.launches, mk.scaled_launches)
    ops.mma_matmul_scaled(_rand_i8(rng, (4, 8)), _rand_i8(rng, (8, 4)), np.float32(0.1),
                          np.ones(4, np.float32), device="cpu")
    assert (mk.launches, mk.scaled_launches) == before


def test_entry_points_without_device_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    x = np.zeros((4, 8), np.int8)
    w = np.zeros((8, 4), np.int8)
    with pytest.raises(RuntimeError, match="CUDA card"):
        ops.mma_matmul(x, w)
    with pytest.raises(RuntimeError, match="CUDA card"):
        ops.mma_conv2d(np.zeros((1, 4, 4, 2), np.int8), np.zeros((3, 3, 2, 2), np.int8))
    with pytest.raises(RuntimeError, match="CUDA card"):
        ops.mma_matmul_scaled(x, w, np.float32(1.0), np.ones(4, np.float32))
