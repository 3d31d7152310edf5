"""The merged multiply-add (MMA) kernel: hand-written CUDA kernels for
Hopper (``csrc/mma_matmul.cu``), their plain PyTorch versions, and the
variant table between them.

The kernels replace the TPU kernel ``repro/kernels/mma_matmul.py::
_mma_kernel`` in both forms.  Unscaled: (M, K) int8 @ (K, N) int8 -> (M, N)
int32 as an MSB-first Horner over ``planes`` bit planes of the offset
activation, one int8 tensor-core product per plane, with the residual held
in registers — x and w stream once per output tile through a ``cp.async``
ring, plane partials never leave the SM.  Scaled: the same product with the
dequant epilogue fused into the store, float32 ``(acc * x_scale) *
w_scale[n]``; at decode shapes (M <= 16) on the tensor cores with the
operands swapped (w^T times the plane of x) and K split across blocks,
above 16 rows on the CUDA cores.

The wrappers pick, in plain Python from what they can see: the unscaled
kernel's block height (:func:`tile_rows`: 64 rows, or 32 where a 64-row grid
would not fill the card's SMs once), the decode kernel's K splits
(:func:`split_k`), and the copy width of each operand's staging
(:func:`copy_width`: 16 or 4 bytes where the row stride and the base
pointer allow, else 1).

Build: at first use, ``nvcc`` compiles the checkout's source into a shared
library with a plain C interface under ``csrc/build/`` (named by a hash of
source and flags), which is loaded with ``ctypes``.

Dispatch is by the tensor's device, nothing else: a CUDA tensor launches the
kernel (or raises), a CPU tensor runs :func:`mma_matmul_plain`.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from repro_torch.core import bitplane

N_BITS = 8

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "mma_matmul.cu"
BUILD_DIR = SOURCE.parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: Kernel launches since the last reset, one count per kernel — incremented
#: where the CUDA kernel is launched and nowhere else, so a run can show its
#: main path went through the kernel.  Callers reset them by assigning 0.
launches = 0  # the unscaled kernel (int32 out)
scaled_launches = 0  # the scaled kernel (fused dequant epilogue, float32 out)
#: The unscaled kernel's launches by ``(planes, signed)`` template
#: instantiation, counted at the same place as ``launches``; reset with
#: ``.clear()``.
variant_launches: collections.Counter = collections.Counter()


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin and PATH)")
    return found


@functools.lru_cache(maxsize=None)
def build() -> tuple[Path, str]:
    """Compile the kernel library (once per source and flags); returns its
    path and the compiler's ``-Xptxas -v`` report (registers, shared memory,
    spills of every instantiation)."""
    tag = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"libmma_matmul-{tag}.so"
    log = BUILD_DIR / f"libmma_matmul-{tag}.log"
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = BUILD_DIR / f"{lib.name}.{os.getpid()}.tmp"
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed with code {proc.returncode}:\n{proc.stdout}{proc.stderr}"
            )
        log.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib)  # atomic: a concurrent build never sees half a library
    return lib, log.read_text()


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    lib.mma_matmul_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.mma_matmul_launch.restype = ctypes.c_int
    lib.mma_matmul_scaled_launch.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    )
    lib.mma_matmul_scaled_launch.restype = ctypes.c_int
    lib.mma_matmul_error_string.argtypes = [ctypes.c_int]
    lib.mma_matmul_error_string.restype = ctypes.c_char_p
    return lib


def tile_rows(m: int, n: int, sms: int) -> int:
    """Block height of the unscaled kernel for an (m, n) output on a card
    with ``sms`` SMs: 64 rows, or 32 where the 64 x 64 grid is under one
    wave (fewer blocks than SMs), so more SMs get work."""
    return 32 if -(-m // 64) * -(-n // 64) < sms else 64


#: The decode kernel: M up to this many rows runs on the tensor cores
#: (``mma_tc_decode_kernel``), in blocks of ``DECODE_BN`` columns over
#: ``DECODE_BK``-deep K tiles (``DECODE_M``, ``DC_BN`` and ``DC_BK`` in
#: ``csrc/mma_matmul.cu``).
DECODE_M, DECODE_BN, DECODE_BK = 16, 64, 128
#: The fewest K tiles a split keeps.
MIN_SPLIT_TILES = 2


def max_splits(k: int) -> int:
    """The most K splits :func:`split_k` gives a contraction of depth ``k``:
    each split keeps at least ``MIN_SPLIT_TILES`` K tiles."""
    return max(1, -(-k // DECODE_BK) // MIN_SPLIT_TILES)


def split_k(m: int, k: int, n: int, sms: int) -> int:
    """K splits of the scaled kernel for an (m, k) @ (k, n) product on a
    card with ``sms`` SMs: enough that the grid of ``DECODE_BN``-column
    blocks times splits covers two waves of SMs, but no more than
    :func:`max_splits`.  1 above ``DECODE_M`` rows (the CUDA-core kernel
    does not split) and where the column blocks alone make two waves."""
    if m > DECODE_M:
        return 1
    blocks = -(-n // DECODE_BN)
    return max(1, min(-(-2 * sms // blocks), max_splits(k)))


def copy_width(ptr: int, row_bytes: int) -> int:
    """Bytes per copy when the kernel stages an operand whose rows are
    ``row_bytes`` apart from address ``ptr``: 16 or 4 where both are
    multiples of it (``cp.async`` wants aligned ends), else 1."""
    for width in (16, 4):
        if ptr % width == 0 and row_bytes % width == 0:
            return width
    return 1


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def mma_matmul_plain(
    x: torch.Tensor, w: torch.Tensor, *, planes: int = N_BITS, signed: bool = True
) -> torch.Tensor:
    """The kernel's plain PyTorch version, on any device: the same MSB-first
    Horner recurrence on whole tensors (``bitplane.bitplane_matmul``, exact
    through float64 products)."""
    return bitplane.bitplane_matmul(x, w, planes=planes, signed=signed)


def mma_matmul_scaled_plain(
    x: torch.Tensor,
    w: torch.Tensor,
    x_scale: torch.Tensor,
    w_scale: torch.Tensor,
    *,
    planes: int = N_BITS,
    signed: bool = True,
) -> torch.Tensor:
    """The scaled kernel's plain PyTorch version, on any device: the exact
    int32 product, then ``(float32(acc) * x_scale) * w_scale`` in that order,
    each product rounded once — bit for bit what the kernel's epilogue
    writes."""
    acc = bitplane.bitplane_matmul(x, w, planes=planes, signed=signed)
    return acc.to(torch.float32) * x_scale.reshape(()) * w_scale.reshape(-1)


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"expected int8 operands, got {x.dtype} and {w.dtype}")
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"expected (M, K) @ (K, N), got {tuple(x.shape)} @ {tuple(w.shape)}")
    if x.device != w.device:
        raise ValueError(f"operands on {x.device} and {w.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("operands must be contiguous")
    if max(x.shape[0], x.shape[1], w.shape[1]) >= 2**31:
        raise ValueError(f"dimension past int32: {tuple(x.shape)} @ {tuple(w.shape)}")


def _check_scales(x_scale: torch.Tensor, w_scale: torch.Tensor, w: torch.Tensor) -> None:
    for name, s, n in (("x_scale", x_scale, 1), ("w_scale", w_scale, w.shape[1])):
        if s.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {s.dtype}")
        if s.numel() != n or s.device != w.device or not s.is_contiguous():
            raise ValueError(
                f"{name} must be {n} contiguous float32 on {w.device}, got "
                f"{tuple(s.shape)} on {s.device}"
            )


def _raise_on(err: int) -> None:
    if err != 0:
        msg = _library().mma_matmul_error_string(err).decode()
        raise RuntimeError(f"mma_matmul kernel launch failed: {msg} (cudaError {err})")


def _launch(
    x: torch.Tensor, w: torch.Tensor, planes: int, signed: bool, *, bm: int | None = None
) -> torch.Tensor:
    """The unscaled kernel; ``bm`` forces the block height (32 or 64), else
    :func:`tile_rows` picks it."""
    global launches
    _check(x, w)
    if x.device.type == "cpu":
        return mma_matmul_plain(x, w, planes=planes, signed=signed)
    if x.device.type != "cuda":
        raise ValueError(f"no MMA kernel for device {x.device}")
    m, k = x.shape
    n = w.shape[1]
    out = torch.empty((m, n), dtype=torch.int32, device=x.device)
    if m == 0 or n == 0:
        return out
    with torch.cuda.device(x.device):
        if bm is None:
            bm = tile_rows(m, n, _sm_count(torch.cuda.current_device()))
        err = _library().mma_matmul_launch(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), m, k, n, planes, int(signed), bm,
            copy_width(x.data_ptr(), k), copy_width(w.data_ptr(), n),
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(err)
    launches += 1
    variant_launches[(planes, bool(signed))] += 1
    return out


def _launch_scaled(
    x: torch.Tensor, w: torch.Tensor, x_scale: torch.Tensor, w_scale: torch.Tensor,
    planes: int, signed: bool, *, splits: int | None = None,
) -> torch.Tensor:
    """The scaled kernel; ``splits`` forces the decode kernel's K splits,
    else :func:`split_k` picks them."""
    global scaled_launches
    _check(x, w)
    _check_scales(x_scale, w_scale, w)
    if x.device.type == "cpu":
        return mma_matmul_scaled_plain(x, w, x_scale, w_scale, planes=planes, signed=signed)
    if x.device.type != "cuda":
        raise ValueError(f"no MMA kernel for device {x.device}")
    m, k = x.shape
    n = w.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return out
    with torch.cuda.device(x.device):
        if splits is None:
            splits = split_k(m, k, n, _sm_count(torch.cuda.current_device()))
        # split sums and one arrival counter per column block, zeroed on
        # the stream (inside a captured graph, at every replay)
        work = (torch.zeros(m * n + -(-n // DECODE_BN), dtype=torch.int32, device=x.device)
                if splits > 1 else None)
        err = _library().mma_matmul_scaled_launch(
            x.data_ptr(), w.data_ptr(), x_scale.data_ptr(), w_scale.data_ptr(),
            out.data_ptr(), None if work is None else work.data_ptr(), m, k, n, planes,
            int(signed), splits, copy_width(x.data_ptr(), k), copy_width(w.data_ptr(), n),
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(err)
    scaled_launches += 1
    return out


@functools.lru_cache(maxsize=None)
def plane_variant(planes: int, signed: bool = True, *, scaled: bool = False):
    """The kernel specialization for one plane budget.

    ``planes`` and ``signed`` are template parameters of the CUDA kernels:
    a 4-plane variant issues half the plane products of the 8-plane one, so
    a schedule that gives a layer 4 planes runs a smaller kernel, not a
    masked full-width one.  ``scaled`` selects the fused-dequant form, which
    takes ``(x, w, x_scale, w_scale)``.  ``plane_variant.cache_info()``
    exposes the variant table for tests and benchmarks.
    """
    if not (1 <= planes <= N_BITS):
        raise ValueError(f"planes {planes} outside 1..{N_BITS}")

    if scaled:
        def variant(x, w, x_scale, w_scale):
            return _launch_scaled(x, w, x_scale, w_scale, planes, signed)
    else:
        def variant(x, w):
            return _launch(x, w, planes, signed)

    variant.__name__ = f"mma_matmul{'_scaled' if scaled else ''}_p{planes}{'' if signed else 'u'}"
    return variant


def mma_matmul_kernel(
    x: torch.Tensor, w: torch.Tensor, *, planes: int = N_BITS, signed: bool = True
) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32, fused bit-plane Horner.

    Contiguous operands on one device.  Ragged shapes need no padding: the
    kernel masks its edges.  Dispatches through the variant table.
    """
    return plane_variant(planes, signed)(x, w)


def mma_matmul_scaled_kernel(
    x: torch.Tensor,
    w: torch.Tensor,
    x_scale: torch.Tensor,
    w_scale: torch.Tensor,
    *,
    planes: int = N_BITS,
    signed: bool = True,
) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) float32 with the dequant epilogue
    fused into the store: ``(acc * x_scale) * w_scale[n]``.

    ``x_scale``: one float32 (a per-tensor activation scale) on the operands'
    device — the kernel reads it there, so no host synchronization;
    ``w_scale``: (N,) float32 per-channel scales.  Dispatches through the
    variant table.
    """
    return plane_variant(planes, signed, scaled=True)(x, w, x_scale, w_scale)
