// Merged multiply-add (MMA) as a bit-plane Horner matmul, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/mma_matmul.py::_mma_kernel in both
// its forms.  Unscaled (scaled=False, launched by _mma_matmul_impl), the
// kernel the U-Net's 3x3 convolutions run through: mma_tc_horner_kernel.
// Scaled (scaled=True, launched by _mma_matmul_scaled_impl), the
// fused-dequant form every int8 linear of LM serving runs through, at every
// M: mma_tc_scaled_kernel.
//
// What both compute, bit for bit: (M,K) int8 @ (K,N) int8 -> (M,N).
//   u   = x + 128 (signed) or the byte of x read as uint8 (unsigned)
//   per K tile:  h = 0;  for b = 7 .. 8-PLANES:  h = 2*h + ((u >> b) & 1) @ w
//                acc += h * 2^(8-PLANES)
//   acc -= 128 * colsum(w)   (signed only)
//   out = acc                                       (unscaled, int32)
//   out = (float(acc) * x_scale) * w_scale[n]       (scaled, float32)
// All arithmetic before the epilogue is int32, so the integer result is
// exact for any K with |acc| < 2^31, i.e. K <= 65,793 (the TPU kernel runs
// the plane products in bf16 with f32 partials and is exact only for
// K <= 512 per block).  The scaled epilogue rounds to nearest at each of
// its two products and contracts no FMA, in the reference's order; x_scale
// is read from device memory, so a caller never synchronizes to hand it
// over.
//
// What bounds them on this card.  The function moves M*K + K*N bytes in
// (plus 4*N of scales) and 4*M*N out and does 2*M*K*N int8 operations; at
// the shapes the port serves the bytes term is the larger, so the card's
// bound is its memory rate.  The digit-serial recurrence multiplies the
// operations by PLANES: the plane-work floor, PLANES * 2*M*K*N int8
// operations at the tensor cores' peak, is the least the recurrence itself
// can cost.
//
// The unscaled kernel: Horner plane products on the int8 tensor cores.
// Each plane product is its own mma.sync m16n8k32 (A the 0/1 plane as u8,
// B the weights as s8, int32 accumulate), issued MSB first into a residual
// h that never leaves registers, then acc += h << (8-PLANES) once per
// 64-deep K tile.  What bounds it (measured on an H100 at the U-Net's
// shapes, PERF.md): per plane, the mma.sync issue with its two integer ops
// of plane extraction ((u >> b) & 0x01010101, four values at once) and the
// doubling of h, about a quarter of the int8 tensor-core peak; below that,
// a fixed cost per K tile (staging latency with two tiles in flight, the
// B-fragment transposes, colsum), which sets the time at few planes and
// long K; and grids of few blocks on the small convs.  What the design
// does about it:
//   - the activation fragments are loaded once per K tile with ldmatrix
//     and every plane is extracted from them in registers; the +128 offset
//     is one xor (x ^ 0x80 per byte);
//   - the weight fragments are built once per K tile with __byte_perm 4x4
//     byte transposes of the staged [k][n] tile, and every plane and every
//     m16 fragment reuses them.  Lane g of a warp feeds column 4g+j of the
//     warp's 32 columns to n8 fragment j, so each thread's outputs are 8
//     consecutive columns of a row (two 16-byte stores);
//   - colsum(w) is one more mma per k32 chunk with an all-ones A;
//   - x and w tiles stream through a 3-deep cp.async ring (16-byte copies
//     where the row stride and base pointer allow, 4-byte copies where they
//     allow that, byte loads otherwise; the wrapper picks), zero-filled past
//     the M, K and N edges so masked rows and columns add 0 to the product
//     and to colsum.  x rows are padded to 80 bytes and w row groups by 32
//     bytes, so ldmatrix and the B-fragment loads are free of bank
//     conflicts;
//   - a block of 4 warps owns a BM x 64 tile (each warp BM/2 x 32):
//     BM = 64, or BM = 32 for shapes whose 64-row grid is under one wave of
//     the card's SMs (the wrapper picks).
//
// The scaled kernel (every M): what bounds it on this card at the shapes
// served is the bytes of w.  A decode call streams every weight once (5.8
// GB per Yi-6B call, 4.4 GB per minitron_4b call) and does M = 4 to 20 rows
// of work per weight byte, far below the tensor cores' operations-per-byte
// line, so the least it can take is w's bytes over the memory rate.  What
// the design does about it:
//   - tensor-core planes, operands swapped: each plane product is one
//     mma.sync m16n8k32 with A = w^T (16 output columns x 32 k, s8, built
//     by the same __byte_perm transposes of the staged [k][n] tile) and
//     B = the 0/1 plane of x (32 k x 8 rows, u8: a lane's B register is a
//     plain 32-bit word of one x row).  An n8 fragment holds 8 rows, so a
//     pass pays for M rounded up to 8, not to 16 or 64: the template NF
//     (1-4 n8 fragments, 8-32 staged x rows) is the fewest that hold M,
//     and at M = 20 one pass of w serves all 20 rows (NF 3).  The Horner,
//     the in-register plane extraction and colsum (one more mma with an
//     all-ones B) are the unscaled kernel's;
//   - row tiles: above 32 rows M is cut into tiles of 32 (NF 4), one grid
//     index each, each tile with its own pass over w.  The tiles that share
//     a column block are adjacent in the grid's order, so their reads of
//     the same w tiles meet in the 50 MB L2;
//   - split K: blocks of 64 columns give the linears 8 to 4,000 blocks on
//     132 SMs, so K is split across blocks (the wrapper picks the count,
//     split_k, over column blocks x row tiles).  Each split adds its int32
//     partial, h << (8-P) over its tiles minus its share of 128*colsum,
//     into a zeroed int32 workspace with atomicAdd: integer sums are exact
//     in any arrival order.  The last block to arrive for its (row tile,
//     column block) (an arrival counter per pair, after __threadfence)
//     runs the float epilogue once on the full sum.  One launch per
//     linear, no host synchronization; the wrapper allocates the workspace
//     per call, so a captured CUDA graph zeroes it at every replay;
//   - bytes in flight: w streams through a cp.async ring of 128-deep x
//     64-column tiles (8 KB, 16-byte copies where the stride and pointer
//     allow), 4 deep at NF 1 and 2 (24 KB of w in flight per block) and 3
//     deep at NF 3 and 4 (16 KB), 4 blocks to an SM.  Rows, k and columns
//     past M, K and N are zero-filled, so they add 0 to colsum and to the
//     kept rows' products.  Every ring is static shared memory, under 48
//     KB: a 4-deep ring at NF 3 and 4 (50,688 and 55,296 bytes) needs
//     dynamic shared memory and ran 2-14% slower on the card at M = 20-32
//     (PERF.md);
//   - registers: NF 1-4 keep about 56 + 20*NF ints live (acc and h 8*NF
//     each, x words 4*NF, w^T 16, colsum 8); at 5 planes, signed, ptxas
//     gives 112, 123, 110 and 128 registers, and no instantiation spills
//     at 4 blocks per SM (128 a thread); a hint of 3 ran no faster.
//   Within a block, 4 warps split the 128-deep tile into two 64-deep
//   halves x two 32-column halves; the two k halves meet in shared memory
//   before the epilogue.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// The unscaled kernel: plane products on the tensor cores
// ---------------------------------------------------------------------------

constexpr int TC_BN = 64;        // output columns per block
constexpr int TC_BK = 64;        // contraction depth of one staged K tile, bytes
constexpr int TC_STAGES = 3;     // depth of the cp.async ring
constexpr int TC_THREADS = 128;  // 4 warps, 2 x 2 over the block's tile
constexpr int XS_STRIDE = TC_BK + 16;  // x row pitch in shared memory, bytes
// w tile: rows of TC_BN bytes, 32 bytes of pad after every 4 rows
constexpr int WS_BYTES = (TC_BK / 4) * (4 * TC_BN + 32);
constexpr uint32_t LOW_BITS = 0x01010101u;  // bit 0 of each byte

__device__ __forceinline__ int ws_row(int k) { return k * TC_BN + (k >> 2) * 32; }

struct XRows {
  __device__ int operator()(int r) const { return r * XS_STRIDE; }
};
struct WRows {
  __device__ int operator()(int r) const { return ws_row(r); }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of `bytes` from global to shared; bytes past `n` are zero-filled
// and not read.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// The m16n8k32 A fragment of a 16 x 32-byte tile (a 16 x 16 tile of b16):
// lanes 8j..8j+7 give the row addresses of 8x8 matrix j.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d += a @ b: a 16 x 32 u8 (row), b 32 x 8 s8 (col), int32 accumulate.
__device__ __forceinline__ void mma_u8s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 4x4 byte transpose: r[j] holds 4 bytes of row j; afterwards r[i] holds
// byte i of rows 0..3, row 0 in the low byte.
__device__ __forceinline__ void transpose4x4(uint32_t (&r)[4]) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140), t1 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140), t3 = __byte_perm(r[2], r[3], 0x7362);
  r[0] = __byte_perm(t0, t2, 0x5410);
  r[1] = __byte_perm(t0, t2, 0x7632);
  r[2] = __byte_perm(t1, t3, 0x5410);
  r[3] = __byte_perm(t1, t3, 0x7632);
}

// Stage a ROWS x 64-byte tile of a row-major int8 matrix (row stride `ld`
// bytes, origin (r0, c0)) at `dst`, row r at dst + row_off(r); zero at rows
// >= rlim and columns >= clim.  `vec`: 16 or 4, cp.async copies of that
// width (the wrapper has checked that `ld` and the base pointer are
// multiples of it); 1, byte loads stored as words.
template <int ROWS, typename RowOff>
__device__ __forceinline__ void stage_tile(uint8_t* dst, const int8_t* src, int ld, int r0,
                                           int rlim, int c0, int clim, int vec, RowOff row_off) {
  const int tid = threadIdx.x;
  if (vec == 16) {
#pragma unroll
    for (int i = tid; i < ROWS * 4; i += TC_THREADS) {
      const int r = i >> 2, c = (i & 3) * 16, gr = r0 + r, gc = c0 + c;
      const int n = gr < rlim ? min(max(clim - gc, 0), 16) : 0;
      cp_async16(smem_addr(dst + row_off(r) + c), n > 0 ? src + (size_t)gr * ld + gc : src, n);
    }
  } else if (vec == 4) {
#pragma unroll
    for (int i = tid; i < ROWS * 16; i += TC_THREADS) {
      const int r = i >> 4, c = (i & 15) * 4, gr = r0 + r, gc = c0 + c;
      const int n = gr < rlim ? min(max(clim - gc, 0), 4) : 0;
      cp_async4(smem_addr(dst + row_off(r) + c), n > 0 ? src + (size_t)gr * ld + gc : src, n);
    }
  } else {
    for (int i = tid; i < ROWS * 16; i += TC_THREADS) {
      const int r = i >> 4, c = (i & 15) * 4, gr = r0 + r, gc = c0 + c;
      uint32_t word = 0;
      if (gr < rlim) {
        const int8_t* p = src + (size_t)gr * ld + gc;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (gc + j < clim) word |= (uint32_t)(uint8_t)p[j] << (8 * j);
        }
      }
      *reinterpret_cast<uint32_t*>(dst + row_off(r) + c) = word;
    }
  }
}

template <int PLANES, bool SIGNED, int BM>
__global__ void __launch_bounds__(TC_THREADS, 3)
mma_tc_horner_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                     int32_t* __restrict__ out, int M, int K, int N, int x_vec, int w_vec) {
  constexpr int MI = BM / 32;  // m16 fragments per warp: a warp owns BM/2 rows x 32 columns
  constexpr int NI = 4;        // n8 fragments per warp: one per byte of the 4x4 transpose
  __shared__ __align__(16) uint8_t xs[TC_STAGES][BM * XS_STRIDE];
  __shared__ __align__(16) uint8_t ws[TC_STAGES][WS_BYTES];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;  // fragment row / column group, thread in group
  const int wm = (warp >> 1) * (BM / 2), wn = (warp & 1) * 32;  // the warp's tile origin
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * TC_BN;
  const int ktiles = (K + TC_BK - 1) / TC_BK;

  auto stage = [&](int buf, int kt) {
    const int k0 = kt * TC_BK;
    stage_tile<BM>(xs[buf], x, K, m0, M, k0, K, x_vec, XRows{});
    stage_tile<TC_BK>(ws[buf], w, N, k0, K, n0, N, w_vec, WRows{});
  };

  int acc[MI][NI][4];
  int cs[NI][4];  // colsum(w) per column, the same in every row of the fragment
#pragma unroll
  for (int j = 0; j < NI; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      cs[j][e] = 0;
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) acc[mi][j][e] = 0;
    }

#pragma unroll
  for (int s = 0; s < TC_STAGES - 1; ++s) {
    if (s < ktiles) stage(s, s);
    cp_async_commit();
  }

  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<TC_STAGES - 2>();  // this thread's copies of tile kt have landed
    __syncthreads();  // everyone's have, and every warp is done with tile kt-1's buffer
    if (kt + TC_STAGES - 1 < ktiles) stage((kt + TC_STAGES - 1) % TC_STAGES, kt + TC_STAGES - 1);
    cp_async_commit();
    const uint8_t* xb = xs[kt % TC_STAGES];
    const uint8_t* wb = ws[kt % TC_STAGES];

    // B fragments, once per K tile: bf[c][hh][j] holds column wn+4g+j at
    // k = 32c + 16hh + 4t .. +3 (the lane's k of n8 fragment j, k32 chunk c)
    uint32_t bf[2][2][NI];
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int k = 32 * c + 16 * hh + 4 * t;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          bf[c][hh][j] = *reinterpret_cast<const uint32_t*>(wb + ws_row(k + j) + wn + 4 * g);
        transpose4x4(bf[c][hh]);
      }
    // A fragments of the offset activations u, once per K tile
    uint32_t xa[MI][2][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int row = wm + 16 * mi + (lane & 7) + 8 * ((lane >> 3) & 1);
        ldmatrix_x4(xa[mi][c], smem_addr(xb + row * XS_STRIDE + 32 * c + 16 * (lane >> 4)));
        if (SIGNED) {
#pragma unroll
          for (int q = 0; q < 4; ++q) xa[mi][c][q] ^= 0x80808080u;  // x + 128 per byte
        }
      }
    if (SIGNED) {  // colsum(w): the all-ones activation times w
      const uint32_t ones[4] = {LOW_BITS, LOW_BITS, LOW_BITS, LOW_BITS};
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int j = 0; j < NI; ++j) mma_u8s8(cs[j], ones, bf[c][0][j], bf[c][1][j]);
    }

    // MSB-first Horner over the planes: h = 2h + plane_b @ w, one tensor-core
    // product per plane and fragment
    int h[MI][NI][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) h[mi][j][e] = 0;
#pragma unroll
    for (int i = 0; i < PLANES; ++i) {
      const int b = 7 - i;
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int j = 0; j < NI; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) h[mi][j][e] += h[mi][j][e];
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          uint32_t plane[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) plane[q] = (xa[mi][c][q] >> b) & LOW_BITS;
#pragma unroll
          for (int j = 0; j < NI; ++j) mma_u8s8(h[mi][j], plane, bf[c][0][j], bf[c][1][j]);
        }
    }
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][j][e] += h[mi][j][e] * (1 << (8 - PLANES));
  }

  // Epilogue: fragment j's C columns 2t, 2t+1 are columns wn+8t+j, wn+8t+4+j,
  // so a thread holds columns n .. n+7 of rows g and g+8 of each m16 fragment
  const int n = n0 + wn + 8 * t;
  const bool vec_out = (N & 3) == 0 && n + 8 <= N;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int m = m0 + wm + 16 * mi + g + 8 * hr;
      if (m >= M) continue;
      int v[8];
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        v[j] = acc[mi][j][2 * hr] - (SIGNED ? 128 * cs[j][0] : 0);
        v[4 + j] = acc[mi][j][2 * hr + 1] - (SIGNED ? 128 * cs[j][1] : 0);
      }
      int32_t* o = out + (size_t)m * N + n;
      if (vec_out) {
        reinterpret_cast<int4*>(o)[0] = make_int4(v[0], v[1], v[2], v[3]);
        reinterpret_cast<int4*>(o)[1] = make_int4(v[4], v[5], v[6], v[7]);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (n + j < N) o[j] = v[j];
      }
    }
}

template <int PLANES, bool SIGNED>
void launch_tc(const int8_t* x, const int8_t* w, int32_t* out, int M, int K, int N, int bm,
               int x_vec, int w_vec, cudaStream_t stream) {
  const dim3 grid((M + bm - 1) / bm, (N + TC_BN - 1) / TC_BN);
  if (bm == 32) {
    mma_tc_horner_kernel<PLANES, SIGNED, 32>
        <<<grid, TC_THREADS, 0, stream>>>(x, w, out, M, K, N, x_vec, w_vec);
  } else {
    mma_tc_horner_kernel<PLANES, SIGNED, 64>
        <<<grid, TC_THREADS, 0, stream>>>(x, w, out, M, K, N, x_vec, w_vec);
  }
}

// A copy width the loader may use: 16 or 4 bytes where the row stride and
// the base pointer are multiples of it, or 1.  (static: nvcc gives the
// anonymous namespace external linkage, and the nine units are linked into
// one library.)
static bool copy_width_ok(int vec, int ld, const void* p) {
  return (vec == 1 || vec == 4 || vec == 16) && ld % vec == 0 &&
         reinterpret_cast<uintptr_t>(p) % vec == 0;
}

// ---------------------------------------------------------------------------
// The scaled kernel: tensor-core planes with the operands swapped, row
// tiles, split K, fused dequant epilogue
// ---------------------------------------------------------------------------

constexpr int SC_TILE_M = 32;   // rows per pass: a row tile, at most 8*NF staged x rows
constexpr int SC_BN = 64;       // output columns per block
constexpr int SC_BK = 128;      // contraction depth of one staged K tile, bytes
constexpr int SC_XS_STRIDE = SC_BK + 16;  // x row pitch in shared memory, bytes
constexpr int SC_WS_BYTES = (SC_BK / 4) * (4 * SC_BN + 32);  // w tile, ws_row layout

struct XRowsScaled {
  __device__ int operator()(int r) const { return r * SC_XS_STRIDE; }
};

// d += a @ b: a 16 x 32 s8 (row), b 32 x 8 u8 (col), int32 accumulate.
__device__ __forceinline__ void mma_s8u8(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.u8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// One block: 64 output columns x the (at most 8*NF) rows of one row tile
// over K tiles [kt0, kt1) of its split (blockIdx.y).  blockIdx.x is
// row tile + row_tiles * column block, so the row tiles of a column block
// run next to each other.  Warp w owns columns 32*(w&1) .. +31 and the
// 64-deep half (w>>1) of every 128-deep K tile.
template <int PLANES, bool SIGNED, int NF>
__global__ void __launch_bounds__(TC_THREADS, 4)
mma_tc_scaled_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                     const float* __restrict__ x_scale, const float* __restrict__ w_scale,
                     float* __restrict__ out, int32_t* __restrict__ work, int M, int K, int N,
                     int splits, int row_tiles, int x_vec, int w_vec) {
  constexpr int XR = 8 * NF;  // staged x rows: one n8 fragment per 8
  // depth of the cp.async ring: 4, or 3 at NF 3-4, where a 4-deep ring
  // would pass the 48 KB of static shared memory
  constexpr int STAGES = NF >= 3 ? 3 : 4;
  static_assert(XR <= SC_TILE_M, "a pass stages at most one row tile");
  static_assert(XR * SC_BN * sizeof(int) <= SC_WS_BYTES, "red fits in ring slot 0");
  static_assert(STAGES * (SC_WS_BYTES + XR * SC_XS_STRIDE) <= 48 * 1024,
                "the ring is static shared memory");
  __shared__ __align__(16) uint8_t ws[STAGES][SC_WS_BYTES];
  __shared__ __align__(16) uint8_t xs[STAGES][XR * SC_XS_STRIDE];
  __shared__ int is_last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // fragment row / column group, thread in group
  const int wn = (warp & 1) * 32, wk = (warp >> 1) * 64;
  const int m0 = (int)(blockIdx.x % row_tiles) * SC_TILE_M;
  const int n0 = (int)(blockIdx.x / row_tiles) * SC_BN;
  const int ktiles = (K + SC_BK - 1) / SC_BK;
  const int kt0 = (int)((long long)blockIdx.y * ktiles / splits);
  const int kt1 = (int)((long long)(blockIdx.y + 1) * ktiles / splits);

  auto stage = [&](int buf, int kt) {
    const int k0 = kt * SC_BK;
    stage_tile<XR>(xs[buf], x, K, m0, M, k0, K, x_vec, XRowsScaled{});
    stage_tile<XR>(xs[buf] + 64, x, K, m0, M, k0 + 64, K, x_vec, XRowsScaled{});
    stage_tile<SC_BK>(ws[buf], w, N, k0, K, n0, N, w_vec, WRows{});
  };

  // acc[q][f]: the C fragment of n8 fragment q (x rows 8q..8q+7 of the
  // tile) and m16 fragment f (columns wn+4g+2f, wn+4g+2f+1 in its rows g,
  // g+8)
  int acc[NF][2][4];
  int cs[2][4];  // colsum(w) of the same columns, equal in every C column
#pragma unroll
  for (int f = 0; f < 2; ++f)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      cs[f][e] = 0;
#pragma unroll
      for (int q = 0; q < NF; ++q) acc[q][f][e] = 0;
    }

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (kt0 + s < kt1) stage(s, kt0 + s);
    cp_async_commit();
  }

  for (int kt = kt0; kt < kt1; ++kt) {
    const int it = kt - kt0;
    cp_async_wait<STAGES - 2>();  // this thread's copies of tile kt have landed
    __syncthreads();  // everyone's have, and every warp is done with tile kt-1's buffer
    if (kt + STAGES - 1 < kt1) stage((it + STAGES - 1) % STAGES, kt + STAGES - 1);
    cp_async_commit();
    const uint8_t* xb = xs[it % STAGES];
    const uint8_t* wb = ws[it % STAGES];

    // A fragments (w^T), once per K tile: wt[c][hh][j] holds column
    // wn+4g+j at k = wk + 32c + 16hh + 4t .. +3.  m16 fragment f takes
    // column 4g+2f as its row g and 4g+2f+1 as its row g+8.
    uint32_t wt[2][2][4];
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int k = wk + 32 * c + 16 * hh + 4 * t;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wt[c][hh][j] = *reinterpret_cast<const uint32_t*>(wb + ws_row(k + j) + wn + 4 * g);
        transpose4x4(wt[c][hh]);
      }
    // B words of the offset activations u: x row 8q+g at the same k
    uint32_t xw[NF][2][2];
#pragma unroll
    for (int q = 0; q < NF; ++q)
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          xw[q][c][hh] = *reinterpret_cast<const uint32_t*>(
              xb + (8 * q + g) * SC_XS_STRIDE + wk + 32 * c + 16 * hh + 4 * t);
          if (SIGNED) xw[q][c][hh] ^= 0x80808080u;  // x + 128 per byte
        }
    if (SIGNED) {  // colsum(w): w^T times the all-ones activation
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int f = 0; f < 2; ++f)
          mma_s8u8(cs[f], wt[c][0][2 * f], wt[c][0][2 * f + 1], wt[c][1][2 * f],
                   wt[c][1][2 * f + 1], LOW_BITS, LOW_BITS);
    }

    // MSB-first Horner over the planes: h = 2h + w^T @ plane_b
    int h[NF][2][4];
#pragma unroll
    for (int q = 0; q < NF; ++q)
#pragma unroll
      for (int f = 0; f < 2; ++f)
#pragma unroll
        for (int e = 0; e < 4; ++e) h[q][f][e] = 0;
#pragma unroll
    for (int i = 0; i < PLANES; ++i) {
      const int b = 7 - i;
#pragma unroll
      for (int q = 0; q < NF; ++q)
#pragma unroll
        for (int f = 0; f < 2; ++f)
#pragma unroll
          for (int e = 0; e < 4; ++e) h[q][f][e] += h[q][f][e];
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int q = 0; q < NF; ++q) {
          const uint32_t b0 = (xw[q][c][0] >> b) & LOW_BITS, b1 = (xw[q][c][1] >> b) & LOW_BITS;
#pragma unroll
          for (int f = 0; f < 2; ++f)
            mma_s8u8(h[q][f], wt[c][0][2 * f], wt[c][0][2 * f + 1], wt[c][1][2 * f],
                     wt[c][1][2 * f + 1], b0, b1);
        }
    }
#pragma unroll
    for (int q = 0; q < NF; ++q)
#pragma unroll
      for (int f = 0; f < 2; ++f)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[q][f][e] += h[q][f][e] * (1 << (8 - PLANES));
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: red reuses it

  // The two k halves meet in red[row][column] (XR x 64 int32): C element
  // e = 2*hi + r of fragment (q, f) is tile row 8q+2t+r, column wn+4g+2f+hi.
  int* red = reinterpret_cast<int*>(ws[0]);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if ((warp >> 1) == half) {
#pragma unroll
      for (int q = 0; q < NF; ++q)
#pragma unroll
        for (int f = 0; f < 2; ++f)
#pragma unroll
          for (int hi = 0; hi < 2; ++hi)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int v = acc[q][f][2 * hi + r] - (SIGNED ? 128 * cs[f][2 * hi] : 0);
              int& dst = red[(8 * q + 2 * t + r) * SC_BN + wn + 4 * g + 2 * f + hi];
              dst = half ? dst + v : v;
            }
    }
    __syncthreads();
  }

  // Epilogue: thread tid owns columns n .. n+3 of tile rows tid/16 + 8*q
  const int cn = 4 * (tid & 15), n = n0 + cn, r0 = m0 + (tid >> 4);
  int v[NF][4];
#pragma unroll
  for (int q = 0; q < NF; ++q)
#pragma unroll
    for (int j = 0; j < 4; ++j) v[q][j] = red[((tid >> 4) + 8 * q) * SC_BN + cn + j];
  if (splits > 1) {
    // add this split's partial to the workspace; the last split to arrive
    // for the (row tile, column block) reads the full sum and runs the
    // epilogue
    int32_t* sum = work;
    int32_t* count = work + (size_t)M * N;
#pragma unroll
    for (int q = 0; q < NF; ++q) {
      const int m = r0 + 8 * q;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (n + j < N) atomicAdd(sum + (size_t)m * N + n + j, v[q][j]);
    }
    __threadfence();  // the partial is visible device-wide before the arrival
    __syncthreads();
    if (tid == 0) is_last = atomicAdd(count + blockIdx.x, 1) == splits - 1;
    __syncthreads();
    if (!is_last) return;
    __threadfence();
#pragma unroll
    for (int q = 0; q < NF; ++q) {
      const int m = r0 + 8 * q;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (n + j < N) v[q][j] = __ldcg(sum + (size_t)m * N + n + j);
    }
  }
  const float xsv = *x_scale;
  float wsv[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wsv[j] = n + j < N ? w_scale[n + j] : 0.f;
  const bool vec_out = (N & 3) == 0 && n + 4 <= N;
#pragma unroll
  for (int q = 0; q < NF; ++q) {
    const int m = r0 + 8 * q;
    if (m >= M) continue;
    // fused dequant epilogue: (acc * x_scale) * w_scale[n], each product
    // rounded to nearest, no contraction into an FMA
    float o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) o[j] = __fmul_rn(__fmul_rn(__int2float_rn(v[q][j]), xsv), wsv[j]);
    float* dst = out + (size_t)m * N + n;
    if (vec_out) {
      *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (n + j < N) dst[j] = o[j];
    }
  }
}

template <int PLANES, bool SIGNED, int NF>
void launch_scaled_nf(const int8_t* x, const int8_t* w, const float* xs, const float* ws,
                   float* out, int32_t* work, int M, int K, int N, int splits, int x_vec,
                   int w_vec, cudaStream_t stream) {
  const int row_tiles = (M - 1) / SC_TILE_M + 1, col_blocks = (N - 1) / SC_BN + 1;
  mma_tc_scaled_kernel<PLANES, SIGNED, NF>
      <<<dim3(row_tiles * col_blocks, splits), TC_THREADS, 0, stream>>>(
          x, w, xs, ws, out, work, M, K, N, splits, row_tiles, x_vec, w_vec);
}

// NF: the fewest n8 fragments that hold M rows, 4 (and row tiles) above 24.
template <int PLANES, bool SIGNED>
void launch_scaled(const int8_t* x, const int8_t* w, const float* xs, const float* ws,
                   float* out, int32_t* work, int M, int K, int N, int splits, int x_vec,
                   int w_vec, cudaStream_t stream) {
  if (M <= 8) {
    launch_scaled_nf<PLANES, SIGNED, 1>(x, w, xs, ws, out, work, M, K, N, splits, x_vec, w_vec,
                                     stream);
  } else if (M <= 16) {
    launch_scaled_nf<PLANES, SIGNED, 2>(x, w, xs, ws, out, work, M, K, N, splits, x_vec, w_vec,
                                     stream);
  } else if (M <= 24) {
    launch_scaled_nf<PLANES, SIGNED, 3>(x, w, xs, ws, out, work, M, K, N, splits, x_vec, w_vec,
                                     stream);
  } else {
    launch_scaled_nf<PLANES, SIGNED, 4>(x, w, xs, ws, out, work, M, K, N, splits, x_vec, w_vec,
                                     stream);
  }
}

}  // namespace

// The build compiles this file as nine translation units at once
// (kernels/mma_matmul.py::build): with -DMMA_PLANES=P, the kernels of one
// plane count and their launchers (mma_tc_launch_pP, mma_scaled_launch_pP);
// without it, the plain C interface below, which checks its arguments and
// calls the plane count's launcher.
#define MMA_FOR_EACH_PLANES(X) X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8)

#define MMA_DECLARE(P)                                                                      \
  extern "C" void mma_tc_launch_p##P(const int8_t* x, const int8_t* w, int32_t* out, int M,   \
                                     int K, int N, int is_signed, int bm, int x_vec,          \
                                     int w_vec, cudaStream_t s);                              \
  extern "C" void mma_scaled_launch_p##P(const int8_t* x, const int8_t* w, const float* xs,   \
                                         const float* ws, float* out, int32_t* work, int M,   \
                                         int K, int N, int is_signed, int splits, int x_vec,  \
                                         int w_vec, cudaStream_t s);
MMA_FOR_EACH_PLANES(MMA_DECLARE)
#undef MMA_DECLARE

#ifdef MMA_PLANES

#define MMA_PLANE_UNIT(P)                                                                   \
  extern "C" void mma_tc_launch_p##P(const int8_t* x, const int8_t* w, int32_t* out, int M,   \
                                     int K, int N, int is_signed, int bm, int x_vec,          \
                                     int w_vec, cudaStream_t s) {                             \
    if (is_signed) launch_tc<P, true>(x, w, out, M, K, N, bm, x_vec, w_vec, s);               \
    else launch_tc<P, false>(x, w, out, M, K, N, bm, x_vec, w_vec, s);                        \
  }                                                                                         \
  extern "C" void mma_scaled_launch_p##P(const int8_t* x, const int8_t* w, const float* xs,   \
                                         const float* ws, float* out, int32_t* work, int M,   \
                                         int K, int N, int is_signed, int splits, int x_vec,  \
                                         int w_vec, cudaStream_t s) {                         \
    if (is_signed)                                                                          \
      launch_scaled<P, true>(x, w, xs, ws, out, work, M, K, N, splits, x_vec, w_vec, s);      \
    else                                                                                    \
      launch_scaled<P, false>(x, w, xs, ws, out, work, M, K, N, splits, x_vec, w_vec, s);     \
  }
#define MMA_PLANE_UNIT_OF(P) MMA_PLANE_UNIT(P)  // expands MMA_PLANES before ## pastes it
MMA_PLANE_UNIT_OF(MMA_PLANES)
#undef MMA_PLANE_UNIT_OF
#undef MMA_PLANE_UNIT

#else  // the C interface

// Plain C interface, loaded with ctypes.  Each returns cudaGetLastError()
// after the launch (0 on success); a refused launch is reported here, not at
// the next synchronize.

// bm: block rows, 32 or 64.  x_vec, w_vec: copy widths of the x and w tiles
// (16, 4 or 1 bytes), each dividing its row stride (K, N) and base pointer.
extern "C" int mma_matmul_launch(const void* x, const void* w, void* out, int M, int K, int N,
                                 int planes, int is_signed, int bm, int x_vec, int w_vec,
                                 void* stream) {
  if (M <= 0 || N <= 0 || K < 0 || (N + TC_BN - 1) / TC_BN > 65535 || (bm != 32 && bm != 64) ||
      !copy_width_ok(x_vec, K, x) || !copy_width_ok(w_vec, N, w)) {
    return (int)cudaErrorInvalidValue;
  }
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* wp = static_cast<const int8_t*>(w);
  auto* op = static_cast<int32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MMA_CASE(P)                                                              \
  case P:                                                                        \
    mma_tc_launch_p##P(xp, wp, op, M, K, N, is_signed, bm, x_vec, w_vec, s);     \
    break;
  switch (planes) {
    MMA_FOR_EACH_PLANES(MMA_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef MMA_CASE
  return (int)cudaGetLastError();
}

// x_scale: one float32 on the device; w_scale: N float32 on the device.
// splits: the K splits (1 up to the number of 128-deep K tiles); work,
// M*N + ceil(M/32)*ceil(N/64) zeroed int32 on the device when splits > 1
// (the split sums, then one arrival counter per row tile and column
// block), else unused; x_vec, w_vec as for mma_matmul_launch.
extern "C" int mma_matmul_scaled_launch(const void* x, const void* w,
                                        const void* x_scale, const void* w_scale,
                                        void* out, void* work, int M, int K, int N, int planes,
                                        int is_signed, int splits, int x_vec, int w_vec,
                                        void* stream) {
  if (M <= 0 || N <= 0 || K < 0) return (int)cudaErrorInvalidValue;
  const int ktiles = (K + SC_BK - 1) / SC_BK;
  const long long blocks = (long long)((M - 1) / SC_TILE_M + 1) * ((N - 1) / SC_BN + 1);
  if (splits < 1 || splits > (ktiles > 1 ? ktiles : 1) || splits > 65535 ||
      blocks > 0x7fffffffLL || (splits > 1 && work == nullptr) ||
      !copy_width_ok(x_vec, K, x) || !copy_width_ok(w_vec, N, w)) {
    return (int)cudaErrorInvalidValue;
  }
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* wp = static_cast<const int8_t*>(w);
  const auto* xsp = static_cast<const float*>(x_scale);
  const auto* wsp = static_cast<const float*>(w_scale);
  auto* op = static_cast<float*>(out);
  auto* wk = static_cast<int32_t*>(work);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MMA_CASE(P)                                                                      \
  case P:                                                                                \
    mma_scaled_launch_p##P(xp, wp, xsp, wsp, op, wk, M, K, N, is_signed, splits, x_vec,  \
                           w_vec, s);                                                    \
    break;
  switch (planes) {
    MMA_FOR_EACH_PLANES(MMA_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef MMA_CASE
  return (int)cudaGetLastError();
}

extern "C" const char* mma_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

#endif  // MMA_PLANES
