// Merged multiply-add (MMA) as a bit-plane Horner matmul, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/mma_matmul.py::_mma_kernel in its
// unscaled form (scaled=False, launched by _mma_matmul_impl), the kernel the
// U-Net's 3x3 convolutions run through.
//
// What it computes, bit for bit: (M,K) int8 @ (K,N) int8 -> (M,N) int32.
//   u   = x + 128 (signed) or the byte of x read as uint8 (unsigned)
//   per K tile:  h = 0;  for b = 7 .. 8-PLANES:  h = 2*h + ((u >> b) & 1) @ w
//                acc += h * 2^(8-PLANES)
//   out = acc - 128 * colsum(w)   (signed only)
// All arithmetic is int32, so the result is exact for any K (the TPU kernel
// runs the plane products in bf16 with f32 partials and is exact only for
// K <= 512 per block).
//
// What bounds it on this card.  The function itself moves M*K + K*N bytes
// in and 4*M*N out and does 2*M*K*N int8 operations; at the main path's
// shapes the bytes term is the larger, so the card's bound is its memory
// rate.  This kernel is far above that bound: it runs the digit-serial
// recurrence on the CUDA cores, one int32 multiply-add per (row, column,
// k, plane), so it is bound by the SM's int32 issue rate, PLANES times the
// work of a bit-parallel product.
//
// What the design does about it.  It keeps the "merged" property of the
// reference: a block owns one 64x64 output tile, x and w are read from
// global memory once per tile into shared memory, and the Horner residual
// h and the accumulator never leave registers.  PLANES and SIGNED are
// template parameters, so a 4-plane layer issues half the multiply-adds of
// an 8-plane one.  Ragged edges are masked in the kernel: rows of w past K
// read as 0, so neither the product nor the colsum correction sees them.
// Tensor-core plane products (mma.sync / wgmma on the 0/1 planes), TMA and
// a pipelined shared-memory ring are left to later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;   // output rows per block
constexpr int BN = 64;   // output columns per block
constexpr int BK = 16;   // contraction depth staged in shared memory
constexpr int KH = 8;    // contraction depth of one register Horner pass
constexpr int TM = 4;    // output rows per thread
constexpr int TN = 4;    // output columns per thread
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256

static_assert(THREADS == BK * (BM / 4), "x loader: one word per thread");
static_assert(THREADS == BK * (BN / 4), "w loader: one int4 per thread");
static_assert(BK % KH == 0, "Horner passes tile the stage");

template <int PLANES, bool SIGNED>
__global__ void __launch_bounds__(THREADS, 2)
mma_horner_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                  int32_t* __restrict__ out, int M, int K, int N) {
  // xs[k][q]: offset activations u of rows 4q..4q+3 at depth k, one byte each
  __shared__ uint32_t xs[BK][BM / 4];
  // ws[k][q]: sign-extended weights of columns 4q..4q+3 at depth k (0 past K)
  __shared__ int4 ws[BK][BN / 4];

  const int tid = threadIdx.x;
  const int tr = tid / (BN / TN);  // this thread's rows: m0 + 4*tr .. +3
  const int tc = tid % (BN / TN);  // this thread's columns: n0 + 4*tc .. +3
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  int acc[TM][TN];
  int colsum[TN];
#pragma unroll
  for (int c = 0; c < TN; ++c) {
    colsum[c] = 0;
#pragma unroll
    for (int r = 0; r < TM; ++r) acc[r][c] = 0;
  }

  for (int k0 = 0; k0 < K; k0 += BK) {
    {  // stage x: thread loads rows 4q..4q+3 at depth k and packs their u bytes
      const int k = tid % BK;
      const int q = tid / BK;
      const int gk = k0 + k;
      uint32_t word = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int gm = m0 + 4 * q + j;
        uint32_t u = 0;
        if (gm < M && gk < K) {
          const int8_t v = x[(size_t)gm * K + gk];
          u = SIGNED ? (uint32_t)((int)v + 128) : (uint32_t)(uint8_t)v;
        }
        word |= u << (8 * j);
      }
      xs[k][q] = word;
    }
    {  // stage w: thread loads columns 4q..4q+3 at depth k
      const int k = tid / (BN / 4);
      const int q = tid % (BN / 4);
      const int gk = k0 + k;
      int v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int gn = n0 + 4 * q + j;
        v[j] = (gk < K && gn < N) ? (int)w[(size_t)gk * N + gn] : 0;
      }
      ws[k][q] = make_int4(v[0], v[1], v[2], v[3]);
    }
    __syncthreads();

#pragma unroll
    for (int kh = 0; kh < BK; kh += KH) {
      uint32_t xr[KH];
      int wr[KH][TN];
#pragma unroll
      for (int k = 0; k < KH; ++k) {
        xr[k] = xs[kh + k][tr];
        const int4 q = ws[kh + k][tc];
        wr[k][0] = q.x;
        wr[k][1] = q.y;
        wr[k][2] = q.z;
        wr[k][3] = q.w;
        if (SIGNED) {
#pragma unroll
          for (int c = 0; c < TN; ++c) colsum[c] += wr[k][c];
        }
      }
      // MSB-first Horner over the planes: the left-shifted residual h
      int h[TM][TN];
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int c = 0; c < TN; ++c) h[r][c] = 0;
#pragma unroll
      for (int i = 0; i < PLANES; ++i) {
        const int b = 7 - i;
#pragma unroll
        for (int r = 0; r < TM; ++r)
#pragma unroll
          for (int c = 0; c < TN; ++c) h[r][c] *= 2;
#pragma unroll
        for (int k = 0; k < KH; ++k) {
#pragma unroll
          for (int r = 0; r < TM; ++r) {
            const int bit = (int)((xr[k] >> (8 * r + b)) & 1u);
#pragma unroll
            for (int c = 0; c < TN; ++c) h[r][c] += bit * wr[k][c];
          }
        }
      }
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int c = 0; c < TN; ++c) acc[r][c] += h[r][c] * (1 << (8 - PLANES));
    }
    __syncthreads();  // the next stage overwrites xs and ws
  }

#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int gm = m0 + TM * tr + r;
    if (gm >= M) continue;
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int gn = n0 + TN * tc + c;
      if (gn < N) out[(size_t)gm * N + gn] = acc[r][c] - (SIGNED ? 128 * colsum[c] : 0);
    }
  }
}

template <int PLANES, bool SIGNED>
void launch(const void* x, const void* w, void* out, int M, int K, int N,
            cudaStream_t stream) {
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  mma_horner_kernel<PLANES, SIGNED><<<grid, THREADS, 0, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<int32_t*>(out), M, K, N);
}

}  // namespace

// Plain C interface, loaded with ctypes.  Returns cudaGetLastError() after
// the launch (0 on success); a refused launch is reported here, not at the
// next synchronize.
extern "C" int mma_matmul_launch(const void* x, const void* w, void* out,
                                 int M, int K, int N, int planes, int is_signed,
                                 void* stream) {
  if (M <= 0 || N <= 0 || K < 0 || (N + BN - 1) / BN > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MMA_CASE(P)                                                  \
  case P:                                                            \
    if (is_signed) launch<P, true>(x, w, out, M, K, N, s);           \
    else launch<P, false>(x, w, out, M, K, N, s);                    \
    break;
  switch (planes) {
    MMA_CASE(1)
    MMA_CASE(2)
    MMA_CASE(3)
    MMA_CASE(4)
    MMA_CASE(5)
    MMA_CASE(6)
    MMA_CASE(7)
    MMA_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef MMA_CASE
  return (int)cudaGetLastError();
}

extern "C" const char* mma_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
