// Merged multiply-add (MMA) as a bit-plane Horner matmul, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/mma_matmul.py::_mma_kernel in both
// its forms: unscaled (scaled=False, launched by _mma_matmul_impl), the
// kernel the U-Net's 3x3 convolutions run through, and scaled (scaled=True,
// launched by _mma_matmul_scaled_impl), the fused-dequant form every int8
// linear of LM serving runs through.
//
// What it computes, bit for bit: (M,K) int8 @ (K,N) int8 -> (M,N) int32.
//   u   = x + 128 (signed) or the byte of x read as uint8 (unsigned)
//   per K tile:  h = 0;  for b = 7 .. 8-PLANES:  h = 2*h + ((u >> b) & 1) @ w
//                acc += h * 2^(8-PLANES)
//   acc -= 128 * colsum(w)   (signed only)
//   out = acc                                       (unscaled, int32)
//   out = (float(acc) * x_scale) * w_scale[n]       (scaled, float32)
// All arithmetic before the epilogue is int32, so the integer result is
// exact for any K (the TPU kernel runs the plane products in bf16 with f32
// partials and is exact only for K <= 512 per block).  The scaled epilogue
// rounds to nearest at each of its two products and contracts no FMA, in
// the reference's order; x_scale is read from device memory, so a caller
// never synchronizes to hand it over.
//
// What bounds it on this card.  The function itself moves M*K + K*N bytes
// in (plus 4*N of scales) and 4*M*N out and does 2*M*K*N int8 operations;
// at the shapes the port serves the bytes term is the larger, so the
// card's bound is its memory rate.  This kernel is far above that bound: it
// runs the digit-serial recurrence on the CUDA cores, one int32
// multiply-add per (row, column, k, plane), so it is bound by the SM's
// int32 issue rate, PLANES times the work of a bit-parallel product.
//
// What the design does about it.  It keeps the "merged" property of the
// reference: a block owns one BM x 64 output tile, x and w are read from
// global memory once per tile into shared memory, and the Horner residual
// h and the accumulator never leave registers.  PLANES and SIGNED are
// template parameters, so a 4-plane layer issues half the multiply-adds of
// an 8-plane one.  TM (output rows per thread) sets the tile height
// BM = 16*TM: 64 rows for wide M (convolutions, prefill), 16 rows when M is
// at most 16 (batched decode), where a 64-row tile would spend 15/16 of its
// work on masked rows.  Ragged edges are masked in the kernel: rows of w
// past K read as 0, so neither the product nor the colsum correction sees
// them.  Tensor-core plane products (mma.sync / wgmma on the 0/1 planes),
// TMA and a pipelined shared-memory ring are left to later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 64;   // output columns per block
constexpr int BK = 16;   // contraction depth staged in shared memory
constexpr int KH = 8;    // contraction depth of one register Horner pass
constexpr int TN = 4;    // output columns per thread
constexpr int ROW_GROUPS = 16;                    // threads along M
constexpr int THREADS = ROW_GROUPS * (BN / TN);   // 256
constexpr int SMALL_M = 16;  // at most this many rows: the 16-row tile

static_assert(THREADS == BK * (BN / 4), "w loader: one int4 per thread");
static_assert(BK % KH == 0, "Horner passes tile the stage");

template <int PLANES, bool SIGNED, bool SCALED, int TM>
__global__ void __launch_bounds__(THREADS, 2)
mma_horner_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                  const float* __restrict__ x_scale,
                  const float* __restrict__ w_scale,
                  void* __restrict__ out, int M, int K, int N) {
  constexpr int BM = ROW_GROUPS * TM;  // output rows per block
  static_assert(TM == 1 || TM % 4 == 0, "a thread's rows lie in whole words or one byte");
  static_assert(BK * (BM / 4) <= THREADS, "x loader: at most one word per thread");
  // xs[k][q]: offset activations u of rows 4q..4q+3 at depth k, one byte each
  __shared__ uint32_t xs[BK][BM / 4];
  // ws[k][q]: sign-extended weights of columns 4q..4q+3 at depth k (0 past K)
  __shared__ int4 ws[BK][BN / 4];

  const int tid = threadIdx.x;
  const int tr = tid / (BN / TN);  // this thread's rows: m0 + TM*tr .. +TM-1
  const int tc = tid % (BN / TN);  // this thread's columns: n0 + 4*tc .. +3
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int xword = (TM * tr) / 4;  // the first word of xs holding this thread's rows
  // bit offset of this thread's row in its word: rows of a 16-row tile share
  // words; a taller tile gives each thread whole words (offset 0)
  const int xshift = TM == 1 ? 8 * (tr % 4) : 0;

  int acc[TM][TN];
  int colsum[TN];
#pragma unroll
  for (int c = 0; c < TN; ++c) {
    colsum[c] = 0;
#pragma unroll
    for (int r = 0; r < TM; ++r) acc[r][c] = 0;
  }

  for (int k0 = 0; k0 < K; k0 += BK) {
    if (tid < BK * (BM / 4)) {  // stage x: rows 4q..4q+3 at depth k, packed u bytes
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
      uint32_t xr[KH][(TM + 3) / 4];
      int wr[KH][TN];
#pragma unroll
      for (int k = 0; k < KH; ++k) {
#pragma unroll
        for (int j = 0; j < (TM + 3) / 4; ++j) xr[k][j] = xs[kh + k][xword + j];
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
            const int bit = (int)((xr[k][r / 4] >> (xshift + 8 * (r % 4) + b)) & 1u);
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

  const float xsv = SCALED ? *x_scale : 0.0f;
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int gm = m0 + TM * tr + r;
    if (gm >= M) continue;
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int gn = n0 + TN * tc + c;
      if (gn >= N) continue;
      const int v = acc[r][c] - (SIGNED ? 128 * colsum[c] : 0);
      const size_t o = (size_t)gm * N + gn;
      if (SCALED) {
        // fused dequant epilogue: (acc * x_scale) * w_scale[n], each product
        // rounded to nearest, no contraction into an FMA
        static_cast<float*>(out)[o] = __fmul_rn(__fmul_rn(__int2float_rn(v), xsv), w_scale[gn]);
      } else {
        static_cast<int32_t*>(out)[o] = v;
      }
    }
  }
}

template <int PLANES, bool SIGNED, bool SCALED>
void launch(const void* x, const void* w, const void* xs, const void* ws, void* out,
            int M, int K, int N, cudaStream_t stream) {
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* wp = static_cast<const int8_t*>(w);
  const auto* xsp = static_cast<const float*>(xs);
  const auto* wsp = static_cast<const float*>(ws);
  const int gy = (N + BN - 1) / BN;
  if (M <= SMALL_M) {
    mma_horner_kernel<PLANES, SIGNED, SCALED, 1><<<dim3(1, gy), THREADS, 0, stream>>>(
        xp, wp, xsp, wsp, out, M, K, N);
  } else {
    constexpr int BM = ROW_GROUPS * 4;
    mma_horner_kernel<PLANES, SIGNED, SCALED, 4>
        <<<dim3((M + BM - 1) / BM, gy), THREADS, 0, stream>>>(xp, wp, xsp, wsp, out, M, K, N);
  }
}

template <bool SCALED>
int dispatch(const void* x, const void* w, const void* xs, const void* ws, void* out,
             int M, int K, int N, int planes, int is_signed, void* stream) {
  if (M <= 0 || N <= 0 || K < 0 || (N + BN - 1) / BN > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MMA_CASE(P)                                                          \
  case P:                                                                    \
    if (is_signed) launch<P, true, SCALED>(x, w, xs, ws, out, M, K, N, s);   \
    else launch<P, false, SCALED>(x, w, xs, ws, out, M, K, N, s);            \
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

}  // namespace

// Plain C interface, loaded with ctypes.  Each returns cudaGetLastError()
// after the launch (0 on success); a refused launch is reported here, not at
// the next synchronize.
extern "C" int mma_matmul_launch(const void* x, const void* w, void* out,
                                 int M, int K, int N, int planes, int is_signed,
                                 void* stream) {
  return dispatch<false>(x, w, nullptr, nullptr, out, M, K, N, planes, is_signed, stream);
}

// x_scale: one float32 on the device; w_scale: N float32 on the device.
extern "C" int mma_matmul_scaled_launch(const void* x, const void* w,
                                        const void* x_scale, const void* w_scale,
                                        void* out, int M, int K, int N, int planes,
                                        int is_signed, void* stream) {
  return dispatch<true>(x, w, x_scale, w_scale, out, M, K, N, planes, is_signed, stream);
}

extern "C" const char* mma_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
