// W8A8 matrix product (the 1x1 convolution) for Hopper (sm_90a), plain C
// interface for ctypes.
//
// Replaces bmcnet_esr_tpu/ops/pallas/qmm.py::_qmm_kernel (the body of
// quant_matmul), and the int8 1x1 lax.conv that
// bmcnet_esr_tpu/models/layers.py::QuantConv._convolve runs for a 1x1 conv
// on the dynamic-scale path:
//
//   acc[b, m, n] = sum_k q(x)[b, m, k] * wq[k, n]          (int32)
//   y[b, m, n]   = acc * (sx[b] * sw[n]) + bias[n]          (float32 -> bf16 / f32)
//
// x is bf16 / float32 and quantized here at the per-lane scale sx[b] (the
// fused Pallas kernel), or int8 already quantized at sx[b].  As in qconv.cu
// every rounding step is written out (__fdiv_rn, __float2int_rn, __fmul_rn,
// __fadd_rn, __float2bfloat16_rn), so the result is bit-equal to the plain
// PyTorch version.
//
// Design.  The TPU grid walks (lane, 576-row tile) with K and N whole.  Here
// rows of all lanes form one M = B*M axis: a block computes 32 rows by 128
// columns, its four warps 32 x 32 each with mma.sync.m16n8k32 s8 -> s32,
// staging a 32 x 32 activation tile and a 128 x 32 weight tile in shared
// memory per K step.  Weights come packed as [N, K_pad] (K contiguous, zeros
// past K, K_pad a multiple of 32).  A row depends on its own lane only, so a
// batch equals its solo launches bit for bit.
//
// Bound.  At the main path's shapes (M = 3600, K = 128 or 256, N = 128) the
// int8 work is 0.1-0.2 GOP per lane and the bytes are the bf16 input and
// output (about 1-2.8 MB): bytes bound it, at about 0.3-0.6 us per lane on
// an H100.  Launch latency and the unpipelined loads dominate this first
// kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 32;         // rows per block
constexpr int BN = 128;        // output channels per block
constexpr int BK = 32;         // K per step: one mma k
constexpr int kThreads = 128;  // four warps side by side along N
constexpr int LDS = BK + 16;   // shared row stride in bytes: fragment reads hit 32 banks

__device__ __forceinline__ int quantize(float v, float s) {
  int q = __float2int_rn(__fdiv_rn(v, s));
  return min(max(q, -127), 127);
}

__device__ __forceinline__ uint32_t load_q(const int8_t* p, long long i, float) {
  return (uint8_t)p[i];
}
__device__ __forceinline__ uint32_t load_q(const __nv_bfloat16* p, long long i, float s) {
  return (uint8_t)(int8_t)quantize(__bfloat162float(p[i]), s);
}
__device__ __forceinline__ uint32_t load_q(const float* p, long long i, float s) {
  return (uint8_t)(int8_t)quantize(p[i], s);
}

__device__ __forceinline__ void store(__nv_bfloat16* o, long long i, float y) {
  o[i] = __float2bfloat16_rn(y);
}
__device__ __forceinline__ void store(float* o, long long i, float y) { o[i] = y; }

__device__ __forceinline__ void mma_s8(int* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(kThreads)
    qmm_kernel(const TIn* __restrict__ x, const int8_t* __restrict__ wp,
               const float* __restrict__ sw, const float* __restrict__ sx,
               const float* __restrict__ bias, TOut* __restrict__ out, int lanes, int m,
               int k, int k_pad, int n) {
  __shared__ __align__(16) int8_t as[BM * LDS];
  __shared__ __align__(16) int8_t bs[BN * LDS];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;  // mma fragment row group, thread in group
  const long long m_total = (long long)lanes * m;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // this thread stages row m0 + ar, columns ac .. ac + 7 of x ...
  const int ar = tid >> 2, ac = (tid & 3) * 8;
  const long long am = m0 + ar;
  const bool a_valid = am < m_total;
  const float a_scale = sx[a_valid ? (int)(am / m) : 0];
  const long long src = a_valid ? am * k : 0;
  // ... and weights of output channel n0 + tid, 32 bytes of K
  const int bn = n0 + tid;

  int acc[2][4][4] = {};  // [m16 tile][n8 tile][fragment]

  for (int k0 = 0; k0 < k; k0 += BK) {
    uint32_t lo = 0, hi = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = k0 + ac + j;
      const uint32_t v = (a_valid && c < k) ? load_q(x, src + c, a_scale) : 0u;
      if (j < 4) lo |= v << (8 * j); else hi |= v << (8 * (j - 4));
    }
    *reinterpret_cast<uint2*>(as + ar * LDS + ac) = make_uint2(lo, hi);
    uint4 w0 = make_uint4(0, 0, 0, 0), w1 = w0;
    if (bn < n) {
      const int8_t* wrow = wp + (long long)bn * k_pad + k0;
      w0 = *reinterpret_cast<const uint4*>(wrow);
      w1 = *reinterpret_cast<const uint4*>(wrow + 16);
    }
    *reinterpret_cast<uint4*>(bs + tid * LDS) = w0;
    *reinterpret_cast<uint4*>(bs + tid * LDS + 16) = w1;
    __syncthreads();

    uint32_t af[2][4], bf[4][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int8_t* r0 = as + (i * 16 + g) * LDS + t4 * 4;
      const int8_t* r8 = r0 + 8 * LDS;
      af[i][0] = *reinterpret_cast<const uint32_t*>(r0);
      af[i][1] = *reinterpret_cast<const uint32_t*>(r8);
      af[i][2] = *reinterpret_cast<const uint32_t*>(r0 + 16);
      af[i][3] = *reinterpret_cast<const uint32_t*>(r8 + 16);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int8_t* col = bs + (warp * 32 + j * 8 + g) * LDS + t4 * 4;
      bf[j][0] = *reinterpret_cast<const uint32_t*>(col);
      bf[j][1] = *reinterpret_cast<const uint32_t*>(col + 16);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const long long row = m0 + i * 16 + g + (r >> 1) * 8;
        const int col = n0 + warp * 32 + j * 8 + t4 * 2 + (r & 1);
        if (row < m_total && col < n) {
          const int b = (int)(row / m);
          const float y = __fadd_rn(
              __fmul_rn(__int2float_rn(acc[i][j][r]), __fmul_rn(sx[b], sw[col])), bias[col]);
          store(out, row * n + col, y);
        }
      }
}

template <typename TIn, typename TOut>
int launch(const void* x, const int8_t* wp, const float* sw, const float* sx, const float* bias,
           void* out, int lanes, int m, int k, int k_pad, int n, cudaStream_t stream) {
  const long long m_total = (long long)lanes * m;
  if (m_total == 0 || n == 0) return (int)cudaGetLastError();
  const long long blocks = (m_total + BM - 1) / BM;
  if (blocks > 0x7fffffffLL || k_pad % BK != 0 || k > k_pad) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)blocks, (n + BN - 1) / BN);
  qmm_kernel<TIn, TOut><<<grid, kThreads, 0, stream>>>((const TIn*)x, wp, sw, sx, bias,
                                                       (TOut*)out, lanes, m, k, k_pad, n);
  return (int)cudaGetLastError();
}

template <typename TIn>
int launch_out(int out_kind, const void* x, const int8_t* wp, const float* sw, const float* sx,
               const float* bias, void* out, int lanes, int m, int k, int k_pad, int n,
               cudaStream_t stream) {
  switch (out_kind) {
    case 0: return launch<TIn, __nv_bfloat16>(x, wp, sw, sx, bias, out, lanes, m, k, k_pad, n,
                                              stream);
    case 1: return launch<TIn, float>(x, wp, sw, sx, bias, out, lanes, m, k, k_pad, n, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// in_kind: 0 int8 x (already quantized at sx), 1 bf16 x, 2 float32 x.
// out_kind: 0 bf16 y, 1 float32 y.
// x [lanes, m, k]; wp int8 [n, k_pad]; sw, bias [n]; sx [lanes];
// out [lanes, m, n].  Returns cudaGetLastError() after the launch.
int qmm(int in_kind, int out_kind, const void* x, const int8_t* wp, const float* sw,
        const float* sx, const float* bias, void* out, int lanes, int m, int k, int k_pad, int n,
        void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (in_kind) {
    case 0: return launch_out<int8_t>(out_kind, x, wp, sw, sx, bias, out, lanes, m, k, k_pad,
                                      n, s);
    case 1: return launch_out<__nv_bfloat16>(out_kind, x, wp, sw, sx, bias, out, lanes, m, k,
                                             k_pad, n, s);
    case 2: return launch_out<float>(out_kind, x, wp, sw, sx, bias, out, lanes, m, k, k_pad, n,
                                     s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* qmm_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
