// W8A8 3x3 SAME convolution for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces bmcnet_esr_tpu/ops/pallas/qconv.py::_qconv_kernel (the body of
// quant_conv3x3), and the int8 lax.conv of the XLA route in
// bmcnet_esr_tpu/models/layers.py::QuantConv._convolve:
//
//   acc[b, y, x, n] = sum over taps (dy, dx) and input channels c of
//                     q(x)[b, y+dy-1, x+dx-1, c] * wq[dy, dx, c, n]   (int32,
//                     zero outside the image)
//   y = acc * (sx[b] * sw[n]) + bias[n]                                 (float32)
//
// Input forms: x is bf16 / float32 and quantized here at the per-lane scale
// sx[b] (the fused Pallas kernel), or x is int8 already quantized at sx[b]
// (the XLA route, and a chained producer's output).  Output forms: y in
// bf16 / float32, or y through an optional ReLU quantized to int8 at the
// per-lane scale se[b] (the chain modes' epilogue).  Every rounding step is
// written out (__fdiv_rn, __float2int_rn, __fmul_rn, __fadd_rn,
// __float2bfloat16_rn), so nvcc cannot contract it into an FMA and the
// result is bit-equal to the plain PyTorch version.
//
// Design.  The TPU kernel holds one lane's whole plane in VMEM and runs nine
// shifted [H*W, Cin] x [Cin, Cout] dots.  Here it is an implicit GEMM,
// M = B*H*W pixels, N = Cout, K = 9 taps x Cin: a block computes a 32-pixel
// by 128-channel tile, its four warps 32 x 32 each with
// mma.sync.m16n8k32 s8 -> s32.  Each K step stages a 32 x 32 int8 tile of
// (quantized, border-masked) activations and a 128 x 32 tile of weights in
// shared memory.  Weights come packed as [Cout, 9, Cin_pad] with Cin_pad a
// multiple of 32 and zeros past Cin, so odd channel counts (131, 150, 172)
// need no special case and every weight row loads as 16-byte vectors.  Each
// output pixel depends on its own lane only, so a batch of B lanes gives
// bit for bit what B solo launches give.
//
// Bound.  At the main path's shapes (45 x 80 pixels, Cin <= 416, Cout 128)
// the dense int8 work is about 1 GOP per lane and the bytes are the bf16
// input and output planes, both well under 1 us on an H100.  This first
// kernel is far from that: no cp.async / TMA pipeline, no wgmma, and in the
// fused form every input value is quantized once per tap.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 32;         // output pixels per block
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

__device__ __forceinline__ void store(__nv_bfloat16* o, long long i, float y, float, int) {
  o[i] = __float2bfloat16_rn(y);
}
__device__ __forceinline__ void store(float* o, long long i, float y, float, int) { o[i] = y; }
__device__ __forceinline__ void store(int8_t* o, long long i, float y, float se, int relu) {
  if (relu) y = fmaxf(y, 0.0f);
  o[i] = (int8_t)quantize(y, se);
}

__device__ __forceinline__ void mma_s8(int* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(kThreads)
    qconv3x3_kernel(const TIn* __restrict__ x, const int8_t* __restrict__ wp,
                    const float* __restrict__ sw, const float* __restrict__ sx,
                    const float* __restrict__ bias, const float* __restrict__ se,
                    TOut* __restrict__ out, int lanes, int h, int w, int cin, int cin_pad,
                    int cout, int relu) {
  __shared__ __align__(16) int8_t as[BM * LDS];
  __shared__ __align__(16) int8_t bs[BN * LDS];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;  // mma fragment row group, thread in group
  const int hw = h * w;
  const long long m_total = (long long)lanes * hw;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // this thread stages activations of pixel m0 + ar, channels ac .. ac + 7
  const int ar = tid >> 2, ac = (tid & 3) * 8;
  const long long am = m0 + ar;
  const bool a_valid = am < m_total;
  int ab = 0, ay = 0, ax = 0;
  if (a_valid) {
    ab = (int)(am / hw);
    const int r = (int)(am - (long long)ab * hw);
    ay = r / w;
    ax = r - ay * w;
  }
  const float a_scale = sx[ab];
  // ... and weights of output channel n0 + tid, 32 bytes of K
  const int bn = n0 + tid;

  int acc[2][4][4] = {};  // [m16 tile][n8 tile][fragment]

  for (int tap = 0; tap < 9; ++tap) {
    const int sy = ay + tap / 3 - 1, sxp = ax + tap % 3 - 1;
    const bool inb = a_valid && sy >= 0 && sy < h && sxp >= 0 && sxp < w;
    const long long src = inb ? (((long long)ab * h + sy) * w + sxp) * cin : 0;
    const int8_t* wrow = wp + ((long long)bn * 9 + tap) * cin_pad;
    for (int c0 = 0; c0 < cin; c0 += BK) {
      uint32_t lo = 0, hi = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = c0 + ac + j;
        const uint32_t v = (inb && c < cin) ? load_q(x, src + c, a_scale) : 0u;
        if (j < 4) lo |= v << (8 * j); else hi |= v << (8 * (j - 4));
      }
      *reinterpret_cast<uint2*>(as + ar * LDS + ac) = make_uint2(lo, hi);
      uint4 w0 = make_uint4(0, 0, 0, 0), w1 = w0;
      if (bn < cout) {
        w0 = *reinterpret_cast<const uint4*>(wrow + c0);
        w1 = *reinterpret_cast<const uint4*>(wrow + c0 + 16);
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
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const long long m = m0 + i * 16 + g + (r >> 1) * 8;
        const int n = n0 + warp * 32 + j * 8 + t4 * 2 + (r & 1);
        if (m < m_total && n < cout) {
          const int b = (int)(m / hw);
          const float y = __fadd_rn(
              __fmul_rn(__int2float_rn(acc[i][j][r]), __fmul_rn(sx[b], sw[n])), bias[n]);
          store(out, m * cout + n, y, se == nullptr ? 0.0f : se[b], relu);
        }
      }
}

template <typename TIn, typename TOut>
int launch(const void* x, const int8_t* wp, const float* sw, const float* sx, const float* bias,
           const float* se, void* out, int lanes, int h, int w, int cin, int cin_pad, int cout,
           int relu, cudaStream_t stream) {
  const long long m_total = (long long)lanes * h * w;
  if (m_total == 0 || cout == 0) return (int)cudaGetLastError();
  const long long blocks = (m_total + BM - 1) / BM;
  if (blocks > 0x7fffffffLL || cin_pad % BK != 0 || cin > cin_pad)
    return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)blocks, (cout + BN - 1) / BN);
  qconv3x3_kernel<TIn, TOut><<<grid, kThreads, 0, stream>>>(
      (const TIn*)x, wp, sw, sx, bias, se, (TOut*)out, lanes, h, w, cin, cin_pad, cout, relu);
  return (int)cudaGetLastError();
}

template <typename TIn>
int launch_out(int out_kind, const void* x, const int8_t* wp, const float* sw, const float* sx,
               const float* bias, const float* se, void* out, int lanes, int h, int w, int cin,
               int cin_pad, int cout, int relu, cudaStream_t stream) {
  switch (out_kind) {
    case 0: return launch<TIn, __nv_bfloat16>(x, wp, sw, sx, bias, se, out, lanes, h, w, cin,
                                              cin_pad, cout, relu, stream);
    case 1: return launch<TIn, float>(x, wp, sw, sx, bias, se, out, lanes, h, w, cin, cin_pad,
                                      cout, relu, stream);
    case 2: return launch<TIn, int8_t>(x, wp, sw, sx, bias, se, out, lanes, h, w, cin, cin_pad,
                                       cout, relu, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// in_kind: 0 int8 x (already quantized at sx), 1 bf16 x, 2 float32 x.
// out_kind: 0 bf16 y, 1 float32 y, 2 int8 at se[b] after an optional ReLU.
// x [lanes, h, w, cin] NHWC; wp int8 [cout, 9, cin_pad]; sw, bias [cout];
// sx, se [lanes]; out [lanes, h, w, cout].  Returns cudaGetLastError().
int qconv3x3(int in_kind, int out_kind, const void* x, const int8_t* wp, const float* sw,
             const float* sx, const float* bias, const float* se, void* out, int lanes, int h,
             int w, int cin, int cin_pad, int cout, int relu, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (in_kind) {
    case 0: return launch_out<int8_t>(out_kind, x, wp, sw, sx, bias, se, out, lanes, h, w, cin,
                                      cin_pad, cout, relu, s);
    case 1: return launch_out<__nv_bfloat16>(out_kind, x, wp, sw, sx, bias, se, out, lanes, h,
                                             w, cin, cin_pad, cout, relu, s);
    case 2: return launch_out<float>(out_kind, x, wp, sw, sx, bias, se, out, lanes, h, w, cin,
                                     cin_pad, cout, relu, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* qconv_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
