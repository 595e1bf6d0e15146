// Activation quantize for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces bmcnet_esr_tpu/ops/pallas/quantize.py::_quant_kernel (the body of
// quantize_act): x [B, H, W, C] (bf16 or float32, NHWC-contiguous) becomes
// int8 at a static per-lane scale sx[b]:
//
//   q = clip(round_half_even([relu](x) / sx[b]), -127, 127)
//
// The division is IEEE (__fdiv_rn, never x * (1/sx)) and the rounding is
// __float2int_rn (half to even, as jnp.round), so the result is bit-equal to
// the plain PyTorch version and to the JAX reference.
//
// Design.  The TPU kernel is one program per lane holding the whole
// [H, W, C] plane in VMEM.  Here the grid is (element blocks, lanes): each
// block reads its lane's scale once, and each thread quantizes 4 elements
// 256 apart, so a warp's loads and stores are contiguous.
//
// Bound.  Bytes: each input element read once (2 bytes bf16) and each int8
// written once.  At the main path's shapes (45 x 80 x C, C <= 416) that is
// under a microsecond at 3.35 TB/s, so launch latency dominates one call.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
    quantize_kernel(const T* __restrict__ x, const float* __restrict__ sx,
                    int8_t* __restrict__ out, int per_lane, int relu) {
  const long long base = (long long)blockIdx.y * per_lane;
  const float s = sx[blockIdx.y];
  int i = blockIdx.x * (kThreads * kPerThread) + threadIdx.x;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k, i += kThreads) {
    if (i < per_lane) {
      float v = to_float(x[base + i]);
      if (relu) v = fmaxf(v, 0.0f);
      int q = __float2int_rn(__fdiv_rn(v, s));
      out[base + i] = (int8_t)min(max(q, -127), 127);
    }
  }
}

template <typename T>
int launch(const T* x, const float* sx, int8_t* out, int lanes, int per_lane, int relu,
           void* stream) {
  if (lanes == 0 || per_lane == 0) return (int)cudaGetLastError();
  if (lanes > 65535) return (int)cudaErrorInvalidConfiguration;
  dim3 grid((per_lane + kThreads * kPerThread - 1) / (kThreads * kPerThread), lanes);
  quantize_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(x, sx, out, per_lane, relu);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x [lanes, per_lane] (per_lane = H * W * C), sx [lanes] float32, out int8
// like x.  Returns cudaGetLastError() after the launch.
int quantize_act_bf16(const void* x, const float* sx, int8_t* out, int lanes, int per_lane,
                      int relu, void* stream) {
  return launch((const __nv_bfloat16*)x, sx, out, lanes, per_lane, relu, stream);
}

int quantize_act_f32(const float* x, const float* sx, int8_t* out, int lanes, int per_lane,
                     int relu, void* stream) {
  return launch(x, sx, out, lanes, per_lane, relu, stream);
}

const char* quantize_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
