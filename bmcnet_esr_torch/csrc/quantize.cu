// Activation quantize for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces bmcnet_esr_tpu/ops/pallas/quantize.py::_quant_kernel (the body of
// quantize_act): x [B, H, W, C] (bf16 or float32, NHWC-contiguous) becomes
// int8 at a static per-lane scale sx[b]:
//
//   q = clip(round_half_even([relu](x) / sx[b]), -127, 127)
//
// The arithmetic is int8_tiles.cuh's: the shortcut around the division that
// is proven equal to __fdiv_rn + __float2int_rn (half to even, as jnp.round)
// wherever it says it is sure, and the division itself elsewhere (near a
// half-step, odd scales, NaN and infinities).  So the result is bit-equal to
// the plain PyTorch version and to the JAX reference.
//
// Design.  The TPU kernel is one program per lane holding the whole
// [H, W, C] plane in VMEM.  Here a lane is a flat run of elements cut into
// units of 4: a thread loads a unit in one transaction (8 bytes of bf16, 16
// of float32), quantizes it without a division and stores its 4 bytes in
// one.  The kernel is bound by its arithmetic and by latency, not by
// bytes (on an NVIDIA H100 80GB HBM3 at 700 W a copy of the same bytes takes
// 0.4-0.7x its time), so it wants many threads with little work each: wider
// units (8 or 16 elements a thread, 16-byte loads and stores) measured
// slower there at every shape of the main path.  The grid is (blocks, lanes), planned by the host from the card's
// multiprocessor count: one unit a thread while all blocks are resident at
// once (8 blocks of 256 threads a multiprocessor), a loop inside the block
// beyond that, the next unit's load started before this one's store.  A lane
// whose first element is not on a 4-byte boundary of the output walks up to
// 3 elements one by one first, and what is left behind the last whole unit
// likewise; when input and output share no boundary, the whole lane.
//
// Bound.  Bytes: each input element read once (2 bytes bf16) and each int8
// written once.  At the main path's shapes (45 x 80 x C, C <= 416) that is
// under a microsecond at 3.35 TB/s, below what one launch takes to start
// and drain: quantize_empty launches the same grid with no work, for the
// measurement of that floor.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_tiles.cuh"

namespace {

using namespace int8_tiles;

constexpr int kThreads = 256;
constexpr int kUnit = 4;         // elements a thread quantizes per step: one 4-byte store
constexpr int kBlocksPerSM = 8;  // resident together: what the host's plan counts on

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// Four consecutive input values, as loaded.
template <typename T>
struct Unit;

template <>
struct Unit<__nv_bfloat16> {
  uint2 w;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    w = *reinterpret_cast<const uint2*>(p);
  }
  // max(v, 0): a negative bf16 (its sign bit set, -0.0 and negative NaN
  // too) becomes +0.0, as fmaxf(v, 0.0f) makes it
  __device__ __forceinline__ void relu() {
    w.x &= ~(((w.x >> 15) & 0x00010001u) * 0xffffu);
    w.y &= ~(((w.y >> 15) & 0x00010001u) * 0xffffu);
  }
  __device__ __forceinline__ float at(int j) const {
    const uint32_t word = j < 2 ? w.x : w.y;
    return __uint_as_float((j & 1) ? (word & 0xffff0000u) : (word << 16));
  }
};

template <>
struct Unit<float> {
  float4 v;
  __device__ __forceinline__ void load(const float* p) {
    v = *reinterpret_cast<const float4*>(p);
  }
  __device__ __forceinline__ void relu() {
    v = make_float4(fmaxf(v.x, 0.0f), fmaxf(v.y, 0.0f), fmaxf(v.z, 0.0f), fmaxf(v.w, 0.0f));
  }
  __device__ __forceinline__ float at(int j) const {
    return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
  }
};

// Four loaded values as four int8 bytes at the scale qs: the shortcut, or
// the division for all four when it is unsure of one.
template <typename T>
__device__ __forceinline__ uint32_t quantize4(const Unit<T>& raw, const QScale& qs) {
  uint32_t b[4];
  float dmax = 0.0f, nan = 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j) b[j] = q8_shortcut(raw.at(j), qs, dmax, nan);
  if (shortcut_unsure(qs, dmax, nan)) {
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = q8(raw.at(j), qs.s);
  }
  // the low bytes of four words into one
  return __byte_perm(__byte_perm(b[0], b[1], 0x0040), __byte_perm(b[2], b[3], 0x0040), 0x5410);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    quantize_kernel(const T* __restrict__ x, const float* __restrict__ sx,
                    int8_t* __restrict__ out, int per_lane, int relu) {
  const T* xl = x + (long long)blockIdx.y * per_lane;
  int8_t* ol = out + (long long)blockIdx.y * per_lane;
  // elements in front of the output's first 4-byte boundary; the input must
  // be on a boundary of its own vector there too, else the lane has no units
  const int lead = (int)((kUnit - (uintptr_t)ol % kUnit) % kUnit);
  const bool shared = (uintptr_t)(xl + lead) % (kUnit * sizeof(T)) == 0;
  const int head = shared ? min(lead, per_lane) : per_lane;
  const int units = (per_lane - head) / kUnit;
  const int tail = head + units * kUnit;
  const int tid = blockIdx.x * kThreads + threadIdx.x, stride = gridDim.x * kThreads;

  // whole units: the load starts before the scale's, and the next unit's
  // (beyond one wave of the grid) before this one's store
  Unit<T> raw;
  int u = tid;
  if (u < units) raw.load(xl + head + u * kUnit);
  const QScale qs = make_qscale(sx[blockIdx.y]);
  while (u < units) {
    if (relu) raw.relu();
    const uint32_t q = quantize4(raw, qs);
    int8_t* o = ol + head + u * kUnit;
    u += stride;
    if (u < units) raw.load(xl + head + u * kUnit);
    *reinterpret_cast<uint32_t*>(o) = q;
  }
  // the elements in front of and behind the units, one by one
  for (int i = tid; i < head + (per_lane - tail); i += stride) {
    const int e = i < head ? i : tail + (i - head);
    float v = to_float(xl[e]);
    if (relu) v = fmaxf(v, 0.0f);
    ol[e] = (int8_t)q8(v, qs);
  }
}

__global__ void __launch_bounds__(kThreads) empty_kernel() {}

template <typename T>
int launch(const T* x, const float* sx, int8_t* out, int lanes, int per_lane, int relu,
           int blocks, void* stream) {
  if (lanes == 0 || per_lane == 0) return (int)cudaGetLastError();
  if (lanes > 65535 || blocks < 1) return (int)cudaErrorInvalidConfiguration;
  quantize_kernel<T><<<dim3(blocks, lanes), kThreads, 0, (cudaStream_t)stream>>>(
      x, sx, out, per_lane, relu);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x [lanes, per_lane] (per_lane = H * W * C), sx [lanes] float32, out int8
// like x; a grid of (blocks, lanes) blocks of 256 threads, the host's plan.
// Returns cudaGetLastError() after the launch.
int quantize_act_bf16(const void* x, const float* sx, int8_t* out, int lanes, int per_lane,
                      int relu, int blocks, void* stream) {
  return launch((const __nv_bfloat16*)x, sx, out, lanes, per_lane, relu, blocks, stream);
}

int quantize_act_f32(const float* x, const float* sx, int8_t* out, int lanes, int per_lane,
                     int relu, int blocks, void* stream) {
  return launch(x, sx, out, lanes, per_lane, relu, blocks, stream);
}

// A kernel that does nothing, on the grid quantize_act would take: what a
// launch of that size costs on the card before any byte moves.
int quantize_empty(int lanes, int blocks, void* stream) {
  if (lanes < 1 || lanes > 65535 || blocks < 1) return (int)cudaErrorInvalidConfiguration;
  empty_kernel<<<dim3(blocks, lanes), kThreads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

const char* quantize_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
