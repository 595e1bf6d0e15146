// Count-image rasterizer for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces bmcnet_esr_tpu/ops/pallas/rasterize.py::_kernel (the body of
// pallas_events_to_counts) and the XLA scatter behind
// bmcnet_esr_tpu/ops/batch.py::batch_counts_from_compact: G windows of N
// zero-padded events become G count images [G, H, W, 2] (NHWC, float32).
// Event (x, y, p) lands at pixel (H-1-y, x), channel (p < 0), value p*p;
// events with x<0 | x>=W | y<0 | y>=H | p==0 are dropped.
//
// Design.  The TPU kernel is event-serial: one program per window walks its
// events from SMEM and adds a one-hot row into a VMEM accumulator, because
// the TPU vector unit has no scatter.  A GPU has hardware atomics on device
// memory, so here every event is one thread and adds itself into the
// zero-filled output with atomicAdd.  For real windows every addend is an
// integer (|p| = 1) and every partial sum is an integer below 2^24, so any
// order of the atomics gives bit-exact counts.
//
// Bound.  Bytes: each event is read once (compact form: 2+2+1 = 5 bytes) and
// each output value is written once (4 bytes x H x W x 2), at 3.35 TB/s.  At
// the main path's shapes (a chunk of N = 2048 events per 45 x 80 LR window,
// 32768 per 180 x 320 GT window) that is a few microseconds, so launch
// latency, the zero fill and atomic contention on hot pixels dominate.
// Privatising the LR image in shared memory and aggregating per warp are
// left for later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename C, typename P>
__global__ void rasterize_counts_kernel(const C* __restrict__ xs, const C* __restrict__ ys,
                                        const P* __restrict__ ps, long long c_stride,
                                        long long p_stride, float* __restrict__ out,
                                        long long total, int n, int h, int w) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  long long g = i / n;
  long long e = i - g * n;
  C x = xs[g * c_stride + e];
  C y = ys[g * c_stride + e];
  P p = ps[g * p_stride + e];
  // written as "inside" tests so that a NaN coordinate is dropped too
  if (!(x >= 0 && x < w && y >= 0 && y < h) || p == 0) return;
  int xi = (int)x;  // truncation toward zero, as the reference's integer cast
  int yi = h - 1 - (int)y;
  float v = (float)p;
  long long idx = ((g * h + yi) * (long long)w + xi) * 2 + (p < 0 ? 1 : 0);
  atomicAdd(out + idx, v * v);
}

constexpr int kThreads = 256;

template <typename C, typename P>
int launch(const C* xs, const C* ys, const P* ps, long long c_stride, long long p_stride,
           float* out, long long g, int n, int h, int w, void* stream) {
  long long total = g * (long long)n;
  if (total == 0) return (int)cudaGetLastError();
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  rasterize_counts_kernel<C, P><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      xs, ys, ps, c_stride, p_stride, out, total, n, h, w);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Compact windows: xy int16 [G, 2, N], p int8 [G, N]; out float32 [G, H, W, 2],
// zero-filled by the caller.  Returns cudaGetLastError() after the launch.
int rasterize_counts_compact(const int16_t* xy, const int8_t* p, float* out, long long g,
                             int n, int h, int w, void* stream) {
  return launch<int16_t, int8_t>(xy, xy + n, p, 2LL * n, (long long)n, out, g, n, h, w,
                                 stream);
}

// Raw windows: events float32 [G, 4, N] with rows x, y, t, p.
int rasterize_counts_f32(const float* ev, float* out, long long g, int n, int h, int w,
                         void* stream) {
  return launch<float, float>(ev, ev + n, ev + 3LL * n, 4LL * n, 4LL * n, out, g, n, h, w,
                              stream);
}

const char* rasterize_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
