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
// the TPU vector unit has no scatter.  Here the image is cut into bands of
// rows, and a block owns one band of one window (band_kernel).  It clears a
// band of counters in shared memory, walks ALL events of its window with
// 16-byte loads (the first already in flight while it clears), adds those
// whose row falls into its band with shared-memory atomics, and writes the
// band out as float32 with 16-byte stores.  Every output byte is written
// exactly once, so the output needs no zero fill, and no atomic touches
// device memory.  The events of a window are read once per band; the blocks
// of one window are neighbours in the grid, so all but the first read come
// from L2.  What the walk costs is its arithmetic (every block tests every
// event of its window), so the test of an event is one subtraction and three
// comparisons, and nothing else runs for an event of another band.  Events
// in front of the first boundary that the three rows' vectors share, and
// behind the last whole vector, are walked one by one; when the rows share
// no boundary (N odd) all are.
//
// Counters.  The compact form (int16 coordinates, int8 polarity) counts in
// int32, which shared memory adds natively, so a hot pixel costs one
// serialised add per event and no retry: p*p <= 16384, so the host's plan
// takes this kernel only where N * 16384 < 2^31, and below 2^24 the
// conversion at the store equals the float32 sums of the plain version in
// any order.  The raw form (float32 rows) admits any p, so its counters are
// float32 and the adds are float atomics (a compare-and-swap loop in shared
// memory, slow when many events share a pixel): exact in any order while
// every partial sum is an integer below 2^24 (|p| = 1, the real windows),
// and dependent on the order of the atomics in the last bit otherwise, as
// any parallel float sum is.
//
// Where no band fits (one image row larger than shared memory, or a compact
// window long enough to overflow int32), the plan takes event_kernel instead:
// the output is cleared with a memset and every event is one thread that
// adds itself with an atomicAdd on device memory.
//
// Bound.  Bytes: each event is read once (compact form: 2+2+1 = 5 bytes) and
// each output value is written once (4 bytes x H x W x 2), at 3.35 TB/s.  At
// the main path's shapes (a chunk of N = 2048 events per 45 x 80 LR window,
// 32768 per 180 x 320 GT window) that is a few microseconds, of which the
// output is 95 %: what counts is that it is written once, in wide stores,
// by blocks that fill the card in one wave.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kEventThreads = 256;

// ---- one vector of events: its loads, and its adds into a band --------------
//
// A band is `nrows` rows of counters whose first row is image row `top`
// counted from below (top = H - 1 - first row of the band), so an event of
// height y lies in row top - y of the band, or in another band.

// Compact form: 8 events, int16 x and y (16 bytes each), int8 p (8 bytes).
struct CompactGroup {
  static constexpr int kEvents = 8;
  uint4 x, y;
  uint2 p;
  __device__ __forceinline__ void load(const int16_t* xs, const int16_t* ys, const int8_t* ps) {
    x = *reinterpret_cast<const uint4*>(xs);
    y = *reinterpret_cast<const uint4*>(ys);
    p = *reinterpret_cast<const uint2*>(ps);
  }
  // For integers the row test covers 0 <= y < H, and x < 0 is a large
  // unsigned x; nothing but the test runs for an event of another band.
  static __device__ __forceinline__ void add(int* cnt, int x, int y, int p, int w, int h, int top,
                                             int nrows) {
    const int row = top - y;
    if (((unsigned)row < (unsigned)nrows) & ((unsigned)x < (unsigned)w) & (p != 0))
      atomicAdd(cnt + ((row * w + x) * 2 + (int)((unsigned)p >> 31)), p * p);
  }
  __device__ __forceinline__ void add_all(int* cnt, int w, int h, int top, int nrows) const {
    const uint32_t xw[4] = {x.x, x.y, x.z, x.w}, yw[4] = {y.x, y.y, y.z, y.w}, pw[2] = {p.x, p.y};
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // two events a word: the low half, the high half
      add(cnt, (int16_t)xw[j], (int16_t)yw[j], (int8_t)(pw[j / 2] >> (16 * (j & 1))), w, h, top,
          nrows);
      add(cnt, (int)xw[j] >> 16, (int)yw[j] >> 16, (int8_t)(pw[j / 2] >> (16 * (j & 1) + 8)), w, h,
          top, nrows);
    }
  }
};

// Raw form: 4 events, float32 x, y and p (16 bytes each).
struct RawGroup {
  static constexpr int kEvents = 4;
  float4 x, y, p;
  __device__ __forceinline__ void load(const float* xs, const float* ys, const float* ps) {
    x = *reinterpret_cast<const float4*>(xs);
    y = *reinterpret_cast<const float4*>(ys);
    p = *reinterpret_cast<const float4*>(ps);
  }
  static __device__ __forceinline__ void add(float* cnt, float x, float y, float p, int w, int h,
                                             int top, int nrows) {
    // written as "inside" tests so that a NaN coordinate is dropped too
    if (!(x >= 0 && x < w && y >= 0 && y < h) || p == 0) return;
    const int row = top - (int)y;  // truncation toward zero, then the y flip
    if ((unsigned)row < (unsigned)nrows)
      atomicAdd(cnt + ((row * w + (int)x) * 2 + (p < 0 ? 1 : 0)), p * p);
  }
  __device__ __forceinline__ void add_all(float* cnt, int w, int h, int top, int nrows) const {
    add(cnt, x.x, y.x, p.x, w, h, top, nrows);
    add(cnt, x.y, y.y, p.y, w, h, top, nrows);
    add(cnt, x.z, y.z, p.z, w, h, top, nrows);
    add(cnt, x.w, y.w, p.w, w, h, top, nrows);
  }
};

// Events to walk one by one until a vector of each row starts on its
// boundary (16 bytes of coordinates, kEvents polarities); n when the rows
// never get there together.
template <typename Group, typename C, typename P>
__device__ __forceinline__ int vector_head(const C* xs, const C* ys, const P* ps, int n) {
  constexpr int kBytes = Group::kEvents * sizeof(P);
  const int head = (int)((kBytes - (uintptr_t)ps % kBytes) % kBytes / sizeof(P));
  const bool shared = ((uintptr_t)(xs + head) % 16 | (uintptr_t)(ys + head) % 16) == 0;
  return shared ? min(head, n) : n;
}

// four counters on a 16-byte boundary as the four float32 of the output
__device__ __forceinline__ float4 counts4(const int* c) {
  const int4 v = *reinterpret_cast<const int4*>(c);
  return make_float4((float)v.x, (float)v.y, (float)v.z, (float)v.w);
}
__device__ __forceinline__ float4 counts4(const float* c) {
  return *reinterpret_cast<const float4*>(c);
}

// One block per (window, band of `rows` rows): grid.x = G * bands, dynamic
// shared memory rows * w * 2 counters rounded up to 16 bytes.
template <typename Group, typename C, typename P, typename Count>
__global__ void __launch_bounds__(kMaxThreads)
    band_kernel(const C* __restrict__ xs, const C* __restrict__ ys, const P* __restrict__ ps,
                long long c_stride, long long p_stride, float* __restrict__ out, int n, int h,
                int w, int rows, int bands) {
  extern __shared__ __align__(16) unsigned char shared_bytes[];
  Count* cnt = reinterpret_cast<Count*>(shared_bytes);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const long long g = blockIdx.x / bands;
  const int r0 = (int)(blockIdx.x - g * bands) * rows;
  const int nrows = min(rows, h - r0);
  const int cells = nrows * w * 2;
  const int top = h - 1 - r0;

  // the window's events: a scalar head, whole vectors dealt to the threads
  // in turn, a scalar tail; the first vector's loads start before the clear
  xs += g * c_stride, ys += g * c_stride, ps += g * p_stride;
  constexpr int kEvents = Group::kEvents;
  const int head = vector_head<Group>(xs, ys, ps, n);
  const int groups = (n - head) / kEvents;
  const int tail = head + groups * kEvents;
  xs += head, ys += head, ps += head;  // from here on the vectors' rows
  Group cur;
  int i = tid;
  if (i < groups) cur.load(xs + i * kEvents, ys + i * kEvents, ps + i * kEvents);

  // 1. clear the band (the bit pattern of 0 is that of 0.0f)
  for (int c = tid; c < (cells + 3) / 4; c += nthreads)
    reinterpret_cast<int4*>(cnt)[c] = make_int4(0, 0, 0, 0);
  __syncthreads();

  // 2. walk the events; the next vector's loads fly over this one's adds
  while (i < groups) {
    const Group now = cur;
    i += nthreads;
    if (i < groups) cur.load(xs + i * kEvents, ys + i * kEvents, ps + i * kEvents);
    now.add_all(cnt, w, h, top, nrows);
  }
  for (int k = tid; k < head + (n - tail); k += nthreads) {
    const int e = k < head ? k - head : tail - head + (k - head);
    Group::add(cnt, xs[e], ys[e], ps[e], w, h, top, nrows);
  }
  __syncthreads();

  // 3. write the band out once: scalars up to the first 16-byte boundary of
  // the output, whole vectors, scalars again
  float* dst = out + (g * h + r0) * (long long)w * 2;
  const int lead = min(cells, (int)((16 - (uintptr_t)dst % 16) % 16 / sizeof(float)));
  const int vecs = (cells - lead) / 4;
  const int rest = lead + vecs * 4;
  if (lead == 0) {  // the counters' vectors are on 16-byte boundaries too
    for (int v = tid; v < vecs; v += nthreads)
      reinterpret_cast<float4*>(dst)[v] = counts4(cnt + 4 * v);
  } else {
    for (int v = tid; v < vecs; v += nthreads) {
      const Count* c = cnt + lead + 4 * v;
      *reinterpret_cast<float4*>(dst + lead + 4 * v) =
          make_float4((float)c[0], (float)c[1], (float)c[2], (float)c[3]);
    }
  }
  for (int k = tid; k < lead + (cells - rest); k += nthreads) {
    const int c = k < lead ? k : rest + (k - lead);
    dst[c] = (float)cnt[c];
  }
}

// One thread per event, atomicAdd into the cleared output: for the shapes no
// band fits.
template <typename C, typename P>
__global__ void __launch_bounds__(kEventThreads)
    event_kernel(const C* __restrict__ xs, const C* __restrict__ ys, const P* __restrict__ ps,
                 long long c_stride, long long p_stride, float* __restrict__ out,
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

// rows > 0: band_kernel with bands of `rows` rows, `threads` threads and
// `smem_bytes` of dynamic shared memory.  rows == 0: event_kernel.
template <typename Group, typename C, typename P, typename Count>
int launch(const C* xs, const C* ys, const P* ps, long long c_stride, long long p_stride,
           float* out, long long g, int n, int h, int w, int rows, int threads, int smem_bytes,
           void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (g == 0 || h == 0 || w == 0) return (int)cudaGetLastError();
  if (rows == 0) {
    cudaError_t err = cudaMemsetAsync(out, 0, (size_t)g * h * w * 2 * sizeof(float), s);
    if (err != cudaSuccess) return (int)err;
    const long long total = g * (long long)n;
    if (total == 0) return (int)cudaGetLastError();
    const long long blocks = (total + kEventThreads - 1) / kEventThreads;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    event_kernel<C, P><<<(unsigned)blocks, kEventThreads, 0, s>>>(xs, ys, ps, c_stride, p_stride,
                                                                  out, total, n, h, w);
    return (int)cudaGetLastError();
  }
  const int bands = (h + rows - 1) / rows;
  const long long blocks = g * bands;
  const long long band_bytes = (long long)(rows < h ? rows : h) * w * 2 * sizeof(Count);
  if (blocks > 0x7fffffffLL || threads < 1 || threads > kMaxThreads || smem_bytes < band_bytes)
    return (int)cudaErrorInvalidConfiguration;
  auto kernel = band_kernel<Group, C, P, Count>;
  if (smem_bytes > 48 * 1024) {  // above 48 KB a kernel has to opt in
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(unsigned)blocks, threads, smem_bytes, s>>>(xs, ys, ps, c_stride, p_stride, out, n, h,
                                                       w, rows, bands);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Compact windows: xy int16 [G, 2, N], p int8 [G, N]; out float32 [G, H, W, 2],
// uninitialised.  rows, threads and smem_bytes are the host's launch plan
// (rows == 0: the per-event kernel).  Returns cudaGetLastError() after the
// launch.
int rasterize_counts_compact(const int16_t* xy, const int8_t* p, float* out, long long g,
                             int n, int h, int w, int rows, int threads, int smem_bytes,
                             void* stream) {
  return launch<CompactGroup, int16_t, int8_t, int>(xy, xy + n, p, 2LL * n, (long long)n, out, g,
                                                    n, h, w, rows, threads, smem_bytes, stream);
}

// Raw windows: events float32 [G, 4, N] with rows x, y, t, p.
int rasterize_counts_f32(const float* ev, float* out, long long g, int n, int h, int w,
                         int rows, int threads, int smem_bytes, void* stream) {
  return launch<RawGroup, float, float, float>(ev, ev + n, ev + 3LL * n, 4LL * n, 4LL * n, out,
                                               g, n, h, w, rows, threads, smem_bytes, stream);
}

const char* rasterize_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
