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
// Bound.  At the main path's shapes (M = 3600, K = 128 or 256, N = 128) the
// int8 work is 0.1-0.2 GOP per lane and the bytes are the bf16 input and
// output (about 1.9-2.8 MB): bytes bound it, at about 0.6-0.8 us per lane
// on an H100.  The kernel is one dependent chain (load, quantize, multiply,
// store), so the design makes that chain short and runs many of them.
//
// Design.  The TPU grid walks (lane, 576-row tile) with K and N whole.  Here
// rows of all lanes form one M axis and a block of eight warps computes 32
// rows by 128 columns (M = 3600 -> 113 blocks, one or two a multiprocessor).
// K is taken whole (in blocks of 512 where it is longer): one thread starts
// a single cp.async.bulk of the block's [128, K + 16] weight slab, which
// completes on an mbarrier, while all threads load the [32, K] activation
// tile once (16-byte loads where K % 8 == 0), quantize it once (a zero
// skips the division) and store it as int8 rows.  Then one block barrier,
// one wait, and every K step of 32 runs back to back: ldmatrix fragments,
// mma.sync.m16n8k32 s8 -> s32, warps 2 x 4 of 16 rows x 32 columns.  The
// per-row lane scale, sw and bias sit in shared memory, read once per
// block; results are stored as pairs.  Weights come packed per block of 128
// output channels and K block as rows of K + 16 bytes (zeros past K and past
// N; the 16 bytes keep ldmatrix off bank conflicts).  A row depends on its
// own lane only, so a batch equals its solo launches bit for bit.

#include "int8_tiles.cuh"

namespace {

using namespace int8_tiles;

constexpr int BM = 32;          // rows per block
constexpr int BN = 128;         // output channels per block
constexpr int KB = 512;         // K per pass (the whole K where it is shorter)
constexpr int PAD = 16;         // bytes added to every shared-memory row
constexpr int kThreads = 256;   // 2 x 4 warps of 16 rows x 32 columns
constexpr int HEAD_BYTES = 128 + (BM + 2 * BN) * 4;  // barrier, row scales, sw, bias

// Stage rows [m0, m0 + BM) x columns [k_base, k_base + kb) of x, quantized at
// each row's lane scale sx[row / m], as int8 rows of astride bytes.
template <typename TIn>
__device__ __forceinline__ void stage_rows(const TIn* __restrict__ x, int8_t* as, int astride,
                                           const float* __restrict__ sx, int m, long long m0,
                                           long long m_total, int k_base, int kb, int k,
                                           int vec, int tid) {
  constexpr int U = 2;
  const int nv = kb >> 3, items = BM * nv;
  for (int it0 = tid; it0 < items; it0 += kThreads * U) {
    Vec8<TIn> raw[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int it = it0 + u * kThreads;
      raw[u].zero();
      if (it < items) {
        const int r = it / nv, c = k_base + ((it - r * nv) << 3);
        if (m0 + r < m_total && c < k) {
          const TIn* p = x + (m0 + r) * k + c;
          if (vec) raw[u].load16(p); else raw[u].load_scalar(p, min(8, k - c));
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int it = it0 + u * kThreads;
      if (it < items) {
        const int r = it / nv, cg = it - r * nv;
        const QScale qs = make_qscale(m0 + r < m_total ? sx[(int)(m0 + r) / m] : 1.0f);
        *reinterpret_cast<uint2*>(as + r * astride + (cg << 3)) = quantize8(raw[u], qs);
      }
    }
  }
}

// The int8-input form: rows are copied, 16 columns an item.
template <>
__device__ __forceinline__ void stage_rows<int8_t>(const int8_t* __restrict__ x, int8_t* as,
                                                   int astride, const float* __restrict__, int,
                                                   long long m0, long long m_total, int k_base,
                                                   int kb, int k, int vec, int tid) {
  const int nv = kb >> 4, items = BM * nv;
  for (int it = tid; it < items; it += kThreads) {
    const int r = it / nv, cg = it - r * nv, c = k_base + (cg << 4);
    const bool live = m0 + r < m_total && c < k;
    int8_t* dst = as + r * astride + (cg << 4);
    if (live && vec) {
      cp_async16(smem_u32(dst), x + (m0 + r) * k + c);
    } else {
      uint32_t q[4] = {0u, 0u, 0u, 0u};
      if (live) {
        const int8_t* p = x + (m0 + r) * k + c;
        const int n = min(16, k - c);
#pragma unroll
        for (int j = 0; j < 16; ++j)
          if (j < n) q[j >> 2] |= (uint32_t)(uint8_t)p[j] << (8 * (j & 3));
      }
      *reinterpret_cast<uint4*>(dst) = make_uint4(q[0], q[1], q[2], q[3]);
    }
  }
  cp_async_wait_all();
}

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(kThreads)
    qmm_kernel(const TIn* __restrict__ x, const int8_t* __restrict__ wp,
               const float* __restrict__ sw, const float* __restrict__ sx,
               const float* __restrict__ bias, TOut* __restrict__ out, long long m_total, int m,
               int k, int k_pad, int n, int vec) {
  extern __shared__ __align__(128) uint8_t smem[];
  float* s_row = reinterpret_cast<float*>(smem + 128);
  float* s_sw = s_row + BM;
  float* s_bias = s_sw + BN;
  const int stride = min(k_pad, KB) + PAD;  // bytes per row of both tiles
  int8_t* as = reinterpret_cast<int8_t*>(smem + HEAD_BYTES);
  uint8_t* bs = smem + HEAD_BYTES + BM * stride;
  const uint32_t bar = smem_u32(smem), as_u32 = smem_u32(as), bs_u32 = smem_u32(bs);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  // packed weights of this block of output channels: K blocks one after another
  const int8_t* wsrc = wp + (long long)blockIdx.y * BN * (k_pad + PAD * ((k_pad + KB - 1) / KB));

  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (tid < BM) s_row[tid] = m0 + tid < m_total ? sx[(int)(m0 + tid) / m] : 1.0f;
  if (tid < BN) {
    const int c = n0 + tid;
    s_sw[tid] = c < n ? sw[c] : 0.0f;
    s_bias[tid] = c < n ? bias[c] : 0.0f;
  }

  const int wm = warp & 1, wn = warp >> 1;
  const uint32_t a_lane = as_u32 + (wm * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * stride +
                          (lane >> 4) * 16;
  const int b_row = wn * 32 + (lane & 7) + (lane >> 4) * 8, b_col = ((lane >> 3) & 1) * 16;

  int acc[4][4] = {};  // [n8 tile][fragment]
  uint32_t parity = 0;
  for (int kb0 = 0; kb0 < k_pad; kb0 += KB, parity ^= 1u) {
    const int kb = min(KB, k_pad - kb0), bstride = kb + PAD;
    if (kb0 > 0) __syncthreads();  // every warp is done with the previous K block
    if (tid == 0) {
      const uint32_t bytes = BN * bstride;
      mbar_expect_tx(bar, bytes);
      bulk_copy(bs_u32, wsrc, bytes, bar);
      wsrc += bytes;
    }
    stage_rows<TIn>(x, as, stride, sx, m, m0, m_total, kb0, kb, k, vec, tid);
    __syncthreads();
    mbar_wait(bar, parity);

    const uint32_t b_lane = bs_u32 + b_row * bstride + b_col;
#pragma unroll 4
    for (int k0 = 0; k0 < kb; k0 += 32) {
      uint32_t af[4], bf[2][4];
      ldmatrix_x4(af, a_lane + k0);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) ldmatrix_x4(bf[jj], b_lane + jj * 16 * bstride + k0);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        mma_s8(acc[j], af, bf[j >> 1][(j & 1) * 2], bf[j >> 1][(j & 1) * 2 + 1]);
    }
  }

  const int g = lane >> 2, t4 = lane & 3;
  const bool even = (n & 1) == 0;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = wm * 16 + g + half * 8;
    const long long row = m0 + r;
    if (row >= m_total) continue;
    const float sr = s_row[r];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int cl = wn * 32 + j * 8 + t4 * 2, c = n0 + cl;
      if (c >= n) continue;
      const float y0 = __fadd_rn(
          __fmul_rn(__int2float_rn(acc[j][half * 2]), __fmul_rn(sr, s_sw[cl])), s_bias[cl]);
      const float y1 = __fadd_rn(
          __fmul_rn(__int2float_rn(acc[j][half * 2 + 1]), __fmul_rn(sr, s_sw[cl + 1])),
          s_bias[cl + 1]);
      store2(out + row * n + c, y0, y1, QScale(), 0, even, c + 1 < n);
    }
  }
}

// What the C entry point hands down to the typed launch.
struct Call {
  const void* x;
  const int8_t* wp;
  const float *sw, *sx, *bias;
  void* out;
  long long m_total;
  int m, k, k_pad, n, vec, grid_x, grid_y, smem_bytes;
  cudaStream_t stream;
};

template <typename TIn, typename TOut>
int launch(const Call& c) {
  auto kernel = qmm_kernel<TIn, TOut>;
  const cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, c.smem_bytes);
  if (rc != cudaSuccess) return (int)rc;
  const dim3 grid((unsigned)c.grid_x, (unsigned)c.grid_y);
  kernel<<<grid, kThreads, c.smem_bytes, c.stream>>>((const TIn*)c.x, c.wp, c.sw, c.sx, c.bias,
                                                     (TOut*)c.out, c.m_total, c.m, c.k, c.k_pad,
                                                     c.n, c.vec);
  return (int)cudaGetLastError();
}

template <typename TIn>
int launch_out(int out_kind, const Call& c) {
  switch (out_kind) {
    case 0: return launch<TIn, __nv_bfloat16>(c);
    case 1: return launch<TIn, float>(c);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// in_kind: 0 int8 x (already quantized at sx), 1 bf16 x, 2 float32 x.
// out_kind: 0 bf16 y, 1 float32 y.
// x [lanes, m, k]; wp the packed weights (see the head of this file;
// kernels/qmm.py::pack_weights writes them); sw, bias [n]; sx [lanes];
// out [lanes, m, n].  vec: x may be read as 16-byte vectors.  The launch
// plan (tile, threads, grid, dynamic shared-memory bytes) comes from
// kernels/qmm.py::matmul_plan and is checked against the kernel's constants
// here.  Returns a cudaError_t.
int qmm(int in_kind, int out_kind, const void* x, const int8_t* wp, const float* sw,
        const float* sx, const float* bias, void* out, int lanes, int m, int k, int k_pad, int n,
        int vec, int block_m, int block_n, int threads, int grid_x, int grid_y, int smem_bytes,
        void* stream) {
  const long long m_total = (long long)lanes * m;
  if (m_total == 0 || n == 0) return (int)cudaGetLastError();
  const int stride = (k_pad < KB ? k_pad : KB) + PAD;
  const long long need = HEAD_BYTES + (long long)(BM + BN) * stride;
  if (block_m != BM || block_n != BN || threads != kThreads || k < 1 || k_pad % 32 != 0 ||
      k > k_pad || k_pad - k >= 32 || grid_x != (m_total + BM - 1) / BM ||
      grid_y != (n + BN - 1) / BN || smem_bytes < need)
    return (int)cudaErrorInvalidValue;
  const Call c = {x, wp, sw, sx, bias, out, m_total, m, k, k_pad, n, vec,
                  grid_x, grid_y, smem_bytes, (cudaStream_t)stream};
  switch (in_kind) {
    case 0: return launch_out<int8_t>(out_kind, c);
    case 1: return launch_out<__nv_bfloat16>(out_kind, c);
    case 2: return launch_out<float>(out_kind, c);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* qmm_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
