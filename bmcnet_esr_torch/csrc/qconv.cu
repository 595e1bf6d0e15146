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
// per-lane scale se[b] (the chain modes' epilogue).  Every rounding step of
// the float arithmetic is written out (__fdiv_rn, __float2int_rn, __fmul_rn,
// __fadd_rn, __float2bfloat16_rn), so nvcc cannot contract it into an FMA
// and the result is bit-equal to the plain PyTorch version.  The int32 sum
// is exact in any order, which is the freedom this design uses.
//
// Bound.  At the main path's shapes (45 x 80 pixels, Cin <= 416, Cout 128)
// the dense int8 work is about 1 GOP per lane and the bytes are the bf16
// input and output planes: both well under 1 us on an H100.  What the
// kernel fights is latency and the bytes each block pulls through L2 (its
// halo and its weights), so the design reads and quantizes each input once
// per block, keeps the weight copies in flight from the block's first
// cycle, and fills the card at one lane.
//
// Design.  The TPU kernel holds one lane's whole plane in VMEM and runs nine
// shifted [H*W, Cin] x [Cin, Cout] dots.  Here a block owns a 4 x 16 pixel
// output tile of ONE lane by 64 output channels (45 x 80 x 128 -> 120
// blocks of 17 warps; 9 warps, two blocks a multiprocessor, where the grid
// has more blocks than the card has multiprocessors), in four steps:
//
// 1. Sixteen (or eight) warps stage the tile's 6 x 18 halo, by a block of up to 512
//    input channels, into shared memory as int8: each value is read once
//    (16-byte loads where Cin % 8 == 0, all of a thread's loads started before
//    the first is used) and quantized once, zero for pixels outside the
//    image and channels past Cin.  The quantization takes a proven shortcut
//    around __fdiv_rn (int8_tiles.cuh) that a zero input passes without any
//    division, and falls back to the division where the shortcut cannot
//    prove the result.  The int8-input form copies with cp.async.  All nine
//    taps read this tile.
// 2. Weights come packed on the host, per block of 64 output channels, as
//    the sequence of slabs the loop consumes: one slab per (halo channel
//    block, tap, chunk of kc <= 128 channels), each in the order the tensor
//    cores read it (core matrices of 8 output channels x 16 input channels,
//    K-major, no swizzle).  The last warp streams the slabs through a
//    ring of shared-memory stages with cp.async.bulk from the block's start,
//    each copy completing on the stage's mbarrier; the math warps wait on
//    that barrier and free the stage on a second one.  No block-wide barrier
//    sits in the K loop.
// 3. Two warpgroups (warps 0-7) multiply: wgmma.mma_async m64n64k32 s8 ->
//    s32, B from the ring through a descriptor, A from registers.  An A
//    fragment row is a halo pixel, loaded by ldmatrix: a tap only shifts the
//    row addresses, which a shared-memory descriptor could not express.  The
//    warpgroups take alternate K steps of 32, and their int32 partial sums
//    are added through shared memory at the end.  A stage is freed once
//    wgmma.wait_group shows its products done.
// 4. Epilogue: sx[b] * sw[n] and bias[n] sit in shared memory, read once
//    per block; bf16 / float32 / int8 results are stored as pairs.
//
// A tile never spans two lanes, so a batch of B lanes gives bit for bit
// what B solo launches give.  Odd channel counts (131, 150, 172) take the
// scalar load path; every Cout is padded to whole blocks in the packed
// weights and masked at the store.

#include "int8_tiles.cuh"

namespace {

using namespace int8_tiles;

constexpr int TH = 4, TW = 16;          // output tile: rows x columns of one lane
constexpr int HALO_W = TW + 2;          // halo columns
constexpr int HALO_PIX = (TH + 2) * HALO_W;
constexpr int BN = 64;                  // output channels per block
constexpr int KC = 128;                 // input channels per ring stage (the last may be shorter)
constexpr int HC = 512;                 // input channels per staged halo block
constexpr int PAD = 16;                 // bytes added to every shared-memory row
constexpr int kMathWarps = 8;           // two warpgroups, each the whole tile over half of K
constexpr int kMathThreads = kMathWarps * 32;
// A block is SW warps that stage the halo (the math warps first), then the
// warp that streams weights.  SW = 16 where the grid leaves a multiprocessor
// one block (staging is then the longest phase, and more warps hide its
// latencies); SW = 8 where there are more blocks than that, so that two
// blocks share a multiprocessor and one's staging overlaps the other's math.
constexpr int threads_of(int sw) { return sw * 32 + 32; }
constexpr int MAX_STAGES = 8;
constexpr int HEAD_BYTES = 128 + 2 * BN * 4;  // barriers, then scale and bias
constexpr int STAGE_BYTES = BN * KC;
constexpr int CORE_BYTES = 8 * 16;      // a wgmma core matrix: 8 rows of 16 bytes
constexpr int KCHUNK_BYTES = (BN / 8) * CORE_BYTES;  // the core matrices of 16 channels

// Halo pixel hp of the tile at (ty0, tx0): its offset in the lane's plane
// in pixels, or -1 outside the image.
__device__ __forceinline__ int halo_src(int hp, int ty0, int tx0, int h, int w) {
  const int hy = hp / HALO_W;
  const int y = ty0 - 1 + hy, x = tx0 - 1 + (hp - hy * HALO_W);
  return (y >= 0 && y < h && x >= 0 && x < w) ? y * w + x : -1;
}

// Stage channels [c_base, c_base + hc) of the halo, quantized at qs, as int8
// rows of hstride bytes.  Loads of four items are started before the first
// is quantized, so several are in flight.
template <int NT, typename TIn>
__device__ __forceinline__ void stage_halo(const TIn* __restrict__ xb, int8_t* halo, int hstride,
                                           int c_base, int hc, int cin, int h, int w, int ty0,
                                           int tx0, const QScale& qs, int vec, int tid) {
  constexpr int U = 4;
  const int nv = hc >> 3, items = HALO_PIX * nv;
  for (int it0 = tid; it0 < items; it0 += NT * U) {
    Vec8<TIn> raw[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int it = it0 + u * NT;
      raw[u].zero();
      if (it < items) {
        const int hp = it / nv, c = c_base + ((it - hp * nv) << 3);
        const int src = halo_src(hp, ty0, tx0, h, w);
        if (src >= 0 && c < cin) {
          const TIn* p = xb + (long long)src * cin + c;
          if (vec) raw[u].load16(p); else raw[u].load_scalar(p, min(8, cin - c));
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int it = it0 + u * NT;
      if (it < items) {
        const int hp = it / nv, cg = it - hp * nv;
        *reinterpret_cast<uint2*>(halo + hp * hstride + (cg << 3)) = quantize8(raw[u], qs);
      }
    }
  }
}

// The int8-input form: the halo is copied, 16 channels an item.
template <int NT>
__device__ __forceinline__ void stage_halo(const int8_t* __restrict__ xb, int8_t* halo,
                                           int hstride, int c_base, int hc, int cin, int h, int w,
                                           int ty0, int tx0, const QScale&, int vec, int tid) {
  const int nv = hc >> 4, items = HALO_PIX * nv;
  for (int it = tid; it < items; it += NT) {
    const int hp = it / nv, cg = it - hp * nv, c = c_base + (cg << 4);
    const int src = halo_src(hp, ty0, tx0, h, w);
    int8_t* dst = halo + hp * hstride + (cg << 4);
    if (src >= 0 && c < cin && vec) {
      cp_async16(smem_u32(dst), xb + (long long)src * cin + c);
    } else {
      uint32_t q[4] = {0u, 0u, 0u, 0u};
      if (src >= 0 && c < cin) {
        const int8_t* p = xb + (long long)src * cin + c;
        const int n = min(16, cin - c);
#pragma unroll
        for (int j = 0; j < 16; ++j)
          if (j < n) q[j >> 2] |= (uint32_t)(uint8_t)p[j] << (8 * (j & 3));
      }
      *reinterpret_cast<uint4*>(dst) = make_uint4(q[0], q[1], q[2], q[3]);
    }
  }
  cp_async_wait_all();
}

// ---- the kernel -------------------------------------------------------------

// Named barriers: among the threads that stage the halo, and among the math
// warps only (the weight stream runs on beside both).
template <int NT>
__device__ __forceinline__ void stage_barrier() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(NT) : "memory");
}
__device__ __forceinline__ void math_barrier() {
  asm volatile("bar.sync 2, %0;\n" ::"n"(kMathThreads) : "memory");
}
// ... and among the math warps and the weight-stream warp, once both are done.
__device__ __forceinline__ void handover_barrier() {
  asm volatile("bar.sync 3, %0;\n" ::"n"(kMathThreads + 32) : "memory");
}

// ---- wgmma: D[64 x 64] += A[64 x 32] (registers) * B[32 x 64] (shared memory)

// Descriptor of a K-major operand without swizzle: core matrices of 8 rows x
// 16 bytes, each 128 contiguous bytes; the next 16 bytes of K are lbo bytes
// on, the next 8 rows sbo bytes on.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3ffffu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void wgmma_s8(int (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"  // scale-d: accumulate into d
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(1));
}

struct Ring {
  int slot = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void advance(int stages) {
    if (++slot == stages) slot = 0, phase ^= 1u;
  }
};

template <typename TIn, typename TOut, int SW>
__global__ void __launch_bounds__(threads_of(SW), SW == 8 ? 2 : 1)
    qconv3x3_kernel(const TIn* __restrict__ x, const int8_t* __restrict__ wp,
                    const float* __restrict__ sw, const float* __restrict__ sx,
                    const float* __restrict__ bias, const float* __restrict__ se,
                    TOut* __restrict__ out, int h, int w, int cin, int cin_pad, int cout,
                    int tiles_x, int tiles_per_lane, int stages, long long wp_block_bytes,
                    int relu, int vec) {
  extern __shared__ __align__(128) uint8_t smem[];
  float* s_scale = reinterpret_cast<float*>(smem + 128);
  float* s_bias = s_scale + BN;
  int8_t* halo = reinterpret_cast<int8_t*>(smem + HEAD_BYTES);
  const int hstride = min(cin_pad, HC) + PAD;
  uint8_t* ring = smem + HEAD_BYTES + HALO_PIX * hstride;
  const uint32_t bar_full = smem_u32(smem), bar_empty = bar_full + 8 * MAX_STAGES;
  const uint32_t ring_u32 = smem_u32(ring), halo_u32 = smem_u32(halo);

  const int tid = threadIdx.x, lane = tid & 31;
  // through a shuffle, so that the compiler knows the warp index (and every
  // branch on it around the wgmma instructions) to be uniform in the warp
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int b = blockIdx.x / tiles_per_lane, tile = blockIdx.x - b * tiles_per_lane;
  const int ty0 = (tile / tiles_x) * TH, tx0 = (tile % tiles_x) * TW;
  const int n0 = blockIdx.y * BN;
  const float sxb = sx[b];
  const TIn* xb = x + (long long)b * h * w * cin;

  if (warp == SW) {
    // ---- the weight stream: this warp never touches the halo.  It sets the
    // barriers up, prepares the epilogue's scale and bias, and then one lane
    // keeps up to `stages` slabs in flight until the last one is on its way.
    if (lane == 0) {
      for (int s = 0; s < stages; ++s) {
        mbar_init(bar_full + 8 * s, 1);
        mbar_init(bar_empty + 8 * s, kMathWarps);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    for (int i = lane; i < BN; i += 32) {
      const int n = n0 + i;
      s_scale[i] = n < cout ? __fmul_rn(sxb, sw[n]) : 0.0f;
      s_bias[i] = n < cout ? bias[n] : 0.0f;
    }
    if (lane == 0) {
      Ring rg;
      const int8_t* wsrc = wp + (long long)blockIdx.y * wp_block_bytes;
      for (int hb = 0; hb < cin_pad; hb += HC) {
        const int hc = min(HC, cin_pad - hb);
        for (int tap = 0; tap < 9; ++tap)
          for (int c0 = 0; c0 < hc; c0 += KC) {
            const uint32_t bytes = BN * min(KC, hc - c0);
            mbar_wait(bar_empty + 8 * rg.slot, rg.phase ^ 1u);
            mbar_expect_tx(bar_full + 8 * rg.slot, bytes);
            bulk_copy(ring_u32 + rg.slot * STAGE_BYTES, wsrc, bytes, bar_full + 8 * rg.slot);
            wsrc += bytes;
            rg.advance(stages);
          }
      }
    }
    // the epilogue's scale and bias are visible to the math warps
    handover_barrier();
    return;
  }

  // ---- the staging threads: warps 0-7 are the two math warpgroups, warps
  // 8-15 (where SW is 16) only help to stage the halo.
  __syncthreads();  // the barriers are set up
  const QScale qs = make_qscale(sxb);
  const int wg = warp >> 2, wm = warp & 3;  // warpgroup = K half, warp = tile row
  // ldmatrix row addresses of the A fragment (16 pixels of tile row wm x 32
  // channels): row = pixel column, 16-byte K half by lane >> 4
  const uint32_t a_base = halo_u32 +
                          (wm * HALO_W + (lane & 7) + ((lane >> 3) & 1) * 8) * hstride +
                          (lane >> 4) * 16;
  const uint64_t b_desc = smem_desc(ring_u32, KCHUNK_BYTES, CORE_BYTES);

  int acc[32] = {};  // [n8 tile][fragment]: rows g and g + 8 of tile row wm
  uint32_t af[2][2][4];  // A fragments: [stage parity][K step of mine in the stage]
  Ring rg;
  int kbase = 0, n_stage = 0, prev_slot = 0;

  for (int hb = 0; hb < cin_pad; hb += HC) {
    const int hc = min(HC, cin_pad - hb);
    if (hb > 0) stage_barrier<SW * 32>();  // every math warp is done with the previous halo block
    stage_halo<SW * 32>(xb, halo, hstride, hb, hc, cin, h, w, ty0, tx0, qs, vec, tid);
    stage_barrier<SW * 32>();
    if (warp >= kMathWarps) continue;

    for (int tap = 0; tap < 9; ++tap) {
      const int tap_off = ((tap / 3) * HALO_W + tap % 3) * hstride;
      for (int c0 = 0; c0 < hc; c0 += KC) {
        const int nk = min(KC, hc - c0) >> 5;
        // the warpgroups take alternate K steps of 32: of each pair of steps
        // in this stage, mine is the one at `off`
        const int off = (wg ^ kbase) & 1;
        const uint32_t as = a_base + tap_off + c0 + off * 32;
        const uint64_t bd = b_desc + ((rg.slot * STAGE_BYTES + off * 2 * KCHUNK_BYTES) >> 4);
        mbar_wait(bar_full + 8 * rg.slot, rg.phase);
        if (n_stage & 1) {
#pragma unroll
          for (int i = 0; i < 2; ++i)
            if (2 * i + off < nk) ldmatrix_x4(af[1][i], as + i * 64);
          wgmma_fence();
#pragma unroll
          for (int i = 0; i < 2; ++i)
            if (2 * i + off < nk) wgmma_s8(acc, af[1][i], bd + ((i * 4 * KCHUNK_BYTES) >> 4));
        } else {
#pragma unroll
          for (int i = 0; i < 2; ++i)
            if (2 * i + off < nk) ldmatrix_x4(af[0][i], as + i * 64);
          wgmma_fence();
#pragma unroll
          for (int i = 0; i < 2; ++i)
            if (2 * i + off < nk) wgmma_s8(acc, af[0][i], bd + ((i * 4 * KCHUNK_BYTES) >> 4));
        }
        wgmma_commit();
        // all but this stage's products are done: the previous stage is free
        wgmma_wait<1>();
        if (n_stage > 0 && lane == 0) mbar_arrive(bar_empty + 8 * prev_slot);
        prev_slot = rg.slot;
        kbase += nk;
        ++n_stage;
        rg.advance(stages);
      }
    }
    wgmma_wait<0>();  // the halo may be restaged, and the sums read
  }
  if (warp >= kMathWarps) return;

  // Add the two warpgroups' partial sums through the (now idle) ring: each
  // warp hands the 32 channels it does not finish to its partner warp.
  handover_barrier();
  int* xch = reinterpret_cast<int*>(ring);
  {
    int* mine = xch + (warp * 16) * 32 + lane;
#pragma unroll
    for (int i = 0; i < 16; ++i) mine[i * 32] = wg ? acc[i] : acc[16 + i];
  }
  math_barrier();

  const int* theirs = xch + ((warp ^ 4) * 16) * 32 + lane;
  const int g = lane >> 2, t4 = lane & 3;
  const int y = ty0 + wm;
  const QScale qe = make_qscale(se == nullptr ? 1.0f : se[b]);
  const bool even = (cout & 1) == 0;
  if (y >= h) return;
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    const int nl = (wg * 4 + jj) * 8 + t4 * 2, n = n0 + nl;
    const float sc0 = s_scale[nl], sc1 = s_scale[nl + 1];
    const float bi0 = s_bias[nl], bi1 = s_bias[nl + 1];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int xo = tx0 + g + half * 8, i0 = jj * 4 + half * 2;
      const int a0 = (wg ? acc[16 + i0] : acc[i0]) + theirs[i0 * 32];
      const int a1 = (wg ? acc[16 + i0 + 1] : acc[i0 + 1]) + theirs[(i0 + 1) * 32];
      if (xo < w && n < cout) {
        const float y0 = __fadd_rn(__fmul_rn(__int2float_rn(a0), sc0), bi0);
        const float y1 = __fadd_rn(__fmul_rn(__int2float_rn(a1), sc1), bi1);
        TOut* o = out + (((long long)b * h + y) * w + xo) * cout + n;
        store2(o, y0, y1, qe, relu, even, n + 1 < cout);
      }
    }
  }
}

// What the C entry point hands down to the typed launch.
struct Call {
  const void* x;
  const int8_t* wp;
  const float *sw, *sx, *bias, *se;
  void* out;
  int h, w, cin, cin_pad, cout, relu, vec;
  int threads, grid_x, grid_y, stages, smem_bytes;
  cudaStream_t stream;
};

template <typename TIn, typename TOut, int SW>
int launch(const Call& c) {
  const int tiles_x = (c.w + TW - 1) / TW, tiles_y = (c.h + TH - 1) / TH;
  auto kernel = qconv3x3_kernel<TIn, TOut, SW>;
  const cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, c.smem_bytes);
  if (rc != cudaSuccess) return (int)rc;
  const dim3 grid((unsigned)c.grid_x, (unsigned)c.grid_y);
  // the packed weights of one block of BN output channels: 9 taps x cin_pad
  kernel<<<grid, threads_of(SW), c.smem_bytes, c.stream>>>(
      (const TIn*)c.x, c.wp, c.sw, c.sx, c.bias, c.se, (TOut*)c.out, c.h, c.w, c.cin, c.cin_pad,
      c.cout, tiles_x, tiles_x * tiles_y, c.stages, 9LL * BN * c.cin_pad, c.relu, c.vec);
  return (int)cudaGetLastError();
}

template <typename TIn, typename TOut>
int launch_sw(const Call& c) {
  return c.threads == threads_of(16) ? launch<TIn, TOut, 16>(c) : launch<TIn, TOut, 8>(c);
}

template <typename TIn>
int launch_out(int out_kind, const Call& c) {
  switch (out_kind) {
    case 0: return launch_sw<TIn, __nv_bfloat16>(c);
    case 1: return launch_sw<TIn, float>(c);
    case 2: return launch_sw<TIn, int8_t>(c);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// in_kind: 0 int8 x (already quantized at sx), 1 bf16 x, 2 float32 x.
// out_kind: 0 bf16 y, 1 float32 y, 2 int8 at se[b] after an optional ReLU.
// x [lanes, h, w, cin] NHWC; wp the packed weights (see the head of this
// file; kernels/qconv.py::pack_weights3x3 writes them); sw, bias [cout];
// sx, se [lanes]; out [lanes, h, w, cout].  vec: x may be read as 16-byte
// vectors.  The launch plan (tile, threads, grid, ring stages, dynamic
// shared-memory bytes) comes from kernels/qconv.py::conv_plan and is checked
// against the kernel's constants here.  Returns a cudaError_t.
int qconv3x3(int in_kind, int out_kind, const void* x, const int8_t* wp, const float* sw,
             const float* sx, const float* bias, const float* se, void* out, int lanes, int h,
             int w, int cin, int cin_pad, int cout, int relu, int vec, int tile_h, int tile_w,
             int block_n, int threads, int grid_x, int grid_y, int stages, int smem_bytes,
             void* stream) {
  if (lanes == 0 || h == 0 || w == 0 || cout == 0) return (int)cudaGetLastError();
  const long long tiles = (long long)((w + TW - 1) / TW) * ((h + TH - 1) / TH);
  const int hstride = (cin_pad < HC ? cin_pad : HC) + PAD;
  const long long need =
      HEAD_BYTES + (long long)HALO_PIX * hstride + (long long)stages * STAGE_BYTES;
  // the ring later holds the sums one warpgroup hands to the other
  if (tile_h != TH || tile_w != TW || block_n != BN ||
      (threads != threads_of(8) && threads != threads_of(16)) ||
      cin_pad % 32 != 0 || cin > cin_pad || cin_pad - cin >= 32 ||
      stages * STAGE_BYTES < kMathThreads * 16 * 4 || stages > MAX_STAGES ||
      grid_x != lanes * tiles || grid_y != (cout + BN - 1) / BN || smem_bytes < need)
    return (int)cudaErrorInvalidValue;
  const Call c = {x, wp, sw, sx, bias, se, out, h, w, cin, cin_pad, cout, relu, vec,
                  threads, grid_x, grid_y, stages, smem_bytes, (cudaStream_t)stream};
  switch (in_kind) {
    case 0: return launch_out<int8_t>(out_kind, c);
    case 1: return launch_out<__nv_bfloat16>(out_kind, c);
    case 2: return launch_out<float>(out_kind, c);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* qconv_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
