// Native host-side event ops of bmcnet_esr_torch (a copy of the JAX
// package's native/eventops.cpp, kept here so the port needs nothing of it).
//
// The reference calls an absent Cython module `c_event_redistribute`
// (dataloader/encodings.py:467-485) as the fast path for stack->event-cloud
// redistribution, falling back to a slow pure-Python loop
// (encodings.py:367-464).  This is the native implementation, plus a
// host-side count rasterizer.
//
// Exposed through a plain C ABI and loaded with ctypes.  Built by
// bmcnet_esr_torch/kernels/_build.py::load_host_library (c++ -O3 -shared
// -fPIC -std=c++17) at first use; loaded by bmcnet_esr_torch/native.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <random>
#include <vector>

extern "C" {

// Count redistribution output sizes.
//
// stack: [B, C, Y, X] row-major (no-polarity) or [B, P, C, Y, X] with
// `polarity_layout=1` (P folded into the leading strides by the caller:
// we treat the polarity case as [B, P*C*Y*X] with bin index recovered from
// the C dimension).  Values are rounded; each cell of magnitude m emits m
// events.  Returns per-batch event counts in `counts` (int64[B]).
void redistribute_count(const float* stack, int64_t b, int64_t p, int64_t c,
                        int64_t y, int64_t x, int64_t* counts) {
  const int64_t per_batch = p * c * y * x;
  for (int64_t bi = 0; bi < b; ++bi) {
    const float* base = stack + bi * per_batch;
    int64_t total = 0;
    for (int64_t i = 0; i < per_batch; ++i) {
      total += static_cast<int64_t>(std::fabs(std::nearbyint(base[i])));
    }
    counts[bi] = total == 0 ? 1 : total;  // empty batches emit one zero event
  }
}

// Fill redistributed event clouds.
//
// out: [B, maxlen, 4] (x, y, t, p) zero-initialized by the caller;
// maxlen must be >= max(counts).  mode: 0 = linear timestamps, 1 = random.
// Timestamps for bin ci span (ci/C + 1/(100C), (ci+1)/C] like the reference
// (encodings.py:392-394); events are emitted in (p, c, y, x) cell order and
// then stably sorted by timestamp per batch (encodings.py:398).
void redistribute_fill(const float* stack, int64_t b, int64_t p, int64_t c,
                       int64_t y, int64_t x, int mode, uint64_t seed,
                       int64_t maxlen, float* out) {
  const int64_t per_batch = p * c * y * x;
  const int64_t plane = y * x;

  for (int64_t bi = 0; bi < b; ++bi) {
    const float* base = stack + bi * per_batch;
    std::mt19937_64 rng(seed + static_cast<uint64_t>(bi));
    std::uniform_real_distribution<double> uni(0.0, 1.0);

    struct Ev {
      float xx, yy, tt, pp;
    };
    std::vector<Ev> events;
    events.reserve(1024);

    for (int64_t pi = 0; pi < p; ++pi) {
      for (int64_t ci = 0; ci < c; ++ci) {
        const float* bin = base + (pi * c + ci) * plane;
        const double t0 = static_cast<double>(ci) / c + 1.0 / (100.0 * c);
        const double t1 = static_cast<double>(ci + 1) / c;
        for (int64_t yi = 0; yi < y; ++yi) {
          for (int64_t xi = 0; xi < x; ++xi) {
            const float v = std::nearbyint(bin[yi * x + xi]);
            const int64_t m = static_cast<int64_t>(std::fabs(v));
            if (m == 0) continue;
            const float pol = v > 0 ? 1.0f : -1.0f;
            for (int64_t k = 0; k < m; ++k) {
              double t;
              if (mode == 0) {
                t = m == 1 ? t0 : t0 + (t1 - t0) * (static_cast<double>(k) / (m - 1));
              } else {
                t = t0 + (t1 - t0) * uni(rng);
              }
              events.push_back({static_cast<float>(xi), static_cast<float>(yi),
                                static_cast<float>(t), pol});
            }
          }
        }
      }
    }

    std::stable_sort(events.begin(), events.end(),
                     [](const Ev& a, const Ev& b2) { return a.tt < b2.tt; });

    float* dst = out + bi * maxlen * 4;
    const int64_t n = std::min<int64_t>(events.size(), maxlen);
    for (int64_t i = 0; i < n; ++i) {
      dst[i * 4 + 0] = events[i].xx;
      dst[i * 4 + 1] = events[i].yy;
      dst[i * 4 + 2] = events[i].tt;
      dst[i * 4 + 3] = events[i].pp;
    }
  }
}

// Fast host-side 2-channel count rasterization with the reference semantics:
// y flip, OOB events dropped-as-zero, polarity squared into positive counts
// (encodings.py:241-305).  img: [2, H, W] zero-initialized by caller.
void rasterize_counts(const float* xs, const float* ys, const float* ps,
                      int64_t n, int64_t h, int64_t w, float* img) {
  for (int64_t i = 0; i < n; ++i) {
    const float xf = xs[i];
    const float yf = ys[i];
    const float p = ps[i];
    if (p == 0.0f) continue;
    if (xf < 0 || xf >= static_cast<float>(w) || yf < 0 ||
        yf >= static_cast<float>(h))
      continue;
    const int64_t xi = static_cast<int64_t>(xf);
    const int64_t yi = h - 1 - static_cast<int64_t>(yf);
    const int64_t chan = p < 0 ? 1 : 0;
    img[chan * h * w + yi * w + xi] += p * p;
  }
}

}  // extern "C"
