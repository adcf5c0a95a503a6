// Tiled walk step on Hopper: temporal cutoff + biased pick + neighbour
// gather for tasks (tiles of node-sorted walk lanes) over staged rows of
// the node-ts view, one launch per hop of the tiled path, oversize lanes
// included.
//
// Replaces the Pallas TPU kernel of the JAX reference
// kernels/walk_step.py::walk_step_tiled (body _kernel, pallas_call at
// walk_step.py:175) together with the plain-jnp fallback that
// kernels/ops.py::walk_step runs for oversize lanes.
//
// What bounds it on an H100: memory latency, not arithmetic or bandwidth.
// A launch reads four or five 4-byte inputs and writes four int32 outputs
// per lane; a task stages at most 2·TE rows of ns_ts / ns_dst (8 bytes a
// row, 12 with the prefix row in weight mode), and an oversize lane reads
// ~log2(region) rows of ns_ts by binary search, one dependent load at a
// time.
//
// Design:
//   * Persistent CTAs, a few per SM, one thread per lane of a task, loop
//     over tasks with two staging buffers: while a CTA searches task t in
//     one buffer, the copy of task t + grid lands in the other.
//   * A task stages only what its lanes read: the rows [min lo, max hi] of
//     its in-tile lanes with a non-empty cutoff neighbourhood (n > 0 iff
//     the region's last timestamp exceeds the lane's time, since ns_ts
//     ascends in a region), widened to 16-byte bounds. A task with no such
//     lane (all oversize, empty or dead) stages nothing. One thread issues
//     the copy as 1-D bulk copies (cp.async.bulk into shared memory,
//     completion on an mbarrier); rows past the last whole 16 bytes of an
//     array are loaded by threads.
//   * In-tile lanes: the Pallas kernel's semantics bit for bit. The cutoff
//     is a binary search in shared memory (equal to the Pallas count,
//     because ns_ts ascends in a region); weight-mode picks stay counts over
//     [c, hi) (the linear S(j) is not provably monotone after rounding);
//     P(c), ts_c and P(hi) read 0 outside the panel as the one-hot sums do;
//     k is clipped to the panel [0, 2·TE − 1].
//   * Oversize lanes (kHop): the reference fallback, bit for bit, from
//     global memory: temporal_cutoff's search with midpoint (lo + hi) >> 1
//     (it stops at the region's end when the last timestamp is <= t), then
//     pick_in_neighborhood: the closed forms in index mode, the fixed-
//     midpoint searches of weighted_pick_exp / weighted_pick_linear in
//     weight mode with the [c, max(b − 1, c)] clamp. The same midpoints
//     give the same k even where S(j) is not monotone.
//   * kHop = false is walk_step_tiled's tile-local contract: every lane,
//     oversize lanes included, is served from the panel with the clipped
//     (lo, hi) the caller gives.
//   * One template instance per (mode, bias, kHop); each sets its shared
//     memory limit once.
//   * Float arithmetic is one correctly rounded operation at a time, in the
//     reference's order, so the outputs equal the plain PyTorch versions
//     (kernels/walk_step.py) bit for bit.
#include "bulk.cuh"
#include "samplers.cuh"

namespace {

using repro::bulk_copy;
using repro::bulk_end;
using repro::index_pick;
using repro::index_uniform;
using repro::mbar_expect;
using repro::mbar_init;
using repro::mbar_wait;
using repro::upper_bound;

constexpr int kBiasExponential = 2;
constexpr int kMaxThreads = 1024;     // one lane per thread: TW <= 1024
constexpr int kMaxWarps = kMaxThreads / 32;

// Weight-mode pick of the Pallas kernel over tile-local positions. px / ps
// are the rows P(base + j) / P(base + j + 1) of the bias's prefix.
template <int kBias>
__device__ __forceinline__ int tiled_weight_pick(const float* px,
                                                 const float* ps,
                                                 const int* ts, int P, int c,
                                                 int hi, int n, float u,
                                                 int tbase) {
  const float p_c = c < P ? px[c] : 0.0f;
  const float p_hi = hi > 0 ? ps[hi - 1] : 0.0f;
  if (kBias == kBiasExponential) {
    const float total = __fsub_rn(p_hi, p_c);
    if (!(total > 0.0f)) return c + index_uniform(u, n);
    const float target = __fadd_rn(p_c, __fmul_rn(u, total));
    int cnt = 0;
    for (int j = c; j < hi; ++j) cnt += ps[j] < target;
    return c + cnt;
  }
  if (kBias == repro::kBiasLinear) {
    const int ts_c = c < P ? ts[c] : 0;
    // int32 difference wraps, as it does in the reference
    const float delta = __int2float_rn(static_cast<int>(
        static_cast<unsigned>(ts_c) - static_cast<unsigned>(tbase)));
    const float total = __fsub_rn(__fsub_rn(p_hi, p_c),
                                  __fmul_rn(__int2float_rn(hi - c), delta));
    if (!(total > 0.0f)) return c + index_uniform(u, n);
    const float target = __fmul_rn(u, total);
    int cnt = 0;
    for (int j = c; j < hi; ++j) {
      const float s = __fsub_rn(__fsub_rn(ps[j], p_c),
                                __fmul_rn(__int2float_rn(j + 1 - c), delta));
      cnt += s < target;
    }
    return c + cnt;
  }
  return c + index_uniform(u, n);
}

// pick_in_neighborhood over global positions [c, b) of a region, weight
// mode: the reference's fixed-midpoint searches over the prefix row pre
// (length E + 1), clamped into [c, max(b − 1, c)].
template <int kBias>
__device__ __forceinline__ int global_weight_pick(const float* pre,
                                                  const int* ns_ts, int E,
                                                  int c, int b, float u,
                                                  int tbase) {
  const int n = b - c;
  const int fb = c + index_uniform(u, n);
  int k = fb;
  if (kBias == kBiasExponential) {
    const float p_c = pre[c];
    const float total = __fsub_rn(pre[b], p_c);
    const float target = __fadd_rn(p_c, __fmul_rn(u, total));
    if (total > 0.0f) {
      int lo = c, hi = b;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (pre[mid + 1] >= target) hi = mid; else lo = mid + 1;
      }
      k = lo;
    }
  } else if (kBias == repro::kBiasLinear) {
    const int ts_c = ns_ts[c < E - 1 ? c : E - 1];
    const float delta = __int2float_rn(static_cast<int>(
        static_cast<unsigned>(ts_c) - static_cast<unsigned>(tbase)));
    const float pl_c = pre[c];
    const float total = __fsub_rn(__fsub_rn(pre[b], pl_c),
                                  __fmul_rn(__int2float_rn(n), delta));
    const float r = __fmul_rn(u, total);
    if (total > 0.0f) {
      int lo = c, hi = b;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        const float s = __fsub_rn(
            __fsub_rn(pre[mid + 1], pl_c),
            __fmul_rn(__int2float_rn(mid + 1 - c), delta));
        if (s >= r) hi = mid; else lo = mid + 1;
      }
      k = lo;
    }
  }
  const int kmax = b - 1 > c ? b - 1 : c;
  return k < c ? c : (k > kmax ? kmax : k);
}

// One lane's inputs, held from its task's staging to its search.
struct Lane {
  int lo, hi;        // tile-local region (kHop: unclipped)
  int time;
  float u;
  int tbase;         // read in weight/linear only
  bool over;         // kHop: served from global memory
  bool need;         // in-tile with n > 0: reads the staged rows
};

// One task's staged rows: global row g0 sits at buffer row 0.
struct Staged {
  long long base;    // global row of panel position 0
  long long g0;
  bool wait;         // a bulk copy was issued into this buffer
};

struct Buffers {
  int* ts;
  int* dst;
  float* pre;
};

template <bool kWeight, int kBias, bool kHop>
__global__ void __launch_bounds__(kMaxThreads)
walk_step_kernel(const int* __restrict__ base_blocks,
                 const int* __restrict__ x_in, const int* __restrict__ y_in,
                 const int* __restrict__ time, const float* __restrict__ u,
                 const int* __restrict__ tbase,
                 const int* __restrict__ ns_ts,
                 const int* __restrict__ ns_dst,
                 const float* __restrict__ pre, int T, int TW, int TE, int E,
                 int rows, int* __restrict__ k_out, int* __restrict__ n_out,
                 int* __restrict__ dst_out, int* __restrict__ ts_out) {
  extern __shared__ __align__(16) int smem[];
  __shared__ __align__(8) uint64_t s_bar[2];
  __shared__ int s_min[kMaxWarps];
  __shared__ int s_max[kMaxWarps];
  const int P = 2 * TE;
  const int tid = threadIdx.x;
  const int nwarps = (blockDim.x + 31) >> 5;
  const int arrays = kWeight ? 3 : 2;

  Buffers buf[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    int* b0 = smem + s * arrays * rows;
    buf[s].ts = b0;
    buf[s].dst = b0 + rows;
    buf[s].pre = reinterpret_cast<float*>(b0 + 2 * rows);
  }
  if (tid == 0) {
    mbar_init(&s_bar[0]);
    mbar_init(&s_bar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // Load task t's lane inputs, vote, and start the copy of its rows into
  // buffer s. Every thread calls it (it holds a barrier); t >= T stages
  // nothing.
  auto stage = [&](int t, int s, Lane& ln) -> Staged {
    Staged st{0, 0, false};
    ln.need = ln.over = false;
    ln.tbase = 0;
    int mn = P, mx = 0;
    if (t < T && tid < TW) {
      st.base = static_cast<long long>(base_blocks[t]) * TE;
      const long long lane = static_cast<long long>(t) * TW + tid;
      const int x = x_in[lane], y = y_in[lane];
      ln.time = time[lane];
      if (kHop) {
        ln.lo = static_cast<int>(x - st.base);
        ln.hi = static_cast<int>(y - st.base);
        ln.over = ln.lo < 0 || ln.hi > P;
      } else {
        ln.lo = x;
        ln.hi = y;
      }
      ln.need = !ln.over && ln.hi > ln.lo &&
                ns_ts[st.base + ln.hi - 1] > ln.time;
      if (ln.need) {
        mn = ln.lo;
        mx = ln.hi;
      }
    } else if (t < T) {
      st.base = static_cast<long long>(base_blocks[t]) * TE;
    }
    mn = __reduce_min_sync(0xffffffffu, mn);
    mx = __reduce_max_sync(0xffffffffu, mx);
    if ((tid & 31) == 0) {
      s_min[tid >> 5] = mn;
      s_max[tid >> 5] = mx;
    }
    if (__syncthreads_or(ln.need)) {
      for (int w = 0; w < nwarps; ++w) {
        mn = min(mn, s_min[w]);
        mx = max(mx, s_max[w]);
      }
      // rows [base + mn, base + mx] are read: ts/dst up to the panel's last
      // row, the prefix up to P(hi) of the widest lane
      st.g0 = (st.base + mn) & ~3ll;
      const long long end_rows = st.base + min(mx + 1, P);
      const long long end_pre = st.base + mx + 1;
      const long long bulk_rows = bulk_end(end_rows, E);
      const long long bulk_pre = bulk_end(end_pre, E + 1ll);
      const uint32_t bytes_rows = static_cast<uint32_t>(bulk_rows - st.g0) * 4;
      const uint32_t bytes_pre =
          kWeight ? static_cast<uint32_t>(bulk_pre - st.g0) * 4 : 0;
      st.wait = bytes_rows + bytes_pre > 0;
      if (tid == 0 && st.wait) {
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        mbar_expect(&s_bar[s], 2 * bytes_rows + bytes_pre);
        if (bytes_rows) {
          bulk_copy(buf[s].ts, ns_ts + st.g0, bytes_rows, &s_bar[s]);
          bulk_copy(buf[s].dst, ns_dst + st.g0, bytes_rows, &s_bar[s]);
        }
        if (kWeight && bytes_pre)
          bulk_copy(buf[s].pre, pre + st.g0, bytes_pre, &s_bar[s]);
      }
      // the rows past the last whole 16 bytes of an array
      if (tid < end_rows - bulk_rows) {
        const long long g = bulk_rows + tid;
        buf[s].ts[g - st.g0] = ns_ts[g];
        buf[s].dst[g - st.g0] = ns_dst[g];
      }
      if (kWeight && tid < end_pre - bulk_pre) {
        const long long g = bulk_pre + tid;
        buf[s].pre[g - st.g0] = pre[g];
      }
    }
    // while the copy is in flight
    if (t < T && tid < TW) {
      const long long lane = static_cast<long long>(t) * TW + tid;
      ln.u = u[lane];
      if (kBias == repro::kBiasLinear && kWeight) ln.tbase = tbase[lane];
    }
    return st;
  };

  // Search task t from buffer s and write its lanes' outputs.
  auto serve = [&](int t, int s, const Lane& ln, const Staged& st,
                   uint32_t parity) {
    if (t >= T || tid >= TW) return;
    const long long lane = static_cast<long long>(t) * TW + tid;
    const float uu = ln.u;
    int k = 0, n = 0, d = 0, tt = 0;
    if (kHop && ln.over) {
      // the reference fallback over the global region [a, b)
      const int a = static_cast<int>(st.base + ln.lo);
      const int b = static_cast<int>(st.base + ln.hi);
      int c = b;
      if (b > a && ns_ts[b - 1] > ln.time) {
        int lo = a, hi = b;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (ns_ts[mid] > ln.time) hi = mid; else lo = mid + 1;
        }
        c = lo;
      }
      n = b - c;
      if (kWeight)
        k = global_weight_pick<kBias>(pre, ns_ts, E, c, b, uu, ln.tbase);
      else
        k = c + index_pick(kBias, uu, n);
      if (n > 0) {
        d = ns_dst[k];
        tt = ns_ts[k];
      }
    } else if (ln.need) {
      if (st.wait) mbar_wait(&s_bar[s], parity);
      const long long off = st.base - st.g0;
      const int* s_ts = buf[s].ts + off;
      const int* s_dst = buf[s].dst + off;
      const int c = upper_bound(s_ts, ln.lo, ln.hi, ln.time);
      n = ln.hi - c;
      if (kWeight) {
        const float* px = buf[s].pre + off;
        k = tiled_weight_pick<kBias>(px, px + 1, s_ts, P, c, ln.hi, n, uu,
                                     ln.tbase);
      } else {
        k = c + index_pick(kBias, uu, n);
      }
      k = k < 0 ? 0 : (k > P - 1 ? P - 1 : k);
      d = s_dst[k];
      tt = s_ts[k];
      if (kHop) k = static_cast<int>(st.base + k);
    } else if (kHop) {
      k = static_cast<int>(st.base);   // n == 0: the panel's k = 0
    }
    k_out[lane] = k;
    n_out[lane] = n;
    dst_out[lane] = d;
    ts_out[lane] = tt;
  };

  uint32_t phase = 0;     // bit s: parity of buffer s's next completion
  int s = 0;
  Lane cur, nxt;
  int t = blockIdx.x;
  Staged st_cur = stage(t, 0, cur);
  __syncthreads();        // every thread has read s_min / s_max
  for (; t < T; t += gridDim.x) {
    const Staged st_nxt = stage(t + gridDim.x, s ^ 1, nxt);
    serve(t, s, cur, st_cur, (phase >> s) & 1u);
    if (st_cur.wait) phase ^= 1u << s;
    __syncthreads();      // buffer s is free for the task after next
    cur = nxt;
    st_cur = st_nxt;
    s ^= 1;
  }
}

struct Launch {
  int blocks_per_sm = -1;
  int smem = -1;
  int threads = -1;
};

template <bool kWeight, int kBias, bool kHop>
cudaError_t launch(const int* base_blocks, const int* x, const int* y,
                   const int* time, const float* u, const int* tbase,
                   const int* ns_ts, const int* ns_dst, const float* pre,
                   int W, int TW, int TE, int E, int* k_out, int* n_out,
                   int* dst_out, int* ts_out, cudaStream_t stream) {
  auto* kernel = walk_step_kernel<kWeight, kBias, kHop>;
  static bool attr_set = false;
  static Launch last;
  static int sms = 0;
  if (!attr_set) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   dev);
    int optin = 0;
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    cudaFuncAttributes fa;
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, kernel);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          optin - static_cast<int>(fa.sharedSizeBytes));
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const int T = W / TW;
  const int threads = (TW + 31) / 32 * 32;
  // rows of one staged array: the panel, plus 16-byte widening at both
  // ends and the prefix row P(2·TE)
  const int rows = (2 * TE + 8 + 3) / 4 * 4;
  const int smem = 2 * (kWeight ? 3 : 2) * rows * 4;
  if (smem != last.smem || threads != last.threads) {
    int per_sm = 0;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, threads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    last = Launch{per_sm, smem, threads};
  }
  const long long grid_cap = static_cast<long long>(sms) * last.blocks_per_sm;
  const int grid = static_cast<int>(T < grid_cap ? T : grid_cap);
  kernel<<<grid, threads, smem, stream>>>(
      base_blocks, x, y, time, u, tbase, ns_ts, ns_dst, pre, T, TW, TE, E,
      rows, k_out, n_out, dst_out, ts_out);
  return cudaGetLastError();
}

using Launcher = cudaError_t (*)(const int*, const int*, const int*,
                                 const int*, const float*, const int*,
                                 const int*, const int*, const float*, int,
                                 int, int, int, int*, int*, int*, int*,
                                 cudaStream_t);

// [hop][weight][bias]: bias codes 0 uniform, 1 linear, 2 exponential
constexpr Launcher kLaunchers[2][2][3] = {
    {{launch<false, 0, false>, launch<false, 1, false>,
      launch<false, 2, false>},
     {launch<true, 0, false>, launch<true, 1, false>,
      launch<true, 2, false>}},
    {{launch<false, 0, true>, launch<false, 1, true>, launch<false, 2, true>},
     {launch<true, 0, true>, launch<true, 1, true>, launch<true, 2, true>}},
};

}  // namespace

// hop = 0: walk_step_tiled, x / y are tile-local (lo, hi) in [0, 2·TE],
// outputs tile-local. hop = 1: walk_step_hop, x / y are the global region
// (a, b), outputs global, oversize lanes served too. pre is the bias's
// prefix row of length E + 1 (weight mode; 16-byte aligned like ns_ts and
// ns_dst); tbase is read in weight/linear only.
REPRO_API int repro_walk_step(int hop, int weight, int bias,
                              const int* base_blocks, const int* x,
                              const int* y, const int* time, const float* u,
                              const int* tbase, const int* ns_ts,
                              const int* ns_dst, const float* pre, int W,
                              int TW, int TE, int E, int* k_out, int* n_out,
                              int* dst_out, int* ts_out, void* stream) {
  if (hop < 0 || hop > 1 || weight < 0 || weight > 1 || bias < 0 ||
      bias > 2 || TW <= 0 || TW > kMaxThreads || TE <= 0 || W % TW != 0 ||
      E < 2 * TE)
    return static_cast<int>(cudaErrorInvalidValue);
  if (W == 0) return 0;
  return static_cast<int>(kLaunchers[hop][weight][bias](
      base_blocks, x, y, time, u, tbase, ns_ts, ns_dst, pre, W, TW, TE, E,
      k_out, n_out, dst_out, ts_out, static_cast<cudaStream_t>(stream)));
}
