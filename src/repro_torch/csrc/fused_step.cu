// Fused walk step on Hopper: the whole hop of path="fused" in one launch,
// fused_hop — per lane the node's region, the tier split, the temporal
// cutoff, the per-lane biased draw (int32 bias code) and the neighbour
// gather, plus the reference's `tiers` statistic.
//
// Replaces the two Pallas TPU kernels of the JAX reference
// kernels/fused_step.py::fused_walk_step, and the tier split of its
// wrapper:
//   * tier S (_small_kernel_index / _small_kernel_weight, pallas_call at
//     fused_step.py:406);
//   * tier L (_big_kernel_index / _big_kernel_weight, pallas_call at
//     fused_step.py:450).
//
// What bounds it on an H100: memory latency and the random gathers, not
// arithmetic. A lane reads ~24 bytes (s_node, time, u, code and its node's
// two region bounds) and writes 16; the rest is a chain of dependent loads:
// s_node -> node_starts -> the region's last timestamp -> the cutoff
// search -> the picked row. On a late hop almost every lane is dead and
// stops after the third load.
//
// Design:
//   * One CTA per walk tile of TW lanes, one thread per lane; many small
//     CTAs per SM overlap one tile's loads with another's searches. (A
//     persistent, double-buffered loop over tiles measured slower: tiles
//     that hold hub lanes take far longer than dead tiles, and a static
//     tile order left CTAs waiting on them; PERF.md.)
//   * The tile's anchor, base = clip(min(a) // TE, 0, E // TE − 2)·TE over
//     all its lanes (dead ones included), and the tier split, tier L iff
//     a − base < 0 or b − base > 2·TE, are computed in the kernel, as is
//     tiers = [tier-S lanes, tier-L lanes, Σ over tiles with a tier-L lane
//     of bhi − blo + 1], added per tile with integer atomics (the same
//     result in any order).
//   * A lane with n == 0 — a == b, or the region's last timestamp <= t,
//     since ns_ts ascends inside a region — writes (0, min(b − a, 0), 0, 0)
//     after that one load. Dead walks keep their node and time, so most
//     lanes of a late hop are such lanes.
//   * Tier S stages only what its live lanes read: rows [min a, max b) of
//     ns_ts / ns_dst over the tile's live tier-S lanes, and the prefix rows
//     one further (for P(b)) in weight mode, by bulk copy (bulk.cuh). A
//     tile with no live tier-S lane stages nothing. A lane's cutoff is a
//     binary search in shared memory, its weight-mode pick a count
//     (weight_pick<false>), k = position of the pick in the view.
//   * A live tier-L lane is served by its own thread from global memory:
//     a binary search for the cutoff and, in weight mode, a lower-bound
//     binary search for the exponential pick (weight_pick<true>), exact
//     because ns_ts ascends in a region and the port's pexp is
//     non-decreasing (kernels/weight_prefix.py). Lanes at one hub share
//     their first probes in cache. (Warps serving one queued lane at a
//     time with 32-ary searches measured no faster on the main path's
//     hops; PERF.md.) The weight/linear pick stays a count over [c, b):
//     S(j) is not provably monotone after rounding.
//   * Float arithmetic is one correctly rounded operation at a time
//     (samplers.cuh), so k, n, dst and ts equal the plain PyTorch version
//     (kernels/fused_step.py::fused_step_plain) bit for bit.
#include "bulk.cuh"
#include "samplers.cuh"

namespace {

using repro::bulk_copy;
using repro::bulk_end;
using repro::index_pick;
using repro::mbar_expect;
using repro::mbar_init;
using repro::mbar_wait;
using repro::upper_bound;
using repro::weight_pick;

constexpr int kMaxThreads = 1024;     // one lane per thread: TW <= 1024
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kIntMax = 0x7fffffff;

// Per-tile reductions, one slot per warp.
enum { kAmin, kLo, kHi, kBlo, kBhi, kNbig, kReductions };

template <bool kWeight>
__global__ void __launch_bounds__(kMaxThreads)
fused_hop_kernel(const int* __restrict__ s_node, const int* __restrict__ time,
                 const float* __restrict__ u, const int* __restrict__ code,
                 const int* __restrict__ node_starts,
                 const int* __restrict__ node_tbase,
                 const int* __restrict__ ns_ts,
                 const int* __restrict__ ns_dst,
                 const float* __restrict__ pexp,
                 const float* __restrict__ plin, int TW, int TE, int E,
                 int nc, int rows, int* __restrict__ k_out,
                 int* __restrict__ n_out, int* __restrict__ dst_out,
                 int* __restrict__ ts_out, int* __restrict__ tiers) {
  extern __shared__ __align__(16) int smem[];
  __shared__ __align__(8) uint64_t s_bar;
  __shared__ int s_red[kReductions][kMaxWarps];
  const int P = 2 * TE;
  const int MAXB = E / TE;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  // staged rows: global row g0 sits at row 0
  int* s_ts = smem;
  int* s_dst = smem + rows;
  float* s_pe = reinterpret_cast<float*>(smem + 2 * rows);
  float* s_pl = reinterpret_cast<float*>(smem + 3 * rows);

  const long long lane = static_cast<long long>(blockIdx.x) * TW + tid;
  const bool in = tid < TW;
  const int node = in ? s_node[lane] : 0;
  const int tm = in ? time[lane] : 0;
  const int v = min(max(node, 0), nc);
  const int a = in ? node_starts[v] : kIntMax;
  const int b = in ? node_starts[v + 1] : kIntMax;

  // ---- anchor, tier split, one load for n > 0
  const int last = in && a < b ? ns_ts[b - 1] : 0;
  const int amin = __reduce_min_sync(kFull, a);
  if ((tid & 31) == 0) s_red[kAmin][warp] = amin;
  if (tid == 0) {
    mbar_init(&s_bar);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  int mn = kIntMax, mx = 0;           // live tier-S rows
  int blo = MAXB - 1, bhi = 0;        // tier-L blocks, as the reference
  bool big = false, live = false;
  if (in) {
    int a0 = s_red[kAmin][0];
    for (int w = 1; w < nwarps; ++w) a0 = min(a0, s_red[kAmin][w]);
    const int base = min(max(a0 / TE, 0), MAXB - 2) * TE;
    big = a - base < 0 || b - base > P;
    live = a < b && last > tm;
    if (big) {
      blo = a / TE;
      bhi = max(b - 1, a) / TE;
    } else if (live) {
      mn = a;
      mx = b;
    }
  }
  mn = __reduce_min_sync(kFull, mn);
  mx = __reduce_max_sync(kFull, mx);
  blo = __reduce_min_sync(kFull, blo);
  bhi = __reduce_max_sync(kFull, bhi);
  const int nbig = __popc(__ballot_sync(kFull, big));
  if ((tid & 31) == 0) {
    s_red[kLo][warp] = mn;
    s_red[kHi][warp] = mx;
    s_red[kBlo][warp] = blo;
    s_red[kBhi][warp] = bhi;
    s_red[kNbig][warp] = nbig;
  }
  if (in && !live) {                  // n == 0: done after one load
    k_out[lane] = 0;
    n_out[lane] = min(b - a, 0);
    dst_out[lane] = 0;
    ts_out[lane] = 0;
  }
  float uu = 0.0f;
  int cd = 0, tb = 0;
  if (live) {
    uu = u[lane];
    cd = code[lane];
    if (kWeight) tb = node_tbase[min(max(node, 0), nc - 1)];
  }
  __syncthreads();
  for (int w = 0; w < nwarps; ++w) {
    mn = min(mn, s_red[kLo][w]);
    mx = max(mx, s_red[kHi][w]);
  }
  if (tid == 0) {
    int big_t = 0;
    for (int w = 0; w < nwarps; ++w) {
      big_t += s_red[kNbig][w];
      blo = min(blo, s_red[kBlo][w]);
      bhi = max(bhi, s_red[kBhi][w]);
    }
    atomicAdd(&tiers[0], TW - big_t);
    if (big_t > 0) {
      atomicAdd(&tiers[1], big_t);
      atomicAdd(&tiers[2], max(bhi, blo) - blo + 1);
    }
  }

  // ---- tier S: rows [mn, mx) of ns_ts / ns_dst, prefix rows [mn, mx]
  if (mx > 0) {
    const int g0 = mn & ~3;
    const int bulk_rows = static_cast<int>(bulk_end(mx, E));
    const int bulk_pre = static_cast<int>(bulk_end(mx + 1ll, E + 1ll));
    const uint32_t bytes_rows = static_cast<uint32_t>(bulk_rows - g0) * 4;
    const uint32_t bytes_pre =
        kWeight ? static_cast<uint32_t>(bulk_pre - g0) * 4 : 0;
    const bool wait = bytes_rows + bytes_pre > 0;
    if (tid == 0 && wait) {
      mbar_expect(&s_bar, 2 * bytes_rows + 2 * bytes_pre);
      if (bytes_rows) {
        bulk_copy(s_ts, ns_ts + g0, bytes_rows, &s_bar);
        bulk_copy(s_dst, ns_dst + g0, bytes_rows, &s_bar);
      }
      if (kWeight && bytes_pre) {
        bulk_copy(s_pe, pexp + g0, bytes_pre, &s_bar);
        bulk_copy(s_pl, plin + g0, bytes_pre, &s_bar);
      }
    }
    // the rows past the last whole 16 bytes of an array
    if (tid < mx - bulk_rows) {
      const int g = bulk_rows + tid;
      s_ts[g - g0] = ns_ts[g];
      s_dst[g - g0] = ns_dst[g];
    }
    if (kWeight && tid < mx + 1 - bulk_pre) {
      const int g = bulk_pre + tid;
      s_pe[g - g0] = pexp[g];
      s_pl[g - g0] = plin[g];
    }
    __syncthreads();    // tail rows written
    if (live && !big) {
      if (wait) mbar_wait(&s_bar, 0);
      const int lo = a - g0;
      const int hi = b - g0;
      const int c = upper_bound(s_ts, lo, hi, tm);
      const int n = hi - c;
      const int kl =
          kWeight ? weight_pick<false>(s_pe, s_pl, s_ts, c, hi, n, uu, cd, tb)
                  : c + index_pick(cd, uu, n);
      k_out[lane] = g0 + kl;
      n_out[lane] = n;
      dst_out[lane] = s_dst[kl];
      ts_out[lane] = s_ts[kl];
    }
  }

  // ---- tier L: the lane's own thread, from global memory. Live, so
  // ns_ts[b − 1] > t and the cutoff lies in [a, b − 1].
  if (live && big) {
    const int c = upper_bound(ns_ts, a, b - 1, tm);
    const int n = b - c;
    const int k =
        kWeight ? weight_pick<true>(pexp, plin, ns_ts, c, b, n, uu, cd, tb)
                : c + index_pick(cd, uu, n);
    k_out[lane] = k;
    n_out[lane] = n;
    dst_out[lane] = ns_dst[k];
    ts_out[lane] = ns_ts[k];
  }
}

template <bool kWeight>
cudaError_t launch(const int* s_node, const int* time, const float* u,
                   const int* code, const int* node_starts,
                   const int* node_tbase, const int* ns_ts, const int* ns_dst,
                   const float* pexp, const float* plin, int W, int TW,
                   int TE, int E, int nc, int* k_out, int* n_out,
                   int* dst_out, int* ts_out, int* tiers,
                   cudaStream_t stream) {
  auto* kernel = fused_hop_kernel<kWeight>;
  static bool attr_set = false;
  if (!attr_set) {
    int dev = 0, optin = 0;
    cudaError_t err = cudaGetDevice(&dev);
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
  const int threads = (TW + 31) / 32 * 32;
  // rows of one staged array: a tier-S span lies in the tile's 2·TE panel,
  // plus 16-byte widening at both ends and the prefix row P(b)
  const int rows = (2 * TE + 8 + 3) / 4 * 4;
  const int smem = (kWeight ? 4 : 2) * rows * 4;
  kernel<<<W / TW, threads, smem, stream>>>(
      s_node, time, u, code, node_starts, node_tbase, ns_ts, ns_dst, pexp,
      plin, TW, TE, E, nc, rows, k_out, n_out, dst_out, ts_out, tiers);
  return cudaGetLastError();
}

}  // namespace

// One fused hop over W = T·TW node-sorted lanes, one CTA per tile of TW.
// node_starts holds nc + 2 rows, node_tbase nc; ns_ts / ns_dst E rows and
// pexp / plin E + 1 rows, 16-byte aligned (pexp, plin and node_tbase are
// read in weight mode only). tiers (int32[3]) must be zero
// on entry: the kernel adds this hop's counts to it.
REPRO_API int repro_fused_hop(int weight, const int* s_node, const int* time,
                              const float* u, const int* code,
                              const int* node_starts, const int* node_tbase,
                              const int* ns_ts, const int* ns_dst,
                              const float* pexp, const float* plin, int W,
                              int TW, int TE, int E, int nc, int* k_out,
                              int* n_out, int* dst_out, int* ts_out,
                              int* tiers, void* stream) {
  if (weight < 0 || weight > 1 || TW <= 0 || TW > kMaxThreads || TE <= 0 ||
      W % TW != 0 || E % TE != 0 || E / TE < 2 || nc < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (W == 0) return 0;
  auto* run = weight ? launch<true> : launch<false>;
  return static_cast<int>(run(s_node, time, u, code, node_starts, node_tbase,
                              ns_ts, ns_dst, pexp, plin, W, TW, TE, E, nc,
                              k_out, n_out, dst_out, ts_out, tiers,
                              static_cast<cudaStream_t>(stream)));
}

REPRO_API const char* repro_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
