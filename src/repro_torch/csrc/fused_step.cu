// Fused walk step on Hopper: temporal cutoff + per-lane biased draw +
// neighbour gather, one launch per tier and hop.
//
// Replaces the two Pallas TPU kernels of the JAX reference
// kernels/fused_step.py::fused_walk_step:
//   * tier S (_small_kernel_index / _small_kernel_weight, pallas_call at
//     fused_step.py:406) -> fused_tier_s_kernel;
//   * tier L (_big_kernel_index / _big_kernel_weight, pallas_call at
//     fused_step.py:450) -> fused_tier_l_kernel.
//
// What bounds it on an H100: memory latency, not bandwidth or arithmetic.
// A hop moves ~40 bytes per lane (six per-lane inputs, four outputs) plus
// the picked edge row, and each lane's cutoff is a data-dependent search
// over its node's region. The work per lane is a few dozen integer/float
// operations.
//
// Design:
//   * Tier S is one CTA per walk tile of tile_walks lanes (lanes arrive
//     grouped by node, so a tile's regions sit inside one 2·tile_edges
//     panel of the node-ts view). The CTA stages the panel — ns_ts and
//     ns_dst, plus the pexp / plin prefix rows in weight mode — in shared
//     memory (16 KB, or ~32 KB in weight mode, at tile_edges = 1024), so
//     every search probe and every weight-mode count is a shared-memory
//     read. One thread per lane.
//   * Tier L lanes are those whose region does not fit the tile's panel
//     (hubs). The Pallas kernel swept the union of the tile's blocks on a
//     sequential grid axis; a GPU grid is not sequential, and every count
//     in that sweep is masked by the lane's own region [a, b), so one
//     thread per lane works over its own region instead. The cutoff and
//     the exponential pick are binary searches over global memory (exact:
//     ns_ts ascends inside a region, pexp is non-decreasing); the linear
//     pick stays a count over [c, b), whose S(j) is not provably monotone.
//   * Both kernels compute the tier-free semantics of the reference oracle
//     kernels/ref.py::fused_step_ref and write disjoint lanes of the same
//     four output arrays, so no merge pass is needed.
//   * Float arithmetic is one correctly rounded operation at a time
//     (samplers.cuh), bit-identical to the plain PyTorch version.
#include "samplers.cuh"

namespace {

using repro::index_pick;
using repro::upper_bound;
using repro::weight_pick;

template <bool kWeight>
__global__ void fused_tier_s_kernel(
    const int* __restrict__ base_blocks, const int* __restrict__ a,
    const int* __restrict__ b, const uint8_t* __restrict__ big,
    const int* __restrict__ time, const float* __restrict__ u,
    const int* __restrict__ code, const int* __restrict__ tbase,
    const int* __restrict__ ns_ts, const int* __restrict__ ns_dst,
    const float* __restrict__ pexp, const float* __restrict__ plin, int W,
    int TW, int TE, int* __restrict__ k_out, int* __restrict__ n_out,
    int* __restrict__ dst_out, int* __restrict__ ts_out) {
  extern __shared__ int smem[];
  const int P = 2 * TE;
  int* s_ts = smem;
  int* s_dst = smem + P;
  float* s_pe = reinterpret_cast<float*>(smem + 2 * P);
  float* s_pl = s_pe + (P + 1);

  const int tile = blockIdx.x;
  const int base = base_blocks[tile] * TE;
  for (int j = threadIdx.x; j < P; j += blockDim.x) {
    s_ts[j] = ns_ts[base + j];
    s_dst[j] = ns_dst[base + j];
  }
  if (kWeight) {
    for (int j = threadIdx.x; j <= P; j += blockDim.x) {
      s_pe[j] = pexp[base + j];
      s_pl[j] = plin[base + j];
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < TW; i += blockDim.x) {
    const int lane = tile * TW + i;
    if (lane >= W || big[lane]) continue;
    const int lo = a[lane] - base;   // 0 <= lo <= hi <= P for tier-S lanes
    const int hi = b[lane] - base;
    const int c = upper_bound(s_ts, lo, hi, time[lane]);
    const int n = hi - c;
    int k;
    if (kWeight) {
      k = weight_pick<false>(s_pe, s_pl, s_ts, c, hi, n, u[lane], code[lane],
                             tbase[lane]);
    } else {
      k = c + index_pick(code[lane], u[lane], n);
    }
    const bool has = n > 0;
    k_out[lane] = has ? base + k : 0;
    n_out[lane] = n;
    dst_out[lane] = has ? s_dst[k] : 0;
    ts_out[lane] = has ? s_ts[k] : 0;
  }
}

template <bool kWeight>
__global__ void fused_tier_l_kernel(
    const int* __restrict__ a, const int* __restrict__ b,
    const uint8_t* __restrict__ big, const int* __restrict__ time,
    const float* __restrict__ u, const int* __restrict__ code,
    const int* __restrict__ tbase, const int* __restrict__ ns_ts,
    const int* __restrict__ ns_dst, const float* __restrict__ pexp,
    const float* __restrict__ plin, int W, int* __restrict__ k_out,
    int* __restrict__ n_out, int* __restrict__ dst_out,
    int* __restrict__ ts_out) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= W || !big[lane]) return;
  const int lo = a[lane];
  const int hi = b[lane];
  const int c = upper_bound(ns_ts, lo, hi, time[lane]);
  const int n = hi - c;
  int k;
  if (kWeight) {
    k = weight_pick<true>(pexp, plin, ns_ts, c, hi, n, u[lane], code[lane],
                          tbase[lane]);
  } else {
    k = c + index_pick(code[lane], u[lane], n);
  }
  const bool has = n > 0;
  k_out[lane] = has ? k : 0;
  n_out[lane] = n;
  dst_out[lane] = has ? ns_dst[k] : 0;
  ts_out[lane] = has ? ns_ts[k] : 0;
}

constexpr int kThreads = 256;

}  // namespace

REPRO_API int repro_fused_tier_s(
    int weight, const int* base_blocks, const int* a, const int* b,
    const uint8_t* big, const int* time, const float* u, const int* code,
    const int* tbase, const int* ns_ts, const int* ns_dst, const float* pexp,
    const float* plin, int W, int TW, int TE, int* k_out, int* n_out,
    int* dst_out, int* ts_out, void* stream) {
  const int T = W / TW;
  const int threads = TW < kThreads ? TW : kThreads;
  const size_t P = 2 * static_cast<size_t>(TE);
  const size_t smem =
      2 * P * sizeof(int) + (weight ? 2 * (P + 1) * sizeof(float) : 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (weight) {
    cudaFuncSetAttribute(fused_tier_s_kernel<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    fused_tier_s_kernel<true><<<T, threads, smem, s>>>(
        base_blocks, a, b, big, time, u, code, tbase, ns_ts, ns_dst, pexp,
        plin, W, TW, TE, k_out, n_out, dst_out, ts_out);
  } else {
    cudaFuncSetAttribute(fused_tier_s_kernel<false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    fused_tier_s_kernel<false><<<T, threads, smem, s>>>(
        base_blocks, a, b, big, time, u, code, tbase, ns_ts, ns_dst, pexp,
        plin, W, TW, TE, k_out, n_out, dst_out, ts_out);
  }
  return static_cast<int>(cudaGetLastError());
}

REPRO_API int repro_fused_tier_l(
    int weight, const int* a, const int* b, const uint8_t* big,
    const int* time, const float* u, const int* code, const int* tbase,
    const int* ns_ts, const int* ns_dst, const float* pexp, const float* plin,
    int W, int* k_out, int* n_out, int* dst_out, int* ts_out, void* stream) {
  const int blocks = (W + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (weight) {
    fused_tier_l_kernel<true><<<blocks, kThreads, 0, s>>>(
        a, b, big, time, u, code, tbase, ns_ts, ns_dst, pexp, plin, W, k_out,
        n_out, dst_out, ts_out);
  } else {
    fused_tier_l_kernel<false><<<blocks, kThreads, 0, s>>>(
        a, b, big, time, u, code, tbase, ns_ts, ns_dst, pexp, plin, W, k_out,
        n_out, dst_out, ts_out);
  }
  return static_cast<int>(cudaGetLastError());
}

REPRO_API const char* repro_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
