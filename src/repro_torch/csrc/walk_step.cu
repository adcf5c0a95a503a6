// Tiled walk step on Hopper: temporal cutoff + biased pick + neighbour
// gather for one task (a tile of node-sorted walk lanes) over a staged
// panel of the node-ts view, one launch per hop of the tiled path.
//
// Replaces the Pallas TPU kernel of the JAX reference
// kernels/walk_step.py::walk_step_tiled (body _kernel, pallas_call at
// walk_step.py:175) -> walk_step_tiled_kernel.
//
// What bounds it on an H100: memory latency and the panel loads, not
// arithmetic. A launch reads five per-lane inputs and writes four int32
// outputs per lane (36 bytes), and each task stages its 2·TE rows of
// ns_ts / ns_dst (8 bytes a row; 16 with the prefix rows in weight mode).
// Neighbouring tasks of node-sorted lanes stage overlapping panels, which
// L2 absorbs.
//
// Design:
//   * One CTA per task (grid T = W / TW), one thread per lane. The CTA
//     stages the panel [base, base + 2·TE) of ns_ts and ns_dst — plus the
//     prefix rows P(j) and P(j+1) in weight mode — in shared memory (16 KB,
//     or 32 KB in weight mode, at TE = 1024).
//   * One template instance per (mode, bias), as the Pallas kernel compiles
//     one per (mode, bias).
//   * The cutoff is a binary search in shared memory. The Pallas kernel
//     counts #{j ∈ [lo, hi) : ts[j] <= t}; that equals the search because
//     ns_ts ascends inside a node region, and the clipped [lo, hi) of an
//     oversize lane is a prefix of its region (lo >= 0 always holds, since
//     the panel base is at most the tile's smallest region start).
//   * The weight-mode picks stay counts over [c, hi), as in the Pallas
//     kernel: the linear S(j) is not provably monotone after rounding.
//   * The Pallas kernel reads P(c), ts_c and P(hi) = ps[hi − 1] by one-hot
//     sums over the panel, which give 0 outside it (c == 2·TE, hi == 0).
//     Those reads are guarded here and give the same 0.
//   * k is clipped to the panel, [0, 2·TE − 1], as the Pallas kernel does,
//     and not into [c, max(hi − 1, c)].
//   * Float arithmetic is one correctly rounded operation at a time, in the
//     reference's order, so the outputs equal the plain PyTorch version
//     (kernels/walk_step.py::walk_step_plain) bit for bit.
#include "samplers.cuh"

namespace {

using repro::index_pick;
using repro::index_uniform;
using repro::upper_bound;

constexpr int kBiasExponential = 2;
constexpr int kThreads = 256;

// Weight-mode pick of the Pallas kernel over tile-local positions. px / ps
// are the staged rows P(base + j) / P(base + j + 1) of the bias's prefix.
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

template <bool kWeight, int kBias>
__global__ void walk_step_tiled_kernel(
    const int* __restrict__ base_blocks, const int* __restrict__ time,
    const int* __restrict__ lo, const int* __restrict__ hi,
    const float* __restrict__ u, const int* __restrict__ tbase,
    const int* __restrict__ ns_ts, const int* __restrict__ ns_dst,
    const float* __restrict__ pfx, const float* __restrict__ pfx_shift,
    int TW, int TE, int* __restrict__ k_out, int* __restrict__ n_out,
    int* __restrict__ dst_out, int* __restrict__ ts_out) {
  extern __shared__ int smem[];
  const int P = 2 * TE;
  int* s_ts = smem;
  int* s_dst = smem + P;
  float* s_px = reinterpret_cast<float*>(smem + 2 * P);
  float* s_ps = s_px + P;

  const int task = blockIdx.x;
  const size_t base = static_cast<size_t>(base_blocks[task]) * TE;
  for (int j = threadIdx.x; j < P; j += blockDim.x) {
    s_ts[j] = ns_ts[base + j];
    s_dst[j] = ns_dst[base + j];
    if (kWeight) {
      s_px[j] = pfx[base + j];
      s_ps[j] = pfx_shift[base + j];
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < TW; i += blockDim.x) {
    const size_t lane = static_cast<size_t>(task) * TW + i;
    const int l = lo[lane];       // 0 <= l <= h <= P (ops.walk_step clips)
    const int h = hi[lane];
    const int c = upper_bound(s_ts, l, h, time[lane]);
    const int n = h - c;
    int k;
    if (kWeight) {
      k = tiled_weight_pick<kBias>(s_px, s_ps, s_ts, P, c, h, n, u[lane],
                                   tbase[lane]);
    } else {
      k = c + index_pick(kBias, u[lane], n);
    }
    k = k < 0 ? 0 : (k > P - 1 ? P - 1 : k);
    const bool has = n > 0;
    k_out[lane] = has ? k : 0;
    n_out[lane] = n;
    dst_out[lane] = has ? s_dst[k] : 0;
    ts_out[lane] = has ? s_ts[k] : 0;
  }
}

template <bool kWeight, int kBias>
cudaError_t launch(const int* base_blocks, const int* time, const int* lo,
                   const int* hi, const float* u, const int* tbase,
                   const int* ns_ts, const int* ns_dst, const float* pfx,
                   const float* pfx_shift, int W, int TW, int TE, int* k_out,
                   int* n_out, int* dst_out, int* ts_out,
                   cudaStream_t stream) {
  const int T = W / TW;
  const int threads = TW < kThreads ? TW : kThreads;
  const size_t smem = (kWeight ? 4 : 2) * 2 * static_cast<size_t>(TE) * 4;
  auto* kernel = walk_step_tiled_kernel<kWeight, kBias>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<T, threads, smem, stream>>>(base_blocks, time, lo, hi, u, tbase,
                                       ns_ts, ns_dst, pfx, pfx_shift, TW, TE,
                                       k_out, n_out, dst_out, ts_out);
  return cudaGetLastError();
}

using Launcher = cudaError_t (*)(const int*, const int*, const int*,
                                 const int*, const float*, const int*,
                                 const int*, const int*, const float*,
                                 const float*, int, int, int, int*, int*,
                                 int*, int*, cudaStream_t);

// [weight][bias]: bias codes 0 uniform, 1 linear, 2 exponential
constexpr Launcher kLaunchers[2][3] = {
    {launch<false, 0>, launch<false, 1>, launch<false, 2>},
    {launch<true, 0>, launch<true, 1>, launch<true, 2>},
};

}  // namespace

REPRO_API int repro_walk_step_tiled(
    int weight, int bias, const int* base_blocks, const int* time,
    const int* lo, const int* hi, const float* u, const int* tbase,
    const int* ns_ts, const int* ns_dst, const float* pfx,
    const float* pfx_shift, int W, int TW, int TE, int* k_out, int* n_out,
    int* dst_out, int* ts_out, void* stream) {
  if (weight < 0 || weight > 1 || bias < 0 || bias > 2 || TW <= 0 ||
      TE <= 0 || W % TW != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(kLaunchers[weight][bias](
      base_blocks, time, lo, hi, u, tbase, ns_ts, ns_dst, pfx, pfx_shift, W,
      TW, TE, k_out, n_out, dst_out, ts_out,
      static_cast<cudaStream_t>(stream)));
}
