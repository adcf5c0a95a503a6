// Fused exp-weight + exclusive prefix sum on Hopper: one launch, one read.
//
// Replaces the Pallas TPU kernel kernels/weight_prefix.py::weight_prefix
// (_kernel, pallas_call at weight_prefix.py:54): P[0] = 0 and
// P[i+1] = P[i] + (valid[i] ? exp(scale·dt[i]) : 0).
//
// What bounds it on an H100: memory bandwidth. It reads 5 bytes and writes
// 4 bytes per edge, once each, with one expf per edge; at 2^26 edges that
// is ~0.6 GB.
//
// Design: a single-pass scan with decoupled look-back (Merrill & Garland),
// shaped so that the output is bit-for-bit the same on every run and
// non-decreasing, which the fused tier-L kernel's binary search over pexp
// relies on (samplers.cuh, weight_pick<true>). A scan that sums the tile
// totals in whatever order the look-back finds them guarantees neither.
//   * Tiles of 8192 edges are handed out by an atomic counter, so every
//     tile a block waits on belongs to a block that is already running.
//   * A block loads its tile with coalesced 16-byte loads into shared
//     memory and scans it in two passes of 4096 edges: each thread scans
//     16 consecutive edges sequentially in float32, thread totals are
//     scanned across the warp by shuffles and warp totals in warp order,
//     starting from the previous pass's last value. Any fixed order will
//     do; a running max, L'_j = max_{i<=j} L_i, then makes the tile-local
//     prefix non-decreasing exactly (max is exact). The tile's aggregate is
//     agg = L'_last. The outputs leave as coalesced stores.
//   * The chain across tiles is carried in float64: R(b) =
//     fl64(R(b-1) + agg(b)). A float32 chain drifts by ~0.3·sqrt(tiles)
//     units of P's float32 roundoff (20.5u read on an H100 with 4096-edge
//     tiles at 2^22 weights spanning e^-87..1, against the limit of 8u);
//     float64 keeps the error to the tile-local scan and the final
//     rounding.
//   * The block publishes agg (status A) and looks back for the nearest
//     predecessor p that has published R(p) (status P). It folds forward
//     in index order, x = R(p), x = fl64(x + agg(j)) for j = p+1 .. b-1,
//     so x = R(b-1) however far each look-back reached: the output does
//     not depend on the schedule. Outputs are fl32(fl64(R(b-1) + L'_j)):
//     the tile's last one is fl32(R(b)) and the next tile starts at or
//     above it, so the output is non-decreasing across tiles too. The fold
//     is one dependent float64 add per tile passed, the one sequential
//     part of the scan.
//   * A status word holds the flag (epoch << 1 | P) above the aggregate's
//     float32 bits, published with release order; R(b) sits in a float64
//     array, written before status P. Readers poll statuses with relaxed
//     loads, then fence before reading R(p). The epoch (from the wrapper)
//     tells this call's words from earlier calls', so the words need no
//     reset between calls; the wrapper zeroes the workspace only when it
//     allocates it. The block that draws the last tile resets the tile
//     counter.
#include "samplers.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;                    // edges per thread per pass
constexpr int kPass = kThreads * kItems;
constexpr int kPasses = 2;
constexpr int kTile = kPass * kPasses;        // edges per tile
constexpr int kBufWords = kTile + kTile / 32;   // padded dt / L'
constexpr int kDynSmem = kBufWords * 4 + kTile;
constexpr int kLookRound = 8;                 // statuses per lane per round
constexpr int kLookSpan = 32 * kLookRound;    // predecessors per round
constexpr int kLookDepth = kLookSpan * 8;      // buffered before a restart
constexpr unsigned kFull = 0xffffffffu;

// shared-memory index of tile position i: one pad word per 32
__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

__device__ __forceinline__ unsigned long long load_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ double load_relaxed_f64(const double* p) {
  double v;
  asm volatile("ld.relaxed.gpu.global.f64 %0, [%1];"
               : "=d"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_relaxed_f64(double* p, double v) {
  asm volatile("st.relaxed.gpu.global.f64 [%0], %1;"
               :: "l"(p), "d"(v) : "memory");
}

__device__ __forceinline__ void fence_acquire() {
  asm volatile("fence.acq_rel.gpu;" ::: "memory");
}

__device__ __forceinline__ void store_release(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

// status word: flag (epoch << 1 | inclusive) above the float32 bits of
// the tile's aggregate
__device__ __forceinline__ unsigned long long status_word(unsigned epoch,
                                                          bool inclusive,
                                                          float agg) {
  const unsigned flag = (epoch << 1) | (inclusive ? 1u : 0u);
  return (static_cast<unsigned long long>(flag) << 32) | __float_as_uint(agg);
}

__device__ __forceinline__ bool ready(unsigned long long s, unsigned epoch) {
  return static_cast<unsigned>(s >> 33) == epoch;
}

__device__ __forceinline__ float status_agg(unsigned long long s) {
  return __uint_as_float(static_cast<unsigned>(s));
}

// Warp 0: R(tile - 1) by look-back and forward fold. look[] buffers the
// aggregates met on the way, nearest first.
__device__ double look_back(const unsigned long long* status,
                            const double* incl, int tile, unsigned epoch,
                            float* look) {
  const int lane = threadIdx.x & 31;
  int top = tile - 1;     // nearest predecessor not yet buffered
  int depth = 0;          // aggregates buffered: look[i] = agg(tile-1-i)
  for (;;) {
    // the round's statuses, loads issued together (relaxed); j < 0 reads
    // as P, with R(-1) = 0
    unsigned long long s[kLookRound];
#pragma unroll
    for (int q = 0; q < kLookRound; ++q) {
      const int j = top - (q * 32 + lane);
      s[q] = j < 0 ? status_word(epoch, true, 0.0f)
                   : load_relaxed(status + j);
    }
    // the nearest position that is not A: if it has not published yet,
    // spin on it alone (its block is running), then look again; positions
    // past the nearest P are never waited for
    int p_pos = -1;       // nearest P in this round, as an offset from top
    for (;;) {
      int stop = -1;
#pragma unroll
      for (int q = 0; q < kLookRound; ++q) {
        const unsigned m = __ballot_sync(
            kFull, !ready(s[q], epoch) || ((s[q] >> 32) & 1u));
        if (m && stop < 0) stop = q * 32 + __ffs(m) - 1;
      }
      if (stop < 0) break;          // all A
      bool unpublished = false;
#pragma unroll
      for (int q = 0; q < kLookRound; ++q)
        if (q * 32 + lane == stop) {
          unpublished = !ready(s[q], epoch);
          while (!ready(s[q], epoch)) s[q] = load_relaxed(status + top - stop);
        }
      if (!__any_sync(kFull, unpublished)) {
        p_pos = stop;
        break;
      }
    }
    if (p_pos >= 0) fence_acquire();   // orders the read of R(p) below
    const int keep = p_pos < 0 ? kLookSpan : p_pos;
    if (p_pos < 0 && depth + keep > kLookDepth) {
      depth = 0;          // buffer full: start again from the nearest
      top = tile - 1;
      continue;
    }
#pragma unroll
    for (int q = 0; q < kLookRound; ++q) {
      const int pos = q * 32 + lane;
      if (pos < keep) look[depth + pos] = status_agg(s[q]);
    }
    depth += keep;
    if (p_pos >= 0) {
      __syncwarp();
      double x = 0.0;     // R(p), then fold forward: agg(p+1) .. agg(tile-1)
      if (lane == 0) {
        const int p = top - p_pos;
        if (p >= 0) x = load_relaxed_f64(incl + p);
        for (int i = depth - 1; i >= 0; --i)
          x = __dadd_rn(x, static_cast<double>(look[i]));
      }
      return __shfl_sync(kFull, x, 0);
    }
    top -= keep;
  }
}

__global__ void __launch_bounds__(kThreads)
weight_prefix_lookback(const float* __restrict__ dt,
                       const uint8_t* __restrict__ valid, float scale,
                       long long E, int ntiles, unsigned epoch,
                       float* __restrict__ out,
                       unsigned long long* __restrict__ status,
                       double* __restrict__ incl_out,
                       unsigned* __restrict__ counter) {
  __shared__ int s_tile;
  __shared__ float s_wsum[kWarps];
  __shared__ float s_wmax[kWarps];
  __shared__ double s_excl;
  __shared__ float s_look[kLookDepth + kLookSpan];
  // dynamic: the tile's dt, then L', one pad word per 32 so that a thread's
  // 16 consecutive words fall in distinct banks across the warp; then the
  // tile's valid bytes
  extern __shared__ __align__(16) float s_buf[];
  uint8_t* s_valid = reinterpret_cast<uint8_t*>(s_buf + kBufWords);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  if (threadIdx.x == 0) {
    const int t = static_cast<int>(atomicAdd(counter, 1u));
    if (t == ntiles - 1) atomicExch(counter, 0u);   // the last draw
    s_tile = t;
  }
  __syncthreads();
  const int tile = s_tile;
  const long long base = static_cast<long long>(tile) * kTile;

  // ---- load the whole tile, coalesced --------------------------------------
  if (base + kTile <= E && (reinterpret_cast<uintptr_t>(dt) & 15) == 0 &&
      (reinterpret_cast<uintptr_t>(valid) & 15) == 0) {
#pragma unroll
    for (int q = 0; q < kTile / 4 / kThreads; ++q) {
      const int f = q * kThreads + threadIdx.x;
      const float4 d = reinterpret_cast<const float4*>(dt + base)[f];
      s_buf[pad(4 * f)] = d.x;
      s_buf[pad(4 * f + 1)] = d.y;
      s_buf[pad(4 * f + 2)] = d.z;
      s_buf[pad(4 * f + 3)] = d.w;
    }
#pragma unroll
    for (int q = 0; q < kTile / 16 / kThreads; ++q) {
      const int f = q * kThreads + threadIdx.x;
      reinterpret_cast<uint4*>(s_valid)[f] =
          reinterpret_cast<const uint4*>(valid + base)[f];
    }
  } else {
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      const bool in = base + i < E;
      s_buf[pad(i)] = in ? dt[base + i] : 0.0f;
      s_valid[i] = in ? valid[base + i] : 0;
    }
  }
  __syncthreads();

  // ---- tile-local prefix L', one pass of 16 edges per thread at a time -----
  // Within a pass: a sequential run per thread, a Kogge-Stone scan of the
  // thread totals per warp, warp totals in warp order from the carry (the
  // previous pass's last L'), then the running max. L' overwrites dt.
  float carry = 0.0f;
  for (int p = 0; p < kPasses; ++p) {
    const int first = p * kPass + threadIdx.x * kItems;
    float s[kItems];
    {
      const uint4 v = reinterpret_cast<const uint4*>(s_valid)[first / 16];
      const unsigned vb[4] = {v.x, v.y, v.z, v.w};
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const float w = ((vb[j / 4] >> (8 * (j % 4))) & 0xffu)
                            ? expf(__fmul_rn(scale, s_buf[pad(first + j)]))
                            : 0.0f;
        acc = __fadd_rn(acc, w);
        s[j] = acc;
      }
    }
    float x = s[kItems - 1];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float y = __shfl_up_sync(kFull, x, d);
      if (lane >= d) x = __fadd_rn(y, x);
    }
    float t_excl = __shfl_up_sync(kFull, x, 1);
    if (lane == 0) t_excl = 0.0f;
    if (lane == 31) s_wsum[warp] = x;
    __syncthreads();
    float w_off = carry;
    for (int i = 0; i < warp; ++i) w_off = __fadd_rn(w_off, s_wsum[i]);
    const float off = __fadd_rn(w_off, t_excl);
#pragma unroll
    for (int j = 0; j < kItems; ++j) s[j] = __fadd_rn(off, s[j]);
    // s[] ascends within the thread, so its max is s[last]
    float m = s[kItems - 1];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float y = __shfl_up_sync(kFull, m, d);
      if (lane >= d) m = fmaxf(y, m);
    }
    float m_excl = __shfl_up_sync(kFull, m, 1);
    if (lane == 0) m_excl = carry;
    if (lane == 31) s_wmax[warp] = m;
    __syncthreads();
    float top = carry;
    for (int i = 0; i < kWarps; ++i) {
      if (i == warp) m_excl = fmaxf(top, m_excl);
      top = fmaxf(top, s_wmax[i]);
    }
#pragma unroll
    for (int j = 0; j < kItems; ++j)
      s_buf[pad(first + j)] = fmaxf(m_excl, s[j]);
    carry = top;
    __syncthreads();      // s_wsum / s_wmax are reused by the next pass
  }
  const float agg = carry;

  // ---- chain across tiles -------------------------------------------------
  if (warp == 0) {
    double excl = 0.0;
    if (tile > 0) {
      if (lane == 0)
        store_release(status + tile, status_word(epoch, false, agg));
      excl = look_back(status, incl_out, tile, epoch, s_look);
    }
    if (lane == 0) {
      const double incl = __dadd_rn(excl, static_cast<double>(agg));
      store_relaxed_f64(incl_out + tile, incl);   // R(tile), then P
      store_release(status + tile, status_word(epoch, true, agg));
      s_excl = excl;
    }
  }
  __syncthreads();
  const double excl = s_excl;
  if (tile == 0 && threadIdx.x == 0) out[0] = 0.0f;
#pragma unroll 4
  for (int q = 0; q < kTile / kThreads; ++q) {  // coalesced: out[base+i+1]
    const int i = q * kThreads + threadIdx.x;
    if (base + i < E)
      out[base + i + 1] = __double2float_rn(
          __dadd_rn(excl, static_cast<double>(s_buf[pad(i)])));
  }
}

}  // namespace

// out[E + 1]. workspace: one 64-bit word whose low half is the tile
// counter, then ntiles status words, then ntiles float64 R(b), with
// ntiles = ceil(E / 16384); zeroed by the caller when allocated, then reused
// with a new epoch (1 .. 2^31 - 1) per call.
REPRO_API int repro_weight_prefix(const float* dt, const uint8_t* valid,
                                  float scale, long long E, float* out,
                                  unsigned long long* workspace,
                                  unsigned epoch, void* stream) {
  if (E <= 0 || epoch == 0 || epoch >= (1u << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        weight_prefix_lookback, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kDynSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ntiles = static_cast<int>((E + kTile - 1) / kTile);
  weight_prefix_lookback<<<ntiles, kThreads, kDynSmem, s>>>(
      dt, valid, scale, E, ntiles, epoch, out, workspace + 1,
      reinterpret_cast<double*>(workspace + 1 + ntiles),
      reinterpret_cast<unsigned*>(workspace));
  return static_cast<int>(cudaGetLastError());
}
