// Fused exp-weight + exclusive prefix sum on Hopper.
//
// Replaces the Pallas TPU kernel kernels/weight_prefix.py::weight_prefix
// (_kernel, pallas_call at weight_prefix.py:54): P[0] = 0 and
// P[i+1] = P[i] + (valid[i] ? exp(scale·dt[i]) : 0).
//
// What bounds it on an H100: memory bandwidth. It reads 5 bytes and writes
// 4 bytes per edge with one expf each; at 2^26 edges that is ~0.6 GB.
//
// Design: the Pallas kernel carried the running sum across a sequential
// grid; GPU blocks run in no order, so the scan is two-level with three
// launches: (1) each block of 4096 elements computes its total, (2) one
// block chains the block totals into exclusive block offsets, (3) each
// block recomputes its local scan and adds its offset. Inside a block each
// thread scans 16 consecutive elements sequentially and thread offsets are
// chained sequentially, and the block offsets are chained the same way, so
// every output is round(offset + local) with offset(next) equal to the last
// output of the previous chunk: the result is non-decreasing for
// non-negative weights, which the fused tier-L kernel's binary search over
// pexp relies on. A tree scan would not guarantee that.
#include "samplers.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kBlockElems = kThreads * kItems;
constexpr int kChainChunk = 4096;

// Per-thread sequential inclusive scan of its kItems weights, plus the
// thread's exclusive offset inside the block (chained sequentially).
// Returns the block total through *block_total.
__device__ __forceinline__ float block_local_scan(
    const float* __restrict__ dt, const uint8_t* __restrict__ valid,
    float scale, long long E, float (&s)[kItems], float* s_tot,
    float* block_total) {
  const long long start =
      static_cast<long long>(blockIdx.x) * kBlockElems + threadIdx.x * kItems;
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long i = start + j;
    float w = 0.0f;
    if (i < E && valid[i]) w = expf(__fmul_rn(scale, dt[i]));
    acc = __fadd_rn(acc, w);
    s[j] = acc;
  }
  s_tot[threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float run = 0.0f;
    for (int t = 0; t < kThreads; ++t) {
      const float v = s_tot[t];
      s_tot[t] = run;
      run = __fadd_rn(run, v);
    }
    s_tot[kThreads] = run;
  }
  __syncthreads();
  *block_total = s_tot[kThreads];
  return s_tot[threadIdx.x];
}

__global__ void wp_block_totals(const float* __restrict__ dt,
                                const uint8_t* __restrict__ valid, float scale,
                                long long E, float* __restrict__ totals) {
  __shared__ float s_tot[kThreads + 1];
  float s[kItems];
  float total;
  block_local_scan(dt, valid, scale, E, s, s_tot, &total);
  if (threadIdx.x == 0) totals[blockIdx.x] = total;
}

// One block: offsets[k] = sum of totals[0..k) chained left to right.
__global__ void wp_chain(const float* __restrict__ totals, int nblk,
                         float* __restrict__ offsets) {
  __shared__ float buf[kChainChunk];
  float run = 0.0f;
  for (int base = 0; base < nblk; base += kChainChunk) {
    const int m = nblk - base < kChainChunk ? nblk - base : kChainChunk;
    for (int j = threadIdx.x; j < m; j += blockDim.x) buf[j] = totals[base + j];
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int j = 0; j < m; ++j) {
        const float v = buf[j];
        buf[j] = run;
        run = __fadd_rn(run, v);
      }
    }
    __syncthreads();
    for (int j = threadIdx.x; j < m; j += blockDim.x) offsets[base + j] = buf[j];
    __syncthreads();
  }
}

__global__ void wp_apply(const float* __restrict__ dt,
                         const uint8_t* __restrict__ valid, float scale,
                         long long E, const float* __restrict__ offsets,
                         float* __restrict__ out) {
  __shared__ float s_tot[kThreads + 1];
  float s[kItems];
  float total;
  const float t_off = block_local_scan(dt, valid, scale, E, s, s_tot, &total);
  const float b_off = offsets[blockIdx.x];
  const long long start =
      static_cast<long long>(blockIdx.x) * kBlockElems + threadIdx.x * kItems;
  if (blockIdx.x == 0 && threadIdx.x == 0) out[0] = 0.0f;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long i = start + j;
    if (i < E) out[i + 1] = __fadd_rn(b_off, __fadd_rn(t_off, s[j]));
  }
}

}  // namespace

// out[E + 1]; scratch[2 * nblk] with nblk = ceil(E / 4096).
REPRO_API int repro_weight_prefix(const float* dt, const uint8_t* valid,
                                  float scale, long long E, float* out,
                                  float* scratch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nblk = static_cast<int>((E + kBlockElems - 1) / kBlockElems);
  float* totals = scratch;
  float* offsets = scratch + nblk;
  wp_block_totals<<<nblk, kThreads, 0, s>>>(dt, valid, scale, E, totals);
  wp_chain<<<1, 1024, 0, s>>>(totals, nblk, offsets);
  wp_apply<<<nblk, kThreads, 0, s>>>(dt, valid, scale, E, offsets, out);
  return static_cast<int>(cudaGetLastError());
}
