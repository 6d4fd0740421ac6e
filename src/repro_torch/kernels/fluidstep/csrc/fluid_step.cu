// Fluid step core of the fluid scheduling simulator, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/fluidstep/kernel.py::_fluid_step_kernel
// and computes what it computes, for every lane of a batch in ONE launch:
//   counts[d]      = sum_j loads[j,d] & active[j]                  (int32)
//   k_eff[j]       = max(1, max_{d loaded by j} counts[d]*oversub[d])
//   k_would[j]     = max(1, max_{d loaded by j} counts[d]+1)        (int32)
//   scale[j]       = min bw over j's member servers, 1.0 without members
//   ratio[j]       = scale * (b / (k_eff*b + (k_eff-1)*eta))       (Eq. 5)
//   min_old_rem[j] = min over d loaded by j of min{rem[i]: i active, loads d},
//                    +inf where there is none
//   overlap[i,j]   = i and j load a common domain (only when asked)
//
// What bounds it: at the simulator's sizes (J ~ 160 jobs, S = 16 servers,
// D <= 64 domains, 8 lanes) a lane's inputs are a few kB, so the launch is
// bound by launch latency, not by bytes or operations.  The design does the
// whole step in one launch for all lanes (one CTA per lane, gridDim.x = L),
// keeps every intermediate in shared memory, and allocates nothing.
//
// Layout: one CTA per lane; threads stride over jobs (no fixed J).  Each
// job's domain-load row is staged in shared memory as a 64-bit mask, so the
// per-domain sums and minima are exact in any order and the overlap test is
// one AND.  Rounding: the f32 arithmetic uses the _rn intrinsics in the
// plain PyTorch version's operation order (k_eff*b, (k_eff-1)*eta, their
// sum, b/(...), then scale*...), and the file is built with --fmad=false,
// so no multiply-add is contracted and the result is bit-equal to the plain
// version.  The simulator turns a one-ulp change of a remainder into a
// different finish tick, so this matters.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDomains = 64;

__global__ void __launch_bounds__(kThreads) fluid_step_core_kernel(
    const uint8_t* __restrict__ loads,    // (L, J, D) bool
    const float* __restrict__ member,     // (L, J, S) float {0,1}
    const uint8_t* __restrict__ active,   // (L, J) bool
    const float* __restrict__ rem,        // (L, J)
    const float* __restrict__ bw,         // (S,)
    const float* __restrict__ oversub,    // (D,)
    int32_t* __restrict__ counts,         // (L, D)
    float* __restrict__ k_eff,            // (L, J)
    float* __restrict__ ratio,            // (L, J)
    int32_t* __restrict__ k_would,        // (L, J)
    float* __restrict__ min_old_rem,      // (L, J)
    uint8_t* __restrict__ overlap,        // (L, J, J) bool, or null
    int J, int S, int D, float b, float eta) {
  extern __shared__ unsigned long long s_mask[];  // (J,) domain-load masks
  __shared__ int s_counts[kMaxDomains];
  __shared__ float s_w[kMaxDomains];
  __shared__ float s_dmin[kMaxDomains];

  const long long lane = blockIdx.x;
  const uint8_t* lane_loads = loads + lane * J * D;
  const uint8_t* lane_active = active + lane * J;
  const float* lane_rem = rem + lane * J;

  for (int j = threadIdx.x; j < J; j += blockDim.x) {
    const uint8_t* row = lane_loads + (long long)j * D;
    unsigned long long m = 0ull;
    for (int d = 0; d < D; ++d) {
      if (row[d]) m |= 1ull << d;
    }
    s_mask[j] = m;
  }
  __syncthreads();

  // Per-domain in-flight count and minimum in-flight remainder: integer sum
  // and min, exact in any order.
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    const unsigned long long bit = 1ull << d;
    int c = 0;
    float mn = INFINITY;
    for (int j = 0; j < J; ++j) {
      if (lane_active[j] && (s_mask[j] & bit)) {
        ++c;
        mn = fminf(mn, lane_rem[j]);
      }
    }
    s_counts[d] = c;
    s_w[d] = __fmul_rn((float)c, oversub[d]);
    s_dmin[d] = mn;
    counts[lane * D + d] = c;
  }
  __syncthreads();

  for (int j = threadIdx.x; j < J; j += blockDim.x) {
    const unsigned long long m = s_mask[j];
    float ke = 0.0f;
    int kw = 0;
    float mo = INFINITY;
    for (int d = 0; d < D; ++d) {
      if ((m >> d) & 1ull) {
        ke = fmaxf(ke, s_w[d]);
        kw = max(kw, s_counts[d] + 1);
        mo = fminf(mo, s_dmin[d]);
      }
    }
    ke = fmaxf(ke, 1.0f);
    kw = max(kw, 1);

    // Slowest member server bottlenecks the ring.
    const float* mrow = member + (lane * J + j) * (long long)S;
    float lo = 1e30f;
    bool has = false;
    for (int s = 0; s < S; ++s) {
      if (mrow[s] > 0.0f) {
        lo = fminf(lo, bw[s]);
        has = true;
      }
    }
    const float scale = has ? lo : 1.0f;
    const float denom = __fadd_rn(__fmul_rn(ke, b), __fmul_rn(__fsub_rn(ke, 1.0f), eta));
    const long long o = lane * J + j;
    k_eff[o] = ke;
    ratio[o] = __fmul_rn(scale, __fdiv_rn(b, denom));
    k_would[o] = kw;
    min_old_rem[o] = mo;
  }

  if (overlap != nullptr) {
    uint8_t* lane_ov = overlap + lane * J * (long long)J;
    const long long n = (long long)J * J;
    for (long long idx = threadIdx.x; idx < n; idx += blockDim.x) {
      const int i = (int)(idx / J);
      const int j = (int)(idx - (long long)i * J);
      lane_ov[idx] = (s_mask[i] & s_mask[j]) != 0ull;
    }
  }
}

}  // namespace

// Launch on `stream` (PyTorch's current stream); returns cudaGetLastError().
extern "C" int fluid_step_core_launch(
    const void* loads, const void* member, const void* active, const void* rem,
    const void* bw, const void* oversub, void* counts, void* k_eff, void* ratio,
    void* k_would, void* min_old_rem, void* overlap, int L, int J, int S, int D,
    float b, float eta, void* stream) {
  if (L < 1 || J < 1 || S < 1 || D < 1 || D > kMaxDomains) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = (size_t)J * sizeof(unsigned long long);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fluid_step_core_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  fluid_step_core_kernel<<<L, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)loads, (const float*)member, (const uint8_t*)active,
      (const float*)rem, (const float*)bw, (const float*)oversub, (int32_t*)counts,
      (float*)k_eff, (float*)ratio, (int32_t*)k_would, (float*)min_old_rem,
      (uint8_t*)overlap, J, S, D, b, eta);
  return (int)cudaGetLastError();
}
