// Mamba-2 SSD decode step for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd/kernel.py::_ssd_step_kernel
// (pallas_call in ssd_decode_step_pallas).  One decode token of one SSM layer:
//
//   decay      = exp(dt[b,h] * a[h])
//   new_state  = state[b,h,p,:] * decay + (dt[b,h] * x[b,h,p]) * B[b,:]
//   y[b,h,p]   = sum_n new_state[b,h,p,n] * C[b,n] + x[b,h,p] * D[h]
//
// x (B,H,P), dt (B,H), B and C (B,N) are float32 or bfloat16 (one type for
// all four); a and D (H) and the state (B,H,P,N) are float32.  y comes out in
// x's type and the new state in float32, either into a new tensor or in
// place (new_state == state: the server's decode step updates its cache so).
// Everything is computed in float32; y is rounded once, after the D*x skip
// term is added, as the Pallas kernel does.  (The plain version rounds y to
// x's type first and adds the skip term in that type, so on bfloat16 inputs
// the two can differ by about one bfloat16 ulp.)
//
// What bounds it on the card: bytes.  Each call reads the float32 state once
// and writes the new state once, 2 * B*H*P*N*4 bytes, against ~5 operations
// per state element; at the serve shape (B 8, H 24, P 64, N 128) that is
// 12.6 MB, 3.77 us at 3.35 TB/s.  A streaming kernel reaches that rate only
// with enough bytes in flight: by Little's law about 3.35 TB/s x ~0.7 us of
// latency, some 2.3 MB.
//
// Design.  The main path (N a multiple of 4, state and new state 16-byte
// aligned) is `ssd_step_bulk_kernel`: each CTA takes a contiguous slice of
// `rows` rows of one (b, h) block (16 rows, 8 KB, at the serve shape: 768
// CTAs of 128 threads at B 8, all resident at once, 5-6 per SM).  Thread 0
// asks for the whole slice with ONE 1-D bulk copy into shared memory
// (cp.async.bulk, completed on an mbarrier, with an L2 evict-first hint:
// the state is read once per call and the 24 layers' states do not fit the
// 50 MB L2), so every CTA's bytes are in flight at once, and the threads
// stage B, C and the slice's x (as float32) and read dt, a and D while they
// arrive.  Then each warp takes rows in turn: the lanes of a row read its N
// elements from shared memory as float4, write the new state with streaming
// stores (__stcs, evict-first), and a warp-shuffle reduction gives the dot
// product with C.  A warp works on four of its rows at once, so their four
// shuffle reductions interleave instead of running one after the other
// (after the wait, the CTA's time is that chain).  Where a row is shorter
// than 32 vectors (N < 128), a warp also works on several rows at once, each
// on an aligned group of a power-of-two number of lanes, and the shuffle
// reduces within the group.
//
// In place: a CTA's whole slice is in shared memory (the mbarrier wait)
// before the CTA writes any of it, and no CTA touches another's slice, so
// new_state may be state; neither pointer is __restrict__.
//
// The other path (N not a multiple of 4, or a pointer not 16-byte aligned)
// is `ssd_step_scalar_kernel`: one CTA per
// (b, h), each element read and written by the same thread with scalar
// accesses, so it too may run in place.
//
// Numerics: accurate expf (not __expf).  FMA contraction is ON (nvcc's
// default --fmad=true): the state update and the dot product may round a
// multiply-add once; the plain version rounds each operation, so the two
// agree to float32 round-off (the tests' bar), not bit for bit.  Both paths
// compute each element with the same expression.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 128;        // bulk path, per CTA
constexpr int kScalarThreads = 256;  // scalar path, per CTA
constexpr size_t kDefaultSmem = 48 * 1024;
// L2 evict-first cache policy for the bulk copy (the 64-bit policy word
// that `createpolicy.fractional.L2::evict_first.b64 p, 1.0` produces; CUTLASS
// names it TMA::CacheHintSm90::EVICT_FIRST).
constexpr uint64_t kEvictFirst = 0x12F0000000000000ull;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_step_bulk_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                     const float* __restrict__ a, const T* __restrict__ bm,
                     const T* __restrict__ cm, const float* __restrict__ d,
                     const float* state, T* __restrict__ y, float* new_state, int H,
                     int P, int N, int rows, int chunks, int lanes_per_row) {
  // rows x N state slice, the B row, the C row, x of the slice's rows (float32)
  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) uint64_t bar;
  float* ss = smem;
  float* sb = ss + static_cast<size_t>(rows) * N;
  float* sc = sb + N;
  float* sx = sc + N;

  const int bh = blockIdx.x / chunks;  // b * H + h
  const int r0 = (blockIdx.x - bh * chunks) * rows;
  const int nrows = min(rows, P - r0);
  const size_t off = (static_cast<size_t>(bh) * P + r0) * N;
  const uint32_t bar_addr = smem_u32(&bar);

  if (threadIdx.x == 0) {
    const uint32_t bytes = static_cast<uint32_t>(nrows) * N * sizeof(float);
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar_addr) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar_addr),
                 "r"(bytes)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint "
        "[%0], [%1], %2, [%3], %4;\n" ::"r"(smem_u32(ss)),
        "l"(state + off), "r"(bytes), "r"(bar_addr), "l"(kEvictFirst)
        : "memory");
  }

  // While the slice arrives: B and C of this batch row, x of the slice's
  // rows, dt, the decay, D.
  const int bi = bh / H;
  const int hi = bh - bi * H;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    sb[n] = to_f32(bm[static_cast<size_t>(bi) * N + n]);
    sc[n] = to_f32(cm[static_cast<size_t>(bi) * N + n]);
  }
  const size_t xrow = static_cast<size_t>(bh) * P + r0;
  for (int r = threadIdx.x; r < nrows; r += blockDim.x) sx[r] = to_f32(x[xrow + r]);
  const float dtv = to_f32(dt[bh]);
  const float decay = expf(dtv * a[hi]);
  const float dv = d[hi];
  __syncthreads();  // B, C and x staged; the barrier is initialised
  while (!mbar_try_wait(bar_addr, 0)) {
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = lane & (lanes_per_row - 1);  // lane within its row's group
  const int group = lane / lanes_per_row;      // row group within the warp
  const int rows_per_warp = 32 / lanes_per_row;
  const int rows_per_pass = (blockDim.x >> 5) * rows_per_warp;
  const int nv = N / 4;
  const float4* ss4 = reinterpret_cast<const float4*>(ss);
  const float4* sb4 = reinterpret_cast<const float4*>(sb);
  const float4* sc4 = reinterpret_cast<const float4*>(sc);
  float4* dst = reinterpret_cast<float4*>(new_state + off);

  // Four row passes at once.  nrows is the same for every lane, so each
  // shuffle is reached by the whole warp; lanes past the last row compute
  // nothing.
  constexpr int kU = 4;
  for (int p0 = 0; p0 < nrows; p0 += kU * rows_per_pass) {
    float acc[kU], xv[kU];
    int pr[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int p = p0 + u * rows_per_pass + warp * rows_per_warp + group;
      pr[u] = p;
      xv[u] = 0.f;
      acc[u] = 0.f;
      if (p < nrows) {
        xv[u] = sx[p];
        const float coef = dtv * xv[u];
        for (int v = sub; v < nv; v += lanes_per_row) {
          const float4 s4 = ss4[p * nv + v];
          const float4 b4 = sb4[v];
          const float4 c4 = sc4[v];
          float4 o;
          o.x = s4.x * decay + coef * b4.x;
          o.y = s4.y * decay + coef * b4.y;
          o.z = s4.z * decay + coef * b4.z;
          o.w = s4.w * decay + coef * b4.w;
          __stcs(dst + p * nv + v, o);
          acc[u] += o.x * c4.x + o.y * c4.y + o.z * c4.z + o.w * c4.w;
        }
      }
    }
#pragma unroll
    for (int step = 16; step > 0; step >>= 1) {
      if (step < lanes_per_row) {
#pragma unroll
        for (int u = 0; u < kU; ++u) acc[u] += __shfl_xor_sync(0xffffffffu, acc[u], step);
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (pr[u] < nrows && sub == 0) y[xrow + pr[u]] = from_f32<T>(acc[u] + xv[u] * dv);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kScalarThreads)
ssd_step_scalar_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                       const float* __restrict__ a, const T* __restrict__ bm,
                       const T* __restrict__ cm, const float* __restrict__ d,
                       const float* state, T* __restrict__ y, float* new_state, int H, int P,
                       int N, int lanes_per_row) {
  extern __shared__ __align__(16) float smem[];  // B row, then C row: 2 * N floats
  float* sb = smem;
  float* sc = smem + N;

  const int bh = blockIdx.x;  // b * H + h
  const int bi = bh / H;
  const int hi = bh - bi * H;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    sb[n] = to_f32(bm[static_cast<size_t>(bi) * N + n]);
    sc[n] = to_f32(cm[static_cast<size_t>(bi) * N + n]);
  }
  __syncthreads();

  const float dtv = to_f32(dt[bh]);
  const float decay = expf(dtv * a[hi]);
  const float dv = d[hi];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = lane & (lanes_per_row - 1);
  const int group = lane / lanes_per_row;
  const int rows_per_warp = 32 / lanes_per_row;
  const int rows_per_pass = (blockDim.x >> 5) * rows_per_warp;

  const size_t block = static_cast<size_t>(bh) * P * N;
  const float* st = state + block;
  float* nst = new_state + block;

  for (int p0 = 0; p0 < P; p0 += rows_per_pass) {
    const int p = p0 + warp * rows_per_warp + group;
    const bool row_ok = p < P;
    float xv = 0.f;
    float acc = 0.f;
    if (row_ok) {
      xv = to_f32(x[static_cast<size_t>(bh) * P + p]);
      const float coef = dtv * xv;
      const float* srow = st + static_cast<size_t>(p) * N;
      float* drow = nst + static_cast<size_t>(p) * N;
      for (int n = sub; n < N; n += lanes_per_row) {
        const float o = srow[n] * decay + coef * sb[n];
        drow[n] = o;
        acc += o * sc[n];
      }
    }
    for (int off = lanes_per_row >> 1; off > 0; off >>= 1) {
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    }
    if (row_ok && sub == 0) {
      y[static_cast<size_t>(bh) * P + p] = from_f32<T>(acc + xv * dv);
    }
  }
}

__global__ void __launch_bounds__(kThreads) ssd_step_empty_kernel() {}

int lanes_for(int nv) {
  int lanes_per_row = 32;
  while (lanes_per_row > 1 && lanes_per_row > nv) lanes_per_row >>= 1;
  return lanes_per_row;
}

size_t bulk_smem(int N, int rows) {
  return (static_cast<size_t>(rows) * N + 2 * static_cast<size_t>(N) + rows) * sizeof(float);
}

template <typename T>
cudaError_t launch(bool vec4, const void* x, const void* dt, const float* a, const void* bm,
                   const void* cm, const float* d, const float* state, void* y,
                   float* new_state, int B, int H, int P, int N, int rows,
                   cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* dtt = static_cast<const T*>(dt);
  const T* bt = static_cast<const T*>(bm);
  const T* ct = static_cast<const T*>(cm);
  T* yt = static_cast<T*>(y);
  if (!vec4) {
    const size_t smem = 2 * static_cast<size_t>(N) * sizeof(float);
    ssd_step_scalar_kernel<T><<<B * H, kScalarThreads, smem, stream>>>(
        xt, dtt, a, bt, ct, d, state, yt, new_state, H, P, N, lanes_for(N));
    return cudaGetLastError();
  }
  const int chunks = (P + rows - 1) / rows;
  const size_t smem = bulk_smem(N, rows);
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_step_bulk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  ssd_step_bulk_kernel<T><<<B * H * chunks, kThreads, smem, stream>>>(
      xt, dtt, a, bt, ct, d, state, yt, new_state, H, P, N, rows, chunks, lanes_for(N / 4));
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, dt, B, C and y).  vec4: the caller
// checked that N % 4 == 0 and that state and new_state are 16-byte aligned;
// then each CTA of the bulk path takes `rows` rows (>= 1) of a (b, h) block.
// new_state may equal state (in place).  Returns the cudaError_t of the
// launch (0 on success).
extern "C" int ssd_step_launch(const void* x, const void* dt, const void* a,
                               const void* bm, const void* cm, const void* d,
                               const void* state, void* y, void* new_state, int B,
                               int H, int P, int N, int dtype, int vec4, int rows,
                               void* stream) {
  if (vec4 && rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto* af = static_cast<const float*>(a);
  const auto* df = static_cast<const float*>(d);
  const auto* sf = static_cast<const float*>(state);
  auto* nf = static_cast<float*>(new_state);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float>(vec4 != 0, x, dt, af, bm, cm, df, sf, y, nf, B, H, P, N, rows, s);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(vec4 != 0, x, dt, af, bm, cm, df, sf, y, nf, B, H, P, N,
                                rows, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// An empty kernel on the bulk path's grid for this shape (B*H*ceil(P/rows)
// CTAs of 128 threads, the same dynamic shared memory): its time in a CUDA
// graph is the card's launch floor for the kernel.
extern "C" int ssd_step_empty_launch(int B, int H, int P, int N, int rows, void* stream) {
  if (rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = bulk_smem(N, rows);
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_step_empty_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int chunks = (P + rows - 1) / rows;
  ssd_step_empty_kernel<<<B * H * chunks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
