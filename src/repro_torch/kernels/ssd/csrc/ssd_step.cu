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
// x's type and the new state in float32, out of place (the input state is
// only read).  Everything is computed in float32; y is rounded once, after
// the D*x skip term is added, as the Pallas kernel does.  (The plain version
// rounds y to x's type first and adds the skip term in that type, so on
// bfloat16 inputs the two can differ by about one bfloat16 ulp.)
//
// What bounds it on the card: bytes.  Each call reads the float32 state once
// and writes the new state once, 2 * B*H*P*N*4 bytes, against ~4 operations
// per state element; at the serve shape (B 8, H 24, P 64, N 128) that is
// 12.58 MB, 3.76 us at 3.35 TB/s.
//
// Design (simple first): one CTA per (b, h), whose P x N state block is one
// contiguous 32 KB stretch at the serve shape.  B and C are staged once per
// CTA in shared memory as float32.  Each warp takes rows p in turn; the
// lanes of a row stream its N elements with coalesced float4 loads and
// stores (scalar loads where N is not a multiple of 4 or the pointers are
// not 16-byte aligned), and a warp-shuffle reduction gives the dot product
// with C.  Where a row is shorter than 32 vectors (N < 128), a warp works on
// several rows at once, each on an aligned group of a power-of-two number
// of lanes, and the shuffle reduces within the group.
//
// Numerics: accurate expf (not __expf).  FMA contraction is ON (nvcc's
// default --fmad=true): the state update and the dot product may round a
// multiply-add once; the plain version rounds each operation, so the two
// agree to float32 round-off (the tests' bar), not bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;

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

template <typename T, bool kVec4>
__global__ void __launch_bounds__(kThreads)
ssd_step_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                const float* __restrict__ a, const T* __restrict__ bm,
                const T* __restrict__ cm, const float* __restrict__ d,
                const float* __restrict__ state, T* __restrict__ y,
                float* __restrict__ new_state, int H, int P, int N,
                int lanes_per_row) {
  extern __shared__ float smem[];  // B row, then C row: 2 * N floats
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
  const int sub = lane & (lanes_per_row - 1);  // lane within its row's group
  const int group = lane / lanes_per_row;      // row group within the warp
  const int rows_per_warp = 32 / lanes_per_row;
  const int rows_per_pass = (blockDim.x >> 5) * rows_per_warp;
  constexpr int V = kVec4 ? 4 : 1;
  const int nv = N / V;

  const size_t block = static_cast<size_t>(bh) * P * N;
  const float* st = state + block;
  float* nst = new_state + block;

  // The pass count is the same for every lane, so each shuffle is reached
  // by the whole warp; lanes past the last row compute nothing.
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
      for (int v = sub; v < nv; v += lanes_per_row) {
        if constexpr (kVec4) {
          const float4 s4 = reinterpret_cast<const float4*>(srow)[v];
          const int n = 4 * v;
          float4 o;
          o.x = s4.x * decay + coef * sb[n];
          o.y = s4.y * decay + coef * sb[n + 1];
          o.z = s4.z * decay + coef * sb[n + 2];
          o.w = s4.w * decay + coef * sb[n + 3];
          reinterpret_cast<float4*>(drow)[v] = o;
          acc += o.x * sc[n] + o.y * sc[n + 1] + o.z * sc[n + 2] + o.w * sc[n + 3];
        } else {
          const float o = srow[v] * decay + coef * sb[v];
          drow[v] = o;
          acc += o * sc[v];
        }
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

template <typename T, bool kVec4>
cudaError_t launch(const void* x, const void* dt, const float* a, const void* bm,
                   const void* cm, const float* d, const float* state, void* y,
                   float* new_state, int B, int H, int P, int N, int lanes_per_row,
                   cudaStream_t stream) {
  const size_t smem = 2 * static_cast<size_t>(N) * sizeof(float);
  ssd_step_kernel<T, kVec4><<<B * H, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), a,
      static_cast<const T*>(bm), static_cast<const T*>(cm), d, state,
      static_cast<T*>(y), new_state, H, P, N, lanes_per_row);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, dt, B, C and y).  vec4: the caller
// checked that N % 4 == 0 and that state and new_state are 16-byte aligned.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int ssd_step_launch(const void* x, const void* dt, const void* a,
                               const void* bm, const void* cm, const void* d,
                               const void* state, void* y, void* new_state, int B,
                               int H, int P, int N, int dtype, int vec4,
                               void* stream) {
  const int nv = vec4 ? N / 4 : N;
  int lanes_per_row = 32;
  while (lanes_per_row > 1 && lanes_per_row > nv) lanes_per_row >>= 1;
  const auto* af = static_cast<const float*>(a);
  const auto* df = static_cast<const float*>(d);
  const auto* sf = static_cast<const float*>(state);
  auto* nf = static_cast<float*>(new_state);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = vec4 ? launch<float, true>(x, dt, af, bm, cm, df, sf, y, nf, B, H, P, N, lanes_per_row, s)
               : launch<float, false>(x, dt, af, bm, cm, df, sf, y, nf, B, H, P, N, lanes_per_row, s);
  } else if (dtype == 1) {
    err = vec4 ? launch<__nv_bfloat16, true>(x, dt, af, bm, cm, df, sf, y, nf, B, H, P, N,
                                             lanes_per_row, s)
               : launch<__nv_bfloat16, false>(x, dt, af, bm, cm, df, sf, y, nf, B, H, P, N,
                                              lanes_per_row, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
