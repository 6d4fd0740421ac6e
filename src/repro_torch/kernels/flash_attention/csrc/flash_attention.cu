// Blocked flash attention (forward) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/kernel.py::_flash_kernel (pallas_call in
// flash_attention_pallas).  For every (bh, query row):
//
//   s_j   = (q . k_j) * scale                  keys j < T; causal: j <= row
//   out   = sum_j softmax(s)_j v_j             written in q's type
//
// q (BH,S,D), k and v (BH,T,D), all float32 or all bfloat16, contiguous;
// D <= 256.  The reference's semantics are kept exactly: scores, the
// running max and denominator of the online softmax and the accumulator are
// float32; masked scores are the finite NEG_INF = -2^30 (an all-masked tile
// gives exp(0) = 1, never NaN); k/v rows at or past T are zeroed; causality
// is top-left aligned (key j <= query row i, also when S != T); kv tiles
// wholly above the diagonal are skipped; out = acc / max(l, 1e-30).
//
// What bounds it on the card: at the serve shape (BH 256, S = T 512, D 64,
// bf16) the bytes (q, k, v read once, out written once: 67 MB, 20 us at
// 3.35 TB/s) outweigh the causal products (8.6 GFLOP, 8.7 us on the bf16
// tensor cores).  This first kernel does not reach either: it runs its
// products on the float32 CUDA cores (no mma, no TMA), so it is bound by
// float32 FMA and shared-memory issue, ~4.3e9 FMAs at the serve shape.
//
// Design (simple first): one CTA of 4 warps per (bh, tile of 4*R query
// rows); each warp owns R rows.  The Q tile is staged once in shared memory
// as float32; K and V tiles of 32 keys are staged in turn (rows past T
// zeroed).  Score pass: lane j takes key j of the tile and computes its dot
// product with the warp's R rows (K row from shared memory as float4, Q rows
// as float4 broadcasts), so no shuffle is needed per score; the row max and
// sum of the online softmax are warp butterflies, once per row per tile.
// Value pass: the probabilities go through shared memory (float4
// broadcasts), and lane l accumulates output columns l, l+32, ... (DPL of
// them, so D = 256 needs 8 per lane and no thread holds a whole row).
// A warp skips the tiles above its own last row; the CTA stops at its last
// row's diagonal.  Query tiles are issued heaviest (latest) first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockK = 32;                 // keys per tile, one per lane
constexpr float kNegInf = -1073741824.0f;   // -2^30, the reference's NEG_INF
constexpr int kMaxD = 256;

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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Shared memory, in floats: Q tile [4R][Dp], K tile [32][Dp + 4] (padded so
// that the lanes' float4 reads of their own rows do not share banks), V tile
// [32][Dp], probabilities [4][R][32].  Dp is D rounded up to 4.
__host__ __device__ constexpr size_t smem_floats(int r, int dp) {
  return static_cast<size_t>(kWarps * r) * dp + static_cast<size_t>(kBlockK) * (dp + 4) +
         static_cast<size_t>(kBlockK) * dp + static_cast<size_t>(kWarps) * r * kBlockK;
}

// R: query rows per warp; DPL: output columns per lane (D <= 32 * DPL).
template <typename T, int R, int DPL>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int S, int Tk, int D, int Dp, int n_qtiles,
                 float scale, int causal) {
  constexpr int BQ = kWarps * R;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  const int ldk = Dp + 4;
  float* ks = qs + BQ * Dp;
  float* vs = ks + kBlockK * ldk;
  float* ps = vs + kBlockK * Dp;

  const int bh = blockIdx.x / n_qtiles;
  const int qt = n_qtiles - 1 - (blockIdx.x - bh * n_qtiles);  // heaviest tiles first
  const int q0 = qt * BQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t qbase = static_cast<size_t>(bh) * S * D;
  const size_t kbase = static_cast<size_t>(bh) * Tk * D;

  for (int idx = threadIdx.x; idx < BQ * Dp; idx += kThreads) {
    const int r = idx / Dp;
    const int c = idx - r * Dp;
    const int qp = q0 + r;
    qs[idx] = (qp < S && c < D) ? to_f32(q[qbase + static_cast<size_t>(qp) * D + c]) : 0.f;
  }

  const int row0 = q0 + warp * R;  // this warp's first query row
  const float* qw = qs + warp * R * Dp;
  float* pw = ps + warp * R * kBlockK;
  // keys this CTA visits, and those this warp's rows can see
  const int k_end = causal ? min(Tk, q0 + BQ) : Tk;
  const int warp_k_end = row0 >= S ? 0 : (causal ? min(Tk, row0 + R) : Tk);

  float m[R], l[R], acc[R][DPL];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }

  for (int k0 = 0; k0 < k_end; k0 += kBlockK) {
    __syncthreads();  // the Q tile is staged; the previous K/V tile is consumed
    for (int idx = threadIdx.x; idx < kBlockK * Dp; idx += kThreads) {
      const int r = idx / Dp;
      const int c = idx - r * Dp;
      const int kp = k0 + r;
      const bool ok = kp < Tk && c < D;
      const size_t g = kbase + static_cast<size_t>(kp) * D + c;
      ks[r * ldk + c] = ok ? to_f32(k[g]) : 0.f;
      vs[r * Dp + c] = ok ? to_f32(v[g]) : 0.f;
    }
    __syncthreads();
    if (k0 >= warp_k_end) continue;  // the tile lies above all of this warp's rows

    // ---- scores: lane j against key k0 + j ----------------------------------
    float s[R];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = 0.f;
    const float* krow = ks + lane * ldk;
    for (int c = 0; c < Dp; c += 4) {
      const float4 k4 = *reinterpret_cast<const float4*>(krow + c);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 q4 = *reinterpret_cast<const float4*>(qw + r * Dp + c);
        s[r] = fmaf(q4.x, k4.x, s[r]);
        s[r] = fmaf(q4.y, k4.y, s[r]);
        s[r] = fmaf(q4.z, k4.z, s[r]);
        s[r] = fmaf(q4.w, k4.w, s[r]);
      }
    }

    // ---- online softmax, one row at a time ----------------------------------
    const int kp = k0 + lane;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const bool valid = kp < Tk && (!causal || kp <= row0 + r);
      const float sv = valid ? s[r] * scale : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(sv));
      const float alpha = expf(m[r] - m_new);
      const float p = expf(sv - m_new);
      l[r] = l[r] * alpha + warp_sum(p);
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] *= alpha;
      pw[r * kBlockK + lane] = p;
    }
    __syncwarp();

    // ---- values: lane l accumulates columns l, l + 32, ... -------------------
    for (int j = 0; j < kBlockK; j += 4) {
      float4 p4[R];
#pragma unroll
      for (int r = 0; r < R; ++r) p4[r] = *reinterpret_cast<const float4*>(pw + r * kBlockK + j);
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int c = lane + 32 * i;
        if (c < Dp) {
          const float* vc = vs + j * Dp + c;
          const float v0 = vc[0], v1 = vc[Dp], v2 = vc[2 * Dp], v3 = vc[3 * Dp];
#pragma unroll
          for (int r = 0; r < R; ++r) {
            float a = acc[r][i];
            a = fmaf(p4[r].x, v0, a);
            a = fmaf(p4[r].y, v1, a);
            a = fmaf(p4[r].z, v2, a);
            a = fmaf(p4[r].w, v3, a);
            acc[r][i] = a;
          }
        }
      }
    }
    __syncwarp();  // the probabilities are read before the next tile rewrites them
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int qp = row0 + r;
    if (qp >= S) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    T* orow = o + qbase + static_cast<size_t>(qp) * D;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int c = lane + 32 * i;
      if (c < D) orow[c] = from_f32<T>(acc[r][i] / denom);
    }
  }
}

template <typename T, int R, int DPL>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int BH, int S,
                   int Tk, int D, float scale, int causal, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, R, DPL>;
  // Above 48 KB a kernel's dynamic shared memory must be opted into; set the
  // largest this instantiation can ask for (D = 32 * DPL) once.
  static cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_floats(R, 32 * DPL) * sizeof(float)));
  if (attr != cudaSuccess) return attr;
  const int dp = (D + 3) & ~3;
  const int bq = kWarps * R;
  const int n_qtiles = (S + bq - 1) / bq;
  const size_t smem = smem_floats(R, dp) * sizeof(float);
  const long long n_ctas = static_cast<long long>(n_qtiles) * BH;
  if (n_ctas > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(n_ctas), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, Tk, D, dp, n_qtiles, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, int BH, int S,
                     int Tk, int D, float scale, int causal, cudaStream_t stream) {
  if (D <= 32) return launch<T, 8, 1>(q, k, v, o, BH, S, Tk, D, scale, causal, stream);
  if (D <= 64) return launch<T, 8, 2>(q, k, v, o, BH, S, Tk, D, scale, causal, stream);
  if (D <= 128) return launch<T, 8, 4>(q, k, v, o, BH, S, Tk, D, scale, causal, stream);
  return launch<T, 4, 8>(q, k, v, o, BH, S, Tk, D, scale, causal, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o).  causal: 0 or 1.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int BH, int S, int T, int D, int dtype, int causal,
                                      float scale, void* stream) {
  if (BH < 1 || S < 1 || T < 1 || D < 1 || D > kMaxD) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch<float>(q, k, v, o, BH, S, T, D, scale, causal, s);
  } else if (dtype == 1) {
    err = dispatch<__nv_bfloat16>(q, k, v, o, BH, S, T, D, scale, causal, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
