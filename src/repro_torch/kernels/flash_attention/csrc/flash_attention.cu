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
// Two paths, chosen by dtype:
//
//   bfloat16, any D <= 256: the tensor-core kernel (flash_fwd_tc_kernel),
//   below, instantiated for D padded to 64, 128 or 256;
//   float32, any D <= 256: the float32-core kernel (flash_fwd_kernel),
//   the arithmetic of its first version.  float32 stays there because its bar
//   (2e-5 against the plain version) and the reduced float32 config's
//   tokens rest on full float32 products, which TF32 tensor cores would
//   break.
//
// What bounds it on the card: at the serve shape (BH 256, S = T 512, D 64,
// bf16) the bytes (q, k, v read once, out written once: 67 MB, 20 us at
// 3.35 TB/s) outweigh the causal products (8.6 GFLOP, 8.7 us on the bf16
// tensor cores at their wgmma rate).  The tensor-core kernel issues
// mma.sync (FlashAttention-2's structure), which reaches a fraction of
// that rate, so it is bound by tensor-core issue and the online softmax's
// float32 work between the two products; wgmma with TMA and warp
// specialisation (FlashAttention-3's structure) is the step after it.
//
// Tensor-core design: a CTA of 4 warps owns 64 query rows of one bh, 16
// rows a warp, and walks kv tiles of 64 keys up to its last row's
// diagonal (tiles above it are never loaded); query tiles are issued
// heaviest (latest) first across all bh.  K and V tiles are copied as
// bf16 into shared memory with 16-byte cp.async (cg) into a 2-stage ring,
// so tile j+1 loads while tile j computes; rows at or past T and columns
// at or past D are zero-filled by the copy (src-size 0).  Rows are
// XOR-swizzled in 16-byte chunks (chunk ^ row % 8), so the 8 rows that
// one ldmatrix phase reads fall in 8 different bank groups.  Q is copied
// the same way once and, for DP <= 128, held in registers as mma
// A-fragments.  Scores:
// mma.sync.m16n8k16 bf16 x bf16 -> float32, K fragments by ldmatrix.  The
// online softmax runs on the accumulator fragments: a row lives in a quad
// of lanes, so its max is two shfl_xor; exponentials are ex2.approx with
// scale * log2(e) folded into the scores (roundings of their own, at
// float32 round-off; 5 % faster than exp2f at the serve shape on an H100).
// Values: the same mma, V fragments by ldmatrix.trans, P passed from the
// score accumulator straight into bf16 A-fragments in registers.
// Output: divided once by max(l, 1e-30), rounded once to bf16, staged in
// shared memory and written as 16-byte stores.  D is padded with zeros to
// 64, 128 or 256 in shared memory (template DP); where 16-byte copies
// cannot be used (D not a multiple of 8, or a pointer not 16-byte aligned)
// the same kernel stages with plain loads and stores.
//
// At DP 256 (gemma-7b's head dim) the registers set the design: a warp's
// 16 x 256 float32 accumulator is 128 registers a thread and a 16 x 64
// score tile 32 more, so the 64 registers of Q's A-fragments do not fit
// beside them.  Q stays in shared memory and each 16-wide column chunk's
// fragment is read with ldmatrix just before its products, once per kv
// tile (16 ldmatrix.x4 more a tile, against 64 for K and 64 for V).
// Shared memory is Q 32 KB + 2 stages x (K + V) 128 KB = 160 KB, opted
// into; one CTA of 4 warps per SM.
//
// Rounding against the kernel's plain version (ref.py): P is rounded to
// bf16 before the product with V (the mma takes bf16 operands), where
// ref.py keeps it in float32; l is summed from the unrounded float32 p.
// The reference model rounds its probabilities to bf16 before that product
// too (src/repro/models/attention.py, ROADMAP R7), so in bf16 the kernel
// moves toward the model.  Scores, the running max and sum, and the
// accumulator stay float32.
//
// Float32-core design (simple first): one CTA of 4 warps per (bh, tile of
// 4*R query rows); each warp owns R rows.  The Q tile is staged once in
// shared memory as float32; K and V tiles of 32 keys are staged in turn
// (rows past T zeroed).  Score pass: lane j takes key j of the tile and computes its dot
// product with the warp's R rows (K row from shared memory as float4, Q rows
// as float4 broadcasts), so no shuffle is needed per score; the row max and
// sum of the online softmax are warp butterflies, once per row per tile.
// Value pass: the probabilities go through shared memory (float4
// broadcasts), and lane l accumulates output columns l, l+32, ... (DPL of
// them, so D = 256 needs 8 per lane and no thread holds a whole row).
// A warp skips the tiles above its own last row; the CTA stops at its last
// row's diagonal.  Query tiles are issued heaviest (latest) first in each bh.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockK = 32;                 // keys per tile, one per lane
constexpr float kNegInf = -1073741824.0f;   // -2^30, the reference's NEG_INF
constexpr int kMaxD = 256;


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
template <int R, int DPL>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int S, int Tk, int D,
                 int Dp, int n_qtiles, float scale, int causal) {
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
    qs[idx] = (qp < S && c < D) ? q[qbase + static_cast<size_t>(qp) * D + c] : 0.f;
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
      ks[r * ldk + c] = ok ? k[g] : 0.f;
      vs[r * Dp + c] = ok ? v[g] : 0.f;
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
    float* orow = o + qbase + static_cast<size_t>(qp) * D;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int c = lane + 32 * i;
      if (c < D) orow[c] = acc[r][i] / denom;
    }
  }
}

template <int R, int DPL>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int BH, int S,
                   int Tk, int D, float scale, int causal, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<R, DPL>;
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
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, Tk, D, dp, n_qtiles, scale, causal);
  return cudaGetLastError();
}

cudaError_t dispatch_f32(const void* q, const void* k, const void* v, void* o, int BH, int S,
                         int Tk, int D, float scale, int causal, cudaStream_t stream) {
  if (D <= 32) return launch<8, 1>(q, k, v, o, BH, S, Tk, D, scale, causal, stream);
  if (D <= 64) return launch<8, 2>(q, k, v, o, BH, S, Tk, D, scale, causal, stream);
  if (D <= 128) return launch<8, 4>(q, k, v, o, BH, S, Tk, D, scale, causal, stream);
  return launch<4, 8>(q, k, v, o, BH, S, Tk, D, scale, causal, stream);
}

// ---------------------------------------------------------------------------
// bfloat16 tensor-core path (D <= 256)
// ---------------------------------------------------------------------------

constexpr int kTcRows = 64;  // query rows per CTA, 16 per warp
constexpr int kTcKeys = 64;  // keys per kv tile
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kTcRows == kTcKeys, "load_tile stages Q, K and V tiles of one height");

// Shared memory, in bf16 elements: Q [64][DP], then two stages of
// K [64][DP] and V [64][DP]; every row XOR-swizzled in 16-byte chunks.
__host__ __device__ constexpr size_t tc_smem_bytes(int dp) {
  return static_cast<size_t>(kTcRows + 4 * kTcKeys) * dp * sizeof(__nv_bfloat16);
}

// Element offset of the 16-byte chunk that holds column col of row r in a
// [rows][DP] tile (add col % 8 for the element itself).
template <int DP>
__device__ __forceinline__ int swz(int r, int col) {
  return r * DP + (((col >> 3) ^ (r & 7)) << 3);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; src_bytes 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

// d += a (16x16, row) * b (16x8, col); bf16 operands, float32 accumulator.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit (relative error ~2^-22; subnormal
// results flush to zero, far below what a bf16 p or the float32 sum keeps).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two floats rounded to bf16 and packed, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Rows [row0, row0 + 64) of a (n_rows, D) matrix into a swizzled [64][DP]
// tile; rows at or past n_rows and columns at or past D become zeros.
template <int DP>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src, int row0,
                                          int n_rows, int D, bool vec) {
  if (vec) {  // D % 8 == 0 and 16-byte aligned pointers: asynchronous copies
    constexpr int kChunks = DP / 8;
#pragma unroll
    for (int idx = threadIdx.x; idx < kTcKeys * kChunks; idx += kThreads) {
      const int r = idx / kChunks;
      const int c = idx % kChunks;
      const bool ok = row0 + r < n_rows && c * 8 < D;
      const __nv_bfloat16* g = ok ? src + static_cast<size_t>(row0 + r) * D + c * 8 : src;
      cp_async16(dst + swz<DP>(r, c * 8), g, ok ? 16 : 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < kTcKeys * DP; idx += kThreads) {
      const int r = idx / DP;
      const int c = idx % DP;
      const bool ok = row0 + r < n_rows && c < D;
      dst[swz<DP>(r, c) + (c & 7)] =
          ok ? src[static_cast<size_t>(row0 + r) * D + c] : __float2bfloat16_rn(0.f);
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int BH,
                    int S, int Tk, int D, int n_qtiles, float scale_log2, int causal, int vec) {
  constexpr int kKC = DP / 16;  // 16-wide column chunks of q and k (mma depth)
  constexpr int kNT = DP / 8;   // 8-wide output column tiles
  // Q's A-fragments in registers for every chunk; at DP 256 read per chunk
  // from shared memory instead (the accumulator leaves no room)
  constexpr bool kQInRegs = DP <= 128;
  extern __shared__ uint4 smem_tc[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_tc);
  __nv_bfloat16* kv = qs + kTcRows * DP;  // stage st: K at kv + st * 2 * 64 * DP, V after it

  // heaviest (latest) query tiles of every bh first
  const int qt = n_qtiles - 1 - static_cast<int>(blockIdx.x / BH);
  const int bh = static_cast<int>(blockIdx.x % BH);
  const int q0 = qt * kTcRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row (and row + 8)
  const int tq = lane & 3;  // fragment column pair
  const __nv_bfloat16* qg = q + static_cast<size_t>(bh) * S * D;
  const __nv_bfloat16* kg = k + static_cast<size_t>(bh) * Tk * D;
  const __nv_bfloat16* vg = v + static_cast<size_t>(bh) * Tk * D;
  const int k_end = causal ? min(Tk, q0 + kTcRows) : Tk;
  const int n_tiles = (k_end + kTcKeys - 1) / kTcKeys;
  const int row_a = q0 + warp * 16 + g;  // this thread's rows: row_a and row_a + 8

  load_tile<DP>(qs, qg, q0, S, D, vec);
  load_tile<DP>(kv, kg, 0, Tk, D, vec);
  load_tile<DP>(kv + kTcKeys * DP, vg, 0, Tk, D, vec);
  cp_async_commit();

  uint32_t qf[kQInRegs ? kKC : 1][4];
  float acc[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};  // running max, in log2 units
  float l[2] = {0.f, 0.f};          // this thread's part of the running sum

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kTcKeys;
    if (it + 1 < n_tiles) {  // prefetch the next tile into the other stage
      __nv_bfloat16* nxt = kv + ((it + 1) & 1) * 2 * kTcKeys * DP;
      load_tile<DP>(nxt, kg, k0 + kTcKeys, Tk, D, vec);
      load_tile<DP>(nxt + kTcKeys * DP, vg, k0 + kTcKeys, Tk, D, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile it (and, first, Q) has landed for every thread
    if constexpr (kQInRegs) {
      if (it == 0) {
#pragma unroll
        for (int kc = 0; kc < kKC; ++kc)
          ldmatrix_x4(qf[kc], qs + swz<DP>(warp * 16 + (lane & 15), kc * 16 + (lane >> 4) * 8));
      }
    }
    const __nv_bfloat16* ks = kv + (it & 1) * 2 * kTcKeys * DP;
    const __nv_bfloat16* vs = ks + kTcKeys * DP;

    // ---- scores: S = Q K^T, 16 rows x 64 keys a warp ------------------------
    float sc[kTcKeys / 8][4];
#pragma unroll
    for (int j = 0; j < kTcKeys / 8; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < kKC; ++kc) {
      if constexpr (!kQInRegs)
        ldmatrix_x4(qf[0], qs + swz<DP>(warp * 16 + (lane & 15), kc * 16 + (lane >> 4) * 8));
      const uint32_t(&qa)[4] = qf[kQInRegs ? kc : 0];
#pragma unroll
      for (int np = 0; np < kTcKeys / 16; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, ks + swz<DP>(np * 16 + (lane & 7) + ((lane >> 4) << 3),
                                    kc * 16 + ((lane >> 3) & 1) * 8));
        mma_bf16(sc[2 * np], qa, b[0], b[1]);
        mma_bf16(sc[2 * np + 1], qa, b[2], b[3]);
      }
    }

    // ---- online softmax on the fragments (log2 units) ------------------------
    const bool need_mask = k0 + kTcKeys > Tk || (causal && k0 + kTcKeys - 1 > q0);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < kTcKeys / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[j][e] * scale_log2;
        if (need_mask) {
          const int key = k0 + j * 8 + 2 * tq + (e & 1);
          const int row = row_a + (e >> 1) * 8;
          if (key >= Tk || (causal && key > row)) x = kNegInf;
        }
        sc[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    }
    const float alpha[2] = {ex2(m[0] - mx[0]), ex2(m[1] - mx[1])};
    m[0] = mx[0];
    m[1] = mx[1];
    float ls[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kTcKeys / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[j][e] = ex2(sc[j][e] - mx[e >> 1]);
        ls[e >> 1] += sc[j][e];  // l from the unrounded float32 p
      }
    }
    l[0] = l[0] * alpha[0] + ls[0];
    l[1] = l[1] * alpha[1] + ls[1];
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // ---- values: acc += P V, P rounded to bf16 in registers ------------------
#pragma unroll
    for (int kc = 0; kc < kTcKeys / 16; ++kc) {
      const uint32_t pa[4] = {pack_bf16(sc[2 * kc][0], sc[2 * kc][1]),
                              pack_bf16(sc[2 * kc][2], sc[2 * kc][3]),
                              pack_bf16(sc[2 * kc + 1][0], sc[2 * kc + 1][1]),
                              pack_bf16(sc[2 * kc + 1][2], sc[2 * kc + 1][3])};
#pragma unroll
      for (int dp = 0; dp < kKC; ++dp) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vs + swz<DP>(kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                          dp * 16 + (lane >> 4) * 8));
        mma_bf16(acc[2 * dp], pa, b[0], b[1]);
        mma_bf16(acc[2 * dp + 1], pa, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // ---- output: acc / max(l, 1e-30), rounded once, through shared memory -----
  float denom[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float t = l[h] + __shfl_xor_sync(0xffffffffu, l[h], 1);
    t += __shfl_xor_sync(0xffffffffu, t, 2);
    denom[h] = fmaxf(t, 1e-30f);
  }
  const int r0 = warp * 16 + g;
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    *reinterpret_cast<__nv_bfloat162*>(qs + swz<DP>(r0, j * 8) + 2 * tq) =
        __floats2bfloat162_rn(acc[j][0] / denom[0], acc[j][1] / denom[0]);
    *reinterpret_cast<__nv_bfloat162*>(qs + swz<DP>(r0 + 8, j * 8) + 2 * tq) =
        __floats2bfloat162_rn(acc[j][2] / denom[1], acc[j][3] / denom[1]);
  }
  __syncthreads();
  __nv_bfloat16* og = o + static_cast<size_t>(bh) * S * D;
  if (vec) {
    constexpr int kChunks = DP / 8;
#pragma unroll
    for (int idx = threadIdx.x; idx < kTcRows * kChunks; idx += kThreads) {
      const int r = idx / kChunks;
      const int c = idx % kChunks;
      if (q0 + r < S && c * 8 < D) {
        *reinterpret_cast<uint4*>(og + static_cast<size_t>(q0 + r) * D + c * 8) =
            *reinterpret_cast<const uint4*>(qs + swz<DP>(r, c * 8));
      }
    }
  } else {
    for (int idx = threadIdx.x; idx < kTcRows * DP; idx += kThreads) {
      const int r = idx / DP;
      const int c = idx % DP;
      if (q0 + r < S && c < D) og[static_cast<size_t>(q0 + r) * D + c] = qs[swz<DP>(r, c) + (c & 7)];
    }
  }
}

template <int DP>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o, int BH, int S,
                      int Tk, int D, float scale, int causal, cudaStream_t stream) {
  auto kernel = flash_fwd_tc_kernel<DP>;
  static cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(tc_smem_bytes(DP)));
  if (attr != cudaSuccess) return attr;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o);
  const int vec = D % 8 == 0 && addr % 16 == 0;
  const int n_qtiles = (S + kTcRows - 1) / kTcRows;
  const long long n_ctas = static_cast<long long>(n_qtiles) * BH;
  if (n_ctas > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kernel<<<static_cast<unsigned>(n_ctas), kThreads, tc_smem_bytes(DP), stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), BH, S, Tk, D,
      n_qtiles, scale * kLog2e, causal, vec);
  return cudaGetLastError();
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
    err = dispatch_f32(q, k, v, o, BH, S, T, D, scale, causal, s);
  } else if (dtype == 1 && D <= 64) {
    err = launch_tc<64>(q, k, v, o, BH, S, T, D, scale, causal, s);
  } else if (dtype == 1 && D <= 128) {
    err = launch_tc<128>(q, k, v, o, BH, S, T, D, scale, causal, s);
  } else if (dtype == 1) {
    err = launch_tc<256>(q, k, v, o, BH, S, T, D, scale, causal, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
