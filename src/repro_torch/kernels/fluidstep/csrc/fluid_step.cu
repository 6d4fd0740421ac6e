// Fluid step core of the fluid scheduling simulator, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/fluidstep/kernel.py::_fluid_step_kernel
// and computes what it computes, for every lane of a batch in ONE launch:
//   counts[d]      = sum_j loads[j,d] & active[j]                  (int32)
//   k_eff[j]       = max(1, max_{d loaded by j} counts[d]*oversub[d])
//   k_would[j]     = max(1, max_{d loaded by j} counts[d]+1)        (int32)
//   scale[j]       = min_s (member[j,s] > 0 ? bw[s] : 1e30), 1.0 without
//                    members (the plain version's sentinel arithmetic)
//   ratio[j]       = scale * (b / (k_eff*b + (k_eff-1)*eta))       (Eq. 5)
//   min_old_rem[j] = min over d loaded by j of min{rem[i]: i active, loads d},
//                    +inf where there is none
//   overlap[i,j]   = i and j load a common domain (only when asked)
//
// What bounds it on this card: launch latency and, inside the launch, the
// chain of dependent instructions each warp issues, not bytes.  At the
// simulator's shape (8 lanes x J 160 jobs x S 16 servers x D 16 domains) a
// call moves 130 kB, which the card's memory would take 0.04 us to move;
// an empty launch on the same grid takes about 1 us in a CUDA graph, and
// the simulator calls the kernel once per tick.
//
// What the design does about that: one CTA of 512 threads per lane, every
// step parallel over all 16 warps, and the chain cut to one round of
// global loads, three barriers and few instructions per warp (a CTA of
// 1024 threads was slower: the 4 schedulers of the SM issue for all its
// warps; a cluster of CTAs per lane is the next step):
//  0. Every thread issues all its first loads at once: `active` and the
//     `loads` plane as aligned 32-bit words (neighbouring threads on
//     neighbouring words; an unaligned head and tail byte by byte),
//     `member` with one warp on consecutive floats (at J 160, S 16 all of
//     it in one batch), each entry's `bw`, and `rem`; then zeroes the
//     shared accumulators while they arrive.  The launch's divisions are
//     done on the host (a runtime integer division is some twenty
//     instructions).
//  1. Each word's 4 bytes become 4 mask bits by one multiply and are
//     OR-ed into the 32-bit halves of 64-bit per-job domain masks in
//     shared memory.  The slowest-member minimum
//     is a segmented warp `fminf` reduction over the S entries of each job
//     (at S = 16 a half-warp; one shuffle per step, the segment test
//     computed from the index), finished by one shared atomic per segment;
//     whether a job has members at all is one ballot.
//  2. Per-domain counts and minima of in-flight `rem`: a warp takes a
//     32-job group and a slice of the domains, and per domain does a
//     `__ballot_sync` + `__popc` and a 5-step `fminf` butterfly, unrolled
//     so the domains' butterflies overlap; the group partials meet in
//     shared-memory atomics.  At J 160 15 of the 16 warps take part.
//  3. One thread per job walks the set bits of its mask for k_eff,
//     k_would and min_old_rem, and writes its outputs.
//
// Exactness: counts are integers (exact in any order); minima and maxima
// are exact in any order for the values the simulator gives (no NaN; the
// float minima combined across warps through an order-preserving map of
// float bits to int, so signed values order correctly).  The float
// arithmetic of ratio uses the _rn intrinsics in the plain PyTorch
// version's operation order (k_eff*b, (k_eff-1)*eta, their sum, b/(...),
// then scale*...), and the file is built with --fmad=false, so no
// multiply-add is contracted and every plane is bit-equal to the plain
// version.  The simulator turns a one-ulp change of a remainder into a
// different finish tick, so this matters.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDomains = 64;
constexpr int kUnroll = 2;        // words in flight per thread and batch
constexpr int kMemberUnroll = 6;  // member entries in flight per thread and batch
constexpr unsigned kFull = 0xffffffffu;

// Order-preserving map of float bits to int (and back): a < b as floats
// iff key(a) < key(b) as ints, for every non-NaN value.
__device__ __forceinline__ int order_key(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ float from_key(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

// The n bytes at p as aligned 32-bit words (the unaligned head and tail
// apart), read in batches of kUnroll words per thread with neighbouring
// threads on neighbouring words.
struct ByteWords {
  const uint8_t* p;
  int n, head, n4, tail;

  __device__ ByteWords(const uint8_t* p_, int n_) : p(p_), n(n_) {
    head = min(n, (int)((4u - ((uintptr_t)p & 3u)) & 3u));
    n4 = (n - head) >> 2;
    tail = head + 4 * n4;
  }

  __device__ void load(int i0, uint32_t (&v)[kUnroll]) const {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(p + head);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kThreads + (int)threadIdx.x;
      v[u] = i < n4 ? __ldg(w + i) : 0u;
    }
  }

  // f(index of the first byte, bytes as a little-endian word, count) for
  // every byte: the first batch from v (loaded by the caller), the rest
  // loaded here.
  template <typename F>
  __device__ void for_each(uint32_t (&v)[kUnroll], F f) const {
    const int tid = threadIdx.x;
    if (tid < head) f(tid, (uint32_t)p[tid], 1);
    if (tid < n - tail) f(tail + tid, (uint32_t)p[tail + tid], 1);
    for (int i0 = 0; i0 < n4; i0 += kThreads * kUnroll) {
      if (i0) load(i0, v);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + u * kThreads + tid;
        if (i < n4) f(head + 4 * i, v[u], 4);
      }
    }
  }
};

// Writes the n bytes at p, byte k = g(k): the aligned middle as 32-bit
// words, the unaligned head and tail byte by byte.  g(k, count) returns
// the count bytes from k on as a little-endian word.
template <typename G>
__device__ __forceinline__ void write_bytes(uint8_t* __restrict__ p, long long n, G g) {
  const int tid = threadIdx.x;
  const long long head = min(n, (long long)((4u - ((uintptr_t)p & 3u)) & 3u));
  const long long n4 = (n - head) >> 2;
  const long long tail = head + 4 * n4;
  if (tid < head) p[tid] = (uint8_t)g(tid, 1);
  if (tid < n - tail) p[tail + tid] = (uint8_t)g(tail + tid, 1);
  uint32_t* w = reinterpret_cast<uint32_t*>(p + head);
  for (long long i = tid; i < n4; i += kThreads) w[i] = g(head + 4 * i, 4);
}

// The launch's shape and the divisions it needs, done once on the host:
// a runtime integer division is some twenty instructions, and the kernel
// is bound by its chain of instructions, not by bytes.
struct Shape {
  int J, S, D;
  float b, eta;
  unsigned long long div_s, div_d;  // ceil(2^32 / S), ceil(2^32 / D)
  int member_drow, member_dcol;     // kThreads entries as (jobs, servers)
  int word_drow, word_dcol;         // 4 * kThreads bytes as (jobs, domains)
  int per_group, stride, slice;     // phase 2's warps per group, groups in flight, domains per warp
};

// x / d as (x * ceil(2^32 / d)) >> 32: exact for 0 <= x with x * d < 2^32.
__device__ __forceinline__ int quot(int x, unsigned long long div) {
  return (int)(((unsigned long long)(unsigned)x * div) >> 32);
}

// Row and column of a flat index into a row-major plane `width` wide,
// stepped by a fixed stride (drow rows and dcol columns) without dividing.
struct RowCol {
  int row, col, width, drow, dcol;

  __device__ RowCol(int index, int width_, unsigned long long div, int drow_, int dcol_)
      : width(width_), drow(drow_), dcol(dcol_) {
    row = quot(index, div);
    col = index - row * width;
  }

  __device__ void step() {
    row += drow;
    col += dcol;
    if (col >= width) {
      col -= width;
      ++row;
    }
  }
};

// The 4 bytes of a bool word as 4 bits, byte k to bit k (any nonzero byte
// is true): each byte's bits folded into its bit 0, then the four bits
// gathered by one multiply (byte k times 2^(21-7k) lands on bit 21+k, and
// no two partial products meet).
__device__ __forceinline__ unsigned word_bits(uint32_t w) {
  w |= w >> 4;
  w |= w >> 2;
  w |= w >> 1;
  return ((w & 0x01010101u) * 0x00204081u) >> 21 & 0xfu;
}

// A batch of the lane's member plane (J rows of S floats, one warp on
// consecutive floats), the bandwidth of each entry's server, and each
// entry's job and server.
__device__ __forceinline__ void load_member(const float* __restrict__ mp,
                                            const float* __restrict__ bw, int J, int e0,
                                            RowCol& pos, float (&mv)[kMemberUnroll],
                                            float (&bv)[kMemberUnroll], int (&js)[kMemberUnroll],
                                            int (&ss)[kMemberUnroll]) {
#pragma unroll
  for (int u = 0; u < kMemberUnroll; ++u) {
    const int e = e0 + u * kThreads + (int)threadIdx.x;
    const bool valid = pos.row < J;
    js[u] = pos.row;
    ss[u] = pos.col;
    mv[u] = valid ? mp[e] : 0.0f;
    bv[u] = valid ? __ldg(bw + pos.col) : 0.0f;
    pos.step();
  }
}

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
    const Shape shape) {
  const int J = shape.J, S = shape.S, D = shape.D;
  const float b = shape.b, eta = shape.eta;
  // dynamic: s_mask (J u64), s_lo (J int), s_has (J int), s_rem (J f32),
  // s_act (J u8)
  extern __shared__ unsigned long long s_mask[];
  int* s_lo = reinterpret_cast<int*>(s_mask + J);
  int* s_has = s_lo + J;
  float* s_rem = reinterpret_cast<float*>(s_has + J);
  uint8_t* s_act = reinterpret_cast<uint8_t*>(s_rem + J);
  __shared__ int s_cnt[kMaxDomains];
  __shared__ int s_min[kMaxDomains];
  __shared__ float s_ov[kMaxDomains];

  const int tid = threadIdx.x;
  const int lane_id = tid & 31;
  const int warp = tid >> 5;
  const long long lane = blockIdx.x;
  const float inf = __int_as_float(0x7f800000);

  // ---- 0. every first load in flight, then the shared accumulators ------
  const ByteWords act_rows(active + lane * J, J);
  const ByteWords load_rows(loads + lane * J * D, J * D);
  const float* mp = member + lane * J * (long long)S;
  const int n_member = J * S;
  uint32_t av[kUnroll], lv[kUnroll];
  float mv[kMemberUnroll], bv[kMemberUnroll];
  int js[kMemberUnroll], ss[kMemberUnroll];
  RowCol member_pos(tid, S, shape.div_s, shape.member_drow, shape.member_dcol);
  act_rows.load(0, av);
  load_rows.load(0, lv);
  load_member(mp, bw, J, 0, member_pos, mv, bv, js, ss);
  const float rem0 = tid < J ? rem[lane * J + tid] : 0.0f;
  RowCol word_pos(load_rows.head + 4 * tid, D, shape.div_d, shape.word_drow, shape.word_dcol);
  for (int j = tid; j < J; j += kThreads) {
    s_mask[j] = 0ull;
    s_lo[j] = order_key(inf);
    s_has[j] = 0;
  }
  if (tid < D) {
    s_cnt[tid] = 0;
    s_min[tid] = order_key(inf);
    s_ov[tid] = oversub[tid];
  }
  __syncthreads();

  // ---- 1. per-job rows into shared memory ---------------------------------
  if (tid < J) s_rem[tid] = rem0;
  for (int j = tid + kThreads; j < J; j += kThreads) s_rem[j] = rem[lane * J + j];
  act_rows.for_each(av, [&](int first, uint32_t word, int nb) {
    for (int k = 0; k < nb; ++k) s_act[first + k] = (word >> (8 * k)) & 0xffu ? 1 : 0;
  });
  // domain masks: each word's bytes as bits, OR-ed into the 32-bit halves
  // of the job masks they fall in
  {
    auto put = [&](int j, int d, unsigned bits, int nb) {
      while (nb > 0) {
        const int take = min(nb, D - d);
        const unsigned long long m = (unsigned long long)(bits & ((1u << take) - 1u)) << d;
        unsigned* half = reinterpret_cast<unsigned*>(s_mask + j);
        if ((unsigned)m) atomicOr(half, (unsigned)m);
        if (m >> 32) atomicOr(half + 1, (unsigned)(m >> 32));
        bits >>= take;
        nb -= take;
        d = 0;
        ++j;
      }
    };
    const ByteWords& w = load_rows;
    if (tid < w.head) {
      const int q = quot(tid, shape.div_d);
      put(q, tid - q * D, w.p[tid] != 0, 1);
    }
    if (tid < w.n - w.tail) {
      const int k = w.tail + tid;
      const int q = quot(k, shape.div_d);
      put(q, k - q * D, w.p[k] != 0, 1);
    }
    for (int i0 = 0; i0 < w.n4; i0 += kThreads * kUnroll) {
      if (i0) w.load(i0, lv);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (i0 + u * kThreads + tid < w.n4) put(word_pos.row, word_pos.col, word_bits(lv[u]), 4);
        word_pos.step();
      }
    }
  }
  // slowest member: a segmented warp minimum over each job's S entries
  // (entries run along the warp, so lane i takes in lane i+off when both
  // lie in one job: r + off < S); `has` from one ballot
  for (int e0 = 0; e0 < n_member; e0 += kThreads * kMemberUnroll) {
    if (e0) load_member(mp, bw, J, e0, member_pos, mv, bv, js, ss);
#pragma unroll
    for (int u = 0; u < kMemberUnroll; ++u) {
      if (e0 + u * kThreads >= n_member) break;  // the same for the whole CTA
      const int j = js[u];
      const int r = ss[u];
      const bool valid = j < J;
      const bool is_member = valid && mv[u] > 0.0f;
      float v = is_member ? bv[u] : 1e30f;
      const unsigned members = __ballot_sync(kFull, is_member);
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        if (off < S) {  // the same for the whole CTA
          const float ov = __shfl_down_sync(kFull, v, off);
          if (lane_id + off < 32 && r + off < S) v = fminf(v, ov);
        }
      }
      if (valid && (r == 0 || lane_id == 0)) {
        const int len = min(S - r, 32 - lane_id);
        const unsigned seg = len >= 32 ? kFull : ((1u << len) - 1u);
        atomicMin(&s_lo[j], order_key(v));
        if ((members >> lane_id) & seg) s_has[j] = 1;
      }
    }
  }
  __syncthreads();

  // ---- 2. per-domain counts and minima ------------------------------------
  // A warp takes one 32-job group and a slice of the domains: per domain a
  // ballot + popc and an fminf butterfly, independent across domains.
  {
    const int groups = (J + 31) >> 5;
    const int per_group = shape.per_group, stride = shape.stride;
    const int d0 = (warp - (warp / per_group) * per_group) * shape.slice;
    const int d1 = min(D, d0 + shape.slice);
    for (int g = warp / per_group; warp < per_group * stride && g < groups; g += stride) {
      const int j = (g << 5) + lane_id;
      const unsigned long long m = (j < J && s_act[j]) ? s_mask[j] : 0ull;
      const float rj = j < J ? s_rem[j] : inf;
      int cnt0 = 0, cnt1 = 0;
      float mn0 = inf, mn1 = inf;
#pragma unroll 4
      for (int d = d0; d < d1; ++d) {
        const bool in = (m >> d) & 1ull;
        const unsigned bal = __ballot_sync(kFull, in);
        float v = in ? rj : inf;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, off));
        if (lane_id == ((d - d0) & 31)) {
          if (d - d0 < 32) {
            cnt0 = __popc(bal);
            mn0 = v;
          } else {
            cnt1 = __popc(bal);
            mn1 = v;
          }
        }
      }
      if (d0 + lane_id < d1 && cnt0) {
        atomicAdd(&s_cnt[d0 + lane_id], cnt0);
        atomicMin(&s_min[d0 + lane_id], order_key(mn0));
      }
      if (d0 + 32 + lane_id < d1 && cnt1) {
        atomicAdd(&s_cnt[d0 + 32 + lane_id], cnt1);
        atomicMin(&s_min[d0 + 32 + lane_id], order_key(mn1));
      }
    }
  }
  __syncthreads();

  // ---- 3. per-job outputs ------------------------------------------------
  if (tid < D) counts[lane * D + tid] = s_cnt[tid];
  for (int j = tid; j < J; j += kThreads) {
    const unsigned long long m = s_mask[j];
    float ke = 0.0f;
    int kw = 0;
    float mo = inf;
    unsigned long long rest = m;
    while (rest) {
      const int d = __ffsll((long long)rest) - 1;
      rest &= rest - 1ull;
      const int c = s_cnt[d];
      ke = fmaxf(ke, __fmul_rn((float)c, s_ov[d]));
      kw = max(kw, c + 1);
      mo = fminf(mo, from_key(s_min[d]));
    }
    ke = fmaxf(ke, 1.0f);
    kw = max(kw, 1);
    const float scale = s_has[j] ? from_key(s_lo[j]) : 1.0f;
    const float denom = __fadd_rn(__fmul_rn(ke, b), __fmul_rn(__fsub_rn(ke, 1.0f), eta));
    const long long o = lane * J + j;
    k_eff[o] = ke;
    ratio[o] = __fmul_rn(scale, __fdiv_rn(b, denom));
    k_would[o] = kw;
    min_old_rem[o] = mo;
  }

  if (overlap != nullptr) {
    write_bytes(overlap + lane * J * (long long)J, (long long)J * J,
                [&](long long first, int nb) {
      int i = (int)(first / J);
      int j = (int)(first - (long long)i * J);
      uint32_t word = 0u;
      for (int k = 0; k < nb; ++k) {
        if (s_mask[i] & s_mask[j]) word |= 1u << (8 * k);
        if (++j == J) {
          j = 0;
          ++i;
        }
      }
      return word;
    });
  }
}

// An empty kernel on the fluid step's grid: its time in a CUDA graph is
// the card's launch floor for this grid, the least any kernel of the
// simulator's tick can take.
__global__ void __launch_bounds__(kThreads) empty_kernel() {}

size_t shared_bytes(int J) {
  return (size_t)J * (sizeof(unsigned long long) + 3 * sizeof(int) + 1);
}

}  // namespace

// Largest dynamic shared memory a CTA of this card may use (227 KB).
extern "C" int fluid_step_core_max_jobs() {
  return (int)((232448 - 3 * kMaxDomains * 4) / shared_bytes(1));
}

// Launch on `stream` (PyTorch's current stream); returns cudaGetLastError().
extern "C" int fluid_step_core_launch(
    const void* loads, const void* member, const void* active, const void* rem,
    const void* bw, const void* oversub, void* counts, void* k_eff, void* ratio,
    void* k_would, void* min_old_rem, void* overlap, int L, int J, int S, int D,
    float b, float eta, void* stream) {
  if (L < 1 || J < 1 || S < 1 || D < 1 || D > kMaxDomains ||
      J > fluid_step_core_max_jobs()) {
    return (int)cudaErrorInvalidValue;
  }
  Shape shape;
  shape.J = J;
  shape.S = S;
  shape.D = D;
  shape.b = b;
  shape.eta = eta;
  shape.div_s = ((1ull << 32) + S - 1) / S;
  shape.div_d = ((1ull << 32) + D - 1) / D;
  shape.member_drow = kThreads / S;
  shape.member_dcol = kThreads % S;
  shape.word_drow = 4 * kThreads / D;
  shape.word_dcol = 4 * kThreads % D;
  const int groups = (J + 31) / 32;
  shape.per_group = groups < kWarps ? kWarps / groups : 1;
  shape.stride = kWarps / shape.per_group;
  shape.slice = (D + shape.per_group - 1) / shape.per_group;
  const size_t smem = shared_bytes(J);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fluid_step_core_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  fluid_step_core_kernel<<<L, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)loads, (const float*)member, (const uint8_t*)active,
      (const float*)rem, (const float*)bw, (const float*)oversub, (int32_t*)counts,
      (float*)k_eff, (float*)ratio, (int32_t*)k_would, (float*)min_old_rem,
      (uint8_t*)overlap, shape);
  return (int)cudaGetLastError();
}

// The empty kernel on the same grid (L CTAs of 512 threads).
extern "C" int fluid_step_empty_launch(int L, void* stream) {
  if (L < 1) return (int)cudaErrorInvalidValue;
  empty_kernel<<<L, kThreads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
