// Paged flash-decode for Hopper (sm_90a): one new query token per sequence
// over a paged KV cache, split over blocks along the sequence and merged by
// log-sum-exp in the same launch.
//
// Replaces: repro/kernels/paged_attention/kernel.py, paged_decode_attention_p
// (Pallas body _decode_kernel). Same function: s = q.k * hd^-0.5, optional
// cap * tanh(s / cap), positions >= seq_len excluded, max / sum /
// accumulator in f32, the sum clamped at 1e-30, output in q's dtype.
//
// What bounds it on an H100: every K and V element of the live tokens is
// read once and used for G (query heads per KV head, 4 for llama3-8b)
// multiply-adds, ~4 FLOP per byte: far under the CUDA cores' ridge, so the
// KV read from device memory bounds it at long contexts, and the latency of
// one block's chain of dependent reads at short ones.
//
// Design. The TPU kernel walked a (batch, page) grid in order and carried
// m / l / acc across grid steps. Here split j of a sequence covers tokens
// [64 j, 64 j + 64): the boundaries depend on the token position alone (not
// on the batch, the table width or the card), and each live split's
// (m, l, acc) is computed by the same arithmetic wherever it runs, so a
// row's result does not depend on the batch around it. The grid is (split
// group, KV head, sequence). A block (8 warps) holds its KV head's G query
// rows, so each K/V element is read once for all G rows, and walks a group
// of consecutive splits: one split while one wave of blocks holds every
// split of the call (decode at serving batch sizes), else as many as fill
// one wave (long contexts). A block whose first split starts at or past
// seq_len returns as soon as it has read seq_len. A live block
//   1. reads seq_len, its splits' table entries and q, all at once;
//   2. keeps its splits' K/V rows in a cp.async ring of two slots, one split
//      each, so the next split's rows are in flight while this one is
//      computed; a split's rows come in two commit groups of 32 tokens (the
//      second half lands while the first is scored), 16 bytes a copy, each
//      token's page looked up in the table (any page size), in the input
//      type, converted at use;
//   3. scores: lane = token, each lane the dot products of its own K row
//      with a pair of q rows (K rows padded by 16 bytes, so the lanes hit
//      distinct banks; q read as a broadcast); a warp per row then takes
//      the split's max m and sum l; p.V goes into the f32 accumulator, a
//      thread per 16-byte column chunk and pair of rows (threads that would
//      idle at small G take slices of the tokens, whose partial sums are
//      then added slice by slice, in order);
//   4. if the sequence has one live split, writes acc / max(l, 1e-30);
//      otherwise writes each split's (m, l, acc) to the workspace, fences,
//      and adds its live splits to the (sequence, KV head) counter. The block
//      that completes the count merges the live splits in split order
//      (M = max m_j, weights exp(m_j - M), L = sum l_j w_j, A = sum acc_j
//      w_j), writes A / max(L, 1e-30), and resets the counter for the next
//      call on the stream.
// Head dims 16, 32, 64, 80, 128 and 256. A K/V row is HD * sizeof(T) / 16
// vectors of 16 bytes (VPR: 10 or 20 at hd 80, not a power of two), so the
// copy and p.V thread mappings use the first (THREADS / VPR) * VPR threads
// and leave the rest idle. The ring has two slots where two fit in a block's
// shared memory at G = 64 and a walk of 16 splits, else one (f32 at hd 256:
// one split's K and V are 132 KB), in which case a block loads its next
// split only after it has computed the last one.
// Only live splits are counted, so the counter waits for no block that
// returned early. Tokens at or past seq_len, whole pages named past it and
// the tail of the last page are never read. The pages must start on a
// 16-byte boundary. seq_len >= 1 is the contract (the engine never passes
// 0; a sequence of 0 gets zeros); seq_len past the table counts as the
// table's last token.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int T_SPLIT = 64;          // tokens per split
constexpr int HALF = 32;             // tokens per commit group: one per lane when scoring
constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int MAX_SLICES = 8;        // token slices of one row in p.V
constexpr int MAX_BLOCK_SPLITS = 16; // splits one block walks, at most
constexpr int RING = 2;              // slots of the ring, one split each
constexpr float NEG_INF = -1e30f;
constexpr int SCRATCH_TOO_SMALL = -1;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T> struct Vec;  // a 16-byte vector of T
template <> struct Vec<float> { static constexpr int N = 4; using U = float4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int N = 8; using U = uint4; };

__device__ __forceinline__ void unpack(const float4& u, float (&out)[4]) {
  out[0] = u.x, out[1] = u.y, out[2] = u.z, out[3] = u.w;
}

// bf16 -> f32 is exact: the bf16 bits are the high half of the f32's
__device__ __forceinline__ void unpack(const uint4& u, float (&out)[8]) {
  const unsigned int h[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(h[i] << 16);
    out[2 * i + 1] = __uint_as_float(h[i] & 0xffff0000u);
  }
}

template <int N> __device__ __forceinline__ void store(float* dst, const float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 4) *reinterpret_cast<float4*>(dst + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
}

template <int N> __device__ __forceinline__ void store(__nv_bfloat16* dst, const float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 2) *reinterpret_cast<__nv_bfloat162*>(dst + i) = __floats2bfloat162_rn(v[i], v[i + 1]);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// wait until at most n of this thread's commit groups are still in flight
__device__ __forceinline__ void wait_groups(int n) {
  static_assert(2 * RING - 1 <= 3, "one case per count");
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

template <typename T, int HD> struct Plan {
  static constexpr int V = Vec<T>::N, VPR = HD / V;        // 16-byte vectors of a K/V row
  static constexpr int NGG = THREADS / VPR;                // thread groups in p.V, one chunk per thread
  static constexpr int USED = NGG * VPR;                   // threads that copy and take p.V chunks
  static_assert(HD % V == 0 && VPR <= THREADS, "a row is whole 16-byte vectors, one thread each at most");
  static constexpr int KROW = HD * sizeof(T) + 16;         // bytes of a K row in shared memory, padded
  static constexpr int STAGE = T_SPLIT * (KROW + HD * sizeof(T));  // one split's K and V
  // Token slices in p.V, where a thread group takes a pair of rows: groups
  // that would idle at small G take slices of the tokens; their partial
  // sums sit in the split's K buffer, which scoring is done with.
  __host__ __device__ static int slices(int G) {
    const int RP = (G + 1) / 2;
    int ts = RP < NGG ? NGG / RP : 1;
    ts = ts < MAX_SLICES ? ts : MAX_SLICES;
    const int fit = T_SPLIT * KROW / (2 * RP * HD * (int)sizeof(float));
    ts = ts < fit ? ts : fit;
    return ts > 1 ? ts : 1;
  }
};

// stages: ring slots of one split each; bsplits: splits a block walks
template <typename T, int HD>
size_t smem_bytes(int G, int stages, int bsplits) {
  return (size_t)stages * Plan<T, HD>::STAGE + sizeof(float) * ((size_t)G * HD + (size_t)G * T_SPLIT + 2 * G) +
         sizeof(int) * (size_t)bsplits * T_SPLIT;
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
paged_decode_split(const T* __restrict__ q, const T* __restrict__ kp, const T* __restrict__ vp,
                   const int* __restrict__ tables, const int* __restrict__ lens, T* __restrict__ out,
                   float* __restrict__ ws_acc, float* __restrict__ ws_ml, int* __restrict__ counters, int KV,
                   int G, int page, int n_pages, int bsplits, int stages, float scale, float softcap) {
  using P = Plan<T, HD>;
  constexpr int V = P::V, VPR = P::VPR, NGG = P::NGG, KROW = P::KROW;
  using U = typename Vec<T>::U;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem + stages * P::STAGE);  // G x HD
  float* Ss = Qs + G * HD;                                         // G x T_SPLIT: scores, then p
  float* Ms = Ss + G * T_SPLIT;                                    // G
  float* Ls = Ms + G;                                              // G
  int* Rows = reinterpret_cast<int*>(Ls + G);  // page * page_size + slot of each of the block's tokens
  __shared__ int last;

  const int S = n_pages * page / T_SPLIT + (n_pages * page % T_SPLIT != 0);  // splits of the table
  const int h = blockIdx.x, first = blockIdx.y * bsplits, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = b * KV + h;
  const int64_t qbase = (int64_t)bh * G * HD;
  const int TS = P::slices(G);

  // 1. seq_len, the table entries of the block's tokens and q, all in
  // flight together (entries past seq_len are read, never followed)
  const int len = min(lens[b], n_pages * page);
  const int tok0 = first * T_SPLIT, ntok = min(bsplits * T_SPLIT, n_pages * page - tok0);
  const int* table = tables + (int64_t)b * n_pages;
  for (int i = tid; i < ntok; i += THREADS) {
    const int pos = tok0 + i;
    Rows[i] = table[pos / page] * page + pos % page;
  }
#pragma unroll 4
  for (int i = tid; i < G * HD; i += THREADS) Qs[i] = to_f32(q[qbase + i]);
  const int n_live = len > 0 ? (len + T_SPLIT - 1) / T_SPLIT : 0;
  if (n_live == 0) {
    if (blockIdx.y == 0)
      for (int i = tid; i < G * HD; i += THREADS) out[qbase + i] = T(0.f);
    return;
  }
  if (first >= n_live) return;
  const int mine = min(bsplits, n_live - first);  // live splits this block walks
  const bool single = n_live == 1;
  __syncthreads();

  // 2. the ring: split k's live K/V rows go to slot k % stages, 16 bytes a
  // copy, in two commit groups of HALF tokens
  auto issue = [&](int k) {
    const int s0 = (first + k) * T_SPLIT, nt = min(T_SPLIT, len - s0);
    unsigned char* Kb = smem + (k % stages) * P::STAGE;
    T* Vs = reinterpret_cast<T*>(Kb + T_SPLIT * KROW);
    // thread tid < USED copies column chunk tid % VPR of every NGG-th token
    const int c = tid % VPR;
    for (int half = 0; half < 2; ++half) {
      const int t_end = tid < P::USED ? min((half + 1) * HALF, nt) : 0;
      for (int t = half * HALF + tid / VPR; t < t_end; t += NGG) {
        const int64_t off = ((int64_t)Rows[k * T_SPLIT + t] * KV + h) * HD + c * V;
        cp_async16(Kb + t * KROW + c * 16, kp + off);
        cp_async16(Vs + t * HD + c * V, vp + off);
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
  };
  for (int k = 0; k < min(stages, mine); ++k) issue(k);

  const int gg = tid / VPR, cc = tid % VPR;
  const int RP = (G + 1) / 2;  // row pairs
  for (int k = 0; k < mine; ++k) {
    const int sj = first + k, s0 = sj * T_SPLIT, nt = min(T_SPLIT, len - s0);
    unsigned char* Kb = smem + (k % stages) * P::STAGE;
    const T* Vs = reinterpret_cast<const T*>(Kb + T_SPLIT * KROW);
    const int ahead = 2 * min(stages - 1, mine - 1 - k);  // groups of the later splits in flight

    // 3. scores: lane = token, each lane whole dot products of its own K row
    // (rows padded by 16 bytes, so the lanes hit distinct banks) with a
    // pair of q rows read as broadcasts, the warps taking (half, row pair)
    // items in turn. When there are few pairs both halves are scored at
    // once by all warps; else a half is scored while the next one may still
    // be in flight.
    const int per_sweep = 2 * RP <= NWARPS ? 2 : 1;  // halves scored at once
    for (int h0 = 0; h0 * HALF < nt; h0 += per_sweep) {
      wait_groups(ahead + (per_sweep == 2 ? 0 : 1 - h0));
      __syncthreads();
      for (int pr = warp; pr < per_sweep * RP; pr += NWARPS) {
        const int g0 = 2 * (pr % RP), g1 = min(g0 + 1, G - 1), t = (h0 + pr / RP) * HALF + lane;
        if (t >= nt) continue;
        const unsigned char* krow = Kb + t * KROW;
        const float* q0 = Qs + g0 * HD;
        const float* q1 = Qs + g1 * HD;
        float dot0 = 0.f, dot1 = 0.f;
#pragma unroll
        for (int c = 0; c < VPR; ++c) {
          float kf[V];
          unpack(*reinterpret_cast<const U*>(krow + c * 16), kf);
          const float4* a4 = reinterpret_cast<const float4*>(q0 + c * V);
          const float4* b4 = reinterpret_cast<const float4*>(q1 + c * V);
          float part0 = 0.f, part1 = 0.f;
#pragma unroll
          for (int v4 = 0; v4 < V / 4; ++v4) {
            const float4 a = a4[v4], bq = b4[v4];
            part0 = fmaf(a.x, kf[4 * v4], part0);
            part0 = fmaf(a.y, kf[4 * v4 + 1], part0);
            part0 = fmaf(a.z, kf[4 * v4 + 2], part0);
            part0 = fmaf(a.w, kf[4 * v4 + 3], part0);
            part1 = fmaf(bq.x, kf[4 * v4], part1);
            part1 = fmaf(bq.y, kf[4 * v4 + 1], part1);
            part1 = fmaf(bq.z, kf[4 * v4 + 2], part1);
            part1 = fmaf(bq.w, kf[4 * v4 + 3], part1);
          }
          dot0 += part0;
          dot1 += part1;
        }
        float s0v = dot0 * scale, s1v = dot1 * scale;
        if (softcap > 0.f) s0v = softcap * tanhf(s0v / softcap), s1v = softcap * tanhf(s1v / softcap);
        Ss[g0 * T_SPLIT + t] = s0v;
        if (g1 != g0) Ss[g1 * T_SPLIT + t] = s1v;
      }
    }
    __syncthreads();

    // the split's max m and sum l of each row, a warp a row; p in place of
    // the scores
    for (int g = warp; g < G; g += NWARPS) {
      float* sg = Ss + g * T_SPLIT;
      float mx = NEG_INF;
      for (int t = lane; t < nt; t += 32) mx = fmaxf(mx, sg[t]);
      mx = warp_max(mx);
      float sum = 0.f;
      for (int t = lane; t < nt; t += 32) {
        const float p = expf(sg[t] - mx);
        sg[t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) Ms[g] = mx, Ls[g] = sum;
    }
    __syncthreads();

    // p.V into the f32 accumulator; the split's result is the output if it
    // is the only live split, else its (acc, m, l) in the workspace
    const int64_t rec = (int64_t)bh * S + sj;
    // N consecutive values of row g from column d
    auto emit = [&](int g, int d, auto& acc) {
      constexpr int N = sizeof(acc) / sizeof(float);
      if (single) {
        const float l = fmaxf(Ls[g], 1e-30f);
#pragma unroll
        for (int v = 0; v < N; ++v) acc[v] = acc[v] / l;
        store<N>(out + qbase + g * HD + d, acc);
      } else {
        store<N>(ws_acc + rec * G * HD + g * HD + d, acc);
      }
    };
    // a thread group takes rows g0 and g1 = g0 + 1 (g0 alone at odd G's
    // last pair), tokens t_first, t_first + t_step, ...
    auto pv = [&](int g0, int g1, int t_first, int t_step, float (&acc0)[V], float (&acc1)[V]) {
      const float* p0 = Ss + g0 * T_SPLIT;
      const float* p1 = Ss + g1 * T_SPLIT;
#pragma unroll
      for (int v = 0; v < V; ++v) acc0[v] = acc1[v] = 0.f;
#pragma unroll 4
      for (int t = t_first; t < nt; t += t_step) {
        float vf[V];
        unpack(*reinterpret_cast<const U*>(Vs + t * HD + cc * V), vf);
        const float a = p0[t], bp = p1[t];
#pragma unroll
        for (int v = 0; v < V; ++v) acc0[v] = fmaf(a, vf[v], acc0[v]), acc1[v] = fmaf(bp, vf[v], acc1[v]);
      }
    };
    if (TS == 1) {
      for (int rp = gg; tid < P::USED && rp < RP; rp += NGG) {
        const int g0 = 2 * rp, g1 = min(g0 + 1, G - 1);
        float acc0[V], acc1[V];
        pv(g0, g1, 0, 1, acc0, acc1);
        emit(g0, cc * V, acc0);
        if (g1 != g0) emit(g1, cc * V, acc1);
      }
    } else {
      // RP < NGG: group gg takes pair gg % RP, tokens t = ts (mod TS). The
      // slices' partial sums go to the split's K buffer; then every thread
      // adds up float4s of the rows, slice by slice in order.
      float* Red = reinterpret_cast<float*>(Kb);  // TS x 2 RP x HD
      const int ts = gg / RP, rp = gg % RP, g0 = 2 * rp, g1 = min(g0 + 1, G - 1);
      if (tid < P::USED && ts < TS) {
        float acc0[V], acc1[V];
        pv(g0, g1, ts, TS, acc0, acc1);
        store<V>(Red + (ts * 2 * RP + g0) * HD + cc * V, acc0);
        store<V>(Red + (ts * 2 * RP + g0 + 1) * HD + cc * V, acc1);
      }
      __syncthreads();
      for (int e = tid; e < G * HD / 4; e += THREADS) {
        const float4* r = reinterpret_cast<const float4*>(Red) + e;
        float a[4] = {0.f, 0.f, 0.f, 0.f};
        for (int sl = 0; sl < TS; ++sl) {
          const float4 u = r[sl * (2 * RP * HD / 4)];
          a[0] += u.x, a[1] += u.y, a[2] += u.z, a[3] += u.w;
        }
        emit(e * 4 / HD, e * 4 % HD, a);
      }
    }
    if (!single)
      for (int g = tid; g < G; g += THREADS) {
        ws_ml[rec * 2 * G + g] = Ms[g];
        ws_ml[rec * 2 * G + G + g] = Ls[g];
      }
    __syncthreads();  // slot k % stages, Ss, Ms and Ls are free again
    if (k + stages < mine) issue(k + stages);
  }
  if (single) return;

  // 4. ticket: the block that brings the count to n_live merges every live
  // split, in split order. One thread fences and counts for the block: the
  // barrier above orders the block's writes before its fence.
  if (tid == 0) {
    __threadfence();
    const int before = atomicAdd(&counters[bh], mine);
    last = before + mine == n_live;
    if (last) __threadfence();
  }
  __syncthreads();
  if (!last) return;
  // M = max m_j first, then the sums chunk by chunk, in split order. A
  // chunk's acc records are copied into the ring's slots (the first chunk's
  // while M is found), its (m, l) into Ss; the running A sits in Qs.
  const int cj = min(32, stages * P::STAGE / (G * HD * (int)sizeof(float)));
  const float4* R4 = reinterpret_cast<const float4*>(smem);
  float4* A4 = reinterpret_cast<float4*>(Qs);
  float* Mj = Ss;           // 32 x G
  float* Lj = Ss + 32 * G;  // 32 x G
  const float* ml0 = ws_ml + (int64_t)bh * S * 2 * G;
  const float* acc0 = ws_acc + (int64_t)bh * S * G * HD;
  auto fetch_acc = [&](int j0, int n) {
    for (int i = tid; i < n * G * HD / 4; i += THREADS)
      cp_async16(smem + 16 * i, acc0 + (int64_t)j0 * G * HD + 4 * i);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  auto fetch_ml = [&](int j0, int n) {
    for (int i = tid; i < n * G; i += THREADS) {
      const float* rec_ml = ml0 + (int64_t)(j0 + i / G) * 2 * G + i % G;
      Mj[i] = __ldcg(rec_ml);
      Lj[i] = __ldcg(rec_ml + G);
    }
  };
  fetch_acc(0, min(cj, n_live));
  float Mg = NEG_INF;  // thread g < G: max over the live splits
  for (int j0 = 0; j0 < n_live; j0 += 32) {
    fetch_ml(j0, min(32, n_live - j0));
    __syncthreads();
    if (tid < G)
      for (int r = 0; r < min(32, n_live - j0); ++r) Mg = fmaxf(Mg, Mj[r * G + tid]);
    __syncthreads();
  }
  if (tid < G) Ms[tid] = Mg, Ls[tid] = 0.f;
  for (int j0 = 0; j0 < n_live; j0 += cj) {
    const int n = min(cj, n_live - j0);
    if (j0 > 0) fetch_acc(j0, n);
    if (j0 > 0 || n_live > 32) fetch_ml(j0, n);  // else Mj and Lj hold these splits already
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    for (int e = tid; e < G * HD / 4; e += THREADS) {
      const int g = e * 4 / HD;
      float4 a = j0 == 0 ? make_float4(0.f, 0.f, 0.f, 0.f) : A4[e];
      for (int r = 0; r < n; ++r) {
        const float w = expf(Mj[r * G + g] - Ms[g]);
        const float4 u = R4[r * (G * HD / 4) + e];
        a.x += u.x * w, a.y += u.y * w, a.z += u.z * w, a.w += u.w * w;
      }
      A4[e] = a;
    }
    if (tid < G) {
      float L = Ls[tid];
      for (int r = 0; r < n; ++r) L += Lj[r * G + tid] * expf(Mj[r * G + tid] - Ms[tid]);
      Ls[tid] = L;
    }
    __syncthreads();
  }
  for (int e = tid; e < G * HD / 4; e += THREADS) {
    const float L = fmaxf(Ls[e * 4 / HD], 1e-30f);
    const float4 u = A4[e];
    float a[4] = {u.x / L, u.y / L, u.z / L, u.w / L};
    store<4>(out + qbase + 4 * e, a);
  }
  if (tid == 0) counters[bh] = 0;  // ready for the next call on this stream, or the next replay of a graph
}

int n_splits(int page, int n_pages) { return (page * n_pages + T_SPLIT - 1) / T_SPLIT; }

// Dynamic shared memory a block of this instance may take, after opting in
// once to the card's most (cudaFuncSetAttribute); minus the CUDA error if
// that failed.
template <typename T, int HD>
int smem_limit() {
  static int limit = 0;
  if (limit == 0) {
    int dev = 0, most = 0;
    cudaFuncAttributes fa;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    cudaError_t e = cudaFuncGetAttributes(&fa, paged_decode_split<T, HD>);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(paged_decode_split<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               most - (int)fa.sharedSizeBytes);
    limit = e == cudaSuccess ? most - (int)fa.sharedSizeBytes : -static_cast<int>(e);
  }
  return limit;
}

// Ring slots for this instance within `limit` bytes: RING where they fit
// beside the largest group (G = 64) and walk (MAX_BLOCK_SPLITS), else
// fewer; 0 if not even one split's stage fits.
template <typename T, int HD>
int ring_stages(int limit) {
  int st = RING;
  while (st > 0 && smem_bytes<T, HD>(64, st, MAX_BLOCK_SPLITS) > (size_t)limit) --st;
  return st;
}

// How many splits a block walks: one while one wave of blocks holds every
// split, else as many as fill one wave. This changes only which block
// computes a split, never a split's arithmetic, so results do not depend
// on it.
template <typename T, int HD>
int block_splits(int total, int G, int ring) {
  static int waves[65] = {0};  // resident blocks on the card, by G, with a full ring
  if (G > 64) return 1;
  if (waves[G] == 0) {
    int dev = 0, n_sm = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, paged_decode_split<T, HD>, THREADS,
                                                  smem_bytes<T, HD>(G, ring, MAX_BLOCK_SPLITS));
    waves[G] = n_sm * (per_sm > 0 ? per_sm : 1);
  }
  const int n = (total + waves[G] - 1) / waves[G];
  return n < 1 ? 1 : n > MAX_BLOCK_SPLITS ? MAX_BLOCK_SPLITS : n;
}

template <typename T, int HD>
int launch(const void* q, const void* kp, const void* vp, const int* tables, const int* lens, void* out,
           float* ws, int* counters, int B, int KV, int G, int page, int n_pages, float softcap, cudaStream_t s) {
  const int limit = smem_limit<T, HD>();  // opts in to dynamic shared memory above 48 KB, once
  if (limit < 0) return -limit;
  const int ring = ring_stages<T, HD>(limit);
  if (ring == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int S = n_splits(page, n_pages);
  const int bsplits = block_splits<T, HD>(B * KV * S, G, ring), stages = bsplits < ring ? bsplits : ring;
  const float scale = (float)(1.0 / sqrt((double)HD));
  float* ws_ml = ws + (int64_t)B * KV * S * G * HD;
  const int groups = (S + bsplits - 1) / bsplits;
  // KV heads fastest: the blocks of one split's heads, which read the
  // neighbouring parts of the same token rows, run side by side
  paged_decode_split<T, HD><<<dim3(KV, groups, B), THREADS, smem_bytes<T, HD>(G, stages, bsplits), s>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp), tables, lens,
      static_cast<T*>(out), ws, ws_ml, counters, KV, G, page, n_pages, bsplits, stages, scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(const void* q, const void* kp, const void* vp, const int* tables, const int* lens, void* out,
                float* ws, int* cnt, int B, int KV, int G, int hd, int page, int n_pages, float softcap,
                cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(q, kp, vp, tables, lens, out, ws, cnt, B, KV, G, page, n_pages, softcap, s);
    case 32: return launch<T, 32>(q, kp, vp, tables, lens, out, ws, cnt, B, KV, G, page, n_pages, softcap, s);
    case 64: return launch<T, 64>(q, kp, vp, tables, lens, out, ws, cnt, B, KV, G, page, n_pages, softcap, s);
    case 80: return launch<T, 80>(q, kp, vp, tables, lens, out, ws, cnt, B, KV, G, page, n_pages, softcap, s);
    case 128: return launch<T, 128>(q, kp, vp, tables, lens, out, ws, cnt, B, KV, G, page, n_pages, softcap, s);
    case 256: return launch<T, 256>(q, kp, vp, tables, lens, out, ws, cnt, B, KV, G, page, n_pages, softcap, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Tokens per split: the kernel's constant, read by the wrapper to check its own.
extern "C" int paged_decode_t_split() { return T_SPLIT; }

// The workspace (f32 elements) and counters (int32) a call needs.
extern "C" void paged_decode_scratch(int B, int KV, int G, int hd, int page, int n_pages, long long* ws_floats,
                                     long long* n_counters) {
  const long long recs = (long long)B * KV * n_splits(page, n_pages);
  *ws_floats = recs * G * (hd + 2);
  *n_counters = (long long)B * KV;
}

// q (B,KV,G,hd); k/v pages (P,page,KV,hd); tables (B,n_pages) int32;
// lens (B,) int32 >= 1; out like q. ws: f32 workspace of ws_floats
// elements; counters: n_counters int32, zero between calls (the kernel
// leaves them so). dtype: 0 = float32, 1 = bfloat16. softcap <= 0 means
// none. Returns SCRATCH_TOO_SMALL (-1) if ws or counters are short of
// paged_decode_scratch's sizes, else cudaGetLastError().
extern "C" int paged_decode_attention(const void* q, const void* kp, const void* vp, const void* tables,
                                      const void* lens, void* out, void* ws, long long ws_floats, void* counters,
                                      long long n_counters, int B, int KV, int G, int hd, int page, int n_pages,
                                      int dtype, float softcap, void* stream) {
  long long need_ws, need_cnt;
  paged_decode_scratch(B, KV, G, hd, page, n_pages, &need_ws, &need_cnt);
  if (ws_floats < need_ws || n_counters < need_cnt) return SCRATCH_TOO_SMALL;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(tables);
  const int* l = static_cast<const int*>(lens);
  float* w = static_cast<float*>(ws);
  int* c = static_cast<int*>(counters);
  if (dtype == 0) return dispatch_hd<float>(q, kp, vp, t, l, out, w, c, B, KV, G, hd, page, n_pages, softcap, s);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(q, kp, vp, t, l, out, w, c, B, KV, G, hd, page, n_pages, softcap, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
