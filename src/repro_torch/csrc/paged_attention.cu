// Paged flash-decode for Hopper (sm_90a): one new query token per sequence
// over a paged KV cache.
//
// Replaces: repro/kernels/paged_attention/kernel.py, paged_decode_attention_p
// (Pallas body _decode_kernel). Same function: s = q.k * hd^-0.5, optional
// cap * tanh(s / cap), positions >= seq_len excluded, running max / sum /
// accumulator in f32, the sum clamped at 1e-30, output in q's dtype.
//
// What bounds it on an H100: every K and V element of the live tokens is
// read once and used for G (query heads per KV head, 4 for llama3-8b)
// multiply-adds, so the KV read from device memory bounds it.
//
// Design: one block per (KV head, sequence) holds that head's G query rows,
// so each K/V element is read from device memory once for all G rows. The
// TPU kernel walked a (batch, page) grid in order and kept m/l/acc in VMEM
// across grid steps; blocks on Hopper run in no order, so here the page
// walk is a loop inside the block. The block reads the live tokens in
// chunks of 32 through the block table (each token's page looked up in the
// table, so any page size works) with 16-byte loads, all of a chunk's loads
// in flight before any is stored, and stages K and V in shared memory as
// f32 (K rows padded so float4 reads hit distinct banks); then one warp
// per query row scores the 32 tokens (one lane each), takes the chunk's max
// and sum with warp shuffles and updates the online softmax; the block
// then folds p.V into the f32 accumulator in shared memory. The pages must
// start on a 16-byte boundary. Tokens at or past seq_len are never read: their scores
// would be -1e30 and add exactly zero, so skipping them changes no result.
// seq_len >= 1 is the contract (the engine never passes 0). Known limit: a
// block walks its whole sequence alone; splitting long sequences over
// blocks and merging by log-sum-exp is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CH = 32;  // tokens per chunk: one lane each in the softmax
constexpr int THREADS = 128;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename O> __device__ __forceinline__ O from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

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

__host__ __device__ constexpr int ldk(int HD) { return HD + 4; }  // padded K rows: float4 reads hit distinct banks

size_t smem_bytes(int G, int HD) {
  return sizeof(float) * (size_t)(2 * G * HD + CH * ldk(HD) + CH * HD + G * CH + 3 * G);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
paged_decode(const T* __restrict__ q, const T* __restrict__ kp, const T* __restrict__ vp,
             const int* __restrict__ tables, const int* __restrict__ lens, T* __restrict__ out,
             int KV, int G, int page, int n_pages, float scale, float softcap) {
  extern __shared__ __align__(16) float smem[];
  constexpr int LDK = ldk(HD);
  constexpr int V = Vec<T>::N, VPR = HD / V;  // 16-byte vectors per token row
  constexpr int NPT = (CH * VPR + THREADS - 1) / THREADS;  // per thread per chunk
  using U = typename Vec<T>::U;
  float* Qs = smem;            // G x HD
  float* Acc = Qs + G * HD;    // G x HD
  float* Ks = Acc + G * HD;    // CH x LDK
  float* Vs = Ks + CH * LDK;   // CH x HD
  float* Ps = Vs + CH * HD;    // G x CH
  float* Mx = Ps + G * CH;     // G
  float* L = Mx + G;           // G
  float* Corr = L + G;         // G

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  constexpr int NWARPS = THREADS / 32;
  const int len = lens[b];
  const int* table = tables + (int64_t)b * n_pages;
  const int64_t qbase = ((int64_t)b * KV + h) * G * HD;

  for (int i = tid; i < G * HD; i += THREADS) {
    Qs[i] = to_f32(q[qbase + i]);
    Acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += THREADS) {
    Mx[g] = NEG_INF;
    L[g] = 0.f;
  }
  __syncthreads();

  for (int c0 = 0; c0 < len; c0 += CH) {
    // the chunk's K and V rows through the block table: all loads in flight, then stores
    U kr[NPT], vr[NPT];
#pragma unroll
    for (int j = 0; j < NPT; ++j) {
      const int idx = tid + j * THREADS, t = idx / VPR, pos = c0 + t;
      kr[j] = vr[j] = U{};
      if (idx < CH * VPR && pos < len) {
        const int64_t pid = table[pos / page];
        const int64_t off = ((pid * page + pos % page) * KV + h) * HD + (idx % VPR) * V;
        kr[j] = __ldg(reinterpret_cast<const U*>(kp + off));
        vr[j] = __ldg(reinterpret_cast<const U*>(vp + off));
      }
    }
#pragma unroll
    for (int j = 0; j < NPT; ++j) {
      const int idx = tid + j * THREADS, t = idx / VPR, d = (idx % VPR) * V;
      if (idx >= CH * VPR) break;
      float kf[V], vf[V];
      unpack(kr[j], kf);
      unpack(vr[j], vf);
#pragma unroll
      for (int v = 0; v < V; v += 4) {
        *reinterpret_cast<float4*>(Ks + t * LDK + d + v) = make_float4(kf[v], kf[v + 1], kf[v + 2], kf[v + 3]);
        *reinterpret_cast<float4*>(Vs + t * HD + d + v) = make_float4(vf[v], vf[v + 1], vf[v + 2], vf[v + 3]);
      }
    }
    __syncthreads();

    for (int g = warp; g < G; g += NWARPS) {
      const bool valid = c0 + lane < len;
      float s = NEG_INF;
      if (valid) {
        const float4* qv = reinterpret_cast<const float4*>(Qs + g * HD);
        const float4* kv = reinterpret_cast<const float4*>(Ks + lane * LDK);
        float dot = 0.f;
#pragma unroll 8
        for (int d4 = 0; d4 < HD / 4; ++d4) {
          const float4 a = qv[d4], k = kv[d4];
          dot = fmaf(a.x, k.x, dot);
          dot = fmaf(a.y, k.y, dot);
          dot = fmaf(a.z, k.z, dot);
          dot = fmaf(a.w, k.w, dot);
        }
        s = dot * scale;
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      }
      const float m_old = Mx[g];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float p = valid ? expf(s - m_new) : 0.f;
      const float psum = warp_sum(p);
      Ps[g * CH + lane] = p;
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        Corr[g] = corr;
        L[g] = L[g] * corr + psum;
        Mx[g] = m_new;
      }
    }
    __syncthreads();

    for (int i = tid; i < G * HD; i += THREADS) {
      const int g = i / HD, d = i % HD;
      float pv = 0.f;
#pragma unroll 8
      for (int t = 0; t < CH; ++t) pv = fmaf(Ps[g * CH + t], Vs[t * HD + d], pv);
      Acc[i] = Acc[i] * Corr[g] + pv;
    }
    __syncthreads();
  }

  for (int i = tid; i < G * HD; i += THREADS) {
    out[qbase + i] = from_f32<T>(Acc[i] / fmaxf(L[i / HD], 1e-30f));
  }
}

template <typename T, int HD>
int launch(const void* q, const void* kp, const void* vp, const int* tables, const int* lens,
           void* out, int B, int KV, int G, int page, int n_pages, float softcap,
           cudaStream_t s) {
  const size_t smem = smem_bytes(G, HD);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(paged_decode<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const float scale = 1.0f / sqrtf((float)HD);
  paged_decode<T, HD><<<dim3(KV, B), THREADS, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp), tables,
      lens, static_cast<T*>(out), KV, G, page, n_pages, scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(const void* q, const void* kp, const void* vp, const int* tables, const int* lens,
                void* out, int B, int KV, int G, int hd, int page, int n_pages, float softcap,
                cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(q, kp, vp, tables, lens, out, B, KV, G, page, n_pages, softcap, s);
    case 32: return launch<T, 32>(q, kp, vp, tables, lens, out, B, KV, G, page, n_pages, softcap, s);
    case 64: return launch<T, 64>(q, kp, vp, tables, lens, out, B, KV, G, page, n_pages, softcap, s);
    case 128: return launch<T, 128>(q, kp, vp, tables, lens, out, B, KV, G, page, n_pages, softcap, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (B,KV,G,hd); k/v pages (P,page,KV,hd); tables (B,n_pages) int32;
// lens (B,) int32 >= 1; out like q. dtype: 0 = float32, 1 = bfloat16.
// softcap <= 0 means none. Returns cudaGetLastError().
extern "C" int paged_decode_attention(const void* q, const void* kp, const void* vp,
                                      const void* tables, const void* lens, void* out, int B,
                                      int KV, int G, int hd, int page, int n_pages, int dtype,
                                      float softcap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(tables);
  const int* l = static_cast<const int*>(lens);
  if (dtype == 0) return dispatch_hd<float>(q, kp, vp, t, l, out, B, KV, G, hd, page, n_pages, softcap, s);
  if (dtype == 1) return dispatch_hd<__nv_bfloat16>(q, kp, vp, t, l, out, B, KV, G, hd, page, n_pages, softcap, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
