// TP-shard-selecting matmul for Hopper (sm_90a).
//
// Replaces: repro/kernels/tp_shard_matmul/kernel.py, tp_shard_matmul_p
// (Pallas body _mm_kernel). As there, one compiled kernel serves every shard
// and every TP level: the shard is chosen by a runtime offset, here folded
// into the weight's base pointer by the caller (col: w + off, row:
// w + off * N_store), with the storage row length as the leading dimension.
// No weight byte is copied to select a shard.
//
//   y[M, N] = x[M, K] @ W,   W[k][n] = w[k * ldw + n]
//
// What bounds it on an H100: at decode (M = the slot count, 8 on the main
// path) every weight byte is used M times, far below the ~295 operations
// per byte where the tensor cores would become the limit, so reading the
// weight from device memory bounds it. At prefill (M = 32..128) f32 is
// bounded by the 67 TFLOP/s of the FMA units.
//
// Design. The TPU kernel walked its K grid axis in order with an f32 VMEM
// accumulator; Hopper blocks run in no order, so K is split over blocks
// (split-K) and the partial sums are added in a second, fixed-order pass.
// Two block shapes, chosen from M:
//  * M <= 8 (decode): a block of 8 warps covers 32 * VEC columns; each
//    lane streams VEC contiguous weight columns with 16-byte loads, 4 (f32)
//    or 8 (bf16, kept packed until used) rows in flight, and keeps all 8
//    rows' sums in registers; x for the block's K range is staged in shared
//    memory; the 8 warps take interleaved rows of that range and add their
//    sums in warp order through shared memory. The grid has enough K
//    splits for ~2 blocks per SM, so a TP-8 shard of a few hundred columns
//    still spreads over the card.
//  * M > 8 (prefill): a plain 64x64 SIMT tile, 256 threads with 4x4
//    register tiles, the next K step's loads issued before the current
//    step's FMAs, plus split-K over blocks when the tile grid is small.
// Every output is then a sum in an order fixed by (M, N, K) alone: the
// split count depends only on the shapes, and the vector/scalar choice of
// a load changes no arithmetic. So the result at a shard offset is
// bit-identical to the same call on the pre-sliced contiguous weight, and
// two calls on the same inputs agree bit for bit (no atomics). f32 runs on
// the FMA units (no TF32); bf16 is widened to f32 on load. Known limits,
// for later work: no tensor cores (wgmma) and no TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int SMS = 132;               // H100 SXM
constexpr int TARGET_BLOCKS = 2 * SMS;  // split K until the grid has ~2 blocks per SM

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename O> __device__ __forceinline__ O from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// ---------------------------------------------------------------------------
// Skinny path, M <= 8
// ---------------------------------------------------------------------------
constexpr int SK_M = 8, SK_WARPS = 8, SK_THREADS = SK_WARPS * 32, SK_ALIGN = 32;
constexpr int SK_MAX_KS = 1024;  // rows of x staged in shared memory per block

// A 16-byte vector of T, and how many rows each lane keeps in flight: bf16
// rows stay packed in registers until used, so a bf16 lane can hold twice
// as many.
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4, UNROLL = 4;
  using U = float4;
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8, UNROLL = 8;
  using U = uint4;
};

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

// Element by element, zero past column N: the same values as a vector load.
__device__ __forceinline__ float4 load_scalar(const float* row, int c, int N) {
  float e[4];
#pragma unroll
  for (int v = 0; v < 4; ++v) e[v] = c + v < N ? row[c + v] : 0.f;
  return make_float4(e[0], e[1], e[2], e[3]);
}

__device__ __forceinline__ uint4 load_scalar(const __nv_bfloat16* row, int c, int N) {
  const unsigned short* r = reinterpret_cast<const unsigned short*>(row);
  unsigned int h[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const unsigned int lo = c + 2 * i < N ? r[c + 2 * i] : 0u;
    const unsigned int hi = c + 2 * i + 1 < N ? r[c + 2 * i + 1] : 0u;
    h[i] = lo | (hi << 16);
  }
  return make_uint4(h[0], h[1], h[2], h[3]);
}

// VEC contiguous weight values of one row from column c: one 16-byte load
// when aligned and in range, else element by element.
template <typename T>
__device__ __forceinline__ typename Vec<T>::U load_row(const T* __restrict__ row, int c, int N, bool vec_ok) {
  using U = typename Vec<T>::U;
  if (vec_ok && c + Vec<T>::N <= N) return __ldg(reinterpret_cast<const U*>(row + c));
  return load_scalar(row, c, N);
}

template <typename T, typename O>
__global__ void __launch_bounds__(SK_THREADS)
skinny_mm(const T* __restrict__ x, const T* __restrict__ w, O* __restrict__ y,
          float* __restrict__ part, int M, int N, int K, int64_t ldw, int KS, bool vec_ok) {
  constexpr int V = Vec<T>::N, BN = 32 * V;
  __shared__ __align__(16) float xs[SK_MAX_KS][SK_M];  // x[m][k0 + r], transposed
  __shared__ float red[SK_M][BN];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * BN, c = n0 + lane * V;
  const int k0 = blockIdx.y * KS, rows = min(KS, K - k0);

#pragma unroll 8
  for (int i = tid; i < rows * SK_M; i += SK_THREADS) {  // coalesced along k
    const int m = i / rows, r = i % rows;
    xs[r][m] = m < M ? to_f32(x[(int64_t)m * K + k0 + r]) : 0.f;
  }
  __syncthreads();

  float acc[SK_M][V];
#pragma unroll
  for (int m = 0; m < SK_M; ++m)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[m][v] = 0.f;

  // warp w takes rows w, w + 8, w + 16, ... of the block's range
  constexpr int UNROLL = Vec<T>::UNROLL;
  for (int r0 = warp; r0 < rows; r0 += SK_WARPS * UNROLL) {
    typename Vec<T>::U wr[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int r = r0 + u * SK_WARPS;
      if (r < rows) wr[u] = load_row(w + (int64_t)(k0 + r) * ldw, c, N, vec_ok);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int r = r0 + u * SK_WARPS;
      if (r >= rows) break;
      float wv[V];
      unpack(wr[u], wv);
      const float4 xa = *reinterpret_cast<const float4*>(&xs[r][0]);
      const float4 xb = *reinterpret_cast<const float4*>(&xs[r][4]);
      const float xr[SK_M] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
      for (int m = 0; m < SK_M; ++m)
#pragma unroll
        for (int v = 0; v < V; ++v) acc[m][v] = fmaf(xr[m], wv[v], acc[m][v]);
    }
  }

  // add the warps' sums in warp order
  for (int ww = 0; ww < SK_WARPS; ++ww) {
    if (warp == ww) {
#pragma unroll
      for (int m = 0; m < SK_M; ++m)
#pragma unroll
        for (int v = 0; v < V; ++v)
          red[m][lane * V + v] = ww == 0 ? acc[m][v] : red[m][lane * V + v] + acc[m][v];
    }
    __syncthreads();
  }
  for (int i = tid; i < M * BN; i += SK_THREADS) {
    const int m = i / BN, n = n0 + i % BN;
    if (n >= N) continue;
    if (part != nullptr) {
      part[((int64_t)blockIdx.y * M + m) * N + n] = red[m][i % BN];
    } else {
      y[(int64_t)m * N + n] = from_f32<O>(red[m][i % BN]);
    }
  }
}

// ---------------------------------------------------------------------------
// Tiled path, M > 8
// ---------------------------------------------------------------------------
constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4, THREADS = 256;

template <typename T, typename O>
__global__ void __launch_bounds__(THREADS)
tiled_mm(const T* __restrict__ x, const T* __restrict__ w, O* __restrict__ y,
         float* __restrict__ part, int M, int N, int K, int64_t ldw, int KS) {
  __shared__ float As[BK][BM + 1];  // x tile, transposed; +1 breaks bank conflicts
  __shared__ float Bs[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int kbeg = blockIdx.z * KS, kend = min(K, kbeg + KS);
  const int ntiles = (kend - kbeg + BK - 1) / BK;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  float ra[4], rb[4];
  auto load = [&](int t) {
    const int k0 = kbeg + t * BK;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + THREADS * i;
      const int am = idx / BK, ak = idx % BK;  // x tile: BM rows x BK
      const int gm = m0 + am, gk = k0 + ak;
      ra[i] = (gm < M && gk < kend) ? to_f32(x[(int64_t)gm * K + gk]) : 0.f;
      const int bk = idx / BN, bn = idx % BN;  // w tile: BK rows x BN
      const int gkb = k0 + bk, gn = n0 + bn;
      rb[i] = (gkb < kend && gn < N) ? to_f32(w[(int64_t)gkb * ldw + gn]) : 0.f;
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = tid + THREADS * i;
      As[idx % BK][idx / BK] = ra[i];
      Bs[idx / BN][idx % BN] = rb[i];
    }
  };

  load(0);
  store();
  __syncthreads();
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) load(t + 1);
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
    if (t + 1 < ntiles) {
      store();
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn >= N) continue;
      if (part != nullptr) {
        part[((int64_t)blockIdx.z * M + gm) * N + gn] = acc[i][j];
      } else {
        y[(int64_t)gm * N + gn] = from_f32<O>(acc[i][j]);
      }
    }
  }
}

// y = sum over splits s = 0..S-1 of part[s], in that order
template <typename O>
__global__ void splitk_reduce(const float* __restrict__ part, O* __restrict__ y, int S, int64_t MN) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MN) return;
  float s = part[i];
  for (int z = 1; z < S; ++z) s += part[z * MN + i];
  y[i] = from_f32<O>(s);
}

// How a call is split: S blocks along K of KS rows each. Depends on the
// shapes and the dtype only.
struct Plan {
  bool skinny;
  int S, KS;
};

Plan plan(int M, int N, int K, int dtype) {
  Plan p;
  p.skinny = M <= SK_M;
  int tiles, max_ks, align;
  if (p.skinny) {
    tiles = ceil_div(N, 32 * (dtype == 0 ? Vec<float>::N : Vec<__nv_bfloat16>::N));
    max_ks = SK_MAX_KS;
    align = SK_ALIGN;
  } else {
    tiles = ceil_div(N, BN) * ceil_div(M, BM);
    max_ks = 1 << 30;
    align = BK;
  }
  int S = ceil_div(TARGET_BLOCKS, tiles);
  S = std::max(1, std::min(S, ceil_div(K, 4 * align)));  // at least 4 steps per split
  int KS = ceil_div(ceil_div(K, S), align) * align;
  KS = std::min(KS, max_ks);
  p.KS = std::max(KS, align);
  p.S = ceil_div(K, p.KS);
  return p;
}

template <typename T, typename O>
int run(const void* xv, const void* wv, void* yv, float* ws, int M, int N, int K, int64_t ldw,
        cudaStream_t s) {
  const T* x = static_cast<const T*>(xv);
  const T* w = static_cast<const T*>(wv);
  O* y = static_cast<O*>(yv);
  const Plan p = plan(M, N, K, sizeof(T) == 4 ? 0 : 1);
  float* part = p.S > 1 ? ws : nullptr;
  if (p.S > 1 && ws == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (p.skinny) {
    const bool vec_ok = reinterpret_cast<uintptr_t>(w) % 16 == 0 && (ldw * sizeof(T)) % 16 == 0;
    const dim3 grid(ceil_div(N, 32 * Vec<T>::N), p.S);
    skinny_mm<T, O><<<grid, SK_THREADS, 0, s>>>(x, w, y, part, M, N, K, ldw, p.KS, vec_ok);
  } else {
    const dim3 grid(ceil_div(N, BN), ceil_div(M, BM), p.S);
    tiled_mm<T, O><<<grid, THREADS, 0, s>>>(x, w, y, part, M, N, K, ldw, p.KS);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || p.S == 1) return static_cast<int>(e);
  const int64_t mn = (int64_t)M * N;
  splitk_reduce<O><<<(unsigned)((mn + 255) / 256), 256, 0, s>>>(part, y, p.S, mn);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Bytes of f32 workspace a call needs for its split-K partial sums (0: none).
extern "C" long long tp_shard_matmul_workspace(int M, int N, int K, int dtype) {
  const Plan p = plan(M, N, K, dtype);
  return p.S > 1 ? (long long)p.S * M * N * sizeof(float) : 0;
}

// dtype: 0 = float32, 1 = bfloat16 (x and w). out_f32: write f32 whatever
// the input type (the LM head's f32 logits). ws: the workspace sized by
// tp_shard_matmul_workspace. Returns cudaGetLastError().
extern "C" int tp_shard_matmul(const void* x, const void* w, void* y, void* ws, int M, int N, int K,
                               long long ldw, int dtype, int out_f32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(ws);
  if (M <= 0 || N <= 0 || K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return run<float, float>(x, w, y, part, M, N, K, ldw, s);
  if (dtype == 1 && out_f32) return run<__nv_bfloat16, float>(x, w, y, part, M, N, K, ldw, s);
  if (dtype == 1) return run<__nv_bfloat16, __nv_bfloat16>(x, w, y, part, M, N, K, ldw, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
