// Paged-KV gather and scatter for Hopper (sm_90a): the aggregation step of
// KV migration (paper §3.2.2).
//
// Replaces: repro/kernels/kv_gather/kernel.py, kv_gather_p (Pallas body
// _copy_kernel) and kv_scatter_p (Pallas body _scatter_kernel).
//
//   gather:  staged[i] = pool[ids[i]]   (fragmented pages -> contiguous staging)
//   scatter: pool[ids[i]] = staged[i]   (contiguous staging -> pool pages, in place)
//
// A row is one page's payload of `row_bytes` bytes. The copy moves bytes
// and never looks at their type, so one kernel serves every dtype and the
// result is exact to the bit. The scatter writes into the caller's pool:
// rows not named in ids keep their contents (the TPU kernel's
// input_output_aliases donation). The caller guarantees ids in range and,
// for the scatter, distinct: blocks run in parallel, so two writes to one
// row would race where the TPU's sequential grid let the last one win.
//
// What bounds it on an H100: no arithmetic at all; every staged byte is read
// once and written once, so device memory bounds it at
// 2 * n * row_bytes / 3.35 TB/s.
//
// Design. The TPU kernel walked the page list in order with scalar-
// prefetched ids and let Pallas double-buffer the block DMAs. Here one
// block copies one row at a time (grid-stride over rows when n exceeds the
// grid); it reads ids[i] once, then each thread issues all of its 16-byte
// loads for the row (8 a thread for a 32 KiB llama3-8b page) before any
// store, so a block keeps a whole row in flight and the SMs together keep
// enough bytes in flight to cover device-memory latency. The 16-byte path
// needs row_bytes % 16 == 0 and both bases on a 16-byte boundary; any
// other case takes a byte loop that writes the same bytes. Offsets are
// 64-bit: a pool of all layers' pages viewed as rows passes 2^31 bytes.
// Known limits, for later work: no TMA bulk copies (cp.async.bulk), and no
// overlap of the gather with the send to another card.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 8;  // 16-byte loads in flight per thread: 32 KiB a block
constexpr int MAX_GRID = 1 << 20;

// src row of step i: gather reads pool[ids[i]], scatter reads staged[i];
// the dst row is the other one.
template <bool GATHER>
__device__ __forceinline__ void rows_of(const int* __restrict__ ids, int64_t i, int64_t& src_row,
                                        int64_t& dst_row) {
  const int64_t page = static_cast<int64_t>(ids[i]);
  src_row = GATHER ? page : i;
  dst_row = GATHER ? i : page;
}

template <bool GATHER>
__global__ void __launch_bounds__(THREADS) copy_rows_vec(const uint4* __restrict__ src,
                                                         uint4* __restrict__ dst,
                                                         const int* __restrict__ ids, int64_t n,
                                                         int64_t row_vecs) {
  for (int64_t i = blockIdx.x; i < n; i += gridDim.x) {
    int64_t s, d;
    rows_of<GATHER>(ids, i, s, d);
    const uint4* from = src + s * row_vecs;
    uint4* to = dst + d * row_vecs;
    for (int64_t base = threadIdx.x; base < row_vecs; base += THREADS * UNROLL) {
      uint4 r[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int64_t j = base + static_cast<int64_t>(u) * THREADS;
        if (j < row_vecs) r[u] = from[j];
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int64_t j = base + static_cast<int64_t>(u) * THREADS;
        if (j < row_vecs) to[j] = r[u];
      }
    }
  }
}

template <bool GATHER>
__global__ void __launch_bounds__(THREADS) copy_rows_bytes(const unsigned char* __restrict__ src,
                                                           unsigned char* __restrict__ dst,
                                                           const int* __restrict__ ids, int64_t n,
                                                           int64_t row_bytes) {
  for (int64_t i = blockIdx.x; i < n; i += gridDim.x) {
    int64_t s, d;
    rows_of<GATHER>(ids, i, s, d);
    const unsigned char* from = src + s * row_bytes;
    unsigned char* to = dst + d * row_bytes;
    for (int64_t j = threadIdx.x; j < row_bytes; j += THREADS) to[j] = from[j];
  }
}

template <bool GATHER>
int launch(const void* src, void* dst, const int* ids, int64_t n, int64_t row_bytes,
           cudaStream_t s) {
  if (n <= 0 || row_bytes <= 0) return 0;
  const int grid = static_cast<int>(n < MAX_GRID ? n : MAX_GRID);
  const bool vec = row_bytes % 16 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dst) % 16 == 0;
  if (vec) {
    copy_rows_vec<GATHER><<<grid, THREADS, 0, s>>>(static_cast<const uint4*>(src),
                                                  static_cast<uint4*>(dst), ids, n, row_bytes / 16);
  } else {
    copy_rows_bytes<GATHER><<<grid, THREADS, 0, s>>>(static_cast<const unsigned char*>(src),
                                                    static_cast<unsigned char*>(dst), ids, n,
                                                    row_bytes);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// staged (n rows) <- pool rows ids[0..n). Returns cudaGetLastError().
extern "C" int kv_gather(const void* pool, void* staged, const void* ids, long long n,
                         long long row_bytes, void* stream) {
  return launch<true>(pool, staged, static_cast<const int*>(ids), n, row_bytes,
                      static_cast<cudaStream_t>(stream));
}

// pool rows ids[0..n) <- staged (n rows), in place. Returns cudaGetLastError().
extern "C" int kv_scatter(void* pool, const void* staged, const void* ids, long long n,
                          long long row_bytes, void* stream) {
  return launch<false>(staged, pool, static_cast<const int*>(ids), n, row_bytes,
                       static_cast<cudaStream_t>(stream));
}

extern "C" const char* error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
