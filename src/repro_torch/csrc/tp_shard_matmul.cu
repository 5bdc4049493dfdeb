// TP-shard-selecting matmul for Hopper (sm_90a).
//
// Replaces: repro/kernels/tp_shard_matmul/kernel.py, tp_shard_matmul_p
// (Pallas body _mm_kernel). As there, one compiled kernel serves every shard
// and every TP level: the shard is chosen by a runtime offset, here folded
// into the weight's base pointer by the caller (col: w + off, row:
// w + off * N_store, col_t: w + off * K), with the storage row length as
// the leading dimension. No weight byte is copied to select a shard.
//
//   y[M, N] = x[M, K] @ W,   sums in f32, where
//   col, row:  W[k][n] = w[k * ldw + n]
//   col_t:     W[k][n] = w[n * ldw + k]   (trans = 1: the weight stored
//              transposed, as the tied LM head reads the (vocab, d)
//              embedding; a vocab shard is a contiguous block of rows)
//
// What bounds it on an H100 (3.35 TB/s, 989 TFLOP/s bf16 on the tensor
// cores, 67 TFLOP/s f32 on the FMA units):
//  * decode, M = 8 slots: every weight byte is used 8 times, far below the
//    ~295 operations per byte where the tensor cores become the limit, so
//    reading the weight bounds it (w_gate 4096 x 14336: 117 MB, 35 us).
//  * prefill, M = 32..128: still bytes on the tensor cores (w_gate at
//    M = 128: 122 MB = 36 us against 15.0 GFLOP = 15 us), but 0.224 ms
//    on the FMA units, so bf16 has to run on the tensor cores.
//
// bf16 (x and w bf16; y bf16, or f32 for the LM head's logits): one kernel,
// wgmma_mm, for every M.
//  * Swap A and B: y^T = W^T x^T. The weight's columns run along wgmma's
//    64-row M and the tokens along its N (NT = 8, 16, 32, 64 or 128, M
//    rounded up with zero rows; at most 64 or 32 for a weight that fits in
//    L2, so that a small projection still fills the card at prefill
//    without a long split-K reduce), so at decode the weight fills the tensor
//    core instead of 8 of its 64 rows. A block owns 128 weight columns
//    (two 64-column sub-tiles, one m64nNTk16 each per K step of 16) and
//    NT tokens. A is the weight tile, N contiguous (MN-major, wgmma's
//    transpose bit); B is the x tile, K-major. In col_t the weight tile is
//    K-major like x (transpose bit clear): TMA boxes of 64 weight rows x 64
//    K from the folded base, the same 128-byte swizzle, the descriptor
//    stepping 32 bytes along a row per K step of 16 instead of 2 KiB down
//    the rows. Only f32 output (logits) is instantiated for it.
//  * A ring of 6 (NT = 128) to 8 stages in 192 KiB of dynamic shared memory
//    (each stage 64 K rows of both weight sub-tiles and NT rows of x,
//    128-byte swizzle), one block per SM. One producer warp keeps TMA
//    loads (cp.async.bulk.tensor) in flight; they complete on an mbarrier
//    per stage. One consumer warpgroup runs wgmma on the stages that have
//    arrived, one stage's products in flight, and frees each stage on a
//    second mbarrier. Weight bytes go from device memory to shared memory
//    without passing through registers.
//  * The TMA descriptors are cut at the shard: the weight's extent is
//    (K rows, N columns) from the folded base with row stride ldw * 2
//    bytes, so a ragged last tile is zero-filled by TMA and never reads the
//    next rank's rows or columns; x is cut at M and K the same way. The
//    weight's descriptor is encoded once per (pointer, shape, stride) and
//    cached: WeightStore's pointers do not change.
//  * Under a CUDA graph: both maps go to the kernel by value, as
//    __grid_constant__ parameters, so a captured launch keeps the maps it
//    was captured with (the weight's from the cache, by its pointer; x's
//    encoded from x's address in that call), as it keeps y, the workspace
//    and the counters by address. A graph is therefore valid only while its
//    weights, its input and output buffers and its scratch keep their
//    addresses: WeightStore never moves a weight, the graph's memory pool
//    keeps the buffers it allocated at capture, and the graph's owner keeps
//    the scratch (repro_torch/core/tp_switch.py).
//  * TMA needs 16-byte-aligned bases and row strides. Where x or the
//    weight misses that, the producer warp writes the same swizzled tiles,
//    zeros past the edges, with ordinary loads and feeds the same wgmma
//    sequence: the loader differs, the arithmetic does not. So a shard read
//    in place is bit-identical to the pre-sliced weight at any offset.
//  * Split-K in the same launch: blocks along K write f32 partial tiles to
//    a workspace, __threadfence(), and take a ticket on a per-tile counter;
//    the last block adds the S partials in split order 0..S-1, writes y and
//    resets the counter. No atomics on values, so two calls on the same
//    inputs agree bit for bit. S depends on (M, N, K) only: enough splits
//    to give each SM one block, each of at least 8 K tiles (so the partial
//    tiles stay small beside the weight bytes). Workspace and counters come
//    from the caller.
//  What is left: persistent blocks that overlap one tile's epilogue with
//  the next tile's loads, clusters with TMA multicast of x, fp8 weights.
//
// f32 (the full-depth trajectory check) stays on the FMA units, without
// TF32 (its tolerance is 1e-5). Two kernels, chosen from M, each one
// launch per call:
//  * M <= 8 (decode), skinny_mm<TA>: the bf16 path's shape with FMAs in
//    place of wgmma. The weight's bytes bound it, so it keeps many of them
//    in flight without passing through registers, and reduces split-K in
//    the same launch: a producer warp keeps a ring of 6 stages in flight
//    per block, two blocks per SM (~200 KiB per SM): each
//    stage 32 K of 128 weight columns (col, row: a (32, 128) tile of
//    W[k][n]; col_t: 128 weight rows x 32 K, K contiguous, 16 KiB either
//    way) and x's 8 rows of those 32 K, by TMA with f32 tensor maps cut at
//    the shard (cached per pointer, shape and stride, as for bf16), or,
//    where a base or row stride is not 16-byte aligned, by 4-byte cp.async
//    into the same tile layout, zeros past the edges, completing on the
//    same mbarrier (cp.async.mbarrier.arrive.noinc). Four consumer warps
//    run the FMAs from shared memory. col, row: a lane owns 4 columns and
//    each warp a quarter of a stage's K; the warps' sums are added in warp
//    order at the end. col_t: 8 lanes share a weight row, each 4 of a
//    stage's 32 K, a lane holds 8 rows x 8 tokens, and the 8 lanes add
//    their sums by a fixed butterfly of shuffles. Split-K is reduced in the
//    same launch as for bf16 (partial tiles of 8 x 128, a ticket per tile,
//    the last block adds splits 0..S-1 in order and resets the counter):
//    S fills ~2 blocks per SM, each split at least 4 stages. The loader
//    differs between TMA and cp.async, the arithmetic does not, so a shard
//    read in place is bit-identical to the pre-sliced weight at any offset.
//  * M > 8 (prefill), fma_mm<BM, TA, THREADS>: one launch per call,
//    split-K included. Bytes bound it up to M ~ 40 (the weight at 3.35 TB/s
//    against 2 M K N FMAs at 67 TFLOP/s), FMAs above: a 4096-token prompt's
//    projections are all FMA work (gemma2-2b's w_gate: 2.6 ms). What stands
//    between the FMA units and that bound is shared memory: an SM reads 32
//    floats a clock from it and issues 128 FMAs, so a thread that holds
//    TM x TN sums must do TM TN / (TM + TN) >= 4 FMAs per float it reads.
//    So each thread holds 8 x 16 sums (128 threads a block, up to 254
//    registers, two blocks per SM) of a BM x 128 output tile (BM = 128 for
//    M > 64; 64 or 32 below, so that M = 32 or 64 spends no FMA on zero
//    rows; then 4 or 2 rows a thread; and smaller where a narrow shard
//    would leave the card short of blocks). A tile of 64 or 128 rows that
//    splits K takes 4 or 8 x 8 sums on 256 threads instead: its blocks are
//    short, and twice the warps hide their latencies better (measured:
//    PERF.md).
//    A ring of 3 (BM = 128), 4 (64) or 5 (32) stages of 32 K, ~100 KiB a
//    block, is filled by TMA, thread 0 issuing each stage's two loads as
//    many stages ahead as the ring holds less one, once every warp has
//    freed the slot (an empty mbarrier per stage): x's [BM][32] tile, K
//    contiguous, with the 128-byte swizzle (each 128-byte row's eight
//    16-byte chunks permuted by row % 8), and the weight's tile from the f32
//    maps cut at the shard and cached (col, row: [32][128], N contiguous,
//    unswizzled, the decode kernel's map; col_t: [128][32], K contiguous,
//    swizzled like x). A ragged tile, such as the last half-tile of a
//    4160-row prompt, arrives zero-filled. Where TMA cannot take a base or
//    row stride, every thread fills its share of the same layouts by 4-byte
//    cp.async, zeros past the edges, completing on the same full mbarrier.
//    No load passes through registers. A thread reads its rows' x one k at
//    a time (rows ty + 16 r: the lanes of a warp hit different chunks of
//    the swizzle, so no bank conflicts) and its columns of the weight as
//    float4s (col, row: columns 4 tx + 4 TX h .. + 3 of a 16 x TX thread
//    grid, a quarter-warp's 8 lanes on 128 contiguous bytes) or one k at a
//    time (col_t: weight rows tx + TX j, swizzled).
//    Split-K in the same launch, S chosen from (M, N, K) as the fewest
//    splits (each at least 8 stages) that fill the grid's waves of ~2
//    blocks per SM to 0.8 on average: partial tiles of BM x 128 in the
//    workspace, a ticket per tile, the last block streams the
//    partials through its idle ring by cp.async and adds splits 0..S-1 in
//    order, then resets the counter. Every sum walks its K in order and the
//    splits in order, whichever loader ran and whichever thread count: a
//    shard read in place is bit-identical to the pre-sliced weight at any
//    offset.
// Every f32 output is a sum in an order fixed by (M, N, K) alone, so two
// calls on the same inputs agree bit for bit.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <mutex>
#include <unordered_map>

namespace {

constexpr int SMS = 132;               // H100 SXM
constexpr int TARGET_BLOCKS = 2 * SMS;  // f32: split K until the grid has ~2 blocks per SM

template <typename O> __device__ __forceinline__ O from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }
__device__ __forceinline__ int dceil_div(int a, int b) { return (a + b - 1) / b; }
// ---------------------------------------------------------------------------
// bf16: TMA-fed wgmma, swap-AB, split-K reduced in the same launch
// ---------------------------------------------------------------------------
constexpr int WG_BN = 128;        // weight columns per block: two 64-column sub-tiles
constexpr int WG_BK = 64;         // K rows per stage: 128 bytes of bf16, one swizzle row
constexpr int WG_THREADS = 160;   // consumer warpgroup (warps 0-3) + producer warp (warp 4)
constexpr int SUB_BYTES = 64 * WG_BK * 2;  // one 64-column weight sub-tile, 8 KiB
constexpr int RING_BUDGET = 192 * 1024;    // shared memory for the ring: one block per SM

template <int NT> struct Ring {
  static constexpr int X_BYTES = NT * WG_BK * 2;
  static constexpr int STAGE_BYTES = 2 * SUB_BYTES + X_BYTES;  // a multiple of 1024
  static constexpr int FIT = RING_BUDGET / STAGE_BYTES;
  static constexpr int STAGES = FIT > 8 ? 8 : FIT;  // 6 (NT = 128) to 8 stages
  // the ring, one full and one empty mbarrier per stage, and slack to align the ring to 1024 bytes
  static constexpr int SMEM = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;
};

// wgmma m64nNk16, f32 += bf16 x bf16: A (the weight tile) from shared
// memory, MN-major (TA = 1, the transpose bit) or K-major (TA = 0, col_t);
// B (the x tile) K-major from shared memory.
template <int N, int TA> struct Wgmma;
template <int TA> struct Wgmma<8, TA> {
  static __device__ __forceinline__ void mma(float (&d)[4], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3"
        "}, %4, %5, p, 1, 1, %7, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(a), "l"(b), "r"(1), "n"(TA));
  }
};
template <int TA> struct Wgmma<16, TA> {
  static __device__ __forceinline__ void mma(float (&d)[8], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1, %11, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(1), "n"(TA));
  }
};
template <int TA> struct Wgmma<32, TA> {
  static __device__ __forceinline__ void mma(float (&d)[16], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, %19, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(1), "n"(TA));
  }
};
template <int TA> struct Wgmma<64, TA> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, %35, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(1), "n"(TA));
  }
};
template <int TA> struct Wgmma<128, TA> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, %67, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(1), "n"(TA));
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// arrive and expect `bytes` of TMA traffic before the phase can complete
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// one 2-D TMA tile load (c0: inner coordinate, c1: outer) that completes on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// Shared-memory matrix descriptor of a 128-byte-swizzled tile: start address,
// leading and stride byte offsets (16-byte units), layout type 1 (128B swizzle).
// Both operands' 8-row groups lie 1024 bytes apart (SBO). The weight tile is
// MN-major and exactly one swizzle atom (64 columns) wide, so its LBO (the
// step to a next 64-column atom) is never taken; the x tile, and col_t's
// weight tile, are K-major, for which LBO is ignored.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1024 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

// keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma's fence and wait
template <int R> __device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// A (rows x 64) bf16 tile in the layout TMA's 128-byte swizzle gives it:
// element (r, c) at byte r * 128 + ((c / 8) ^ (r % 8)) * 16 + (c % 8) * 2.
// src[r * ld + c] where r < rows and c < cols, zero elsewhere. Written by the
// 32 lanes of the producer warp, for operands TMA cannot take.
__device__ __forceinline__ void fill_tile(uint8_t* dst, const uint16_t* src, int64_t ld, int rows, int cols,
                                          int R, int lane) {
  for (int e = lane; e < R * 64; e += 32) {
    const int r = e >> 6, c = e & 63;
    const uint16_t v = r < rows && c < cols ? src[r * ld + c] : uint16_t(0);
    *reinterpret_cast<uint16_t*>(dst + r * 128 + ((((c >> 3) ^ (r & 7)) << 4) | ((c & 7) << 1))) = v;
  }
}

struct WgArgs {
  const uint16_t* x;  // bf16 bits
  const uint16_t* w;
  void* y;
  float* ws;       // f32 partial tiles, S per output tile
  int* counters;   // arrivals per output tile; 0 between calls
  int M, N, K;
  int64_t ldw;
  int S, kts;      // splits along K, K tiles (of WG_BK) per split
  int tma;         // 1: TMA loads; 0: the producer warp's own loads
};

// grid (N tiles of 128, S, M tiles of NT); WG_THREADS threads. TA = 1: the
// weight is (K, N) rows, its tile MN-major; TA = 0 (col_t): (N, K) rows,
// its tile K-major.
template <int NT, typename O, int TA>
__global__ void __launch_bounds__(WG_THREADS)
wgmma_mm(const __grid_constant__ CUtensorMap wmap, const __grid_constant__ CUtensorMap xmap, const WgArgs a) {
  using RG = Ring<NT>;
  constexpr int R = NT / 2;  // accumulators per thread per 64-column sub-tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + RG::STAGES * RG::STAGE_BYTES);
  uint64_t* empty = full + RG::STAGES;
  __shared__ int last;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * WG_BN, split = blockIdx.y, m0 = blockIdx.z * NT;
  const int kt0 = split * a.kts, nkt = min(a.kts, dceil_div(a.K, WG_BK) - kt0);

  if (tid == 0) {
    for (int s = 0; s < RG::STAGES; ++s) {
      mbar_init(&full[s], 1);   // the producer's one arrival (plus the TMA bytes)
      mbar_init(&empty[s], 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {  // producer: fill the ring
    for (int i = 0; i < nkt; ++i) {
      const int s = i % RG::STAGES;
      mbar_wait(&empty[s], ((i / RG::STAGES) & 1) ^ 1);
      uint8_t* st = ring + s * RG::STAGE_BYTES;
      const int k0 = (kt0 + i) * WG_BK;
      if (a.tma) {
        if (lane == 0) {  // boxes past the shard's edge (even wholly) arrive zero-filled
          mbar_expect_tx(&full[s], RG::STAGE_BYTES);
          if (TA) {
            tma_load(st, &wmap, &full[s], n0, k0);
            tma_load(st + SUB_BYTES, &wmap, &full[s], n0 + 64, k0);
          } else {
            tma_load(st, &wmap, &full[s], k0, n0);
            tma_load(st + SUB_BYTES, &wmap, &full[s], k0, n0 + 64);
          }
          tma_load(st + 2 * SUB_BYTES, &xmap, &full[s], k0, m0);
        }
      } else {
        if (TA) {
          const uint16_t* wk = a.w + k0 * a.ldw + n0;
          fill_tile(st, wk, a.ldw, a.K - k0, a.N - n0, 64, lane);
          fill_tile(st + SUB_BYTES, wk + 64, a.ldw, a.K - k0, a.N - n0 - 64, 64, lane);
        } else {
          const uint16_t* wn = a.w + n0 * a.ldw + k0;
          fill_tile(st, wn, a.ldw, a.N - n0, a.K - k0, 64, lane);
          fill_tile(st + SUB_BYTES, wn + 64 * a.ldw, a.ldw, a.N - n0 - 64, a.K - k0, 64, lane);
        }
        fill_tile(st + 2 * SUB_BYTES, a.x + (int64_t)m0 * a.K + k0, a.K, a.M - m0, a.K - k0, NT, lane);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // generic writes -> wgmma reads
        __syncwarp();
        if (lane == 0) mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // consumer warpgroup
  float acc0[R], acc1[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc0[r] = acc1[r] = 0.f;
  const uint32_t ring_addr = smem_u32(ring);
  fence_regs(acc0);
  fence_regs(acc1);
  for (int i = 0; i < nkt; ++i) {
    const int s = i % RG::STAGES;
    mbar_wait(&full[s], (i / RG::STAGES) & 1);
    const uint32_t st = ring_addr + s * RG::STAGE_BYTES;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int j = 0; j < WG_BK / 16; ++j) {
      const uint64_t b = sw128_desc(st + 2 * SUB_BYTES + j * 32);  // 16 K values = 32 bytes along a row
      const uint32_t step = TA ? j * 2048 : j * 32;                 // MN-major: 16 K rows of 128 bytes
      Wgmma<NT, TA>::mma(acc0, sw128_desc(st + step), b);
      Wgmma<NT, TA>::mma(acc1, sw128_desc(st + SUB_BYTES + step), b);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // keep this stage's products in flight; the previous stage's are done, so free its tiles
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    if (i > 0 && lane == 0) mbar_arrive(&empty[(i - 1) % RG::STAGES]);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_regs(acc0);
  fence_regs(acc1);

  // Accumulator r of sub-tile h holds weight column n0 + 64 h + row(r) and
  // token m0 + col(r) (wgmma's D fragment: rows by warp and lane / 4, columns
  // by lane % 4 and r).
  O* y = static_cast<O*>(a.y);
  auto out = [&](int h, int r, float v) {
    const int n = n0 + 64 * h + warp * 16 + (lane >> 2) + 8 * ((r >> 1) & 1);
    const int m = m0 + (r >> 2) * 8 + (lane & 3) * 2 + (r & 1);
    if (n < a.N && m < a.M) y[(int64_t)m * a.N + n] = from_f32<O>(v);
  };
  auto out_all = [&]() {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      out(0, r, acc0[r]);
      out(1, r, acc1[r]);
    }
  };
  if (a.S == 1) {
    out_all();
    return;
  }

  // split-K: this split's partial tile as float4s of the fragment, in
  // [float4][tid] order (coalesced over tid); F4 float4s per thread
  constexpr int F4 = 2 * R / 4, H4 = F4 / 2;  // H4 per sub-tile
  const int tile = blockIdx.z * gridDim.x + blockIdx.x;
  float4* parts = reinterpret_cast<float4*>(a.ws) + (int64_t)tile * a.S * (F4 * 128);
  float4* mine = parts + (int64_t)split * (F4 * 128);
#pragma unroll
  for (int f = 0; f < H4; ++f) {
    mine[f * 128 + tid] = make_float4(acc0[4 * f], acc0[4 * f + 1], acc0[4 * f + 2], acc0[4 * f + 3]);
    mine[(H4 + f) * 128 + tid] = make_float4(acc1[4 * f], acc1[4 * f + 1], acc1[4 * f + 2], acc1[4 * f + 3]);
  }
  __threadfence();
  asm volatile("bar.sync 1, 128;\n" ::: "memory");  // the consumer warpgroup only
  if (tid == 0) last = atomicAdd(&a.counters[tile], 1) == a.S - 1;
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
  if (!last) return;
  __threadfence();
  // The last block to arrive adds the S partials in split order 0..S-1. They
  // stream through the idle ring with cp.async (L2 only), ZC splits at a
  // time, so that many bytes are in flight; each thread copies and then adds
  // only its own float4s, so no barrier is needed between copy and add.
  constexpr int ZC = RG::STAGES * RG::STAGE_BYTES / (F4 * 16 * 128);
  float4* held = reinterpret_cast<float4*>(ring);
  for (int z0 = 0; z0 < a.S; z0 += ZC) {
    const int nz = min(ZC, a.S - z0);
    for (int zz = 0; zz < nz; ++zz) {
#pragma unroll
      for (int f = 0; f < F4; ++f) {
        const int i = (zz * F4 + f) * 128 + tid;
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(held + i)),
                     "l"(parts + (int64_t)(z0 + zz) * (F4 * 128) + f * 128 + tid)
                     : "memory");
      }
    }
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
    for (int zz = 0; zz < nz; ++zz) {
      const bool first = z0 + zz == 0;
#pragma unroll
      for (int f = 0; f < H4; ++f) {
        const float4 u = held[(zz * F4 + f) * 128 + tid], v = held[(zz * F4 + H4 + f) * 128 + tid];
        const float us[4] = {u.x, u.y, u.z, u.w}, vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc0[4 * f + c] = first ? us[c] : acc0[4 * f + c] + us[c];
          acc1[4 * f + c] = first ? vs[c] : acc1[4 * f + c] + vs[c];
        }
      }
    }
  }
  out_all();
  if (tid == 0) a.counters[tile] = 0;  // ready for the next call on this stream, or the next replay of a graph
}

// How a bf16 call is cut: tokens per block (NT), N and M tiles, and S splits
// along K of kts K tiles each. Depends on the shapes only.
struct WgPlan {
  int NT, tiles_n, tiles_m, S, kts;
};

WgPlan plan_bf16(int M, int N, int K) {
  WgPlan p;
  p.NT = M <= 8 ? 8 : M <= 16 ? 16 : M <= 32 ? 32 : M <= 64 ? 64 : 128;
  // A weight that fits in L2 (<= 32 MiB, <= 8 MiB) makes few tiles: there,
  // narrower token tiles, which read it again from L2, fill the SMs at less
  // split-K than wide ones would need.
  const long long wtiles = (long long)ceil_div(N, WG_BN) * ceil_div(K, WG_BK);
  p.NT = std::min(p.NT, wtiles <= 512 ? 32 : wtiles <= 2048 ? 64 : 128);
  p.tiles_n = ceil_div(N, WG_BN);
  p.tiles_m = ceil_div(M, p.NT);
  const int kt = ceil_div(K, WG_BK);
  // as many splits as fill the SMs with one block each, each of at least 8 K tiles
  const int S = std::max(1, std::min(SMS / (p.tiles_n * p.tiles_m), kt / 8));
  p.kts = ceil_div(kt, S);
  p.S = ceil_div(kt, p.kts);
  return p;
}

// ---------------------------------------------------------------------------
// f32, decode path (M <= 8): the same ring, fed by TMA or cp.async; FMAs
// ---------------------------------------------------------------------------
constexpr int SK_M = 8;                          // x rows a block computes; rows past M are zero
constexpr int SK_BN = 128;                       // weight columns (col_t: weight rows) per block
constexpr int SK_BK = 32;                        // K per stage: 128 bytes of f32
constexpr int SK_THREADS = 160;                  // 4 consumer warps (0-3) + the producer warp (4)
constexpr int SK_W_BYTES = SK_BN * SK_BK * 4;    // the weight tile, 16 KiB
constexpr int SK_STAGE = SK_W_BYTES + SK_M * SK_BK * 4;  // + x's tile, 1 KiB
constexpr int SK_STAGES = 6;                     // 102 KiB a block: two blocks per SM
constexpr int SK_TILE = SK_M * SK_BN;            // floats of one output (or partial) tile
// the ring, one full and one empty mbarrier per stage, and slack to align the ring to 1024 bytes
constexpr int SK_SMEM = SK_STAGES * SK_STAGE + 2 * SK_STAGES * 8 + 1024;
constexpr int SK_MIN_KT = 4;                     // stages per split, at least

// 4 bytes global -> shared, asynchronously; zeros where !ok (src is then not read)
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

// arrive on bar once this thread's cp.asyncs so far have landed (counted in the barrier's expected arrivals)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void consumers_sync() { asm volatile("bar.sync 1, 128;\n" ::: "memory"); }

struct SkArgs {
  const float* x;
  const float* w;
  float* y;
  float* ws;       // partial tiles, S per output tile
  int* counters;   // arrivals per output tile; 0 between calls
  int M, N, K;
  int64_t ldw;
  int S, kts;      // splits along K, stages (of SK_BK) per split
  int tma;         // 1: TMA loads; 0: the producer warp's cp.async
};

// grid (N tiles of SK_BN, S); SK_THREADS threads. TA = 1 (col, row): the
// weight is (K, N) rows, a stage's tile [SK_BK][SK_BN]; TA = 0 (col_t): (N,
// K) rows, the tile [SK_BN][SK_BK]. x's tile is [SK_M][SK_BK] either way.
template <int TA>
__global__ void __launch_bounds__(SK_THREADS, 2)
skinny_mm(const __grid_constant__ CUtensorMap wmap, const __grid_constant__ CUtensorMap xmap, const SkArgs a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + SK_STAGES * SK_STAGE);
  uint64_t* empty = full + SK_STAGES;
  __shared__ int last;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * SK_BN, split = blockIdx.y;
  const int kt0 = split * a.kts, nkt = min(a.kts, dceil_div(a.K, SK_BK) - kt0);

  if (tid == 0) {
    for (int s = 0; s < SK_STAGES; ++s) {
      mbar_init(&full[s], a.tma ? 1 : 32);  // TMA: the producer's one arrival; else one per lane's copies
      mbar_init(&empty[s], 4);              // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {  // producer: fill the ring
    for (int i = 0; i < nkt; ++i) {
      const int s = i % SK_STAGES;
      mbar_wait(&empty[s], ((i / SK_STAGES) & 1) ^ 1);
      float* st = reinterpret_cast<float*>(ring + s * SK_STAGE);
      const int k0 = (kt0 + i) * SK_BK;
      if (a.tma) {
        if (lane == 0) {  // boxes past the shard's or x's edge arrive zero-filled
          mbar_expect_tx(&full[s], SK_STAGE);
          tma_load(st, &wmap, &full[s], TA ? n0 : k0, TA ? k0 : n0);
          tma_load(st + SK_BN * SK_BK, &xmap, &full[s], k0, 0);
        }
      } else {
        for (int e = lane; e < SK_BN * SK_BK; e += 32) {
          const int r = TA ? e / SK_BN : e / SK_BK, c = TA ? e % SK_BN : e % SK_BK;
          const int k = k0 + (TA ? r : c), n = n0 + (TA ? c : r);
          const bool ok = k < a.K && n < a.N;
          cp_async4(st + e, ok ? a.w + (TA ? (int64_t)k * a.ldw + n : (int64_t)n * a.ldw + k) : a.w, ok);
        }
        for (int e = lane; e < SK_M * SK_BK; e += 32) {
          const int m = e / SK_BK, k = k0 + e % SK_BK;
          const bool ok = m < a.M && k < a.K;
          cp_async4(st + SK_BN * SK_BK + e, ok ? a.x + (int64_t)m * a.K + k : a.x, ok);
        }
        cp_async_arrive(&full[s]);
      }
    }
    return;
  }

  // consumers: this thread's sums of the block's output tile, (m, n0 + tid) for m < SK_M
  float v[SK_M];
  float* red = reinterpret_cast<float*>(ring);  // the ring, once every stage is consumed
  if (TA) {
    // lane: columns 4 lane .. + 3; warp: K rows 8 warp .. + 7 of each stage
    float acc[SK_M][4];
#pragma unroll
    for (int m = 0; m < SK_M; ++m) acc[m][0] = acc[m][1] = acc[m][2] = acc[m][3] = 0.f;
    for (int i = 0; i < nkt; ++i) {
      const int s = i % SK_STAGES;
      mbar_wait(&full[s], (i / SK_STAGES) & 1);
      const float* wt = reinterpret_cast<const float*>(ring + s * SK_STAGE);
      const float* xt = wt + SK_BN * SK_BK;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r0 = warp * 8 + h * 4;
        float4 xv[SK_M], wv[4];
#pragma unroll
        for (int m = 0; m < SK_M; ++m) xv[m] = *reinterpret_cast<const float4*>(xt + m * SK_BK + r0);
#pragma unroll
        for (int u = 0; u < 4; ++u) wv[u] = *reinterpret_cast<const float4*>(wt + (r0 + u) * SK_BN + lane * 4);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
#pragma unroll
          for (int m = 0; m < SK_M; ++m) {
            const float xm = u == 0 ? xv[m].x : u == 1 ? xv[m].y : u == 2 ? xv[m].z : xv[m].w;
            acc[m][0] = fmaf(xm, wv[u].x, acc[m][0]);
            acc[m][1] = fmaf(xm, wv[u].y, acc[m][1]);
            acc[m][2] = fmaf(xm, wv[u].z, acc[m][2]);
            acc[m][3] = fmaf(xm, wv[u].w, acc[m][3]);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    consumers_sync();
#pragma unroll
    for (int m = 0; m < SK_M; ++m)
      *reinterpret_cast<float4*>(red + (warp * SK_M + m) * SK_BN + lane * 4) =
          make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
    consumers_sync();
#pragma unroll
    for (int m = 0; m < SK_M; ++m)  // the 4 warps' sums, in warp order
      v[m] = ((red[m * SK_BN + tid] + red[(SK_M + m) * SK_BN + tid]) + red[(2 * SK_M + m) * SK_BN + tid]) +
             red[(3 * SK_M + m) * SK_BN + tid];
  } else {
    // lane: K 4 c .. + 3 of each stage (c = lane % 8) of rows 32 warp + 4 j + lane / 8, j < 8
    const int c = lane & 7, r0 = warp * 32 + (lane >> 3);
    float acc[8][SK_M];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int m = 0; m < SK_M; ++m) acc[j][m] = 0.f;
    for (int i = 0; i < nkt; ++i) {
      const int s = i % SK_STAGES;
      mbar_wait(&full[s], (i / SK_STAGES) & 1);
      const float* wt = reinterpret_cast<const float*>(ring + s * SK_STAGE);
      const float* xt = wt + SK_BN * SK_BK;
      float4 xv[SK_M];
#pragma unroll
      for (int m = 0; m < SK_M; ++m) xv[m] = *reinterpret_cast<const float4*>(xt + m * SK_BK + 4 * c);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 wv = *reinterpret_cast<const float4*>(wt + (r0 + 4 * j) * SK_BK + 4 * c);
#pragma unroll
        for (int m = 0; m < SK_M; ++m) {
          acc[j][m] = fmaf(xv[m].x, wv.x, acc[j][m]);
          acc[j][m] = fmaf(xv[m].y, wv.y, acc[j][m]);
          acc[j][m] = fmaf(xv[m].z, wv.z, acc[j][m]);
          acc[j][m] = fmaf(xv[m].w, wv.w, acc[j][m]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    // the 8 lanes of a row add their sums by the same butterfly; lane c keeps token c's
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int m = 0; m < SK_M; ++m)
#pragma unroll
        for (int o = 1; o < 8; o <<= 1) acc[j][m] += __shfl_xor_sync(0xffffffffu, acc[j][m], o);
    consumers_sync();
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int m = 0; m < SK_M; ++m)
        if (m == c) red[m * SK_BN + r0 + 4 * j] = acc[j][m];
    consumers_sync();
#pragma unroll
    for (int m = 0; m < SK_M; ++m) v[m] = red[m * SK_BN + tid];
  }

  auto out = [&]() {  // this thread's column of y
#pragma unroll
    for (int m = 0; m < SK_M; ++m)
      if (m < a.M && n0 + tid < a.N) a.y[(int64_t)m * a.N + n0 + tid] = v[m];
  };
  if (a.S == 1) {
    out();
    return;
  }
  // split-K: this split's tile to the workspace, then a ticket; the last
  // block to arrive adds splits 0..S-1 in that order, 8 splits' loads in flight
  float* parts = a.ws + (int64_t)blockIdx.x * a.S * SK_TILE;
#pragma unroll
  for (int m = 0; m < SK_M; ++m) parts[split * SK_TILE + m * SK_BN + tid] = v[m];
  __threadfence();
  consumers_sync();
  if (tid == 0) last = atomicAdd(&a.counters[blockIdx.x], 1) == a.S - 1;
  consumers_sync();
  if (!last) return;
  __threadfence();
  for (int z0 = 0; z0 < a.S; z0 += 8) {
    float p[8][SK_M];
#pragma unroll
    for (int zz = 0; zz < 8; ++zz)
#pragma unroll
      for (int m = 0; m < SK_M; ++m)
        p[zz][m] = z0 + zz < a.S ? __ldcg(parts + (z0 + zz) * SK_TILE + m * SK_BN + tid) : 0.f;
#pragma unroll
    for (int zz = 0; zz < 8; ++zz)
#pragma unroll
      for (int m = 0; m < SK_M; ++m)
        if (z0 + zz < a.S) v[m] = z0 + zz == 0 ? p[zz][m] : v[m] + p[zz][m];
  }
  out();
  if (tid == 0) a.counters[blockIdx.x] = 0;  // ready for the next call on this stream, or the next replay of a graph
}

// How a decode f32 call is cut: N tiles of SK_BN and S splits along K of
// kts stages each. Depends on the shapes only.
struct SkPlan {
  int tiles, S, kts;
};

SkPlan plan_skinny(int N, int K) {
  SkPlan p;
  p.tiles = ceil_div(N, SK_BN);
  const int kt = ceil_div(K, SK_BK);
  // as many splits as give each SM two blocks, each of at least SK_MIN_KT stages
  const int S = std::max(1, std::min(TARGET_BLOCKS / p.tiles, kt / SK_MIN_KT));
  p.kts = ceil_div(kt, S);
  p.S = ceil_div(kt, p.kts);
  return p;
}

// ---------------------------------------------------------------------------
// f32, prefill path (M > 8): a ring fed by TMA or cp.async; 8 x 16 FMA tiles
// ---------------------------------------------------------------------------
constexpr int FM_BN = 128;           // weight columns (col_t: weight rows) per block
constexpr int FM_BK = 32;            // K per stage: 128 bytes of f32
constexpr int FM_RING = 100 * 1024;  // shared memory for the ring: two blocks per SM
constexpr int FM_W_FLOATS = FM_BK * FM_BN;  // the weight's tile, 16 KiB
static_assert(FM_BN == SK_BN && FM_BK == SK_BK, "the weight's f32 tensor maps serve both f32 kernels");

template <int BM> struct Fm {
  static constexpr int TM = BM / 16;                  // rows per thread: ty + 16 r
  static constexpr int STAGE = (FM_W_FLOATS + BM * FM_BK) * 4;  // + x's tile; a multiple of 1024
  static constexpr int STAGES = FM_RING / STAGE;      // 3 (BM 128), 4 (64), 5 (32)
  // the ring, one full and one empty mbarrier per stage, and slack to align the ring to 1024 bytes
  static constexpr int SMEM = STAGES * STAGE + 2 * STAGES * 8 + 1024;
};
constexpr int FM_MIN_KT = 8;  // stages per split, at least

struct FmArgs {
  const float* x;
  const float* w;
  float* y;
  float* ws;       // partial tiles, S per output tile
  int* counters;   // arrivals per output tile; 0 between calls
  int M, N, K;
  int64_t ldw;
  int S, kts;      // splits along K, stages (of FM_BK) per split
  int tma;         // 1: TMA loads; 0: every thread's cp.async
};

// Element (r, k) of a K-contiguous [rows][32] f32 tile (x's; col_t's
// weight), in floats: row r's 8 chunks of 4 K permuted by r % 8, as TMA's
// 128-byte swizzle lays them out.
__device__ __forceinline__ int sw128(int r, int k) { return r * 32 + ((((k >> 2) ^ (r & 7)) << 2) | (k & 3)); }

// grid (M tiles of BM, N tiles of FM_BN, S); THREADS (128 or 256) threads,
// no producer warp: thread 0 issues a stage's two TMA loads (or, without
// TMA, every thread its share of 4-byte cp.asyncs into the same layouts)
// once every warp has freed the slot. Thread (ty, tx) of the 16 x TX grid
// holds rows ty + 16 r and TN = 128 / TX columns: TA = 1 (col, row: the
// weight is (K, N) rows, its tile [FM_BK][FM_BN] dense, read as float4s)
// 4 tx + 4 TX h .. + 3; TA = 0 (col_t: (N, K) rows, its tile swizzled like
// x's, read one k at a time) tx + TX j. Every sum takes its K in order, so
// the thread count changes no bit of the result.
template <int BM, int TA, int THREADS>
__global__ void __launch_bounds__(THREADS, 2)
fma_mm(const __grid_constant__ CUtensorMap wmap, const __grid_constant__ CUtensorMap xmap, const FmArgs a) {
  using F = Fm<BM>;
  // a 16 x TX grid of threads, each TM rows x TN columns
  constexpr int TM = F::TM, WARPS = THREADS / 32, TX = THREADS / 16, TN = FM_BN / TX;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + F::STAGES * F::STAGE);
  uint64_t* empty = full + F::STAGES;
  __shared__ int last;

  const int tid = threadIdx.x, lane = tid & 31, tx = tid % TX, ty = tid / TX;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * FM_BN, split = blockIdx.z;
  const int kt0 = split * a.kts, nkt = min(a.kts, dceil_div(a.K, FM_BK) - kt0);

  if (tid == 0) {
    for (int s = 0; s < F::STAGES; ++s) {
      mbar_init(&full[s], a.tma ? 1 : THREADS);  // TMA: thread 0's arrival; else every thread's copies
      mbar_init(&empty[s], WARPS);                  // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // this split's stage t into slot t % STAGES, once every warp has freed it;
  // zeros past the shard's and x's edges
  auto refill = [&](int t) {
    const int s = t % F::STAGES;
    float* wt = reinterpret_cast<float*>(ring + s * F::STAGE);
    float* xt = wt + FM_W_FLOATS;
    const int k0 = (kt0 + t) * FM_BK;
    if (a.tma) {
      if (tid == 0) {
        mbar_wait(&empty[s], ((t / F::STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], F::STAGE);
        tma_load(wt, &wmap, &full[s], TA ? n0 : k0, TA ? k0 : n0);
        tma_load(xt, &xmap, &full[s], k0, m0);
      }
      return;
    }
    mbar_wait(&empty[s], ((t / F::STAGES) & 1) ^ 1);
    for (int e = tid; e < FM_W_FLOATS; e += THREADS) {  // lanes along the tile's contiguous axis
      const int r = TA ? e / FM_BN : e / FM_BK, c = TA ? e % FM_BN : e % FM_BK;
      const int k = k0 + (TA ? r : c), n = n0 + (TA ? c : r);
      const bool ok = k < a.K && n < a.N;
      cp_async4(wt + (TA ? e : sw128(r, c)), ok ? a.w + (TA ? (int64_t)k * a.ldw + n : (int64_t)n * a.ldw + k) : a.w,
                ok);
    }
    for (int e = tid; e < BM * FM_BK; e += THREADS) {
      const int r = e / FM_BK, k = k0 + e % FM_BK, m = m0 + r;
      const bool ok = m < a.M && k < a.K;
      cp_async4(xt + sw128(r, e % FM_BK), ok ? a.x + (int64_t)m * a.K + k : a.x, ok);
    }
    cp_async_arrive(&full[s]);
  };

  for (int t = 0; t < F::STAGES - 1 && t < nkt; ++t) refill(t);

  float acc[TM][TN];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[r][j] = 0.f;
  for (int i = 0; i < nkt; ++i) {
    if (i + F::STAGES - 1 < nkt) refill(i + F::STAGES - 1);  // the slot stage i - 1 used
    const int s = i % F::STAGES;
    mbar_wait(&full[s], (i / F::STAGES) & 1);
    const float* wt = reinterpret_cast<const float*>(ring + s * F::STAGE);
    const float* xt = wt + FM_W_FLOATS + ty * FM_BK;  // row ty; rows ty + 16 r share its swizzle
#pragma unroll
    for (int c = 0; c < FM_BK / 4; ++c) {
      const float* xc = xt + ((c ^ (ty & 7)) << 2);
      const float* wc = TA ? wt + 4 * tx : wt + tx * FM_BK + ((c ^ (tx & 7)) << 2);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int k = 4 * c + u;
        float xv[TM], wv[TN];
#pragma unroll
        for (int r = 0; r < TM; ++r) xv[r] = xc[r * 16 * FM_BK + u];
        if (TA) {
#pragma unroll
          for (int h = 0; h < TN / 4; ++h) {
            const float4 v = *reinterpret_cast<const float4*>(wc + k * FM_BN + 4 * TX * h);
            wv[4 * h] = v.x, wv[4 * h + 1] = v.y, wv[4 * h + 2] = v.z, wv[4 * h + 3] = v.w;
          }
        } else {
#pragma unroll
          for (int j = 0; j < TN; ++j) wv[j] = wc[j * TX * FM_BK + u];
        }
#pragma unroll
        for (int r = 0; r < TM; ++r)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[r][j] = fmaf(xv[r], wv[j], acc[r][j]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  auto out = [&]() {  // this thread's TM x TN outputs
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const int m = m0 + ty + 16 * r;
      if (m >= a.M) continue;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int n = n0 + (TA ? (j >> 2) * 4 * TX + 4 * tx + (j & 3) : tx + TX * j);
        if (n < a.N) a.y[(int64_t)m * a.N + n] = acc[r][j];
      }
    }
  };
  if (a.S == 1) {
    out();
    return;
  }
  // split-K: this split's tile to the workspace as float4s in [float4][tid]
  // order (coalesced), then a ticket; the last block to arrive adds splits
  // 0..S-1 in that order, each thread its own float4s
  constexpr int F4 = TM * TN / 4;
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  float4* parts = reinterpret_cast<float4*>(a.ws) + (int64_t)tile * a.S * (F4 * THREADS);
  float4* mine = parts + (int64_t)split * (F4 * THREADS);
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int h = 0; h < TN / 4; ++h)
      mine[(TN / 4 * r + h) * THREADS + tid] =
          make_float4(acc[r][4 * h], acc[r][4 * h + 1], acc[r][4 * h + 2], acc[r][4 * h + 3]);
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&a.counters[tile], 1) == a.S - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // The partials stream through the idle ring with cp.async (L2 only), ZC
  // splits at a time, so that many bytes are in flight without holding
  // registers; each thread copies and then adds only its own float4s, so no
  // barrier is needed between copy and add.
  constexpr int ZC = F::STAGES * F::STAGE / (F4 * THREADS * 16);
  float4* held = reinterpret_cast<float4*>(ring);
  for (int z0 = 0; z0 < a.S; z0 += ZC) {
    const int nz = min(ZC, a.S - z0);
    for (int zz = 0; zz < nz; ++zz)
#pragma unroll
      for (int f = 0; f < F4; ++f) {
        const int i = (zz * F4 + f) * THREADS + tid;
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(held + i)),
                     "l"(parts + (int64_t)(z0 + zz) * (F4 * THREADS) + f * THREADS + tid)
                     : "memory");
      }
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
    for (int zz = 0; zz < nz; ++zz) {
      const bool first = z0 + zz == 0;
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int h = 0; h < TN / 4; ++h) {
          const float4 v = held[(zz * F4 + TN / 4 * r + h) * THREADS + tid];
          const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[r][4 * h + e] = first ? vs[e] : acc[r][4 * h + e] + vs[e];
        }
    }
  }
  out();
  if (tid == 0) a.counters[tile] = 0;  // ready for the next call on this stream, or the next replay of a graph
}

// How a prefill f32 call is cut: BM rows per tile, M and N tiles, S
// splits along K of kts stages each, and the block's threads. Depends on
// the shapes only.
struct FmPlan {
  int BM, tiles_m, tiles_n, S, kts, threads;
};

FmPlan plan_fma(int M, int N, int K) {
  FmPlan p;
  const int kt = ceil_div(K, FM_BK), s_max = std::max(1, kt / FM_MIN_KT);
  // BM: the rows M needs (32, 64 or 128), or fewer where that tile leaves
  // the card short of blocks even at the most splits (a TP 8 rank's narrow
  // shard): the largest whose tiles times s_max reach 0.4 of TARGET_BLOCKS,
  // else 32
  p.BM = 32;
  for (int bm = M <= 32 ? 32 : M <= 64 ? 64 : 128; bm >= 32; bm /= 2)
    if ((double)ceil_div(M, bm) * ceil_div(N, FM_BN) * s_max >= 0.4 * TARGET_BLOCKS) {
      p.BM = bm;
      break;
    }
  p.tiles_m = ceil_div(M, p.BM);
  p.tiles_n = ceil_div(N, FM_BN);
  const int tiles = p.tiles_m * p.tiles_n;
  // S: the fewest splits whose grid fills its waves of TARGET_BLOCKS blocks
  // to 0.8 or more on average; if none does, the one that fills them best
  int S = 1;
  double best = 0.0;
  for (int s = 1; s <= s_max; ++s) {
    const double fill = (double)tiles * s / ((double)ceil_div(tiles * s, TARGET_BLOCKS) * TARGET_BLOCKS);
    if (fill > best + 1e-9) S = s, best = fill;
    if (fill >= 0.8) break;
  }
  p.kts = ceil_div(kt, S);
  p.S = ceil_div(kt, p.kts);
  // 8 x 16 sums a thread (128 threads) read 3 floats of shared memory per
  // 16 FMAs, 8 x 8 or 4 x 8 (256 threads) 4 or 6: the card's 128 FMAs and
  // 32 floats of shared memory a clock make the first FMA-bound. But the
  // short blocks of a split tile of 64 or 128 rows run faster with twice
  // the warps to hide their latencies (measured on an H100: PERF.md).
  p.threads = p.BM >= 64 && p.S > 1 ? 256 : 128;
  return p;
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime's entry-point query (no -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A 2-D tensor map: `inner` x `outer` elements from `base`, rows
// `row_bytes` apart, boxes of box_inner x box_outer, with the 128-byte
// swizzle (sw) or none. bf16 maps take the swizzle wgmma reads; f32 maps
// none (the decode kernel reads its tiles row by row), except the prefill
// kernel's K-contiguous tiles (x's, col_t's weight), whose 128-byte rows it
// reads one k at a time across rows.
bool encode(CUtensorMap* map, bool f32, bool sw, const void* base, uint64_t inner, uint64_t outer, uint64_t row_bytes,
            uint32_t box_inner, uint32_t box_outer) {
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {inner, outer}, strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_inner, box_outer}, elem[2] = {1, 1};
  return fn(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
            const_cast<void*>(base), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            sw ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The weight's map, encoded once per (base, shard shape, row length,
// layout, dtype, swizzle): the weights of a WeightStore keep their
// pointers, so the engine's calls find it here. bf16 (K, N) rows: boxes of
// 64 columns x 64 K rows; col_t's (N, K) rows: 64 K x 64 weight rows. f32:
// 128 columns x 32 K rows; col_t: 32 K x 128 weight rows, unswizzled for
// the decode kernel, swizzled (sw) for the prefill kernel.
struct MapKey {
  uintptr_t base;
  int N, K;
  int64_t ldw;
  bool trans, f32, sw;
  bool operator==(const MapKey& o) const {
    return base == o.base && N == o.N && K == o.K && ldw == o.ldw && trans == o.trans && f32 == o.f32 && sw == o.sw;
  }
};
struct MapKeyHash {
  size_t operator()(const MapKey& k) const {
    return std::hash<uintptr_t>()(k.base) ^
           (std::hash<int64_t>()(k.ldw) * 31 + k.N * 131 + k.K + k.trans + 2 * k.f32 + 4 * k.sw);
  }
};

bool weight_map(CUtensorMap* map, const void* w, int N, int K, int64_t ldw, bool trans, bool f32, bool sw = false) {
  static std::mutex mu;
  static std::unordered_map<MapKey, CUtensorMap, MapKeyHash> cache;
  const MapKey key{reinterpret_cast<uintptr_t>(w), N, K, ldw, trans, f32, sw};
  std::lock_guard<std::mutex> lock(mu);
  auto it = cache.find(key);
  if (it != cache.end()) {
    *map = it->second;
    return true;
  }
  const bool ok = f32 ? (trans ? encode(map, true, sw, w, K, N, ldw * 4, SK_BK, SK_BN)
                               : encode(map, true, false, w, N, K, ldw * 4, SK_BN, SK_BK))
                      : (trans ? encode(map, false, true, w, K, N, ldw * 2, 64, 64)
                               : encode(map, false, true, w, N, K, ldw * 2, 64, WG_BK));
  if (!ok) return false;
  if (cache.size() >= (1u << 16)) cache.clear();
  cache.emplace(key, *map);
  return true;
}

template <int NT, typename O, int TA>
cudaError_t launch_wgmma(const WgPlan& p, const CUtensorMap& wmap, const CUtensorMap& xmap, const WgArgs& a,
                         cudaStream_t s) {
  static const cudaError_t attr =
      cudaFuncSetAttribute(wgmma_mm<NT, O, TA>, cudaFuncAttributeMaxDynamicSharedMemorySize, Ring<NT>::SMEM);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(p.tiles_n, p.S, p.tiles_m);
  wgmma_mm<NT, O, TA><<<grid, WG_THREADS, Ring<NT>::SMEM, s>>>(wmap, xmap, a);
  return cudaGetLastError();
}

template <typename O, int TA>
cudaError_t launch_wgmma(const WgPlan& p, const CUtensorMap& wmap, const CUtensorMap& xmap, const WgArgs& a,
                         cudaStream_t s) {
  switch (p.NT) {
    case 8: return launch_wgmma<8, O, TA>(p, wmap, xmap, a, s);
    case 16: return launch_wgmma<16, O, TA>(p, wmap, xmap, a, s);
    case 32: return launch_wgmma<32, O, TA>(p, wmap, xmap, a, s);
    case 64: return launch_wgmma<64, O, TA>(p, wmap, xmap, a, s);
    default: return launch_wgmma<128, O, TA>(p, wmap, xmap, a, s);
  }
}

int run_bf16(const void* x, const void* w, void* y, float* ws, int* counters, int M, int N, int K, int64_t ldw,
             bool out_f32, bool trans, cudaStream_t s) {
  if (trans && !out_f32) return static_cast<int>(cudaErrorInvalidValue);  // col_t: f32 logits only
  const WgPlan p = plan_bf16(M, N, K);
  WgArgs a{static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(w), y, ws, counters, M, N, K, ldw,
           p.S, p.kts, 0};
  // TMA takes 16-byte-aligned bases and row strides; else the producer warp loads the tiles itself
  a.tma = reinterpret_cast<uintptr_t>(w) % 16 == 0 && (ldw * 2) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(x) % 16 == 0 && (static_cast<int64_t>(K) * 2) % 16 == 0;
  CUtensorMap wmap{}, xmap{};
  if (a.tma && !(weight_map(&wmap, w, N, K, ldw, trans, false) &&
                 encode(&xmap, false, true, x, K, M, (uint64_t)K * 2, 64, p.NT)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (trans) return static_cast<int>(launch_wgmma<float, 0>(p, wmap, xmap, a, s));
  return static_cast<int>(out_f32 ? launch_wgmma<float, 1>(p, wmap, xmap, a, s)
                                  : launch_wgmma<__nv_bfloat16, 1>(p, wmap, xmap, a, s));
}

template <int TA>
cudaError_t launch_skinny(const SkPlan& p, const CUtensorMap& wmap, const CUtensorMap& xmap, const SkArgs& a,
                          cudaStream_t s) {
  static const cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(skinny_mm<TA>, cudaFuncAttributeMaxDynamicSharedMemorySize, SK_SMEM);
    if (e == cudaSuccess)  // room for two blocks per SM
      e = cudaFuncSetAttribute(skinny_mm<TA>, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    return e;
  }();
  if (attr != cudaSuccess) return attr;
  skinny_mm<TA><<<dim3(p.tiles, p.S), SK_THREADS, SK_SMEM, s>>>(wmap, xmap, a);
  return cudaGetLastError();
}

template <int BM, int TA, int THREADS>
cudaError_t launch_fma(const FmPlan& p, const CUtensorMap& wmap, const CUtensorMap& xmap, const FmArgs& a,
                       cudaStream_t s) {
  static const cudaError_t attr = [] {
    cudaError_t e =
        cudaFuncSetAttribute(fma_mm<BM, TA, THREADS>, cudaFuncAttributeMaxDynamicSharedMemorySize, Fm<BM>::SMEM);
    if (e == cudaSuccess)  // room for two blocks per SM
      e = cudaFuncSetAttribute(fma_mm<BM, TA, THREADS>, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    return e;
  }();
  if (attr != cudaSuccess) return attr;
  fma_mm<BM, TA, THREADS><<<dim3(p.tiles_m, p.tiles_n, p.S), THREADS, Fm<BM>::SMEM, s>>>(wmap, xmap, a);
  return cudaGetLastError();
}

template <int TA>
cudaError_t launch_fma(const FmPlan& p, const CUtensorMap& wmap, const CUtensorMap& xmap, const FmArgs& a,
                       cudaStream_t s) {
  if (p.threads == 256) return p.BM == 64 ? launch_fma<64, TA, 256>(p, wmap, xmap, a, s)
                                          : launch_fma<128, TA, 256>(p, wmap, xmap, a, s);
  switch (p.BM) {
    case 32: return launch_fma<32, TA, 128>(p, wmap, xmap, a, s);
    case 64: return launch_fma<64, TA, 128>(p, wmap, xmap, a, s);
    default: return launch_fma<128, TA, 128>(p, wmap, xmap, a, s);
  }
}

int run_f32(const float* x, const float* w, float* y, float* ws, int* counters, int M, int N, int K, int64_t ldw,
            bool trans, cudaStream_t s) {
  CUtensorMap wmap{}, xmap{};
  // TMA takes 16-byte-aligned bases and row strides; else the kernels copy 4 bytes at a time with cp.async
  const bool tma = reinterpret_cast<uintptr_t>(w) % 16 == 0 && (ldw * 4) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 && (static_cast<int64_t>(K) * 4) % 16 == 0;
  if (M > SK_M) {
    const FmPlan p = plan_fma(M, N, K);
    const FmArgs a{x, w, y, ws, counters, M, N, K, ldw, p.S, p.kts, tma};
    if (tma && !(weight_map(&wmap, w, N, K, ldw, trans, true, trans) &&
                 encode(&xmap, true, true, x, K, M, (uint64_t)K * 4, FM_BK, p.BM)))
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(trans ? launch_fma<0>(p, wmap, xmap, a, s) : launch_fma<1>(p, wmap, xmap, a, s));
  }
  const SkPlan p = plan_skinny(N, K);
  const SkArgs a{x, w, y, ws, counters, M, N, K, ldw, p.S, p.kts, tma};
  if (tma && !(weight_map(&wmap, w, N, K, ldw, trans, true) &&
               encode(&xmap, true, false, x, K, M, (uint64_t)K * 4, SK_BK, SK_M)))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(trans ? launch_skinny<0>(p, wmap, xmap, a, s) : launch_skinny<1>(p, wmap, xmap, a, s));
}

// Scratch a call needs: f32 partial sums (bytes) and arrival counters (ints).
void scratch_need(int M, int N, int K, int dtype, long long* ws_bytes, long long* n_counters) {
  *ws_bytes = *n_counters = 0;
  if (dtype == 0 && M > SK_M) {
    const FmPlan p = plan_fma(M, N, K);
    if (p.S > 1) {
      *n_counters = (long long)p.tiles_m * p.tiles_n;
      *ws_bytes = *n_counters * p.S * p.BM * FM_BN * (long long)sizeof(float);
    }
  } else if (dtype == 0) {
    const SkPlan p = plan_skinny(N, K);
    if (p.S > 1) {
      *n_counters = p.tiles;
      *ws_bytes = (long long)p.tiles * p.S * SK_TILE * sizeof(float);
    }
  } else {
    const WgPlan p = plan_bf16(M, N, K);
    if (p.S > 1) {
      *n_counters = (long long)p.tiles_n * p.tiles_m;
      *ws_bytes = *n_counters * p.S * p.NT * WG_BN * (long long)sizeof(float);
    }
  }
}

constexpr int SCRATCH_TOO_SMALL = -1;

}  // namespace

// trans (col_t) is taken for the caller's sake: no plan depends on it.
extern "C" void tp_shard_matmul_scratch(int M, int N, int K, int dtype, int trans, long long* ws_bytes,
                                        long long* n_counters) {
  scratch_need(M, N, K, dtype, ws_bytes, n_counters);
}

// dtype: 0 = float32, 1 = bfloat16 (x and w). out_f32: write f32 whatever
// the input type (the LM head's f32 logits). trans: 1 for col_t (w holds
// N rows of K, at ldw), which in bf16 needs out_f32. ws / counters: the
// caller's scratch, of ws_bytes bytes and n_counters zeroed ints; -1
// (launching nothing) when that is less than tp_shard_matmul_scratch asks
// for. Else returns cudaGetLastError().
extern "C" int tp_shard_matmul(const void* x, const void* w, void* y, void* ws, long long ws_bytes, void* counters,
                               long long n_counters, int M, int N, int K, long long ldw, int dtype, int out_f32,
                               int trans, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K <= 0 || dtype < 0 || dtype > 1 || trans < 0 || trans > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  long long need_ws, need_counters;
  scratch_need(M, N, K, dtype, &need_ws, &need_counters);
  if (ws_bytes < need_ws || n_counters < need_counters) return SCRATCH_TOO_SMALL;
  if (dtype == 0)
    return run_f32(static_cast<const float*>(x), static_cast<const float*>(w), static_cast<float*>(y),
                   static_cast<float*>(ws), static_cast<int*>(counters), M, N, K, ldw, trans != 0, s);
  return run_bf16(x, w, y, static_cast<float*>(ws), static_cast<int*>(counters), M, N, K, ldw, out_f32 != 0,
                  trans != 0, s);
}

extern "C" const char* error_string(int e) {
  if (e == SCRATCH_TOO_SMALL) return "scratch smaller than tp_shard_matmul_scratch asks for";
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
