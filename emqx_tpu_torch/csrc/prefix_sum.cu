// Kernel 2: prefix_sum — inclusive int32 scan along the last dimension.
//
// Replaces emqx_tpu/ops/pallas_scan.py prefix_sum_pallas (kernel body
// _scan_kernel), which scanned 1024-element blocks with lower-triangular
// float32 matmuls on the MXU and carried the running total in SMEM across
// a sequential grid. Here the arithmetic is integer, so no float trick is
// needed and the result equals the reference on every input whose total
// stays below 2^24 (the reference's exactness bound, kept by the wrapper).
//
// Input [R, n] int32 row-major (a 1D input is R = 1). Rows of at most
// SHORT = 32 elements (the route window's [W*B, NSc] match-width scans,
// a million rows of length 1 at the bench shape; the trie NFA's [B, 2w]
// emission and frontier scans) take one thread per row, a serial scan.
// Rows of at most MID = 1024 (the mesh path's [B, 64] fan-out segment
// scans) take one warp per row: 32 elements per step, __shfl_up_sync
// within the warp, the running total carried in a register. Longer rows:
// blocks run in no order, so the TPU's carried total becomes two passes
// over tiles of TILE = 4096 elements (1024 threads x 4):
//   1. tile_sums: one block per (row, tile) writes the tile's sum
//      (skipped when a row is a single tile);
//   2. scan_tiles: one block per (row, tile) adds up the sums of the
//      row's earlier tiles, scans its tile (thread-serial over 4 items,
//      __shfl_up_sync within each warp, then across the 32 warp totals)
//      and writes the tile.
//
// Bound: memory — the function must read and write 4 B per element once
// (8 MB for the [8, 131072] compact offsets, ~2.5 us at 3.35 TB/s; 8 MB
// for a [2^20, 1] short-row scan). Pass 1
// reads the input a second time (its tiles mostly stay in L2 at these
// sizes); a single-pass decoupled look-back scan would remove that read
// and is left for later.
//
// Launches on the caller's stream, allocates nothing (the tile-sum scratch
// comes from the wrapper), does not synchronise; returns cudaGetLastError().

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int SHORT = 32;
constexpr int SHORT_THREADS = 256;
constexpr int MID = 1024;
constexpr int MID_THREADS = 256;  // 8 rows (warps) per block
constexpr int THREADS = 1024;
constexpr int ITEMS = 4;
constexpr int TILE = THREADS * ITEMS;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xFFFFFFFFu;

// Inclusive scan of one value per thread across the block; `total` gets
// the block's sum. `warp_sums` is WARPS ints of shared memory.
__device__ __forceinline__ int block_scan(int v, int* warp_sums, int& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int n = __shfl_up_sync(FULL, v, off);
    if (lane >= off) v += n;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int s = warp_sums[lane];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int n = __shfl_up_sync(FULL, s, off);
      if (lane >= off) s += n;
    }
    warp_sums[lane] = s;
  }
  __syncthreads();
  if (warp > 0) v += warp_sums[warp - 1];
  total = warp_sums[WARPS - 1];
  return v;
}

__device__ __forceinline__ int block_sum(int v, int* warp_sums) {
  int total;
  block_scan(v, warp_sums, total);
  return total;
}

__global__ void __launch_bounds__(THREADS) tile_sums(
    const int32_t* __restrict__ x, int32_t* __restrict__ sums, int n,
    int tiles) {
  __shared__ int warp_sums[WARPS];
  const int row = blockIdx.x / tiles;
  const int t = blockIdx.x % tiles;
  const int32_t* xr = x + size_t(row) * n;
  const int i0 = t * TILE + threadIdx.x * ITEMS;
  int v = 0;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k)
    if (i0 + k < n) v += __ldg(xr + i0 + k);
  const int total = block_sum(v, warp_sums);
  if (threadIdx.x == 0) sums[blockIdx.x] = total;
}

__global__ void __launch_bounds__(THREADS) scan_tiles(
    const int32_t* __restrict__ x, const int32_t* __restrict__ sums,
    int32_t* __restrict__ y, int n, int tiles) {
  __shared__ int warp_sums[WARPS];
  const int row = blockIdx.x / tiles;
  const int t = blockIdx.x % tiles;
  // offset of this tile: the sum of the row's earlier tiles
  int part = 0;
  for (int j = threadIdx.x; j < t; j += THREADS)
    part += sums[size_t(row) * tiles + j];
  const int offset = t > 0 ? block_sum(part, warp_sums) : 0;
  __syncthreads();  // warp_sums is reused below

  const int32_t* xr = x + size_t(row) * n;
  int32_t* yr = y + size_t(row) * n;
  const int i0 = t * TILE + threadIdx.x * ITEMS;
  int item[ITEMS];
  int run = 0;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    run += i0 + k < n ? __ldg(xr + i0 + k) : 0;
    item[k] = run;
  }
  int total;
  const int excl = block_scan(run, warp_sums, total) - run + offset;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k)
    if (i0 + k < n) yr[i0 + k] = item[k] + excl;
}

__global__ void __launch_bounds__(SHORT_THREADS) scan_short_rows(
    const int32_t* __restrict__ x, int32_t* __restrict__ y, int R, int n) {
  const int r = blockIdx.x * SHORT_THREADS + threadIdx.x;
  if (r >= R) return;
  const int32_t* xr = x + size_t(r) * n;
  int32_t* yr = y + size_t(r) * n;
  int run = 0;
  for (int i = 0; i < n; ++i) {
    run += __ldg(xr + i);
    yr[i] = run;
  }
}

__global__ void __launch_bounds__(MID_THREADS) scan_mid_rows(
    const int32_t* __restrict__ x, int32_t* __restrict__ y, int R, int n) {
  const int lane = threadIdx.x & 31;
  // one row per warp: every lane of a warp shares r, so a warp past the
  // last row leaves as a whole and the shuffles below see full warps
  const int r = blockIdx.x * (MID_THREADS / 32) + (threadIdx.x >> 5);
  if (r >= R) return;
  const int32_t* xr = x + size_t(r) * n;
  int32_t* yr = y + size_t(r) * n;
  int carry = 0;
  for (int i0 = 0; i0 < n; i0 += 32) {
    const int i = i0 + lane;
    int v = i < n ? __ldg(xr + i) : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(FULL, v, off);
      if (lane >= off) v += t;
    }
    v += carry;
    if (i < n) yr[i] = v;
    carry = __shfl_sync(FULL, v, 31);
  }
}

}  // namespace

// x, y: [R, n] int32; scratch: R * ceil(n / 4096) int32 (unused when a row
// is a single tile or short).
extern "C" int prefix_sum_launch(const void* x, void* y, void* scratch, int R,
                                 int n, void* stream) {
  if (R <= 0 || n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= SHORT) {
    scan_short_rows<<<(R + SHORT_THREADS - 1) / SHORT_THREADS, SHORT_THREADS,
                      0, s>>>(static_cast<const int32_t*>(x),
                              static_cast<int32_t*>(y), R, n);
    return static_cast<int>(cudaGetLastError());
  }
  if (n <= MID) {
    const int rows_per_block = MID_THREADS / 32;
    scan_mid_rows<<<(R + rows_per_block - 1) / rows_per_block, MID_THREADS,
                    0, s>>>(static_cast<const int32_t*>(x),
                            static_cast<int32_t*>(y), R, n);
    return static_cast<int>(cudaGetLastError());
  }
  const int tiles = (n + TILE - 1) / TILE;
  const int grid = R * tiles;
  if (tiles > 1)
    tile_sums<<<grid, THREADS, 0, s>>>(static_cast<const int32_t*>(x),
                                       static_cast<int32_t*>(scratch), n,
                                       tiles);
  scan_tiles<<<grid, THREADS, 0, s>>>(
      static_cast<const int32_t*>(x), static_cast<const int32_t*>(scratch),
      static_cast<int32_t*>(y), n, tiles);
  return static_cast<int>(cudaGetLastError());
}
