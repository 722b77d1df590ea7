// Kernel 2: prefix_sum — inclusive int32 scan along the last dimension.
//
// Replaces emqx_tpu/ops/pallas_scan.py prefix_sum_pallas (kernel body
// _scan_kernel), which scanned 1024-element blocks with lower-triangular
// float32 matmuls on the MXU and carried the running total in SMEM across
// a sequential grid. Here the arithmetic is integer: sums are taken in
// uint32, so the result equals torch.cumsum's int32 result on every input,
// wraparound included (addition modulo 2^32 is associative).
//
// Input [R, n] int32 row-major (a 1D input is R = 1). Every call is ONE
// kernel launch; ops/scan.py picks the kernel, the elements per thread,
// the tile count and the grid (scan_plan) and passes them in:
//
//   n == 1      ps_copy: the scan of a length-1 row is the row; one int4
//               (or four scalars) per thread.
//   n <= 32     ps_short: a block stages 256 consecutive rows in shared
//               memory with coalesced 16-byte loads, one thread scans one
//               row there (index e + e/32: no bank conflicts for the
//               power-of-two widths), and the block writes back coalesced.
//   n <= 1024   ps_mid: one warp per row; each lane loads ITEMS = 2 or 4
//               consecutive elements (int2 / int4), scans them serially,
//               then one warp shuffle scan. A 64-wide row is one step; for
//               ITEMS = 2 a warp holds two rows' loads in flight at once.
//   n > 1024    ps_long: a single-pass chained scan with decoupled
//               look-back (Merrill & Garland, "Single-pass Parallel Prefix
//               Scan with Decoupled Look-back", NVIDIA 2016). A block of 256
//               threads owns one tile of 256 x ITEMS elements (1024, 2048
//               or 4096), reads it once with int4 loads, scans it in
//               registers and shuffles, publishes its aggregate, and its
//               first warp looks back over the status words of its row's
//               earlier tiles, 32 at a time, until it meets an inclusive
//               prefix. Rows that fit one tile skip the status words.
//
// Status words: 64 bits each, {value:32 | epoch:30 | flag:2}, flag 1 =
// aggregate, 2 = inclusive prefix, one word per (row, tile) so several
// rows scan side by side in one grid, each word in its own 32-byte sector
// (a tile's polls then do not queue behind its neighbours' stores). They
// live in a persistent buffer per (device, stream) that ops/scan.py owns;
// each call carries a new epoch, and a word from another epoch reads as
// "not ready", so no memset runs per call (the buffer is zeroed when
// allocated, grown, or when the epoch wraps).
//
// Memory order: a status word is written and read whole, as one
// single-copy-atomic 64-bit access at GPU scope (st/ld.relaxed.gpu). The
// value rides in the same word as its flag, so a reader that sees the
// flag of this epoch sees the value stored with it; no other memory is
// published through a flag (a tile's output is read by no other block),
// so there is nothing for release/acquire to order. On the H100, st.release
// puts a MEMBAR.GPU and ld.acquire an L1 invalidation on the look-back
// chain, and the release measurably lengthened every call.
//
// Tile order: blockIdx. A look-back waits only on lower-numbered blocks of
// the same grid, which the hardware dispatches before higher ones (the
// property CUB's single-pass scan, and so torch.cumsum, rests on). A
// ticket counter (one atomicAdd per block) makes that hold by
// construction, but it added an L2 round trip to every tile's chain and
// was measurably slower; if a predecessor ever failed to publish, the
// bounded spin below traps instead of hanging the card.
//
// Bound: memory — the function must read and write 4 B per element once:
// 8 MB for the compaction's [8, 131072] offsets (2.5 us at 3.35 TB/s),
// 2 MB for the [262144] rank scan (0.63 us). At those sizes the launch and
// the look-back chain's L2 round trips, not the bytes, set the time, hence
// one launch, one read, and the smallest tiles that keep the grid within a
// few waves (ops/scan.py). Launches on the caller's stream, allocates
// nothing, does not synchronise; returns cudaGetLastError().

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

using u32 = unsigned;
using u64 = unsigned long long;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr u32 FULL = 0xFFFFFFFFu;
constexpr u32 FLAG_AGG = 1;
constexpr u32 FLAG_PREFIX = 2;
// polls of one look-back window before the kernel gives up: seconds, where
// a real wait lasts microseconds
constexpr u32 SPIN_LIMIT = 1u << 24;
// 64-bit words per status word: each in its own 32-byte sector, so the
// polls of one tile do not queue behind the stores to its neighbours
constexpr int STRIDE = 4;

// Status words are single-copy-atomic 64-bit accesses at GPU scope. The
// value travels in the same word as its flag and nothing else is
// published through it, so relaxed order suffices: see the header.
__device__ __forceinline__ void st_status(u64* p, u64 v) {
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ u64 ld_status(const u64* p) {
  u64 v;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ u64 pack(u32 value, u32 tag) {
  return (u64(value) << 32) | tag;
}

// ITEMS consecutive elements p[i..i+ITEMS) of a row of n; zeros past n.
// VEC: the row start is aligned to ITEMS * 4 bytes (16 for ITEMS >= 4).
template <int ITEMS, bool VEC>
__device__ __forceinline__ void load_items(const int32_t* p, int i, int n,
                                           u32 (&v)[ITEMS]) {
  if (VEC && i + ITEMS <= n) {
    if constexpr (ITEMS == 2) {
      const int2 a = __ldg(reinterpret_cast<const int2*>(p + i));
      v[0] = a.x;
      v[1] = a.y;
    } else {
#pragma unroll
      for (int k = 0; k < ITEMS / 4; ++k) {
        const int4 a = __ldg(reinterpret_cast<const int4*>(p + i) + k);
        v[4 * k] = a.x;
        v[4 * k + 1] = a.y;
        v[4 * k + 2] = a.z;
        v[4 * k + 3] = a.w;
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < ITEMS; ++k)
      v[k] = i + k < n ? u32(__ldg(p + i + k)) : 0u;
  }
}

template <int ITEMS, bool VEC>
__device__ __forceinline__ void store_items(int32_t* p, int i, int n,
                                            const u32 (&v)[ITEMS]) {
  if (VEC && i + ITEMS <= n) {
    if constexpr (ITEMS == 2) {
      *reinterpret_cast<int2*>(p + i) = make_int2(v[0], v[1]);
    } else {
#pragma unroll
      for (int k = 0; k < ITEMS / 4; ++k)
        reinterpret_cast<int4*>(p + i)[k] =
            make_int4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < ITEMS; ++k)
      if (i + k < n) p[i + k] = int(v[k]);
  }
}

__device__ __forceinline__ u32 warp_inclusive(u32 s, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const u32 t = __shfl_up_sync(FULL, s, off);
    if (lane >= off) s += t;
  }
  return s;
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS) ps_copy(
    const int32_t* __restrict__ x, int32_t* __restrict__ y, int R) {
  const size_t i = (size_t(blockIdx.x) * THREADS + threadIdx.x) * 4;
  if (VEC && i + 4 <= size_t(R)) {
    reinterpret_cast<int4*>(y)[i / 4] =
        __ldg(reinterpret_cast<const int4*>(x) + i / 4);
    return;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (i + k < size_t(R)) y[i + k] = __ldg(x + i + k);
}

__device__ __forceinline__ int pad(int e) { return e + (e >> 5); }

// Shared memory for ps_short at width n: 256 rows of n, one pad word per 32.
__host__ __device__ constexpr int short_smem_words(int n) {
  return THREADS * n + THREADS * n / 32 + 1;
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS) ps_short(
    const int32_t* __restrict__ x, int32_t* __restrict__ y, int R, int n) {
  extern __shared__ u32 sm[];
  const int r0 = blockIdx.x * THREADS;
  const int rows = min(THREADS, R - r0);
  const int count = rows * n;
  // the block's first element sits 1024 * n bytes past the previous one's:
  // 16-byte aligned whenever the bases are
  const int32_t* xb = x + size_t(r0) * n;
  int32_t* yb = y + size_t(r0) * n;
  const int nv = VEC ? count >> 2 : 0;
  for (int q = threadIdx.x; q < nv; q += THREADS) {
    const int4 a = __ldg(reinterpret_cast<const int4*>(xb) + q);
    const int e = q << 2;
    sm[pad(e)] = a.x;
    sm[pad(e + 1)] = a.y;
    sm[pad(e + 2)] = a.z;
    sm[pad(e + 3)] = a.w;
  }
  for (int e = (nv << 2) + threadIdx.x; e < count; e += THREADS)
    sm[pad(e)] = __ldg(xb + e);
  __syncthreads();
  if (threadIdx.x < rows) {
    const int e0 = threadIdx.x * n;
    u32 run = 0;
    for (int i = 0; i < n; ++i) {
      const int p = pad(e0 + i);
      run += sm[p];
      sm[p] = run;
    }
  }
  __syncthreads();
  for (int q = threadIdx.x; q < nv; q += THREADS) {
    const int e = q << 2;
    reinterpret_cast<int4*>(yb)[q] = make_int4(
        sm[pad(e)], sm[pad(e + 1)], sm[pad(e + 2)], sm[pad(e + 3)]);
  }
  for (int e = (nv << 2) + threadIdx.x; e < count; e += THREADS)
    yb[e] = int(sm[pad(e)]);
}

// RPW rows per warp, their loads issued together; a row of n takes
// ceil(n / (32 * ITEMS)) steps with the running total carried.
template <int ITEMS, bool VEC, int RPW>
__global__ void __launch_bounds__(THREADS) ps_mid(
    const int32_t* __restrict__ x, int32_t* __restrict__ y, int R, int n) {
  const int lane = threadIdx.x & 31;
  // every lane of a warp shares r0, so a warp past the last row leaves as
  // a whole and the shuffles below see full warps
  const int r0 = (blockIdx.x * WARPS + (threadIdx.x >> 5)) * RPW;
  if (r0 >= R) return;
  u32 carry[RPW];
#pragma unroll
  for (int q = 0; q < RPW; ++q) carry[q] = 0;
  for (int i0 = 0; i0 < n; i0 += 32 * ITEMS) {
    const int i = i0 + lane * ITEMS;
    u32 v[RPW][ITEMS];
#pragma unroll
    for (int q = 0; q < RPW; ++q) {
      if (r0 + q < R) {
        load_items<ITEMS, VEC>(x + size_t(r0 + q) * n, i, n, v[q]);
      } else {
#pragma unroll
        for (int k = 0; k < ITEMS; ++k) v[q][k] = 0;
      }
    }
#pragma unroll
    for (int q = 0; q < RPW; ++q) {
#pragma unroll
      for (int k = 1; k < ITEMS; ++k) v[q][k] += v[q][k - 1];
      const u32 s = warp_inclusive(v[q][ITEMS - 1], lane);
      const u32 excl = s - v[q][ITEMS - 1] + carry[q];
#pragma unroll
      for (int k = 0; k < ITEMS; ++k) v[q][k] += excl;
      if (r0 + q < R) store_items<ITEMS, VEC>(y + size_t(r0 + q) * n, i, n,
                                              v[q]);
      carry[q] += __shfl_sync(FULL, s, 31);
    }
  }
}

template <int ITEMS, bool VEC>
__global__ void __launch_bounds__(THREADS) ps_long(
    const int32_t* __restrict__ x, int32_t* __restrict__ y,
    u64* __restrict__ state, int n, int tiles, u32 epoch) {
  constexpr int TILE = THREADS * ITEMS;
  __shared__ u32 warp_incl[WARPS];
  __shared__ u32 s_prefix;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = int(blockIdx.x / u32(tiles));
  const int t = int(blockIdx.x - u32(row) * u32(tiles));
  const int i0 = t * TILE + threadIdx.x * ITEMS;
  u32 v[ITEMS];
  load_items<ITEMS, VEC>(x + size_t(row) * n, i0, n, v);
#pragma unroll
  for (int k = 1; k < ITEMS; ++k) v[k] += v[k - 1];
  const u32 s = warp_inclusive(v[ITEMS - 1], lane);
  if (lane == 31) warp_incl[warp] = s;
  __syncthreads();
  if (warp == 0) {
    u32 w = lane < WARPS ? warp_incl[lane] : 0u;
#pragma unroll
    for (int off = 1; off < WARPS; off <<= 1) {
      const u32 o = __shfl_up_sync(FULL, w, off);
      if (lane >= off) w += o;
    }
    if (lane < WARPS) warp_incl[lane] = w;
    const u32 agg = __shfl_sync(FULL, w, WARPS - 1);
    u32 prefix = 0;
    if (tiles > 1) {
      u64* words = state + size_t(row) * tiles * STRIDE;
      const u32 tag = epoch << 2;
      if (t == 0) {
        if (lane == 0) st_status(words, pack(agg, tag | FLAG_PREFIX));
      } else {
        if (lane == 0) st_status(words + t * STRIDE, pack(agg, tag | FLAG_AGG));
        // lane l reads tile j - l; before the row's start a lane reads a
        // zero inclusive prefix
        u32 spins = 0;
        for (int j = t - 1;; j -= 32) {
          const int k = j - lane;
          u64 word;
          u32 pm, need;
          for (;;) {
            word = k >= 0 ? ld_status(words + k * STRIDE)
                          : pack(0, tag | FLAG_PREFIX);
            const u32 flag =
                (u32(word) & ~3u) == tag ? (u32(word) & 3u) : 0u;
            // the lanes up to and including the nearest inclusive prefix
            pm = __ballot_sync(FULL, flag == FLAG_PREFIX);
            need = pm ? ((pm & (0u - pm)) << 1) - 1u : FULL;
            if (!(__ballot_sync(FULL, flag == 0) & need)) break;
            // a predecessor that never publishes is a broken launch plan:
            // fault (the caller's next synchronise reports it), never hang
            if (++spins > SPIN_LIMIT) __trap();
          }
          prefix += __reduce_add_sync(
              FULL, (need >> lane) & 1u ? u32(word >> 32) : 0u);
          if (pm) break;
        }
        if (lane == 0)
          st_status(words + t * STRIDE, pack(prefix + agg, tag | FLAG_PREFIX));
      }
    }
    if (lane == 0) s_prefix = prefix;
  }
  __syncthreads();
  const u32 excl = s - v[ITEMS - 1] + (warp > 0 ? warp_incl[warp - 1] : 0u)
                   + s_prefix;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) v[k] += excl;
  store_items<ITEMS, VEC>(y + size_t(row) * n, i0, n, v);
}

__global__ void ps_empty() {}

template <int ITEMS>
cudaError_t launch_long(const int32_t* x, int32_t* y, u64* state, int n,
                        int vec, int grid, int tiles, u32 epoch,
                        cudaStream_t s) {
  if (vec)
    ps_long<ITEMS, true><<<grid, THREADS, 0, s>>>(x, y, state, n, tiles,
                                                  epoch);
  else
    ps_long<ITEMS, false><<<grid, THREADS, 0, s>>>(x, y, state, n, tiles,
                                                   epoch);
  return cudaGetLastError();
}

template <int ITEMS, int RPW>
cudaError_t launch_mid(const int32_t* x, int32_t* y, int R, int n, int vec,
                       int grid, cudaStream_t s) {
  if (vec)
    ps_mid<ITEMS, true, RPW><<<grid, THREADS, 0, s>>>(x, y, R, n);
  else
    ps_mid<ITEMS, false, RPW><<<grid, THREADS, 0, s>>>(x, y, R, n);
  return cudaGetLastError();
}

}  // namespace

// One launch. path 0 copy (n == 1), 1 short (n <= 32), 2 mid (n <= 1024,
// items 2 with two rows per warp, or items 4 with one), 3 long (items 4,
// 8 or 16; `tiles` per row; `state` holds STRIDE * R * tiles words when
// tiles > 1, else may be null). `vec`: x and y are 16-byte aligned and
// every row start the path loads vectors from is too (ops/scan.py decides).
extern "C" int prefix_sum_launch(const void* xv, void* yv, void* statev,
                                 int R, int n, int path, int items, int vec,
                                 int grid, int tiles, unsigned epoch,
                                 void* stream) {
  if (R <= 0 || n <= 0 || grid <= 0) return 0;
  const int32_t* x = static_cast<const int32_t*>(xv);
  int32_t* y = static_cast<int32_t*>(yv);
  u64* state = static_cast<u64*>(statev);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (path) {
    case 0:
      if (n != 1) break;
      if (vec)
        ps_copy<true><<<grid, THREADS, 0, s>>>(x, y, R);
      else
        ps_copy<false><<<grid, THREADS, 0, s>>>(x, y, R);
      return static_cast<int>(cudaGetLastError());
    case 1: {
      if (n > 32) break;
      const size_t smem = size_t(short_smem_words(n)) * 4;
      if (vec)
        ps_short<true><<<grid, THREADS, smem, s>>>(x, y, R, n);
      else
        ps_short<false><<<grid, THREADS, smem, s>>>(x, y, R, n);
      return static_cast<int>(cudaGetLastError());
    }
    case 2:
      if (items == 2) return launch_mid<2, 2>(x, y, R, n, vec, grid, s);
      if (items == 4) return launch_mid<4, 1>(x, y, R, n, vec, grid, s);
      break;
    case 3:
      // every (row, tile) has its block
      if (tiles < 1 || size_t(grid) != size_t(R) * size_t(tiles) ||
          size_t(tiles) * size_t(THREADS) * size_t(items) < size_t(n) ||
          (tiles > 1 &&
           (state == nullptr || epoch == 0 || epoch >= (1u << 30))))
        break;
      if (items == 4)
        return launch_long<4>(x, y, state, n, vec, grid, tiles, epoch, s);
      if (items == 8)
        return launch_long<8>(x, y, state, n, vec, grid, tiles, epoch, s);
      if (items == 16)
        return launch_long<16>(x, y, state, n, vec, grid, tiles, epoch, s);
      break;
    default:
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// An empty kernel at the same grid: the launch floor a scan is timed
// against (chip_smoke.py), never its bound.
extern "C" int prefix_sum_empty_launch(int grid, void* stream) {
  if (grid <= 0) return 0;
  ps_empty<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
