// Kernel 3: ring_rotate — one round of the exchange's route-ring rotation.
//
// Replaces emqx_tpu/ops/pallas_exchange.py:67-106 (_rotate_pallas, reached
// through ring_rotate(impl="pallas")): there, every device started one
// remote DMA of its whole [E, 3] int32 block into the output buffer of the
// device k hops right around the 'route' ring and waited on a pair of DMA
// semaphores. The port is single-controller: one process owns every
// (dp, route) shard, and several shards may share a card. So one launch per
// round per source card takes a table of (src, dst) pointer pairs, one per
// shard living on that card, and copies each block into its destination —
// the receiver's recv[(my_r - k) % R] slot directly (the wrapper passes
// those slots as destinations), fusing the reference's
// dynamic_update_index_in_dim into the copy. A destination on the same card
// is local memory; on another card it is a peer pointer, written over
// NVLink (ring_enable_peer maps it once per pair of cards).
//
// Ordering: the TPU's send/recv semaphores become stream order. On one
// card the copy runs on the caller's stream between the pack that wrote the
// source blocks and the merge that reads the destinations. Across cards the
// wrapper makes the source card's stream wait on an event of the
// destination's stream before the launch, and the destination's stream wait
// on an event recorded after it.
//
// Design: grid (x: chunks of the block, y: pair). Each thread moves int4
// (16 bytes) when both pointers of its pair are 16-byte aligned, with a
// scalar tail for n_ints % 4 (the wrapper's blocks are [E, 3], so E * 3 is
// often not a multiple of 4); otherwise it moves int32s. The pair table is
// a kernel parameter (MAX_PAIRS pointer pairs, 1 KB), so a launch needs no
// host-to-device copy of its own.
//
// Bound: bytes. Each pair reads and writes E * 12 bytes once: on one H100,
// (2 * pairs * E * 12) bytes over 3.35 TB/s — at the mesh phase's
// 8 shards and E = 24,576 that is 4.7 MB, about 1.4 us; a peer write is
// bound instead by NVLink at 450 GB/s each way. At these sizes the launch
// (a few microseconds) dominates: the kernel is launch-bound, and batching
// all pairs of a card into one launch is what its design does about it.
//
// Launches on the caller's stream, allocates nothing, does not
// synchronise; returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_PAIRS = 64;
constexpr int THREADS = 256;
constexpr long long MAX_CHUNKS = 1024;

struct Pairs {
  const int32_t* src[MAX_PAIRS];
  int32_t* dst[MAX_PAIRS];
};

__global__ void __launch_bounds__(THREADS) copy_pairs(const Pairs p,
                                                      long long n_ints) {
  const int32_t* __restrict__ s = p.src[blockIdx.y];
  int32_t* __restrict__ d = p.dst[blockIdx.y];
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  const long long t0 = static_cast<long long>(blockIdx.x) * THREADS +
                       threadIdx.x;
  long long done = 0;
  const bool aligned = ((reinterpret_cast<uintptr_t>(s) |
                         reinterpret_cast<uintptr_t>(d)) & 15) == 0;
  if (aligned) {
    const long long n4 = n_ints / 4;
    const int4* s4 = reinterpret_cast<const int4*>(s);
    int4* d4 = reinterpret_cast<int4*>(d);
    for (long long i = t0; i < n4; i += stride) d4[i] = __ldg(s4 + i);
    done = n4 * 4;
  }
  for (long long i = done + t0; i < n_ints; i += stride) d[i] = __ldg(s + i);
}

}  // namespace

// src[i], dst[i]: device pointers of pair i (n_pairs <= 64), each block
// n_ints int32. The sources live on card `device`; destinations on that
// card or on a card ring_enable_peer has mapped.
extern "C" int ring_rotate_launch(const void* const* src, void* const* dst,
                                  int n_pairs, long long n_ints, int device,
                                  void* stream) {
  if (n_pairs <= 0 || n_ints <= 0) return 0;
  if (n_pairs > MAX_PAIRS) return static_cast<int>(cudaErrorInvalidValue);
  Pairs p;
  for (int i = 0; i < n_pairs; ++i) {
    p.src[i] = static_cast<const int32_t*>(src[i]);
    p.dst[i] = static_cast<int32_t*>(dst[i]);
  }
  int prev = device;
  cudaGetDevice(&prev);
  if (prev != device) cudaSetDevice(device);
  const long long n4 = (n_ints + 3) / 4;
  long long chunks = (n4 + THREADS - 1) / THREADS;
  if (chunks > MAX_CHUNKS) chunks = MAX_CHUNKS;
  const dim3 grid(static_cast<unsigned>(chunks), n_pairs);
  copy_pairs<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      p, n_ints);
  const int err = static_cast<int>(cudaGetLastError());
  if (prev != device) cudaSetDevice(prev);
  return err;
}

// Map card `peer`'s memory into card `device`'s context. Returns 0 when
// mapped (or already mapped), -1 when the pair cannot peer, else the CUDA
// error.
extern "C" int ring_enable_peer(int device, int peer) {
  int can = 0;
  cudaError_t e = cudaDeviceCanAccessPeer(&can, device, peer);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!can) return -1;
  int prev = device;
  cudaGetDevice(&prev);
  cudaSetDevice(device);
  e = cudaDeviceEnablePeerAccess(peer, 0);
  if (e == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();
    e = cudaSuccess;
  }
  cudaSetDevice(prev);
  return static_cast<int>(e);
}
