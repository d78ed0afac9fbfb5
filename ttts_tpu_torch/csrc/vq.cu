// VQ codebook nearest neighbour.
//
// Replaces ttts_tpu/ops/pallas/vq.py vq_nearest_pallas / _vq_nn_kernel:
// argmin_j ||e_j||^2 - 2 x.e_j, ties to the lowest index. The (N, bins)
// distance matrix is never stored.
//
// What bounds it on the H100: the FP32 FMAs. At the codec's N=500, D=192,
// bins=1024 a call is 98 M FMA (0.2 GFLOP, 2.9 us at the card's f32 peak)
// against 0.8 MB of x and codebook, so the FMA units set the rate, provided
// every SM gets work and the shared-memory loads that feed the FMAs do not
// issue faster than the FMAs. The dot products and ||e||^2 stay IEEE FP32
// FMA summed in ascending d, never TF32 or tensor cores: the codes must
// equal the plain path's.
//
// Design: one launch, no scratch. The grid is (code slices, row tiles) =
// (8, ceil(N/40)) in clusters of the 8 code slices of one 40-row tile;
// rank r takes the 128-code slices r, r+8, ... (one slice at bins <= 1024).
// N=500 makes 13 clusters, 104 blocks: 32-row tiles made 16 clusters of 8,
// more than an H100 can place one block per SM (a variant that forced that
// ran in two waves), so some SMs ran two blocks (16.1 us against 13.8).
//   - The x tile and each code slice arrive K-major by TMA, 2-D boxes of 32
//     floats along D (one 128-byte row, swizzled by 128 bytes) into a
//     3-stage mbarrier ring: D=192 is 6 chunks. The codebook stays (bins, D).
//   - 128 threads, each owning 5 rows x 8 codes (rows rg + 8i, codes cgp
//     + 16k): a float4 along d of its 5 rows and of its 8 codes, 13 shared
//     loads of 16 bytes, feed 160 FMAs. A quarter-warp's 8 codes are 8
//     consecutive rows of the slice, which the swizzle puts in 8 different
//     bank groups; its rows are one address (a broadcast). Thread t also
//     sums code t's ||e||^2 from the same chunk.
//   - Keys (order-preserving distance bits << 32 | index): the smaller
//     distance wins and a tie goes to the lowest index, as in jnp.argmin /
//     torch.argmin. TMA fills codes past `bins` with zeros, whose distance 0
//     would win: they get the key ~0. Each block reduces its rows' keys in
//     shared memory; after a cluster barrier rank 0 takes the minimum over
//     the 8 ranks through distributed shared memory and writes the indices
//     of rows < N, and a second barrier keeps the ranks' shared memory alive
//     until it has read them. Rows past N (zero-filled) are never written.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

constexpr int VQ_RANKS = 8;    // code slices of a row tile: the portable cluster size
constexpr int VQ_ROWS = 40;    // rows of x a block
constexpr int VQ_SLICE = 128;  // codes a slice
constexpr int VQ_CHUNK = 32;   // floats along D a box: one 128-byte swizzle row
constexpr int VQ_STAGES = 3;
constexpr int VQ_MR = 5, VQ_MC = 8;  // a thread's rows and codes
constexpr int VQ_RG = VQ_ROWS / VQ_MR, VQ_CG = VQ_SLICE / VQ_MC;  // row and code groups
constexpr int VQ_THREADS = VQ_RG * VQ_CG;
constexpr uint32_t VQ_X_BYTES = VQ_ROWS * VQ_CHUNK * 4;
constexpr uint32_t VQ_E_BYTES = VQ_SLICE * VQ_CHUNK * 4;
constexpr uint32_t VQ_STAGE = VQ_X_BYTES + VQ_E_BYTES;
constexpr int VQ_SMEM = VQ_STAGES * VQ_STAGE + 1024;  // + slack to the swizzle's 1024-byte period

typedef unsigned long long u64;

__device__ __forceinline__ u64 vq_key(float s, int j) {
  const unsigned u = __float_as_uint(s);
  const unsigned ord = (u & 0x80000000u) ? ~u : (u | 0x80000000u);  // monotone in s
  return ((u64)ord << 32) | (unsigned)j;
}

__device__ __forceinline__ int vq_index(u64 k) { return (int)(k & 0xffffffffull); }

__device__ __forceinline__ u64 key_min(u64 a, u64 b) { return b < a ? b : a; }

// 16 bytes at chunk q (of 8) of row r of a tile of 128-byte rows swizzled by
// 128 bytes (its base 1024-byte aligned)
__device__ __forceinline__ float4 lds_sw(const uint8_t* tile, int r, int q) {
  return *reinterpret_cast<const float4*>(tile + r * 128 + ((q ^ (r & 7)) << 4));
}

__global__ void __cluster_dims__(VQ_RANKS, 1, 1) __launch_bounds__(VQ_THREADS)
vq_nearest_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap te,
                  int* __restrict__ out, int n, int d, int bins) {
  extern __shared__ uint8_t vq_smem[];
  __shared__ float s_nrm[VQ_SLICE];
  __shared__ u64 s_part[VQ_CG / 8][VQ_ROWS];  // per 8 code groups (one warp's)
  __shared__ u64 s_key[VQ_ROWS];      // the block's key of each row, read by rank 0
  __shared__ __align__(8) uint64_t bars[VQ_STAGES];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), row0 = blockIdx.y * VQ_ROWS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // a warp: 8 code groups x 4 row groups
  const int cgp = warp % (VQ_CG / 8) * 8 + (lane & 7);  // this thread's codes cgp + VQ_CG k
  const int rg = warp / (VQ_CG / 8) * 4 + (lane >> 3);  // and rows rg + VQ_RG i
  const uint32_t raw = smem_u32(vq_smem), base = (raw + 1023) & ~1023u;
  const uint8_t* tiles = vq_smem + (base - raw);
  const uint32_t bar0 = smem_u32(bars);
  const int nch = d / VQ_CHUNK, slices = (bins + VQ_SLICE - 1) / VQ_SLICE;
  const int steps = (rank < slices ? (slices - 1 - rank) / VQ_RANKS + 1 : 0) * nch;

  // step it: chunk it % nch of slice rank + 8 (it / nch), into stage it % VQ_STAGES
  auto issue = [&](int it) {
    const int s = it % VQ_STAGES, slice = rank + VQ_RANKS * (it / nch);
    const uint32_t dst = base + s * VQ_STAGE, bar = bar0 + 8 * s;
    fence_proxy_async();  // the stage's earlier reads come before these writes
    mbar_expect_tx(bar, VQ_STAGE);
    tma_load_2d(dst, &tx, bar, (it % nch) * VQ_CHUNK, row0);
    tma_load_2d(dst + VQ_X_BYTES, &te, bar, (it % nch) * VQ_CHUNK, slice * VQ_SLICE);
  };
  if (tid == 0) {
    for (int s = 0; s < VQ_STAGES; ++s) mbar_init(bar0 + 8 * s, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0)
    for (int it = 0; it < min(VQ_STAGES, steps); ++it) issue(it);

  float acc[VQ_MR][VQ_MC], nrm = 0.f;
  u64 best[VQ_MR];
#pragma unroll
  for (int i = 0; i < VQ_MR; ++i) {
    best[i] = ~0ull;
#pragma unroll
    for (int k = 0; k < VQ_MC; ++k) acc[i][k] = 0.f;
  }
  for (int it = 0; it < steps; ++it) {
    const int s = it % VQ_STAGES;
    mbar_wait(bar0 + 8 * s, (it / VQ_STAGES) & 1);
    const uint8_t* xs = tiles + s * VQ_STAGE;
    const uint8_t* es = xs + VQ_X_BYTES;
#pragma unroll
    for (int q = 0; q < VQ_CHUNK / 4; ++q) {  // 4 values of d at a time, ascending
      float4 xv[VQ_MR];
#pragma unroll
      for (int i = 0; i < VQ_MR; ++i) xv[i] = lds_sw(xs, rg + VQ_RG * i, q);
#pragma unroll
      for (int k = 0; k < VQ_MC; ++k) {
        const float4 e = lds_sw(es, cgp + VQ_CG * k, q);
#pragma unroll
        for (int i = 0; i < VQ_MR; ++i) {
          float a = fmaf(xv[i].x, e.x, acc[i][k]);
          a = fmaf(xv[i].y, e.y, a);
          a = fmaf(xv[i].z, e.z, a);
          acc[i][k] = fmaf(xv[i].w, e.w, a);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < VQ_CHUNK / 4; ++q) {  // ||e||^2 of code tid
      if (tid >= VQ_SLICE) break;
      const float4 e = lds_sw(es, tid, q);
      nrm = fmaf(e.x, e.x, nrm);
      nrm = fmaf(e.y, e.y, nrm);
      nrm = fmaf(e.z, e.z, nrm);
      nrm = fmaf(e.w, e.w, nrm);
    }
    __syncthreads();  // every thread is done with stage s: refill it
    if (tid == 0 && it + VQ_STAGES < steps) issue(it + VQ_STAGES);
    if ((it + 1) % nch == 0) {  // the slice is complete: fold its keys in
      const int j0 = (rank + VQ_RANKS * (it / nch)) * VQ_SLICE;
      if (tid < VQ_SLICE) s_nrm[tid] = nrm;
      nrm = 0.f;
      __syncthreads();
#pragma unroll
      for (int k = 0; k < VQ_MC; ++k) {
        const int j = j0 + cgp + VQ_CG * k;
        const float nk = s_nrm[cgp + VQ_CG * k];
#pragma unroll
        for (int i = 0; i < VQ_MR; ++i) {
          // codes past `bins` arrived as zeros: keep them out
          if (j < bins) best[i] = key_min(best[i], vq_key(nk - 2.f * acc[i][k], j));
          acc[i][k] = 0.f;
        }
      }
    }
  }

  // the block's key of each row: over a row's 8 lanes, then its warps
#pragma unroll
  for (int i = 0; i < VQ_MR; ++i) {
    u64 k = best[i];
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) k = key_min(k, __shfl_xor_sync(0xffffffffu, k, off));
    if ((lane & 7) == 0) s_part[warp % (VQ_CG / 8)][rg + VQ_RG * i] = k;
  }
  __syncthreads();
  if (tid < VQ_ROWS) {
    u64 k = s_part[0][tid];
    for (int w = 1; w < VQ_CG / 8; ++w) k = key_min(k, s_part[w][tid]);
    s_key[tid] = k;
  }

  cluster.sync();  // every rank's keys are in its shared memory
  if (rank == 0 && tid < VQ_ROWS) {
    u64 k = s_key[tid];
    for (int r = 1; r < VQ_RANKS; ++r) k = key_min(k, cluster.map_shared_rank(s_key, r)[tid]);
    if (row0 + tid < n) out[row0 + tid] = vq_index(k);
  }
  cluster.sync();  // rank 0 has read every rank's keys: their shared memory may go
}

// x (n, d) and codebook (bins, d) f32 contiguous, 16-byte aligned, d a
// multiple of VQ_CHUNK; out (n,) int32
extern "C" int ttts_vq_nearest(const void* x, const void* codebook, void* out, int n, int d,
                               int bins, void* stream) {
  if (n <= 0) return 0;
  if (d <= 0 || d % VQ_CHUNK || bins <= 0) return (int)cudaErrorInvalidValue;
  CUtensorMap tx, te;
  const cuuint64_t x_dims[2] = {(cuuint64_t)d, (cuuint64_t)n};
  const cuuint64_t e_dims[2] = {(cuuint64_t)d, (cuuint64_t)bins};
  const cuuint64_t strides[1] = {(cuuint64_t)d * 4};
  const cuuint32_t x_box[2] = {VQ_CHUNK, VQ_ROWS}, e_box[2] = {VQ_CHUNK, VQ_SLICE};
  if (!f32_map(&tx, x, 2, x_dims, strides, x_box, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !f32_map(&te, codebook, 2, e_dims, strides, e_box, CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      vq_nearest_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, VQ_SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid(VQ_RANKS, (n + VQ_ROWS - 1) / VQ_ROWS);
  vq_nearest_kernel<<<grid, VQ_THREADS, VQ_SMEM, TTTS_STREAM(stream)>>>(
      tx, te, static_cast<int*>(out), n, d, bins);
  return (int)cudaGetLastError();
}

extern "C" const char* ttts_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
