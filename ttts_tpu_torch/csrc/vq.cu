// VQ codebook nearest neighbour.
//
// Replaces ttts_tpu/ops/pallas/vq.py vq_nearest_pallas / _vq_nn_kernel:
// argmin_j ||e_j||^2 - 2 x.e_j with a running (min, argmin) per row, ties to
// the lowest index. The (N, bins) distance matrix is never stored.
//
// What bounds it on the H100: parallelism, not bytes or FLOPs. x is
// (N<=500, 192) and the codebook (1024, 192) f32 is 768 KB, resident in the
// 50 MB L2; the work is ~0.2 GFLOP of FP32 FMA, ~3 us at the card's f32
// peak, but only if all 132 SMs get work: one block per row tile gives 63.
//
// Design: a block owns VQ_ROWS rows of x (staged in shared memory) and one
// VQ_SLICE-code slice of the codebook, one code per thread, so N=500 makes
// 504 blocks. The codebook is pre-transposed to (D, bins) by the wrapper so
// a warp reads 32 consecutive codes (coalesced). The dot runs in IEEE FP32
// FMA, never TF32 or tensor cores, because the codes must equal the plain
// path's. Slices merge through one 64-bit atomicMin per (row, slice) on
// keys of (order-preserving distance bits << 32 | index): the smaller
// distance wins and a tie goes to the lowest index, as in jnp.argmin /
// torch.argmin. A second tiny kernel unpacks the indices.
#include "common.cuh"

constexpr int VQ_ROWS = 8;
constexpr int VQ_SLICE = 128;  // codes per block = threads per block

__device__ __forceinline__ unsigned long long vq_key(float s, int j) {
  const unsigned u = __float_as_uint(s);
  const unsigned ord = (u & 0x80000000u) ? ~u : (u | 0x80000000u);  // monotone in s
  return ((unsigned long long)ord << 32) | (unsigned)j;
}

__global__ void __launch_bounds__(VQ_SLICE)
vq_nearest_kernel(const float* __restrict__ x, const float* __restrict__ cbt,
                  unsigned long long* __restrict__ keys, int n, int d, int bins) {
  extern __shared__ float xs[];  // VQ_ROWS * d
  __shared__ unsigned long long wbest[VQ_ROWS][VQ_SLICE / 32];
  const int row0 = blockIdx.x * VQ_ROWS;
  const int j = blockIdx.y * VQ_SLICE + threadIdx.x;
  for (int i = threadIdx.x; i < VQ_ROWS * d; i += blockDim.x) {
    const int r = i / d, c = i - r * d;
    xs[i] = (row0 + r < n) ? x[(size_t)(row0 + r) * d + c] : 0.f;
  }
  __syncthreads();

  float acc[VQ_ROWS];
#pragma unroll
  for (int r = 0; r < VQ_ROWS; ++r) acc[r] = 0.f;
  float nrm = 0.f;
  if (j < bins) {
    for (int c = 0; c < d; ++c) {
      const float e = cbt[(size_t)c * bins + j];
      nrm = fmaf(e, e, nrm);
#pragma unroll
      for (int r = 0; r < VQ_ROWS; ++r) acc[r] = fmaf(xs[r * d + c], e, acc[r]);
    }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < VQ_ROWS; ++r) {
    unsigned long long k = j < bins ? vq_key(nrm - 2.f * acc[r], j) : ~0ull;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const unsigned long long o = __shfl_xor_sync(0xffffffffu, k, off);
      k = o < k ? o : k;
    }
    if (lane == 0) wbest[r][warp] = k;
  }
  __syncthreads();
  if (threadIdx.x < VQ_ROWS && row0 + threadIdx.x < n) {
    const int r = threadIdx.x;
    unsigned long long k = wbest[r][0];
    for (int w = 1; w < VQ_SLICE / 32; ++w) k = wbest[r][w] < k ? wbest[r][w] : k;
    atomicMin(keys + row0 + r, k);
  }
}

__global__ void vq_unpack_kernel(const unsigned long long* __restrict__ keys,
                                 int* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = (int)(keys[i] & 0xffffffffull);
}

extern "C" int ttts_vq_nearest(const void* x, const void* cbt, void* keys, void* out, int n,
                               int d, int bins, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = TTTS_STREAM(stream);
  cudaError_t err = cudaMemsetAsync(keys, 0xff, (size_t)n * sizeof(unsigned long long), st);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + VQ_ROWS - 1) / VQ_ROWS, (bins + VQ_SLICE - 1) / VQ_SLICE);
  vq_nearest_kernel<<<grid, VQ_SLICE, (size_t)VQ_ROWS * d * sizeof(float), st>>>(
      static_cast<const float*>(x), static_cast<const float*>(cbt),
      static_cast<unsigned long long*>(keys), n, d, bins);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  vq_unpack_kernel<<<(n + 255) / 256, 256, 0, st>>>(static_cast<const unsigned long long*>(keys),
                                                    static_cast<int*>(out), n);
  return (int)cudaGetLastError();
}

extern "C" const char* ttts_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
