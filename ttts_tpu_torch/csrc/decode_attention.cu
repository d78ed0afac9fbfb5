// Fused single-token decode attention for the GPT serving loop.
//
// Replaces ttts_tpu/ops/pallas/decode_attention.py fused_decode_attention /
// _kernel: write the step's new K/V row at `pos` in place, then q.K^T over
// rows <= pos with an online softmax and P.V. Rows past `pos` are never read.
//
// What bounds it on the H100: cache bytes. One step reads (pos+1) rows of
// K and V per (batch, head): at B=1, H=8, dk=64, pos~560 in bf16 that is
// ~1.1 MB per layer, ~0.35 us at 3.35 TB/s; so at B=1 the real bound is
// launch latency and parallelism: only B*H = 8 (batch, head) pairs exist
// against 132 SMs.
//
// Design: flash-decoding. The time axis is cut into DEC_CHUNK-row chunks and
// each (chunk, batch*head) pair is one block, so B=1 still fills the card
// (pos=560 gives 18 x 8 = 144 blocks). Only chunks at or below `pos` are
// launched. Each block writes a partial (m, z, acc) and a second kernel
// combines them. CUDA blocks run in no order, so unlike the sequential TPU
// grid no block may rely on another having written row `pos`: the one block
// whose chunk holds `pos` takes that row from the uk/uv inputs and is the
// only block that writes it into the cache.
#include "common.cuh"

constexpr int DEC_CHUNK = 32;
constexpr int DEC_THREADS = 128;

template <typename T>
__global__ void __launch_bounds__(DEC_THREADS)
decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ uk,
                      const T* __restrict__ uv, T* __restrict__ kc, T* __restrict__ vc,
                      float* __restrict__ m_part, float* __restrict__ z_part,
                      float* __restrict__ acc_part, int max_len, int dk, int pos,
                      int nsplit, float scale) {
  extern __shared__ float sm[];
  float* qs = sm;       // dk
  float* ps = sm + dk;  // DEC_CHUNK scores, then probabilities
  const int split = blockIdx.x, bh = blockIdx.y, tid = threadIdx.x;
  const int r0 = split * DEC_CHUNK;
  const size_t cbase = (size_t)bh * max_len * dk;
  const T* ukr = uk + (size_t)bh * dk;
  const T* uvr = uv + (size_t)bh * dk;

  for (int d = tid; d < dk; d += blockDim.x) qs[d] = to_f(q[(size_t)bh * dk + d]) * scale;
  if (pos < r0 + DEC_CHUNK) {  // this block owns row `pos`: the only writer
    for (int d = tid; d < dk; d += blockDim.x) {
      kc[cbase + (size_t)pos * dk + d] = ukr[d];
      vc[cbase + (size_t)pos * dk + d] = uvr[d];
    }
  }
  __syncthreads();

  const int lane = tid & 31, warp = tid >> 5, nwarps = blockDim.x >> 5;
  for (int r = warp; r < DEC_CHUNK; r += nwarps) {
    const int row = r0 + r;
    float s = -INFINITY;
    if (row <= pos) {
      const T* krow = row == pos ? ukr : kc + cbase + (size_t)row * dk;
      float a = 0.f;
      for (int d = lane; d < dk; d += 32) a = fmaf(qs[d], to_f(krow[d]), a);
      s = warp_sum(a);
    }
    if (lane == 0) ps[r] = s;
  }
  __syncthreads();
  float m = -INFINITY;  // finite: row r0 <= pos always holds
  for (int r = 0; r < DEC_CHUNK; ++r) m = fmaxf(m, ps[r]);
  __syncthreads();
  if (tid < DEC_CHUNK) ps[tid] = expf(ps[tid] - m);
  __syncthreads();

  const int nrows = min(DEC_CHUNK, pos - r0 + 1);
  for (int d = tid; d < dk; d += blockDim.x) {
    float acc = 0.f;
    for (int r = 0; r < nrows; ++r) {
      const int row = r0 + r;
      const T* vrow = row == pos ? uvr : vc + cbase + (size_t)row * dk;
      acc = fmaf(ps[r], to_f(vrow[d]), acc);
    }
    acc_part[((size_t)bh * nsplit + split) * dk + d] = acc;
  }
  if (tid == 0) {
    float z = 0.f;
    for (int r = 0; r < nrows; ++r) z += ps[r];
    m_part[bh * nsplit + split] = m;
    z_part[bh * nsplit + split] = z;
  }
}

template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ m_part,
                                      const float* __restrict__ z_part,
                                      const float* __restrict__ acc_part, T* __restrict__ out,
                                      int dk, int nsplit) {
  const int bh = blockIdx.x;
  const float* mp = m_part + (size_t)bh * nsplit;
  const float* zp = z_part + (size_t)bh * nsplit;
  float mx = -INFINITY;
  for (int s = 0; s < nsplit; ++s) mx = fmaxf(mx, mp[s]);
  float z = 0.f;
  for (int s = 0; s < nsplit; ++s) z += zp[s] * expf(mp[s] - mx);
  for (int d = threadIdx.x; d < dk; d += blockDim.x) {
    float o = 0.f;
    for (int s = 0; s < nsplit; ++s)
      o += acc_part[((size_t)bh * nsplit + s) * dk + d] * expf(mp[s] - mx);
    out[(size_t)bh * dk + d] = from_f<T>(o / z);
  }
}

template <typename T>
static int decode_launch(const void* q, const void* uk, const void* uv, void* kc, void* vc,
                         void* out, void* m_part, void* z_part, void* acc_part, int bh,
                         int max_len, int dk, int pos, float scale, void* stream) {
  const int nsplit = pos / DEC_CHUNK + 1;
  const size_t smem = (size_t)(dk + DEC_CHUNK) * sizeof(float);
  cudaStream_t st = TTTS_STREAM(stream);
  decode_partial_kernel<T><<<dim3(nsplit, bh), DEC_THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(uk), static_cast<const T*>(uv),
      static_cast<T*>(kc), static_cast<T*>(vc), static_cast<float*>(m_part),
      static_cast<float*>(z_part), static_cast<float*>(acc_part), max_len, dk, pos, nsplit,
      scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_combine_kernel<T><<<bh, 64, 0, st>>>(
      static_cast<const float*>(m_part), static_cast<const float*>(z_part),
      static_cast<const float*>(acc_part), static_cast<T*>(out), dk, nsplit);
  return (int)cudaGetLastError();
}

extern "C" int ttts_decode_attention_bf16(const void* q, const void* uk, const void* uv,
                                          void* kc, void* vc, void* out, void* m_part,
                                          void* z_part, void* acc_part, int bh, int max_len,
                                          int dk, int pos, float scale, void* stream) {
  return decode_launch<bf16>(q, uk, uv, kc, vc, out, m_part, z_part, acc_part, bh, max_len,
                             dk, pos, scale, stream);
}
