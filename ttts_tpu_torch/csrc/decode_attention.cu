// Fused single-token decode attention for the GPT serving loop.
//
// Replaces ttts_tpu/ops/pallas/decode_attention.py fused_decode_attention /
// _kernel: write the step's new K/V row at `pos` in place, then q.K^T over
// rows <= pos with an online softmax and P.V. Rows past `pos` are never read.
//
// What bounds it on the H100: cache bytes, then latency. One step reads
// (pos+1) rows of K and V per (batch, head): at B=4, H=8, dk=64, pos~560 in
// bf16 that is ~4.6 MB, 1.4 us at 3.35 TB/s; only B*H = 8-32 (batch, head)
// pairs exist against 132 SMs, and the work of one pair is a few
// microseconds of dependent steps, so launches and synchronisation set the
// time as much as bytes do.
//
// Design: one launch, split over a thread-block cluster. The grid is
// (DEC_RANKS, B*H) with clusters of DEC_RANKS blocks along x: the cluster is
// one (batch, head) pair and does not depend on `pos`. Rank r takes an even
// share of rows [0, pos]; in the (B, H, max_len, dk) layout the share is one
// contiguous run of K and one of V, brought into shared memory by two bulk
// copies (cp.async.bulk) on an mbarrier, a panel of DEC_PANEL rows at a
// time. Scores: 8 lanes per row, each with 8 dk values from one 16-byte
// load, a 3-shuffle reduction, so a warp scores 4 rows per instruction. The
// softmax max is a warp reduction; P.V keeps all 128 threads busy (8 column
// groups x 16 row slices). Each rank leaves (acc[dk], m, z) in its shared
// memory; after a cluster barrier rank 0 merges the DEC_RANKS partials
// through distributed shared memory and writes the output, and a second
// cluster barrier keeps the other ranks' shared memory alive until it has
// read them. No global scratch. Ranks with no rows (pos < DEC_RANKS-1) still
// reach both barriers and leave m = -inf, z = 0, acc = 0, which the merge
// weighs by exp2(-inf) = 0. CUDA blocks run in no order, so no block may
// rely on another having written row `pos`: the rank whose share holds
// `pos` takes that row from uk/uv and is the only one that writes it into
// the caches.
//
// `pos` from the device: the kernel reads the row from an int32 word in
// device memory (`pos_word`), so a CUDA graph captured once replays every
// step of the serving loop while the loop advances the word on the card; a
// null word takes `pos` by value (chip_smoke.py, the tests), through the
// same body. The host checks 0 <= pos < max_len for a value; for a word the
// decode loop checks once, on the host, the largest row it will reach
// before it replays (models/gpt.inference_speech), and the kernel guards
// itself: every block of a launch reads the same word, and with it out of
// range they all write NaN to `out` and return before any cache access or
// cluster barrier.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

constexpr int DEC_RANKS = 8;  // blocks per (batch, head): the portable cluster size
constexpr int DEC_THREADS = 128;
constexpr int DEC_DK = 64;     // head width (the GPT's 512 / 8 heads)
constexpr int DEC_PANEL = 128;  // rows of K and of V in shared memory at once
constexpr int DEC_VEC = DEC_DK / 8;  // 16-byte chunks per row = lanes per row

__device__ __forceinline__ void bf16x8_to_f(const uint4& raw, float (&f)[8]) {
  const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
  for (int x = 0; x < 8; ++x) f[x] = __bfloat162float(e[x]);
}

__global__ void __cluster_dims__(DEC_RANKS, 1, 1) __launch_bounds__(DEC_THREADS)
decode_kernel(const bf16* __restrict__ q, const bf16* __restrict__ uk,
              const bf16* __restrict__ uv, bf16* __restrict__ kc, bf16* __restrict__ vc,
              bf16* __restrict__ out, const int* __restrict__ pos_word, int max_len, int pos_value,
              float scale) {
  __shared__ __align__(128) uint4 Ks[DEC_PANEL * DEC_VEC];
  __shared__ __align__(128) uint4 Vs[DEC_PANEL * DEC_VEC];
  __shared__ float ps[DEC_PANEL];                    // the panel's scores (log2 domain)
  __shared__ float red[DEC_THREADS / 32][DEC_DK + 1];  // per warp: acc[dk], z
  __shared__ float part[DEC_DK + 2];                 // this rank's acc[dk], m, z
  __shared__ __align__(8) uint64_t bar;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), bh = blockIdx.y, tid = threadIdx.x;
  const int pos = pos_word ? *pos_word : pos_value;
  if (pos < 0 || pos >= max_len) {  // uniform over the grid: no block reaches a barrier
    if (rank == 0 && tid < DEC_DK) out[(size_t)bh * DEC_DK + tid] = __float2bfloat16(NAN);
    return;
  }
  const int lane = tid & 31, warp = tid >> 5, c = lane & (DEC_VEC - 1);
  const int n = pos + 1, share = (n + DEC_RANKS - 1) / DEC_RANKS;
  const int r0 = min(n, rank * share), r1 = min(n, r0 + share);  // this rank's rows
  const size_t cbase = (size_t)bh * max_len * DEC_DK;
  const uint4* ukr = reinterpret_cast<const uint4*>(uk + (size_t)bh * DEC_DK);
  const uint4* uvr = reinterpret_cast<const uint4*>(uv + (size_t)bh * DEC_DK);
  const uint32_t bar_a = smem_u32(&bar);
  if (tid == 0) {
    mbar_init(bar_a, 1);
    fence_barrier_init();
  }
  if (r0 <= pos && pos < r1 && tid < DEC_VEC) {  // this rank owns row `pos`: the only writer
    reinterpret_cast<uint4*>(kc + cbase + (size_t)pos * DEC_DK)[tid] = ukr[tid];
    reinterpret_cast<uint4*>(vc + cbase + (size_t)pos * DEC_DK)[tid] = uvr[tid];
  }
  float qf[8];  // this lane's 8 q values, scaled into the log2 domain
  bf16x8_to_f(reinterpret_cast<const uint4*>(q + (size_t)bh * DEC_DK)[c], qf);
#pragma unroll
  for (int x = 0; x < 8; ++x) qf[x] *= scale * LOG2E;
  __syncthreads();

  float m = -INFINITY, z = 0.f, acc[8] = {};
  uint32_t phase = 0;
  for (int p0 = r0; p0 < r1; p0 += DEC_PANEL) {
    const int rows = min(DEC_PANEL, r1 - p0);
    const int cached = min(rows, pos - p0);  // rows read from the caches; row pos comes from uk, uv
    if (tid == 0 && cached > 0) {
      const uint32_t bytes = (uint32_t)cached * DEC_DK * 2;
      fence_proxy_async();  // the previous panel's reads come before these writes
      mbar_expect_tx(bar_a, 2 * bytes);
      bulk_load(smem_u32(Ks), kc + cbase + (size_t)p0 * DEC_DK, bytes, bar_a);
      bulk_load(smem_u32(Vs), vc + cbase + (size_t)p0 * DEC_DK, bytes, bar_a);
    }
    if (cached < rows && tid < DEC_VEC) {  // row pos: the panel's last
      Ks[cached * DEC_VEC + tid] = ukr[tid];
      Vs[cached * DEC_VEC + tid] = uvr[tid];
    }
    if (cached > 0) {
      mbar_wait(bar_a, phase);
      phase ^= 1;
    }
    __syncthreads();

    // scores: 8 lanes per row, a warp's 4 row groups take 4 rows at once
    for (int rb = 0; rb < rows; rb += 4 * DEC_THREADS / 32) {
      const int r = rb + warp * 4 + (lane >> 3);
      float a = 0.f;
      if (r < rows) {
        float kf[8];
        bf16x8_to_f(Ks[r * DEC_VEC + c], kf);
#pragma unroll
        for (int x = 0; x < 8; ++x) a = fmaf(qf[x], kf[x], a);
      }
      a += __shfl_xor_sync(0xffffffffu, a, 1);
      a += __shfl_xor_sync(0xffffffffu, a, 2);
      a += __shfl_xor_sync(0xffffffffu, a, 4);
      if (r < rows && c == 0) ps[r] = a;
    }
    __syncthreads();

    float mp = -INFINITY;  // the panel's max, reduced by every warp alike
    for (int r = lane; r < rows; r += 32) mp = fmaxf(mp, ps[r]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mp = fmaxf(mp, __shfl_xor_sync(0xffffffffu, mp, off));
    const float m_new = fmaxf(m, mp);     // finite: the panel holds a row
    const float alpha = exp2f(m - m_new);  // 0 on the first panel
    m = m_new;
    z *= alpha;
#pragma unroll
    for (int x = 0; x < 8; ++x) acc[x] *= alpha;
    // P.V: thread (slice tid / 8, column group c) takes rows slice, slice + 16, ...
    for (int r = tid >> 3; r < rows; r += DEC_THREADS / 8) {
      const float p = exp2f(ps[r] - m);
      float vf[8];
      bf16x8_to_f(Vs[r * DEC_VEC + c], vf);
      z += p;
#pragma unroll
      for (int x = 0; x < 8; ++x) acc[x] = fmaf(p, vf[x], acc[x]);
    }
    __syncthreads();  // the panel's buffers may be refilled
  }

  // this rank's partial: sum the 16 row slices (4 per warp, then 4 warps)
#pragma unroll
  for (int x = 0; x < 8; ++x) {
    acc[x] += __shfl_xor_sync(0xffffffffu, acc[x], 8);
    acc[x] += __shfl_xor_sync(0xffffffffu, acc[x], 16);
  }
  z += __shfl_xor_sync(0xffffffffu, z, 8);
  z += __shfl_xor_sync(0xffffffffu, z, 16);
  if (lane < DEC_VEC) {
#pragma unroll
    for (int x = 0; x < 8; ++x) red[warp][c * 8 + x] = acc[x];
    if (lane == 0) red[warp][DEC_DK] = z;
  }
  __syncthreads();
  if (tid <= DEC_DK) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < DEC_THREADS / 32; ++w) s += red[w][tid];
    part[tid == DEC_DK ? DEC_DK + 1 : tid] = s;
    if (tid == 0) part[DEC_DK] = m;
  }

  cluster.sync();  // every rank's partial is in its shared memory
  if (rank == 0 && tid < DEC_DK) {
    float mr[DEC_RANKS], mx = -INFINITY;
#pragma unroll
    for (int r = 0; r < DEC_RANKS; ++r) {
      mr[r] = cluster.map_shared_rank(part, r)[DEC_DK];
      mx = fmaxf(mx, mr[r]);  // finite: rank 0 holds row 0
    }
    float zs = 0.f, o = 0.f;
#pragma unroll
    for (int r = 0; r < DEC_RANKS; ++r) {
      const float* pr = cluster.map_shared_rank(part, r);
      const float w = exp2f(mr[r] - mx);
      zs = fmaf(w, pr[DEC_DK + 1], zs);
      o = fmaf(w, pr[tid], o);
    }
    out[(size_t)bh * DEC_DK + tid] = __float2bfloat16(o / zs);
  }
  cluster.sync();  // rank 0 has read every partial: the ranks' shared memory may go
}

// q, uk, uv: (bh, dk) contiguous; kc, vc: (bh, max_len, dk) contiguous; all
// 16-byte aligned; dk = DEC_DK. pos_word: the row as an int32 in device
// memory, or null to take `pos` (then 0 <= pos < max_len)
extern "C" int ttts_decode_attention_bf16(const void* q, const void* uk, const void* uv,
                                          void* kc, void* vc, void* out, const void* pos_word,
                                          int bh, int max_len, int dk, int pos, float scale,
                                          void* stream) {
  if (dk != DEC_DK || (!pos_word && (pos < 0 || pos >= max_len)))
    return (int)cudaErrorInvalidValue;
  decode_kernel<<<dim3(DEC_RANKS, bh), DEC_THREADS, 0, TTTS_STREAM(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(uk), static_cast<const bf16*>(uv),
      static_cast<bf16*>(kc), static_cast<bf16*>(vc), static_cast<bf16*>(out),
      static_cast<const int*>(pos_word), max_len, pos, scale);
  return (int)cudaGetLastError();
}
