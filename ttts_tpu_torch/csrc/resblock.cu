// Fused scale-shift ResBlock of the diffusion trunk, and the fused
// GroupNorm -> qkv projection of its attention blocks.
//
// Replaces ttts_tpu/ops/pallas/resblock.py fused_scale_shift_resblock /
// _resblock_kernel:
//   out = x + conv3(SiLU(GN(Dense(SiLU(GN(x)*g1 + b1)))*a2 + b2)) + bc3,
// GroupNorm statistics in f32, both activations rounded to bf16 before their
// products (resblock.py:88, :101), h = Dense(.) kept in f32, the conv's
// 'SAME' zero padding applied to the *activated* h (_shift_rows), the
// residual added in f32, bf16 out.
//
// What bounds it on the H100: the two GEMMs (C x C and 3C x C at M = B*T =
// 3200, C = 512) are 6.7 GFLOP, 6.8 us at the bf16 tensor-core peak; the
// function's own traffic (x in, out, the weights) is ~8 MB, 2.4 us. The TPU
// kernel keeps a whole (T, C) slab in VMEM and makes one pass; here a slab
// is 1.6 MB, far past the 227 KB of shared memory a block has, and
// GroupNorm needs statistics over all of T before any row can be normalised,
// so the block is cut where those statistics are needed:
//   1. gn_stats_kernel: per (32-row chunk, batch) block, each group's mean
//      and centred sum of squares (M2) of x, 16-byte loads across channels;
//   2. gn_act_kernel<bf16>: merges the chunks' partials (Chan's formula) and
//      writes a1 = bf16(SiLU(GN(x)*g1 + b1)) once (what JAX rounds before
//      the Dense), in blocks of 8 rows, each thread's loads issued before
//      the merge;
//   3. rb_wgmma_kernel<1>: h = a1 @ w1 + bd1 in f32, and from the same
//      accumulators each (128-row tile, group) partial of h, so h is not
//      read again for its statistics;
//   4. gn_act_kernel<float>: a2 = bf16(SiLU(GN(h)*a2[b] + b2[b])) once;
//   5. rb_wgmma_kernel<2>: out = x + conv3(a2) + bc3 as one K = 3C GEMM.
// The two GEMMs run on Hopper's asynchronous paths: a producer warp keeps a
// 4-stage ring of 32 KB stages full by TMA (A: a 128x64 box of a (C, T, B)
// tensor map; B: two 64x64 boxes of the (in, out) weight, read MN-major by
// wgmma's transpose bit, so the weights keep the JAX layout), and two
// consumer warpgroups each issue wgmma m64n128k16 on their 64 rows. The
// conv's three taps are three TMA loads of a2 at rows t-1, t, t+1; rows -1
// and T of each batch lie outside the (C, T, B) map, so TMA's zero fill is
// the 'SAME' padding, per batch. Tiles of 128x128: at B=2, T=1600, C=512,
// 13 x 4 x 2 = 104 blocks, under one wave of 132 SMs, each with 129 KB of
// dynamic shared memory. The activation passes move ~23 MB, most of it out
// of L2 (50 MB).
//
// Also replaces resblock.py fused_gn_qkv / _gn_qkv_kernel:
//   out = (GroupNorm(x) * g + b) @ W + bias,  W (C, 3C), out (B, T, 3C),
// f32 statistics, the normalised x rounded to bf16 for the product. At B=4,
// T=1600, C=512 that is 10.1 GFLOP against ~15 MB of traffic: bound by the
// tensor cores (10.2 us), where the TPU kernel re-paid the statistics for
// each of its three column blocks. Three launches: the statistics pass of
// step 1; gn_table_kernel, which merges x's partials once per (batch, group)
// into a per-(batch, channel) multiply-add; and gn_qkv_kernel, a persistent
// wgmma GEMM fed by TMA that applies the multiply-add to the raw x on its
// way from shared memory into wgmma's register A operand (no normalised x
// is written), with the bias in the epilogue.
#include <type_traits>

#include "common.cuh"

constexpr int GN_ROWS = 128;   // rows of a partial of h = the GEMMs' M tile
constexpr int X_ROWS = 32;     // rows of a partial of x (one statistics block)
constexpr int GN_THREADS = 256;  // a statistics block
constexpr int ROW_BATCH = 8;     // rows whose loads a statistics thread has in flight
constexpr int ACT_THREADS = 128, ACT_BATCH = 4;  // an activation block, its rows a thread
constexpr int RB_MAX_C = 1024, RB_MAX_G = 64;

// (n, mean, M2) += (nb, mb, qb): Chan's parallel combination
__device__ __forceinline__ void chan_merge(float& n, float& mean, float& m2, float nb, float mb,
                                           float qb) {
  const float nn = n + nb;
  if (nn == 0.f) return;
  const float d = mb - mean;
  mean += d * (nb / nn);
  m2 += qb + d * d * (n * nb / nn);
  n = nn;
}

__device__ __forceinline__ void load8(const bf16* p, float (&v)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = __bfloat162float(e[i]);
}

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 lo = reinterpret_cast<const float4*>(p)[0];
  const float4 hi = reinterpret_cast<const float4*>(p)[1];
  v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;
  v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
}

// Block (s, b): mean and M2 of x[b, rows s*X_ROWS .., channels of group g]
// for every group g. A thread takes 8 channels (one 16-byte load a row) of
// every (GN_THREADS / (C/8))-th row, ROW_BATCH rows' loads in flight at
// once; the threads of a group are merged last. Needs C/G a multiple of 8
// and C <= 8 * GN_THREADS.
__global__ void __launch_bounds__(GN_THREADS)
gn_stats_kernel(const bf16* __restrict__ x, float2* __restrict__ part, int T, int C, int G,
                int S) {
  __shared__ float3 st[GN_THREADS];
  const int s = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int c8n = C / 8, rp = GN_THREADS / c8n;  // threads per row, rows per pass
  const int c8 = tid % c8n, r0 = tid / c8n;
  const int t0 = s * X_ROWS, rows = min(X_ROWS, T - t0);
  const bf16* src = x + ((size_t)b * T + t0) * C + c8 * 8;
  float n = 0.f, mean = 0.f, m2 = 0.f;
  if (r0 < rp)
    for (int r = r0; r < rows; r += ROW_BATCH * rp) {
      float v[ROW_BATCH][8];
#pragma unroll
      for (int k = 0; k < ROW_BATCH; ++k)
        if (r + k * rp < rows) load8(src + (size_t)(r + k * rp) * C, v[k]);
#pragma unroll
      for (int k = 0; k < ROW_BATCH; ++k) {
        if (r + k * rp >= rows) break;
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) sum += v[k][i];
        const float m8 = sum * 0.125f;
        float q = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) q = fmaf(v[k][i] - m8, v[k][i] - m8, q);
        chan_merge(n, mean, m2, 8.f, m8, q);
      }
    }
  st[tid] = make_float3(n, mean, m2);
  __syncthreads();
  const int cg8 = C / G / 8;  // threads of one row per group
  for (int g = tid; g < G; g += GN_THREADS) {
    float gn = 0.f, gm = 0.f, gq = 0.f;
    for (int r = 0; r < rp; ++r)
      for (int j = 0; j < cg8; ++j) {
        const float3 o = st[r * c8n + g * cg8 + j];
        chan_merge(gn, gm, gq, o.x, o.y, o.z);
      }
    part[((size_t)b * G + g) * S + s] = make_float2(gm, gq);
  }
}

// Every group's mean and 1/sqrt(var + eps) of batch b from its S partials
// (mean, M2), each over `rows` rows (the last over what remains of T), into
// s_mean and s_rstd: the mean from the partials' means weighted by their
// rows, M2 from their M2s and the spread of their means around it (Chan).
// Four lanes a group; called by every thread of the block, which then syncs.
__device__ __forceinline__ void gn_merge(const float2* __restrict__ part, int b, int G, int S,
                                         int rows, int T, int cg, float eps, float* s_mean,
                                         float* s_rstd) {
  const float n_all = (float)T * cg;
  const int s_end = S;
  for (int g0 = 0; g0 < G; g0 += blockDim.x / 4) {
    const int g = g0 + threadIdx.x / 4, sub = threadIdx.x & 3;
    const float2* pg = part + ((size_t)b * G + min(g, G - 1)) * S;
    float sum = 0.f;
#pragma unroll 8
    for (int s = sub; s < s_end; s += 4)
      sum += (float)(min(rows, T - s * rows) * cg) * pg[s].x;
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float mean = sum / n_all;
    float m2 = 0.f;
#pragma unroll 4
    for (int s = sub; s < s_end; s += 4) {
      const float d = pg[s].x - mean;
      m2 += pg[s].y + (float)(min(rows, T - s * rows) * cg) * d * d;
    }
    m2 += __shfl_xor_sync(0xffffffffu, m2, 1);
    m2 += __shfl_xor_sync(0xffffffffu, m2, 2);
    if (g < G && sub == 0) {
      s_mean[g] = mean;
      s_rstd[g] = rsqrtf(m2 / n_all + eps);
    }
  }
}

// Block (row chunk, b): dst = bf16(SiLU(GN(src)*scale + shift)) for
// ACT_BATCH * (ACT_THREADS / (C/8)) rows. src is bf16 x (scale g1, shift
// b1; S partials of X_ROWS rows) or f32 h (FILM: the per-batch GN_1 x FiLM
// affine a2[b], b2[b]; S partials of GN_ROWS rows). A thread's rows are
// loaded first, so their latency overlaps the merge of the partials, and
// small blocks (~3 an SM at the trunk's shape) overlap each other's chains.
template <typename TIn, bool FILM>
__global__ void __launch_bounds__(ACT_THREADS)
gn_act_kernel(const TIn* __restrict__ src, const float2* __restrict__ part,
              const float* __restrict__ sc, const float* __restrict__ sh, bf16* __restrict__ dst,
              int T, int C, int G, int S, float eps) {
  __shared__ float s_mean[RB_MAX_G], s_rstd[RB_MAX_G];
  const int b = blockIdx.y, tid = threadIdx.x, cg = C / G;
  const int c8n = C / 8, rp = ACT_THREADS / c8n, c8 = tid % c8n, r0 = tid / c8n;
  const int t0 = blockIdx.x * ACT_BATCH * rp + r0;  // this thread's rows t0, t0 + rp, ...
  const size_t o0 = ((size_t)b * T + t0) * C + c8 * 8;
  float v[ACT_BATCH][8];
  if (r0 < rp)
#pragma unroll
    for (int k = 0; k < ACT_BATCH; ++k)
      if (t0 + k * rp < T) load8(src + o0 + (size_t)k * rp * C, v[k]);
  gn_merge(part, b, G, S, FILM ? GN_ROWS : X_ROWS, T, cg, eps, s_mean, s_rstd);
  __syncthreads();
  if (r0 >= rp) return;
  const float* scb = FILM ? sc + (size_t)b * C : sc;
  const float* shb = FILM ? sh + (size_t)b * C : sh;
  float mul[8], add[8];  // GN and the affine as one multiply-add per channel
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int c = c8 * 8 + e, g = c / cg;
    const float rs = s_rstd[g];
    mul[e] = rs * scb[c];
    add[e] = shb[c] - s_mean[g] * mul[e];
  }
#pragma unroll
  for (int k = 0; k < ACT_BATCH; ++k) {
    if (t0 + k * rp >= T) break;
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      w[e] = pack_bf16(silu(fmaf(v[k][2 * e], mul[2 * e], add[2 * e])),
                       silu(fmaf(v[k][2 * e + 1], mul[2 * e + 1], add[2 * e + 1])));
    *reinterpret_cast<uint4*>(dst + o0 + (size_t)k * rp * C) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// ---------------------------------------------------------------- the GEMMs

constexpr int RB_BM = 128, RB_BN = 128, RB_BK = 64, RB_STAGES = 4;
constexpr int RB_CWG = 2;                      // consumer warpgroups, 64 rows each
constexpr int RB_THREADS = RB_CWG * 128 + 32;  // + one producer warp
constexpr uint32_t RB_A_BYTES = RB_BM * RB_BK * 2;  // 128 rows of 128 bytes
constexpr uint32_t RB_B_BYTES = RB_BK * RB_BN * 2;  // two [64 K][64 N] boxes
constexpr uint32_t RB_STAGE = RB_A_BYTES + RB_B_BYTES;
constexpr int RB_SMEM = RB_STAGES * RB_STAGE + 2 * RB_STAGES * 8 + 1024;  // + barriers, slack
constexpr int RB_CG = 16;  // channels per group the Dense epilogue's partials take
constexpr int RB_NG = RB_BN / RB_CG;

__device__ __forceinline__ void consumer_sync() {  // the consumer warpgroups only
  asm volatile("bar.sync 1, %0;\n" ::"n"(RB_CWG * 128) : "memory");
}

// MODE 1: dst (f32 h) = a1 @ w1 + bias, and the GroupNorm partials (mean,
//         M2) of h over this tile's rows for each of its RB_NG groups;
// MODE 2: dst (bf16) = resid + taps(a2) @ w3 + bias, w3 the (3C, C) conv
//         kernel, tap k of row t being a2 row t + k - 1.
// ta: the activation's (C, T, B) map, box 64 x 128 x 1; tw: the (in, out)
// weight's (C, rows) map, box 64 x 64; both 128-byte swizzled.
template <int MODE>
__global__ void __launch_bounds__(RB_THREADS, 1)
rb_wgmma_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tw,
                const float* __restrict__ bias, const bf16* __restrict__ resid,
                void* __restrict__ dst, float2* __restrict__ part, int T, int C, int G, int S) {
  extern __shared__ uint8_t rb_smem[];
  const uint32_t raw = smem_u32(rb_smem), base = (raw + 1023) & ~1023u;
  const uint32_t full0 = base + RB_STAGES * RB_STAGE, empty0 = full0 + 8 * RB_STAGES;
  const int m0 = blockIdx.x * RB_BM, n0 = blockIdx.y * RB_BN, b = blockIdx.z;
  const int kc = C / RB_BK, nk = MODE == 2 ? 3 * kc : kc;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    for (int s = 0; s < RB_STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, RB_CWG * 4);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == RB_CWG * 4) {  // the producer warp: one lane keeps the ring full
    if (lane == 0)
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % RB_STAGES;
        if (kt >= RB_STAGES) mbar_wait(empty0 + 8 * s, (kt / RB_STAGES - 1) & 1);
        const uint32_t sa = base + s * RB_STAGE, sb = sa + RB_A_BYTES, full = full0 + 8 * s;
        mbar_expect_tx(full, RB_STAGE);
        if (MODE == 1) {
          tma_load_3d(sa, &ta, full, kt * RB_BK, m0, b);
        } else {  // rows t - 1 and t + 1 past the batch's ends arrive as zeros
          const int tap = kt / kc;
          tma_load_3d(sa, &ta, full, (kt - tap * kc) * RB_BK, m0 + tap - 1, b);
        }
        tma_load_2d(sb, &tw, full, n0, kt * RB_BK);
        tma_load_2d(sb + RB_B_BYTES / 2, &tw, full, n0 + 64, kt * RB_BK);
      }
    return;
  }

  // consumers: warpgroup wg takes tile rows wg*64 .. wg*64 + 63
  const int wg = warp >> 2;
  float acc[64];  // (i = 4n + e): row wg*64 + (warp&3)*16 + g + 8(e>>1), column 8n + 2t4 + (e&1)
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % RB_STAGES;
    mbar_wait(full0 + 8 * s, (kt / RB_STAGES) & 1);
    const uint32_t sa = base + s * RB_STAGE + wg * (RB_A_BYTES / 2);
    const uint64_t da = wg_desc(sa, 16, 1024, 1);  // K-major: 8 rows of 128 bytes apart
    // MN-major: 8 K-rows 1024 bytes apart, the two 64-column spans 8 KB apart
    const uint64_t db = wg_desc(base + s * RB_STAGE + RB_A_BYTES, RB_B_BYTES / 2, 1024, 1);
    reg_fence(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < RB_BK / 16; ++kk)  // 16 K = 32 bytes along A's rows, 16 rows of B
      wgmma_n128_tb(acc, da + 2 * kk, db + ((kk * 16 * 128) >> 4));
    wg_commit();
    wg_wait_one();  // the previous stage's MMAs are done: release it
    reg_fence(acc);
    if (kt > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((kt - 1) % RB_STAGES));
  }
  wg_wait_all();
  reg_fence(acc);

  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = m0 + wg * 64 + (warp & 3) * 16 + g;  // this thread's rows r0, r0 + 8
  const bool ok0 = r0 < T, ok1 = r0 + 8 < T;
#pragma unroll
  for (int n = 0; n < RB_BN / 8; ++n) {
    const int c = n0 + 8 * n + 2 * t4;
    const float b0 = bias[c], b1 = bias[c + 1];
    acc[4 * n] += b0, acc[4 * n + 1] += b1, acc[4 * n + 2] += b0, acc[4 * n + 3] += b1;
  }
  if constexpr (MODE == 2) {
#pragma unroll
    for (int n = 0; n < RB_BN / 8; ++n) {
      const int c = n0 + 8 * n + 2 * t4;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (!(r ? ok1 : ok0)) continue;
        const size_t o = ((size_t)b * T + r0 + 8 * r) * C + c;
        const __nv_bfloat162 x2 = *reinterpret_cast<const __nv_bfloat162*>(resid + o);
        *reinterpret_cast<uint32_t*>(static_cast<bf16*>(dst) + o) =
            pack_bf16(__low2float(x2) + acc[4 * n + 2 * r],
                      __high2float(x2) + acc[4 * n + 2 * r + 1]);
      }
    }
  } else {
    static_assert(RB_CG == 16, "a group is two n8 blocks of the accumulator");
    __shared__ float red[RB_CWG * 4][RB_NG];
    __shared__ float s_gmean[RB_NG];
    float* h = static_cast<float*>(dst);
#pragma unroll
    for (int n = 0; n < RB_BN / 8; ++n) {
      const size_t o = ((size_t)b * T + r0) * C + n0 + 8 * n + 2 * t4;
      if (ok0) *reinterpret_cast<float2*>(h + o) = make_float2(acc[4 * n], acc[4 * n + 1]);
      if (ok1)
        *reinterpret_cast<float2*>(h + o + 8 * (size_t)C) =
            make_float2(acc[4 * n + 2], acc[4 * n + 3]);
    }
    // partials of the tile's rows < T: the mean first, then M2 about it
    const float cnt = (float)(min(RB_BM, T - m0) * RB_CG);
    float v[RB_NG];
#pragma unroll
    for (int j = 0; j < RB_NG; ++j) {
      v[j] = 0.f;
#pragma unroll
      for (int n = 2 * j; n < 2 * j + 2; ++n)
        v[j] += (ok0 ? acc[4 * n] + acc[4 * n + 1] : 0.f) +
                (ok1 ? acc[4 * n + 2] + acc[4 * n + 3] : 0.f);
      v[j] = warp_sum(v[j]);
    }
    if (lane == 0)
#pragma unroll
      for (int j = 0; j < RB_NG; ++j) red[warp][j] = v[j];
    consumer_sync();
    if (tid < RB_NG) {
      float sum = 0.f;
      for (int w = 0; w < RB_CWG * 4; ++w) sum += red[w][tid];
      s_gmean[tid] = sum / cnt;
    }
    consumer_sync();
#pragma unroll
    for (int j = 0; j < RB_NG; ++j) {
      const float mj = s_gmean[j];
      v[j] = 0.f;
#pragma unroll
      for (int n = 2 * j; n < 2 * j + 2; ++n) {
        const float d0 = acc[4 * n] - mj, d1 = acc[4 * n + 1] - mj;
        const float d2 = acc[4 * n + 2] - mj, d3 = acc[4 * n + 3] - mj;
        v[j] += (ok0 ? d0 * d0 + d1 * d1 : 0.f) + (ok1 ? d2 * d2 + d3 * d3 : 0.f);
      }
      v[j] = warp_sum(v[j]);
    }
    if (lane == 0)
#pragma unroll
      for (int j = 0; j < RB_NG; ++j) red[warp][j] = v[j];
    consumer_sync();
    if (tid < RB_NG) {
      float m2 = 0.f;
      for (int w = 0; w < RB_CWG * 4; ++w) m2 += red[w][tid];
      part[((size_t)b * G + n0 / RB_CG + tid) * S + blockIdx.x] = make_float2(s_gmean[tid], m2);
    }
  }
}

// ---------------------------------------------------------------- fused_gn_qkv

constexpr int QKV_STAGES = 4;
constexpr uint32_t QKV_ROW = RB_BN * 2 + 16;  // bytes of an epilogue staging row (padded)
constexpr uint32_t QKV_STAGING = 16 * QKV_ROW;  // a consumer warp's 16 rows
constexpr int QKV_SMEM = QKV_STAGES * RB_STAGE + 2 * QKV_STAGES * 8 +
                         RB_CWG * 4 * QKV_STAGING + 1024;  // + barriers, staging, slack

// Block b: GN(x)*g + b = x*mul + add per channel of batch b, merged once from
// x's S partials, as (B, C/2) float4 {mul_c, mul_c+1, add_c, add_c+1}.
__global__ void __launch_bounds__(GN_THREADS)
gn_table_kernel(const float2* __restrict__ part, const float* __restrict__ sc,
                const float* __restrict__ sh, float4* __restrict__ table, int T, int C, int G,
                int S, float eps) {
  __shared__ float s_mean[RB_MAX_G], s_rstd[RB_MAX_G];
  const int b = blockIdx.x, cg = C / G;
  gn_merge(part, b, G, S, X_ROWS, T, cg, eps, s_mean, s_rstd);
  __syncthreads();
  for (int p = threadIdx.x; p < C / 2; p += blockDim.x) {
    float m[2], a[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 2 * p + e, g = c / cg;
      m[e] = s_rstd[g] * sc[c];
      a[e] = sh[c] - s_mean[g] * m[e];
    }
    table[(size_t)b * (C / 2) + p] = make_float4(m[0], m[1], a[0], a[1]);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void stsm_x4(uint32_t addr, uint32_t r0, uint32_t r1, uint32_t r2,
                                        uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(r0), "r"(r1), "r"(r2), "r"(r3)
               : "memory");
}

// two bf16 of x (low: the even channel) times mul plus add, in f32, rounded
// to bf16 as JAX rounds the normalised x before the product
__device__ __forceinline__ uint32_t gn_affine(uint32_t x2, float m0, float m1, float a0,
                                              float a1) {
  return pack_bf16(fmaf(__uint_as_float(x2 << 16), m0, a0),
                   fmaf(__uint_as_float(x2 & 0xffff0000u), m1, a1));
}

// out (bf16, B x T x N) = bf16(x*mul + add) @ W + bias, W (C, N) as (in, out).
// A persistent grid: block i takes output tiles [i*per, (i+1)*per) of 128 x
// 128 (column tiles fastest, then row tiles, then batches). A producer warp
// keeps a 4-stage TMA ring full across the block's tiles with raw x (a box
// 64 x 128 x 1 of the (C, T, B) map: no tile reaches into the next batch;
// rows past T arrive as zeros) and two 64x64 boxes of W read MN-major. Two
// consumer warpgroups of 64 rows each build the A operand in registers:
// ldmatrix of the raw bf16 x from the swizzled tile, the GN affine of the
// tile's batch (staged from `table` in shared memory), rounded to bf16, then
// wgmma m64n128k16 with A from registers; the next k-step's A is built while
// this one's MMAs run. Epilogue: bias added, bf16 through stmatrix into a
// per-warp staging tile, 16-byte stores of rows < T.
__global__ void __launch_bounds__(RB_THREADS, 1)
gn_qkv_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
              const float4* __restrict__ table, const float* __restrict__ bias,
              bf16* __restrict__ dst, int T, int C, int N, int tiles, int per) {
  extern __shared__ uint8_t qkv_smem[];
  __shared__ float4 s_ma[RB_MAX_C / 2];  // the current batch's {mul, mul, add, add} pairs
  const uint32_t raw = smem_u32(qkv_smem), base = (raw + 1023) & ~1023u;
  const uint32_t full0 = base + QKV_STAGES * RB_STAGE, empty0 = full0 + 8 * QKV_STAGES;
  const uint32_t staging0 = empty0 + 8 * QKV_STAGES;
  const int kc = C / RB_BK, nt = N / RB_BN, mt = (T + RB_BM - 1) / RB_BM;
  const int t_begin = blockIdx.x * per, t_end = min(tiles, t_begin + per);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    for (int s = 0; s < QKV_STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, RB_CWG * 4);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == RB_CWG * 4) {  // the producer warp: one lane keeps the ring full
    if (lane == 0)
      for (int tile = t_begin, it = 0; tile < t_end; ++tile) {
        const int n0 = tile % nt * RB_BN, m0 = tile / nt % mt * RB_BM, b = tile / (nt * mt);
        for (int kt = 0; kt < kc; ++kt, ++it) {
          const int s = it % QKV_STAGES;
          if (it >= QKV_STAGES) mbar_wait(empty0 + 8 * s, (it / QKV_STAGES - 1) & 1);
          const uint32_t sa = base + s * RB_STAGE, sb = sa + RB_A_BYTES, full = full0 + 8 * s;
          mbar_expect_tx(full, RB_STAGE);
          tma_load_3d(sa, &tx, full, kt * RB_BK, m0, b);
          tma_load_2d(sb, &tw, full, n0, kt * RB_BK);
          tma_load_2d(sb + RB_B_BYTES / 2, &tw, full, n0 + 64, kt * RB_BK);
        }
      }
    return;
  }

  // consumers: warpgroup wg takes tile rows wg*64 .. wg*64 + 63, warp w4 16 of them
  const int wg = warp >> 2, w4 = warp & 3, t4 = lane & 3;
  // this lane's ldmatrix row of the tile, and the 8-column half of a k16 step
  const uint32_t a_row = (wg * 64 + w4 * 16 + (lane & 15)) * 128, a_half = lane >> 4;
  const uint32_t staging = staging0 + warp * QKV_STAGING;
  const uint8_t* staged = qkv_smem + (staging - raw);
  float acc[64];  // (i = 4n + e): row w4*16 + (lane>>2) + 8(e>>1), column 8n + 2t4 + (e&1)
  uint32_t a[2][RB_BK / 16][4];  // A of two k-steps: the one in flight, the next

  // A of k-step kt (ring stage s) into a[buf]: ldmatrix's four 8x8 blocks of
  // a k16 step are wgmma's register fragment a0..a3 (rows +0/+8, columns
  // +0/+8); the swizzle moves a row's 16-byte chunk q to q ^ (row & 7)
  auto build = [&](auto buf, int s, int kt) {
    const uint32_t sa = base + s * RB_STAGE + a_row;
#pragma unroll
    for (int kk = 0; kk < RB_BK / 16; ++kk) {
      uint32_t r[4];
      ldsm_x4(r, sa + (((2 * kk + a_half) ^ (lane & 7)) << 4));
      const int p = (kt * RB_BK + kk * 16) / 2 + t4;  // channels 2p, 2p+1 and 2p+8, 2p+9
      const float4 lo = s_ma[p], hi = s_ma[p + 4];
      uint32_t(&f)[4] = a[decltype(buf)::value][kk];
      f[0] = gn_affine(r[0], lo.x, lo.y, lo.z, lo.w);
      f[1] = gn_affine(r[1], lo.x, lo.y, lo.z, lo.w);
      f[2] = gn_affine(r[2], hi.x, hi.y, hi.z, hi.w);
      f[3] = gn_affine(r[3], hi.x, hi.y, hi.z, hi.w);
    }
  };
  using B0 = std::integral_constant<int, 0>;
  using B1 = std::integral_constant<int, 1>;

  int cur_b = -1;
  for (int tile = t_begin, it = 0; tile < t_end; ++tile, it += kc) {
    const int n0 = tile % nt * RB_BN, m0 = tile / nt % mt * RB_BM, b = tile / (nt * mt);
    if (b != cur_b) {  // stage batch b's affine
      consumer_sync();  // every consumer is done with the previous batch's
      for (int p = tid; p < C / 2; p += RB_CWG * 128) s_ma[p] = table[(size_t)b * (C / 2) + p];
      consumer_sync();
      cur_b = b;
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    mbar_wait(full0 + 8 * (it % QKV_STAGES), (it / QKV_STAGES) & 1);
    build(B0{}, it % QKV_STAGES, 0);
    // k-step kt: its MMAs from a[buf], then (while they run) the next A
    auto step = [&](auto buf, int kt) {
      const int j = it + kt, s = j % QKV_STAGES;
      // MN-major B: 8 K-rows 1024 bytes apart, the two 64-column spans 8 KB apart
      const uint64_t db = wg_desc(base + s * RB_STAGE + RB_A_BYTES, RB_B_BYTES / 2, 1024, 1);
#pragma unroll
      for (int kk = 0; kk < RB_BK / 16; ++kk) reg_fence(a[decltype(buf)::value][kk]);
      reg_fence(acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < RB_BK / 16; ++kk)
        wgmma_n128_rs_tb(acc, a[decltype(buf)::value][kk], db + ((kk * 16 * 128) >> 4));
      wg_commit();
      wg_wait_one();  // step kt-1's MMAs are done: its stage and A registers are free
      reg_fence(acc);
      if (kt > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((j - 1) % QKV_STAGES));
      if (kt + 1 < kc) {
        mbar_wait(full0 + 8 * ((j + 1) % QKV_STAGES), ((j + 1) / QKV_STAGES) & 1);
        build(std::integral_constant<int, 1 - decltype(buf)::value>{}, (j + 1) % QKV_STAGES,
              kt + 1);
      }
    };
    for (int kt = 0; kt < kc; kt += 2) {
      step(B0{}, kt);
      if (kt + 1 < kc) step(B1{}, kt + 1);
    }
    wg_wait_all();
    reg_fence(acc);
    if (lane == 0) mbar_arrive(empty0 + 8 * ((it + kc - 1) % QKV_STAGES));

    // epilogue: + bias, bf16, stmatrix of the warp's 16 x 128 into its
    // staging rows (x4: blocks n and n+1, rows +0 and +8), then 16 bytes a
    // lane per store, two full 256-byte rows a warp
#pragma unroll
    for (int n = 0; n < RB_BN / 8; n += 2) {
      const float2 b0 = *reinterpret_cast<const float2*>(bias + n0 + 8 * n + 2 * t4);
      const float2 b1 = *reinterpret_cast<const float2*>(bias + n0 + 8 * n + 8 + 2 * t4);
      const float* c0 = acc + 4 * n;
      stsm_x4(staging + (lane & 7) * QKV_ROW + ((lane >> 3) & 1) * 8 * QKV_ROW +
                  (n + (lane >> 4)) * 16,
              pack_bf16(c0[0] + b0.x, c0[1] + b0.y), pack_bf16(c0[2] + b0.x, c0[3] + b0.y),
              pack_bf16(c0[4] + b1.x, c0[5] + b1.y), pack_bf16(c0[6] + b1.x, c0[7] + b1.y));
    }
    __syncwarp();
    const int row0 = m0 + wg * 64 + w4 * 16;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int r = 2 * k + (lane >> 4), chunk = lane & 15;
      const uint4 v = *reinterpret_cast<const uint4*>(staged + r * QKV_ROW + chunk * 16);
      if (row0 + r < T)
        *reinterpret_cast<uint4*>(dst + ((size_t)b * T + row0 + r) * N + n0 + chunk * 8) = v;
    }
    __syncwarp();  // the staging rows are read before the next tile's stmatrix
  }
}

// ---------------------------------------------------------------- host

// shapes the statistics and activation passes take
static bool gn_shapes_ok(int C, int G) {
  return C % G == 0 && (C / G) % 8 == 0 && C <= RB_MAX_C && G <= RB_MAX_G;
}

// act1 and act2 (bf16, B x T x C) hold a1 and a2; part1 (B, G, ceil(T/32))
// and part2 (B, G, ceil(T/128)) float2 the partials of x and of h
extern "C" int ttts_resblock(const void* x, const void* g1, const void* b1, const void* w1,
                             const void* bd1, const void* a2, const void* b2, const void* w3,
                             const void* bc3, void* out, void* h, void* act1, void* act2,
                             void* part1, void* part2, int B, int T, int C, int G, float eps,
                             void* stream) {
  if (C % RB_BN || C / G != RB_CG || !gn_shapes_ok(C, G)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = TTTS_STREAM(stream);
  const int S = (T + GN_ROWS - 1) / GN_ROWS;

  CUtensorMap ta1, ta3, tw1, tw3;
  const cuuint64_t act_strides[2] = {(cuuint64_t)C * 2, (cuuint64_t)T * C * 2};
  const cuuint32_t act_box[3] = {RB_BK, RB_BM, 1}, w_box[2] = {64, RB_BK};
  const cuuint64_t dense_dims[3] = {(cuuint64_t)C, (cuuint64_t)T, (cuuint64_t)B};
  // conv3's taps: rows -1 and T of a batch lie outside this (C, T, B) map
  // and arrive as zeros, the 'SAME' padding of each batch
  const cuuint64_t conv_dims[3] = {(cuuint64_t)C, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t w1_dims[2] = {(cuuint64_t)C, (cuuint64_t)C};
  const cuuint64_t w3_dims[2] = {(cuuint64_t)C, (cuuint64_t)3 * C};
  const cuuint64_t w_strides[1] = {(cuuint64_t)C * 2};
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  if (!bf16_map(&ta1, act1, 3, dense_dims, act_strides, act_box, sw) ||
      !bf16_map(&ta3, act2, 3, conv_dims, act_strides, act_box, sw) ||
      !bf16_map(&tw1, w1, 2, w1_dims, w_strides, w_box, sw) ||
      !bf16_map(&tw3, w3, 2, w3_dims, w_strides, w_box, sw))
    return (int)cudaErrorInvalidValue;
  static const cudaError_t attr = [] {  // once: above 48 KB of dynamic shared memory
    const cudaError_t e = cudaFuncSetAttribute(
        rb_wgmma_kernel<1>, cudaFuncAttributeMaxDynamicSharedMemorySize, RB_SMEM);
    return e != cudaSuccess ? e
                            : cudaFuncSetAttribute(rb_wgmma_kernel<2>,
                                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                   RB_SMEM);
  }();
  if (attr != cudaSuccess) return (int)attr;

  const int act_rows = ACT_BATCH * (ACT_THREADS / (C / 8));  // rows per activation block
  const int SX = (T + X_ROWS - 1) / X_ROWS;  // partials of x
  const dim3 sgrid(SX, B), agrid((T + act_rows - 1) / act_rows, B), ggrid(S, C / RB_BN, B);
  float2* p1 = static_cast<float2*>(part1);
  float2* p2 = static_cast<float2*>(part2);
  gn_stats_kernel<<<sgrid, GN_THREADS, 0, st>>>(static_cast<const bf16*>(x), p1, T, C, G, SX);
  gn_act_kernel<bf16, false><<<agrid, ACT_THREADS, 0, st>>>(
      static_cast<const bf16*>(x), p1, static_cast<const float*>(g1),
      static_cast<const float*>(b1), static_cast<bf16*>(act1), T, C, G, SX, eps);
  rb_wgmma_kernel<1><<<ggrid, RB_THREADS, RB_SMEM, st>>>(
      ta1, tw1, static_cast<const float*>(bd1), nullptr, h, p2, T, C, G, S);
  gn_act_kernel<float, true><<<agrid, ACT_THREADS, 0, st>>>(
      static_cast<const float*>(h), p2, static_cast<const float*>(a2),
      static_cast<const float*>(b2), static_cast<bf16*>(act2), T, C, G, S, eps);
  rb_wgmma_kernel<2><<<ggrid, RB_THREADS, RB_SMEM, st>>>(
      ta3, tw3, static_cast<const float*>(bc3), static_cast<const bf16*>(x), out, nullptr, T, C,
      G, S);
  return (int)cudaGetLastError();
}

extern "C" int ttts_gn_qkv(const void* x, const void* g, const void* b, const void* w,
                           const void* bias, void* out, void* part, void* table, int B,
                           int Tlen, int C, int N, int G, float eps, void* stream) {
  if (C % RB_BK || N % RB_BN || !gn_shapes_ok(C, G)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = TTTS_STREAM(stream);
  const int S = (Tlen + X_ROWS - 1) / X_ROWS;
  CUtensorMap tx, tw;
  const cuuint64_t x_dims[3] = {(cuuint64_t)C, (cuuint64_t)Tlen, (cuuint64_t)B};
  const cuuint64_t x_strides[2] = {(cuuint64_t)C * 2, (cuuint64_t)Tlen * C * 2};
  const cuuint64_t w_dims[2] = {(cuuint64_t)N, (cuuint64_t)C};
  const cuuint64_t w_strides[1] = {(cuuint64_t)N * 2};
  const cuuint32_t x_box[3] = {RB_BK, RB_BM, 1}, w_box[2] = {64, RB_BK};
  if (!bf16_map(&tx, x, 3, x_dims, x_strides, x_box, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !bf16_map(&tw, w, 2, w_dims, w_strides, w_box, CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      gn_qkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, QKV_SMEM);
  if (attr != cudaSuccess) return (int)attr;
  static const int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n > 0 ? n : 132;
  }();
  const int tiles = B * ((Tlen + RB_BM - 1) / RB_BM) * (N / RB_BN);
  const int per = (tiles + sms - 1) / sms;  // tiles a block: the grid is one wave
  float2* p = static_cast<float2*>(part);
  float4* tab = static_cast<float4*>(table);
  gn_stats_kernel<<<dim3(S, B), GN_THREADS, 0, st>>>(static_cast<const bf16*>(x), p, Tlen, C, G,
                                                     S);
  gn_table_kernel<<<B, GN_THREADS, 0, st>>>(p, static_cast<const float*>(g),
                                            static_cast<const float*>(b), tab, Tlen, C, G, S,
                                            eps);
  gn_qkv_kernel<<<(tiles + per - 1) / per, RB_THREADS, QKV_SMEM, st>>>(
      tx, tw, tab, static_cast<const float*>(bias), static_cast<bf16*>(out), Tlen, C, N, tiles,
      per);
  return (int)cudaGetLastError();
}
