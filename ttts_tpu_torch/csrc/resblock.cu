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
// f32 statistics, the normalised x rounded to bf16 for the product: the same
// statistics pass as step 1, then gn_qkv_kernel, an mma.sync GEMM whose
// A-tile prologue applies the GN affine, with the bias in the epilogue. At
// the trunk's (B=2, T=1600, C=512) that is 5.0 GFLOP against ~16 MB of
// traffic: bound by the tensor cores (~5 us), where the TPU kernel re-paid
// the statistics for each of its three column blocks.
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

constexpr int QKV_BM = 64, QKV_BN = 128, QKV_BK = 32, QKV_THREADS = 128;
constexpr int QKV_LDA = QKV_BK + 8;  // padded rows: conflict-free ldmatrix
constexpr int QKV_LDB = QKV_BN + 8;

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// out (bf16) = (GN(x)*g + b) @ W + bias: W (C, N) row-major, (in, out) as in
// the flax layout. 64x128 block tiles, four warps of 32x64 on mma.sync fed
// by ldmatrix from double-buffered shared-memory tiles; the A-tile prologue
// applies the GN affine as one multiply-add per channel.
__global__ void __launch_bounds__(QKV_THREADS)
gn_qkv_kernel(const bf16* __restrict__ x, const float2* __restrict__ part,
              const float* __restrict__ sc, const float* __restrict__ sh,
              const bf16* __restrict__ W, const float* __restrict__ bias, bf16* __restrict__ dst,
              int Tlen, int C, int N, int G, int S, float eps) {
  __shared__ __align__(16) bf16 As[2][QKV_BM * QKV_LDA];
  __shared__ __align__(16) bf16 Bs[2][QKV_BK * QKV_LDB];
  __shared__ float s_mul[RB_MAX_C], s_add[RB_MAX_C];
  __shared__ float s_mean[RB_MAX_G], s_rstd[RB_MAX_G];

  const int m0 = blockIdx.x * QKV_BM, n0 = blockIdx.y * QKV_BN, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 64;
  const int cg = C / G;

  // GroupNorm x affine as one per-channel multiply-add
  gn_merge(part, b, G, S, X_ROWS, Tlen, cg, eps, s_mean, s_rstd);
  __syncthreads();
  for (int c = tid; c < C; c += QKV_THREADS) {
    const int g = c / cg;
    const float mul = s_rstd[g] * sc[c];
    s_mul[c] = mul;
    s_add[c] = sh[c] - s_mean[g] * mul;
  }
  __syncthreads();

  // A loader: thread -> (row ar, 16 consecutive k from ak0)
  const int ar = tid >> 1, ak0 = (tid & 1) * 16;
  const int at = m0 + ar;
  const bool aok = at < Tlen;
  auto load_a = [&](int k0, uint4 (&raw)[2]) {
    if (aok) {
      const uint4* p = reinterpret_cast<const uint4*>(x + ((size_t)b * Tlen + at) * C + k0 + ak0);
      raw[0] = p[0];
      raw[1] = p[1];
    }
  };
  auto store_a = [&](int buf, int k0, const uint4 (&raw)[2]) {
    const bf16* e = reinterpret_cast<const bf16*>(raw);
    const int c0 = k0 + ak0;
    uint32_t w[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float lo = 0.f, hi = 0.f;  // rows past T stay zero
      if (aok) {
        lo = fmaf(__bfloat162float(e[2 * i]), s_mul[c0 + 2 * i], s_add[c0 + 2 * i]);
        hi = fmaf(__bfloat162float(e[2 * i + 1]), s_mul[c0 + 2 * i + 1], s_add[c0 + 2 * i + 1]);
      }
      w[i] = pack_bf16(lo, hi);
    }
    uint4* d = reinterpret_cast<uint4*>(&As[buf][ar * QKV_LDA + ak0]);
    d[0] = make_uint4(w[0], w[1], w[2], w[3]);
    d[1] = make_uint4(w[4], w[5], w[6], w[7]);
  };
  // B loader: 32 x 128 bf16 = 512 x 16 bytes, 4 per thread
  auto load_b = [&](int k0, uint4 (&raw)[4]) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = tid + j * QKV_THREADS, kk = i >> 4, ch = i & 15;
      raw[j] = *reinterpret_cast<const uint4*>(W + (size_t)(k0 + kk) * N + n0 + ch * 8);
    }
  };
  auto store_b = [&](int buf, const uint4 (&raw)[4]) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = tid + j * QKV_THREADS, kk = i >> 4, ch = i & 15;
      *reinterpret_cast<uint4*>(&Bs[buf][kk * QKV_LDB + ch * 8]) = raw[j];
    }
  };

  float acc[2][8][4] = {};
  uint4 araw[2] = {}, braw[4];
  load_a(0, araw);
  load_b(0, braw);
  store_a(0, 0, araw);
  store_b(0, braw);
  __syncthreads();

  const int nk = C / QKV_BK;
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) {  // next tile's global loads fly during this tile's MMAs
      load_a((kt + 1) * QKV_BK, araw);
      load_b((kt + 1) * QKV_BK, braw);
    }
#pragma unroll
    for (int ks = 0; ks < QKV_BK; ks += 16) {
      uint32_t fa[2][4], fb[4][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldsm_x4(fa[i], &As[buf][(wm + i * 16 + (lane & 15)) * QKV_LDA + ks + (lane >> 4) * 8]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ldsm_x4_trans(fb[j],
                      &Bs[buf][(ks + (lane & 15)) * QKV_LDB + wn + j * 16 + (lane >> 4) * 8]);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          mma_16816(acc[i][2 * j], fa[i], fb[j][0], fb[j][1]);
          mma_16816(acc[i][2 * j + 1], fa[i], fb[j][2], fb[j][3]);
        }
    }
    if (kt + 1 < nk) {
      store_a(buf ^ 1, (kt + 1) * QKV_BK, araw);
      store_b(buf ^ 1, braw);
    }
    __syncthreads();
  }

  const int g8 = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = m0 + wm + i * 16 + g8 + r * 8;
      if (t >= Tlen) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = n0 + wn + j * 8 + 2 * t4;
        const size_t o = ((size_t)b * Tlen + t) * N + c;
        *reinterpret_cast<uint32_t*>(dst + o) =
            pack_bf16(acc[i][j][2 * r] + bias[c], acc[i][j][2 * r + 1] + bias[c + 1]);
      }
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
                           const void* bias, void* out, void* part, int B, int Tlen, int C,
                           int N, int G, float eps, void* stream) {
  if (C % QKV_BK || N % QKV_BN || !gn_shapes_ok(C, G)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = TTTS_STREAM(stream);
  const int S = (Tlen + X_ROWS - 1) / X_ROWS;
  gn_stats_kernel<<<dim3(S, B), GN_THREADS, 0, st>>>(static_cast<const bf16*>(x),
                                                     static_cast<float2*>(part), Tlen, C, G, S);
  gn_qkv_kernel<<<dim3((Tlen + QKV_BM - 1) / QKV_BM, N / QKV_BN, B), QKV_THREADS, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<const float2*>(part),
      static_cast<const float*>(g), static_cast<const float*>(b), static_cast<const bf16*>(w),
      static_cast<const float*>(bias), static_cast<bf16*>(out), Tlen, C, N, G, S, eps);
  return (int)cudaGetLastError();
}
