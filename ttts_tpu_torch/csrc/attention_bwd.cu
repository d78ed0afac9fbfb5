// Flash attention, causal backward: dQ, dK and dV of
// O = softmax(q.k^T / sqrt(D), causal).v over (B, T, H, D), from q, k, v,
// the forward's output O and its rows' log2-sum-exp2 (attention.cu's causal
// mode with an lse buffer), and dO.
//
// Replaces the backward half of the library kernel behind
// ttts_tpu/models/gpt.py _flash_causal_attention (the GPT's long-context
// training route): jax.experimental.pallas.ops.tpu.flash_attention
// _flash_attention_bwd_dkv (pallas_call :1121) and _flash_attention_bwd_dq
// (pallas_call :1456). Split as the library splits it, into two kernels
// launched in turn on one stream, with no atomics, so that a training step
// repeats bit for bit:
//   flash_bwd_dq_sm90, one block per (64-query tile, head, batch). Its
//     prologue computes di = rowsum(dO * O) of its rows (the library's di,
//     which it computes in XLA outside its kernels) and stores it for the
//     second kernel. It then walks the key tiles at or before the diagonal:
//       S = qs.K^T, P = exp2(log2(e) S - lse2), dP = dO.V^T,
//       dS = P * (dP - di), dQ += dS.K;   dq = dQ / sqrt(D) at the end;
//   flash_bwd_dkv_sm90, one block per (64-key tile, head, batch), walking
//     the query tiles at or past the diagonal:
//       S^T = K.qs^T, P^T = exp2(log2(e) S^T - lse2), dV += P^T.dO,
//       dP^T = V.dO^T, dS^T = P^T * (dP^T - di), dK += dS^T.qs.
// qs = bf16(q / sqrt(D)), the forward's scaled q, so P is the forward's
// softmax to f32 rounding and the scale enters dK through qs and dq once
// at the end. Keys j > i of the diagonal tile and rows past T get P = 0;
// the masked scores never reach an exponential, so no row can turn to NaN
// (a causal row always keeps its own key). Any T works: TMA zero-fills the
// rows of a tile past T and the stores stop at T.
//
// What bounds it on the H100: at the GPT's reference context (B=64,
// T=1796, H=8, D=64) the causal pairs number 8.26e8; the five products a
// pair needs (S, dP, dV, dQ, dK) are 5.3e11 flop, 0.53 ms at the bf16 peak,
// its ~0.95 GB of traffic 0.28 ms, and one exp2 a pair 0.2 ms of the SFUs:
// bound by the tensor cores. This first design recomputes S and P in both
// kernels (six products and two exp2 a pair) and waits on each wgmma group
// before its softmax, so the MMAs and the exponentials do not overlap.
//
// Design, as attention.cu's forward: one warpgroup (128 threads) a block;
// the 64 rows of each wgmma are the block's own tile (queries in dQ, keys
// in dK/dV), its resident tiles arrive once by TMA, the walked tiles
// through a two-stage mbarrier ring (tile i+1 requested before tile i's
// MMAs). Products whose B operand is a (token, d) tile (dQ += dS.K,
// dV += P^T.dO, dK += dS^T.qs) take it MN-major through the descriptor's
// transpose bit, with the left operand packed to bf16 in registers from the
// accumulator, as the forward's P.V: nothing is transposed in memory. The
// walked tile's lse2 and di (64 floats each) are staged in shared memory one
// tile ahead.
#include "common.cuh"

constexpr int FB_TILE = 64;  // queries or keys a tile
constexpr int FB_THREADS = 128;

// six 64-row tiles (each 1024-byte aligned), three mbarriers (32 bytes),
// 256 floats of row statistics, alignment slack
template <int D>
constexpr int fb_smem_bytes() {
  return 6 * FB_TILE * D * 2 + 32 + 256 * 4 + 1024;
}

// this thread's accumulator element e of n8 block n: row row0 + 8 (e >> 1),
// column 8n + 2 t4 + (e & 1) (wgmma's f32 C layout)
#define FB_COL(n, e) ((n) * 8 + 2 * t4 + ((e) & 1))
#define FB_ROW(e) (row0 + ((e) >> 1) * 8)

// acc (64xD) += a (64x64, bf16 fragments) . the (64 tokens x D) tile at
// smem address `tile`, read MN-major
template <int D>
__device__ __forceinline__ void fb_acc_tile(float (&acc)[D / 2], uint32_t (&a)[4][4],
                                            uint32_t tile) {
  constexpr uint32_t ROW = D * 2, LAYOUT = D == 64 ? 1 : 2;
  const uint64_t desc = wg_desc(tile, FB_TILE * ROW, 8 * ROW, LAYOUT);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) reg_fence(a[kk]);
  reg_fence(acc);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_pv<D>(acc, a[kk], desc + ((kk * 16 * ROW) >> 4));
  wg_commit();
  wg_wait_all();
  reg_fence(acc);
}

// s = a.b^T and t = c.d^T, each (64 x 64) over D, all four tiles K-major
// in shared memory
template <int D>
__device__ __forceinline__ void fb_two_products(float (&s)[32], float (&t)[32], uint32_t a,
                                                uint32_t b, uint32_t c, uint32_t d) {
  constexpr uint32_t SBO = 8 * D * 2, LAYOUT = D == 64 ? 1 : 2;
  const uint64_t da = wg_desc(a, 16, SBO, LAYOUT), db = wg_desc(b, 16, SBO, LAYOUT);
  const uint64_t dc = wg_desc(c, 16, SBO, LAYOUT), dd = wg_desc(d, 16, SBO, LAYOUT);
  reg_fence(s);
  reg_fence(t);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) wgmma_s(s, da + 2 * kk, db + 2 * kk, kk);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) wgmma_s(t, dc + 2 * kk, dd + 2 * kk, kk);
  wg_commit();
  wg_wait_all();
  reg_fence(s);
  reg_fence(t);
}

template <int D>
__global__ void __launch_bounds__(FB_THREADS)
flash_bwd_dq_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                  const bf16* __restrict__ o, const bf16* __restrict__ dout,
                  const float* __restrict__ lse, float* __restrict__ di, bf16* __restrict__ dq,
                  int g_st, int T, int H, float scale) {
  constexpr uint32_t TILE = FB_TILE * D * 2;
  extern __shared__ uint8_t fb_smem[];
  const uint32_t raw = smem_u32(fb_smem), base = (raw + 1023) & ~1023u;
  uint8_t* tiles = fb_smem + (base - raw);
  const uint32_t sq = base, sdo = base + TILE, sk = base + 2 * TILE, sv = base + 4 * TILE;
  const uint32_t bar_q = base + 6 * TILE, bar_kv = bar_q + 8;  // + 8 * stage
  float* di_s = reinterpret_cast<float*>(tiles + 6 * TILE + 32);

  const int q0 = blockIdx.x * FB_TILE, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t4 = lane & 3, row0 = warp * 16 + (lane >> 2);
  // key tiles at or before the diagonal
  const int n_tiles = (min(T, q0 + FB_TILE) + FB_TILE - 1) / FB_TILE;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    mbar_init(bar_kv, 1);
    mbar_init(bar_kv + 8, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_q, 2 * TILE);
    tma_load_4d(sq, &tq, bar_q, 0, h, q0, b);
    tma_load_4d(sdo, &tdo, bar_q, 0, h, q0, b);
    mbar_expect_tx(bar_kv, 2 * TILE);
    tma_load_4d(sk, &tk, bar_kv, 0, h, 0, b);
    tma_load_4d(sv, &tv, bar_kv, 0, h, 0, b);
  }
  {  // di = rowsum(dO * O) of this block's rows, two threads a row
    const int r = tid >> 1, t = q0 + r;
    float acc = 0.f;
    if (t < T) {
      const size_t off = ((size_t)(b * T + t) * H + h) * D + (tid & 1) * (D / 2);
#pragma unroll
      for (int x = 0; x < D / 2; x += 8) {
        uint4 ov = *reinterpret_cast<const uint4*>(o + off + x);
        uint4 dv = *reinterpret_cast<const uint4*>(dout + off + x);
        const bf16* oe = reinterpret_cast<const bf16*>(&ov);
        const bf16* de = reinterpret_cast<const bf16*>(&dv);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc = fmaf(to_f(oe[e]), to_f(de[e]), acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if ((tid & 1) == 0) {
      di_s[r] = acc;
      if (t < T) di[((size_t)b * H + h) * T + t] = acc;
    }
  }
  mbar_wait(bar_q, 0);
  scale_tile_bf16<FB_TILE * D / 8, FB_THREADS>(tiles, scale);  // q -> qs, as the forward
  __syncthreads();                 // (and di_s is complete)

  float lse_r[2], di_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = q0 + row0 + r * 8;
    lse_r[r] = t < T ? lse[((size_t)b * H + h) * T + t] : 0.f;
    di_r[r] = di_s[row0 + r * 8];
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1, k0 = it * FB_TILE;
    if (tid == 0 && it + 1 < n_tiles) {  // tile it+1 into the stage freed at it-1's end
      const uint32_t bar = bar_kv + 8 * (stage ^ 1);
      mbar_expect_tx(bar, 2 * TILE);
      tma_load_4d(sk + (stage ^ 1) * TILE, &tk, bar, 0, h, k0 + FB_TILE, b);
      tma_load_4d(sv + (stage ^ 1) * TILE, &tv, bar, 0, h, k0 + FB_TILE, b);
    }
    mbar_wait(bar_kv + 8 * stage, (it >> 1) & 1);
    float s[32], dp[32];
    fb_two_products<D>(s, dp, sq, sk + stage * TILE, sdo, sv + stage * TILE);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = FB_COL(n, e), i = FB_ROW(e), x = 4 * n + e;
        // key j of the diagonal tile past query i, or a key past T
        const bool keep = k0 + j < T && !(k0 == q0 && j > i);
        const float p = keep ? exp2f(fmaf(s[x], LOG2E, -lse_r[e >> 1])) : 0.f;
        s[x] = p * (dp[x] - di_r[e >> 1]);  // dS
      }
    uint32_t a[4][4];
    pack_a_frags(s, a);
    fb_acc_tile<D>(acc, a, sk + stage * TILE);  // dQ += dS.K
    __syncthreads();  // every warp's MMAs of this stage are done: it may be refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = q0 + row0 + r * 8;
    if (t < T) {
      bf16* row = dq + (size_t)(b * T + t) * g_st + h * D + 2 * t4;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<uint32_t*>(row + n * 8) =
            pack_bf16(acc[4 * n + 2 * r] * scale, acc[4 * n + 2 * r + 1] * scale);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(FB_THREADS)
flash_bwd_dkv_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                   const float* __restrict__ lse, const float* __restrict__ di,
                   bf16* __restrict__ dk, bf16* __restrict__ dv, int g_st, int T, int H,
                   float scale) {
  constexpr uint32_t TILE = FB_TILE * D * 2;
  extern __shared__ uint8_t fb_smem[];
  const uint32_t raw = smem_u32(fb_smem), base = (raw + 1023) & ~1023u;
  uint8_t* tiles = fb_smem + (base - raw);
  const uint32_t sk = base, sv = base + TILE, sq = base + 2 * TILE, sdo = base + 4 * TILE;
  const uint32_t bar_kv = base + 6 * TILE, bar_q = bar_kv + 8;  // + 8 * stage
  // per stage: lse2 of the walked tile's 64 queries, then their di
  float* stats = reinterpret_cast<float*>(tiles + 6 * TILE + 32);

  const int k0 = blockIdx.x * FB_TILE, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t4 = lane & 3, row0 = warp * 16 + (lane >> 2);
  // query tiles at or past the diagonal
  const int n_tiles = (T + FB_TILE - 1) / FB_TILE - (int)blockIdx.x;
  const size_t bh = ((size_t)b * H + h) * T;
  auto stage_stats = [&](int buf, int q0) {  // one float a thread
    const int t = q0 + (tid & 63);
    stats[buf * 128 + tid] = t < T ? (tid < 64 ? lse : di)[bh + t] : 0.f;
  };

  if (tid == 0) {
    mbar_init(bar_kv, 1);
    mbar_init(bar_q, 1);
    mbar_init(bar_q + 8, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_kv, 2 * TILE);
    tma_load_4d(sk, &tk, bar_kv, 0, h, k0, b);
    tma_load_4d(sv, &tv, bar_kv, 0, h, k0, b);
    mbar_expect_tx(bar_q, 2 * TILE);
    tma_load_4d(sq, &tq, bar_q, 0, h, k0, b);
    tma_load_4d(sdo, &tdo, bar_q, 0, h, k0, b);
  }
  stage_stats(0, k0);
  mbar_wait(bar_kv, 0);

  float acc_k[D / 2], acc_v[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1, q0 = k0 + it * FB_TILE;
    if (it + 1 < n_tiles) {  // tile it+1 into the stage freed at it-1's end
      if (tid == 0) {
        const uint32_t bar = bar_q + 8 * (stage ^ 1);
        mbar_expect_tx(bar, 2 * TILE);
        tma_load_4d(sq + (stage ^ 1) * TILE, &tq, bar, 0, h, q0 + FB_TILE, b);
        tma_load_4d(sdo + (stage ^ 1) * TILE, &tdo, bar, 0, h, q0 + FB_TILE, b);
      }
      stage_stats(stage ^ 1, q0 + FB_TILE);
    }
    mbar_wait(bar_q + 8 * stage, (it >> 1) & 1);
    scale_tile_bf16<FB_TILE * D / 8, FB_THREADS>(tiles + (2 + stage) * TILE, scale);
    __syncthreads();  // (the stage's statistics, stored one tile ago, are visible)
    float s[32], dp[32];
    fb_two_products<D>(s, dp, sk, sq + stage * TILE, sv, sdo + stage * TILE);
    const float* lse_s = stats + stage * 128;
    const float* di_s = lse_s + 64;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = FB_COL(n, e), i = FB_ROW(e), x = 4 * n + e;
        // query j of the diagonal tile before key i, or a query past T
        const bool keep = q0 + j < T && !(it == 0 && j < i);
        const float p = keep ? exp2f(fmaf(s[x], LOG2E, -lse_s[j])) : 0.f;
        s[x] = p;                           // P^T
        dp[x] = p * (dp[x] - di_s[j]);      // dS^T
      }
    uint32_t a[4][4];
    pack_a_frags(s, a);
    fb_acc_tile<D>(acc_v, a, sdo + stage * TILE);  // dV += P^T.dO
    pack_a_frags(dp, a);
    fb_acc_tile<D>(acc_k, a, sq + stage * TILE);   // dK += dS^T.qs
    __syncthreads();  // every warp's MMAs of this stage are done: it may be refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = k0 + row0 + r * 8;
    if (t < T) {
      const size_t off = (size_t)(b * T + t) * g_st + h * D + 2 * t4;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        *reinterpret_cast<uint32_t*>(dk + off + n * 8) =
            pack_bf16(acc_k[4 * n + 2 * r], acc_k[4 * n + 2 * r + 1]);
        *reinterpret_cast<uint32_t*>(dv + off + n * 8) =
            pack_bf16(acc_v[4 * n + 2 * r], acc_v[4 * n + 2 * r + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------- host

template <int D>
static int bwd_dispatch(const void* q, const void* k, const void* v, const void* o,
                        const void* dout, const float* lse, float* di, bf16* dq, bf16* dk,
                        bf16* dv, int B, int T, int H, const int (&st)[6], int g_st, float scale,
                        void* stream) {
  CUtensorMap tq, tk, tv, tdo;
  if (!attn_tile_map<D>(&tq, q, B, T, H, st[0], st[1]) ||
      !attn_tile_map<D>(&tk, k, B, T, H, st[2], st[3]) ||
      !attn_tile_map<D>(&tv, v, B, T, H, st[4], st[5]) ||
      !attn_tile_map<D>(&tdo, dout, B, T, H, H * D, D))
    return (int)cudaErrorInvalidValue;
  constexpr int smem = fb_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_sm90<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dkv_sm90<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + FB_TILE - 1) / FB_TILE, H, B);
  flash_bwd_dq_sm90<D><<<grid, FB_THREADS, smem, TTTS_STREAM(stream)>>>(
      tq, tk, tv, tdo, static_cast<const bf16*>(o), static_cast<const bf16*>(dout), lse, di, dq,
      g_st, T, H, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // di, written by the first kernel, is read by the second on the same stream
  flash_bwd_dkv_sm90<D><<<grid, FB_THREADS, smem, TTTS_STREAM(stream)>>>(
      tq, tk, tv, tdo, lse, di, dk, dv, g_st, T, H, scale);
  return (int)cudaGetLastError();
}

// q, k, v: (B, T, H, D) bf16 views with token / head strides q_st, q_sh,
// ... (elements); o and dout contiguous (B, T, H, D) bf16; lse the
// forward's contiguous f32 (B, H, T) log2-sum-exp2; di an f32 (B, H, T)
// scratch; dq, dk, dv (B, T, H, D) bf16 outputs with token stride g_st and
// head stride D (the three column blocks of one (B, T, 3 H D) gradient)
extern "C" int ttts_flash_causal_backward(const void* q, const void* k, const void* v,
                                          const void* o, const void* dout, const void* lse,
                                          void* di, void* dq, void* dk, void* dv, int B, int T,
                                          int H, int D, int q_st, int q_sh, int k_st, int k_sh,
                                          int v_st, int v_sh, int g_st, float scale,
                                          void* stream) {
  const int st[6] = {q_st, q_sh, k_st, k_sh, v_st, v_sh};
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(di);
  bf16 *gq = static_cast<bf16*>(dq), *gk = static_cast<bf16*>(dk), *gv = static_cast<bf16*>(dv);
  if (D == 32)
    return bwd_dispatch<32>(q, k, v, o, dout, l, d, gq, gk, gv, B, T, H, st, g_st, scale,
                            stream);
  if (D == 64)
    return bwd_dispatch<64>(q, k, v, o, dout, l, d, gq, gk, gv, B, T, H, st, g_st, scale,
                            stream);
  return (int)cudaErrorInvalidValue;
}
