// Flash attention, causal backward: dQ, dK and dV of
// O = softmax(q.k^T / sqrt(D), causal).v over (B, T, H, D), from q, k, v,
// the forward's output O and its rows' log2-sum-exp2 (attention.cu's causal
// mode with an lse buffer), and dO.
//
// Replaces the backward half of the library kernel behind
// ttts_tpu/models/gpt.py _flash_causal_attention (the GPT's long-context
// training route): jax.experimental.pallas.ops.tpu.flash_attention
// _flash_attention_bwd_dkv (pallas_call :1121) and _flash_attention_bwd_dq
// (pallas_call :1456), with the di the library computes in XLA. Split as
// the library splits it, into two kernels launched in turn on one stream,
// with no atomics, so that a training step repeats bit for bit:
//   flash_bwd_dq_sm90, one block per (192-query tile, head, batch). Its
//     prologue computes di = rowsum(dO * O) of its rows and stores it for
//     the second kernel. It then walks the 64-key tiles at or before the
//     diagonal:
//       S = q.K^T, P = exp2(c S - lse2), dP = dO.V^T,
//       dS = P * (dP - di), dQ += dS.K;   dq = dQ / sqrt(D) at the end;
//   flash_bwd_dkv_sm90, one block per (128-key tile, head, batch), walking
//     the 64-query tiles at or past the diagonal:
//       S^T = K.q^T, P^T = exp2(c S^T - lse2), dV += P^T.dO,
//       dP^T = V.dO^T, dS^T = P^T * (dP^T - di), dK += dS^T.q.
// The scores are the forward's, q scaled by 1/sqrt(D) and rounded to bf16
// (qs). At D=64 the scale is 1/8, a power of two, so bf16(q / 8) = q / 8
// exactly: the kernels read q as it is, c = log2(e) / 8, and dK is scaled
// by 1/8 in its epilogue, which gives the same f32 values as products of qs.
// At D=32 (1/sqrt(32) is not a power of two) q is scaled in shared memory,
// c = log2(e): the dQ kernel scales its resident q once, and the dK/dV
// kernel's producer warp scales each walked q tile once for the block's 128
// keys. Keys past a query and rows past T get P = 0; the masked scores never
// reach an exponential. Any T works: TMA zero-fills the rows of a tile past
// T and the stores stop at T.
//
// What bounds it on the H100: at the GPT's reference context (B=64,
// T=1796, H=8, D=64) the causal pairs number 8.26e8, and the five products
// a pair needs (S, dP, dV, dQ, dK) are 5.3e11 flop: 534.7 us at the bf16
// peak, against ~0.95 GB of traffic (0.28 ms) and one exp2 a pair (0.2 ms of
// the SFUs): bound by operations. The two-kernel split runs seven products
// and two exp2 a pair (S and dP in both kernels): one pass of five would
// need a cross-block reduction of dQ, by atomics (whose order changes the
// bits) or by f32 partial sums that at D=64 cost about the product saved.
//
// Design (the PR-13 first design's limits in brackets):
//   - Blocks of 64-row consumer warpgroups that all read every walked tile,
//     which is loaded once for the block [one warpgroup, 64-row blocks: each
//     walked tile crossed L2 -> shared memory once per 64 rows]: three in dQ
//     (192 queries, ~140 registers a thread), two in dK/dV (128 keys, two
//     accumulators: ~200 registers). One block an SM.
//   - One producer warp keeps a four-stage TMA ring of the walked tiles full
//     (K and V in dQ; q, dO and the tile's lse2 and di, which its lanes
//     stage, in dK/dV); the consumers release a stage through an mbarrier
//     once its last product is done. The producer is a whole warpgroup so
//     that setmaxnreg can move registers to the consumers (FbBlock; without
//     it dK/dV's three warpgroups have 168 a thread, and it spilled).
//   - Asynchronous wgmma [every product group waited for before any
//     arithmetic]. dQ: S and dP are two commit groups, P = exp2(...) runs
//     while dP is in the tensor cores, and tile i's dQ product is issued
//     before tile i+1's S and dP. dK/dV: the queue holds dP^T of tile i, S^T
//     of tile i+1, then tile i's dV and dK products, and P^T of tile i+1 runs
//     while those two are in flight. dS waits for dP in both kernels: in
//     dK/dV, dP^T in flight beside dV and dK pinned 160 registers under
//     in-flight wgmmas, and ptxas then serialised every wgmma of the kernel.
//   - ptxas keeps the groups asynchronous only if no other instruction
//     defines an accumulator while a group is in flight: the role branch
//     tests a warp index broadcast from lane 0 (uniform), accumulators are
//     zeroed before the first issue, stage releases are predicated arrivals,
//     and the last tile is peeled so that every issue in the loop is
//     unconditional.
//   - No per-tile q re-scale at D=64 [every walked q tile was scaled in
//     shared memory, once per 64 keys, behind a block barrier].
//   - Longest first: the dQ grid starts with the last query tiles, which
//     walk the most key tiles, as the dK/dV grid starts with the first key
//     tiles [the dQ grid ran its light tiles first]. The tile index is the
//     grid's fastest dimension, so the blocks of one (head, batch) run
//     together and share their walked tiles in L2.
//   - Only the tiles a mask touches (a warpgroup's diagonal tile, the ragged
//     tile past T) test it; a warpgroup skips the tiles wholly past its
//     diagonal (it releases them unread), and one with no rows exits.
// Products whose B operand is a (token, d) tile (dQ += dS.K, dV += P^T.dO,
// dK += dS^T.q) read it MN-major through the descriptor's transpose bit,
// with the left operand packed to bf16 in registers from the accumulator:
// nothing is transposed in memory.
#include <type_traits>

#include "common.cuh"

constexpr int FB_TILE = 64;                      // rows of a TMA box, a wgmma, a walked tile
constexpr int FB_STAGES = 4;                     // walked tiles in flight

// a block: CWG consumer warpgroups of 64 rows each, and a producer warpgroup
// (one warp of it works). setmaxnreg moves registers between them: an SM
// sub-partition holds one warp of each warpgroup, 512 registers a lane
// between them (two consumers: 40 + 2 x 232 = 504; three: 32 + 3 x 160 = 512)
template <int CWG>
struct FbBlock {
  static constexpr int ROWS = CWG * FB_TILE, THREADS = (CWG + 1) * 128;
  static constexpr int PRODUCER_REGS = CWG == 2 ? 40 : 32, CONSUMER_REGS = CWG == 2 ? 232 : 160;
};
// dQ needs ~140 registers a thread and takes three; dK/dV ~200, two
constexpr int FB_DQ_CWG = 3, FB_DKV_CWG = 2;

// CWG resident 64-row tiles of each of two tensors and a ring of FB_STAGES
// pairs of 64-row tiles (each 1024-byte aligned), 128 bytes of mbarriers,
// FB_STAGES x 128 floats (dK/dV: each stage's lse2 and di; dQ: di of its
// rows), alignment slack
template <int D, int CWG>
constexpr int fb_smem_bytes() {
  return (2 * CWG + 2 * FB_STAGES) * FB_TILE * D * 2 + 128 + FB_STAGES * 128 * 4 + 1024;
}

// this thread's accumulator element e of n8 block n: row row0 + 8 (e >> 1)
// of its warpgroup's 64, column 8n + 2 t4 + (e & 1) (wgmma's f32 C layout)
#define FB_COL(n, e) ((n) * 8 + 2 * t4 + ((e) & 1))
#define FB_ROW(e) (row0 + ((e) >> 1) * 8)

// the 128 threads of consumer warpgroup w (named barrier 1 + w)
__device__ __forceinline__ void fb_wg_sync(int w) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + w) : "memory");
}

// q -> bf16(q * scale) in place over one 64-row tile of D bf16 in shared
// memory, by `n` threads of index `idx`, then fenced for wgmma's reads
template <int D>
__device__ __forceinline__ void fb_scale_tile(uint8_t* tile, int idx, int n, float scale) {
  for (int i = idx; i < FB_TILE * D / 8; i += n) {
    uint4* p = reinterpret_cast<uint4*>(tile) + i;
    uint4 val = *p;
    bf16* e = reinterpret_cast<bf16*>(&val);
#pragma unroll
    for (int x = 0; x < 8; ++x) e[x] = __float2bfloat16(__bfloat162float(e[x]) * scale);
    *p = val;
  }
  fence_proxy_async();
}

// issue s = a.b^T (64 x 64 over D), both tiles K-major in shared memory, as
// one commit group
template <int D>
__device__ __forceinline__ void fb_issue_s(float (&s)[32], uint32_t a, uint32_t b) {
  constexpr uint32_t SBO = 8 * D * 2, LAYOUT = D == 64 ? 1 : 2;
  const uint64_t da = wg_desc(a, 16, SBO, LAYOUT), db = wg_desc(b, 16, SBO, LAYOUT);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) wgmma_s(s, da + 2 * kk, db + 2 * kk, kk);
  wg_commit();
}

// issue acc (64 x D) += a (64 x 64, bf16 fragments) . the (64 tokens x D)
// tile at `tile`, read MN-major, as one commit group
template <int D>
__device__ __forceinline__ void fb_issue_acc(float (&acc)[D / 2], uint32_t (&a)[4][4],
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
}

template <int D>
__global__ void __launch_bounds__(FbBlock<FB_DQ_CWG>::THREADS, 1)
flash_bwd_dq_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                  const bf16* __restrict__ o, const bf16* __restrict__ dout,
                  const float* __restrict__ lse, float* __restrict__ di, bf16* __restrict__ dq,
                  int g_st, int T, int H, float scale) {
  constexpr int CWG = FB_DQ_CWG, ROWS = FbBlock<CWG>::ROWS;
  constexpr uint32_t TILE = FB_TILE * D * 2;
  constexpr bool FOLD = D == 64;  // the scale is a power of two: no rounded qs
  extern __shared__ uint8_t fb_smem[];
  const uint32_t raw = smem_u32(fb_smem), base = (raw + 1023) & ~1023u;
  uint8_t* tiles = fb_smem + (base - raw);
  // q: warpgroup w's 64 rows at sq + w TILE; dO the same; stage s: K at
  // ring + 2 s TILE, then V
  const uint32_t sq = base, sdo = base + CWG * TILE, ring = base + 2 * CWG * TILE;
  const uint32_t bar_res = base + (2 * CWG + 2 * FB_STAGES) * TILE, full = bar_res + 8,
                 empty = full + 8 * FB_STAGES;
  float* di_s = reinterpret_cast<float*>(tiles + (2 * CWG + 2 * FB_STAGES) * TILE + 128);

  // longest first: block x takes the x-th query tile from the end
  const int q0 = (gridDim.x - 1 - blockIdx.x) * ROWS, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = warp_uniform();
  const int n_kt = (min(T, q0 + ROWS) + FB_TILE - 1) / FB_TILE;  // key tiles walked
  const int n_res = min(CWG, (T - q0 + FB_TILE - 1) / FB_TILE);  // warpgroups with rows

  if (tid == 0) {
    mbar_init(bar_res, 1);
    for (int s = 0; s < FB_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CWG * 4);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= CWG * 4) {  // the producer warpgroup: one lane keeps the ring full
    regs_dec<FbBlock<CWG>::PRODUCER_REGS>();
    if (warp == CWG * 4 && lane == 0) {
      mbar_expect_tx(bar_res, 2 * n_res * TILE);
      for (int w = 0; w < n_res; ++w) {
        tma_load_4d(sq + w * TILE, &tq, bar_res, 0, h, q0 + w * FB_TILE, b);
        tma_load_4d(sdo + w * TILE, &tdo, bar_res, 0, h, q0 + w * FB_TILE, b);
      }
      for (int it = 0; it < n_kt; ++it) {
        const int s = it % FB_STAGES;
        if (it >= FB_STAGES) mbar_wait(empty + 8 * s, (it / FB_STAGES - 1) & 1);
        const uint32_t stage = ring + 2 * s * TILE;
        mbar_expect_tx(full + 8 * s, 2 * TILE);
        tma_load_4d(stage, &tk, full + 8 * s, 0, h, it * FB_TILE, b);
        tma_load_4d(stage + TILE, &tv, full + 8 * s, 0, h, it * FB_TILE, b);
      }
    }
    return;
  }

  regs_inc<FbBlock<CWG>::CONSUMER_REGS>();
  // consumer warpgroup w: queries r0 .. r0 + 63
  const int w = warp >> 2, ct = tid & 127;
  const int t4 = lane & 3, row0 = (warp & 3) * 16 + (lane >> 2);
  const int r0 = q0 + w * FB_TILE;
  // key tiles up to and including the diagonal (its last, the only masked one)
  const int n_w = r0 < T ? (min(T, r0 + FB_TILE) + FB_TILE - 1) / FB_TILE : 0;
  const size_t bh = ((size_t)b * H + h) * T;
  auto release = [&](int it) { mbar_arrive_if(empty + 8 * (it % FB_STAGES), lane == 0); };
  if (n_w == 0) {  // no rows (all past T): the walked tiles are released unread
    for (int it = 0; it < n_kt; ++it) {
      mbar_wait(full + 8 * (it % FB_STAGES), (it / FB_STAGES) & 1);
      release(it);
    }
    return;
  }
  float lse_r[2];  // loaded first: its latency runs under the di prologue's
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = r0 + row0 + r * 8;
    lse_r[r] = t < T ? lse[bh + t] : 0.f;
  }
  {  // di = rowsum(dO * O) of this warpgroup's rows, two threads a row
    const int r = ct >> 1, t = r0 + r;
    float acc = 0.f;
    if (t < T) {
      const size_t off = ((size_t)(b * T + t) * H + h) * D + (ct & 1) * (D / 2);
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
    if ((ct & 1) == 0) {
      di_s[w * FB_TILE + r] = acc;
      if (t < T) di[bh + t] = acc;
    }
  }
  mbar_wait(bar_res, 0);
  if (!FOLD)  // q -> qs, as the forward, once a block
    fb_scale_tile<D>(tiles + w * TILE, ct, 128, scale);
  fb_wg_sync(w);  // the warpgroup's di_s (and qs) are complete

  float di_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) di_r[r] = di_s[w * FB_TILE + row0 + r * 8];
  const float c = FOLD ? LOG2E * scale : LOG2E;
  const uint32_t my_q = sq + w * TILE, my_do = sdo + w * TILE;
  // every register a wgmma accumulates into is defined before the first
  // issue, so that no other instruction defines one while a group is in flight
  float acc[D / 2], s[32], dp[32];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
  reg_fence(acc);
  uint32_t a[4][4];

  auto issue_sdp = [&](int it) {  // S = q.K^T, then dP = dO.V^T: two groups
    const int st = it % FB_STAGES;
    mbar_wait(full + 8 * st, (it / FB_STAGES) & 1);
    reg_fence(s);
    reg_fence(dp);
    wg_fence();
    fb_issue_s<D>(s, my_q, ring + 2 * st * TILE);
    fb_issue_s<D>(dp, my_do, ring + (2 * st + 1) * TILE);
  };
  // key tile `it`; the last is the diagonal (the only masked one) and issues
  // no next tile: every issue inside the loop is unconditional
  auto step = [&](int it, auto last) {
    constexpr bool LAST = decltype(last)::value;
    const int k0 = it * FB_TILE;
    wg_wait_one();  // S, and the previous tile's dQ product: that stage is free
    reg_fence(s);
    mbar_arrive_if(empty + 8 * ((it + FB_STAGES - 1) % FB_STAGES), lane == 0 && it > 0);
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8)  // P, while dP is in the tensor cores
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = 4 * n8 + e;
        bool keep = true;
        if constexpr (LAST) {
          const int j = k0 + FB_COL(n8, e);
          // key j past query r0 + i, or past T
          keep = j <= r0 + FB_ROW(e) && j < T;
        }
        s[x] = keep ? exp2_ftz(fmaf(s[x], c, -lse_r[e >> 1])) : 0.f;
      }
    wg_wait_all();  // dP
    reg_fence(dp);
#pragma unroll
    for (int x = 0; x < 32; ++x) s[x] *= dp[x] - di_r[(x >> 1) & 1];  // dS
    pack_a_frags(s, a);
    fb_issue_acc<D>(acc, a, ring + 2 * (it % FB_STAGES) * TILE);  // dQ += dS.K
    if constexpr (LAST) {
      wg_wait_all();
      reg_fence(acc);
    } else {
      issue_sdp(it + 1);
    }
  };

  issue_sdp(0);
  for (int it = 0; it + 1 < n_w; ++it) step(it, std::false_type{});
  step(n_w - 1, std::true_type{});
  release(n_w - 1);
  for (int it = n_w; it < n_kt; ++it) {  // key tiles past this warpgroup's rows
    mbar_wait(full + 8 * (it % FB_STAGES), (it / FB_STAGES) & 1);
    release(it);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = r0 + row0 + r * 8;
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
__global__ void __launch_bounds__(FbBlock<FB_DKV_CWG>::THREADS, 1)
flash_bwd_dkv_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                   const float* __restrict__ lse, const float* __restrict__ di,
                   bf16* __restrict__ dk, bf16* __restrict__ dv, int g_st, int T, int H,
                   float scale) {
  constexpr int CWG = FB_DKV_CWG, ROWS = FbBlock<CWG>::ROWS;
  static_assert(CWG == 2, "the second warpgroup's first query tile is the only one skipped");
  constexpr uint32_t TILE = FB_TILE * D * 2;
  constexpr bool FOLD = D == 64;  // the scale is a power of two: no rounded qs
  extern __shared__ uint8_t fb_smem[];
  const uint32_t raw = smem_u32(fb_smem), base = (raw + 1023) & ~1023u;
  uint8_t* tiles = fb_smem + (base - raw);
  // K rows 0-63, 64-127; V the same; stage s: q at ring + 2 s TILE, then dO
  const uint32_t sk = base, sv = base + 2 * TILE, ring = base + 4 * TILE;
  const uint32_t bar_res = base + (4 + 2 * FB_STAGES) * TILE, full = bar_res + 8,
                 empty = full + 8 * FB_STAGES, loaded = empty + 8 * FB_STAGES;
  // stage s: lse2 of the walked tile's 64 queries, then their di
  float* stats = reinterpret_cast<float*>(tiles + (4 + 2 * FB_STAGES) * TILE + 128);

  // longest first: block x takes key tile x, which walks the most query tiles
  const int k0 = blockIdx.x * ROWS, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = warp_uniform();
  const int n_qt = (T + FB_TILE - 1) / FB_TILE - k0 / FB_TILE;  // query tiles from k0 on
  const bool two = k0 + FB_TILE < T;  // the second warpgroup has keys
  const size_t bh = ((size_t)b * H + h) * T;

  if (tid == 0) {
    mbar_init(bar_res, 1);
    for (int s = 0; s < FB_STAGES; ++s) {
      // each producer lane's statistics, and at D=64 the TMA bytes
      mbar_init(full + 8 * s, FOLD ? 33 : 32);
      mbar_init(empty + 8 * s, CWG * 4);  // one arrival per consumer warp
      mbar_init(loaded + 8 * s, 1);          // D=32: the TMA bytes, before q's scale
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= CWG * 4) {  // the producer warpgroup: its first warp works
    regs_dec<FbBlock<CWG>::PRODUCER_REGS>();
    if (warp > CWG * 4) return;
    if (lane == 0) {
      mbar_expect_tx(bar_res, (two ? 4 : 2) * TILE);
      tma_load_4d(sk, &tk, bar_res, 0, h, k0, b);
      tma_load_4d(sv, &tv, bar_res, 0, h, k0, b);
      if (two) {
        tma_load_4d(sk + TILE, &tk, bar_res, 0, h, k0 + FB_TILE, b);
        tma_load_4d(sv + TILE, &tv, bar_res, 0, h, k0 + FB_TILE, b);
      }
    }
    // lane l stages lse2 and di of queries 2l, 2l + 1 of each walked tile,
    // read one tile ahead
    float st[4];
    auto fetch = [&](int q0) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int t = q0 + 2 * lane + e;
        st[e] = t < T ? lse[bh + t] : 0.f;
        st[2 + e] = t < T ? di[bh + t] : 0.f;
      }
    };
    fetch(k0);
    for (int it = 0; it < n_qt; ++it) {
      const int s = it % FB_STAGES, q0 = k0 + it * FB_TILE;
      if (it >= FB_STAGES) mbar_wait(empty + 8 * s, (it / FB_STAGES - 1) & 1);
      const uint32_t stage = ring + 2 * s * TILE, land = FOLD ? full + 8 * s : loaded + 8 * s;
      if (lane == 0) {
        mbar_expect_tx(land, 2 * TILE);
        tma_load_4d(stage, &tq, land, 0, h, q0, b);
        tma_load_4d(stage + TILE, &tdo, land, 0, h, q0, b);
      }
      if constexpr (!FOLD) {  // q -> qs, as the forward, once per query tile a block
        mbar_wait(land, (it / FB_STAGES) & 1);
        fb_scale_tile<D>(tiles + (4 + 2 * s) * TILE, lane, 32, scale);
      }
      float2* sts = reinterpret_cast<float2*>(stats + s * 128);
      sts[lane] = make_float2(st[0], st[1]);
      sts[32 + lane] = make_float2(st[2], st[3]);
      mbar_arrive(full + 8 * s);
      if (it + 1 < n_qt) fetch(q0 + FB_TILE);
    }
    return;
  }

  regs_inc<FbBlock<CWG>::CONSUMER_REGS>();
  // consumer warpgroup w: keys kw0 .. kw0 + 63
  const int w = warp >> 2;
  const int t4 = lane & 3, row0 = (warp & 3) * 16 + (lane >> 2);
  const int kw0 = k0 + w * FB_TILE;
  // the second warpgroup's tile 0 (queries before all its keys) is skipped
  const int first = kw0 < T ? w : n_qt;
  const float c = FOLD ? LOG2E * scale : LOG2E;
  const uint32_t my_k = sk + w * TILE, my_v = sv + w * TILE;
  auto release = [&](int it) { mbar_arrive_if(empty + 8 * (it % FB_STAGES), lane == 0); };
  for (int it = 0; it < first; ++it) {  // query tiles before this warpgroup's keys
    mbar_wait(full + 8 * (it % FB_STAGES), (it / FB_STAGES) & 1);
    release(it);
  }
  if (first == n_qt) return;  // no keys (all past T): nothing to store
  // every register a wgmma accumulates into is defined before the first
  // issue, so that no other instruction defines one while a group is in flight
  float acc_k[D / 2], acc_v[D / 2], s[32], dp[32];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
  reg_fence(acc_k);
  reg_fence(acc_v);
  uint32_t pa[4][4], da[4][4];

  auto issue_s = [&](int it) {  // S^T = K.q^T, once the tile has landed
    const int st = it % FB_STAGES;
    mbar_wait(full + 8 * st, (it / FB_STAGES) & 1);
    reg_fence(s);
    wg_fence();
    fb_issue_s<D>(s, my_k, ring + 2 * st * TILE);
  };
  // query tile `it`: masked at the diagonal (the first) and the last (past T
  // or not). The tensor cores' queue: dP^T of tile it, S^T of tile it + 1,
  // then the dV and dK products of tile it; P^T of tile it + 1 runs while
  // the last two are in flight. The registers pinned under in-flight wgmmas
  // then stay at 128 of the 232 a thread has (with dP^T in flight beside them,
  // or dV's product beside dS^T, ptxas serialised every wgmma of the kernel).
  // The last tile issues no next one, so every issue inside the loop is
  // unconditional.
  auto step = [&](int it, auto masked, auto last) {
    constexpr bool MASKED = decltype(masked)::value, LAST = decltype(last)::value;
    const int stg = it % FB_STAGES, q0 = k0 + it * FB_TILE;
    wg_wait<2>();  // S^T
    reg_fence(s);
    const float2* lse_s = reinterpret_cast<const float2*>(stats + stg * 128);
    const float2* di_s = lse_s + 32;
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8) {  // P^T, while the previous dV and dK are in flight
      const float2 l2 = lse_s[4 * n8 + t4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = 4 * n8 + e;
        bool keep = true;
        if constexpr (MASKED) {
          const int j = FB_COL(n8, e), i = FB_ROW(e);
          // query q0 + j before key kw0 + i, or past T
          keep = q0 + j >= kw0 + i && q0 + j < T;
        }
        s[x] = keep ? exp2_ftz(fmaf(s[x], c, -(e & 1 ? l2.y : l2.x))) : 0.f;
      }
    }
    wg_wait_all();  // the previous tile's dV and dK products: that stage is free
    mbar_arrive_if(empty + 8 * ((it + FB_STAGES - 1) % FB_STAGES), lane == 0 && it > first);
    reg_fence(dp);
    wg_fence();
    fb_issue_s<D>(dp, my_v, ring + (2 * stg + 1) * TILE);  // dP^T = V.dO^T
    wg_wait_all();
    reg_fence(dp);
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8) {  // dS^T
      const float2 d2 = di_s[4 * n8 + t4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = 4 * n8 + e;
        dp[x] = s[x] * (dp[x] - (e & 1 ? d2.y : d2.x));
      }
    }
    pack_a_frags(s, pa);
    pack_a_frags(dp, da);
    if constexpr (!LAST) issue_s(it + 1);
    fb_issue_acc<D>(acc_v, pa, ring + (2 * stg + 1) * TILE);  // dV += P^T.dO
    fb_issue_acc<D>(acc_k, da, ring + 2 * stg * TILE);        // dK += dS^T.q
    if constexpr (LAST) {
      wg_wait_all();
      reg_fence(acc_v);
      reg_fence(acc_k);
      release(it);
    }
  };

  mbar_wait(bar_res, 0);
  issue_s(first);
  wg_commit();  // two empty groups where the loop has the dV and dK products
  wg_commit();
  if (first + 1 == n_qt) {
    step(first, std::true_type{}, std::true_type{});
  } else {
    step(first, std::true_type{}, std::false_type{});
    for (int it = first + 1; it + 1 < n_qt; ++it) step(it, std::false_type{}, std::false_type{});
    step(n_qt - 1, std::true_type{}, std::true_type{});
  }

  const float ks = FOLD ? scale : 1.f;  // dK's 1/sqrt(D), where q was read unscaled
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = kw0 + row0 + r * 8;
    if (t < T) {
      const size_t off = (size_t)(b * T + t) * g_st + h * D + 2 * t4;
#pragma unroll
      for (int n8 = 0; n8 < D / 8; ++n8) {
        *reinterpret_cast<uint32_t*>(dk + off + n8 * 8) =
            pack_bf16(acc_k[4 * n8 + 2 * r] * ks, acc_k[4 * n8 + 2 * r + 1] * ks);
        *reinterpret_cast<uint32_t*>(dv + off + n8 * 8) =
            pack_bf16(acc_v[4 * n8 + 2 * r], acc_v[4 * n8 + 2 * r + 1]);
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
  using Dq = FbBlock<FB_DQ_CWG>;
  using Dkv = FbBlock<FB_DKV_CWG>;
  constexpr int smem_dq = fb_smem_bytes<D, FB_DQ_CWG>(), smem_dkv = fb_smem_bytes<D, FB_DKV_CWG>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_sm90<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dq);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_bwd_dkv_sm90<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dkv);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_dq((T + Dq::ROWS - 1) / Dq::ROWS, H, B);
  flash_bwd_dq_sm90<D><<<grid_dq, Dq::THREADS, smem_dq, TTTS_STREAM(stream)>>>(
      tq, tk, tv, tdo, static_cast<const bf16*>(o), static_cast<const bf16*>(dout), lse, di, dq,
      g_st, T, H, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // di, written by the first kernel, is read by the second on the same stream
  const dim3 grid_dkv((T + Dkv::ROWS - 1) / Dkv::ROWS, H, B);
  flash_bwd_dkv_sm90<D><<<grid_dkv, Dkv::THREADS, smem_dkv, TTTS_STREAM(stream)>>>(
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
