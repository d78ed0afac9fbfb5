// Flash attention, forward: softmax(q.k^T / sqrt(D) [+ Toeplitz bias]
// [causal mask]).v over (B, T, H, D).
//
// Replaces ttts_tpu/ops/pallas/attention.py flash_attention / _flash_kernel /
// _flash_kernel_nobias / _toeplitz_tile in all four of its modes, with one
// kernel, flash_kernel_sm90<D, CAUSAL, BIAS>:
//   bias (the diffusion trunk and reference encoders): bias[h, i, j] =
//     strip[h, j-i+T-1], neither the (T, T) bias nor the scores reach device
//     memory;
//   no bias (CLVP's encoders);
//   causal (the GPT's prefill and return_latent forward): key tiles wholly
//     past the diagonal are skipped (about half the work) and keys j > i in
//     the diagonal tile are masked with the f32 minimum, as attention.py:72-75
//     does; the diagonal always leaves a row at least one key;
//   bias + causal, which no caller uses but the TPU kernel computes.
// (The GPT's training route has a causal forward of its own that also
// writes each row's log-sum-exp: attention_fwd.cu.)
// The softmax scale is folded into q (rounded to bf16) and the output
// normalised after P.V. Scores run in the log2 domain (exp2), P is rounded
// to bf16 before P.V. The TPU kernel needed T and the block to be multiples
// of 128; here the ragged edge is masked, so any T works. q, k and v are
// read through (token, head) strides, so they may be views of a fused qkv
// tensor in either layout the models use.
//
// What bounds it on the H100: at the diffusion trunk's shape (B=2, H=16,
// D=32, T<=1600) one call is 10.5 GFLOP of QK^T and P.V (10.6 us at the bf16
// peak) and 82 M exponentials, which the SFUs (16 a clock per SM) need
// ~22 us for, against ~10 MB of q/k/v traffic: with D=32 the softmax per
// score (bias, max, exp2, sum) costs more than the two MMAs. At CLVP's (B=4,
// T=400, H=16, D=64) and the GPT's (B=1..4, T=100-436, H=8, D=64) a call is
// 0.1-0.8 GFLOP against 1-2 MB: a few hundred blocks, each bounded by the
// latency of its key-tile loop.
//
// Design, on Hopper's asynchronous paths. One warpgroup per (64-query tile,
// head, batch): wgmma's 64 rows are the block's 64 queries. Several blocks
// share an SM (about six at the trunk's shape), so one block's softmax runs
// under another's MMAs.
//   - Q, and each 64-key tile of K and V, arrive by TMA (one 4-D tensor map
//     (D, H, T, B) per view, built on the host) into shared memory, swizzled
//     by 128 bytes (D=64: one row) or 64 bytes (D=32). K and V go through a
//     two-stage ring on mbarriers: tile j+1 is requested before the MMAs of
//     tile j, so its load overlaps them. TMA zero-fills rows past T.
//   - S = Q.K^T is wgmma m64n64k16 with both operands in shared memory,
//     K-major. Its f32 accumulator has mma.sync's C layout per warp (rows
//     warp*16 + g and + 8, column pairs 2*t4).
//   - Bias modes: the block's whole segment of strip[h], the T + 64
//     diagonals its queries meet, pre-multiplied by log2(e) and zero outside
//     [0, 2T-1), is loaded into shared memory once, while the first tiles
//     are in flight; score (i, j) of key tile k0 adds seg[k0 + j - i + 63].
//     A thread's second row (i + 8) reuses its first row's values eight
//     columns back, so a tile costs 18 shared loads a thread, not 32; they
//     are conflict-free (a warp's lanes touch 14 consecutive words). Only
//     the last key tile applies the ragged-edge mask, and the exponentials
//     are single ex2.approx.ftz instructions: the bias mode's softmax is
//     bound by instruction issue and the SFUs, not by the MMAs.
//   - O += P.V is wgmma m64nDk16 with P packed to bf16 in registers (A) and
//     the V tile read in its natural [key][d] layout as an MN-major B
//     operand (the descriptor's transpose bit): nothing is transposed.
//   - The scale is applied to the Q tile in shared memory after it lands
//     (q * 1/sqrt(D) rounded to bf16, as the plain version), then a proxy
//     fence hands it to wgmma.
#include <type_traits>

#include "common.cuh"

constexpr int FA_BQ = 64;
constexpr int FA_BK = 64;
constexpr int FA_THREADS = 128;  // one warpgroup

// Q tile, two K and two V ring stages (each 64 rows of D bf16, 1024-byte
// aligned: the swizzle pattern's period), three mbarriers (32 bytes),
// alignment slack; the bias modes add the strip segment (fa9_seg floats)
template <int D>
constexpr int fa9_smem_bytes() {
  return 5 * FA_BK * D * 2 + 32 + 1024;
}

// strip segment length: every diagonal k0 + j - i + 63 a block can read
__host__ __device__ inline int fa9_seg(int T) {
  return (T + FA_BK - 1) / FA_BK * FA_BK + FA_BQ;
}

// keys j > i of the diagonal tile get the f32 minimum (attention.py:72-75)
template <bool CAUSAL>
__device__ __forceinline__ float fa_causal(float x, int k0, int q0, int j, int i) {
  if (CAUSAL && k0 == q0 && j > i) x = -FLT_MAX;
  return x;
}

// keys past T (TMA zero-filled them) get no weight
__device__ __forceinline__ float fa_ragged(float x, int k0, int j, int T) {
  return k0 + j < T ? x : -INFINITY;
}

template <int D, bool CAUSAL, bool BIAS>
__global__ void __launch_bounds__(FA_THREADS)
flash_kernel_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, const float* __restrict__ strip,
                  bf16* __restrict__ out, int T, int H, int strip_stride, float scale) {
  constexpr uint32_t ROW = D * 2;             // bytes per row = the swizzle span
  constexpr uint32_t TILE = FA_BK * ROW;      // bytes per 64-row tile
  constexpr uint32_t LAYOUT = D == 64 ? 1 : 2;  // 128-byte / 64-byte swizzle
  constexpr uint32_t SBO = 8 * ROW;           // between 8-row groups
  extern __shared__ uint8_t fa9_smem[];
  const uint32_t raw = smem_u32(fa9_smem), base = (raw + 1023) & ~1023u;
  uint8_t* qs = fa9_smem + (base - raw);  // generic pointer to the Q tile
  const uint32_t sq = base, sk = base + TILE, sv = base + 3 * TILE;
  const uint32_t bar_q = base + 5 * TILE, bar_kv = bar_q + 8;  // + 8 * stage
  // log2(e) * strip[h, T-1-q0-(FA_BQ-1) + w], the diagonals this block meets
  float* seg = reinterpret_cast<float*>(qs + 5 * TILE + 32);

  const int q0 = blockIdx.x * FA_BQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;  // accumulator row group, column pair
  const int row0 = warp * 16 + g;          // this thread's rows: row0, row0 + 8
  // causal: key tiles past the diagonal hold no key j <= i of this block
  const int k_end = CAUSAL ? min(T, q0 + FA_BQ) : T;
  const int n_tiles = (k_end + FA_BK - 1) / FA_BK;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    mbar_init(bar_kv, 1);
    mbar_init(bar_kv + 8, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_q, TILE);
    tma_load_4d(sq, &tq, bar_q, 0, h, q0, b);
    mbar_expect_tx(bar_kv, 2 * TILE);
    tma_load_4d(sk, &tk, bar_kv, 0, h, 0, b);
    tma_load_4d(sv, &tv, bar_kv, 0, h, 0, b);
  }
  if constexpr (BIAS) {  // while Q and the first K/V tile are in flight
    const float* strip_h = strip + (size_t)h * strip_stride;
    const int ws = T - 1 - q0 - (FA_BQ - 1), n_strip = 2 * T - 1;
    for (int w = tid; w < fa9_seg(T); w += FA_THREADS) {
      const int idx = ws + w;
      seg[w] = (idx >= 0 && idx < n_strip) ? strip_h[idx] * LOG2E : 0.f;
    }
  }
  mbar_wait(bar_q, 0);
  scale_tile_bf16<FA_BQ * D / 8, FA_THREADS>(qs, scale);  // q * 1/sqrt(D), in place
  __syncthreads();  // (and the strip segment is complete)

  const uint64_t dq = wg_desc(sq, 16, SBO, LAYOUT);
  float o[D / 2];  // accumulator (i = 4n + e): rows row0 + 8 (e >> 1), column 8n + 2t4 + (e & 1)
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1, k0 = it * FA_BK;
    if (tid == 0 && it + 1 < n_tiles) {  // tile it+1 into the other stage, freed at it-1's end
      const uint32_t bar = bar_kv + 8 * (stage ^ 1);
      mbar_expect_tx(bar, 2 * TILE);
      tma_load_4d(sk + (stage ^ 1) * TILE, &tk, bar, 0, h, k0 + FA_BK, b);
      tma_load_4d(sv + (stage ^ 1) * TILE, &tv, bar, 0, h, k0 + FA_BK, b);
    }
    mbar_wait(bar_kv + 8 * stage, (it >> 1) & 1);  // the stage's (it/2)-th fill

    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    const uint64_t dk = wg_desc(sk + stage * TILE, 16, SBO, LAYOUT);
    reg_fence(s);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)  // 16 columns = 32 bytes along the swizzled row
      wgmma_s(s, dq + 2 * kk, dk + 2 * kk, kk);
    wg_commit();
    wg_wait_all();
    reg_fence(s);

    float mx[2] = {-INFINITY, -INFINITY};
    if constexpr (BIAS) {
      // score (i, j) adds seg[k0 + j - i + FA_BQ - 1]. Row row0 + 8 at
      // column j meets row row0's diagonal at column j - 8, so the values of
      // n8 block n - 1 serve the second row of block n: 18 loads, not 32.
      // Only the last tile holds keys past T: the others skip that mask.
      const int sb = k0 + 2 * t4 - row0 + FA_BQ - 1;  // row row0, column 2t4
      auto scores = [&](auto ragged) {
        float bprev[2] = {seg[sb - 8], seg[sb - 7]};
#pragma unroll
        for (int n = 0; n < FA_BK / 8; ++n) {
          const float bcur[2] = {seg[sb + 8 * n], seg[sb + 8 * n + 1]};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = n * 8 + 2 * t4 + (e & 1), i = row0 + (e >> 1) * 8;
            float x = fmaf(s[4 * n + e], LOG2E, e >> 1 ? bprev[e & 1] : bcur[e & 1]);
            x = fa_causal<CAUSAL>(x, k0, q0, j, i);
            if constexpr (decltype(ragged)::value) x = fa_ragged(x, k0, j, T);
            s[4 * n + e] = x;
            mx[e >> 1] = fmaxf(mx[e >> 1], x);
          }
          bprev[0] = bcur[0], bprev[1] = bcur[1];
        }
      };
      if (k0 + FA_BK > T)
        scores(std::true_type{});
      else
        scores(std::false_type{});
    } else {
#pragma unroll
      for (int n = 0; n < FA_BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = n * 8 + 2 * t4 + (e & 1), i = row0 + (e >> 1) * 8;
          float x = fa_causal<CAUSAL>(s[4 * n + e] * LOG2E, k0, q0, j, i);
          x = fa_ragged(x, k0, j, T);
          s[4 * n + e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // a row's 64 scores sit on 4 lanes
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // finite: key k0 < T is valid and, causal, j = 0 <= i in every tile
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = BIAS ? exp2_ftz(m[r] - m_new) : exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      // the bias modes are bound by the SFUs' exponentials (82 M a trunk call)
      const float p = BIAS ? exp2_ftz(s[i] - m[(i >> 1) & 1]) : exp2f(s[i] - m[(i >> 1) & 1]);
      s[i] = p;
      l[(i >> 1) & 1] += p;
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
    uint32_t pa[FA_BK / 16][4];  // P's A fragments
    pack_a_frags(s, pa);
    const uint64_t dv = wg_desc(sv + stage * TILE, TILE, SBO, LAYOUT);
#pragma unroll
    for (int kk = 0; kk < FA_BK / 16; ++kk) reg_fence(pa[kk]);
    reg_fence(o);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < FA_BK / 16; ++kk)  // 16 keys = 16 rows of the V tile
      wgmma_pv<D>(o, pa[kk], dv + ((kk * 16 * ROW) >> 4));
    wg_commit();
    wg_wait_all();
    reg_fence(o);
    __syncthreads();  // every warp's MMAs of this stage are done: it may be refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int t = q0 + row0 + r * 8;
    if (t < T) {
      const float inv = 1.f / l[r];
      bf16* orow = out + ((size_t)(b * T + t) * H + h) * D + 2 * t4;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<uint32_t*>(orow + n * 8) =
            pack_bf16(o[4 * n + 2 * r] * inv, o[4 * n + 2 * r + 1] * inv);
    }
  }
}

// ---------------------------------------------------------------- host

template <int D>
static int flash_dispatch(const void* q, const void* k, const void* v, const float* strip,
                          void* out, int B, int T, int H, const int (&st)[6],
                          int strip_stride, int causal, float scale, void* stream) {
  CUtensorMap tq, tk, tv;
  if (!attn_tile_map<D>(&tq, q, B, T, H, st[0], st[1]) ||
      !attn_tile_map<D>(&tk, k, B, T, H, st[2], st[3]) ||
      !attn_tile_map<D>(&tv, v, B, T, H, st[4], st[5]))
    return (int)cudaErrorInvalidValue;
  const bool bias = strip != nullptr;
  auto kernel = causal ? (bias ? flash_kernel_sm90<D, true, true>
                               : flash_kernel_sm90<D, true, false>)
                       : (bias ? flash_kernel_sm90<D, false, true>
                               : flash_kernel_sm90<D, false, false>);
  const int smem = fa9_smem_bytes<D>() + (bias ? fa9_seg(T) * 4 : 0);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((T + FA_BQ - 1) / FA_BQ, H, B);
  kernel<<<grid, FA_THREADS, smem, TTTS_STREAM(stream)>>>(tq, tk, tv, strip,
                                                           static_cast<bf16*>(out), T, H,
                                                           strip_stride, scale);
  return (int)cudaGetLastError();
}

// strip == nullptr selects the no-bias / causal modes; q_st/q_sh etc. are
// the token and head strides of q, k, v in elements; out is contiguous
// (B, T, H, D)
extern "C" int ttts_flash_attention(const void* q, const void* k, const void* v,
                                    const void* strip, void* out, int B, int T, int H, int D,
                                    int q_st, int q_sh, int k_st, int k_sh, int v_st, int v_sh,
                                    int strip_stride, int causal, float scale, void* stream) {
  const int st[6] = {q_st, q_sh, k_st, k_sh, v_st, v_sh};
  const float* bias = static_cast<const float*>(strip);
  if (D == 32)
    return flash_dispatch<32>(q, k, v, bias, out, B, T, H, st, strip_stride, causal, scale,
                              stream);
  if (D == 64)
    return flash_dispatch<64>(q, k, v, bias, out, B, T, H, st, strip_stride, causal, scale,
                              stream);
  return (int)cudaErrorInvalidValue;
}
