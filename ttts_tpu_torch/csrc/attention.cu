// Flash attention, forward: softmax(q.k^T / sqrt(D) [+ Toeplitz bias]
// [causal mask]).v over (B, T, H, D).
//
// Replaces ttts_tpu/ops/pallas/attention.py flash_attention / _flash_kernel /
// _flash_kernel_nobias / _toeplitz_tile in all four of its modes:
//   bias (the diffusion trunk and reference encoders): bias[h, i, j] =
//     strip[h, j-i+T-1], neither the (T, T) bias nor the scores reach device
//     memory;
//   no bias (CLVP's encoders);
//   causal (the GPT's prefill and return_latent forward): key tiles wholly
//     past the diagonal are skipped (about half the work) and keys j > i in
//     the diagonal tile are masked with the f32 minimum, as attention.py:72-75
//     does; the diagonal always leaves a row at least one key;
//   bias + causal, which no caller uses but the TPU kernel computes.
// The softmax scale is folded into q and the output normalised after P.V.
// Scores run in the log2 domain (exp2). The TPU kernel needed T and the
// block to be multiples of 128; here the ragged edge is masked, so any T
// works. q, k and v are read through (token, head) strides, so they may be
// views of a fused qkv tensor in either layout the models use.
//
// What bounds it on the H100: at the diffusion trunk's shape (B=2, H=16,
// D=32, T<=1600) one call is 10.5 GFLOP of QK^T and P.V and 82 M
// exponentials against ~10 MB of q/k/v traffic, so it is compute-bound, and
// with D=32 the softmax (exp, bias, max) per score costs more than the MMA.
// At CLVP's (B=4, T=400, H=16, D=64) and the GPT's (B=1..4, T=100-436, H=8,
// D=64) a call is 0.1-0.8 GFLOP against 1-2 MB: a few hundred blocks, each
// bounded by the latency of its key-tile loop.
//
// Two kernels, chosen on the host by whether a bias strip is given:
//
// flash_bias_kernel (bias and bias + causal): flash-attention 2 on
// mma.sync.m16n8k16, bf16 in, f32 accumulators. One block per (64-query
// tile, head, batch), four warps of 16 query rows. Q is loaded once into A
// fragments. The block loops over 64-key tiles; K, V (stored transposed, so
// both MMAs read 32-bit pairs) and the (64+64-1)-wide window of strip[h]
// the tile pair needs are staged in shared memory. Scores, probabilities and
// the output accumulator stay in registers: the C fragments of two adjacent
// n8 score tiles are exactly the A fragment of P.V, and a row's max and sum
// reduce over the 4 lanes that hold it.
//
// flash_kernel_sm90 (no bias and causal): the same tiles and online softmax
// on Hopper's asynchronous paths. One warpgroup per (64-query tile, head,
// batch): wgmma's 64 rows are the block's 64 queries.
//   - Q, and each 64-key tile of K and V, arrive by TMA (one 4-D tensor map
//     (D, H, T, B) per view, built on the host) into shared memory, swizzled
//     by 128 bytes (D=64: one row) or 64 bytes (D=32). K and V go through a
//     two-stage ring on mbarriers: tile j+1 is requested before the MMAs of
//     tile j, so its load overlaps them. TMA zero-fills rows past T.
//   - S = Q.K^T is wgmma m64n64k16 with both operands in shared memory,
//     K-major. Its f32 accumulator has mma.sync's C layout per warp (rows
//     warp*16 + g and + 8, column pairs 2*t4), so the softmax is the bias
//     kernel's, line for line.
//   - O += P.V is wgmma m64nDk16 with P packed to bf16 in registers (A) and
//     the V tile read in its natural [key][d] layout as an MN-major B
//     operand (the descriptor's transpose bit): nothing is transposed.
//   - The scale is applied to the Q tile in shared memory after it lands
//     (q * 1/sqrt(D) rounded to bf16, as the plain version), then a proxy
//     fence hands it to wgmma.
#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up at run time

#include "common.cuh"

constexpr int FA_BQ = 64;
constexpr int FA_BK = 64;
constexpr int FA_WARPS = FA_BQ / 16;
constexpr int FA_THREADS = FA_WARPS * 32;
constexpr int FA_WIN = FA_BQ + FA_BK;  // window slots (FA_BQ + FA_BK - 1 used)

// d += a (16x16, row) * b (16x8, col), bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// 8 bf16 of row t, head h: the tensor is read through its token stride st
// and head stride sh (the batch stride is T * st)
__device__ __forceinline__ uint4 ld_row8(const bf16* __restrict__ src, int b, int t, int T,
                                         int h, int st, int sh, int c8) {
  if (t >= T) return make_uint4(0u, 0u, 0u, 0u);
  return *reinterpret_cast<const uint4*>(src + (size_t)(b * T + t) * st + (size_t)h * sh +
                                         c8 * 8);
}

struct FaStrides {
  int q_st, q_sh, k_st, k_sh, v_st, v_sh;
};

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(FA_THREADS)
flash_bias_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const float* __restrict__ strip,
                  bf16* __restrict__ out, int T, int H, FaStrides st, int strip_stride,
                  float scale) {
  constexpr int LDQ = D + 8, LDK = D + 8, LDV = FA_BK + 8;  // padded: no bank conflicts
  constexpr int VEC = D / 8;
  __shared__ __align__(16) bf16 Qs[FA_BQ * LDQ];
  __shared__ __align__(16) bf16 Ks[FA_BK * LDK];
  __shared__ __align__(16) bf16 Vt[D * LDV];  // V transposed: [d][key]
  __shared__ float W[FA_WIN];                 // log2e * bias window

  const int q0 = blockIdx.x * FA_BQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;  // fragment row group, column pair
  const int row0 = warp * 16 + g;          // this thread's rows: row0, row0 + 8

  for (int i = tid; i < FA_BQ * VEC; i += FA_THREADS) {
    const int r = i / VEC, c8 = i - r * VEC;
    uint4 val = ld_row8(q, b, q0 + r, T, h, st.q_st, st.q_sh, c8);
    bf16* e = reinterpret_cast<bf16*>(&val);
#pragma unroll
    for (int x = 0; x < 8; ++x) e[x] = __float2bfloat16(__bfloat162float(e[x]) * scale);
    *reinterpret_cast<uint4*>(Qs + r * LDQ + c8 * 8) = val;
  }
  __syncthreads();
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    qa[kk][0] = lds32(Qs + row0 * LDQ + kk * 16 + 2 * t4);
    qa[kk][1] = lds32(Qs + (row0 + 8) * LDQ + kk * 16 + 2 * t4);
    qa[kk][2] = lds32(Qs + row0 * LDQ + kk * 16 + 8 + 2 * t4);
    qa[kk][3] = lds32(Qs + (row0 + 8) * LDQ + kk * 16 + 8 + 2 * t4);
  }

  float o[D / 8][4] = {};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const float* strip_h = strip + (size_t)h * strip_stride;
  const int n_strip = 2 * T - 1;
  // causal: key tiles past the diagonal hold no key j <= i of this block
  const int k_end = CAUSAL ? min(T, q0 + FA_BQ) : T;

  for (int k0 = 0; k0 < k_end; k0 += FA_BK) {
    __syncthreads();  // the previous tile's K, V and window are no longer read
    for (int i = tid; i < FA_BK * VEC; i += FA_THREADS) {
      const int r = i / VEC, c8 = i - r * VEC;
      *reinterpret_cast<uint4*>(Ks + r * LDK + c8 * 8) =
          ld_row8(k, b, k0 + r, T, h, st.k_st, st.k_sh, c8);
      uint4 vv = ld_row8(v, b, k0 + r, T, h, st.v_st, st.v_sh, c8);
      const bf16* ve = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
      for (int x = 0; x < 8; ++x) Vt[(c8 * 8 + x) * LDV + r] = ve[x];
    }
    // W[w] = strip[h, (k0 - q0) - (FA_BQ - 1) + w + T - 1], so that
    // bias(i, j) = W[j - i + FA_BQ - 1] for tile-local row i and key j
    const int ws = k0 - q0 - (FA_BQ - 1) + T - 1;
    for (int w = tid; w < FA_WIN; w += FA_THREADS) {
      const int idx = ws + w;
      W[w] = (idx >= 0 && idx < n_strip) ? strip_h[idx] * LOG2E : 0.f;
    }
    __syncthreads();

    float s[FA_BK / 8][4];
#pragma unroll
    for (int n = 0; n < FA_BK / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const bf16* krow = Ks + (n * 8 + g) * LDK + 2 * t4;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_16816(s[n], qa[kk], lds32(krow + kk * 16), lds32(krow + kk * 16 + 8));
    }

    // only the diagonal tile holds keys past a row's own position
    const bool diag = CAUSAL && k0 + FA_BK > q0;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < FA_BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = n * 8 + 2 * t4 + (e & 1), i = row0 + (e >> 1) * 8;
        float x = fmaf(s[n][e], LOG2E, W[j - i + FA_BQ - 1]);
        if (diag && k0 + j > q0 + i) x = -FLT_MAX;  // jnp.finfo(f32).min
        if (k0 + j >= T) x = -INFINITY;             // the ragged edge
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // a row's 64 scores sit on 4 lanes
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // finite: key k0 < T is valid and, causal, j = 0 <= i in every tile
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < FA_BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[n][e] - m[e >> 1]);
        s[n][e] = p;
        l[e >> 1] += p;
      }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
    // P.V: the score C fragments of n-tiles 2kk, 2kk+1 form P's A fragment
#pragma unroll
    for (int kk = 0; kk < FA_BK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const bf16* vrow = Vt + (n * 8 + g) * LDV + kk * 16 + 2 * t4;
        mma_16816(o[n], pa, lds32(vrow), lds32(vrow + 8));
      }
    }
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
            pack_bf16(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
    }
  }
}

// ---------------------------------------------------------------- Hopper path

// TMA: a 4-D box of the tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (in 16-byte units), layout (1: 128-byte swizzle, 2: 64-byte)
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                            uint32_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)layout << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving accesses of wgmma's registers across the
// fence / wait instructions, which it cannot see depend on them
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define WG_F8(d, i)                                                                \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),     \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64x64 f32) = [d +] a (64x16, shared, K-major) . b (16x64, shared, K-major)
__device__ __forceinline__ void wgmma_s(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : WG_F8(d, 0), WG_F8(d, 8), WG_F8(d, 16), WG_F8(d, 24)
      : "l"(da), "l"(db), "r"(acc));
}

// d (64xD f32) += a (64x16, registers) . b (16xD, shared, MN-major)
template <int D>
__device__ __forceinline__ void wgmma_pv(float (&d)[D / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (D == 64) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
        "}\n"
        : WG_F8(d, 0), WG_F8(d, 8), WG_F8(d, 16), WG_F8(d, 24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else {
    static_assert(D == 32, "head width 32 or 64");
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n"
        "}\n"
        : WG_F8(d, 0), WG_F8(d, 8)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
}

// Q tile, two K and two V ring stages (each 64 rows of D bf16, 1024-byte
// aligned: the swizzle pattern's period), three mbarriers, alignment slack
template <int D>
constexpr int fa9_smem_bytes() {
  return 5 * FA_BK * D * 2 + 3 * 8 + 1024;
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(FA_THREADS)
flash_kernel_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, bf16* __restrict__ out, int T, int H,
                  float scale) {
  constexpr uint32_t ROW = D * 2;             // bytes per row = the swizzle span
  constexpr uint32_t TILE = FA_BK * ROW;      // bytes per 64-row tile
  constexpr uint32_t LAYOUT = D == 64 ? 1 : 2;  // 128-byte / 64-byte swizzle
  constexpr uint32_t SBO = 8 * ROW;           // between 8-row groups
  extern __shared__ uint8_t fa9_smem[];
  const uint32_t raw = smem_u32(fa9_smem), base = (raw + 1023) & ~1023u;
  uint8_t* qs = fa9_smem + (base - raw);  // generic pointer to the Q tile
  const uint32_t sq = base, sk = base + TILE, sv = base + 3 * TILE;
  const uint32_t bar_q = base + 5 * TILE, bar_kv = bar_q + 8;  // + 8 * stage

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
  mbar_wait(bar_q, 0);
  for (int i = tid; i < FA_BQ * D / 8; i += FA_THREADS) {  // q * 1/sqrt(D), in place
    uint4* p = reinterpret_cast<uint4*>(qs) + i;
    uint4 val = *p;
    bf16* e = reinterpret_cast<bf16*>(&val);
#pragma unroll
    for (int x = 0; x < 8; ++x) e[x] = __float2bfloat16(__bfloat162float(e[x]) * scale);
    *p = val;
  }
  fence_proxy_async();  // the scaled tile, written by threads, is read by wgmma
  __syncthreads();

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
#pragma unroll
    for (int n = 0; n < FA_BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = n * 8 + 2 * t4 + (e & 1), i = row0 + (e >> 1) * 8;
        float x = s[4 * n + e] * LOG2E;
        if (CAUSAL && k0 == q0 && j > i) x = -FLT_MAX;  // the diagonal tile
        x = k0 + j < T ? x : -INFINITY;  // keys past T (TMA zero-filled them)
        s[4 * n + e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // a row's 64 scores sit on 4 lanes
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // finite: key k0 < T is valid and, causal, j = 0 <= i in every tile
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float p = exp2f(s[i] - m[(i >> 1) & 1]);
      s[i] = p;
      l[(i >> 1) & 1] += p;
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
    // P's A fragments: the accumulators of key columns 16kk..16kk+15
    uint32_t pa[FA_BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < FA_BK / 16; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
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

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no -lcuda)
static EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                     &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// the (B, T, H, D) view with token stride st and head stride sh (elements)
// as a 4-D tensor map (D, H, T, B) whose box is one 64-token tile of one head
template <int D>
static bool tensor_map(CUtensorMap* map, const void* ptr, int B, int T, int H, int st, int sh) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)st * 2,
                                 (cuuint64_t)T * st * 2};
  const cuuint32_t box[4] = {D, 1, FA_BK, 1}, unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                D == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
static int flash_dispatch(const void* q, const void* k, const void* v, const void* strip,
                          void* out, int B, int T, int H, const FaStrides& st, int strip_stride,
                          int causal, float scale, void* stream) {
  const dim3 grid((T + FA_BQ - 1) / FA_BQ, H, B);
  cudaStream_t cs = TTTS_STREAM(stream);
  if (strip != nullptr) {
    auto kernel = causal ? flash_bias_kernel<D, true> : flash_bias_kernel<D, false>;
    kernel<<<grid, FA_THREADS, 0, cs>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const float*>(strip), static_cast<bf16*>(out), T, H, st, strip_stride, scale);
    return (int)cudaGetLastError();
  }
  CUtensorMap tq, tk, tv;
  if (!tensor_map<D>(&tq, q, B, T, H, st.q_st, st.q_sh) ||
      !tensor_map<D>(&tk, k, B, T, H, st.k_st, st.k_sh) ||
      !tensor_map<D>(&tv, v, B, T, H, st.v_st, st.v_sh))
    return (int)cudaErrorInvalidValue;
  auto kernel = causal ? flash_kernel_sm90<D, true> : flash_kernel_sm90<D, false>;
  kernel<<<grid, FA_THREADS, fa9_smem_bytes<D>(), cs>>>(tq, tk, tv, static_cast<bf16*>(out), T,
                                                        H, scale);
  return (int)cudaGetLastError();
}

// strip == nullptr selects the no-bias / causal kernel; q_st/q_sh etc. are
// the token and head strides of q, k, v in elements; out is contiguous
// (B, T, H, D)
extern "C" int ttts_flash_attention(const void* q, const void* k, const void* v,
                                    const void* strip, void* out, int B, int T, int H, int D,
                                    int q_st, int q_sh, int k_st, int k_sh, int v_st, int v_sh,
                                    int strip_stride, int causal, float scale, void* stream) {
  const FaStrides st{q_st, q_sh, k_st, k_sh, v_st, v_sh};
  if (D == 32)
    return flash_dispatch<32>(q, k, v, strip, out, B, T, H, st, strip_stride, causal, scale,
                              stream);
  if (D == 64)
    return flash_dispatch<64>(q, k, v, strip, out, B, T, H, st, strip_stride, causal, scale,
                              stream);
  return (int)cudaErrorInvalidValue;
}
