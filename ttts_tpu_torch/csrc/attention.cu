// Flash attention, forward: softmax(q.k^T / sqrt(D) [+ Toeplitz bias]
// [causal mask]).v over (B, T, H, D).
//
// Replaces ttts_tpu/ops/pallas/attention.py flash_attention / _flash_kernel /
// _flash_kernel_nobias / _toeplitz_tile in all four of its modes:
//   bias (the diffusion trunk and reference encoders): bias[h, i, j] =
//     strip[h, j-i+T-1], neither the (T, T) bias nor the scores reach device
//     memory;
//   no bias (CLVP's encoders): the strip staging is skipped;
//   causal (the GPT's prefill and return_latent forward): key tiles wholly
//     past the diagonal are skipped (about half the work) and keys j > i in
//     the diagonal tile are masked with the f32 minimum, as attention.py:72-75
//     does; the diagonal always leaves a row at least one key;
//   bias + causal, which no caller uses but the TPU kernel computes.
// The softmax scale is folded into q and the output normalised after P.V.
//
// What bounds it on the H100: at the diffusion trunk's shape (B=2, H=16,
// D=32, T<=1600) one call is 10.5 GFLOP of QK^T and P.V and 82 M
// exponentials against ~10 MB of q/k/v traffic, so it is compute-bound, and
// with D=32 the softmax (exp, bias, max) per score costs more than the MMA.
// Any round trip of scores through shared memory dominates. At CLVP's
// (B=4, T=400, H=16, D=64) and the GPT's (B=4, T=163, H=8, D=64) a call is
// 0.1-0.8 GFLOP: a few hundred blocks, latency-bound.
//
// Design (flash-attention 2 on mma.sync.m16n8k16, bf16 in, f32 out): one
// block per (64-query tile, head, batch), four warps of 16 query rows. Q is
// loaded once into A fragments. The block loops over 64-key tiles; K, V
// (stored transposed, so both MMAs read 32-bit pairs) and, in bias mode, the
// (64+64-1)-wide window of strip[h] the tile pair needs are staged in
// shared memory. Scores, probabilities and the output accumulator stay in
// registers: the C fragments of two adjacent n8 score tiles are exactly the
// A fragment of P.V, and a row's max and sum reduce over the 4 lanes that
// hold it. Scores run in the log2 domain (exp2). The TPU kernel needed T
// and the block to be multiples of 128; here the ragged edge is masked, so
// any T works. q, k and v are read through (token, head) strides, so they
// may be views of a fused qkv tensor in either layout the models use.
#include "common.cuh"

constexpr int FA_BQ = 64;
constexpr int FA_BK = 64;
constexpr int FA_WARPS = FA_BQ / 16;
constexpr int FA_THREADS = FA_WARPS * 32;
constexpr int FA_WIN = FA_BQ + FA_BK;  // window slots (FA_BQ + FA_BK - 1 used)
constexpr float FA_LOG2E = 1.4426950408889634f;

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

template <int D, bool BIAS, bool CAUSAL>
__global__ void __launch_bounds__(FA_THREADS)
flash_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
             const float* __restrict__ strip, bf16* __restrict__ out, int T, int H, FaStrides st,
             int strip_stride, float scale) {
  constexpr int LDQ = D + 8, LDK = D + 8, LDV = FA_BK + 8;  // padded: no bank conflicts
  constexpr int VEC = D / 8;
  __shared__ __align__(16) bf16 Qs[FA_BQ * LDQ];
  __shared__ __align__(16) bf16 Ks[FA_BK * LDK];
  __shared__ __align__(16) bf16 Vt[D * LDV];  // V transposed: [d][key]
  __shared__ float W[BIAS ? FA_WIN : 1];      // log2e * bias window

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
  const float* strip_h = BIAS ? strip + (size_t)h * strip_stride : nullptr;
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
    if (BIAS) {
      // W[w] = strip[h, (k0 - q0) - (FA_BQ - 1) + w + T - 1], so that
      // bias(i, j) = W[j - i + FA_BQ - 1] for tile-local row i and key j
      const int ws = k0 - q0 - (FA_BQ - 1) + T - 1;
      for (int w = tid; w < FA_WIN; w += FA_THREADS) {
        const int idx = ws + w;
        W[w] = (idx >= 0 && idx < n_strip) ? strip_h[idx] * FA_LOG2E : 0.f;
      }
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
        float x = BIAS ? fmaf(s[n][e], FA_LOG2E, W[j - i + FA_BQ - 1]) : s[n][e] * FA_LOG2E;
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

template <int D, bool BIAS, bool CAUSAL>
static int flash_launch(const void* q, const void* k, const void* v, const void* strip,
                        void* out, int B, int T, int H, const FaStrides& st, int strip_stride,
                        float scale, void* stream) {
  dim3 grid((T + FA_BQ - 1) / FA_BQ, H, B);
  flash_kernel<D, BIAS, CAUSAL><<<grid, FA_THREADS, 0, TTTS_STREAM(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(strip), static_cast<bf16*>(out), T, H, st, strip_stride, scale);
  return (int)cudaGetLastError();
}

template <int D>
static int flash_dispatch(const void* q, const void* k, const void* v, const void* strip,
                          void* out, int B, int T, int H, const FaStrides& st, int strip_stride,
                          int causal, float scale, void* stream) {
  if (strip != nullptr)
    return causal ? flash_launch<D, true, true>(q, k, v, strip, out, B, T, H, st, strip_stride,
                                                scale, stream)
                  : flash_launch<D, true, false>(q, k, v, strip, out, B, T, H, st, strip_stride,
                                                 scale, stream);
  return causal ? flash_launch<D, false, true>(q, k, v, strip, out, B, T, H, st, strip_stride,
                                               scale, stream)
                : flash_launch<D, false, false>(q, k, v, strip, out, B, T, H, st, strip_stride,
                                                scale, stream);
}

// strip == nullptr selects the no-bias mode; q_st/q_sh etc. are the token
// and head strides of q, k, v in elements; out is contiguous (B, T, H, D)
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
