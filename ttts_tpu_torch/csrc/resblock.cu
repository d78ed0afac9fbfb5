// Fused scale-shift ResBlock of the diffusion trunk, and the fused
// GroupNorm -> qkv projection of its attention blocks.
//
// Replaces ttts_tpu/ops/pallas/resblock.py fused_scale_shift_resblock /
// _resblock_kernel:
//   out = x + conv3(SiLU(GN(Dense(SiLU(GN(x)*g1 + b1)))*a2 + b2)) + bc3,
// GroupNorm statistics in f32, matmul operands in bf16 with f32 sums, and
// the conv's 'SAME' zero padding applied to the *activated* h.
//
// What bounds it on the H100: the TPU kernel keeps a whole (T, C) slab in
// VMEM and makes one pass. At T=1600, C=512 in bf16 that slab is 1.6 MB, far
// past the 227 KB of shared memory a block can hold, and GroupNorm needs
// statistics over all of T before any row can be normalised. The two GEMMs
// (C x C and 3C x C at M = B*T = 3200) are 6.7 GFLOP of tensor-core work
// against ~25 MB of traffic; the GN + SiLU prologue on every A element is
// the other cost.
//
// Design: four launches instead of one slab.
//   1. gn_partial over x: per (group, batch, 128-row chunk) block, the
//      chunk's mean and centred sum of squares (M2);
//   2. a GEMM whose A-tile prologue combines those partials with Chan's
//      formula into one per-channel multiply-add (GN * g1 + b1), applies it
//      and SiLU while loading x, with the Dense bias added in the epilogue;
//      h stays f32 in memory;
//   3. gn_partial over h;
//   4. the conv3 as one K = 3C GEMM: A[t, k*C + c] = act(h[t+k-1, c]) with
//      act = SiLU(GN(h)*a2 + b2) and zero for rows outside [0, T); its
//      epilogue adds the conv bias and the residual x.
// The GEMMs are 64x128 block tiles, four warps of 32x64, on mma.sync
// m16n8k16 (bf16 in, f32 accumulators) fed by ldmatrix from double-buffered
// shared-memory tiles; the next tile's global loads are in flight while the
// current tile's MMAs run. The normalised activations never reach device
// memory.
//
// Also replaces resblock.py fused_gn_qkv / _gn_qkv_kernel:
//   out = (GroupNorm(x) * g + b) @ W + bias,  W (C, 3C), out (B, T, 3C),
// f32 statistics, the normalised x rounded to bf16 for the product. On the
// H100 it is the first half of the resblock design: the same (mean, M2)
// partials pass, then a GEMM (MODE 0) whose A-tile prologue applies the GN
// affine with no SiLU, with the bias in the epilogue. At the trunk's
// (B=2, T=1600, C=512) that is 5.0 GFLOP against ~16 MB of traffic: bound by
// the tensor cores (~5 us), where the TPU kernel re-paid the statistics for
// each of its three column blocks.
#include "common.cuh"

constexpr int GN_ROWS = 128;  // rows per statistics chunk (= threads per block)
constexpr int RB_BM = 64, RB_BN = 128, RB_BK = 32, RB_THREADS = 128;
constexpr int RB_LDA = RB_BK + 8;  // padded rows: conflict-free ldmatrix
constexpr int RB_LDB = RB_BN + 8;
constexpr int RB_MAX_C = 1024, RB_MAX_G = 64;

// Block (g, b, s): mean and M2 of x[b, rows of chunk s, channels of group g]
template <typename T>
__global__ void __launch_bounds__(GN_ROWS)
gn_partial_kernel(const T* __restrict__ x, float2* __restrict__ part, int Tlen, int C, int G,
                  int S) {
  __shared__ float red[GN_ROWS / 32];
  const int g = blockIdx.x, b = blockIdx.y, s = blockIdx.z, cg = C / G;
  const int t = s * GN_ROWS + threadIdx.x;
  const int rows = min(GN_ROWS, Tlen - s * GN_ROWS);
  const T* row = x + ((size_t)b * Tlen + t) * C + g * cg;
  float sum = 0.f;
  if (t < Tlen)
    for (int c = 0; c < cg; ++c) sum += to_f(row[c]);
  const float mean = block_sum(sum, red) / (float)(rows * cg);
  float m2 = 0.f;
  if (t < Tlen)
    for (int c = 0; c < cg; ++c) {
      const float d = to_f(row[c]) - mean;
      m2 = fmaf(d, d, m2);
    }
  m2 = block_sum(m2, red);
  if (threadIdx.x == 0) part[((size_t)b * G + g) * S + s] = make_float2(mean, m2);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 A elements of one row in flight: bf16 x (MODE 0, 1) or f32 h (MODE 2)
template <int MODE>
struct ARaw;
template <>
struct ARaw<1> {
  uint4 v[2];
  __device__ __forceinline__ float get(int e) const {
    return __bfloat162float(reinterpret_cast<const bf16*>(v)[e]);
  }
};
template <>
struct ARaw<2> {
  float4 v[4];
  __device__ __forceinline__ float get(int e) const {
    return reinterpret_cast<const float*>(v)[e];
  }
};

// MODE 0: A = GN(x)*g + b from bf16 x; out (bf16) = A @ W + bias.
// MODE 1: A = SiLU(GN(x)*g1 + b1) from bf16 x; out (f32) = A @ W + bias.
// MODE 2: A = conv3 taps of SiLU(GN(h)*a2[b] + b2[b]) from f32 h;
//         out (bf16) = resid + A @ W + bias, with W the (3C, C) conv kernel.
// W is (K, N) row-major, (in, out) as in the flax layout; N = C but in
// MODE 0, where N = 3C.
template <int MODE>
__global__ void __launch_bounds__(RB_THREADS)
rb_gemm_kernel(const void* __restrict__ src, const float2* __restrict__ part,
               const float* __restrict__ sc, const float* __restrict__ sh,
               const bf16* __restrict__ W, const float* __restrict__ bias,
               const bf16* __restrict__ resid, void* __restrict__ dst, int Tlen, int C, int N,
               int G, int S, float eps) {
  __shared__ __align__(16) bf16 As[2][RB_BM * RB_LDA];
  __shared__ __align__(16) bf16 Bs[2][RB_BK * RB_LDB];
  __shared__ float s_mul[RB_MAX_C], s_add[RB_MAX_C];
  __shared__ float s_mean[RB_MAX_G], s_rstd[RB_MAX_G];

  const int m0 = blockIdx.x * RB_BM, n0 = blockIdx.y * RB_BN, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 64;
  const int K = MODE == 2 ? 3 * C : C;
  const int cg = C / G;

  // GroupNorm x affine as one per-channel multiply-add: Chan's combination
  // of the per-chunk (mean, M2) partials
  for (int g = tid; g < G; g += RB_THREADS) {
    const float2* pg = part + ((size_t)b * G + g) * S;
    const float n_all = (float)Tlen * cg;
    float mean = 0.f;
    for (int s = 0; s < S; ++s) mean += (float)(min(GN_ROWS, Tlen - s * GN_ROWS) * cg) * pg[s].x;
    mean /= n_all;
    float m2 = 0.f;
    for (int s = 0; s < S; ++s) {
      const float d = pg[s].x - mean;
      m2 += pg[s].y + (float)(min(GN_ROWS, Tlen - s * GN_ROWS) * cg) * d * d;
    }
    s_mean[g] = mean;
    s_rstd[g] = rsqrtf(m2 / n_all + eps);
  }
  __syncthreads();
  const float* scb = MODE == 2 ? sc + (size_t)b * C : sc;
  const float* shb = MODE == 2 ? sh + (size_t)b * C : sh;
  for (int c = tid; c < C; c += RB_THREADS) {
    const int g = c / cg;
    const float mul = s_rstd[g] * scb[c];
    s_mul[c] = mul;
    s_add[c] = shb[c] - s_mean[g] * mul;
  }
  __syncthreads();

  // A loader: thread -> (row ar, 16 consecutive k from ak0)
  const int ar = tid >> 1, ak0 = (tid & 1) * 16;
  const int at = m0 + ar;
  using Raw = ARaw<MODE == 2 ? 2 : 1>;
  auto load_a = [&](int k0, Raw& raw, bool& ok, int& c0) {
    const int kg = k0 + ak0;
    if (MODE != 2) {
      c0 = kg;
      ok = at < Tlen;
      if (ok) {
        const bf16* p = static_cast<const bf16*>(src) + ((size_t)b * Tlen + at) * C + kg;
        reinterpret_cast<ARaw<1>&>(raw).v[0] = reinterpret_cast<const uint4*>(p)[0];
        reinterpret_cast<ARaw<1>&>(raw).v[1] = reinterpret_cast<const uint4*>(p)[1];
      }
    } else {
      const int tap = kg / C, ts = at + tap - 1;
      c0 = kg - tap * C;
      ok = at < Tlen && ts >= 0 && ts < Tlen;
      if (ok) {
        const float4* p = reinterpret_cast<const float4*>(
            static_cast<const float*>(src) + ((size_t)b * Tlen + ts) * C + c0);
#pragma unroll
        for (int e = 0; e < 4; ++e) reinterpret_cast<ARaw<2>&>(raw).v[e] = p[e];
      }
    }
  };
  auto act = [](float y) { return MODE == 0 ? y : silu(y); };
  auto store_a = [&](int buf, const Raw& raw, bool ok, int c0) {
    uint32_t w[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float lo = 0.f, hi = 0.f;  // zero rows stay zero after the activation
      if (ok) {
        lo = act(fmaf(raw.get(2 * e), s_mul[c0 + 2 * e], s_add[c0 + 2 * e]));
        hi = act(fmaf(raw.get(2 * e + 1), s_mul[c0 + 2 * e + 1], s_add[c0 + 2 * e + 1]));
      }
      __nv_bfloat162 v2 = __floats2bfloat162_rn(lo, hi);
      w[e] = *reinterpret_cast<uint32_t*>(&v2);
    }
    uint4* d = reinterpret_cast<uint4*>(&As[buf][ar * RB_LDA + ak0]);
    d[0] = make_uint4(w[0], w[1], w[2], w[3]);
    d[1] = make_uint4(w[4], w[5], w[6], w[7]);
  };
  // B loader: 32 x 128 bf16 = 512 x 16 bytes, 4 per thread
  auto load_b = [&](int k0, uint4 (&raw)[4]) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = tid + j * RB_THREADS, kk = i >> 4, ch = i & 15;
      raw[j] = *reinterpret_cast<const uint4*>(W + (size_t)(k0 + kk) * N + n0 + ch * 8);
    }
  };
  auto store_b = [&](int buf, const uint4 (&raw)[4]) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = tid + j * RB_THREADS, kk = i >> 4, ch = i & 15;
      *reinterpret_cast<uint4*>(&Bs[buf][kk * RB_LDB + ch * 8]) = raw[j];
    }
  };

  float acc[2][8][4] = {};
  Raw araw;
  uint4 braw[4];
  bool aok;
  int ac0;
  load_a(0, araw, aok, ac0);
  load_b(0, braw);
  store_a(0, araw, aok, ac0);
  store_b(0, braw);
  __syncthreads();

  const int nk = K / RB_BK;
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) {  // next tile's global loads fly during this tile's MMAs
      load_a((kt + 1) * RB_BK, araw, aok, ac0);
      load_b((kt + 1) * RB_BK, braw);
    }
#pragma unroll
    for (int ks = 0; ks < RB_BK; ks += 16) {
      uint32_t fa[2][4], fb[4][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldsm_x4(fa[i], &As[buf][(wm + i * 16 + (lane & 15)) * RB_LDA + ks + (lane >> 4) * 8]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ldsm_x4_trans(fb[j], &Bs[buf][(ks + (lane & 15)) * RB_LDB + wn + j * 16 + (lane >> 4) * 8]);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          mma_16816(acc[i][2 * j], fa[i], fb[j][0], fb[j][1]);
          mma_16816(acc[i][2 * j + 1], fa[i], fb[j][2], fb[j][3]);
        }
    }
    if (kt + 1 < nk) {
      store_a(buf ^ 1, araw, aok, ac0);
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
        const float y0 = acc[i][j][2 * r] + bias[c], y1 = acc[i][j][2 * r + 1] + bias[c + 1];
        if (MODE == 0) {
          *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(dst) + o) =
              __floats2bfloat162_rn(y0, y1);
        } else if (MODE == 1) {
          *reinterpret_cast<float2*>(static_cast<float*>(dst) + o) = make_float2(y0, y1);
        } else {
          const __nv_bfloat162 x2 = *reinterpret_cast<const __nv_bfloat162*>(resid + o);
          *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(dst) + o) =
              __floats2bfloat162_rn(__low2float(x2) + y0, __high2float(x2) + y1);
        }
      }
    }
}

extern "C" int ttts_resblock(const void* x, const void* g1, const void* b1, const void* w1,
                             const void* bd1, const void* a2, const void* b2, const void* w3,
                             const void* bc3, void* out, void* h, void* part1, void* part2,
                             int B, int Tlen, int C, int G, float eps, void* stream) {
  if (C % RB_BN || C % G || C > RB_MAX_C || G > RB_MAX_G) return (int)cudaErrorInvalidValue;
  cudaStream_t st = TTTS_STREAM(stream);
  const int S = (Tlen + GN_ROWS - 1) / GN_ROWS;
  const dim3 sgrid(G, B, S), ggrid((Tlen + RB_BM - 1) / RB_BM, C / RB_BN, B);
  gn_partial_kernel<bf16><<<sgrid, GN_ROWS, 0, st>>>(static_cast<const bf16*>(x),
                                                     static_cast<float2*>(part1), Tlen, C, G, S);
  rb_gemm_kernel<1><<<ggrid, RB_THREADS, 0, st>>>(
      x, static_cast<const float2*>(part1), static_cast<const float*>(g1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w1), static_cast<const float*>(bd1),
      nullptr, h, Tlen, C, C, G, S, eps);
  gn_partial_kernel<float><<<sgrid, GN_ROWS, 0, st>>>(static_cast<const float*>(h),
                                                      static_cast<float2*>(part2), Tlen, C, G, S);
  rb_gemm_kernel<2><<<ggrid, RB_THREADS, 0, st>>>(
      h, static_cast<const float2*>(part2), static_cast<const float*>(a2),
      static_cast<const float*>(b2), static_cast<const bf16*>(w3), static_cast<const float*>(bc3),
      static_cast<const bf16*>(x), out, Tlen, C, C, G, S, eps);
  return (int)cudaGetLastError();
}

extern "C" int ttts_gn_qkv(const void* x, const void* g, const void* b, const void* w,
                           const void* bias, void* out, void* part, int B, int Tlen, int C,
                           int N, int G, float eps, void* stream) {
  if (C % RB_BK || N % RB_BN || C % G || C > RB_MAX_C || G > RB_MAX_G)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = TTTS_STREAM(stream);
  const int S = (Tlen + GN_ROWS - 1) / GN_ROWS;
  gn_partial_kernel<bf16><<<dim3(G, B, S), GN_ROWS, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<float2*>(part), Tlen, C, G, S);
  rb_gemm_kernel<0><<<dim3((Tlen + RB_BM - 1) / RB_BM, N / RB_BN, B), RB_THREADS, 0, st>>>(
      x, static_cast<const float2*>(part), static_cast<const float*>(g),
      static_cast<const float*>(b), static_cast<const bf16*>(w), static_cast<const float*>(bias),
      nullptr, out, Tlen, C, N, G, S, eps);
  return (int)cudaGetLastError();
}
