// Flash attention, causal forward with each row's log2-sum-exp2: the GPT's
// long-context training route. O = softmax(q.k^T / sqrt(D), causal).v over
// (B, T, H, D) in bf16, and lse2 = log2(e) * logsumexp_j(q.k_j / sqrt(D)), an
// f32 (B, H, T), the statistic the backward (attention_bwd.cu) reads.
//
// Replaces the forward half of the library kernel behind
// ttts_tpu/models/gpt.py _flash_causal_attention
// (jax.experimental.pallas.ops.tpu.flash_attention, forward pallas_call
// :758, which saves l and m). Its arithmetic is the serving kernel's causal
// mode (attention.cu) and flash_causal_forward_plain's: q * 1/sqrt(D)
// rounded to bf16 before Q.K^T, scores in the log2 domain, keys j > i get no
// weight, P rounded to bf16 before P.V, O normalised after it; any T (the
// ragged edge is masked), q, k and v strided (token, head) views of the
// fused (B, T, 3 H D) projection, D 32 or 64. At D=64 the scale is 1/8, a
// power of two: bf16(q / 8) = q / 8 exactly, so the kernel reads q as it is
// and folds the scale into the exponent's factor (c = log2(e) / 8), which
// gives the same f32 values as products of the rounded q, as the backward
// does. At D=32 each warpgroup scales its resident q tile once.
//
// What bounds it on the H100: at the GPT's reference context (B=64, T=1796,
// H=8, D=64) the causal pairs number 8.26e8: 2.1e11 flop of Q.K^T and P.V
// (214 us at the bf16 peak) and one exp2 a pair, 8.3e8, which the SFUs (16 a
// clock per SM) need ~200 us for, against 0.06 GB of traffic. Whole 128-key
// tiles compute ~1.2x the causal pairs (the diagonal tiles' masked half, the
// last block's rows past T).
//
// Design (the serving kernel's, which this route used before, in brackets):
//   - Persistent blocks, one an SM. The 192-query tiles are ordered with,
//     per (head, batch), the query tiles that walk the most key tiles first;
//     block x takes the x-th tile of each wave of gridDim.x tiles, counted
//     from the wave's end in every other wave, so that each block meets long
//     and short tiles alike. The tiles of one (head, batch) run together and
//     share K and V in L2 [a block per 64-query tile: each SM idled while a
//     block's first tiles loaded, and its short tiles ran first].
//   - Three consumer warpgroups of 64 query rows and a producer warpgroup
//     [one warpgroup of 64 queries: every walked K/V tile crossed L2 ->
//     shared memory once per 64 rows, 3.3 GB at the reference context]. One
//     lane of the producer keeps a ring of FW_STAGES 128-key K and V tiles in
//     flight by TMA on mbarriers (K and V land on barriers of their own) and
//     two Q buffers, so that the next tile's queries and first keys load
//     while this tile's last products run; the consumers release a stage
//     once its products have retired and a Q buffer after their last S.
//     setmaxnreg moves registers from the producer (32) to the consumers
//     (160).
//   - S = Q.K^T is wgmma m64n128k16 [m64n64k16] with both operands in shared
//     memory, K-major; O += P.V is m64nDk16 with P packed to bf16 in
//     registers and V read MN-major through the descriptor's transpose bit.
//   - Each warpgroup runs S, softmax, P.V in turn; the three warpgroups'
//     softmaxes and products interleave on the SM's SFUs and tensor cores.
//     Overlap inside a warpgroup (the next tile's S, or the previous tile's
//     P.V, in flight during the softmax) ran slower on an H100 at the
//     reference context, with three warpgroups of 160 registers and with two
//     of 232 (PERF.md, chip_flash_fwd.py).
//   - The softmax specialised by tile [every score paid the causal and ragged
//     masks]: a warpgroup's key tiles before its diagonal tile are unmasked;
//     only its last, the diagonal, masks keys past each row, which also
//     masks every key past T for the rows the kernel stores. Each exponential
//     is one ex2.approx.ftz [exp2f with its range fix-ups]; l stays in f32
//     and lse2 = m c + log2(l) is written once a row.
//   - ptxas keeps the groups asynchronous only if no other instruction
//     defines an accumulator while its group is in flight: the role branch
//     tests a warp index broadcast from lane 0, O is zeroed before the first
//     issue, stage releases are predicated arrivals.
#include <type_traits>

#include "common.cuh"

constexpr int FW_CWG = 3;                     // consumer warpgroups of 64 query rows
constexpr int FW_ROWS = FW_CWG * 64;          // queries a block
constexpr int FW_KEYS = 128;                  // keys a walked tile
constexpr int FW_STAGES = 2;                  // K/V tiles in flight
constexpr int FW_THREADS = (FW_CWG + 1) * 128;
// an SM sub-partition holds one warp of each warpgroup: 32 + 3 x 160 = 512
// registers a lane between them
constexpr int FW_PRODUCER_REGS = 32, FW_CONSUMER_REGS = 160;

// two sets of the consumers' 64-row Q tiles and FW_STAGES pairs of 128-row K
// and V tiles (each 1024-byte aligned), 256 bytes of mbarriers, alignment
// slack
template <int D>
constexpr int fw_smem_bytes() {
  return (2 * FW_CWG * 64 + 2 * FW_STAGES * FW_KEYS) * D * 2 + 256 + 1024;
}

// d (64x128 f32) = [d +] a (64x16, shared, K-major) . b (16x128, shared, K-major)
__device__ __forceinline__ void wgmma_s128(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : WG_F8(d, 0), WG_F8(d, 8), WG_F8(d, 16), WG_F8(d, 24), WG_F8(d, 32), WG_F8(d, 40),
        WG_F8(d, 48), WG_F8(d, 56)
      : "l"(da), "l"(db), "r"(acc));
}

template <int D>
__global__ void __launch_bounds__(FW_THREADS, 1)
flash_fwd_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, bf16* __restrict__ out,
               float* __restrict__ lse, int T, int H, int n_tiles, float scale) {
  constexpr uint32_t ROW = D * 2, QTILE = 64 * ROW, KV = FW_KEYS * ROW;
  constexpr uint32_t QBUF = FW_CWG * QTILE;
  constexpr uint32_t LAYOUT = D == 64 ? 1 : 2, SBO = 8 * ROW;  // 128- / 64-byte swizzle
  constexpr bool FOLD = D == 64;  // the scale is a power of two: q is read as it is
  extern __shared__ uint8_t fw_smem[];
  const uint32_t raw = smem_u32(fw_smem), base = (raw + 1023) & ~1023u;
  uint8_t* tiles = fw_smem + (base - raw);
  // Q buffer k: warpgroup w's rows at sq + k QBUF + w QTILE; ring stage s: K
  // at ring + 2 s KV, then V
  const uint32_t sq = base, ring = base + 2 * QBUF;
  const uint32_t qfull = ring + 2 * FW_STAGES * KV, qempty = qfull + 16, kfull = qempty + 16,
                 vfull = kfull + 8 * FW_STAGES, empty = vfull + 8 * FW_STAGES;
  const int n_q = (T + FW_ROWS - 1) / FW_ROWS;  // query tiles a (head, batch)
  const int tid = threadIdx.x, lane = tid & 31, warp = warp_uniform();
  // this block's k-th tile: wave k of gridDim.x tiles, taken in snake order
  // (block x takes the x-th of an even wave, the x-th from its end of an odd
  // one), so that each block meets long and short query tiles alike
  auto tile_at = [&](int k) {
    return k * (int)gridDim.x + (k & 1 ? (int)(gridDim.x - 1 - blockIdx.x) : (int)blockIdx.x);
  };

  if (tid == 0) {
    for (int k = 0; k < 2; ++k) {
      mbar_init(qfull + 8 * k, 1);
      mbar_init(qempty + 8 * k, FW_CWG * 4);  // one arrival per consumer warp
    }
    for (int s = 0; s < FW_STAGES; ++s) {
      mbar_init(kfull + 8 * s, 1);
      mbar_init(vfull + 8 * s, 1);
      mbar_init(empty + 8 * s, FW_CWG * 4);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= FW_CWG * 4) {  // the producer warpgroup: one lane keeps the buffers full
    regs_dec<FW_PRODUCER_REGS>();
    if (warp == FW_CWG * 4 && lane == 0) {
      // tile idx: query tile n_q - 1 - idx % n_q of head idx / n_q % H, batch
      // idx / n_q / H; k counts this block's tiles, g the ring's walked K/V
      // tiles over all of them
      int g = 0;
      for (int k = 0, idx = tile_at(0); idx < n_tiles; idx = tile_at(++k)) {
        const int qb = k & 1;
        if (k >= 2) mbar_wait(qempty + 8 * qb, ((k >> 1) - 1) & 1);
        const int q0 = (n_q - 1 - idx % n_q) * FW_ROWS, h = idx / n_q % H, b = idx / n_q / H;
        const int n_res = min(FW_CWG, (T - q0 + 63) / 64);
        const int n_kt = ((q0 + (n_res - 1) * 64) >> 7) + 1;
        mbar_expect_tx(qfull + 8 * qb, n_res * QTILE);
        for (int w = 0; w < n_res; ++w)
          tma_load_4d(sq + qb * QBUF + w * QTILE, &tq, qfull + 8 * qb, 0, h, q0 + w * 64, b);
        for (int it = 0; it < n_kt; ++it, ++g) {
          const int s = g % FW_STAGES;
          if (g >= FW_STAGES) mbar_wait(empty + 8 * s, (g / FW_STAGES - 1) & 1);
          const uint32_t stage = ring + 2 * s * KV;
          mbar_expect_tx(kfull + 8 * s, KV);
          tma_load_4d(stage, &tk, kfull + 8 * s, 0, h, it * FW_KEYS, b);
          mbar_expect_tx(vfull + 8 * s, KV);
          tma_load_4d(stage + KV, &tv, vfull + 8 * s, 0, h, it * FW_KEYS, b);
        }
      }
    }
    return;
  }

  regs_inc<FW_CONSUMER_REGS>();
  // consumer warpgroup w: queries r0 .. r0 + 63 of each tile; this thread's
  // rows of them are row0 and row0 + 8 (wgmma's f32 accumulator layout), its
  // columns of n8 block n are 8n + 2 t4 and + 1
  const int w = warp >> 2, ct = tid & 127;
  const int t4 = lane & 3, row0 = (warp & 3) * 16 + (lane >> 2);
  const float c = FOLD ? LOG2E * scale : LOG2E;
  int g = 0;  // the ring's walked tiles so far
  auto release = [&](int gi) { mbar_arrive_if(empty + 8 * (gi % FW_STAGES), lane == 0); };
  auto skip = [&](int gi) {  // a walked tile this warpgroup does not read: once it
    // has landed (no copy may write shared memory after the block exits)
    mbar_wait(kfull + 8 * (gi % FW_STAGES), (gi / FW_STAGES) & 1);
    mbar_wait(vfull + 8 * (gi % FW_STAGES), (gi / FW_STAGES) & 1);
    release(gi);
  };
  float s[64], o[D / 2];  // S (then P, f32) of a 64 x 128 tile; O (64 x D)
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] = 0.f;
  uint32_t pa[8][4];  // P's A fragments: pa[kk] holds keys 16 kk .. 16 kk + 15
  for (int k = 0, idx = tile_at(0); idx < n_tiles; idx = tile_at(++k)) {
    const int qb = k & 1;
    mbar_wait(qfull + 8 * qb, (k >> 1) & 1);
    const int q0 = (n_q - 1 - idx % n_q) * FW_ROWS, h = idx / n_q % H, b = idx / n_q / H;
    const int n_res = min(FW_CWG, (T - q0 + 63) / 64);
    const int n_kt = ((q0 + (n_res - 1) * 64) >> 7) + 1;
    const int r0 = q0 + w * 64;
    if (w >= n_res) {  // no rows (all past T): the walked tiles are released unread
      for (int it = 0; it < n_kt; ++it) skip(g + it);
      mbar_arrive_if(qempty + 8 * qb, lane == 0);
      g += n_kt;
      continue;
    }
    // key tiles up to the diagonal one, the last; this warpgroup's first row
    // sits `diag` (0 or 64) keys into it
    const int n_w = (r0 >> 7) + 1, diag = r0 - (n_w - 1) * FW_KEYS;
    const uint32_t my_q = sq + qb * QBUF + w * QTILE;
    if constexpr (!FOLD) {  // q -> bf16(q * scale), as the plain version
      for (int i = ct; i < 64 * D / 8; i += 128) {
        uint4* p = reinterpret_cast<uint4*>(tiles + qb * QBUF + w * QTILE) + i;
        uint4 val = *p;
        bf16* e = reinterpret_cast<bf16*>(&val);
#pragma unroll
        for (int x = 0; x < 8; ++x) e[x] = __float2bfloat16(__bfloat162float(e[x]) * scale);
        *p = val;
      }
      fence_proxy_async();
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + w) : "memory");
    }
    // O is defined before its first issue, as S was before the loop
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    reg_fence(o);
    // running maximum of the raw scores, the rows' partial sums of
    // 2^(c s - c m) over this thread's columns, the tile's rescale of O and l
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];

    auto issue_s = [&](int gi) {  // S = q.K^T, once K has landed: one group
      const int st = gi % FW_STAGES;
      mbar_wait(kfull + 8 * st, (gi / FW_STAGES) & 1);
      const uint64_t da = wg_desc(my_q, 16, SBO, LAYOUT);
      const uint64_t db = wg_desc(ring + 2 * st * KV, 16, SBO, LAYOUT);
      reg_fence(s);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)  // 16 columns = 32 bytes along the swizzled row
        wgmma_s128(s, da + 2 * kk, db + 2 * kk, kk);
      wg_commit();
    };
    auto issue_pv = [&](int gi) {  // O += P.V, once V has landed: one group
      const int st = gi % FW_STAGES;
      mbar_wait(vfull + 8 * st, (gi / FW_STAGES) & 1);
      const uint64_t dv = wg_desc(ring + (2 * st + 1) * KV, KV, SBO, LAYOUT);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) reg_fence(pa[kk]);
      reg_fence(o);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)  // 16 keys = 16 rows of the V tile
        wgmma_pv<D>(o, pa[kk], dv + ((kk * 16 * ROW) >> 4));
      wg_commit();
    };
    // the online softmax of the tile in s: P in s (f32), m, l and alpha updated
    auto softmax = [&](auto masked) {
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int n = 0; n < 16; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = 4 * n + e;
          if constexpr (decltype(masked)::value) {  // the diagonal tile: keys past the row
            const int col = 8 * n + 2 * t4 + (e & 1), row = row0 + 8 * (e >> 1);
            if (col > row + diag) s[x] = -INFINITY;
          }
          mx[e >> 1] = fmaxf(mx[e >> 1], s[x]);
        }
      float mc[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {  // a row's 128 scores sit on 4 lanes
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        // finite: key 0 of the first tile is at or before every row
        mc[r] = mx[r] * c;
        alpha[r] = exp2_ftz(fmaf(m[r], c, -mc[r]));
        m[r] = mx[r];
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int x = 0; x < 64; ++x) {
        const float p = exp2_ftz(fmaf(s[x], c, -mc[(x >> 1) & 1]));
        s[x] = p;
        l[(x >> 1) & 1] += p;
      }
    };
    // key tile `it` of this tile's walk: S, softmax, then O = alpha O + P.V;
    // the diagonal tile (the last) is the only masked one
    auto tile = [&](int it, auto masked) {
      issue_s(g + it);
      wg_wait_all();
      reg_fence(s);
      softmax(masked);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      issue_pv(g + it);
      wg_wait_all();
      reg_fence(o);
      release(g + it);  // both products of this stage have retired
    };
    for (int it = 0; it + 1 < n_w; ++it) tile(it, std::false_type{});
    tile(n_w - 1, std::true_type{});
    mbar_arrive_if(qempty + 8 * qb, lane == 0);  // the products that read Q are done
    for (int it = n_w; it < n_kt; ++it) skip(g + it);  // key tiles past this warpgroup's rows
    g += n_kt;

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const int t = r0 + row0 + r * 8;
      if (t < T) {
        const float inv = 1.f / l[r];
        bf16* orow = out + ((size_t)(b * T + t) * H + h) * D + 2 * t4;
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
          *reinterpret_cast<uint32_t*>(orow + n * 8) =
              pack_bf16(o[4 * n + 2 * r] * inv, o[4 * n + 2 * r + 1] * inv);
        if (t4 == 0) lse[((size_t)b * H + h) * T + t] = m[r] * c + log2f(l[r]);
      }
    }
  }
}

// ---------------------------------------------------------------- host

// SMs of the current device: the persistent grid's size
static int fw_sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 1;
}

template <int D>
static int fwd_dispatch(const void* q, const void* k, const void* v, bf16* out, float* lse,
                        int B, int T, int H, const int (&st)[6], float scale, void* stream) {
  CUtensorMap tq, tk, tv;
  if (!attn_tile_map<D>(&tq, q, B, T, H, st[0], st[1], 64) ||
      !attn_tile_map<D>(&tk, k, B, T, H, st[2], st[3], FW_KEYS) ||
      !attn_tile_map<D>(&tv, v, B, T, H, st[4], st[5], FW_KEYS))
    return (int)cudaErrorInvalidValue;
  constexpr int smem = fw_smem_bytes<D>();
  const cudaError_t err =
      cudaFuncSetAttribute(flash_fwd_sm90<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (T + FW_ROWS - 1) / FW_ROWS * H * B;
  static const int sms = fw_sm_count();
  flash_fwd_sm90<D><<<min(n_tiles, sms), FW_THREADS, smem, TTTS_STREAM(stream)>>>(
      tq, tk, tv, out, lse, T, H, n_tiles, scale);
  return (int)cudaGetLastError();
}

// q, k, v: (B, T, H, D) bf16 views with token / head strides q_st, q_sh,
// ... (elements); out a contiguous (B, T, H, D) bf16 output; lse a
// contiguous f32 (B, H, T) output, the rows' log2-sum-exp2
extern "C" int ttts_flash_causal_forward(const void* q, const void* k, const void* v, void* out,
                                         void* lse, int B, int T, int H, int D, int q_st,
                                         int q_sh, int k_st, int k_sh, int v_st, int v_sh,
                                         float scale, void* stream) {
  const int st[6] = {q_st, q_sh, k_st, k_sh, v_st, v_sh};
  bf16* o = static_cast<bf16*>(out);
  float* l = static_cast<float*>(lse);
  if (D == 32) return fwd_dispatch<32>(q, k, v, o, l, B, T, H, st, scale, stream);
  if (D == 64) return fwd_dispatch<64>(q, k, v, o, l, B, T, H, st, scale, stream);
  return (int)cudaErrorInvalidValue;
}
