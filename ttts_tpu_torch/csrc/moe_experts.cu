// Grouped SwiGLU experts of a mixture-of-experts layer (the routed experts
// of the MLA-MoE trunk, ttts_tpu_torch/models/mla_moe.py):
//   h[r] = bf16(silu(xs[r] . Wg_e) * (xs[r] . Wu_e)),  y[r] = ws[r] * (h[r] . Wd_e)
// for the rows r of expert e, the (token, expert) pairs sorted by expert.
//
// Replaces no TPU kernel (the JAX package has no mixture of experts); added
// because the routed experts are most of a decode step's bytes: at 64 decode
// rows a layer routes 384 pairs, ~6 an expert, so nearly every expert's
// 17.3 MB (three 2048 x 1408 bf16 matrices) is read each step, and the step
// is bound by HBM (~9 ms of a step's ~31 GB at 3.35 TB/s); at prefill sizes
// (~600 pairs an expert) the same products are bound by the tensor cores.
// The design reads each expert that has pairs once per launch and nothing
// of an expert that has none:
//   - the group sizes `counts` stay on the device: every block reads them,
//     works out the experts' tile starts in shared memory and finds its own
//     (expert, 64-row tile); the grid (tiles, column blocks) depends only on
//     P and E, so one launch captured in a CUDA graph serves every routing,
//     and blocks past the last tile exit at once;
//   - a producer warp keeps a 4-stage ring full by TMA: the A tile (64 pair
//     rows x 64 K, rows of other experts or past P arrive and are masked at
//     the store) and 256 weight rows x 64 K (gate/up: 128 gate rows and the
//     same 128 up rows; down: 256 output rows), 40 KB a stage, 128-byte
//     swizzled, the weights in nn.Linear's (out, in) layout read K-major;
//   - two consumer warpgroups issue wgmma m64n64k16 on the same A rows and
//     two 64-row B spans each: gate/up keeps a gate and an up accumulator of
//     the same 64 h columns, so silu(g) * u is taken in registers and only h
//     goes out, in bf16; down scales its 128 columns by the pair's weight
//     and writes y in f32 (the combine over a token's experts is its own
//     gather-sum).
// Block (0, 0) of the gate/up launch adds [P, experts with pairs] to the
// int64 counter `stats` (atomics), which the host reads once a call.
#include "common.cuh"

constexpr int MX_BM = 64, MX_BK = 64, MX_STAGES = 4;
constexpr int MX_CWG = 2;                      // consumer warpgroups
constexpr int MX_THREADS = MX_CWG * 128 + 32;  // + one producer warp
constexpr int MX_GU_N = 128;                   // h columns of a gate/up block
constexpr int MX_DN_N = 256;                   // y columns of a down block
constexpr uint32_t MX_A_BYTES = MX_BM * MX_BK * 2;  // 64 rows of 128 bytes
constexpr uint32_t MX_HALF = 128 * MX_BK * 2;       // one 128-row weight box
constexpr uint32_t MX_STAGE = MX_A_BYTES + 2 * MX_HALF;
constexpr int MX_SMEM = MX_STAGES * MX_STAGE + 2 * MX_STAGES * 8 + 1024;  // + barriers, slack
constexpr int MX_MAX_E = 256;

// MODE 0: h = bf16(silu(xs . Wg) * (xs . Wu)), gate_up (E, 2F, D): K = D, N = F, R = 2F;
// MODE 1: y = ws * (h . Wd), down (E, D, F): K = F, N = D, R = D.
// ta: the (K, P) map of the activations, box 64 x 64; tw: the (K, E*R) map of
// the weights, box 64 x 128; both 128-byte swizzled.
template <int MODE>
__global__ void __launch_bounds__(MX_THREADS, 1)
moe_experts_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tw,
                   const int* __restrict__ counts, const float* __restrict__ ws,
                   void* __restrict__ out, unsigned long long* __restrict__ stats, int P, int E,
                   int K, int N, int R) {
  extern __shared__ uint8_t mx_smem[];
  __shared__ int s_count[MX_MAX_E];
  __shared__ int s_info[4];  // expert, first row, end of the expert's rows, experts with pairs
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  for (int e = tid; e < E; e += blockDim.x) s_count[e] = counts[e];
  __syncthreads();
  if (tid == 0) {
    const int t = blockIdx.x;
    int tile = 0, row = 0, nonempty = 0;
    s_info[0] = -1;
    for (int e = 0; e < E; ++e) {
      const int c = s_count[e], tiles = (c + MX_BM - 1) / MX_BM;
      nonempty += c > 0;
      if (s_info[0] < 0 && t < tile + tiles) {
        s_info[0] = e;
        s_info[1] = row + (t - tile) * MX_BM;
        s_info[2] = row + c;
      }
      tile += tiles;
      row += c;
    }
    s_info[3] = nonempty;
    if (MODE == 0 && stats != nullptr && blockIdx.x == 0 && blockIdx.y == 0) {
      atomicAdd(stats, (unsigned long long)P);
      atomicAdd(stats + 1, (unsigned long long)nonempty);
    }
  }
  __syncthreads();
  const int expert = s_info[0];
  if (expert < 0) return;  // past the last tile: uniform over the block
  const int row0 = s_info[1], row_end = s_info[2];

  const uint32_t raw = smem_u32(mx_smem), base = (raw + 1023) & ~1023u;
  const uint32_t full0 = base + MX_STAGES * MX_STAGE, empty0 = full0 + 8 * MX_STAGES;
  const int nk = K / MX_BK;
  const int n0 = blockIdx.y * (MODE == 0 ? MX_GU_N : MX_DN_N);

  if (tid == 0) {
    for (int s = 0; s < MX_STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, MX_CWG * 4);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == MX_CWG * 4) {  // the producer warp: one lane keeps the ring full
    if (lane == 0) {
      const int w0 = expert * R + n0, w1 = MODE == 0 ? w0 + N : w0 + 128;
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % MX_STAGES;
        if (kt >= MX_STAGES) mbar_wait(empty0 + 8 * s, (kt / MX_STAGES - 1) & 1);
        const uint32_t sa = base + s * MX_STAGE, sb = sa + MX_A_BYTES, full = full0 + 8 * s;
        mbar_expect_tx(full, MX_STAGE);
        tma_load_2d(sa, &ta, full, kt * MX_BK, row0);
        tma_load_2d(sb, &tw, full, kt * MX_BK, w0);
        tma_load_2d(sb + MX_HALF, &tw, full, kt * MX_BK, w1);
      }
    }
    return;
  }

  // consumers: warpgroup wg takes two 64-row spans of the stage's weight rows
  const int wg = warp >> 2;
  const uint32_t off0 = MODE == 0 ? wg * 8192u : wg * 16384u;
  const uint32_t off1 = MODE == 0 ? MX_HALF + wg * 8192u : wg * 16384u + 8192u;
  float acc0[32], acc1[32];  // (i = 4n + e): row 16(warp&3) + g + 8(e>>1), column 8n + 2t4 + (e&1)
#pragma unroll
  for (int i = 0; i < 32; ++i) acc0[i] = acc1[i] = 0.f;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % MX_STAGES;
    mbar_wait(full0 + 8 * s, (kt / MX_STAGES) & 1);
    const uint32_t sa = base + s * MX_STAGE, sb = sa + MX_A_BYTES;
    const uint64_t da = wg_desc(sa, 16, 1024, 1);  // K-major: 8 rows of 128 bytes apart
    const uint64_t d0 = wg_desc(sb + off0, 16, 1024, 1), d1 = wg_desc(sb + off1, 16, 1024, 1);
    reg_fence(acc0);
    reg_fence(acc1);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < MX_BK / 16; ++kk) {  // 16 K = 32 bytes along every row
      wgmma_s(acc0, da + 2 * kk, d0 + 2 * kk, 1);
      wgmma_s(acc1, da + 2 * kk, d1 + 2 * kk, 1);
    }
    wg_commit();
    wg_wait_one();  // the previous stage's MMAs are done: release it
    reg_fence(acc0);
    reg_fence(acc1);
    if (kt > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((kt - 1) % MX_STAGES));
  }
  wg_wait_all();
  reg_fence(acc0);
  reg_fence(acc1);

  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = row0 + (warp & 3) * 16 + g;  // this thread's rows r0, r0 + 8
  const bool ok0 = r0 < row_end, ok1 = r0 + 8 < row_end;
  if constexpr (MODE == 0) {
    bf16* h = static_cast<bf16*>(out);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int c = n0 + wg * 64 + 8 * n + 2 * t4;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (!(r ? ok1 : ok0)) continue;
        const int i = 4 * n + 2 * r;
        *reinterpret_cast<uint32_t*>(h + (size_t)(r0 + 8 * r) * N + c) =
            pack_bf16(silu(acc0[i]) * acc1[i], silu(acc0[i + 1]) * acc1[i + 1]);
      }
    }
  } else {
    float* y = static_cast<float*>(out);
    const float w0 = ok0 ? ws[r0] : 0.f, w1 = ok1 ? ws[r0 + 8] : 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int c = n0 + wg * 128 + 8 * n + 2 * t4;
      const int i = 4 * n;
      if (ok0) {
        *reinterpret_cast<float2*>(y + (size_t)r0 * N + c) =
            make_float2(w0 * acc0[i], w0 * acc0[i + 1]);
        *reinterpret_cast<float2*>(y + (size_t)r0 * N + c + 64) =
            make_float2(w0 * acc1[i], w0 * acc1[i + 1]);
      }
      if (ok1) {
        *reinterpret_cast<float2*>(y + (size_t)(r0 + 8) * N + c) =
            make_float2(w1 * acc0[i + 2], w1 * acc0[i + 3]);
        *reinterpret_cast<float2*>(y + (size_t)(r0 + 8) * N + c + 64) =
            make_float2(w1 * acc1[i + 2], w1 * acc1[i + 3]);
      }
    }
  }
}

// a row-major (rows, k) bf16 matrix as a tensor map with box 64 x box_rows
static inline bool rows_map(CUtensorMap* map, const void* ptr, int rows, int k, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)k, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)k * 2};
  const cuuint32_t box[2] = {MX_BK, (cuuint32_t)box_rows};
  return bf16_map(map, ptr, 2, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

extern "C" int ttts_moe_experts(const void* xs, const void* gate_up, const void* down,
                                const int* counts, const float* ws, void* h, float* y,
                                unsigned long long* stats, int P, int E, int D, int F,
                                void* stream) {
  if (E > MX_MAX_E || D % MX_DN_N || F % MX_GU_N || D % MX_BK || F % MX_BK || P <= 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap ta_x, tw_gu, ta_h, tw_d;
  if (!rows_map(&ta_x, xs, P, D, MX_BM) || !rows_map(&tw_gu, gate_up, E * 2 * F, D, 128) ||
      !rows_map(&ta_h, h, P, F, MX_BM) || !rows_map(&tw_d, down, E * D, F, 128))
    return (int)cudaErrorInvalidValue;
  static bool attrs = false;
  if (!attrs) {
    cudaFuncSetAttribute(moe_experts_kernel<0>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         MX_SMEM);
    cudaFuncSetAttribute(moe_experts_kernel<1>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         MX_SMEM);
    attrs = true;
  }
  const int tiles = (P + MX_BM - 1) / MX_BM + (E < P ? E : P);
  cudaStream_t s = TTTS_STREAM(stream);
  moe_experts_kernel<0><<<dim3(tiles, F / MX_GU_N), MX_THREADS, MX_SMEM, s>>>(
      ta_x, tw_gu, counts, ws, h, stats, P, E, D, F, 2 * F);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  moe_experts_kernel<1><<<dim3(tiles, D / MX_DN_N), MX_THREADS, MX_SMEM, s>>>(
      ta_h, tw_d, counts, ws, y, stats, P, E, F, D, D);
  return (int)cudaGetLastError();
}
