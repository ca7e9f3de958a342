// Flash-attention forward for Hopper (sm_90a), bf16 in / bf16 out, D = 64.
//
// Replaces the Pallas TPU kernel dreammat_tpu/ops/attention.py::_fwd_kernel
// (launched by _flash_forward, pallas_call at attention.py:219): non-causal,
// unmasked softmax attention O = softmax(scale * Q K^T) V with an online
// softmax over K/V tiles, plus the per-row log-sum-exp L (natural log, of
// the scaled scores) that the backward kernels need.
//
// What bounds it on the H100: at the UNet's self-attention shapes (N = M =
// 4096, 1024) the work is 4*N*M*D flops per head against 2*(N+2M)*D bytes of
// q/k/v plus the output, i.e. ~N/2 flops per byte: far above the card's
// ~295 flop/byte ridge, so the tensor cores bound it. At the cross-attention
// shapes (M = 77) and the 64/256-token levels the bytes bound it.
//
// What the design does about that (version 3, the FlashAttention-3
// arrangement with its intra-warpgroup overlap):
//   - warp specialisation: a block of 3 warpgroups owns 128 query rows of
//     one (batch, head). Warpgroup 2 is the producer: one thread issues
//     every TMA load, and the warpgroup gives its registers away
//     (setmaxnreg.dec). Warpgroups 0 and 1 are the consumers, 64 rows each
//     (setmaxnreg.inc); the softmax of one overlaps the other's products.
//   - TMA: Q (128 x 64, once) and a ring of 2 stages of K and V tiles
//     (128 keys x 64 each) come through 4-D tensor maps over the caller's
//     strided [B, N, H, D] layout, 128-byte swizzled, with full/empty
//     mbarriers per stage. Rows past N or M arrive as zeros.
//   - both products on wgmma (bf16 in, fp32 accumulate): S = Q K^T as
//     m64n128k16 with Q and K from shared memory (both K-major); O += P V as
//     m64n64k16 with P from registers and V from shared memory through the
//     transpose bit (V stays [key][d], no transpose pass). The m64
//     accumulator layout of each warp is the m16n8 fragment layout that
//     converts to the A fragment, so P goes from registers to the second
//     product without shared memory.
//   - each consumer issues S_t = Q K_t^T and O += P_{t-1} V_{t-1} together
//     and runs the softmax of tile t while P_{t-1} V_{t-1} is on the tensor
//     cores; P of two consecutive tiles lives in two register arrays (the
//     loop is unrolled by two), so the softmax never writes registers that
//     an issued wgmma still reads.
//   - the online softmax (running max and denominator) is fp32; each
//     exponential is one ex2.approx of scale * log2(e) * s - max, and P is
//     rounded to bf16 for P V, as the TPU kernel does. Keys past M are set
//     to -inf after the product (a zero-filled key would score 0); rows past
//     N are not stored.
//   - O is scaled by 1/l and stored through the caller's strides; L = scale
//     * m + ln l goes to [B*H, N].
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC  (see dreammat_tpu_torch/ops/kernels.py)

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int D = 64;
constexpr int BLOCK_M = 128;     // query rows per block, 64 per consumer warpgroup
constexpr int BLOCK_N = 128;     // keys per K/V tile
constexpr int STAGES = 2;        // K/V ring
constexpr int NUM_THREADS = 384; // consumers: warpgroups 0 and 1; producer: warpgroup 2
constexpr int PRODUCER_THREAD = 256;
constexpr uint32_t TILE_BYTES = BLOCK_N * D * 2;  // one 128 x 64 bf16 tile
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Smem {  // at a 1024-byte-aligned address; every tile is 16 KB
  __nv_bfloat16 q[BLOCK_M * D];
  __nv_bfloat16 k[STAGES][BLOCK_N * D];
  __nv_bfloat16 v[STAGES][BLOCK_N * D];
  uint64_t q_full;
  uint64_t k_full[STAGES];
  uint64_t v_full[STAGES];
  uint64_t k_empty[STAGES];  // one arrival per consumer warp
  uint64_t v_empty[STAGES];
};
constexpr int SMEM_BYTES = sizeof(Smem) + 1024;

// 2^x on the special-function unit (flushes denormals to zero)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One consumer warpgroup's online-softmax state: rows g and g+8 of each warp.
struct Softmax {
  float m_scaled[2];  // running max of the scores, times scale * log2(e)
  float l[2];         // this thread's share of the denominators

  // scores -> P (bf16 A fragments of P V); returns the factor alpha by which
  // the output accumulated so far must be rescaled, per row
  __device__ __forceinline__ void step(float (&sc)[64], uint32_t (&pf)[BLOCK_N / 16][4],
                                       float (&alpha)[2], float scale_log2) {
    float mt[2] = {sc[0], sc[2]};
#pragma unroll
    for (int j = 0; j < BLOCK_N / 8; ++j) {
      mt[0] = fmaxf(mt[0], fmaxf(sc[4 * j], sc[4 * j + 1]));
      mt[1] = fmaxf(mt[1], fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
    float neg_m[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 1));
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 2));
      const float m_new = fmaxf(m_scaled[i], mt[i] * scale_log2);
      alpha[i] = ex2(m_scaled[i] - m_new);
      m_scaled[i] = m_new;
      neg_m[i] = -m_new;
    }
    float ls[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < BLOCK_N / 8; ++j) {
      const float p0 = ex2(fmaf(sc[4 * j], scale_log2, neg_m[0]));
      const float p1 = ex2(fmaf(sc[4 * j + 1], scale_log2, neg_m[0]));
      const float p2 = ex2(fmaf(sc[4 * j + 2], scale_log2, neg_m[1]));
      const float p3 = ex2(fmaf(sc[4 * j + 3], scale_log2, neg_m[1]));
      ls[0] += p0 + p1;
      ls[1] += p2 + p3;
      pf[j >> 1][(j & 1) * 2 + 0] = pack_bf16(p0, p1);
      pf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
    l[0] = l[0] * alpha[0] + ls[0];
    l[1] = l[1] * alpha[1] + ls[1];
  }
};

__global__ void __launch_bounds__(NUM_THREADS, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
                      float* __restrict__ lse, int N, int M, int H, long long o_sb,
                      long long o_sn, long long o_sh, float scale) {
  extern __shared__ uint8_t smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(align1024(smem_raw));

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int m0 = blockIdx.x * BLOCK_M;
  const int n_tiles = (M + BLOCK_N - 1) / BLOCK_N;

  if (tid == 0) {
    mbar_init(&s.q_full, 1);
#pragma unroll
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&s.k_full[st], 1);
      mbar_init(&s.v_full[st], 1);
      mbar_init(&s.k_empty[st], 8);
      mbar_init(&s.v_empty[st], 8);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: Q, then K_t and V_t in order, each into a free stage ----
    setmaxnreg_dec<24>();
    if (tid == PRODUCER_THREAD) {
      tma_prefetch_map(&tm_q);
      tma_prefetch_map(&tm_k);
      tma_prefetch_map(&tm_v);
      mbar_arrive_expect_tx(&s.q_full, TILE_BYTES);
      tma_load_4d(s.q, &tm_q, &s.q_full, 0, h, m0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % STAGES;
        const uint32_t free_parity = ((t / STAGES) & 1) ^ 1;  // the first round passes
        mbar_wait(&s.k_empty[st], free_parity);
        mbar_arrive_expect_tx(&s.k_full[st], TILE_BYTES);
        tma_load_4d(s.k[st], &tm_k, &s.k_full[st], 0, h, t * BLOCK_N, b);
        mbar_wait(&s.v_empty[st], free_parity);
        mbar_arrive_expect_tx(&s.v_full[st], TILE_BYTES);
        tma_load_4d(s.v[st], &tm_v, &s.v_full[st], 0, h, t * BLOCK_N, b);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows m0 + 64 wg .. + 63 ----
    // Iteration t issues S_t = Q K_t^T and then O += P_{t-1} V_{t-1}, so the
    // softmax of tile t runs while the tensor cores do P_{t-1} V_{t-1}.
    setmaxnreg_inc<240>();
    const int warp = (tid >> 5) & 3;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int tq = lane & 3;
    const float scale_log2 = scale * LOG2E;
    const float neg_inf = __int_as_float(0xff800000);
    const uint64_t q_desc = smem_desc(smem_u32(s.q) + wg * 64 * D * 2);

    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    Softmax sm{{neg_inf, neg_inf}, {0.f, 0.f}};
    // P of two consecutive tiles, as A fragments: P V of one tile reads one
    // array while the softmax of the next writes the other
    uint32_t pa[BLOCK_N / 16][4], pb[BLOCK_N / 16][4];

    // S_t = Q K_t^T into sc; keys past M score -inf
    auto scores = [&](int t, float (&sc)[64]) {
      const int st = t % STAGES;
      mbar_wait(&s.k_full[st], (t / STAGES) & 1);
      const uint64_t k_desc = smem_desc(smem_u32(s.k[st]));
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_m64n128k16(sc, q_desc + kk * DESC_K16_KMAJOR, k_desc + kk * DESC_K16_KMAJOR,
                            kk > 0);
      wgmma_commit();
    };
    auto mask = [&](int t, float (&sc)[64]) {
      const int n0 = t * BLOCK_N;
      if (n0 + BLOCK_N > M) {  // only the last tile can hold keys past M
#pragma unroll
        for (int j = 0; j < BLOCK_N / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (n0 + j * 8 + 2 * tq + e >= M) {
              sc[4 * j + e] = neg_inf;
              sc[4 * j + 2 + e] = neg_inf;
            }
          }
        }
      }
    };
    // O += P V_t
    auto pv = [&](int t, uint32_t (&pf)[BLOCK_N / 16][4]) {
      const int st = t % STAGES;
      mbar_wait(&s.v_full[st], (t / STAGES) & 1);
      const uint64_t v_desc = smem_desc(smem_u32(s.v[st]));
#pragma unroll
      for (int kk = 0; kk < BLOCK_N / 16; ++kk)
        wgmma_rs_m64n64k16_bt(acc, pf[kk], v_desc + kk * DESC_K16_NMAJOR, 1);
      wgmma_commit();
    };

    // iteration t: S_t = Q K_t^T and O += P_{t-1} V_{t-1} issued together,
    // then the softmax of S_t into p_next while P_{t-1} V_{t-1} runs
    auto iteration = [&](int t, uint32_t (&p_prev)[BLOCK_N / 16][4],
                         uint32_t (&p_next)[BLOCK_N / 16][4]) {
      float sc[64], alpha[2];
      fence_regs(acc);
      wgmma_fence();
      scores(t, sc);
      pv(t - 1, p_prev);
      wgmma_wait<1>();  // S_t is in
      fence_regs(sc);
      if (lane == 0) mbar_arrive(&s.k_empty[t % STAGES]);
      mask(t, sc);
      sm.step(sc, p_next, alpha, scale_log2);
      wgmma_wait<0>();  // P_{t-1} V_{t-1} is in
      fence_regs(acc);
      fence_regs(p_prev);
      if (lane == 0) mbar_arrive(&s.v_empty[(t - 1) % STAGES]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[4 * n] *= alpha[0];
        acc[4 * n + 1] *= alpha[0];
        acc[4 * n + 2] *= alpha[1];
        acc[4 * n + 3] *= alpha[1];
      }
    };

    mbar_wait(&s.q_full, 0);
    {
      float sc[64], alpha[2];
      wgmma_fence();
      scores(0, sc);
      wgmma_wait<0>();
      fence_regs(sc);
      if (lane == 0) mbar_arrive(&s.k_empty[0]);
      mask(0, sc);
      sm.step(sc, pa, alpha, scale_log2);  // alpha = 0 and acc = 0: nothing to rescale
    }
    int t = 1;
    for (; t + 1 < n_tiles; t += 2) {
      iteration(t, pa, pb);
      iteration(t + 1, pb, pa);
    }
    // the last P: in pa if n_tiles is odd, else in pb after one more iteration
    if (t < n_tiles) iteration(t, pa, pb);
    fence_regs(acc);
    wgmma_fence();
    if (n_tiles % 2 == 1) {
      pv(n_tiles - 1, pa);
    } else {
      pv(n_tiles - 1, pb);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(pa);
    fence_regs(pb);
    if (lane == 0) mbar_arrive(&s.v_empty[(n_tiles - 1) % STAGES]);

    // epilogue: O = acc / l, L = ln 2 * m_scaled + ln(l) = scale * m + ln(l)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sm.l[i] += __shfl_xor_sync(0xffffffffu, sm.l[i], 1);
      sm.l[i] += __shfl_xor_sync(0xffffffffu, sm.l[i], 2);
    }
    const int row0 = m0 + wg * 64 + warp * 16 + g;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      if (row >= N) continue;
      const float inv = 1.f / sm.l[i];
      __nv_bfloat16* orow = o + b * o_sb + (long long)row * o_sn + h * o_sh;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * tq) =
            __floats2bfloat162_rn(acc[4 * n + 2 * i] * inv, acc[4 * n + 2 * i + 1] * inv);
      }
      if (tq == 0) lse[(long long)bh * N + row] = sm.m_scaled[i] * LN2 + logf(sm.l[i]);
    }
  }
}

}  // namespace

// Returns 0, a cudaError_t, or a negative tensor-map error (hopper.cuh).
extern "C" int flash_attn_fwd_bf16_d64(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int B, int N, int M, int H,
    long long q_sb, long long q_sn, long long q_sh,
    long long k_sb, long long k_sn, long long k_sh,
    long long v_sb, long long v_sn, long long v_sh,
    long long o_sb, long long o_sn, long long o_sh,
    float scale, void* stream) {
  using hopper_host::encode_bhnd;
  CUtensorMap tm_q, tm_k, tm_v;
  int rc;
  if ((rc = encode_bhnd(&tm_q, q, B, N, H, q_sb, q_sn, q_sh, BLOCK_M)) != 0) return rc;
  if ((rc = encode_bhnd(&tm_k, k, B, M, H, k_sb, k_sn, k_sh, BLOCK_N)) != 0) return rc;
  if ((rc = encode_bhnd(&tm_v, v, B, M, H, v_sb, v_sn, v_sh, BLOCK_N)) != 0) return rc;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_sm90_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((N + BLOCK_M - 1) / BLOCK_M, B * H);
  flash_fwd_sm90_kernel<<<grid, NUM_THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), N, M, H, o_sb,
      o_sn, o_sh, scale);
  return (int)cudaGetLastError();
}
