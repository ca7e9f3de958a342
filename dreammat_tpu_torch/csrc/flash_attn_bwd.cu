// Flash-attention backward for Hopper (sm_90a), bf16 in / bf16 out, D = 64.
//
// Two kernels, one for each Pallas TPU kernel of dreammat_tpu/ops/attention.py
// (both launched by _flash_backward):
//
//   kernel C  flash_bwd_dq_sm90_kernel   replaces _bwd_dq_kernel  (attention.py:115,
//             pallas_call at 271):       dq_i = scale * sum_j ds_ij k_j
//   kernel D  flash_bwd_dkv_sm90_kernel  replaces _bwd_dkv_kernel (attention.py:146,
//             pallas_call at 287):       dv_j = sum_i p_ij dO_i,
//                                        dk_j = scale * sum_i ds_ij q_i
//
// with p_ij = exp(scale * q_i.k_j - L_i) recomputed from the forward's
// log-sum-exp L (kernel A, flash_attn_fwd.cu), dp_ij = dO_i.v_j,
// ds_ij = p_ij (dp_ij - D_i) and D_i = dO_i.O_i (computed by the caller, as
// the JAX package computes it outside its kernels). As on the TPU, ds is
// rounded to bf16 before its product with k (C) or q (D), p to bf16 before
// its product with dO (D), and every product accumulates in fp32.
//
// What bounds them on the H100: kernel C does 3 products of 2*N*M*D flops
// per head (S, dP, dS K) and kernel D 4 (S, dP, P^T dO, dS^T Q), against a
// few bytes per element of q, k, v, dO; at the UNet's long self-attention
// (N = M >= 1024) the tensor cores bound both, at M = 77 and short N the
// bytes do.
//
// What the designs do about that: the split of the TPU kernels, one pass
// over K/V per query tile (C) and one pass over Q/dO per key tile (D), so
// neither needs atomics and both are deterministic. Both are warp-
// specialised like kernel A (flash_attn_fwd.cu): a block of 3 warpgroups,
// of which warpgroup 2 is the producer (one thread issues every TMA load;
// the warpgroup gives its registers away with setmaxnreg.dec) and
// warpgroups 0 and 1 are consumers of 64 rows each that run every product
// on wgmma (bf16 in, fp32 accumulate). Tiles come through 4-D tensor maps
// over the caller's strided [B, N, H, D] layout, 128-byte swizzled, with
// full/empty mbarriers per stage; rows past N or M arrive as zeros and are
// masked in-kernel rather than padded.
//
// Kernel C (version 2): a block owns 128 queries of one (batch, head). Its
// Q and dO tiles are loaded once by TMA; K and V tiles of 64 keys stream
// through a ring of 3 stages. Each consumer holds L * log2(e) and D of its
// rows in registers and, per K/V tile, runs S = Q K^T and dP = dO V^T as
// m64n64k16 from shared memory (both operands K-major), committed as two
// groups so that P = exp2(S scale log2(e) - L log2(e)) is computed while dP
// is still in flight; then dS = P (dP - D), rounded to bf16 in registers as
// the A fragments of dQ += dS K (m64n64k16 with K through the transpose
// bit: K stays [key][d]). Keys past M (zero-filled, so scoring 0, not
// -inf) get p = 0; rows past N have L = +inf (p = 0) and are not stored. A
// consumer whose 64 rows all lie past N (N <= 64, or the last block) leaves
// at once, and the producer's empty barriers count only the live consumers.
//
// Kernel D (version 2): a block owns 128 keys; the producer loads its K and
// V once and streams 64-query tiles of Q and dO by TMA (and L, D by plain
// loads) through a 2-stage ring; each consumer owns 64 keys and runs all
// four products on wgmma: S^T = K Q^T and dP^T = V dO^T from shared memory
// (K-major), then dV += P^T dO and dK += dS^T Q with P^T and dS^T from
// registers and Q, dO through the transpose bit.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC  (see dreammat_tpu_torch/ops/kernels.py)

#include "hopper.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;

// 2^x on the special-function unit (flushes denormals to zero)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Kernel C (version 2, wgmma + TMA): one block per (128-query tile, batch *
// head), 3 warpgroups. Warpgroups 0 and 1 are consumers, 64 queries each;
// thread 256 of the producer warpgroup loads Q and dO once and streams K
// and V tiles of 64 keys through a ring of 3 stages.
namespace dqk {

constexpr int D = 64;
constexpr int BLOCK_M = 128;      // queries per block, 64 per consumer warpgroup
constexpr int TILE_N = 64;        // keys per streamed tile
constexpr int STAGES = 3;
constexpr int NUM_THREADS = 384;  // consumers: warpgroups 0 and 1; producer: warpgroup 2
constexpr int PRODUCER_THREAD = 256;
constexpr uint32_t Q_BYTES = BLOCK_M * D * 2;   // one 128 x 64 bf16 tile
constexpr uint32_t KV_BYTES = TILE_N * D * 2;   // one 64 x 64 bf16 tile

struct Smem {  // at a 1024-byte-aligned address; every tile a multiple of 8 KB
  __nv_bfloat16 q[BLOCK_M * D];
  __nv_bfloat16 dout[BLOCK_M * D];
  __nv_bfloat16 k[STAGES][TILE_N * D];
  __nv_bfloat16 v[STAGES][TILE_N * D];
  uint64_t q_full;
  uint64_t full[STAGES];   // K and V of a stage, one transaction count
  uint64_t empty[STAGES];  // one arrival per live consumer warp
};
constexpr int SMEM_BYTES = sizeof(Smem) + 1024;

__global__ void __launch_bounds__(NUM_THREADS, 1)
flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dq, int N, int M, int H,
                         long long dq_sb, long long dq_sn, long long dq_sh, float scale) {
  namespace hp = hopper;
  extern __shared__ uint8_t smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(hp::align1024(smem_raw));

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int m0 = blockIdx.x * BLOCK_M;
  const int n_tiles = (M + TILE_N - 1) / TILE_N;
  const int live_wgs = N - m0 > 64 ? 2 : 1;  // consumers with a row below N

  if (tid == 0) {
    hp::mbar_init(&s.q_full, 1);
#pragma unroll
    for (int st = 0; st < STAGES; ++st) {
      hp::mbar_init(&s.full[st], 1);
      hp::mbar_init(&s.empty[st], 4 * live_wgs);
    }
    hp::mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: Q and dO, then K_t and V_t in order, each into a free stage ----
    hp::setmaxnreg_dec<24>();
    if (tid == PRODUCER_THREAD) {
      hp::tma_prefetch_map(&tm_k);
      hp::tma_prefetch_map(&tm_v);
      hp::mbar_arrive_expect_tx(&s.q_full, 2 * Q_BYTES);
      hp::tma_load_4d(s.q, &tm_q, &s.q_full, 0, h, m0, b);
      hp::tma_load_4d(s.dout, &tm_do, &s.q_full, 0, h, m0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % STAGES;
        hp::mbar_wait(&s.empty[st], ((t / STAGES) & 1) ^ 1);  // the first round passes
        hp::mbar_arrive_expect_tx(&s.full[st], 2 * KV_BYTES);
        hp::tma_load_4d(s.k[st], &tm_k, &s.full[st], 0, h, t * TILE_N, b);
        hp::tma_load_4d(s.v[st], &tm_v, &s.full[st], 0, h, t * TILE_N, b);
      }
    }
  } else if (wg < live_wgs) {
    // ---- consumers: warpgroup wg owns queries m0 + 64 wg .. + 63 ----
    hp::setmaxnreg_inc<240>();
    const int warp = (tid >> 5) & 3;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int tq = lane & 3;
    const float scale_log2 = scale * LOG2E;
    const uint64_t q_desc = hp::smem_desc(hp::smem_u32(s.q) + wg * 64 * D * 2);
    const uint64_t do_desc = hp::smem_desc(hp::smem_u32(s.dout) + wg * 64 * D * 2);

    // L * log2(e) and D of rows g and g + 8 of this warp; L = +inf past N
    const int row0 = m0 + wg * 64 + warp * 16 + g;
    float lse2[2], dcap[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      const bool ok = row < N;
      lse2[i] = ok ? lse[(long long)bh * N + row] * LOG2E : __int_as_float(0x7f800000);
      dcap[i] = ok ? delta[(long long)bh * N + row] : 0.f;
    }

    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;

    hp::mbar_wait(&s.q_full, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % STAGES;
      hp::mbar_wait(&s.full[st], (t / STAGES) & 1);
      const uint64_t k_desc = hp::smem_desc(hp::smem_u32(s.k[st]));
      const uint64_t v_desc = hp::smem_desc(hp::smem_u32(s.v[st]));

      // S = Q K^T and dP = dO V^T: 64 queries x 64 keys each, two groups
      float sc[32], dp[32];
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hp::wgmma_ss_m64n64k16(sc, q_desc + kk * hp::DESC_K16_KMAJOR,
                               k_desc + kk * hp::DESC_K16_KMAJOR, kk > 0);
      hp::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hp::wgmma_ss_m64n64k16(dp, do_desc + kk * hp::DESC_K16_KMAJOR,
                               v_desc + kk * hp::DESC_K16_KMAJOR, kk > 0);
      hp::wgmma_commit();

      // P = exp2(S scale log2(e) - L log2(e)), in place, while dP runs;
      // keys past M (zero-filled by TMA) get p = 0
      hp::wgmma_wait<1>();
      hp::fence_regs(sc);
      const int n0 = t * TILE_N;
#pragma unroll
      for (int j = 0; j < TILE_N / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sc[4 * j + e] = ex2(fmaf(sc[4 * j + e], scale_log2, -lse2[0]));
          sc[4 * j + 2 + e] = ex2(fmaf(sc[4 * j + 2 + e], scale_log2, -lse2[1]));
        }
      }
      if (n0 + TILE_N > M) {  // only the last tile can hold keys past M
#pragma unroll
        for (int j = 0; j < TILE_N / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (n0 + j * 8 + 2 * tq + e >= M) {
              sc[4 * j + e] = 0.f;
              sc[4 * j + 2 + e] = 0.f;
            }
          }
        }
      }

      // dS = P (dP - D), rounded to bf16 as the A fragments of dS K
      hp::wgmma_wait<0>();
      hp::fence_regs(dp);
      uint32_t sf[TILE_N / 16][4];
#pragma unroll
      for (int j = 0; j < TILE_N / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sc[4 * j + e] *= dp[4 * j + e] - dcap[0];
          sc[4 * j + 2 + e] *= dp[4 * j + 2 + e] - dcap[1];
        }
        sf[j >> 1][(j & 1) * 2 + 0] = hp::pack_bf16(sc[4 * j], sc[4 * j + 1]);
        sf[j >> 1][(j & 1) * 2 + 1] = hp::pack_bf16(sc[4 * j + 2], sc[4 * j + 3]);
      }

      // dQ += dS K (K through the transpose bit: it stays [key][d])
      hp::fence_regs(acc);
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TILE_N / 16; ++kk)
        hp::wgmma_rs_m64n64k16_bt(acc, sf[kk], k_desc + kk * hp::DESC_K16_NMAJOR, 1);
      hp::wgmma_commit();
      hp::wgmma_wait<0>();
      hp::fence_regs(acc);
      hp::fence_regs(sf);
      if (lane == 0) hp::mbar_arrive(&s.empty[st]);
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      if (row >= N) continue;
      __nv_bfloat16* dst = dq + b * dq_sb + (long long)row * dq_sn + h * dq_sh;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        *reinterpret_cast<__nv_bfloat162*>(dst + n * 8 + 2 * tq) =
            __floats2bfloat162_rn(acc[4 * n + 2 * i] * scale, acc[4 * n + 2 * i + 1] * scale);
      }
    }
  }
}

}  // namespace dqk

// Kernel D (version 2, wgmma + TMA): one block per (128-key tile, batch *
// head), 3 warpgroups. Warpgroups 0 and 1 are consumers, 64 keys each;
// warpgroup 2 is the producer, whose first warp loads the block's K and V
// once and then streams tiles of 64 queries through a ring of 2 stages:
// Q and dO by TMA, and L * log2(e) and D by plain loads into shared memory
// (L is +inf past N, so p = 0 there before dV and dK use it).
namespace dkv {

constexpr int D = 64;
constexpr int BLOCK_N = 128;      // keys per block, 64 per consumer warpgroup
constexpr int TILE_M = 64;        // queries per streamed tile
constexpr int STAGES = 2;
constexpr int NUM_THREADS = 384;  // consumers: warpgroups 0 and 1; producer: warpgroup 2
constexpr int PRODUCER_WARP = 8;
constexpr uint32_t KV_BYTES = BLOCK_N * D * 2;  // one 128 x 64 bf16 tile
constexpr uint32_t Q_BYTES = TILE_M * D * 2;    // one 64 x 64 bf16 tile

struct Smem {  // at a 1024-byte-aligned address; every tile a multiple of 8 KB
  __nv_bfloat16 k[BLOCK_N * D];
  __nv_bfloat16 v[BLOCK_N * D];
  __nv_bfloat16 q[STAGES][TILE_M * D];
  __nv_bfloat16 dout[STAGES][TILE_M * D];
  float lse2[STAGES][TILE_M];   // L * log2(e) of the tile's queries, +inf past N
  float delta[STAGES][TILE_M];  // D of the tile's queries, 0 past N
  uint64_t kv_full;
  uint64_t full[STAGES];
  uint64_t empty[STAGES];  // one arrival per consumer warp
};
constexpr int SMEM_BYTES = sizeof(Smem) + 1024;

__global__ void __launch_bounds__(NUM_THREADS, 1)
flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                          int N, int M, int H,
                          long long dk_sb, long long dk_sn, long long dk_sh,
                          long long dv_sb, long long dv_sn, long long dv_sh, float scale) {
  namespace hp = hopper;
  extern __shared__ uint8_t smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(hp::align1024(smem_raw));

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int lane = tid & 31;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int n0 = blockIdx.x * BLOCK_N;
  const int n_tiles = (N + TILE_M - 1) / TILE_M;

  if (tid == 0) {
    hp::mbar_init(&s.kv_full, 1);
#pragma unroll
    for (int st = 0; st < STAGES; ++st) {
      hp::mbar_init(&s.full[st], 1);
      hp::mbar_init(&s.empty[st], 8);
    }
    hp::mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer ----
    hp::setmaxnreg_dec<24>();
    if ((tid >> 5) == PRODUCER_WARP) {
      const float inf = __int_as_float(0x7f800000);
      const float* lse_bh = lse + (long long)bh * N;
      const float* delta_bh = delta + (long long)bh * N;
      if (lane == 0) {
        hp::tma_prefetch_map(&tm_q);
        hp::tma_prefetch_map(&tm_do);
        hp::mbar_arrive_expect_tx(&s.kv_full, 2 * KV_BYTES);
        hp::tma_load_4d(s.k, &tm_k, &s.kv_full, 0, h, n0, b);
        hp::tma_load_4d(s.v, &tm_v, &s.kv_full, 0, h, n0, b);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % STAGES;
        hp::mbar_wait(&s.empty[st], ((t / STAGES) & 1) ^ 1);  // the first round passes
        for (int i = lane; i < TILE_M; i += 32) {
          const int r = t * TILE_M + i;
          const bool ok = r < N;
          s.lse2[st][i] = ok ? lse_bh[r] * LOG2E : inf;
          s.delta[st][i] = ok ? delta_bh[r] : 0.f;
        }
        __syncwarp();  // the stats are written before lane 0's arrival releases them
        if (lane == 0) {
          hp::mbar_arrive_expect_tx(&s.full[st], 2 * Q_BYTES);
          hp::tma_load_4d(s.q[st], &tm_q, &s.full[st], 0, h, t * TILE_M, b);
          hp::tma_load_4d(s.dout[st], &tm_do, &s.full[st], 0, h, t * TILE_M, b);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns keys n0 + 64 wg .. + 63 ----
    hp::setmaxnreg_inc<240>();
    const int warp = (tid >> 5) & 3;
    const int tq = lane & 3;
    const float scale_log2 = scale * LOG2E;
    const uint64_t k_desc = hp::smem_desc(hp::smem_u32(s.k) + wg * 64 * D * 2);
    const uint64_t v_desc = hp::smem_desc(hp::smem_u32(s.v) + wg * 64 * D * 2);

    float dk_acc[32], dv_acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[i] = dv_acc[i] = 0.f;

    hp::mbar_wait(&s.kv_full, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % STAGES;
      hp::mbar_wait(&s.full[st], (t / STAGES) & 1);
      const uint64_t q_desc = hp::smem_desc(hp::smem_u32(s.q[st]));
      const uint64_t do_desc = hp::smem_desc(hp::smem_u32(s.dout[st]));

      // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries each, two groups
      float sc[32], dp[32];
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hp::wgmma_ss_m64n64k16(sc, k_desc + kk * hp::DESC_K16_KMAJOR,
                               q_desc + kk * hp::DESC_K16_KMAJOR, kk > 0);
      hp::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hp::wgmma_ss_m64n64k16(dp, v_desc + kk * hp::DESC_K16_KMAJOR,
                               do_desc + kk * hp::DESC_K16_KMAJOR, kk > 0);
      hp::wgmma_commit();

      // this thread's query columns 8j + 2tq + e: their L * log2(e) and D
      float l2[16], dc[16];
#pragma unroll
      for (int j = 0; j < TILE_M / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          l2[2 * j + e] = s.lse2[st][j * 8 + 2 * tq + e];
          dc[2 * j + e] = s.delta[st][j * 8 + 2 * tq + e];
        }
      }

      // P^T = exp2(S^T scale log2(e) - L log2(e)), in place, and as bf16 A fragments
      hp::wgmma_wait<1>();
      hp::fence_regs(sc);
      uint32_t af[TILE_M / 16][4];
#pragma unroll
      for (int j = 0; j < TILE_M / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sc[4 * j + e] = ex2(fmaf(sc[4 * j + e], scale_log2, -l2[2 * j + e]));
          sc[4 * j + 2 + e] = ex2(fmaf(sc[4 * j + 2 + e], scale_log2, -l2[2 * j + e]));
        }
        af[j >> 1][(j & 1) * 2 + 0] = hp::pack_bf16(sc[4 * j], sc[4 * j + 1]);
        af[j >> 1][(j & 1) * 2 + 1] = hp::pack_bf16(sc[4 * j + 2], sc[4 * j + 3]);
      }

      // dV += P^T dO (dO through the transpose bit: it stays [query][d])
      hp::fence_regs(dv_acc);
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TILE_M / 16; ++kk)
        hp::wgmma_rs_m64n64k16_bt(dv_acc, af[kk], do_desc + kk * hp::DESC_K16_NMAJOR, 1);
      hp::wgmma_commit();

      // dS^T = P^T (dP^T - D), rounded to bf16
      hp::wgmma_wait<1>();
      hp::fence_regs(dp);
      uint32_t sf[TILE_M / 16][4];
#pragma unroll
      for (int j = 0; j < TILE_M / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sc[4 * j + e] *= dp[4 * j + e] - dc[2 * j + e];
          sc[4 * j + 2 + e] *= dp[4 * j + 2 + e] - dc[2 * j + e];
        }
        sf[j >> 1][(j & 1) * 2 + 0] = hp::pack_bf16(sc[4 * j], sc[4 * j + 1]);
        sf[j >> 1][(j & 1) * 2 + 1] = hp::pack_bf16(sc[4 * j + 2], sc[4 * j + 3]);
      }

      // dK += dS^T Q (Q through the transpose bit)
      hp::fence_regs(dk_acc);
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TILE_M / 16; ++kk)
        hp::wgmma_rs_m64n64k16_bt(dk_acc, sf[kk], q_desc + kk * hp::DESC_K16_NMAJOR, 1);
      hp::wgmma_commit();
      hp::wgmma_wait<0>();
      hp::fence_regs(dv_acc);
      hp::fence_regs(dk_acc);
      hp::fence_regs(af);
      hp::fence_regs(sf);
      if (lane == 0) hp::mbar_arrive(&s.empty[st]);
    }

    const int g = lane >> 2;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = n0 + wg * 64 + warp * 16 + g + 8 * i;
      if (row >= M) continue;
      __nv_bfloat16* kd = dk + b * dk_sb + (long long)row * dk_sn + h * dk_sh;
      __nv_bfloat16* vd = dv + b * dv_sb + (long long)row * dv_sn + h * dv_sh;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        *reinterpret_cast<__nv_bfloat162*>(kd + n * 8 + 2 * tq) = __floats2bfloat162_rn(
            dk_acc[4 * n + 2 * i] * scale, dk_acc[4 * n + 2 * i + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(vd + n * 8 + 2 * tq) =
            __floats2bfloat162_rn(dv_acc[4 * n + 2 * i], dv_acc[4 * n + 2 * i + 1]);
      }
    }
  }
}

}  // namespace dkv
}  // namespace

// Returns 0, a cudaError_t, or a negative tensor-map error (hopper.cuh).
extern "C" int flash_attn_bwd_dq_bf16_d64(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, void* dq, int B, int N, int M, int H,
    long long q_sb, long long q_sn, long long q_sh,
    long long k_sb, long long k_sn, long long k_sh,
    long long v_sb, long long v_sn, long long v_sh,
    long long do_sb, long long do_sn, long long do_sh,
    long long dq_sb, long long dq_sn, long long dq_sh,
    float scale, void* stream) {
  using hopper_host::encode_bhnd;
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  int rc;
  if ((rc = encode_bhnd(&tm_q, q, B, N, H, q_sb, q_sn, q_sh, dqk::BLOCK_M)) != 0) return rc;
  if ((rc = encode_bhnd(&tm_do, dout, B, N, H, do_sb, do_sn, do_sh, dqk::BLOCK_M)) != 0) return rc;
  if ((rc = encode_bhnd(&tm_k, k, B, M, H, k_sb, k_sn, k_sh, dqk::TILE_N)) != 0) return rc;
  if ((rc = encode_bhnd(&tm_v, v, B, M, H, v_sb, v_sn, v_sh, dqk::TILE_N)) != 0) return rc;
  static const cudaError_t attr =
      cudaFuncSetAttribute(dqk::flash_bwd_dq_sm90_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, dqk::SMEM_BYTES);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((N + dqk::BLOCK_M - 1) / dqk::BLOCK_M, B * H);
  dqk::flash_bwd_dq_sm90_kernel<<<grid, dqk::NUM_THREADS, dqk::SMEM_BYTES, (cudaStream_t)stream>>>(
      tm_q, tm_k, tm_v, tm_do, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dq), N, M, H, dq_sb, dq_sn, dq_sh, scale);
  return (int)cudaGetLastError();
}


// Returns 0, a cudaError_t, or a negative tensor-map error (hopper.cuh).
extern "C" int flash_attn_bwd_dkv_bf16_d64(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, void* dk, void* dv, int B, int N, int M, int H,
    long long q_sb, long long q_sn, long long q_sh,
    long long k_sb, long long k_sn, long long k_sh,
    long long v_sb, long long v_sn, long long v_sh,
    long long do_sb, long long do_sn, long long do_sh,
    long long dk_sb, long long dk_sn, long long dk_sh,
    long long dv_sb, long long dv_sn, long long dv_sh,
    float scale, void* stream) {
  using hopper_host::encode_bhnd;
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  int rc;
  if ((rc = encode_bhnd(&tm_q, q, B, N, H, q_sb, q_sn, q_sh, dkv::TILE_M)) != 0) return rc;
  if ((rc = encode_bhnd(&tm_do, dout, B, N, H, do_sb, do_sn, do_sh, dkv::TILE_M)) != 0) return rc;
  if ((rc = encode_bhnd(&tm_k, k, B, M, H, k_sb, k_sn, k_sh, dkv::BLOCK_N)) != 0) return rc;
  if ((rc = encode_bhnd(&tm_v, v, B, M, H, v_sb, v_sn, v_sh, dkv::BLOCK_N)) != 0) return rc;
  static const cudaError_t attr =
      cudaFuncSetAttribute(dkv::flash_bwd_dkv_sm90_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, dkv::SMEM_BYTES);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((M + dkv::BLOCK_N - 1) / dkv::BLOCK_N, B * H);
  dkv::flash_bwd_dkv_sm90_kernel<<<grid, dkv::NUM_THREADS, dkv::SMEM_BYTES,
                                   (cudaStream_t)stream>>>(
      tm_q, tm_k, tm_v, tm_do, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), N, M, H, dk_sb, dk_sn,
      dk_sh, dv_sb, dv_sn, dv_sh, scale);
  return (int)cudaGetLastError();
}
