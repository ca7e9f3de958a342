// Flash-attention backward for Hopper (sm_90a), bf16 in / bf16 out, D = 64.
//
// Two kernels, one for each Pallas TPU kernel of dreammat_tpu/ops/attention.py
// (both launched by _flash_backward):
//
//   kernel C  flash_bwd_dq_kernel        replaces _bwd_dq_kernel  (attention.py:115,
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
// neither needs atomics and both are deterministic. Ragged N and M are
// masked in-kernel (zero-filled loads, p = 0 outside the sequence) rather
// than padded; reads and writes go through the caller's [B, N, H, D] strides.
//
// Kernel C (version 1, the Ampere arrangement): one block of 4 warps owns
// 64 query rows, 16 per warp, held in registers as mma A operands; K/V tiles
// of 64 rows stream through shared memory with cp.async, double-buffered.
// Every product is mma.sync m16n8k16 with operands fetched by ldmatrix
// (.trans where the streamed tile is the k-major side) from rows padded to
// 72 elements; the score accumulators are laid out as the A operand of the
// next product, so dS never leaves registers. Not yet: wgmma, TMA.
//
// Kernel D (version 2, Hopper): warp-specialised like kernel A
// (flash_attn_fwd.cu). A block of 3 warpgroups owns 128 keys; the producer
// loads its K and V once by TMA and streams 64-query tiles of Q and dO by
// TMA (and L, D by plain loads) through a 2-stage ring with mbarriers; each
// of the 2 consumer warpgroups owns 64 keys and runs all four products on
// wgmma: S^T = K Q^T and dP^T = V dO^T from shared memory (K-major), then
// dV += P^T dO and dK += dS^T Q with P^T and dS^T from registers and Q, dO
// through the transpose bit. Its registers: dK, dV, S^T and dP^T take 32
// fp32 each per thread.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC  (see dreammat_tpu_torch/ops/kernels.py)

#include "hopper.cuh"

namespace {

constexpr int BLOCK = 64;  // the block's own rows: queries (C) or keys (D), 16 per warp
constexpr int TILE = 64;   // rows of each streamed tile
constexpr int NUM_THREADS = 128;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; zero-fills the destination when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a * b for one 16x8x16 tile (a: 16x16 row-major, b: 16x8 column-major)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows [r0, r0 + 64) of a [n, D] bf16 matrix (row stride in elements) into
// a padded shared tile; rows past n are zero-filled
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* base,
                                          long long row_stride, int r0, int n, int tid) {
  constexpr int LDS = D + 8;
  constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
  for (int i = tid; i < TILE * CHUNKS; i += NUM_THREADS) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * 8;
    const bool ok = r0 + r < n;
    cp_async16(&dst[r * LDS + c], base + (long long)(ok ? r0 + r : 0) * row_stride + c, ok);
  }
}

// this warp's 16 rows of a shared tile as mma A operands, one per 16 of D
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&f)[D / 16][4], const __nv_bfloat16* s,
                                       int warp, int lane) {
  constexpr int LDS = D + 8;
  const int row = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) ldmatrix_x4(f[kk], &s[row * LDS + kk * 16 + (lane >> 4) * 8]);
}

// c = a * s^T: a holds this warp's 16 rows x D, s a shared [64, D] tile;
// c is 16 x 64 (column = row of s)
template <int D>
__device__ __forceinline__ void mma_abt(float (&c)[TILE / 8][4], const uint32_t (&a)[D / 16][4],
                                        const __nv_bfloat16* s, int lane) {
  constexpr int LDS = D + 8;
#pragma unroll
  for (int j = 0; j < TILE / 8; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int jj = 0; jj < TILE / 16; ++jj) {
      uint32_t b[4];
      const int r = jj * 16 + (lane & 7) + ((lane >> 4) & 1) * 8;
      ldmatrix_x4(b, &s[r * LDS + kk * 16 + ((lane >> 3) & 1) * 8]);
      mma_bf16(c[2 * jj], a[kk], b[0], b[1]);
      mma_bf16(c[2 * jj + 1], a[kk], b[2], b[3]);
    }
  }
}

// c += a * s: a holds 16 x 64 (the contraction runs over the rows of s),
// s a shared [64, D] tile; c is 16 x D
template <int D>
__device__ __forceinline__ void mma_ab(float (&c)[D / 8][4], const uint32_t (&a)[TILE / 16][4],
                                       const __nv_bfloat16* s, int lane) {
  constexpr int LDS = D + 8;
#pragma unroll
  for (int kk = 0; kk < TILE / 16; ++kk) {
#pragma unroll
    for (int nn = 0; nn < D / 16; ++nn) {
      uint32_t b[4];
      const int r = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
      ldmatrix_x4_trans(b, &s[r * LDS + nn * 16 + ((lane >> 4) & 1) * 8]);
      mma_bf16(c[2 * nn], a[kk], b[0], b[1]);
      mma_bf16(c[2 * nn + 1], a[kk], b[2], b[3]);
    }
  }
}

// accumulators of a 16 x 64 product, rounded to bf16, as the A operand of
// the next product: k-step kk covers 8-column tiles 2kk and 2kk+1
__device__ __forceinline__ void pack_a(uint32_t (&a)[TILE / 16][4], const float (&c)[TILE / 8][4]) {
#pragma unroll
  for (int j = 0; j < TILE / 8; ++j) {
    a[j >> 1][(j & 1) * 2 + 0] = pack_bf16(c[j][0], c[j][1]);
    a[j >> 1][(j & 1) * 2 + 1] = pack_bf16(c[j][2], c[j][3]);
  }
}

// Accumulator element (j, e) of a thread sits at rows g (e < 2) and g + 8
// (e >= 2) and column j * 8 + 2 * tq + (e & 1) of the warp's 16 x 64 tile.

// Kernel C: one block per (64-row query tile, batch * head)
template <int D>
__global__ void __launch_bounds__(NUM_THREADS)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, int N, int M, int H,
                    long long q_sb, long long q_sn, long long q_sh,
                    long long k_sb, long long k_sn, long long k_sh,
                    long long v_sb, long long v_sn, long long v_sh,
                    long long do_sb, long long do_sn, long long do_sh,
                    long long dq_sb, long long dq_sn, long long dq_sh, float scale) {
  static_assert(D % 16 == 0, "the products step through D in 16s");
  constexpr int LDS = D + 8;
  __shared__ __align__(128) __nv_bfloat16 sK[2][TILE * LDS];
  __shared__ __align__(128) __nv_bfloat16 sV[2][TILE * LDS];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int m0 = blockIdx.x * BLOCK;

  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kb = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + h * v_sh;
  const __nv_bfloat16* dob = dout + b * do_sb + h * do_sh;

  // Q and dO pass through buffer 1, which the loop refills with K/V tile 1
  load_tile<D>(sK[1], qb, q_sn, m0, N, tid);
  load_tile<D>(sV[1], dob, do_sn, m0, N, tid);
  load_tile<D>(sK[0], kb, k_sn, 0, M, tid);
  load_tile<D>(sV[0], vb, v_sn, 0, M, tid);
  cp_async_commit();

  const int rows[2] = {m0 + warp * 16 + g, m0 + warp * 16 + g + 8};
  float lse2[2], dcap[2];  // L * log2(e) and D of rows g and g+8
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool ok = rows[i] < N;
    lse2[i] = ok ? lse[(long long)bh * N + rows[i]] * LOG2E : 0.f;
    dcap[i] = ok ? delta[(long long)bh * N + rows[i]] : 0.f;
  }
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[D / 16][4], dof[D / 16][4];
  load_a<D>(qf, sK[1], warp, lane);
  load_a<D>(dof, sV[1], warp, lane);
  __syncthreads();  // buffer 1 is free

  const float scale_log2 = scale * LOG2E;
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int n_tiles = (M + TILE - 1) / TILE;
  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) {
      load_tile<D>(sK[buf ^ 1], kb, k_sn, (t + 1) * TILE, M, tid);
      load_tile<D>(sV[buf ^ 1], vb, v_sn, (t + 1) * TILE, M, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    float s[TILE / 8][4], dp[TILE / 8][4];
    mma_abt<D>(s, qf, sK[buf], lane);    // S = Q K^T
    mma_abt<D>(dp, dof, sV[buf], lane);  // dP = dO V^T
    const int n0 = t * TILE;
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool valid = n0 + j * 8 + 2 * tq + e < M;
        const float p0 = valid ? exp2f(fmaf(s[j][e], scale_log2, -lse2[0])) : 0.f;
        const float p1 = valid ? exp2f(fmaf(s[j][2 + e], scale_log2, -lse2[1])) : 0.f;
        s[j][e] = p0 * (dp[j][e] - dcap[0]);  // dS, in place
        s[j][2 + e] = p1 * (dp[j][2 + e] - dcap[1]);
      }
    }
    uint32_t dsf[TILE / 16][4];
    pack_a(dsf, s);
    mma_ab<D>(acc, dsf, sK[buf], lane);  // dQ += dS K
    __syncthreads();  // every warp is done with buf before it is refilled
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= N) continue;
    __nv_bfloat16* dst = dq + b * dq_sb + (long long)rows[i] * dq_sn + h * dq_sh;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dst + n * 8 + 2 * tq) =
          __floats2bfloat162_rn(acc[n][2 * i] * scale, acc[n][2 * i + 1] * scale);
    }
  }
}

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

// 2^x on the special-function unit (flushes denormals to zero)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

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

extern "C" int flash_attn_bwd_dq_bf16_d64(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, void* dq, int B, int N, int M, int H,
    long long q_sb, long long q_sn, long long q_sh,
    long long k_sb, long long k_sn, long long k_sh,
    long long v_sb, long long v_sn, long long v_sh,
    long long do_sb, long long do_sn, long long do_sh,
    long long dq_sb, long long dq_sn, long long dq_sh,
    float scale, void* stream) {
  dim3 grid((N + BLOCK - 1) / BLOCK, B * H);
  flash_bwd_dq_kernel<64><<<grid, NUM_THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dq), N, M, H, q_sb, q_sn, q_sh, k_sb, k_sn, k_sh,
      v_sb, v_sn, v_sh, do_sb, do_sn, do_sh, dq_sb, dq_sn, dq_sh, scale);
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
