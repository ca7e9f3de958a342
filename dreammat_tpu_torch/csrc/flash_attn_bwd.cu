// Flash-attention backward for Hopper (sm_90a), bf16 in / bf16 out, D = 64.
//
// Two kernels, one for each Pallas TPU kernel of dreammat_tpu/ops/attention.py
// (both launched by _flash_backward):
//
//   kernel C  flash_bwd_dq_kernel   replaces _bwd_dq_kernel  (attention.py:115,
//             pallas_call at 271): dq_i = scale * sum_j ds_ij k_j
//   kernel D  flash_bwd_dkv_kernel  replaces _bwd_dkv_kernel (attention.py:146,
//             pallas_call at 287): dv_j = sum_i p_ij dO_i,
//                                  dk_j = scale * sum_i ds_ij q_i
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
// What the design does about that: the split of the TPU kernels, one pass
// over K/V per query tile (C) and one pass over Q/dO per key tile (D), so
// neither needs atomics and both are deterministic. One block of 4 warps
// owns 64 rows of one (batch, head), 16 per warp; its own rows live in
// registers as mma A operands for the whole pass, and the streamed tiles of
// 64 rows go through shared memory with cp.async, double-buffered. The
// block's own tiles are staged through the second buffer before the loop
// first refills it, so a block needs 37 KB of static shared memory. Every
// product is mma.sync m16n8k16 (bf16 in, fp32 accumulate) with operands
// fetched by ldmatrix (.trans where the streamed tile is the k-major side)
// from rows padded to 72 elements. The score accumulators are laid out as
// the A operand of the next product (the FlashAttention-2 arrangement), so
// P and dS never leave registers. Reads and writes go through the caller's
// [B, N, H, D] strides; ragged N and M are masked in-kernel (zero-filled
// loads and p = 0 outside the sequence) rather than padded. Not yet: wgmma,
// TMA, a fused single-kernel backward.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC  (see dreammat_tpu_torch/ops/kernels.py)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// Kernel D: one block per (64-row key tile, batch * head)
template <int D>
__global__ void __launch_bounds__(NUM_THREADS)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                     int N, int M, int H,
                     long long q_sb, long long q_sn, long long q_sh,
                     long long k_sb, long long k_sn, long long k_sh,
                     long long v_sb, long long v_sn, long long v_sh,
                     long long do_sb, long long do_sn, long long do_sh,
                     long long dk_sb, long long dk_sn, long long dk_sh,
                     long long dv_sb, long long dv_sn, long long dv_sh, float scale) {
  static_assert(D % 16 == 0, "the products step through D in 16s");
  constexpr int LDS = D + 8;
  __shared__ __align__(128) __nv_bfloat16 sQ[2][TILE * LDS];
  __shared__ __align__(128) __nv_bfloat16 sO[2][TILE * LDS];  // dO tiles
  __shared__ float sL[2][TILE];  // L * log2(e) of the tile's queries
  __shared__ float sD[2][TILE];  // D of the tile's queries

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int n0 = blockIdx.x * BLOCK;

  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kb = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + h * v_sh;
  const __nv_bfloat16* dob = dout + b * do_sb + h * do_sh;
  const float* lse_bh = lse + (long long)bh * N;
  const float* delta_bh = delta + (long long)bh * N;

  // plain loads; the __syncthreads at the top of the iteration that reads
  // them makes them visible
  auto load_stats = [&](int tile, int buf) {
    for (int i = tid; i < TILE; i += NUM_THREADS) {
      const int r = tile * TILE + i;
      const bool ok = r < N;
      sL[buf][i] = ok ? lse_bh[r] * LOG2E : 0.f;
      sD[buf][i] = ok ? delta_bh[r] : 0.f;
    }
  };

  // K and V pass through buffer 1, which the loop refills with Q/dO tile 1
  load_tile<D>(sQ[1], kb, k_sn, n0, M, tid);
  load_tile<D>(sO[1], vb, v_sn, n0, M, tid);
  load_tile<D>(sQ[0], qb, q_sn, 0, N, tid);
  load_tile<D>(sO[0], dob, do_sn, 0, N, tid);
  cp_async_commit();
  load_stats(0, 0);
  cp_async_wait<0>();
  __syncthreads();
  uint32_t kf[D / 16][4], vf[D / 16][4];
  load_a<D>(kf, sQ[1], warp, lane);
  load_a<D>(vf, sO[1], warp, lane);
  __syncthreads();  // buffer 1 is free

  const float scale_log2 = scale * LOG2E;
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    dk_acc[n][0] = dk_acc[n][1] = dk_acc[n][2] = dk_acc[n][3] = 0.f;
    dv_acc[n][0] = dv_acc[n][1] = dv_acc[n][2] = dv_acc[n][3] = 0.f;
  }

  const int n_tiles = (N + TILE - 1) / TILE;
  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) {
      load_tile<D>(sQ[buf ^ 1], qb, q_sn, (t + 1) * TILE, N, tid);
      load_tile<D>(sO[buf ^ 1], dob, do_sn, (t + 1) * TILE, N, tid);
    }
    cp_async_commit();
    if (t + 1 < n_tiles) load_stats(t + 1, buf ^ 1);
    cp_async_wait<1>();
    __syncthreads();

    // P^T = exp(scale K Q^T - L): rows are this warp's keys, columns queries
    float s[TILE / 8][4];
    mma_abt<D>(s, kf, sQ[buf], lane);
    const int i0 = t * TILE;
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = j * 8 + 2 * tq + e;
        const bool valid = i0 + col < N;
        const float l2 = sL[buf][col];
        s[j][e] = valid ? exp2f(fmaf(s[j][e], scale_log2, -l2)) : 0.f;
        s[j][2 + e] = valid ? exp2f(fmaf(s[j][2 + e], scale_log2, -l2)) : 0.f;
      }
    }
    uint32_t af[TILE / 16][4];
    pack_a(af, s);
    mma_ab<D>(dv_acc, af, sO[buf], lane);  // dV += P^T dO

    float dp[TILE / 8][4];
    mma_abt<D>(dp, vf, sO[buf], lane);  // dP^T = V dO^T
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float dc = sD[buf][j * 8 + 2 * tq + e];
        s[j][e] *= dp[j][e] - dc;  // dS^T, in place
        s[j][2 + e] *= dp[j][2 + e] - dc;
      }
    }
    pack_a(af, s);
    mma_ab<D>(dk_acc, af, sQ[buf], lane);  // dK += dS^T Q
    __syncthreads();  // every warp is done with buf before it is refilled
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = n0 + warp * 16 + g + 8 * i;
    if (row >= M) continue;
    __nv_bfloat16* kd = dk + b * dk_sb + (long long)row * dk_sn + h * dk_sh;
    __nv_bfloat16* vd = dv + b * dv_sb + (long long)row * dv_sn + h * dv_sh;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(kd + n * 8 + 2 * tq) =
          __floats2bfloat162_rn(dk_acc[n][2 * i] * scale, dk_acc[n][2 * i + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(vd + n * 8 + 2 * tq) =
          __floats2bfloat162_rn(dv_acc[n][2 * i], dv_acc[n][2 * i + 1]);
    }
  }
}

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
  dim3 grid((M + BLOCK - 1) / BLOCK, B * H);
  flash_bwd_dkv_kernel<64><<<grid, NUM_THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), N, M, H,
      q_sb, q_sn, q_sh, k_sb, k_sn, k_sh, v_sb, v_sn, v_sh, do_sb, do_sn, do_sh,
      dk_sb, dk_sn, dk_sh, dv_sb, dv_sn, dv_sh, scale);
  return (int)cudaGetLastError();
}
