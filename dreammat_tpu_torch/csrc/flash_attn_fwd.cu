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
// What the design does about that: the [N, M] score matrix never leaves
// registers. One block of 4 warps owns 64 query rows of one (batch, head);
// each warp owns 16 rows. K/V tiles of 64 keys stream through shared memory
// with cp.async, double-buffered so the next tile loads while this one is
// used. Both products run on the tensor cores as mma.sync m16n8k16 (bf16 in,
// fp32 accumulate), with operands fetched by ldmatrix (.trans for V) from
// rows padded to 72 elements so the fetches are free of bank conflicts. The
// score accumulators of Q K^T are laid out as the A operand of P V, so P
// goes from registers to the second product without shared memory (the
// FlashAttention-2 arrangement). The online softmax (running max and
// denominator) is fp32; the scale 1/sqrt(D) is applied in fp32 inside the
// exponent; P is rounded to bf16 for P V, as the TPU kernel does. Reads and
// writes go through the caller's [B, N, H, D] strides. Ragged N and M are
// masked (zero-filled loads, -inf scores). Not yet: wgmma, TMA, warp
// specialisation.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC  (see dreammat_tpu_torch/ops/kernels.py)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_M = 64;     // query rows per block, 16 per warp
constexpr int BLOCK_N = 64;     // keys per K/V tile
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

// D: the head dim, a multiple of 16; instantiated for 64 only
template <int D>
__global__ void __launch_bounds__(NUM_THREADS)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                 float* __restrict__ lse, int N, int M, int H,
                 long long q_sb, long long q_sn, long long q_sh,
                 long long k_sb, long long k_sn, long long k_sh,
                 long long v_sb, long long v_sn, long long v_sh,
                 long long o_sb, long long o_sn, long long o_sh, float scale) {
  static_assert(D % 16 == 0, "the products step through D in 16s");
  constexpr int LDS = D + 8;  // padded shared row (144 bytes at D = 64)
  __shared__ __align__(128) __nv_bfloat16 sQ[BLOCK_M * LDS];
  __shared__ __align__(128) __nv_bfloat16 sK[2][BLOCK_N * LDS];
  __shared__ __align__(128) __nv_bfloat16 sV[2][BLOCK_N * LDS];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;   // accumulator row (and row + 8) within the warp's 16
  const int tq = lane & 3;   // accumulator column pair within an 8-wide tile
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int m0 = blockIdx.x * BLOCK_M;

  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kb = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + h * v_sh;

  // Q tile and the first K/V tile: 16-byte chunks, 8 per row
  for (int i = tid; i < BLOCK_M * (D / 8); i += NUM_THREADS) {
    const int r = i >> 3, c = (i & 7) * 8;
    const bool ok = m0 + r < N;
    cp_async16(&sQ[r * LDS + c], qb + (long long)(ok ? m0 + r : 0) * q_sn + c, ok);
  }
  auto load_kv = [&](int tile, int buf) {
    const int n0 = tile * BLOCK_N;
    for (int i = tid; i < BLOCK_N * (D / 8); i += NUM_THREADS) {
      const int r = i >> 3, c = (i & 7) * 8;
      const bool ok = n0 + r < M;
      const long long row = ok ? n0 + r : 0;
      cp_async16(&sK[buf][r * LDS + c], kb + row * k_sn + c, ok);
      cp_async16(&sV[buf][r * LDS + c], vb + row * v_sn + c, ok);
    }
  };
  load_kv(0, 0);
  cp_async_commit();

  const float scale_log2 = scale * LOG2E;
  const float neg_inf = __int_as_float(0xff800000);
  uint32_t qf[D / 16][4];
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_run[2] = {neg_inf, neg_inf};  // running max of the raw scores, rows g and g+8
  float l_run[2] = {0.f, 0.f};          // this thread's share of the denominators

  const int n_tiles = (M + BLOCK_N - 1) / BLOCK_N;
  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) load_kv(t + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int row = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldmatrix_x4(qf[kk], &sQ[row * LDS + kk * 16 + (lane >> 4) * 8]);
      }
    }

    // S = Q K^T for this warp's 16 rows x 64 keys
    float s[BLOCK_N / 8][4];
#pragma unroll
    for (int j = 0; j < BLOCK_N / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int jj = 0; jj < BLOCK_N / 16; ++jj) {
        uint32_t kf[4];
        const int key = jj * 16 + (lane & 7) + ((lane >> 4) & 1) * 8;
        ldmatrix_x4(kf, &sK[buf][key * LDS + kk * 16 + ((lane >> 3) & 1) * 8]);
        mma_bf16(s[2 * jj], qf[kk], kf[0], kf[1]);
        mma_bf16(s[2 * jj + 1], qf[kk], kf[2], kf[3]);
      }
    }

    // mask the keys past M (only the last tile can hold any)
    const int n0 = t * BLOCK_N;
    if (n0 + BLOCK_N > M) {
#pragma unroll
      for (int j = 0; j < BLOCK_N / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (n0 + j * 8 + 2 * tq + e >= M) {
            s[j][e] = neg_inf;
            s[j][2 + e] = neg_inf;
          }
        }
      }
    }

    // online softmax; the four threads of a quad share rows g and g+8
    float mt[2] = {neg_inf, neg_inf};
#pragma unroll
    for (int j = 0; j < BLOCK_N / 8; ++j) {
      mt[0] = fmaxf(mt[0], fmaxf(s[j][0], s[j][1]));
      mt[1] = fmaxf(mt[1], fmaxf(s[j][2], s[j][3]));
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 1));
      mt[i] = fmaxf(mt[i], __shfl_xor_sync(0xffffffffu, mt[i], 2));
      const float m_new = fmaxf(m_run[i], mt[i]);
      alpha[i] = exp2f((m_run[i] - m_new) * scale_log2);
      m_run[i] = m_new;
    }

    // P (bf16) in the A-operand layout of P V: k-step kk covers tiles 2kk, 2kk+1
    uint32_t pf[BLOCK_N / 16][4];
    float ls[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < BLOCK_N / 8; ++j) {
      const float p0 = exp2f((s[j][0] - m_run[0]) * scale_log2);
      const float p1 = exp2f((s[j][1] - m_run[0]) * scale_log2);
      const float p2 = exp2f((s[j][2] - m_run[1]) * scale_log2);
      const float p3 = exp2f((s[j][3] - m_run[1]) * scale_log2);
      ls[0] += p0 + p1;
      ls[1] += p2 + p3;
      pf[j >> 1][(j & 1) * 2 + 0] = pack_bf16(p0, p1);
      pf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
    l_run[0] = l_run[0] * alpha[0] + ls[0];
    l_run[1] = l_run[1] * alpha[1] + ls[1];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += P V
#pragma unroll
    for (int kk = 0; kk < BLOCK_N / 16; ++kk) {
#pragma unroll
      for (int nn = 0; nn < D / 16; ++nn) {
        uint32_t vf[4];
        const int key = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldmatrix_x4_trans(vf, &sV[buf][key * LDS + nn * 16 + ((lane >> 4) & 1) * 8]);
        mma_bf16(acc[2 * nn], pf[kk], vf[0], vf[1]);
        mma_bf16(acc[2 * nn + 1], pf[kk], vf[2], vf[3]);
      }
    }
    __syncthreads();  // every warp is done with buf before it is refilled
  }

  // epilogue: O = acc / l, L = scale * m + ln(l)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
  }
  const int rows[2] = {m0 + warp * 16 + g, m0 + warp * 16 + g + 8};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= N) continue;
    const float inv = 1.f / l_run[i];
    __nv_bfloat16* orow = o + b * o_sb + (long long)rows[i] * o_sn + h * o_sh;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * tq) =
          __floats2bfloat162_rn(acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
    }
    if (tq == 0) lse[(long long)bh * N + rows[i]] = m_run[i] * scale + logf(l_run[i]);
  }
}

}  // namespace

extern "C" int flash_attn_fwd_bf16_d64(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int B, int N, int M, int H,
    long long q_sb, long long q_sn, long long q_sh,
    long long k_sb, long long k_sn, long long k_sh,
    long long v_sb, long long v_sn, long long v_sh,
    long long o_sb, long long o_sn, long long o_sh,
    float scale, void* stream) {
  dim3 grid((N + BLOCK_M - 1) / BLOCK_M, B * H);
  flash_fwd_kernel<64><<<grid, NUM_THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), N, M, H, q_sb, q_sn, q_sh, k_sb, k_sn, k_sh,
      v_sb, v_sn, v_sh, o_sb, o_sn, o_sh, scale);
  return (int)cudaGetLastError();
}
