// Dense first-hit ray caster for Hopper (sm_90a), fp32.
//
// Replaces the Pallas TPU kernel dreammat_tpu/ops/bvh.py::_dense_pallas_kernel
// (launched by cast_rays_dense_pallas, pallas_call at bvh.py:783): the first
// hit of R rays against T triangles given as plane/edge equations
// (_plane_tri_data: rows N | d0 | g_u | c_u | g_v | c_v, [12, T]):
//
//   A = o.N + d0,  B = d.N,  t = -A / B,
//   u = (o.g_u + c_u) + t d.g_u,  v = (o.g_v + c_v) + t d.g_v,
//   valid = |B| > 1e-12, t > 1e-6, u >= 0, v >= 0, u + v <= 1, id >= 0,
//           t < the running best (which starts at t_max).
//
// The kernel returns bit for bit what the plain PyTorch version
// (ops/bvh.py cast_rays_plain) returns: every operation is rounded in the
// plain version's order ((x0 r0 + x1 r1) + x2 r2, then the constant), with
// no FMA contraction (__fmul_rn, __fadd_rn) and IEEE division, and the
// triangles are visited in leaf order with a strict "<", so the first of
// equal t wins, as torch.argmin does. No tensor cores: TF32 flips
// silhouette hits (bvh.py:618-622).
//
// What bounds it on the H100: the fp32 pipes. A tested pair costs 15
// rounded fp32 operations before the division can be skipped (A: 6,
// B: 5, |B| > 1e-12 and A != 0: 2, the threshold product and its compare:
// 2; none is an FMA; the SASS of the loop holds these 15 beside 7 integer
// and select instructions, one LDS.128 and the branch), against 24 bytes
// in and 16 out per ray. chip_smoke.py divides the tested pairs times 15
// by the card's instruction rate (132 SMs x 128 lanes x the SM clock).
//
// What the design does about that (version 2):
//   - fewer pairs. Each ray tests the boxes of 256-triangle tiles (in
//     leaf order, so spatially compact) and then of their 32-triangle
//     sub-tiles against its segment (0, best t), a slab test;
//     a warp stages and tests a sub-tile only when one of its rays may hit
//     it. The segment ends at the running best t, so tiles beyond a ray's
//     hit drop out as hits are found. The boxes are padded by CULL_PAD, far
//     above the rounding of the slab test and of the hit point that the
//     plain test accepts (each about 1e-7 of the coordinates and lengths
//     involved, of order 1 to 10 for the unit-scale meshes and t_max = 10
//     the system casts with), so the cull may keep a tile that no ray
//     needs but never drops one that a ray needs: it changes no result.
//     The visibility bake orders its rays to suit (vertices in
//     Morton order, direction-major: ops/visibility.py), so a warp's rays
//     start close together and run parallel.
//   - fewer instructions per pair. A warp stages its sub-tile in shared
//     memory by cp.async as four float4 per triangle ((N, d0), (g_u, c_u),
//     (g_v, c_v), id), read back as broadcasts; a pair is rejected before
//     the division where the plain test would reject it anyway (the two
//     rules and their proof are next to passes_early); the rest of the
//     test runs as predicates, not as a branch per test.
//   - one ray per thread, 32 per warp, and warps are independent: no block
//     barrier, each warp walks the tiles with its own votes. (Two rays per
//     thread, so that one read of a triangle served two pairs, was slower
//     on every case: the warp's cull covers twice the rays, and a thread's
//     rays ran the division one after the other; PERF.md, PR 4.)
// When the caller passes a counter, the kernel adds to it the (ray,
// triangle) pairs it tested (live rays of a warp times triangles of each
// sub-tile it staged): the work this run's data needs after the cull.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC  (see dreammat_tpu_torch/ops/kernels.py)

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;  // one ray per thread: 128 rays per block, 32 per warp
constexpr int TILE = 256;  // triangles per outer box
constexpr int SUB = 32;    // triangles per inner box, staged by a warp
constexpr float CULL_PAD = 1e-4f;
constexpr float T_MIN = 1e-6f;
constexpr float B_MIN = 1e-12f;
constexpr float CUT_SLACK = 1.00000095367431640625f;  // 1 + 2^-20, exact in fp32

__device__ __forceinline__ float dot3(float x, float y, float z, float a, float b, float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, a), __fmul_rn(y, b)), __fmul_rn(z, c));
}

// Whether a pair must go on to the division, given A, B and
// cut = RN(tb (1 + 2^-20)), where tb is the ray's running best t: the
// plain test rejects every pair that this rejects.
//
//   1. t = -A / B > 1e-6 needs A != 0 and A, B of opposite signs: with
//      A = +-0 the quotient is +-0; with equal signs it is <= 0 (B != 0,
//      since |B| > 1e-12 is tested first).
//   2. t < tb fails once |A| >= RN(cut |B|). Both products are of normal
//      numbers (tb > 1e-6 while a hit is still possible, |B| > 1e-12, so
//      cut |B| > 1e-18), so each rounds down by at most a factor
//      (1 - 2^-24): |A| / |B| >= tb (1 + 2^-20)(1 - 2^-24)^2 > tb, and
//      t = RN(|A| / |B|) >= RN(tb) = tb, as RN is monotone and tb is a
//      float. (A product that overflows to inf only weakens the rule.
//      While tb <= 1e-6 no pair can pass t > 1e-6 and t < tb at once, so
//      any rejection is right.)
//
// A NaN A or B is rejected too, as the plain test rejects it (t is NaN).
// No short-circuit: the four tests are predicates, without branches.
__device__ __forceinline__ bool passes_early(float A, float B, float cut) {
  const bool opposite = (int)(__float_as_uint(A) ^ __float_as_uint(B)) < 0;
  return (fabsf(B) > B_MIN) & opposite & (A != 0.f) & (fabsf(A) < __fmul_rn(cut, fabsf(B)));
}

struct Ray {
  float o[3], d[3];
  float inv[3], o_inv[3];  // 1 / d per axis (|d| clamped to 1e-12) and o / d, for the slab test
  float tb, ub, vb, cut;   // running best t, its u and v; cut = RN(tb (1 + 2^-20))
  int fb;
  bool live;
};

// Whether the ray's segment (0, tb) meets the box [lo, hi] (padded): a
// slab test whose rounding is far below the padding. A dead ray meets
// nothing.
__device__ __forceinline__ bool meets(const Ray& r, const float4& lo, const float4& hi) {
  float t0 = 0.f, t1 = r.tb;
  const float l[3] = {lo.x, lo.y, lo.z}, h[3] = {hi.x, hi.y, hi.z};
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float s0 = fmaf(l[a], r.inv[a], -r.o_inv[a]);
    const float s1 = fmaf(h[a], r.inv[a], -r.o_inv[a]);
    t0 = fmaxf(t0, fminf(s0, s1));
    t1 = fminf(t1, fmaxf(s0, s1));
  }
  return r.live && t0 <= t1;
}

// 16-byte asynchronous copy from global to shared memory (no registers)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// the box pair (min, max) at `box`, padded by CULL_PAD
__device__ __forceinline__ void load_box(const float4* box, float4& lo, float4& hi) {
  lo = __ldg(box);
  hi = __ldg(box + 1);
  lo.x -= CULL_PAD; lo.y -= CULL_PAD; lo.z -= CULL_PAD;
  hi.x += CULL_PAD; hi.y += CULL_PAD; hi.z += CULL_PAD;
}

__global__ void __launch_bounds__(32 * WARPS)
ray_cast_kernel(const float* __restrict__ ro, const float* __restrict__ rd,
                const float4* __restrict__ tris, const float4* __restrict__ tile_box,
                const float4* __restrict__ sub_box, int R, int T, float t_max,
                float* __restrict__ t_out, int* __restrict__ f_out,
                float* __restrict__ u_out, float* __restrict__ v_out,
                unsigned long long* __restrict__ pairs) {
  __shared__ float4 s_tri[WARPS][SUB * 4];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long base = ((long long)blockIdx.x * WARPS + warp) * 32;
  if (base >= R) return;  // the whole warp: warps share no barrier
  const int live_rays = (int)min(32LL, R - base);

  const long long idx = base + lane;
  Ray r;
  r.live = idx < R;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    r.o[a] = r.live ? ro[3 * idx + a] : 0.f;
    r.d[a] = r.live ? rd[3 * idx + a] : 0.f;
    r.inv[a] = 1.f / (fabsf(r.d[a]) < 1e-12f ? 1e-12f : r.d[a]);
    r.o_inv[a] = r.o[a] * r.inv[a];
  }
  r.tb = t_max;
  r.cut = __fmul_rn(t_max, CUT_SLACK);
  r.ub = r.vb = 0.f;
  r.fb = -1;
  const float ox = r.o[0], oy = r.o[1], oz = r.o[2], dx = r.d[0], dy = r.d[1], dz = r.d[2];

  float4* st = s_tri[warp];
  unsigned long long tested = 0;
  const int n_tiles = (T + TILE - 1) / TILE;
  for (int tile = 0; tile < n_tiles; ++tile) {
    float4 lo, hi;
    load_box(tile_box + 2 * tile, lo, hi);
    if (!__any_sync(0xffffffffu, meets(r, lo, hi))) continue;

    for (int s0 = tile * TILE; s0 < min(T, (tile + 1) * TILE); s0 += SUB) {
      load_box(sub_box + 2 * (s0 / SUB), lo, hi);
      if (!__any_sync(0xffffffffu, meets(r, lo, hi))) continue;

      const int n = min(SUB, T - s0);
      __syncwarp();  // every lane is done with the previous sub-tile
      for (int j = lane; j < 4 * n; j += 32) cp_async16(st + j, tris + 4LL * s0 + j);
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncwarp();
      tested += (unsigned long long)live_rays * n;

#pragma unroll 2
      for (int c = 0; c < n; ++c) {
        const float4 P = st[4 * c];
        const float A = __fadd_rn(dot3(ox, oy, oz, P.x, P.y, P.z), P.w);
        const float B = dot3(dx, dy, dz, P.x, P.y, P.z);
        if (!passes_early(A, B, r.cut)) continue;
        // the rest of the plain test as predicates, without a branch per test
        const float4 GU = st[4 * c + 1], GV = st[4 * c + 2];
        const int id = __float_as_int(st[4 * c + 3].x);
        const float t = __fdiv_rn(-A, B);
        const float u = __fadd_rn(__fadd_rn(dot3(ox, oy, oz, GU.x, GU.y, GU.z), GU.w),
                                  __fmul_rn(t, dot3(dx, dy, dz, GU.x, GU.y, GU.z)));
        const float v = __fadd_rn(__fadd_rn(dot3(ox, oy, oz, GV.x, GV.y, GV.z), GV.w),
                                  __fmul_rn(t, dot3(dx, dy, dz, GV.x, GV.y, GV.z)));
        const bool hit = (t > T_MIN) & (t < r.tb) & (u >= 0.f) & (v >= 0.f) &
                         (__fadd_rn(u, v) <= 1.f) & (id >= 0);
        r.tb = hit ? t : r.tb;
        r.cut = hit ? __fmul_rn(t, CUT_SLACK) : r.cut;
        r.ub = hit ? u : r.ub;
        r.vb = hit ? v : r.vb;
        r.fb = hit ? id : r.fb;
      }
    }
  }
  if (pairs != nullptr && lane == 0 && tested > 0) atomicAdd(pairs, tested);
  if (r.live) {
    t_out[idx] = r.tb;
    f_out[idx] = r.fb;
    u_out[idx] = r.ub;
    v_out[idx] = r.vb;
  }
}

}  // namespace

// Triangles per outer and inner box: the wrapper builds tile_box
// [ceil(T / tile), 2, 4] and sub_box [ceil(T / sub), 2, 4] with them.
extern "C" int ray_cast_tile_size() { return TILE; }
extern "C" int ray_cast_sub_size() { return SUB; }

// tris: [T, 4, 4] float, per triangle (N, d0), (g_u, c_u), (g_v, c_v),
// (id as int bits, 0, 0, 0). Returns 0 or a cudaError_t.
extern "C" int ray_cast_dense(const void* rays_o, const void* rays_d, const void* tris,
                              const void* tile_box, const void* sub_box, int R, int T,
                              float t_max, void* t_out, void* f_out, void* u_out, void* v_out,
                              void* pairs, void* stream) {
  const int blocks = (R + 32 * WARPS - 1) / (32 * WARPS);
  ray_cast_kernel<<<blocks, 32 * WARPS, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(rays_o), static_cast<const float*>(rays_d),
      static_cast<const float4*>(tris), static_cast<const float4*>(tile_box),
      static_cast<const float4*>(sub_box), R, T, t_max, static_cast<float*>(t_out),
      static_cast<int*>(f_out), static_cast<float*>(u_out), static_cast<float*>(v_out),
      static_cast<unsigned long long*>(pairs));
  return (int)cudaGetLastError();
}
