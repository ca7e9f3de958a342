// BVH-walk ray caster for Hopper (sm_90a), fp32: kernel E, with a
// closest-hit entry (bvh_traverse) and an any-hit entry (bvh_occluded).
//
// Replaces no Pallas kernel: the JAX package walks its BVH in plain XLA,
// dreammat_tpu/ops/bvh.py::cast_rays (a jax.lax.while_loop over all rays,
// one gather per node and leaf), which cast_rays_chunked takes for meshes
// above DENSE_CAST_MAX_TRIS = 2^22 triangles; its occlusion_rays is that
// walk's hit mask. In eager PyTorch the walk costs a few dozen launches per
// step of the longest ray, hence a kernel.
//
// What it computes, per ray (the stackless skip-link walk over the host
// builder's DFS layout): start at the root; test the node's box by the slab
// test against (0, best t); a met internal node goes on to the next node
// (its first child), anything else to the node's miss link, until the link
// is -1. A met leaf tests its at most 4 triangles in slot order by
// Moller-Trumbore (|det| > 1e-9, u >= 0, v >= 0, u + v <= 1, t > 1e-6); a
// hit becomes the best only with t strictly below the best so far (which
// starts at t_max), so the first of equal t wins, as argmin's first lane
// does in the JAX walk. The any-hit entry walks the same way and stops at
// the ray's first valid pair (t < t_max). Until that pair both entries test
// the same nodes and pairs in the same order against the same best (t_max),
// so it finds a hit exactly when the closest-hit walk does: its hit mask is
// the closest-hit walk's, bit for bit. It writes the mask alone, no t, face,
// u or v.
//
// The kernel returns bit for bit what the plain PyTorch version
// (ops/bvh.py cast_rays_bvh_plain, any_hit as the entry) returns: every
// operation is rounded as the plain version rounds it, each cross and dot
// product written out component by component and summed left to right, with
// no FMA contraction (__fmul_rn, __fadd_rn, __fsub_rn) and IEEE division
// (__fdiv_rn); min and max are the plain version's where(a < b, a, b) and
// where(a > b, a, b).
//
// What bounds it on the H100. Each step of a ray reads what the previous
// step chose (the arithmetic is small: a slab test is 6 subtractions, 6
// products and 12 compares and selects; a Moller-Trumbore test about 27
// multiplies and adds and one division). chip_smoke.py bounds it by the
// larger of the nodes visited times the slab test's operations plus the
// pairs tested times Moller-Trumbore's, over the fp32 instruction rate, and
// the bytes of the rays, the results and the boxes and triangles the walk
// touches, each read once, over the memory rate; the walk runs far above
// both. Fewer reads on the chain of dependent reads did not make it faster
// here: a version that read both children's halves of a record at once (64
// bytes a read, the second child's test then needing none) ran 3-19%
// slower than v1 at path 13's shapes, and a walk of single halves that
// branched where this one selects 9-21% (tools/ab_bvh_traverse.py).
//
// Its design (v2). The any-hit entry does the work the hit-mask callers
// need and no more. The nodes are records: an internal node's record holds
// the boxes of its two children (64 bytes, four float4, ops/bvh.py
// pack_bvh), the first child being the next node in DFS order and the
// second its miss link, so a sibling's box sits beside the first child's,
// where v1 read it past the first child's whole subtree. Each step reads
// the 32-byte half that holds its child, chosen by selects, not branches,
// as v1 chose its next node: a met internal child's record (its first
// half), else from a first child its sibling's half, from a second child
// the second half of the record whose second child is its miss link (the
// walk ends where that is -1). A virtual record 0 holds the root as its
// first child and no second. The order of the box and triangle tests, and
// so every answer and both counters, stay the plain walk's. A leaf's
// triangles are read one at a time (read together, the four took 95
// registers a thread and the walk ran slower). The counters are compiled in
// only where the caller passes them. One thread per ray, 128 rays a block,
// the rays in the caller's order (sorting the shadow rays by direction and
// origin cut the walk by 8-12% but the sort and the scatter back cost more
// than that), all reads through the read-only path (__ldg). Not done: a
// short stack with the nearer child first and compressed boxes (both
// change which of two near-equal hits wins), wider nodes.
//
// When the caller passes a counter, the kernel adds to it the nodes
// visited (slab tests) and the (ray, triangle) pairs tested: the work this
// run's data needs.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC  (see dreammat_tpu_torch/ops/kernels.py)

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int LEAF_SIZE = 4;
constexpr float DIR_MIN = 1e-12f;
constexpr float DET_MIN = 1e-9f;
constexpr float T_MIN = 1e-6f;
// a child's word: a leaf's first slot * 8 + its count (1..4), an internal
// node's record * 8, or NONE where a record has no second child
constexpr int NONE = -1;

__device__ __forceinline__ float min_sel(float a, float b) { return a < b ? a : b; }
__device__ __forceinline__ float max_sel(float a, float b) { return a > b ? a : b; }

// ((a0 b0 + a1 b1) + a2 b2), each step rounded
__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0, float b1,
                                      float b2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a0, b0), __fmul_rn(a1, b1)), __fmul_rn(a2, b2));
}

// a1 b2 - a2 b1, each step rounded (one component of a cross product)
__device__ __forceinline__ float cross1(float a1, float a2, float b1, float b2) {
  return __fsub_rn(__fmul_rn(a1, b2), __fmul_rn(a2, b1));
}

__device__ __forceinline__ float inv_dir(float d) {
  const float c = fabsf(d) < DIR_MIN ? (d >= 0.f ? DIR_MIN : -DIR_MIN) : d;
  return __fdiv_rn(1.f, c);
}

template <bool ANY_HIT, bool COUNT>
__global__ void __launch_bounds__(THREADS)
bvh_walk_kernel(const float* __restrict__ ro, const float* __restrict__ rd,
                const float4* __restrict__ nodes, const float4* __restrict__ tris, int R,
                float t_max, float* __restrict__ t_out, int* __restrict__ f_out,
                float* __restrict__ u_out, float* __restrict__ v_out,
                bool* __restrict__ hit_out, unsigned long long* __restrict__ counters) {
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  const bool live = idx < R;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 1.f, dy = 1.f, dz = 1.f;
  if (live) {
    ox = ro[3 * idx];
    oy = ro[3 * idx + 1];
    oz = ro[3 * idx + 2];
    dx = rd[3 * idx];
    dy = rd[3 * idx + 1];
    dz = rd[3 * idx + 2];
  }
  const float ix = inv_dir(dx), iy = inv_dir(dy), iz = inv_dir(dz);
  float tb = t_max, ub = 0.f, vb = 0.f;
  int fb = -1;
  bool found = false;  // the any-hit entry's answer
  unsigned visited = 0, tested = 0;  // this ray's; summed only when COUNT

  // the walk's place: the half of a record that holds the child under test
  // (lo.w its word; hi.w the record's second word in a first child's half,
  // the next record in a second child's), its record, and which half
  float4 lo = __ldg(nodes), hi = __ldg(nodes + 1);
  long long rec = 0;
  bool second = false;
  while (live) {
    const int word = __float_as_int(lo.w);
    if (COUNT) ++visited;
    const float t0x = __fmul_rn(__fsub_rn(lo.x, ox), ix), t1x = __fmul_rn(__fsub_rn(hi.x, ox), ix);
    const float t0y = __fmul_rn(__fsub_rn(lo.y, oy), iy), t1y = __fmul_rn(__fsub_rn(hi.y, oy), iy);
    const float t0z = __fmul_rn(__fsub_rn(lo.z, oz), iz), t1z = __fmul_rn(__fsub_rn(hi.z, oz), iz);
    const float tmin = max_sel(max_sel(min_sel(t0x, t1x), min_sel(t0y, t1y)), min_sel(t0z, t1z));
    const float tmax = min_sel(min_sel(max_sel(t0x, t1x), max_sel(t0y, t1y)), max_sel(t0z, t1z));
    const bool met = (tmax >= max_sel(tmin, 0.f)) & (tmin < tb);
    const int count = word & 7;
    if (met && count > 0) {
      const long long first = word >> 3;
      for (int lane = 0; lane < count; ++lane) {
        const float4 A = __ldg(tris + 3 * (first + lane));
        const float4 E1 = __ldg(tris + 3 * (first + lane) + 1);
        const float4 E2 = __ldg(tris + 3 * (first + lane) + 2);
        if (COUNT) ++tested;
        const float px = cross1(dy, dz, E2.y, E2.z);
        const float py = cross1(dz, dx, E2.z, E2.x);
        const float pz = cross1(dx, dy, E2.x, E2.y);
        const float det = dot3(E1.x, E1.y, E1.z, px, py, pz);
        const bool ok = fabsf(det) > DET_MIN;
        const float inv_det = ok ? __fdiv_rn(1.f, det) : 0.f;
        const float tx = __fsub_rn(ox, A.x), ty = __fsub_rn(oy, A.y), tz = __fsub_rn(oz, A.z);
        const float u = __fmul_rn(dot3(tx, ty, tz, px, py, pz), inv_det);
        const float qx = cross1(ty, tz, E1.y, E1.z);
        const float qy = cross1(tz, tx, E1.z, E1.x);
        const float qz = cross1(tx, ty, E1.x, E1.y);
        const float v = __fmul_rn(dot3(dx, dy, dz, qx, qy, qz), inv_det);
        const float t = __fmul_rn(dot3(E2.x, E2.y, E2.z, qx, qy, qz), inv_det);
        const bool hit = ok & (u >= 0.f) & (v >= 0.f) & (__fadd_rn(u, v) <= 1.f) &
                         (t > T_MIN) & (t < tb);
        if (ANY_HIT && hit) {
          found = true;
          break;
        }
        if (hit) {
          fb = __float_as_int(A.w);
          tb = t;
          ub = u;
          vb = v;
        }
      }
      if (ANY_HIT && found) break;
    }
    // the next half, chosen by selects as v1 chose its next node: a met
    // internal child's record (its first half); from a first child its
    // sibling (this record's second half); from a second child the next
    // record's second half. A link of -1 (no sibling, no next record) ends
    // the walk.
    const bool down = met && count == 0;
    const int link = __float_as_int(hi.w);
    if (!down && link < 0) break;
    rec = down ? (long long)(word >> 3) : (second ? (long long)link : rec);
    second = !down;
    const float4* p = nodes + 4 * rec + (second ? 2 : 0);
    lo = __ldg(p);
    hi = __ldg(p + 1);
  }

  if (COUNT) {
    unsigned long long v = visited, p = tested;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v += __shfl_down_sync(0xffffffffu, v, off);
      p += __shfl_down_sync(0xffffffffu, p, off);
    }
    if ((threadIdx.x & 31) == 0 && v > 0) {
      atomicAdd(counters, v);
      atomicAdd(counters + 1, p);
    }
  }
  if (live) {
    if (ANY_HIT) {
      hit_out[idx] = found;
    } else {
      t_out[idx] = tb;
      f_out[idx] = fb;
      u_out[idx] = ub;
      v_out[idx] = vb;
    }
  }
}

template <bool ANY_HIT>
int launch(const void* rays_o, const void* rays_d, const void* nodes, const void* tris, int R,
           float t_max, void* t_out, void* f_out, void* u_out, void* v_out, void* hit_out,
           void* counters, void* stream) {
  const int blocks = (R + THREADS - 1) / THREADS;
  const auto kernel = counters != nullptr ? bvh_walk_kernel<ANY_HIT, true>
                                          : bvh_walk_kernel<ANY_HIT, false>;
  kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(rays_o), static_cast<const float*>(rays_d),
      static_cast<const float4*>(nodes), static_cast<const float4*>(tris), R, t_max,
      static_cast<float*>(t_out), static_cast<int*>(f_out), static_cast<float*>(u_out),
      static_cast<float*>(v_out), static_cast<bool*>(hit_out),
      static_cast<unsigned long long*>(counters));
  return (int)cudaGetLastError();
}

}  // namespace

// rays_o, rays_d: [R, 3] float; nodes: [M, 4] float4 records, tris: [T, 3]
// float4 (ops/bvh.py pack_bvh); t, u, v: [R] float and face: [R] int out
// (the best t, or t_max, and -1 for a miss); counters: null or two unsigned
// 64-bit sums (nodes visited, pairs tested; the kernel counts only when it
// is given them). Returns 0 or a cudaError_t.
extern "C" int bvh_traverse(const void* rays_o, const void* rays_d, const void* nodes,
                            const void* tris, int R, float t_max, void* t_out, void* f_out,
                            void* u_out, void* v_out, void* counters, void* stream) {
  return launch<false>(rays_o, rays_d, nodes, tris, R, t_max, t_out, f_out, u_out, v_out,
                       nullptr, counters, stream);
}

// The any-hit entry: as bvh_traverse, with hit: [R] bool out (a valid pair
// with t < t_max exists) in place of t, face, u and v.
extern "C" int bvh_occluded(const void* rays_o, const void* rays_d, const void* nodes,
                            const void* tris, int R, float t_max, void* hit_out,
                            void* counters, void* stream) {
  return launch<true>(rays_o, rays_d, nodes, tris, R, t_max, nullptr, nullptr, nullptr,
                      nullptr, hit_out, counters, stream);
}
