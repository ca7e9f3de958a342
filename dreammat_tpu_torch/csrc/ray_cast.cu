// Dense first-hit ray caster for Hopper (sm_90a), fp32.
//
// Replaces the Pallas TPU kernel dreammat_tpu/ops/bvh.py::_dense_pallas_kernel
// (launched by cast_rays_dense_pallas, pallas_call at bvh.py:783): the first
// hit of R rays against T triangles given as plane/edge equations
// (_plane_tri_data: rows N | d0 | g_u | c_u | g_v | c_v, [12, T]):
//
//   t = -(o.N + d0) / (d.N),  u = (o.g_u + c_u) + t d.g_u,
//   v = (o.g_v + c_v) + t d.g_v,
//   valid = |d.N| > 1e-12, t > 1e-6, u >= 0, v >= 0, u + v <= 1, id >= 0,
//           t < the running best (which starts at t_max).
//
// What bounds it on the H100: ~35 fp32 operations per (ray, triangle) pair
// against 32 bytes in and 16 bytes out per ray, so the fp32 pipes, not the
// memory, bound it (no tensor cores: TF32 flips silhouette hits, see
// bvh.py:618-622).
//
// What the design does about that: one thread per ray, 128 rays per block.
// The block stages 256-triangle tiles (13 floats each, structure-of-arrays)
// in shared memory, and every thread walks the tile with all lanes reading
// the same triangle (a broadcast, no bank conflicts). The running (t, face,
// u, v) minimum lives in registers; the strict "<" keeps the first triangle
// in leaf order on ties, as the TPU kernel's first-lane tie-break does. All
// math is fp32, rounded after every operation (no FMA contraction) and with
// IEEE division, so the kernel returns bit for bit what the plain PyTorch
// version (ops/bvh.py cast_rays_plain) returns.
//
// Pairs that cannot hit are skipped a tile at a time, as the TPU kernel's
// cull does (bvh.py:603-609): the block's rays, clipped to the scene box,
// span a box, and a triangle tile (256 triangles in BVH leaf order, so
// spatially compact) whose box misses it is never loaded. Both boxes are
// padded by CULL_PAD, so rounding can only keep a tile, never drop one: the
// cull changes no result. Rays are not sorted; camera rays in raster order
// already come in compact strips. When the caller passes a counter, the
// kernel adds to it the (ray, triangle) pairs it tested (live rays of the
// block times triangles of each kept tile): the work this run's data needs,
// from the cull itself, for the bound a benchmark reports.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
//        -Xcompiler -fPIC  (see dreammat_tpu_torch/ops/kernels.py)

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RAYS_PER_BLOCK = 128;
constexpr int NUM_WARPS = RAYS_PER_BLOCK / 32;
constexpr int TRI_TILE = 256;
constexpr float CULL_PAD = 1e-4f;

// Rounded, uncontracted fp32 arithmetic in the plain version's order
// ((x0 r0 + x1 r1) + x2 r2, then the constant): an FMA changes the last bit
// of u or v, and a ray through the shared edge of two triangles can then
// fall through both and report the back face.
__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }

__device__ __forceinline__ float dot3(float x, float y, float z, float a, float b, float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, a), __fmul_rn(y, b)), __fmul_rn(z, c));
}

__global__ void __launch_bounds__(RAYS_PER_BLOCK)
ray_cast_kernel(const float* __restrict__ ro, const float* __restrict__ rd,
                const float* __restrict__ rows, const int* __restrict__ tid,
                const float* __restrict__ tile_box, const float* __restrict__ scene_box,
                int R, int T, float t_max,
                float* __restrict__ t_out, int* __restrict__ f_out,
                float* __restrict__ u_out, float* __restrict__ v_out,
                unsigned long long* __restrict__ pairs) {
  __shared__ float s_rows[12][TRI_TILE];
  __shared__ int s_tid[TRI_TILE];
  __shared__ float s_red[NUM_WARPS][6];
  __shared__ float s_blk[6];  // the block's ray box: -min x,y,z then max x,y,z

  const int r = blockIdx.x * RAYS_PER_BLOCK + threadIdx.x;
  const bool live = r < R;
  float o[3] = {0.f, 0.f, 0.f}, d[3] = {0.f, 0.f, 0.f};
  if (live) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      o[a] = ro[3 * r + a];
      d[a] = rd[3 * r + a];
    }
  }

  // this ray's segment (t in [1e-6, t_max]) clipped to the padded scene box
  const float neg_inf = __int_as_float(0xff800000);
  float box[6];  // -min, max: both reduce with fmaxf
#pragma unroll
  for (int k = 0; k < 6; ++k) box[k] = neg_inf;
  if (live) {
    float enter = 1e-6f, leave = t_max;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float inv = 1.f / (fabsf(d[a]) < 1e-12f ? 1e-12f : d[a]);
      const float s0 = (scene_box[a] - CULL_PAD - o[a]) * inv;
      const float s1 = (scene_box[3 + a] + CULL_PAD - o[a]) * inv;
      enter = fmaxf(enter, fminf(s0, s1));
      leave = fminf(leave, fmaxf(s0, s1));
    }
    if (leave >= enter) {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float p0 = o[a] + enter * d[a], p1 = o[a] + leave * d[a];
        box[a] = -(fminf(p0, p1) - CULL_PAD);
        box[3 + a] = fmaxf(p0, p1) + CULL_PAD;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    float x = box[k];
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, m));
    if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5][k] = x;
  }
  __syncthreads();
  if (threadIdx.x < 6) {
    float x = s_red[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < NUM_WARPS; ++w) x = fmaxf(x, s_red[w][threadIdx.x]);
    s_blk[threadIdx.x] = x;
  }
  __syncthreads();
  const float bmin[3] = {-s_blk[0], -s_blk[1], -s_blk[2]};
  const float bmax[3] = {s_blk[3], s_blk[4], s_blk[5]};

  const float ox = o[0], oy = o[1], oz = o[2], dx = d[0], dy = d[1], dz = d[2];
  float tb = t_max, ub = 0.f, vb = 0.f;
  int fb = -1;
  const unsigned long long live_rays = min(RAYS_PER_BLOCK, R - blockIdx.x * RAYS_PER_BLOCK);
  unsigned long long tested = 0;

  for (int t0 = 0, tile = 0; t0 < T; t0 += TRI_TILE, ++tile) {
    const float* box_t = tile_box + 6 * tile;
    // the same answer in every thread of the block: the skip is uniform
    if (!(bmin[0] <= box_t[3] && box_t[0] <= bmax[0] && bmin[1] <= box_t[4] &&
          box_t[1] <= bmax[1] && bmin[2] <= box_t[5] && box_t[2] <= bmax[2]))
      continue;
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < 12 * TRI_TILE; i += RAYS_PER_BLOCK) {
      const int row = i / TRI_TILE;
      const int c = i % TRI_TILE;
      s_rows[row][c] = (t0 + c < T) ? rows[(long long)row * T + t0 + c] : 0.f;
    }
    for (int c = threadIdx.x; c < TRI_TILE; c += RAYS_PER_BLOCK)
      s_tid[c] = (t0 + c < T) ? tid[t0 + c] : -1;
    __syncthreads();

    const int n = min(TRI_TILE, T - t0);
    tested += live_rays * n;
#pragma unroll 4
    for (int c = 0; c < n; ++c) {
      const float A = fadd(dot3(ox, oy, oz, s_rows[0][c], s_rows[1][c], s_rows[2][c]),
                           s_rows[3][c]);
      const float B = dot3(dx, dy, dz, s_rows[0][c], s_rows[1][c], s_rows[2][c]);
      if (!(fabsf(B) > 1e-12f)) continue;
      const float t = -A / B;
      if (!(t > 1e-6f) || !(t < tb)) continue;
      const float gux = s_rows[4][c], guy = s_rows[5][c], guz = s_rows[6][c];
      const float u = fadd(fadd(dot3(ox, oy, oz, gux, guy, guz), s_rows[7][c]),
                           __fmul_rn(t, dot3(dx, dy, dz, gux, guy, guz)));
      if (!(u >= 0.f)) continue;
      const float gvx = s_rows[8][c], gvy = s_rows[9][c], gvz = s_rows[10][c];
      const float v = fadd(fadd(dot3(ox, oy, oz, gvx, gvy, gvz), s_rows[11][c]),
                           __fmul_rn(t, dot3(dx, dy, dz, gvx, gvy, gvz)));
      if (!(v >= 0.f) || !(fadd(u, v) <= 1.f) || s_tid[c] < 0) continue;
      tb = t;
      ub = u;
      vb = v;
      fb = s_tid[c];
    }
  }
  if (pairs != nullptr && threadIdx.x == 0 && tested > 0) atomicAdd(pairs, tested);
  if (live) {
    t_out[r] = tb;
    f_out[r] = fb;
    u_out[r] = ub;
    v_out[r] = vb;
  }
}

}  // namespace

// Triangles per tile: the wrapper builds tile_box [ceil(T / tile), 6] with it.
extern "C" int ray_cast_tile_size() { return TRI_TILE; }

extern "C" int ray_cast_dense(const void* rays_o, const void* rays_d, const void* rows,
                              const void* tid, const void* tile_box, const void* scene_box,
                              int R, int T, float t_max, void* t_out, void* f_out, void* u_out,
                              void* v_out, void* pairs, void* stream) {
  const int blocks = (R + RAYS_PER_BLOCK - 1) / RAYS_PER_BLOCK;
  ray_cast_kernel<<<blocks, RAYS_PER_BLOCK, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(rays_o), static_cast<const float*>(rays_d),
      static_cast<const float*>(rows), static_cast<const int*>(tid),
      static_cast<const float*>(tile_box), static_cast<const float*>(scene_box), R, T, t_max,
      static_cast<float*>(t_out), static_cast<int*>(f_out), static_cast<float*>(u_out),
      static_cast<float*>(v_out), static_cast<unsigned long long*>(pairs));
  return (int)cudaGetLastError();
}
