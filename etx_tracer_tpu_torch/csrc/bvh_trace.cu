// BVH ray/triangle intersection for scenes above 4096 triangles, for NVIDIA
// Hopper (sm_90a): closest hit and any hit over the fat-node rows (K5, K6)
// and over the plain pre-order nodes (K7, K8).
//
// Replaces the TPU kernels of etx_tracer_tpu/ops/pallas_trace.py:
//   K5 intersect_bvh_fat_pallas (`_kernel_bvh_fat`)        -> bvh_fat_kernel<false>
//   K6 occluded_bvh_fat_pallas  (`_kernel_bvh_fat_anyhit`) -> bvh_fat_kernel<true>
//   K7 intersect_bvh_pallas     (`_kernel_bvh`)            -> bvh_node_kernel<false>
//   K8 occluded_bvh_pallas      (`_kernel_bvh_anyhit`)     -> bvh_node_kernel<true>
// They compute the outputs of the TPU kernels, not their layout. The TPU
// kernels walk ONE depth-first node stream per tile of 1024 rays, because
// the TPU vector unit has no per-lane control flow, and read chunk-packed
// (16, 128) tables through one-hot reduces, with ids stored as float32.
// Here one thread owns one ray and walks the same tree on its own stack (64
// int entries in local memory) in the same left-first pre-order, reading
// fat rows (64 B, four 16-byte loads), node rows (32 B, two loads) and the
// triangle rows reordered by leaf order (48 B, three loads) through the
// read-only path. Ids and counts are int32. The bigscene tables (305 KB of
// fat rows, 305 KB of nodes, 739 KB of triangles) sit in the 50 MB L2.
//
// Walk. A fat row slab-tests both children's boxes against
// cap = min(t_max, best_t) (t_max for the any hits), tests the triangles of
// a hit leaf child in place (left, then right), then descends into a hit
// left inner child, pushing a hit right inner child, or goes to a hit right
// inner child, or pops. Row fields: boxes as float32 bits in words 0-11,
// then L_first, R_first (a fat-row index for an inner child, a triangle
// row for a leaf), counts = L_count * 32 + R_count, skip (unused here). A
// plain node slab-tests its box; a hit leaf tests its triangles; a hit
// inner node pushes its right child (node_left) and goes to its left child
// (the next node). A ray thus tests its triangles in the order the TPU
// kernels' shared stream tests them for it (a subsequence), and a strict
// `t < best_t` keeps the first of equal hits: the same triangle wins a tie.
// The any hits return at the first valid triangle, where the TPU kernels
// exit once every ray of the tile is occluded; the output is the same.
//
// What bounds it: the work depends on the data. Per ray, bigscene's closest
// hit walks make about 29 box tests (14 FP32 adds, subtracts and
// multiplies and 12 min/max each) and 8 triangle tests (45 FP32 adds,
// subtracts and multiplies and a division each); each ray moves 32 bytes
// in and 16 (closest) or 1 (any) out, and the tables' words that the walk
// reads are read once. At the card's FP32 and HBM peaks the two are close
// (for 2^18 rays 3.0 us of operations, 4.0 us of bytes), and the kernel
// takes some 60x that: the warps' walks diverge and each step waits on a
// dependent load. This first design is simple on purpose: one ray per
// thread, no ray sorting, no near-first child order (which would change
// which triangle wins an exact tie against the plain version), no wide
// nodes.
//
// Numerics: the expressions of `pallas_trace._tri_hit` and the slab of
// `_fat_step` / `_kernel_bvh`, in the same order, built with -fmad=false and
// without --use_fast_math, so each rounds as the plain PyTorch version
// (etx_tracer_tpu_torch/ops/bvh_trace.py) evaluates it; the two agree bit
// for bit.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kStackDepth = 64;   // ops/bvh_build.py STACK_DEPTH
constexpr float kMtEps = 1e-9f;
constexpr float kBig = 3e38f;

struct Ray {
  float ox, oy, oz, dx, dy, dz;
  float ivx, ivy, ivz;
  bool parx, pary, parz;
  float tmin, tmax;
};

struct Best {
  float t;
  int tri;
  float u, v;
};

__device__ __forceinline__ float safe_inv(float x) {
  return 1.0f / (fabsf(x) < 1e-20f ? (x < 0.0f ? -1e-20f : 1e-20f) : x);
}

__device__ __forceinline__ Ray load_ray(int i, const float* __restrict__ o, int o_ray, int o_comp,
                                        const float* __restrict__ d, int d_ray, int d_comp,
                                        const float* __restrict__ t_min,
                                        const float* __restrict__ t_max) {
  Ray r;
  const long long io = (long long)i * o_ray, id = (long long)i * d_ray;
  r.ox = o[io]; r.oy = o[io + o_comp]; r.oz = o[io + 2 * o_comp];
  r.dx = d[id]; r.dy = d[id + d_comp]; r.dz = d[id + 2 * d_comp];
  r.ivx = safe_inv(r.dx); r.ivy = safe_inv(r.dy); r.ivz = safe_inv(r.dz);
  r.parx = fabsf(r.dx) < 1e-12f;
  r.pary = fabsf(r.dy) < 1e-12f;
  r.parz = fabsf(r.dz) < 1e-12f;
  r.tmin = t_min[i];
  r.tmax = t_max[i];
  return r;
}

// One axis of the slab test; an axis the ray runs parallel to (|d| < 1e-12)
// is all or nothing by whether the origin lies in the slab.
__device__ __forceinline__ void slab(bool par, float o, float iv, float mn, float mx,
                                     float& lo, float& hi) {
  const float t0 = (mn - o) * iv;
  const float t1 = (mx - o) * iv;
  lo = fminf(t0, t1);
  hi = fmaxf(t0, t1);
  if (par) {
    const bool inside = o >= mn && o <= mx;
    lo = inside ? -kBig : kBig;
    hi = inside ? kBig : -kBig;
  }
}

// Conservative slab test of the box [mn, mx] over [t_min, cap].
__device__ __forceinline__ bool box_hit(const Ray& r, float mnx, float mny, float mnz,
                                        float mxx, float mxy, float mxz, float cap) {
  float lx, hx, ly, hy, lz, hz;
  slab(r.parx, r.ox, r.ivx, mnx, mxx, lx, hx);
  slab(r.pary, r.oy, r.ivy, mny, mxy, ly, hy);
  slab(r.parz, r.oz, r.ivz, mnz, mxz, lz, hz);
  const float t_near = fmaxf(fmaxf(lx, fmaxf(ly, lz)), r.tmin);
  const float t_far = fminf(fminf(hx, fminf(hy, hz)), cap);
  return t_near <= t_far * 1.0000002f + 1e-7f;
}

__device__ __forceinline__ float bits(int x) { return __int_as_float(x); }

// Möller-Trumbore against the `count` triangle rows from `first` on (each
// v0, e1, e2, original id as int bits, 2 pad words). The closest hit keeps
// a valid t < best_t; the any hit returns true at the first valid one.
template <bool kAnyHit>
__device__ __forceinline__ bool test_leaf(const Ray& r, const float4* __restrict__ tris,
                                          const unsigned char* __restrict__ mask, int first,
                                          int count, Best& b) {
  for (int k = 0; k < count; ++k) {
    const float4* row = tris + 3 * (long long)(first + k);
    const float4 a = __ldg(row);
    const float4 q = __ldg(row + 1);
    const float4 c = __ldg(row + 2);
    const float v0x = a.x, v0y = a.y, v0z = a.z;
    const float e1x = a.w, e1y = q.x, e1z = q.y;
    const float e2x = q.z, e2y = q.w, e2z = c.x;
    const int id = __float_as_int(c.y);

    const float px = r.dy * e2z - r.dz * e2y;
    const float py = r.dz * e2x - r.dx * e2z;
    const float pz = r.dx * e2y - r.dy * e2x;
    const float det = px * e1x + py * e1y + pz * e1z;
    const bool det_ok = fabsf(det) > kMtEps;
    const float inv_det = det_ok ? 1.0f / (det == 0.0f ? 1.0f : det) : 0.0f;
    const float tx = r.ox - v0x;
    const float ty = r.oy - v0y;
    const float tz = r.oz - v0z;
    const float u = (tx * px + ty * py + tz * pz) * inv_det;
    const float qx = ty * e1z - tz * e1y;
    const float qy = tz * e1x - tx * e1z;
    const float qz = tx * e1y - ty * e1x;
    const float v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
    const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
    const float best_t = kAnyHit ? INFINITY : b.t;
    const bool ok = det_ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t >= r.tmin &&
                    t <= r.tmax && t < best_t && (mask == nullptr || mask[id] != 0);
    if (ok) {
      if (kAnyHit) return true;
      b.t = t;
      b.tri = id;
      b.u = u;
      b.v = v;
    }
  }
  return false;
}

template <bool kAnyHit>
__device__ __forceinline__ void write_out(int i, const Best& b, bool occluded, float* t_out,
                                          int* tri_out, float* u_out, float* v_out,
                                          unsigned char* occ_out) {
  if (kAnyHit) {
    occ_out[i] = occluded ? 1 : 0;
  } else {
    t_out[i] = b.t;
    tri_out[i] = b.tri;
    u_out[i] = b.u;
    v_out[i] = b.v;
  }
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads)
bvh_fat_kernel(const int4* __restrict__ fat, const float4* __restrict__ tris,
               const unsigned char* __restrict__ mask,
               const float* __restrict__ o, int o_ray, int o_comp,
               const float* __restrict__ d, int d_ray, int d_comp,
               const float* __restrict__ t_min, const float* __restrict__ t_max, int num_r,
               float* __restrict__ t_out, int* __restrict__ tri_out,
               float* __restrict__ u_out, float* __restrict__ v_out,
               unsigned char* __restrict__ occ_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= num_r) return;
  const Ray r = load_ray(i, o, o_ray, o_comp, d, d_ray, d_comp, t_min, t_max);
  Best b{INFINITY, -1, 0.0f, 0.0f};
  bool occluded = false;
  int stack[kStackDepth];
  int sp = 0;
  int row = 0;
  while (true) {
    const int4* p = fat + 4 * (long long)row;
    const int4 q0 = __ldg(p);
    const int4 q1 = __ldg(p + 1);
    const int4 q2 = __ldg(p + 2);
    const int4 q3 = __ldg(p + 3);
    const float cap = kAnyHit ? r.tmax : fminf(r.tmax, b.t);
    const bool hit_l = box_hit(r, bits(q0.x), bits(q0.y), bits(q0.z),
                               bits(q0.w), bits(q1.x), bits(q1.y), cap);
    const bool hit_r = box_hit(r, bits(q1.z), bits(q1.w), bits(q2.x),
                               bits(q2.y), bits(q2.z), bits(q2.w), cap);
    const int count_l = q3.z >> 5;
    const int count_r = q3.z & 31;
    if (hit_l && count_l > 0 && test_leaf<kAnyHit>(r, tris, mask, q3.x, count_l, b)) {
      occluded = true;
      break;
    }
    if (hit_r && count_r > 0 && test_leaf<kAnyHit>(r, tris, mask, q3.y, count_r, b)) {
      occluded = true;
      break;
    }
    const bool down = hit_l && count_l == 0;
    const bool go_r = hit_r && count_r == 0;
    if (down) {
      // the tree's depth is checked against kStackDepth when it is frozen
      if (go_r && sp < kStackDepth) stack[sp++] = q3.y;
      row = q3.x;
    } else if (go_r) {
      row = q3.y;
    } else if (sp > 0) {
      row = stack[--sp];
    } else {
      break;
    }
  }
  write_out<kAnyHit>(i, b, occluded, t_out, tri_out, u_out, v_out, occ_out);
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads)
bvh_node_kernel(const int4* __restrict__ nodes, const float4* __restrict__ tris,
                const unsigned char* __restrict__ mask,
                const float* __restrict__ o, int o_ray, int o_comp,
                const float* __restrict__ d, int d_ray, int d_comp,
                const float* __restrict__ t_min, const float* __restrict__ t_max, int num_r,
                float* __restrict__ t_out, int* __restrict__ tri_out,
                float* __restrict__ u_out, float* __restrict__ v_out,
                unsigned char* __restrict__ occ_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= num_r) return;
  const Ray r = load_ray(i, o, o_ray, o_comp, d, d_ray, d_comp, t_min, t_max);
  Best b{INFINITY, -1, 0.0f, 0.0f};
  bool occluded = false;
  int stack[kStackDepth];
  int sp = 0;
  int node = 0;
  while (true) {
    const int4* p = nodes + 2 * (long long)node;
    const int4 q0 = __ldg(p);
    const int4 q1 = __ldg(p + 1);
    const float cap = kAnyHit ? r.tmax : fminf(r.tmax, b.t);
    const bool hit = box_hit(r, bits(q0.x), bits(q0.y), bits(q0.z),
                             bits(q0.w), bits(q1.x), bits(q1.y), cap);
    const int left = q1.z;
    const int count = q1.w;
    if (hit && count > 0 && test_leaf<kAnyHit>(r, tris, mask, left, count, b)) {
      occluded = true;
      break;
    }
    if (hit && count == 0) {
      if (sp < kStackDepth) stack[sp++] = left;
      node = node + 1;
    } else if (sp > 0) {
      node = stack[--sp];
    } else {
      break;
    }
  }
  write_out<kAnyHit>(i, b, occluded, t_out, tri_out, u_out, v_out, occ_out);
}

inline int grid_for(int num_r) { return (num_r + kThreads - 1) / kThreads; }

}  // namespace

extern "C" {

// Every entry: `table` is the fat table (Ni, 16) int32 or the node table
// (N, 8) int32, `tris` the (T, 12) float32 triangle rows in leaf order,
// `mask` a (T,) byte per original triangle id or null. Ray component c of
// ray i is at o[i * o_ray + c * o_comp] (likewise d). Launches on `stream`
// without synchronising; returns cudaGetLastError().
int etx_bvh_intersect_fat(const int* table, const float* tris, const unsigned char* mask,
                          const float* o, int o_ray, int o_comp,
                          const float* d, int d_ray, int d_comp,
                          const float* t_min, const float* t_max, int num_r,
                          float* t_out, int* tri_out, float* u_out, float* v_out,
                          void* stream) {
  if (num_r <= 0) return (int)cudaErrorInvalidValue;
  bvh_fat_kernel<false><<<grid_for(num_r), kThreads, 0, (cudaStream_t)stream>>>(
      (const int4*)table, (const float4*)tris, mask, o, o_ray, o_comp, d, d_ray, d_comp,
      t_min, t_max, num_r, t_out, tri_out, u_out, v_out, nullptr);
  return (int)cudaGetLastError();
}

int etx_bvh_occluded_fat(const int* table, const float* tris, const unsigned char* mask,
                         const float* o, int o_ray, int o_comp,
                         const float* d, int d_ray, int d_comp,
                         const float* t_min, const float* t_max, int num_r,
                         unsigned char* occ_out, void* stream) {
  if (num_r <= 0) return (int)cudaErrorInvalidValue;
  bvh_fat_kernel<true><<<grid_for(num_r), kThreads, 0, (cudaStream_t)stream>>>(
      (const int4*)table, (const float4*)tris, mask, o, o_ray, o_comp, d, d_ray, d_comp,
      t_min, t_max, num_r, nullptr, nullptr, nullptr, nullptr, occ_out);
  return (int)cudaGetLastError();
}

int etx_bvh_intersect_node(const int* table, const float* tris, const unsigned char* mask,
                           const float* o, int o_ray, int o_comp,
                           const float* d, int d_ray, int d_comp,
                           const float* t_min, const float* t_max, int num_r,
                           float* t_out, int* tri_out, float* u_out, float* v_out,
                           void* stream) {
  if (num_r <= 0) return (int)cudaErrorInvalidValue;
  bvh_node_kernel<false><<<grid_for(num_r), kThreads, 0, (cudaStream_t)stream>>>(
      (const int4*)table, (const float4*)tris, mask, o, o_ray, o_comp, d, d_ray, d_comp,
      t_min, t_max, num_r, t_out, tri_out, u_out, v_out, nullptr);
  return (int)cudaGetLastError();
}

int etx_bvh_occluded_node(const int* table, const float* tris, const unsigned char* mask,
                          const float* o, int o_ray, int o_comp,
                          const float* d, int d_ray, int d_comp,
                          const float* t_min, const float* t_max, int num_r,
                          unsigned char* occ_out, void* stream) {
  if (num_r <= 0) return (int)cudaErrorInvalidValue;
  bvh_node_kernel<true><<<grid_for(num_r), kThreads, 0, (cudaStream_t)stream>>>(
      (const int4*)table, (const float4*)tris, mask, o, o_ray, o_comp, d, d_ray, d_comp,
      t_min, t_max, num_r, nullptr, nullptr, nullptr, nullptr, occ_out);
  return (int)cudaGetLastError();
}

const char* etx_bvh_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
