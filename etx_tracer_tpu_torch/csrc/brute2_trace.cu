// Pair-tile ray/triangle intersection for any triangle count: closest hit
// (K3) and any hit (K4), for NVIDIA Hopper (sm_90a). The trace dispatch
// sends 129 to 4096 triangles here (ops/trace.py); the kernels, like the
// TPU kernels they replace, take any count.
//
// Replaces the TPU kernels of etx_tracer_tpu/ops/pallas_trace.py:
//   K3 intersect_brute2_pallas (:1121, `_kernel_brute2`)        -> brute2_kernel<false>
//   K4 occluded_brute2_pallas  (:1148, `_kernel_brute2_anyhit`) -> brute2_kernel<true>
// Both compute the outputs of the TPU kernels, not their layout. The TPU
// versions hold the whole triangle table as a transposed (16, T) matrix in
// VMEM and evaluate (256 rays) x (512 triangles) pair tiles on the vector
// unit.
//
// Design. A block takes a tile of 256 consecutive rays and packs its live
// rays: each thread tests one ray's interval, the block ballots and writes
// the live indices, in order, to a list in shared memory; a dead ray gets
// its miss at once and is never seen again, and a tile with no live ray
// ends there. The block then stages the triangle table in dynamic shared
// memory as 48-byte rows (v0, e1, e2, each padded to a float4, the mask
// folded into the edges), up to 1024 rows (48 KB) a chunk, padded to a
// multiple of 32 with zero rows (det == 0, never valid): a table of at most
// 1024 triangles, such as the materials scene's 996, is staged once and its
// loops have no barrier; a larger one takes a barrier per chunk. Warps then
// work on the live list cooperatively, lane l testing rows l, l + 32, ...,
// the same count in every lane: a row is three LDS.128, free of bank
// conflicts (a 48-byte stride puts the 8 lanes of each phase on 8 disjoint
// 4-bank groups), and no lane holds a dead ray.
//   K4 (any hit): the block also stages each live ray's o, t_min, d, t_max
//   in shared memory; a warp takes one live ray at a time from a shared
//   counter and ends it with __any_sync at the first 32-row step that holds
//   a valid pair, so a ray costs ceil(first / 32) steps and no lane waits
//   on another lane's ray. The test order inside a ray is free (an OR), so
//   it is lane-major: rows 0-31 in one step.
//   K3 (closest hit): a warp takes two live rays at a time (each staged row
//   is loaded once for both); every lane marks its valid rows in a bit mask
//   per ray, then, past the loop, divides for those rows in row order and
//   keeps its own best (t, tri) with a strict <; the warp takes the least t
//   and, among equal t, the lowest index (two __reduce_min_sync on an
//   order-preserving integer key of t, then on tri), and a later chunk
//   replaces the best only when strictly nearer. That is the plain
//   version's rule (least t, lowest lane in a chunk, earlier chunk on a
//   tie). The winner's a, b, |det| are recomputed once, from the same row
//   and the same expressions, for u = a * (1 / |det|), v = b * (1 / |det|).
//
// What bounds them. K3: the instructions a pair issues. Every live ray
// needs every pair: 41 FP32 adds, subtracts and multiplies, 4 for the sign
// (one compare, three selects), 7 compares, 2 multiplies for the interval
// ends and one instruction to mark the row, about 55 (cuobjdump counts
// 469 for the unrolled loop's 4 rows x 2 rays, 58.6 a pair), where the
// first design issued about 68 (9 scalar shared loads and a branch around
// the division for every pair). The bound counts 48 operations a pair at
// the 67 TFLOP/s peak, which counts a fused multiply-add as two; built with
// -fmad=false no product fuses, so half that peak is the ceiling. K4: the
// pairs up to each ray's first valid one, rounded up to whole 32-row steps,
// at 63 instructions a step (a row's loads, the test, the vote and the
// loop), and the latency of a step's dependent chain, which one ray per
// warp does not hide; the first design ran every ray of a warp as long as
// its slowest lane.
//
// Registers, occupancy and waves (chip_smoke.py's build phase and timed
// K3/K4 cases on an H100): K3 uses 60 registers and 3,104 B of static
// shared memory, K4 40 registers and 10,288 B (the staged rays). At 996
// triangles (1,024 padded rows, 48 KB) both registers and shared memory let
// K3 hold 4 blocks of 256 threads on an SM, so the 1,024 blocks of 2^18
// rays run in 1.94 waves of 528; K4's 58 KB allow 3 blocks, 2.59 waves of
// 396. A larger table keeps K3 at 4 blocks, one 1,024-row chunk at a time.
//
// The skip test. A ray is dead when t_max <= 0 and t_min > 1e-30. Such a
// ray has no valid pair under the kernel's own rounding: a valid pair needs
// dd > 1e-9, so the exact product t_min * dd exceeds 1e-39, far above half
// the least subnormal, and RN(t_min * dd) > 0 (no flush to zero: built
// without fast math); t_max <= 0 gives RN(t_max * dd) <= 0; tt >= RN(t_min *
// dd) > 0 >= RN(t_max * dd) >= tt cannot hold. (t_max < t_min alone does not
// suffice: the two rounded products may be equal; t_min = t_max = 0 is not
// empty: tt == 0 passes both tests.) A dead ray writes what a miss writes:
// t = +inf, tri = -1, u = v = 0, occluded 0.
//
// Numerics: the expressions of `_kernel_brute2`, in the same order, built
// with -fmad=false and without --use_fast_math, so each rounds as the plain
// PyTorch version (etx_tracer_tpu_torch/ops/brute2_trace.py) evaluates it;
// the two agree bit for bit. Two rewrites are exact: dd = |det| where the
// plain version has det * sgn (they differ only at det = -0 and NaN, where
// dd > 1e-9 fails either way and the winner's dd is never read), and
// x * sgn becomes a select of x or -x (a product with +-1 is exact).
//
// Semantics (both kernels): Möller-Trumbore validity tested without a
// division on sign-multiplied forms: with sgn = det >= 0 ? 1 : -1,
// dd = det * sgn, a = u * det * sgn, b = v * det * sgn, tt = t * det * sgn,
// a pair is valid when dd > 1e-9, a >= 0, b >= 0, a + b <= dd,
// tt >= t_min * dd and tt <= t_max * dd. A masked triangle is staged with
// zero edges (det == 0, never valid), as the TPU kernels fold the mask into
// the geometry. K3 takes t = tt / dd; it writes t (+inf on a miss), tri
// (-1), u, v (0). K4 writes one byte per ray.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;          // rays per tile, one block per tile
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 1024;         // rows staged per chunk: 48 KB
constexpr int kRays = 2;               // K3: rays a warp tests against each row load
constexpr float kMtEps = 1e-9f;
constexpr float kSkipTMin = 1e-30f;
constexpr unsigned kFull = 0xffffffffu;

struct Tris {
  const float* v0;
  const float* e1;
  const float* e2;
  const unsigned char* mask;  // may be null
  int n;
};

struct Rays {
  const float* o;
  int o_ray, o_comp;
  const float* d;
  int d_ray, d_comp;
  const float* t_min;
  const float* t_max;
  int n;
};

struct Out {
  float* t;
  int* tri;
  float* u;
  float* v;
  unsigned char* occ;
};

struct Ray {
  float ox, oy, oz, dx, dy, dz, tmin, tmax;
};

struct Row {
  float4 v0, e1, e2;
};

__device__ __forceinline__ Ray load_ray(const Rays& rs, int i) {
  const long long io = (long long)i * rs.o_ray, id = (long long)i * rs.d_ray;
  Ray r;
  r.ox = rs.o[io];
  r.oy = rs.o[io + rs.o_comp];
  r.oz = rs.o[io + 2 * rs.o_comp];
  r.dx = rs.d[id];
  r.dy = rs.d[id + rs.d_comp];
  r.dz = rs.d[id + 2 * rs.d_comp];
  r.tmin = rs.t_min[i];
  r.tmax = rs.t_max[i];
  return r;
}

// Triangle g as staged: the mask folded into the edges.
__device__ __forceinline__ Row load_row(const Tris& tr, int g) {
  const float m = (tr.mask == nullptr || tr.mask[g] != 0) ? 1.0f : 0.0f;
  const float* p = tr.v0 + 3LL * g;
  const float* q = tr.e1 + 3LL * g;
  const float* s = tr.e2 + 3LL * g;
  Row w;
  w.v0 = make_float4(p[0], p[1], p[2], 0.0f);
  w.e1 = make_float4(q[0] * m, q[1] * m, q[2] * m, 0.0f);
  w.e2 = make_float4(s[0] * m, s[1] * m, s[2] * m, 0.0f);
  return w;
}

__device__ __forceinline__ Row smem_row(const float4* rows, int i) {
  return Row{rows[3 * i], rows[3 * i + 1], rows[3 * i + 2]};
}

// `_pairs` for one ray and one row: whether the pair is valid, and a, b, tt, dd.
__device__ __forceinline__ bool pair_test(const Row& w, const Ray& r, float& a, float& b,
                                          float& tt, float& dd) {
  const float px = r.dy * w.e2.z - r.dz * w.e2.y;
  const float py = r.dz * w.e2.x - r.dx * w.e2.z;
  const float pz = r.dx * w.e2.y - r.dy * w.e2.x;
  const float det = px * w.e1.x + py * w.e1.y + pz * w.e1.z;
  const bool pos = det >= 0.0f;
  dd = fabsf(det);
  const float tx = r.ox - w.v0.x;
  const float ty = r.oy - w.v0.y;
  const float tz = r.oz - w.v0.z;
  const float sa = tx * px + ty * py + tz * pz;
  a = pos ? sa : -sa;
  const float qx = ty * w.e1.z - tz * w.e1.y;
  const float qy = tz * w.e1.x - tx * w.e1.z;
  const float qz = tx * w.e1.y - ty * w.e1.x;
  const float sb = r.dx * qx + r.dy * qy + r.dz * qz;
  b = pos ? sb : -sb;
  const float st = w.e2.x * qx + w.e2.y * qy + w.e2.z * qz;
  tt = pos ? st : -st;
  return dd > kMtEps && a >= 0.0f && b >= 0.0f && a + b <= dd && tt >= r.tmin * dd &&
         tt <= r.tmax * dd;
}

// An unsigned key in the order of t, with +0 and -0 one key (they tie, as
// in the plain version's comparisons).
__device__ __forceinline__ unsigned order_key(float t) {
  const unsigned u = __float_as_uint(t == 0.0f ? 0.0f : t);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// Stages triangles s .. s + m - 1 as rows 0 .. m - 1, then zero rows up to
// `padded` (zero edges: det == 0, never valid).
__device__ void stage(float4* rows, const Tris& tr, int s, int m, int padded) {
  for (int j = threadIdx.x; j < padded; j += kThreads) {
    Row w{};
    if (j < m) w = load_row(tr, s + j);
    rows[3 * j] = w.v0;
    rows[3 * j + 1] = w.e1;
    rows[3 * j + 2] = w.e2;
  }
}

// K3 on one staged chunk of `padded` rows (triangles s .., a multiple of 32,
// at most 1024): the warp's groups of kRays live rays; merges each ray's
// best into best_t / best_tri. Lane l tests rows l, l + 32, ... (the same
// count in every lane) and marks the valid ones in a bit mask per ray; the
// divisions and compares of the few valid rows come after the loop, in row
// order, so the loop has no branch.
__device__ void closest_chunk(const float4* rows, int s, int padded, const Rays& rs,
                              const int* list, int n, float* best_t, int* best_tri) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int count = padded >> 5;  // rows of each lane
  for (int g = warp * kRays; g < n; g += kWarps * kRays) {
    Ray ray[kRays];
#pragma unroll
    for (int k = 0; k < kRays; ++k) ray[k] = load_ray(rs, list[min(g + k, n - 1)]);
    unsigned valid[kRays] = {};
    const float4* p = rows + 3 * lane;
#pragma unroll 4
    for (int it = 0; it < count; ++it, p += 3 * 32) {
      const Row w{p[0], p[1], p[2]};
#pragma unroll
      for (int k = 0; k < kRays; ++k) {
        float a, b, tt, dd;
        if (pair_test(w, ray[k], a, b, tt, dd)) valid[k] |= 1u << it;
      }
    }
#pragma unroll
    for (int k = 0; k < kRays; ++k) {
      const int j = g + k;
      if (j >= n) break;  // warp-uniform
      float bt = INFINITY;
      int bi = -1;
      for (unsigned v = valid[k]; v != 0; v &= v - 1) {
        const int i = lane + 32 * (__ffs(v) - 1);
        float a, b, tt, dd;
        pair_test(smem_row(rows, i), ray[k], a, b, tt, dd);
        const float t = tt / dd;
        if (t < bt) {
          bt = t;
          bi = s + i;
        }
      }
      const unsigned key = order_key(bt);
      const unsigned kmin = __reduce_min_sync(kFull, key);
      const unsigned win = __reduce_min_sync(kFull, key == kmin ? (unsigned)bi : 0xffffffffu);
      // one lane holds the winning row; a later chunk wins only when nearer
      if (bi >= 0 && (unsigned)bi == win && bt < best_t[j]) {
        best_t[j] = bt;
        best_tri[j] = bi;
      }
    }
  }
}

// K4 on one staged chunk of `padded` rows (a multiple of 32): warps take
// unresolved live rays one at a time, their data staged in shared memory.
__device__ void anyhit_chunk(const float4* rows, int padded, const float4* ray_o,
                             const float4* ray_d, int n, int* resolved, int* next_ray,
                             int* num_resolved) {
  const int lane = threadIdx.x & 31;
  for (;;) {
    int j = 0;
    if (lane == 0) j = atomicAdd(next_ray, 1);
    j = __shfl_sync(kFull, j, 0);
    if (j >= n) break;
    if (resolved[j]) continue;  // occluded in an earlier chunk
    const float4 o = ray_o[j], d = ray_d[j];
    const Ray ray{o.x, o.y, o.z, d.x, d.y, d.z, o.w, d.w};
    const float4* p = rows + 3 * lane;
    for (int base = 0; base < padded; base += 32, p += 3 * 32) {
      float a, b, tt, dd;
      const bool ok = pair_test(Row{p[0], p[1], p[2]}, ray, a, b, tt, dd);
      if (__any_sync(kFull, ok)) {
        if (lane == 0) {
          resolved[j] = 1;
          atomicAdd(num_resolved, 1);
        }
        break;
      }
    }
  }
}

template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads, 4)
brute2_kernel(const Tris tr, const Rays rs, const Out out, int chunk) {
  extern __shared__ float4 rows[];
  __shared__ int list[kThreads];
  __shared__ int warp_live[kWarps];
  __shared__ float best_t[kThreads];   // K3
  __shared__ int best_tri[kThreads];   // K3: the winner; K4: 1 once occluded
  __shared__ int next_ray, num_resolved;
  // K4: each live ray's o, t_min and d, t_max, in list order
  __shared__ float4 ray_o[kAnyHit ? kThreads : 1], ray_d[kAnyHit ? kThreads : 1];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r = blockIdx.x * kThreads + tid;
  bool live = false;
  if (r < rs.n) {
    live = !(rs.t_max[r] <= 0.0f && rs.t_min[r] > kSkipTMin);
    if (!live) {
      if (kAnyHit) {
        out.occ[r] = 0;
      } else {
        out.t[r] = INFINITY;
        out.tri[r] = -1;
        out.u[r] = 0.0f;
        out.v[r] = 0.0f;
      }
    }
  }
  const unsigned ballot = __ballot_sync(kFull, live);
  if (lane == 0) warp_live[warp] = __popc(ballot);
  if (tid == 0) num_resolved = 0;
  __syncthreads();
  int n = 0, at = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    at += w < warp ? warp_live[w] : 0;
    n += warp_live[w];
  }
  if (n == 0) return;  // block-uniform: every ray of the tile is dead
  if (live) {
    const int slot = at + __popc(ballot & ((1u << lane) - 1u));
    list[slot] = r;
    if (kAnyHit) {
      const Ray ray = load_ray(rs, r);
      ray_o[slot] = make_float4(ray.ox, ray.oy, ray.oz, ray.tmin);
      ray_d[slot] = make_float4(ray.dx, ray.dy, ray.dz, ray.tmax);
    }
  }
  if (tid < n) {
    best_t[tid] = INFINITY;
    best_tri[tid] = kAnyHit ? 0 : -1;
  }
  __syncthreads();

  for (int s = 0; s < tr.n; s += chunk) {
    const int m = min(chunk, tr.n - s);
    const int padded = (m + 31) & ~31;
    stage(rows, tr, s, m, padded);
    if (tid == 0) next_ray = 0;
    __syncthreads();
    if (kAnyHit) {
      anyhit_chunk(rows, padded, ray_o, ray_d, n, best_tri, &next_ray, &num_resolved);
    } else {
      closest_chunk(rows, s, padded, rs, list, n, best_t, best_tri);
    }
    // every warp is done with the rows before they are staged again
    __syncthreads();
    if (kAnyHit && num_resolved == n) break;
  }

  if (tid >= n) return;
  const int i = list[tid];
  if (kAnyHit) {
    out.occ[i] = best_tri[tid] ? 1 : 0;
  } else {
    const int tri = best_tri[tid];
    float u = 0.0f, v = 0.0f;
    if (tri >= 0) {
      float a, b, tt, dd;
      pair_test(load_row(tr, tri), load_ray(rs, i), a, b, tt, dd);
      const float inv = 1.0f / dd;
      u = a * inv;
      v = b * inv;
    }
    out.t[i] = best_t[tid];
    out.tri[i] = tri;
    out.u[i] = u;
    out.v[i] = v;
  }
}

// Rows per chunk: the whole table up to kMaxRows, else chunks of kMaxRows
// and a shorter last one.
inline int chunk_rows(int num_t) { return num_t < kMaxRows ? num_t : kMaxRows; }

// Dynamic shared memory of a chunk, its rows padded to a multiple of 32.
inline int smem_bytes(int num_t) { return ((chunk_rows(num_t) + 31) & ~31) * (int)sizeof(Row); }

template <bool kAnyHit>
int launch(const Tris& tr, const Rays& rs, const Out& out, void* stream) {
  if (tr.n < 0 || rs.n <= 0) return (int)cudaErrorInvalidValue;
  const int chunk = chunk_rows(tr.n);
  const int smem = smem_bytes(tr.n);
  // the 48 KB a block may take without this counts the static arrays too
  const cudaError_t e = cudaFuncSetAttribute(
      brute2_kernel<kAnyHit>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int grid = (rs.n + kThreads - 1) / kThreads;
  brute2_kernel<kAnyHit><<<grid, kThreads, smem, (cudaStream_t)stream>>>(tr, rs, out, chunk);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Closest hit. Ray component c of ray i is at o[i * o_ray + c * o_comp]
// (likewise d); triangle arrays are contiguous (T, 3); mask may be null.
// Launches on `stream` without synchronising; returns cudaGetLastError().
int etx_brute2_intersect(const float* v0, const float* e1, const float* e2,
                         const unsigned char* mask, int num_t,
                         const float* o, int o_ray, int o_comp,
                         const float* d, int d_ray, int d_comp,
                         const float* t_min, const float* t_max, int num_r,
                         float* t_out, int* tri_out, float* u_out, float* v_out,
                         void* stream) {
  return launch<false>(Tris{v0, e1, e2, mask, num_t},
                       Rays{o, o_ray, o_comp, d, d_ray, d_comp, t_min, t_max, num_r},
                       Out{t_out, tri_out, u_out, v_out, nullptr}, stream);
}

// Any hit: occ_out[i] = 1 when ray i has a valid pair with an unmasked
// triangle, else 0.
int etx_brute2_occluded(const float* v0, const float* e1, const float* e2,
                        const unsigned char* mask, int num_t,
                        const float* o, int o_ray, int o_comp,
                        const float* d, int d_ray, int d_comp,
                        const float* t_min, const float* t_max, int num_r,
                        unsigned char* occ_out, void* stream) {
  return launch<true>(Tris{v0, e1, e2, mask, num_t},
                      Rays{o, o_ray, o_comp, d, d_ray, d_comp, t_min, t_max, num_r},
                      Out{nullptr, nullptr, nullptr, nullptr, occ_out}, stream);
}

// Blocks of K3 (any_hit 0) or K4 (1) that one SM of the current device
// holds at once for a table of num_t triangles; each block takes 256 rays.
int etx_brute2_occupancy(int num_t, int any_hit, int* blocks_per_sm) {
  if (num_t < 0) return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes(num_t);
  cudaError_t e;
  if (any_hit) {
    e = cudaFuncSetAttribute(brute2_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, brute2_kernel<true>,
                                                         kThreads, smem);
  } else {
    e = cudaFuncSetAttribute(brute2_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, brute2_kernel<false>,
                                                         kThreads, smem);
  }
  return (int)e;
}

const char* etx_brute2_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
