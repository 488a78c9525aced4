// Woop unit-triangle ray/triangle intersection for any triangle count:
// closest hit (K9a) and any hit (K9b), for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels of etx_tracer_tpu/ops/pallas_trace.py:
//   K9a intersect_woop_pallas (:1365, pallas_call :1380; body
//       `_kernel_woop` :1227)        -> woop_kernel<false>
//   K9b occluded_woop_pallas  (:1392, pallas_call :1406; body
//       `_kernel_woop_anyhit` :1273) -> woop_kernel<true>
// Both compute the outputs of the TPU kernels, not their layout. The TPU
// versions multiply a (256 rays, 8) block by an (8, 6 x 512) table chunk on
// the matrix unit, in emulated FP32, and run the validity tests on the
// vector unit. Here the six dot products of a pair are plain FP32 multiplies
// and adds: no cuBLAS, no tensor cores.
//
// Design. A block takes a tile of 256 consecutive rays and packs its live
// rays: each thread tests one ray's interval (the skip test below), the
// block ballots and writes the live indices, in order, to a list in shared
// memory; a dead ray gets its miss at once, and a tile with no live ray
// ends there. The block stages the (T, 12) table of rows [r_u b_u r_v b_v
// r_w b_w] (ops/woop_trace.py:woop_tables) in dynamic shared memory as it
// is (48 bytes, three float4 a row), up to 1024 rows (48 KB) a chunk,
// padded to a multiple of 32 with zero rows (q_z = 0, never valid): a table
// of at most 1024 triangles, such as the materials scene's 996, is staged
// once and its loops have no barrier; a larger one takes a barrier per
// chunk. Every shared load is a broadcast (all lanes one row) or a row a
// lane at a 48-byte stride, which puts the 8 lanes of each LDS.128 phase on
// 8 disjoint 4-bank groups: no bank conflicts.
//   K9b (any hit): the block also stages each live ray's o, t_min, d, t_max
//   in shared memory; a warp takes one live ray at a time from a shared
//   counter, lane l tests rows l, l + 32, ..., and the warp ends the ray
//   with __any_sync at the first 32-row step that holds a valid pair, so a
//   ray costs ceil(first / 32) steps and no lane waits on another lane's
//   ray. The order inside a ray is free: the result is an OR.
//   K9a (closest hit): thread i of the block owns live ray i. Each pair is
//   split into a cheap half and a dear half, and only candidates run the
//   dear half, packed across the warp. For each 32 rows: (1) every lane
//   runs the cheap half of its own ray against the 32 rows, read by all
//   lanes at once: q_z and w_z (the r_w, b_w row, 11 FP32 operations),
//   |q_z| > 1e-7, the sign test and the cull below, into a 32-bit mask;
//   (2) the warp transposes the 32 masks by five xor shuffles, so lane l
//   holds, for row l, the rays whose pair with it is a candidate; (3) lane
//   l walks those rays, taking each ray's o, d, t_min, t_max by shuffle
//   from its lane, and runs the dear half against row l (in its registers):
//   w_x, w_y, q_x, q_y, the division t = -w_z / q_z, u, v and the compares.
//   The warp walks as many steps as its busiest lane, not one a pair. A
//   valid pair (about 0.1% of pairs) goes by shuffle to the ray's lane,
//   which keeps the least (t, index) as a pair, since candidates come in no
//   index order: among equal t (+0 and -0 equal, as the plain version
//   compares them) the lowest index. That is the plain version's winner
//   (least t, the lowest index among equal ones), with its own u and v.
//
// The skip test. A ray is dead when !(t_min <= t_max), NaN ends included
// (`woop_trace.dead_lanes`). A valid pair needs t >= t_min and t <= t_max
// on one rounded t; a NaN end fails its compare, and t_min > t_max would
// give t_max < t_min <= t <= t_max. So a dead ray has no valid pair, and it
// writes what a miss writes: t = +inf, tri = -1, u = v = 0, occluded 0.
//
// The sign test (K9a). For a ray with t_min > 0 a pair can be valid only if
// w_z != 0 and the sign bits of w_z and q_z differ. Proof: a valid pair has
// t = RN(-w_z / q_z) >= t_min > 0, so t is neither NaN nor a zero and its
// sign bit is 0. IEEE division (built without fast math: div.rn.f32, no
// flush to zero) gives a non-NaN quotient the XOR of its operands' signs,
// and the negation flips w_z's, so the sign bits of w_z and q_z differ; a
// zero w_z gives a zero quotient for |q_z| > 1e-7, which is not > 0. The
// kernel reads the bits ((w_z ^ q_z) >> 31), never the product w_z * q_z,
// which can underflow to a zero of either sign, and keeps the pairs with a
// zero w_z (a superset: too few to pay for the compare). A ray with
// t_min <= 0 takes every pair with |q_z| > 1e-7 to the dear half.
//
// The cull (K9a). For a ray with t_min > 0, let c be the least of its t_max
// and its best t so far, and cut the next float above c. A candidate (signs
// differ, so -w_z / q_z = |w_z| / |q_z|) with RN(|w_z| - cut |q_z|) > 0, one
// rounding by an explicit fused multiply-add, has |w_z| / |q_z| > cut, so
// t = RN(-w_z / q_z) >= cut > c: beyond t_max (invalid), or farther than a
// valid pair already found (never the winner, not even a tie). It is dropped
// before the division.
//
// What bounds them. K9a: the instructions issued. Every live ray needs
// every pair's cheap half (a broadcast load, 11 FP32 operations, the
// tests, the mask and a share of the transpose: about 22 a pair) and each
// candidate's step of the dear half (8 shuffles, q_z and w_z again, 22
// FP32 operations for w_x, w_y, q_x, q_y, the division's fast path, u, v
// and five compares: about 85 a step, for as many steps as the warp's
// busiest lane needs). On the micro-benchmark's random rays about half the
// pairs pass the sign test. The bound counts 39 operations a pair at the
// 67 TFLOP/s peak, which counts a fused multiply-add as two; built with
// -fmad=false no product fuses. K9b: the pairs up to each ray's first valid
// one, rounded up to whole 32-row steps, each step a row's three loads, the
// whole test, the vote and the loop, and the latency of a step's dependent
// chain, which one ray a warp does not hide.
//
// Registers, shared memory and occupancy (ptxas, on an H100): K9a is
// bounded to 64 registers for 4 blocks of 256 threads an SM; its static
// shared memory is the live list (1 KB); with a 1024-row chunk (48 KB) 4
// blocks share an SM, so the 1,024 blocks of 2^18 rays run in 1.94 waves
// of 528. K9b uses 40 registers and 10 KB of static shared memory (the
// list, the staged rays, a flag a ray): 58 KB a block, 3 blocks an SM,
// 2.59 waves of 396. `chip_smoke.py` prints each launch's blocks an SM.
//
// Numerics: built with -fmad=false and without --use_fast_math, so each
// product and sum rounds on its own, in the order the plain PyTorch version
// (ops/woop_trace.py:_pairs) evaluates it; given the same table the two
// agree bit for bit. The rewrites change which lane tests a pair and when,
// never the arithmetic: the dear half forms q_z and w_z again from the same
// row and ray in the same order; a pair that the skip test, the sign test
// or the cull drops is one the plain version finds invalid or that cannot
// win; the explicit fused multiply-add of the cull decides only that; the
// (t, index) minimum is the plain version's winner, and its u, v are the
// winner's own.
//
// Semantics (both kernels): w_k = r_k . o + b_k and q_k = r_k . d, summed
// x, y, z, then the bias; a pair is valid when |q_z| > 1e-7 and, with
// t = -w_z / q_z, u = w_x + t q_x, v = w_y + t q_y: u >= 0, v >= 0,
// u + v <= 1, t_min <= t <= t_max. Masked and degenerate triangles have
// all-zero rows (q_z == 0, never valid). K9a writes t (+inf on a miss), tri
// (-1), u, v (0); K9b writes one byte per ray.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;          // rays per tile, one block per tile
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 1024;         // rows staged per chunk: 48 KB
constexpr float kQzEps = 1e-7f;
constexpr unsigned kFull = 0xffffffffu;

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

// Stages table rows s .. s + m - 1 as rows 0 .. m - 1, then zero rows up to
// `padded` (q_z == 0: never valid).
__device__ void stage(float4* rows, const float4* tab, int s, int m, int padded) {
  const float4* src = tab + 3LL * s;
  for (int j = threadIdx.x; j < 3 * padded; j += kThreads)
    rows[j] = j < 3 * m ? src[j] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// The cheap half's arithmetic: q_z and w_z of ray r against row c (r_w, b_w).
__device__ __forceinline__ void z_terms(const float4& c, const Ray& r, float& wz, float& qz) {
  qz = c.x * r.dx + c.y * r.dy + c.z * r.dz;
  wz = c.x * r.ox + c.y * r.oy + c.z * r.oz + c.w;
}

// The sign test in bit 31: set when the sign bits of w_z and q_z differ, or
// for a ray with t_min <= 0 (`no_test` = 0x80000000), which takes every
// pair with |q_z| > 1e-7. (The sign test without its w_z != 0 term, which
// drops too few pairs to pay.)
__device__ __forceinline__ unsigned sign_word(float wz, float qz, unsigned no_test) {
  return (__float_as_uint(wz) ^ __float_as_uint(qz)) | no_test;
}

// Whether a candidate's t must exceed cut, for a ray with t_min > 0 (its
// sign test passed, so -w_z / q_z = |w_z| / |q_z|): RN(|w_z| - cut |q_z|) > 0
// gives |w_z| / |q_z| > cut, so t = RN(-w_z / q_z) >= cut. One rounding (an
// explicit fused multiply-add, which -fmad=false does not split).
__device__ __forceinline__ bool beyond(float wz, float qz, float cut) {
  return fmaf(-cut, fabsf(qz), fabsf(wz)) > 0.0f;
}

// The next float above a positive x (x itself when infinite).
__device__ __forceinline__ float next_up(float x) {
  return x < INFINITY ? __uint_as_float(__float_as_uint(x) + 1u) : x;
}

// The dear half: the rest of the pair's test, for a pair with |q_z| > 1e-7,
// rows a (r_u, b_u) and b (r_v, b_v); writes t, u, v.
__device__ __forceinline__ bool dear_half(const float4& a, const float4& b, float wz, float qz,
                                          const Ray& r, float& t, float& u, float& v) {
  const float wx = a.x * r.ox + a.y * r.oy + a.z * r.oz + a.w;
  const float wy = b.x * r.ox + b.y * r.oy + b.z * r.oz + b.w;
  const float qx = a.x * r.dx + a.y * r.dy + a.z * r.dz;
  const float qy = b.x * r.dx + b.y * r.dy + b.z * r.dz;
  t = -wz / qz;
  u = wx + t * qx;
  v = wy + t * qy;
  return u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t >= r.tmin && t <= r.tmax;
}

// `_pairs` for one ray and the staged row at p: whether the pair is valid.
__device__ __forceinline__ bool pair_valid(const float4* p, const Ray& r) {
  float wz, qz;
  z_terms(p[2], r, wz, qz);
  if (!(fabsf(qz) > kQzEps)) return false;
  float t, u, v;
  return dear_half(p[0], p[1], wz, qz, r, t, u, v);
}

// The 32 x 32 bit matrix whose row i is lane i's x, transposed: bit 31 - j
// of lane i's word is (row i, column j), and the result's bit 31 - i of
// lane j's word is the same bit (Hacker's Delight's transpose32, one lane
// a word, partners by xor shuffles).
__device__ __forceinline__ unsigned transpose32(unsigned x, int lane) {
  unsigned m = 0x0000ffffu;
#pragma unroll
  for (int j = 16; j != 0; j >>= 1, m ^= m << j) {
    const unsigned y = __shfl_xor_sync(kFull, x, j);
    if (lane & j) {
      x ^= ((y ^ (x >> j)) & m) << j;
    } else {
      x ^= (x ^ (y >> j)) & m;
    }
  }
  return x;
}

// K9a on one staged chunk of `padded` rows (triangles s .., a multiple of
// 32). Lane l holds live ray l of its warp (`has`: lanes past the block's
// live count hold none) and its best. For each 32 rows: (1) every lane
// runs the cheap half of its ray against the 32 rows, read by all lanes at
// once (a broadcast), into a bit mask; (2) the warp transposes the masks,
// so lane l holds, for row l, the rays whose pair is a candidate; (3) lane
// l walks those rays, taking each ray's data by shuffle from its lane, and
// runs the dear half against row l, held in its registers. The warp walks
// as many steps as its busiest lane. A valid pair (rare) goes to the
// ray's lane, which keeps the least (t, index).
__device__ __forceinline__ void closest_chunk(const float4* rows, int s, int padded, bool has,
                                              const Ray& r, float& bt, int& bi, float& bu,
                                              float& bv) {
  const int lane = threadIdx.x & 31;
  const bool full = !(r.tmin > 0.0f);  // no sign test
  const unsigned no_test = full ? 0x80000000u : 0u;
  for (int base = 0; base < padded; base += 32) {
    unsigned mask = 0;  // bit 31 - j: row base + j is a candidate of this lane's ray
    const float4* p = rows + 3 * base;
    // a pair whose t exceeds t_max or the ray's best so far is dropped
    const float cut = full ? INFINITY : next_up(fminf(r.tmax, bt));
    if (has) {
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        float wz, qz;
        z_terms(p[3 * j + 2], r, wz, qz);
        // bit 31 - j: |q_z| > 1e-7, t not beyond cut, and the sign test
        const bool keep = (fabsf(qz) > kQzEps) & !beyond(wz, qz, cut);
        mask |= keep ? (sign_word(wz, qz, no_test) & 0x80000000u) >> j : 0u;
      }
    }
    unsigned rays = transpose32(mask, lane);  // bit 31 - k: ray k against row base + lane
    const float4* q = p + 3 * lane;
    const float4 ra = q[0], rb = q[1], rc = q[2];
    const int steps = __reduce_max_sync(kFull, __popc(rays));
    for (int it = 0; it < steps; ++it) {
      const bool take = rays != 0;
      const int k = take ? __clz(rays) : lane;  // rays in lane order
      rays &= ~(0x80000000u >> k);
      Ray x;
      x.ox = __shfl_sync(kFull, r.ox, k);
      x.oy = __shfl_sync(kFull, r.oy, k);
      x.oz = __shfl_sync(kFull, r.oz, k);
      x.dx = __shfl_sync(kFull, r.dx, k);
      x.dy = __shfl_sync(kFull, r.dy, k);
      x.dz = __shfl_sync(kFull, r.dz, k);
      x.tmin = __shfl_sync(kFull, r.tmin, k);
      x.tmax = __shfl_sync(kFull, r.tmax, k);
      float wz, qz, t = 0.0f, u = 0.0f, v = 0.0f;
      z_terms(rc, x, wz, qz);
      const bool ok = take && dear_half(ra, rb, wz, qz, x, t, u, v);  // |q_z| > 1e-7
      for (unsigned found = __ballot_sync(kFull, ok); found != 0; found &= found - 1) {
        const int src = __ffs(found) - 1;
        const int kk = __shfl_sync(kFull, k, src);
        const float tt = __shfl_sync(kFull, t, src);
        const float uu = __shfl_sync(kFull, u, src);
        const float vv = __shfl_sync(kFull, v, src);
        const int tri = s + base + src;
        if (lane == kk && (tt < bt || (tt == bt && tri < bi))) {
          bt = tt;
          bi = tri;
          bu = uu;
          bv = vv;
        }
      }
    }
  }
}

// K9b on one staged chunk of `padded` rows (a multiple of 32): warps take
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
      if (__any_sync(kFull, pair_valid(p, ray))) {
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
woop_kernel(const float4* __restrict__ tab, int num_t, const Rays rs, const Out out, int chunk) {
  extern __shared__ float4 rows[];
  __shared__ int list[kThreads];
  __shared__ int warp_live[kWarps];
  __shared__ int resolved[kAnyHit ? kThreads : 1];  // K9b: 1 once occluded
  __shared__ int next_ray, num_resolved;
  // K9b: each live ray's o, t_min and d, t_max, in list order
  __shared__ float4 ray_o[kAnyHit ? kThreads : 1], ray_d[kAnyHit ? kThreads : 1];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r = blockIdx.x * kThreads + tid;
  bool live = false;
  if (r < rs.n) {
    live = rs.t_min[r] <= rs.t_max[r];  // the skip test: NaN ends are dead
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
      resolved[slot] = 0;
    }
  }
  __syncthreads();
  // K9a: thread tid < n owns live ray list[tid] for the whole table
  Ray ray{};
  if (!kAnyHit && tid < n) ray = load_ray(rs, list[tid]);
  const bool has = tid < n;
  float bt = INFINITY, bu = 0.0f, bv = 0.0f;
  int bi = -1;

  for (int s = 0; s < num_t; s += chunk) {
    const int m = min(chunk, num_t - s);
    const int padded = (m + 31) & ~31;
    stage(rows, tab, s, m, padded);
    if (tid == 0) next_ray = 0;
    __syncthreads();
    if (kAnyHit) {
      anyhit_chunk(rows, padded, ray_o, ray_d, n, resolved, &next_ray, &num_resolved);
    } else if (warp * 32 < n) {  // warp-uniform: the warp holds a live ray
      closest_chunk(rows, s, padded, has, ray, bt, bi, bu, bv);
    }
    // every warp is done with the rows before they are staged again
    __syncthreads();
    if (kAnyHit && num_resolved == n) break;
  }

  if (tid >= n) return;
  const int i = list[tid];
  if (kAnyHit) {
    out.occ[i] = resolved[tid] ? 1 : 0;
  } else {
    out.t[i] = bt;
    out.tri[i] = bi;
    out.u[i] = bu;
    out.v[i] = bv;
  }
}

// Rows per chunk: the whole table up to kMaxRows, else chunks of kMaxRows
// and a shorter last one.
inline int chunk_rows(int num_t) { return num_t < kMaxRows ? num_t : kMaxRows; }

// Dynamic shared memory of a chunk, its rows padded to a multiple of 32.
inline int smem_bytes(int num_t) {
  return ((chunk_rows(num_t) + 31) & ~31) * 3 * (int)sizeof(float4);
}

template <bool kAnyHit>
cudaError_t allow_smem(int num_t) {
  // the 48 KB a block may take without this counts the static arrays too
  return cudaFuncSetAttribute(woop_kernel<kAnyHit>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_bytes(num_t));
}

template <bool kAnyHit>
int launch(const float* tab, int num_t, const Rays& rs, const Out& out, void* stream) {
  if (num_t < 0 || rs.n <= 0 || (reinterpret_cast<unsigned long long>(tab) & 15ULL) != 0)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = allow_smem<kAnyHit>(num_t);
  if (e != cudaSuccess) return (int)e;
  const int grid = (rs.n + kThreads - 1) / kThreads;
  woop_kernel<kAnyHit><<<grid, kThreads, smem_bytes(num_t), (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(tab), num_t, rs, out, chunk_rows(num_t));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Closest hit. `tab` is the contiguous (T, 12) float32 Woop table, 16-byte
// aligned. Ray component c of ray i is at o[i * o_ray + c * o_comp]
// (likewise d). Launches on `stream` without synchronising; returns
// cudaGetLastError().
int etx_woop_intersect(const float* tab, int num_t,
                       const float* o, int o_ray, int o_comp,
                       const float* d, int d_ray, int d_comp,
                       const float* t_min, const float* t_max, int num_r,
                       float* t_out, int* tri_out, float* u_out, float* v_out,
                       void* stream) {
  return launch<false>(tab, num_t, Rays{o, o_ray, o_comp, d, d_ray, d_comp, t_min, t_max, num_r},
                       Out{t_out, tri_out, u_out, v_out, nullptr}, stream);
}

// Any hit: occ_out[i] = 1 when ray i has a valid pair, else 0.
int etx_woop_occluded(const float* tab, int num_t,
                      const float* o, int o_ray, int o_comp,
                      const float* d, int d_ray, int d_comp,
                      const float* t_min, const float* t_max, int num_r,
                      unsigned char* occ_out, void* stream) {
  return launch<true>(tab, num_t, Rays{o, o_ray, o_comp, d, d_ray, d_comp, t_min, t_max, num_r},
                      Out{nullptr, nullptr, nullptr, nullptr, occ_out}, stream);
}

// Blocks of K9a (any_hit 0) or K9b (1) that one SM of the current device
// holds at once for a table of num_t triangles; each block takes 256 rays.
int etx_woop_occupancy(int num_t, int any_hit, int* blocks_per_sm) {
  if (num_t < 0) return (int)cudaErrorInvalidValue;
  cudaError_t e;
  if (any_hit) {
    e = allow_smem<true>(num_t);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, woop_kernel<true>,
                                                         kThreads, smem_bytes(num_t));
  } else {
    e = allow_smem<false>(num_t);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, woop_kernel<false>,
                                                         kThreads, smem_bytes(num_t));
  }
  return (int)e;
}

const char* etx_woop_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
