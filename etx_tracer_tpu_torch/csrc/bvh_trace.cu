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
// Here each ray walks the same tree on its own in the same left-first
// pre-order (the fat rows on a stack, the nodes by skips), reading fat rows
// (64 B, four 16-byte loads), node rows (32 B, two loads) and the triangle
// rows reordered by leaf order (48 B, three loads) through the read-only
// path. Ids and counts are int32. The bigscene
// tables (305 KB of fat rows, 305 KB of nodes, 739 KB of triangles) sit in
// the 50 MB L2.
//
// Walk. A fat row slab-tests both children's boxes against
// cap = min(t_max, best_t) (t_max for the any hits), tests the triangles of
// a hit leaf child in place (left, then right), then descends into a hit
// left inner child, pushing a hit right inner child, or goes to a hit right
// inner child, or pops. Row fields: boxes as float32 bits in words 0-11,
// then L_first, R_first (a fat-row index for an inner child, a triangle
// row for a leaf), counts = L_count * 32 + R_count, skip (unused here). A
// plain node slab-tests its box; a hit leaf tests its triangles; the walk
// then goes to the next node (node + 1) after a hit inner node or a leaf,
// and to the node's skip after a missed inner node, as the TPU kernels'
// stream does; it ends at N, the node count. Node row fields: the box as
// float32 bits in words 0-5, word 6 the first triangle row of a leaf or the
// skip of an inner node, word 7 the leaf's count (0: inner). A ray thus
// tests its triangles in the order the TPU kernels' shared stream tests
// them for it (a subsequence), and a strict `t < best_t` keeps the first of
// equal hits: the same triangle wins a tie.
// The any hits return at the first valid triangle, where the TPU kernels
// exit once every ray of the tile is occluded; the output is the same.
//
// What bounds K5/K6. Their work is small and depends on the data: per ray of
// `chip_smoke.py`'s 2^18 test rays in bigscene, K5 reads 14.4 fat rows (p99
// 68, max 129) and tests 8.2 triangles (p99 45, max 90), K6 8.3 rows and 2.9
// triangles, 4 us of bytes at the HBM peak. The kernels take some 50x that,
// and what sets their time is the longest walks, a chain of dependent steps
// each: a row's loads, its box tests, its leaves' triangle tests, the next
// row. One ray a thread, a warp runs as long as its longest walk, and in
// each of its steps the other lanes' leaf loops run in turn: only 0.29 of
// K5's lane slots (0.32 of K6's) carry a step. Dead lanes (an empty
// interval) held slots.
//
// Design of K5/K6 (timed by `kernel_steps.py bvh` against the one-ray-a-thread
// design it replaced; PERF.md §6 has the numbers):
//  - Packing. A ray with !(t_min <= t_max), NaN included, has no valid
//    triangle (a hit wants t_min <= t <= t_max): it gets the miss record at
//    once and no lane walks it.
//  - Lanes from the batch. A warp keeps as many lanes busy as spread the
//    live rays over every warp of the resident grid, at most 32: a small
//    batch (the main path's narrow phases, a batch of long walks) runs a
//    few rays a warp, whose walks diverge less, where 32 rays a warp wait
//    on each other; a large batch runs full warps.
//  - K5 (closest hit): persistent warps (as many blocks as stay resident, the
//    occupancy calculator) take rays from a queue, `want` at a time with one
//    atomicAdd, ballot the live ones to their idle lanes, and refill lanes
//    once 8 are idle (Aila and Laine, "Understanding the Efficiency of Ray
//    Traversal on GPUs", HPG 2009): the long closest-hit walks finish on
//    balanced warps, and a refill's atomic is shared by 8 rays. The lanes to
//    keep come from the live share each warp has seen. A lane steps its
//    ray up to 8 times between two votes of its warp (the votes, the
//    refill test and the parallel-axis vote cost a node step about a
//    quarter of its instructions): on an H100 2-10% off K5 and 4-17% off K7
//    against a vote every step, on every ray set, for a few steps of an
//    idle lane before its refill; 0-5% more than 4 steps a vote, and 16
//    gain nothing more.
//  - K6 (any hit): a first kernel writes the dead rays' misses and packs the
//    live rays' indices into a list (one atomicAdd a block); each active
//    lane of the walk takes one ray of it, and the walk's grid has a block
//    for every 128 rays of the batch (at least the resident grid), which
//    the hardware hands to the SMs as blocks finish. The short any-hit
//    walks gain less from a queue than its atomics and votes cost, and a
//    batch of dead rays (the main path's shadow rays) costs one pass. The
//    resident grid's lanes taking fixed strides of the list, one ray after
//    another, left SMs idle at the end of a large batch (half the lanes of
//    a 2^18 batch walk two rays, the other half one): 10-18% slower on an
//    H100 at 2^18-2^20 test rays, and 3% on the main path's calls.
//  - A warp none of whose rays runs parallel to an axis (|d| < 1e-12, rare
//    off the test rays) steps without the parallel-axis override; the two
//    leaves of a row are tested in one loop of n_l + n_r triangles.
//  - The stack stays in local memory, which L1 holds: in shared memory
//    ([entry][thread], 16 or 64 entries a ray) it was slower. The scratch
//    memory (counts, queue, list) comes from the wrapper; the entry resets
//    it with cudaMemsetAsync on the stream, so a launch can be captured in a
//    CUDA graph.
// The invariant that keeps every bit: each ray makes exactly the steps of
// the plain walk (`ops/bvh_trace.py:_walk`): the same rows in the same
// order, the same cap at each, the same triangle tests in the same order,
// the strict `t < best_t`, the any hit's stop at the first valid triangle.
// The design changes which lane runs a ray and when, and which instructions
// compute each value, never what is computed.
//
// K7/K8 (timed by `kernel_steps.py bvh` against the first port's
// one-ray-a-thread stack walk and against a stack walk on this scheduler; PERF.md §6): the
// same scheduler as K5/K6 (one template, `walk`: dead rays packed away, K7
// on persistent warps refilled from the queue, K8 on the pack kernel's
// list, lanes from the batch), over the nodes by a stackless skip walk. A
// ray's walk is then (node, best) and nothing in local memory: on an H100
// 1-3% faster than the same scheduler's stack walk for K7 (no local-memory
// push and pop) and 1-5% for K8, with 58 registers against 60.
//
// Why the skip walk visits exactly the nodes of the stack walk, in order.
// The tree is in pre-order: subtree(i) is the node range [i, end(i)); an
// inner node's left child is i + 1 and its right child r(i) = end(i + 1);
// a right child's subtree ends where its parent's does. skip(i) = end(i):
// `bvh_build.compute_skip` gives the root N, a left child its parent's
// right child, a right child its parent's skip. A leaf's subtree is itself,
// so its skip is i + 1. The stack walk, at a hit inner node i, pushes r(i)
// and goes to i + 1; at a leaf or a missed node it pops, or ends on an
// empty stack. Claim: standing at node i, its stack holds r(a) for each
// ancestor a of i whose left subtree holds i, the deepest on top, and
// nothing else. It holds at the root (empty). A push at i keeps it for
// i + 1: i joins as the deepest such ancestor, and the others' left
// subtrees hold i + 1 as they hold i. A pop goes to r(a) for the deepest
// such a and removes it: the ancestors of r(a) whose left subtree holds it
// are those above a whose left subtree holds a, which are the ones left.
// So a pop from i goes to r(a) = end(a + 1) for the deepest ancestor a
// whose left subtree holds i. The path from a + 1 down to i runs through
// right children only (a deeper ancestor with i on its left would be
// deeper than a), so end(i) = end(a + 1) = r(a) = skip(i); and with no
// such ancestor the path from the root runs through right children only,
// end(i) = N, and the stack is empty. The stack walk's moves are the skip
// walk's moves, step for step: the same nodes in the same order, with the
// same box test at each (its cap depends on the triangles tested before,
// which are the same) and the same triangles in the same order. Neither a
// depth nor a stack bounds the skip walk. `tests/test_torch_bvh_lanes.py`
// checks this on seeded trees and the comb, against a stack walk kept in
// the test.
//
// Numerics: the expressions of `pallas_trace._tri_hit` and the slab of
// `_fat_step` / `_kernel_bvh`, in the same order, built with -fmad=false and
// without --use_fast_math, so each rounds as the plain PyTorch version
// (etx_tracer_tpu_torch/ops/bvh_trace.py) evaluates it; the two agree bit
// for bit.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;     // threads a block of K5-K8
constexpr int kWarps = kThreads / 32;
constexpr int kPackThreads = 256;  // K6's and K8's pack kernel
constexpr int kRefillMin = 8;     // K5/K7 refill their lanes once this many are idle
constexpr int kStepsPerVote = 8;  // ... and step a ray up to this often between votes
constexpr int kStackDepth = 64;   // ops/bvh_build.py STACK_DEPTH
constexpr float kMtEps = 1e-9f;
constexpr float kBig = 3e38f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;

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

__device__ __forceinline__ float safe_inv(float x) {
  return 1.0f / (fabsf(x) < 1e-20f ? (x < 0.0f ? -1e-20f : 1e-20f) : x);
}

__device__ __forceinline__ Ray load_ray(const Rays& rs, int i) {
  Ray r;
  const long long io = (long long)i * rs.o_ray, id = (long long)i * rs.d_ray;
  r.ox = rs.o[io]; r.oy = rs.o[io + rs.o_comp]; r.oz = rs.o[io + 2 * rs.o_comp];
  r.dx = rs.d[id]; r.dy = rs.d[id + rs.d_comp]; r.dz = rs.d[id + 2 * rs.d_comp];
  r.ivx = safe_inv(r.dx); r.ivy = safe_inv(r.dy); r.ivz = safe_inv(r.dz);
  r.parx = fabsf(r.dx) < 1e-12f;
  r.pary = fabsf(r.dy) < 1e-12f;
  r.parz = fabsf(r.dz) < 1e-12f;
  r.tmin = rs.t_min[i];
  r.tmax = rs.t_max[i];
  return r;
}

// One axis of the slab test; an axis the ray runs parallel to (|d| < 1e-12)
// is all or nothing by whether the origin lies in the slab. kPar = false
// leaves that override out, for rays with no parallel axis.
template <bool kPar>
__device__ __forceinline__ void slab(bool par, float o, float iv, float mn, float mx,
                                     float& lo, float& hi) {
  const float t0 = (mn - o) * iv;
  const float t1 = (mx - o) * iv;
  lo = fminf(t0, t1);
  hi = fmaxf(t0, t1);
  if (kPar && par) {
    const bool inside = o >= mn && o <= mx;
    lo = inside ? -kBig : kBig;
    hi = inside ? kBig : -kBig;
  }
}

// Conservative slab test of the box [mn, mx] over [t_min, cap].
template <bool kPar>
__device__ __forceinline__ bool box_hit(const Ray& r, float mnx, float mny, float mnz,
                                        float mxx, float mxy, float mxz, float cap) {
  float lx, hx, ly, hy, lz, hz;
  slab<kPar>(r.parx, r.ox, r.ivx, mnx, mxx, lx, hx);
  slab<kPar>(r.pary, r.oy, r.ivy, mny, mxy, ly, hy);
  slab<kPar>(r.parz, r.oz, r.ivz, mnz, mxz, lz, hz);
  const float t_near = fmaxf(fmaxf(lx, fmaxf(ly, lz)), r.tmin);
  const float t_far = fminf(fminf(hx, fminf(hy, hz)), cap);
  return t_near <= t_far * 1.0000002f + 1e-7f;
}

__device__ __forceinline__ float bits(int x) { return __int_as_float(x); }

// Möller-Trumbore against triangle row `j` (v0, e1, e2, original id as int
// bits, 2 pad words). The closest hit keeps a valid t < best_t; the any hit
// returns true for a valid one.
template <bool kAnyHit>
__device__ __forceinline__ bool tri_test(const Ray& r, const float4* __restrict__ tris,
                                         const unsigned char* __restrict__ mask, int j,
                                         Best& b) {
  const float4* row = tris + 3 * (long long)j;
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
  if (ok && !kAnyHit) {
    b.t = t;
    b.tri = id;
    b.u = u;
    b.v = v;
  }
  return ok;
}

// The `count` triangle rows from `first` on, in order; the any hit returns
// true at the first valid one.
template <bool kAnyHit>
__device__ __forceinline__ bool test_leaf(const Ray& r, const float4* __restrict__ tris,
                                          const unsigned char* __restrict__ mask, int first,
                                          int count, Best& b) {
  for (int k = 0; k < count; ++k) {
    if (tri_test<kAnyHit>(r, tris, mask, first + k, b) && kAnyHit) return true;
  }
  return false;
}

template <bool kAnyHit>
__device__ __forceinline__ void write_out(const Out& out, int i, const Best& b, bool occluded) {
  if (kAnyHit) {
    out.occ[i] = occluded ? 1 : 0;
  } else {
    out.t[i] = b.t;
    out.tri[i] = b.tri;
    out.u[i] = b.u;
    out.v[i] = b.v;
  }
}

// ------------------------------------------------------------------ K5-K8

// The tree a walk reads: the fat rows (4 int4 a row) or the plain nodes (2
// int4 a node), their number (read by the node walk, which ends past the
// last node), and the triangle rows and mask.
struct Tree {
  const int4* rows;
  int num_rows;
  const float4* tris;
  const unsigned char* mask;
};

// A ray's walk: the row (fat row or node) to test next and, in K5/K6, the
// stack pointer.
struct Walk {
  int row, sp;
};

// One fat row of a ray's walk: the box tests of both children against
// cap, then the hit leaves' triangles in one loop (the left leaf's first),
// then the move: down to a hit left inner child (pushing a hit right inner
// child), or to a hit right inner child, or a pop. Returns true when the
// ray has finished (an any hit found, or nothing left to pop).
template <bool kAnyHit, bool kPar>
__device__ __forceinline__ bool fat_step(const Tree& tree, const Ray& r, Best& b,
                                         bool& occluded, Walk& w, int* stack) {
  const int4* p = tree.rows + 4 * (long long)w.row;
  const int4 q0 = __ldg(p);
  const int4 q1 = __ldg(p + 1);
  const int4 q2 = __ldg(p + 2);
  const int4 q3 = __ldg(p + 3);
  const float cap = kAnyHit ? r.tmax : fminf(r.tmax, b.t);
  const bool hit_l = box_hit<kPar>(r, bits(q0.x), bits(q0.y), bits(q0.z),
                                   bits(q0.w), bits(q1.x), bits(q1.y), cap);
  const bool hit_r = box_hit<kPar>(r, bits(q1.z), bits(q1.w), bits(q2.x),
                                   bits(q2.y), bits(q2.z), bits(q2.w), cap);
  const int count_l = q3.z >> 5;
  const int count_r = q3.z & 31;
  // an inner child's count is 0
  const int n_l = hit_l ? count_l : 0;
  const int n = n_l + (hit_r ? count_r : 0);
  for (int k = 0; k < n; ++k) {
    const int j = k < n_l ? q3.x + k : q3.y + (k - n_l);
    if (tri_test<kAnyHit>(r, tree.tris, tree.mask, j, b) && kAnyHit) {
      occluded = true;
      return true;
    }
  }
  const bool down = hit_l && count_l == 0;
  const bool go_r = hit_r && count_r == 0;
  if (down) {
    // the tree's depth is checked against kStackDepth when it is frozen
    if (go_r && w.sp < kStackDepth) stack[w.sp++] = q3.y;
    w.row = q3.x;
  } else if (go_r) {
    w.row = q3.y;
  } else if (w.sp > 0) {
    w.row = stack[--w.sp];
  } else {
    return true;
  }
  return false;
}

// One plain node of a ray's skip walk (K7/K8): the box test against cap, a
// hit leaf's triangles (word 6 is its first triangle row, word 7 its
// count), then the next node: node + 1 after a hit inner node and after any
// leaf, the skip (word 6 of an inner node) after a missed inner node. The
// stack goes unused. Returns true when the ray has finished (an any hit
// found, or the walk has passed the last node).
template <bool kAnyHit, bool kPar>
__device__ __forceinline__ bool node_step(const Tree& tree, const Ray& r, Best& b,
                                          bool& occluded, Walk& w, int* stack) {
  const int4* p = tree.rows + 2 * (long long)w.row;
  const int4 q0 = __ldg(p);
  const int4 q1 = __ldg(p + 1);
  const float cap = kAnyHit ? r.tmax : fminf(r.tmax, b.t);
  const bool hit = box_hit<kPar>(r, bits(q0.x), bits(q0.y), bits(q0.z),
                                 bits(q0.w), bits(q1.x), bits(q1.y), cap);
  const int count = q1.w;
  if (hit && count > 0 && test_leaf<kAnyHit>(r, tree.tris, tree.mask, q1.z, count, b)) {
    occluded = true;
    return true;
  }
  w.row = hit || count > 0 ? w.row + 1 : q1.z;
  return w.row >= tree.num_rows;
}

template <bool kAnyHit, bool kFat, bool kPar>
__device__ __forceinline__ bool step(const Tree& tree, const Ray& r, Best& b, bool& occluded,
                                     Walk& w, int* stack) {
  return kFat ? fat_step<kAnyHit, kPar>(tree, r, b, occluded, w, stack)
              : node_step<kAnyHit, kPar>(tree, r, b, occluded, w, stack);
}

// Lanes a warp keeps busy when `live` rays are shared by `warps` warps: as
// many as spread the live rays over every warp, at most 32. A small batch
// then runs a few rays a warp, whose long walks diverge less.
__device__ __forceinline__ int lanes_for(long long live, int warps) {
  const long long per = (live + warps - 1) / warps;
  return per < 1 ? 1 : (per > 32 ? 32 : (int)per);
}

// The first kernel of K6 and K8: the miss (occ = 0) for each ray whose
// interval is empty (!(t_min <= t_max), NaN included: no t lies in it, so
// no triangle is valid), and the live rays' indices appended to list =
// scratch + 2, one atomicAdd on the count scratch[0] a block.
__device__ __forceinline__ void pack(const Rays& rs, const Out& out, int* __restrict__ scratch) {
  __shared__ int warp_at[kPackThreads / 32];
  __shared__ int block_at;
  const int i = blockIdx.x * kPackThreads + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  bool live = false;
  if (i < rs.n) {
    live = rs.t_min[i] <= rs.t_max[i];
    if (!live) write_out<true>(out, i, Best{INFINITY, -1, 0.0f, 0.0f}, false);
  }
  const unsigned m = __ballot_sync(kFull, live);
  if (lane == 0) warp_at[warp] = __popc(m);
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int k = 0; k < kPackThreads / 32; ++k) {
      const int c = warp_at[k];
      warp_at[k] = total;
      total += c;
    }
    block_at = total > 0 ? atomicAdd(scratch, total) : 0;
  }
  __syncthreads();
  if (live) scratch[2 + block_at + warp_at[warp] + __popc(m & ((1u << lane) - 1u))] = i;
}

// The walk of K5-K8, one scheduler for both row forms (kFat); the live rays
// are spread over `warps` warps (the grid that stays resident, or fewer
// for a small batch). The any hits (K6, K8): the a-th active lane (`target`
// a warp) walks ray a of the list that the pack kernel wrote, and the grid
// has a block for every 128 rays, which the hardware hands to the SMs as
// blocks finish. The closest hits (K5, K7): persistent warps take `want`
// rays at a time from the queue scratch[1] (all rays: each dead one gets
// its miss there), hand the live ones to their idle lanes, and refill once
// kRefillMin lanes are idle; a lane steps its ray up to kStepsPerVote times
// between two votes of its warp.
template <bool kAnyHit, bool kFat>
__device__ __forceinline__ void walk(const Tree& tree, const Rays& rs, const Out& out,
                                     int* __restrict__ scratch, int warps) {
  __shared__ int s_hand[kWarps][32];
  // K5/K6's stack; the node walk (no stack) leaves it unused, and the
  // compiler drops it
  int stack[kStackDepth];
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int warp_id = blockIdx.x * kWarps + (threadIdx.x >> 5);

  if (kAnyHit) {
    const int n = *(volatile int*)scratch;
    const int target = lanes_for(n, warps);
    const int j = warp_id * target + lane;
    if (lane >= target || j >= n) return;
    const int i = scratch[2 + j];
    const Ray r = load_ray(rs, i);
    Best b{INFINITY, -1, 0.0f, 0.0f};
    bool occluded = false;
    Walk w{0, 0};
    const bool par = r.parx || r.pary || r.parz;
    while (!(par ? step<kAnyHit, kFat, true>(tree, r, b, occluded, w, stack)
                 : step<kAnyHit, kFat, false>(tree, r, b, occluded, w, stack))) {
    }
    write_out<kAnyHit>(out, i, b, occluded);
    return;
  }

  int* hand = s_hand[threadIdx.x >> 5];
  // warp-uniform: the lanes to keep busy (from the batch, then from the live
  // share of the rays this warp has taken), whether the queue is empty
  int target = lanes_for(rs.n, warps);
  int seen = 0, alive = 0;
  bool drained = false;
  // this lane's ray (-1: idle) and its walk
  int cur = -1;
  Ray r{};
  bool any_par = false, occluded = false;
  Best b{INFINITY, -1, 0.0f, 0.0f};
  Walk w{};
  for (;;) {
    const unsigned busy = __ballot_sync(kFull, cur >= 0);
    const int want = target - __popc(busy);
    if (!drained && want > 0 && (busy == 0 || want >= kRefillMin)) {
      // take `want` rays at a time from the queue; each dead one gets its
      // miss, the live ones go to the idle lanes in order
      const unsigned idle = ~busy;
      int filled = 0;
      while (filled < want && !drained) {
        const int take = want - filled;
        int base = 0;
        if (lane == 0) base = atomicAdd(scratch + 1, take);
        base = __shfl_sync(kFull, base, 0);
        drained = base + take >= rs.n;
        const int i = base + lane;
        bool live = false;
        if (lane < take && i < rs.n) {
          // an empty interval (NaN included) has no valid triangle
          live = rs.t_min[i] <= rs.t_max[i];
          if (!live) write_out<kAnyHit>(out, i, Best{INFINITY, -1, 0.0f, 0.0f}, false);
        }
        const unsigned m = __ballot_sync(kFull, live);
        if (live) hand[__popc(m & below)] = i;
        __syncwarp();
        const int q = __popc(idle & below) - filled;
        if (((idle >> lane) & 1u) && q >= 0 && q < __popc(m)) {
          cur = hand[q];
          r = load_ray(rs, cur);
          any_par = r.parx || r.pary || r.parz;
          b = Best{INFINITY, -1, 0.0f, 0.0f};
          occluded = false;
          w = Walk{0, 0};
        }
        filled += __popc(m);
        seen += max(0, min(take, rs.n - base));
        alive += __popc(m);
        __syncwarp();
      }
      if (seen > 0) target = lanes_for((long long)rs.n * alive / seen, warps);
    }
    if (__ballot_sync(kFull, cur >= 0) == 0) {
      if (drained) break;
      continue;
    }
    // the parallel-axis override only in a warp with such a ray
    const bool par = __any_sync(kFull, cur >= 0 && any_par);
    for (int k = 0; k < kStepsPerVote && cur >= 0; ++k) {
      const bool done = par ? step<kAnyHit, kFat, true>(tree, r, b, occluded, w, stack)
                            : step<kAnyHit, kFat, false>(tree, r, b, occluded, w, stack);
      if (done) {
        write_out<kAnyHit>(out, cur, b, occluded);
        cur = -1;
      }
    }
  }
}

// K5 (false) and K6 (true): the walk over the fat rows.
template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads)
bvh_fat_kernel(const Tree tree, const Rays rs, const Out out, int* __restrict__ scratch,
               int warps) {
  walk<kAnyHit, true>(tree, rs, out, scratch, warps);
}

// K7 (false) and K8 (true): the skip walk over the plain nodes.
template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads)
bvh_node_kernel(const Tree tree, const Rays rs, const Out out, int* __restrict__ scratch,
                int warps) {
  walk<kAnyHit, false>(tree, rs, out, scratch, warps);
}

__global__ void __launch_bounds__(kPackThreads)
bvh_fat_kernel_pack(const Rays rs, const Out out, int* __restrict__ scratch) {
  pack(rs, out, scratch);
}

__global__ void __launch_bounds__(kPackThreads)
bvh_node_kernel_pack(const Rays rs, const Out out, int* __restrict__ scratch) {
  pack(rs, out, scratch);
}

using WalkKernel = void (*)(Tree, Rays, Out, int*, int);

template <bool kAnyHit, bool kFat>
WalkKernel walk_kernel() {
  if (kFat) return bvh_fat_kernel<kAnyHit>;
  return bvh_node_kernel<kAnyHit>;
}

// Blocks of one of K5-K8's walks that the current device holds at once
// (per SM, and on all SMs), from the occupancy calculator, cached per
// device.
template <bool kAnyHit, bool kFat>
cudaError_t resident(int* per_sm, int* total) {
  static int cache_sm[kMaxDevices], cache_total[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && cache_total[dev] > 0) {
    *per_sm = cache_sm[dev];
    *total = cache_total[dev];
    return cudaSuccess;
  }
  int sms = 0, blocks = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, walk_kernel<kAnyHit, kFat>(),
                                                    kThreads, 0);
  if (e != cudaSuccess) return e;
  if (blocks < 1) return cudaErrorInvalidConfiguration;
  *per_sm = blocks;
  *total = blocks * sms;
  if (dev < kMaxDevices) {
    cache_sm[dev] = blocks;
    cache_total[dev] = blocks * sms;
  }
  return cudaSuccess;
}

template <bool kAnyHit, bool kFat>
int launch(const Tree& tree, const Rays& rs, const Out& out, int* scratch, void* stream) {
  if (rs.n <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  // blocks enough for every ray at once (at least one ray a warp), at most
  // the blocks that stay resident
  const int tiles = (rs.n + kWarps - 1) / kWarps;
  int per_sm = 0, all = 0;
  cudaError_t e = resident<kAnyHit, kFat>(&per_sm, &all);
  if (e != cudaSuccess) return (int)e;
  const int grid = all < tiles ? all : tiles;
  // the live count and the queue start at 0
  e = cudaMemsetAsync(scratch, 0, 2 * sizeof(int), st);
  if (e != cudaSuccess) return (int)e;
  const int pack_blocks = (rs.n + kPackThreads - 1) / kPackThreads;
  if (kAnyHit && kFat) {
    bvh_fat_kernel_pack<<<pack_blocks, kPackThreads, 0, st>>>(rs, out, scratch);
  } else if (kAnyHit) {
    bvh_node_kernel_pack<<<pack_blocks, kPackThreads, 0, st>>>(rs, out, scratch);
  }
  // the any hits: one ray a lane, so a block for every kThreads rays (at
  // least the resident grid, whose warps `lanes_for` spreads the rays over)
  const int wave = (rs.n + kThreads - 1) / kThreads;
  const int blocks = kAnyHit && wave > grid ? wave : grid;
  if (kFat) {
    bvh_fat_kernel<kAnyHit><<<blocks, kThreads, 0, st>>>(tree, rs, out, scratch, grid * kWarps);
  } else {
    bvh_node_kernel<kAnyHit><<<blocks, kThreads, 0, st>>>(tree, rs, out, scratch, grid * kWarps);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Every entry: `table` is the fat table (Ni, 16) int32 or the node table
// (N, 8) int32 (its row count `num_nodes` comes with it), `tris` the
// (T, 12) float32 triangle rows in leaf order, `mask` a (T,) byte per
// original triangle id or null. Ray component c of ray i is at
// o[i * o_ray + c * o_comp] (likewise d). `scratch` is num_r + 2 ints of
// device memory (the live count, the queue, the list of live rays), whose
// first two the entry resets on `stream`. Launches on `stream` without
// synchronising; returns cudaGetLastError() (or the error of a call before
// the launches).
int etx_bvh_intersect_fat(const int* table, const float* tris, const unsigned char* mask,
                          const float* o, int o_ray, int o_comp,
                          const float* d, int d_ray, int d_comp,
                          const float* t_min, const float* t_max, int num_r,
                          float* t_out, int* tri_out, float* u_out, float* v_out,
                          int* scratch, void* stream) {
  return launch<false, true>(Tree{(const int4*)table, 0, (const float4*)tris, mask},
                             Rays{o, o_ray, o_comp, d, d_ray, d_comp, t_min, t_max, num_r},
                             Out{t_out, tri_out, u_out, v_out, nullptr}, scratch, stream);
}

int etx_bvh_occluded_fat(const int* table, const float* tris, const unsigned char* mask,
                         const float* o, int o_ray, int o_comp,
                         const float* d, int d_ray, int d_comp,
                         const float* t_min, const float* t_max, int num_r,
                         unsigned char* occ_out, int* scratch, void* stream) {
  return launch<true, true>(Tree{(const int4*)table, 0, (const float4*)tris, mask},
                            Rays{o, o_ray, o_comp, d, d_ray, d_comp, t_min, t_max, num_r},
                            Out{nullptr, nullptr, nullptr, nullptr, occ_out}, scratch, stream);
}

int etx_bvh_intersect_node(const int* table, int num_nodes, const float* tris,
                           const unsigned char* mask,
                           const float* o, int o_ray, int o_comp,
                           const float* d, int d_ray, int d_comp,
                           const float* t_min, const float* t_max, int num_r,
                           float* t_out, int* tri_out, float* u_out, float* v_out,
                           int* scratch, void* stream) {
  return launch<false, false>(Tree{(const int4*)table, num_nodes, (const float4*)tris, mask},
                              Rays{o, o_ray, o_comp, d, d_ray, d_comp, t_min, t_max, num_r},
                              Out{t_out, tri_out, u_out, v_out, nullptr}, scratch, stream);
}

int etx_bvh_occluded_node(const int* table, int num_nodes, const float* tris,
                          const unsigned char* mask,
                          const float* o, int o_ray, int o_comp,
                          const float* d, int d_ray, int d_comp,
                          const float* t_min, const float* t_max, int num_r,
                          unsigned char* occ_out, int* scratch, void* stream) {
  return launch<true, false>(Tree{(const int4*)table, num_nodes, (const float4*)tris, mask},
                             Rays{o, o_ray, o_comp, d, d_ray, d_comp, t_min, t_max, num_r},
                             Out{nullptr, nullptr, nullptr, nullptr, occ_out}, scratch, stream);
}

// K5 (any_hit 0) or K6 (1): blocks one SM of the current device holds at
// once, and threads per block.
int etx_bvh_fat_occupancy(int any_hit, int* blocks_per_sm, int* threads_per_block) {
  int total = 0;
  const cudaError_t e = any_hit ? resident<true, true>(blocks_per_sm, &total)
                                : resident<false, true>(blocks_per_sm, &total);
  *threads_per_block = kThreads;
  return (int)e;
}

// The same for K7 (any_hit 0) or K8 (1).
int etx_bvh_node_occupancy(int any_hit, int* blocks_per_sm, int* threads_per_block) {
  int total = 0;
  const cudaError_t e = any_hit ? resident<true, false>(blocks_per_sm, &total)
                                : resident<false, false>(blocks_per_sm, &total);
  *threads_per_block = kThreads;
  return (int)e;
}

const char* etx_bvh_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
