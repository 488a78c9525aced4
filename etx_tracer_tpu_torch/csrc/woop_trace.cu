// Woop unit-triangle ray/triangle intersection for any triangle count:
// closest hit (K9a) and any hit (K9b), for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels of etx_tracer_tpu/ops/pallas_trace.py:
//   K9a intersect_woop_pallas (`_kernel_woop`)        -> woop_kernel<false>
//   K9b occluded_woop_pallas  (`_kernel_woop_anyhit`) -> woop_kernel<true>
// Both compute the outputs of the TPU kernels, not their layout. The TPU
// versions multiply a (256 rays, 8) block by an (8, 6 x 512) table chunk on
// the matrix unit, in emulated FP32, and run the validity tests on the
// vector unit. Here one thread owns one ray and walks a (T, 12) table of
// per-triangle rows [r_u b_u r_v b_v r_w b_w] (built by
// ops/woop_trace.py:woop_tables) in chunks of 512 rows (24 KB) that the
// block stages in shared memory with 16-byte copies; every thread of a warp
// reads a row at the same address (a broadcast), as three float4 loads.
// The six dot products of a pair are plain FP32 multiplies and adds in the
// thread: no cuBLAS, no tensor cores.
//
// What bounds it: arithmetic. A pair costs 39 FP32 operations (18 for
// w = A o + b, 15 for q = A d, one division, four for u and v, one for
// u + v) and six compares; a ray moves 32 bytes in and 1 (K9b) or 16 (K9a)
// out, a triangle 48 bytes. At 996 triangles the operations outweigh the
// bytes by more than 100x at the card's FP32 and HBM peaks. This first
// design is simple on purpose: one ray per thread, no ray sorting, no
// early culling beyond K9b's exit once every ray of a block is occluded.
//
// Numerics: built with -fmad=false and without --use_fast_math, so each
// product and sum rounds on its own, in the order the plain PyTorch version
// (ops/woop_trace.py:_pairs) evaluates it; given the same table the two
// agree bit for bit.
//
// Semantics (both kernels): w_k = r_k . o + b_k and q_k = r_k . d, summed
// x, y, z, then the bias; a pair is valid when |q_z| > 1e-7 and, with
// t = -w_z / q_z, u = w_x + t q_x, v = w_y + t q_y: u >= 0, v >= 0,
// u + v <= 1, t_min <= t <= t_max. Masked and degenerate triangles have
// all-zero rows (q_z == 0, never valid). K9a tests the triangles in index
// order and takes a hit only when t < best_t, so the lowest triangle index
// wins a tie, and writes t (+inf on a miss), tri (-1), u, v (0). K9b writes
// one byte per ray and stops at the first valid pair.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kChunk = 512;   // triangles staged per pass
constexpr int kThreads = 256;
constexpr float kQzEps = 1e-7f;

template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads)
woop_kernel(const float4* __restrict__ tab, int num_t,
            const float* __restrict__ o, int o_ray, int o_comp,
            const float* __restrict__ d, int d_ray, int d_comp,
            const float* __restrict__ t_min, const float* __restrict__ t_max,
            int num_r,
            float* __restrict__ t_out, int* __restrict__ tri_out,
            float* __restrict__ u_out, float* __restrict__ v_out,
            unsigned char* __restrict__ occ_out) {
  __shared__ float4 rows[kChunk * 3];

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = i < num_r;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
  float tmin = 0.0f, tmax = -1.0f;
  if (active) {
    const long long io = (long long)i * o_ray, id = (long long)i * d_ray;
    ox = o[io]; oy = o[io + o_comp]; oz = o[io + 2 * o_comp];
    dx = d[id]; dy = d[id + d_comp]; dz = d[id + 2 * d_comp];
    tmin = t_min[i];
    tmax = t_max[i];
  }

  float best_t = INFINITY;
  int best_tri = -1;
  float best_u = 0.0f, best_v = 0.0f;
  bool occluded = false;

  for (int s = 0; s < num_t; s += kChunk) {
    // the barrier also keeps the previous chunk until every thread is done
    if (kAnyHit) {
      if (__syncthreads_and(occluded || !active)) break;
    } else {
      __syncthreads();
    }
    const int n = min(kChunk, num_t - s);
    const float4* src = tab + 3LL * s;
    for (int j = threadIdx.x; j < 3 * n; j += blockDim.x) rows[j] = src[j];
    __syncthreads();
    if (!active || occluded) continue;

    for (int k = 0; k < n; ++k) {
      const float4 a = rows[3 * k];      // r_u, b_u
      const float4 b = rows[3 * k + 1];  // r_v, b_v
      const float4 c = rows[3 * k + 2];  // r_w, b_w
      const float qz = c.x * dx + c.y * dy + c.z * dz;
      if (!(fabsf(qz) > kQzEps)) continue;
      const float wx = a.x * ox + a.y * oy + a.z * oz + a.w;
      const float wy = b.x * ox + b.y * oy + b.z * oz + b.w;
      const float wz = c.x * ox + c.y * oy + c.z * oz + c.w;
      const float qx = a.x * dx + a.y * dy + a.z * dz;
      const float qy = b.x * dx + b.y * dy + b.z * dz;
      const float t = -wz / qz;
      const float u = wx + t * qx;
      const float v = wy + t * qy;
      const bool ok = u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t >= tmin && t <= tmax;
      if (kAnyHit) {
        if (ok) {
          occluded = true;
          break;
        }
      } else if (ok && t < best_t) {
        best_t = t;
        best_tri = s + k;
        best_u = u;
        best_v = v;
      }
    }
  }

  if (!active) return;
  if (kAnyHit) {
    occ_out[i] = occluded ? 1 : 0;
  } else {
    t_out[i] = best_t;
    tri_out[i] = best_tri;
    u_out[i] = best_u;
    v_out[i] = best_v;
  }
}

inline int grid_for(int num_r) { return (num_r + kThreads - 1) / kThreads; }

inline bool bad_args(const float* tab, int num_t, int num_r) {
  return num_t < 0 || num_r <= 0 || (reinterpret_cast<unsigned long long>(tab) & 15ULL) != 0;
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
  if (bad_args(tab, num_t, num_r)) return (int)cudaErrorInvalidValue;
  woop_kernel<false><<<grid_for(num_r), kThreads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(tab), num_t, o, o_ray, o_comp, d, d_ray, d_comp,
      t_min, t_max, num_r, t_out, tri_out, u_out, v_out, nullptr);
  return (int)cudaGetLastError();
}

// Any hit: occ_out[i] = 1 when ray i has a valid pair, else 0.
int etx_woop_occluded(const float* tab, int num_t,
                      const float* o, int o_ray, int o_comp,
                      const float* d, int d_ray, int d_comp,
                      const float* t_min, const float* t_max, int num_r,
                      unsigned char* occ_out, void* stream) {
  if (bad_args(tab, num_t, num_r)) return (int)cudaErrorInvalidValue;
  woop_kernel<true><<<grid_for(num_r), kThreads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(tab), num_t, o, o_ray, o_comp, d, d_ray, d_comp,
      t_min, t_max, num_r, nullptr, nullptr, nullptr, nullptr, occ_out);
  return (int)cudaGetLastError();
}

const char* etx_woop_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
