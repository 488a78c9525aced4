// Pair-tile ray/triangle intersection for any triangle count: closest hit
// (K3) and any hit (K4), for NVIDIA Hopper (sm_90a). The trace dispatch
// sends 129 to 4096 triangles here (ops/trace.py); the kernels, like the
// TPU kernels they replace, take any count.
//
// Replaces the TPU kernels of etx_tracer_tpu/ops/pallas_trace.py:
//   K3 intersect_brute2_pallas (`_kernel_brute2`)        -> brute2_kernel<false>
//   K4 occluded_brute2_pallas  (`_kernel_brute2_anyhit`) -> brute2_kernel<true>
// Both compute the outputs of the TPU kernels, not their layout. The TPU
// versions hold the whole triangle table as a transposed (16, T) matrix in
// VMEM and evaluate (256 rays) x (512 triangles) pair tiles on the vector
// unit. Here one thread owns one ray and walks the table in chunks of 512
// triangles (9 floats each, 18 KB) that the block stages in shared memory:
// a larger table would not fit the 48 KB of static shared memory, and a
// chunk read by every thread of a warp at the same address is a broadcast.
//
// What bounds it: arithmetic. A ray-triangle pair costs 48 FP32 adds,
// subtracts and multiplies and 7 compares; a ray moves 32 bytes in and 1
// (K4) or 16 (K3) out. At 996 triangles the operations outweigh the bytes
// by more than 100x at the card's FP32 and HBM peaks. This first design is
// simple on purpose: one ray per thread, no ray sorting, no early culling
// beyond K4's exit once every ray of a block is occluded.
//
// Numerics: the same expressions as `_kernel_brute2`, in the same order,
// built with -fmad=false and without --use_fast_math, so each rounds as the
// plain PyTorch version (etx_tracer_tpu_torch/ops/brute2_trace.py)
// evaluates it; the two agree bit for bit.
//
// Semantics (both kernels): Möller-Trumbore validity tested without a
// division on sign-multiplied forms: with sgn = det >= 0 ? 1 : -1,
// dd = det * sgn, a = u * det * sgn, b = v * det * sgn, tt = t * det * sgn,
// a pair is valid when dd > 1e-9, a >= 0, b >= 0, a + b <= dd,
// tt >= t_min * dd and tt <= t_max * dd. A masked triangle is staged with
// zero edges (det == 0, never valid), as the TPU kernels fold the mask into
// the geometry. K3 takes t = tt / dd when t < best_t, so the lowest triangle
// index wins a tie, and divides u = a * (1 / dd), v = b * (1 / dd) once,
// for the winner; it writes t (+inf on a miss), tri (-1), u, v (0). K4
// writes one byte per ray and stops at the first valid pair.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kChunk = 512;    // triangles staged per pass
constexpr int kRowWidth = 9;   // v0(3) e1(3) e2(3)
constexpr int kThreads = 256;
constexpr float kMtEps = 1e-9f;

template <bool kAnyHit>
__global__ void __launch_bounds__(kThreads)
brute2_kernel(const float* __restrict__ v0, const float* __restrict__ e1,
              const float* __restrict__ e2, const unsigned char* __restrict__ mask,
              int num_t,
              const float* __restrict__ o, int o_ray, int o_comp,
              const float* __restrict__ d, int d_ray, int d_comp,
              const float* __restrict__ t_min, const float* __restrict__ t_max,
              int num_r,
              float* __restrict__ t_out, int* __restrict__ tri_out,
              float* __restrict__ u_out, float* __restrict__ v_out,
              unsigned char* __restrict__ occ_out) {
  __shared__ float tris[kChunk * kRowWidth];

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
  float best_a = 0.0f, best_b = 0.0f, best_dd = 0.0f;
  bool occluded = false;

  for (int s = 0; s < num_t; s += kChunk) {
    // the barrier also keeps the previous chunk until every thread is done
    if (kAnyHit) {
      if (__syncthreads_and(occluded || !active)) break;
    } else {
      __syncthreads();
    }
    const int n = min(kChunk, num_t - s);
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      const int g = s + j;
      const float m = (mask == nullptr || mask[g] != 0) ? 1.0f : 0.0f;
      float* row = tris + j * kRowWidth;
      row[0] = v0[3 * g]; row[1] = v0[3 * g + 1]; row[2] = v0[3 * g + 2];
      row[3] = e1[3 * g] * m; row[4] = e1[3 * g + 1] * m; row[5] = e1[3 * g + 2] * m;
      row[6] = e2[3 * g] * m; row[7] = e2[3 * g + 1] * m; row[8] = e2[3 * g + 2] * m;
    }
    __syncthreads();
    if (!active || occluded) continue;

    for (int k = 0; k < n; ++k) {
      const float* row = tris + k * kRowWidth;
      const float v0x = row[0], v0y = row[1], v0z = row[2];
      const float e1x = row[3], e1y = row[4], e1z = row[5];
      const float e2x = row[6], e2y = row[7], e2z = row[8];

      const float px = dy * e2z - dz * e2y;
      const float py = dz * e2x - dx * e2z;
      const float pz = dx * e2y - dy * e2x;
      const float det = px * e1x + py * e1y + pz * e1z;
      const float sgn = det >= 0.0f ? 1.0f : -1.0f;
      const float dd = det * sgn;
      const float tx = ox - v0x;
      const float ty = oy - v0y;
      const float tz = oz - v0z;
      const float a = (tx * px + ty * py + tz * pz) * sgn;
      const float qx = ty * e1z - tz * e1y;
      const float qy = tz * e1x - tx * e1z;
      const float qz = tx * e1y - ty * e1x;
      const float b = (dx * qx + dy * qy + dz * qz) * sgn;
      const float tt = (e2x * qx + e2y * qy + e2z * qz) * sgn;
      const bool ok = dd > kMtEps && a >= 0.0f && b >= 0.0f && a + b <= dd &&
                      tt >= tmin * dd && tt <= tmax * dd;
      if (kAnyHit) {
        if (ok) {
          occluded = true;
          break;
        }
      } else if (ok) {
        const float t = tt / dd;
        if (t < best_t) {
          best_t = t;
          best_tri = s + k;
          best_a = a;
          best_b = b;
          best_dd = dd;
        }
      }
    }
  }

  if (!active) return;
  if (kAnyHit) {
    occ_out[i] = occluded ? 1 : 0;
  } else {
    const float inv = 1.0f / (best_dd == 0.0f ? 1.0f : best_dd);
    t_out[i] = best_t;
    tri_out[i] = best_tri;
    u_out[i] = best_tri >= 0 ? best_a * inv : 0.0f;
    v_out[i] = best_tri >= 0 ? best_b * inv : 0.0f;
  }
}

inline int grid_for(int num_r) { return (num_r + kThreads - 1) / kThreads; }

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
  if (num_t < 0 || num_r <= 0) return (int)cudaErrorInvalidValue;
  brute2_kernel<false><<<grid_for(num_r), kThreads, 0, (cudaStream_t)stream>>>(
      v0, e1, e2, mask, num_t, o, o_ray, o_comp, d, d_ray, d_comp, t_min, t_max, num_r,
      t_out, tri_out, u_out, v_out, nullptr);
  return (int)cudaGetLastError();
}

// Any hit: occ_out[i] = 1 when ray i has a valid pair with an unmasked
// triangle, else 0.
int etx_brute2_occluded(const float* v0, const float* e1, const float* e2,
                        const unsigned char* mask, int num_t,
                        const float* o, int o_ray, int o_comp,
                        const float* d, int d_ray, int d_comp,
                        const float* t_min, const float* t_max, int num_r,
                        unsigned char* occ_out, void* stream) {
  if (num_t < 0 || num_r <= 0) return (int)cudaErrorInvalidValue;
  brute2_kernel<true><<<grid_for(num_r), kThreads, 0, (cudaStream_t)stream>>>(
      v0, e1, e2, mask, num_t, o, o_ray, o_comp, d, d_ray, d_comp, t_min, t_max, num_r,
      nullptr, nullptr, nullptr, nullptr, occ_out);
  return (int)cudaGetLastError();
}

const char* etx_brute2_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
