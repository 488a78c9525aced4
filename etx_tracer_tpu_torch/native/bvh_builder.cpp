// Native BVH builder: binned-SAH over triangle soups.
//
// The host-side counterpart of Embree's BVH build behind
// Raytracing::commit_changes (reference rt/rt.cxx:58-88): scene geometry is
// flattened into the depth-first 2-wide layout that ops/bvh_build.py turns
// into the BVH kernels' tables. Exposed via a plain C ABI and loaded with
// ctypes (native/__init__.py builds it with g++ at first use).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct float3 {
  float x, y, z;
};

inline float3 f3min(const float3& a, const float3& b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline float3 f3max(const float3& a, const float3& b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct Node {
  float3 bmin, bmax;
  int32_t left;   // inner: right-child index (left = self+1); leaf: first prim
  int32_t count;  // 0 for inner nodes
};

struct Builder {
  static constexpr int kBins = 16;
  static constexpr int kLeafSize = 4;
  static constexpr int kMaxDepth = 60;

  const float* v0;
  const float* e1;
  const float* e2;
  std::vector<float3> tri_min, tri_max, centroid;
  std::vector<Node> nodes;
  std::vector<int32_t> prims_out;

  static float area(const float3& mn, const float3& mx) {
    float dx = std::max(mx.x - mn.x, 0.f);
    float dy = std::max(mx.y - mn.y, 0.f);
    float dz = std::max(mx.z - mn.z, 0.f);
    return 2.f * (dx * dy + dy * dz + dz * dx);
  }

  int32_t build(std::vector<int32_t>& ids, int begin, int end, int depth) {
    int32_t ni = (int32_t)nodes.size();
    nodes.push_back({});
    float3 bmin = tri_min[ids[begin]];
    float3 bmax = tri_max[ids[begin]];
    float3 cmin = centroid[ids[begin]];
    float3 cmax = cmin;
    for (int i = begin + 1; i < end; ++i) {
      bmin = f3min(bmin, tri_min[ids[i]]);
      bmax = f3max(bmax, tri_max[ids[i]]);
      cmin = f3min(cmin, centroid[ids[i]]);
      cmax = f3max(cmax, centroid[ids[i]]);
    }
    nodes[ni].bmin = bmin;
    nodes[ni].bmax = bmax;

    int n = end - begin;
    if (n <= kLeafSize || depth >= kMaxDepth) {
      nodes[ni].left = (int32_t)prims_out.size();
      nodes[ni].count = n;
      for (int i = begin; i < end; ++i)
        prims_out.push_back(ids[i]);
      return ni;
    }

    float3 ext = {cmax.x - cmin.x, cmax.y - cmin.y, cmax.z - cmin.z};
    int axis = 0;
    if (ext.y > ext.x)
      axis = 1;
    if (ext.z > (axis == 0 ? ext.x : ext.y))
      axis = 2;
    float extent = axis == 0 ? ext.x : (axis == 1 ? ext.y : ext.z);
    float origin = axis == 0 ? cmin.x : (axis == 1 ? cmin.y : cmin.z);

    int mid = -1;
    if (extent > 1e-12f) {
      // binned SAH
      struct Bin {
        float3 mn{1e30f, 1e30f, 1e30f}, mx{-1e30f, -1e30f, -1e30f};
        int cnt = 0;
      } bins[kBins];
      auto bin_of = [&](int32_t t) {
        float c = axis == 0 ? centroid[t].x : (axis == 1 ? centroid[t].y : centroid[t].z);
        int b = (int)((c - origin) / extent * kBins);
        return std::min(std::max(b, 0), kBins - 1);
      };
      for (int i = begin; i < end; ++i) {
        int b = bin_of(ids[i]);
        bins[b].mn = f3min(bins[b].mn, tri_min[ids[i]]);
        bins[b].mx = f3max(bins[b].mx, tri_max[ids[i]]);
        bins[b].cnt++;
      }
      float best_cost = 1e30f;
      int best_split = -1;
      for (int s = 1; s < kBins; ++s) {
        float3 lmn{1e30f, 1e30f, 1e30f}, lmx{-1e30f, -1e30f, -1e30f};
        float3 rmn = lmn, rmx = lmx;
        int ln = 0, rn = 0;
        for (int b = 0; b < s; ++b)
          if (bins[b].cnt) {
            lmn = f3min(lmn, bins[b].mn);
            lmx = f3max(lmx, bins[b].mx);
            ln += bins[b].cnt;
          }
        for (int b = s; b < kBins; ++b)
          if (bins[b].cnt) {
            rmn = f3min(rmn, bins[b].mn);
            rmx = f3max(rmx, bins[b].mx);
            rn += bins[b].cnt;
          }
        if (ln == 0 || rn == 0)
          continue;
        float cost = area(lmn, lmx) * ln + area(rmn, rmx) * rn;
        if (cost < best_cost) {
          best_cost = cost;
          best_split = s;
        }
      }
      if (best_split > 0) {
        auto it = std::partition(ids.begin() + begin, ids.begin() + end,
                                 [&](int32_t t) { return bin_of(t) < best_split; });
        mid = (int)(it - ids.begin());
        if (mid == begin || mid == end)
          mid = -1;
      }
    }
    if (mid < 0) {  // median fallback
      mid = begin + n / 2;
      std::nth_element(ids.begin() + begin, ids.begin() + mid, ids.begin() + end,
                       [&](int32_t a, int32_t b) {
                         float ca = axis == 0 ? centroid[a].x : (axis == 1 ? centroid[a].y : centroid[a].z);
                         float cb = axis == 0 ? centroid[b].x : (axis == 1 ? centroid[b].y : centroid[b].z);
                         return ca < cb;
                       });
    }

    build(ids, begin, mid, depth + 1);
    int32_t ri = build(ids, mid, end, depth + 1);
    nodes[ni].left = ri;
    nodes[ni].count = 0;
    return ni;
  }
};

}  // namespace

extern "C" {

// Returns the number of nodes; fills caller-allocated output arrays.
// Query sizes first with bvh_build(…, nullptr, …) pattern is avoided by the
// worst-case bound: nodes <= 2*T, prims == T.
int32_t etx_bvh_build(const float* v0, const float* e1, const float* e2,
                      int32_t num_tris,
                      float* node_min, float* node_max,
                      int32_t* node_left, int32_t* node_count,
                      int32_t* prim_index) {
  Builder b;
  b.v0 = v0;
  b.e1 = e1;
  b.e2 = e2;
  b.tri_min.resize(num_tris);
  b.tri_max.resize(num_tris);
  b.centroid.resize(num_tris);
  for (int32_t i = 0; i < num_tris; ++i) {
    float3 a{v0[3 * i], v0[3 * i + 1], v0[3 * i + 2]};
    float3 p1{a.x + e1[3 * i], a.y + e1[3 * i + 1], a.z + e1[3 * i + 2]};
    float3 p2{a.x + e2[3 * i], a.y + e2[3 * i + 1], a.z + e2[3 * i + 2]};
    b.tri_min[i] = f3min(a, f3min(p1, p2));
    b.tri_max[i] = f3max(a, f3max(p1, p2));
    b.centroid[i] = {0.5f * (b.tri_min[i].x + b.tri_max[i].x),
                     0.5f * (b.tri_min[i].y + b.tri_max[i].y),
                     0.5f * (b.tri_min[i].z + b.tri_max[i].z)};
  }
  b.nodes.reserve(2 * num_tris);
  b.prims_out.reserve(num_tris);
  std::vector<int32_t> ids(num_tris);
  for (int32_t i = 0; i < num_tris; ++i)
    ids[i] = i;
  if (num_tris > 0)
    b.build(ids, 0, num_tris, 0);
  else
    b.nodes.push_back({{0, 0, 0}, {-1, -1, -1}, 0, 0});

  int32_t nn = (int32_t)b.nodes.size();
  for (int32_t i = 0; i < nn; ++i) {
    node_min[3 * i] = b.nodes[i].bmin.x;
    node_min[3 * i + 1] = b.nodes[i].bmin.y;
    node_min[3 * i + 2] = b.nodes[i].bmin.z;
    node_max[3 * i] = b.nodes[i].bmax.x;
    node_max[3 * i + 1] = b.nodes[i].bmax.y;
    node_max[3 * i + 2] = b.nodes[i].bmax.z;
    node_left[i] = b.nodes[i].left;
    node_count[i] = b.nodes[i].count;
  }
  for (size_t i = 0; i < b.prims_out.size(); ++i)
    prim_index[i] = b.prims_out[i];
  return nn;
}
}
