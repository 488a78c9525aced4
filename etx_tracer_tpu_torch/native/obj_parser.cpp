// Native OBJ geometry parser.
//
// Host-side replacement for the reference's tinyobj usage
// (scene_representation.cxx load_from_obj): parses v/vn/vt/f records with fan
// triangulation and per-face material ids at C++ speed for large meshes.
// Materials (usemtl names) are resolved by the Python side; this parser
// reports per-triangle material SLOT indices in order of first use.

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct ParseState {
  std::vector<float> positions;  // x y z
  std::vector<float> normals;
  std::vector<float> uvs;
  // per-corner resolved indices (3 per triangle)
  std::vector<int32_t> pos_idx, nrm_idx, uv_idx;
  std::vector<int32_t> tri_mtl;
  std::vector<std::string> mtl_names;
  std::unordered_map<std::string, int32_t> mtl_map;
  std::string mtllib;
};

ParseState* g_state = nullptr;

inline const char* skip_ws(const char* p) {
  while (*p == ' ' || *p == '\t')
    ++p;
  return p;
}

inline int32_t fix_index(long v, size_t count) {
  if (v > 0)
    return (int32_t)(v - 1);
  if (v < 0)
    return (int32_t)((long)count + v);
  return -1;
}

}  // namespace

extern "C" {

// Parses the file; returns 0 on success. Sizes are then queried and data
// copied out by the etx_obj_* accessors below.
int32_t etx_obj_parse(const char* path) {
  delete g_state;
  g_state = new ParseState();
  ParseState& st = *g_state;

  FILE* f = fopen(path, "rb");
  if (!f)
    return -1;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::string data(size_t(size), 0);
  size_t got = fread(data.data(), 1, size_t(size), f);
  fclose(f);
  if ((long)got != size)
    return -2;

  int32_t current_mtl = -1;
  const char* p = data.c_str();
  const char* end = p + data.size();

  std::vector<long> face_v, face_t, face_n;
  while (p < end) {
    const char* line_end = (const char*)memchr(p, '\n', size_t(end - p));
    if (!line_end)
      line_end = end;
    p = skip_ws(p);
    if (p[0] == 'v' && p[1] == ' ') {
      char* q = nullptr;
      float x = strtof(p + 2, &q);
      float y = strtof(q, &q);
      float z = strtof(q, &q);
      st.positions.insert(st.positions.end(), {x, y, z});
    } else if (p[0] == 'v' && p[1] == 'n' && p[2] == ' ') {
      char* q = nullptr;
      float x = strtof(p + 3, &q);
      float y = strtof(q, &q);
      float z = strtof(q, &q);
      st.normals.insert(st.normals.end(), {x, y, z});
    } else if (p[0] == 'v' && p[1] == 't' && p[2] == ' ') {
      char* q = nullptr;
      float u = strtof(p + 3, &q);
      float v = strtof(q, &q);
      st.uvs.insert(st.uvs.end(), {u, v});
    } else if (p[0] == 'f' && (p[1] == ' ' || p[1] == '\t')) {
      face_v.clear();
      face_t.clear();
      face_n.clear();
      const char* q = p + 1;
      while (q < line_end) {
        q = skip_ws(q);
        if (q >= line_end || *q == '\r' || *q == '\n' || *q == '#')
          break;
        char* r = nullptr;
        long vi = strtol(q, &r, 10);
        long ti = 0, ni = 0;
        if (*r == '/') {
          ++r;
          if (*r != '/')
            ti = strtol(r, &r, 10);
          if (*r == '/') {
            ++r;
            ni = strtol(r, &r, 10);
          }
        }
        face_v.push_back(vi);
        face_t.push_back(ti);
        face_n.push_back(ni);
        q = r;
      }
      size_t nvert = face_v.size();
      size_t vcount = st.positions.size() / 3;
      size_t tcount = st.uvs.size() / 2;
      size_t ncount = st.normals.size() / 3;
      for (size_t k = 1; k + 1 < nvert; ++k) {
        size_t corners[3] = {0, k, k + 1};
        for (size_t c = 0; c < 3; ++c) {
          size_t i = corners[c];
          st.pos_idx.push_back(fix_index(face_v[i], vcount));
          st.uv_idx.push_back(face_t[i] ? fix_index(face_t[i], tcount) : -1);
          st.nrm_idx.push_back(face_n[i] ? fix_index(face_n[i], ncount) : -1);
        }
        st.tri_mtl.push_back(current_mtl);
      }
    } else if (strncmp(p, "usemtl", 6) == 0) {
      std::string name(skip_ws(p + 6), size_t(line_end - skip_ws(p + 6)));
      while (!name.empty() && (name.back() == '\r' || name.back() == ' '))
        name.pop_back();
      auto it = st.mtl_map.find(name);
      if (it == st.mtl_map.end()) {
        current_mtl = (int32_t)st.mtl_names.size();
        st.mtl_map[name] = current_mtl;
        st.mtl_names.push_back(name);
      } else {
        current_mtl = it->second;
      }
    } else if (strncmp(p, "mtllib", 6) == 0) {
      std::string name(skip_ws(p + 6), size_t(line_end - skip_ws(p + 6)));
      while (!name.empty() && (name.back() == '\r' || name.back() == ' '))
        name.pop_back();
      st.mtllib = name;
    }
    p = line_end + 1;
  }
  return 0;
}

int32_t etx_obj_counts(int32_t* num_pos, int32_t* num_nrm, int32_t* num_uv,
                       int32_t* num_tris, int32_t* num_mtls) {
  if (!g_state)
    return -1;
  *num_pos = (int32_t)(g_state->positions.size() / 3);
  *num_nrm = (int32_t)(g_state->normals.size() / 3);
  *num_uv = (int32_t)(g_state->uvs.size() / 2);
  *num_tris = (int32_t)(g_state->tri_mtl.size());
  *num_mtls = (int32_t)(g_state->mtl_names.size());
  return 0;
}

int32_t etx_obj_data(float* positions, float* normals, float* uvs,
                     int32_t* pos_idx, int32_t* nrm_idx, int32_t* uv_idx,
                     int32_t* tri_mtl) {
  if (!g_state)
    return -1;
  ParseState& st = *g_state;
  memcpy(positions, st.positions.data(), st.positions.size() * sizeof(float));
  memcpy(normals, st.normals.data(), st.normals.size() * sizeof(float));
  memcpy(uvs, st.uvs.data(), st.uvs.size() * sizeof(float));
  memcpy(pos_idx, st.pos_idx.data(), st.pos_idx.size() * sizeof(int32_t));
  memcpy(nrm_idx, st.nrm_idx.data(), st.nrm_idx.size() * sizeof(int32_t));
  memcpy(uv_idx, st.uv_idx.data(), st.uv_idx.size() * sizeof(int32_t));
  memcpy(tri_mtl, st.tri_mtl.data(), st.tri_mtl.size() * sizeof(int32_t));
  return 0;
}

int32_t etx_obj_material_name(int32_t index, char* out, int32_t cap) {
  if (!g_state || index < 0 || index >= (int32_t)g_state->mtl_names.size())
    return -1;
  snprintf(out, size_t(cap), "%s", g_state->mtl_names[size_t(index)].c_str());
  return 0;
}

int32_t etx_obj_mtllib(char* out, int32_t cap) {
  if (!g_state)
    return -1;
  snprintf(out, size_t(cap), "%s", g_state->mtllib.c_str());
  return 0;
}

void etx_obj_free() {
  delete g_state;
  g_state = nullptr;
}
}
