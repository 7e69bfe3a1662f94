// Native host runtime for vct_tpu_torch: OBJ geometry parsing and
// stratified surface-sample generation (a copy of vct_tpu/native's, the
// same C ABI and float order).
//
// The counterpart of the reference's C++ asset layer
// (Voxel_Cone_Tracing_Final/Model.h:43-139 Assimp import, Mesh.h:41-82
// vertex assembly): scene ingest and sample generation are host-bound,
// string/branch-heavy work where native code is several times the Python
// and numpy paths on Sponza-scale meshes.
//
// Exact-parity contract: both entry points reproduce the plain
// implementations bit-for-bit (scene/obj.py load_obj geometry,
// render/voxelize.py generate_surface_samples) — compile with
// -ffp-contract=off so no FMA contraction changes float results.
// Parity is enforced by tests/test_torch_native.py.
//
// C ABI only (ctypes binding in vct_tpu_torch/native/__init__.py).

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct V3 { float x, y, z; };
struct V2 { float u, v; };
// raw vt records stay double so the flip (1.0 - v) rounds to float32 the
// same way numpy does (scene/obj.py:183 computes it in python floats)
struct V2d { double u, v; };

struct ObjData {
  std::vector<V3> positions;   // deduped output vertices
  std::vector<V2> uvs;
  std::vector<V3> normals;
  std::vector<int32_t> tris;        // 3*T
  std::vector<int32_t> tri_mat;     // T
  std::string mat_names;            // '\n'-joined, first-use order
  std::string mtllibs;              // '\n'-joined mtllib paths
  int32_t any_normals = 0;
};

struct Key {
  int32_t v, t, n;
  bool operator==(const Key& o) const {
    return v == o.v && t == o.t && n == o.n;
  }
};
struct KeyHash {
  size_t operator()(const Key& k) const {
    size_t h = (size_t)(uint32_t)k.v;
    h = h * 1000003u ^ (size_t)(uint32_t)k.t;
    h = h * 1000003u ^ (size_t)(uint32_t)k.n;
    return h;
  }
};

inline int32_t resolve(int64_t count, long idx) {
  return idx > 0 ? (int32_t)(idx - 1) : (int32_t)(count + idx);
}

// split on whitespace like python str.split()
inline char* next_tok(char** cur) {
  char* p = *cur;
  while (*p == ' ' || *p == '\t' || *p == '\r') ++p;
  if (*p == '\0' || *p == '\n') { *cur = p; return nullptr; }
  char* start = p;
  while (*p && *p != ' ' && *p != '\t' && *p != '\r' && *p != '\n') ++p;
  if (*p) { *p = '\0'; ++p; }
  *cur = p;
  return start;
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------- OBJ ----

void* vct_obj_parse(const char* path, int32_t flip_uv, float scale) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::string buf((size_t)size, '\0');
  if (fread(&buf[0], 1, (size_t)size, f) != (size_t)size) {
    fclose(f);
    return nullptr;
  }
  fclose(f);

  auto* d = new ObjData();
  std::vector<V3> vpos, vnrm;
  std::vector<V2d> vuv;
  std::unordered_map<Key, int32_t, KeyHash> vmap;
  std::unordered_map<std::string, int32_t> mat_index;
  std::vector<std::string> mat_names;
  int32_t cur_mat = 0;
  std::vector<int32_t> face;  // scratch

  char* line = &buf[0];
  char* end = line + buf.size();
  while (line < end) {
    char* nl = (char*)memchr(line, '\n', (size_t)(end - line));
    char* line_end = nl ? nl : end;
    if (nl) *nl = '\0';
    char* cur = line;
    char* key = next_tok(&cur);
    if (key && key[0] != '#') {
      if (!strcmp(key, "v")) {
        char* a = next_tok(&cur);
        char* b = next_tok(&cur);
        char* c = next_tok(&cur);
        vpos.push_back({(float)strtod(a ? a : "0", nullptr),
                        (float)strtod(b ? b : "0", nullptr),
                        (float)strtod(c ? c : "0", nullptr)});
      } else if (!strcmp(key, "vt")) {
        char* a = next_tok(&cur);
        char* b = next_tok(&cur);
        vuv.push_back({strtod(a ? a : "0", nullptr),
                       b ? strtod(b, nullptr) : 0.0});
      } else if (!strcmp(key, "vn")) {
        char* a = next_tok(&cur);
        char* b = next_tok(&cur);
        char* c = next_tok(&cur);
        vnrm.push_back({(float)strtod(a ? a : "0", nullptr),
                        (float)strtod(b ? b : "0", nullptr),
                        (float)strtod(c ? c : "0", nullptr)});
        d->any_normals = 1;
      } else if (!strcmp(key, "mtllib")) {
        // remainder of the line joined with spaces (python " ".join)
        std::string name;
        for (char* t = next_tok(&cur); t; t = next_tok(&cur)) {
          if (!name.empty()) name += ' ';
          name += t;
        }
        if (!d->mtllibs.empty()) d->mtllibs += '\n';
        d->mtllibs += name;
      } else if (!strcmp(key, "usemtl")) {
        char* t = next_tok(&cur);
        std::string name = t ? t : "default";
        auto it = mat_index.find(name);
        if (it == mat_index.end()) {
          cur_mat = (int32_t)mat_names.size();
          mat_index.emplace(name, cur_mat);
          mat_names.push_back(name);
        } else {
          cur_mat = it->second;
        }
      } else if (!strcmp(key, "f")) {
        face.clear();
        for (char* t = next_tok(&cur); t; t = next_tok(&cur)) {
          // spec: v[/vt][/vn]
          char* p = t;
          long vi_raw = strtol(p, &p, 10);
          int32_t vi = resolve((int64_t)vpos.size(), vi_raw);
          int32_t ti = -1, ni = -1;
          if (*p == '/') {
            ++p;
            if (*p != '/' && *p != '\0')
              ti = resolve((int64_t)vuv.size(), strtol(p, &p, 10));
            if (*p == '/') {
              ++p;
              if (*p != '\0') ni = resolve((int64_t)vnrm.size(),
                                           strtol(p, &p, 10));
            }
          }
          Key k{vi, ti, ni};
          auto it = vmap.find(k);
          int32_t out;
          if (it == vmap.end()) {
            out = (int32_t)d->positions.size();
            vmap.emplace(k, out);
            d->positions.push_back(vpos[(size_t)vi]);
            if (ti >= 0) {
              V2d uv = vuv[(size_t)ti];
              d->uvs.push_back({(float)uv.u,
                                (float)(flip_uv ? 1.0 - uv.v : uv.v)});
            } else {
              d->uvs.push_back({0.0f, 0.0f});
            }
            d->normals.push_back(ni >= 0 ? vnrm[(size_t)ni]
                                         : V3{0.0f, 0.0f, 0.0f});
          } else {
            out = it->second;
          }
          face.push_back(out);
        }
        for (size_t i = 1; i + 1 < face.size(); ++i) {
          d->tris.push_back(face[0]);
          d->tris.push_back(face[i]);
          d->tris.push_back(face[i + 1]);
          d->tri_mat.push_back(cur_mat);
        }
      }
    }
    line = line_end + 1;
  }

  for (auto& p : d->positions) {
    p.x *= scale;
    p.y *= scale;
    p.z *= scale;
  }
  for (size_t i = 0; i < mat_names.size(); ++i) {
    if (i) d->mat_names += '\n';
    d->mat_names += mat_names[i];
  }
  return d;
}

void vct_obj_counts(void* h, int64_t* n_verts, int64_t* n_tris,
                    int64_t* matname_bytes, int64_t* mtllib_bytes,
                    int32_t* any_normals) {
  auto* d = (ObjData*)h;
  *n_verts = (int64_t)d->positions.size();
  *n_tris = (int64_t)d->tri_mat.size();
  *matname_bytes = (int64_t)d->mat_names.size();
  *mtllib_bytes = (int64_t)d->mtllibs.size();
  *any_normals = d->any_normals;
}

void vct_obj_fill(void* h, float* pos, float* uv, float* nrm,
                  int32_t* tris, int32_t* tri_mat, char* mat_names,
                  char* mtllibs) {
  auto* d = (ObjData*)h;
  memcpy(pos, d->positions.data(), d->positions.size() * sizeof(V3));
  memcpy(uv, d->uvs.data(), d->uvs.size() * sizeof(V2));
  memcpy(nrm, d->normals.data(), d->normals.size() * sizeof(V3));
  memcpy(tris, d->tris.data(), d->tris.size() * sizeof(int32_t));
  memcpy(tri_mat, d->tri_mat.data(), d->tri_mat.size() * sizeof(int32_t));
  memcpy(mat_names, d->mat_names.data(), d->mat_names.size());
  memcpy(mtllibs, d->mtllibs.data(), d->mtllibs.size());
}

void vct_obj_free(void* h) { delete (ObjData*)h; }

// ---------------------------------------------- surface sample gen ----

// Per-triangle subdivision level: ceil(longest_edge / voxel * density)
// clipped to [1, nmax] — float32 math identical to voxelize.py:64-75.
void vct_sample_levels(const float* tv,           // (T, 3, 3)
                       int64_t t, float voxel, float density,
                       int32_t nmax, int32_t* levels /* (T,) */) {
  for (int64_t i = 0; i < t; ++i) {
    const float* a = tv + i * 9;
    const float* b = a + 3;
    const float* c = b + 3;
    float l1 = 0, l2 = 0, l3 = 0;
    for (int k = 0; k < 3; ++k) {
      float e1 = b[k] - a[k], e2 = c[k] - a[k], e3 = c[k] - b[k];
      l1 += e1 * e1;
      l2 += e2 * e2;
      l3 += e3 * e3;
    }
    float longest = sqrtf(l1);
    float s2 = sqrtf(l2);
    float s3 = sqrtf(l3);
    if (s2 > longest) longest = s2;
    if (s3 > longest) longest = s3;
    float n = ceilf(longest / voxel * density);
    if (!(n >= 1.0f)) n = 1.0f;
    if (n > (float)nmax) n = (float)nmax;
    levels[i] = (int32_t)n;
  }
}

// Fill stratified barycentric samples for all triangles.  Per triangle of
// level n: the lower lattice (i+j <= n-1, bary (i+1/3)/n) then the upper
// (i+j <= n-2, bary (i+2/3)/n), i-major — n^2 samples total, the same
// multiset as voxelize.generate_surface_samples (which batches by level).
// Returns the number of samples written.
int64_t vct_sample_fill(const float* tv,      // (T, 3, 3)
                        const float* t_uv,    // (T, 3, 2)
                        const float* fn,      // (T, 3) face normals
                        const int32_t* tri_material,  // (T,)
                        const int32_t* levels,        // (T,)
                        int64_t t,
                        float* pos,           // (S, 3)
                        float* nrm,           // (S, 3)
                        float* uv,            // (S, 2)
                        int32_t* mat,         // (S,)
                        int32_t* tri_id) {    // (S,)
  int64_t s = 0;
  for (int64_t i = 0; i < t; ++i) {
    const int n = levels[i];
    const float* a = tv + i * 9;
    const float* b = a + 3;
    const float* c = b + 3;
    const float* ua = t_uv + i * 6;
    const float* ub = ua + 2;
    const float* uc = ub + 2;
    const float* fnorm = fn + i * 3;
    const int32_t m = tri_material[i];
    for (int half = 0; half < 2; ++half) {
      const double off = half == 0 ? (1.0 / 3.0) : (2.0 / 3.0);
      const int lim = half == 0 ? n - 1 : n - 2;
      for (int ii = 0; ii <= lim; ++ii) {
        for (int jj = 0; jj + ii <= lim; ++jj) {
          // numpy: ((i + off) / n) computed in float64, cast to float32
          float u = (float)(((double)ii + off) / (double)n);
          float v = (float)(((double)jj + off) / (double)n);
          float w0 = 1.0f - u - v;
          for (int k = 0; k < 3; ++k) {
            float p = w0 * a[k];
            p += u * b[k];
            p += v * c[k];
            pos[s * 3 + k] = p;
            nrm[s * 3 + k] = fnorm[k];
          }
          for (int k = 0; k < 2; ++k) {
            float p = w0 * ua[k];
            p += u * ub[k];
            p += v * uc[k];
            uv[s * 2 + k] = p;
          }
          mat[s] = m;
          tri_id[s] = (int32_t)i;
          ++s;
        }
      }
    }
  }
  return s;
}

}  // extern "C"
