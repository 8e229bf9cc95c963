// Fast Wavefront OBJ parser behind models/obj_io.py: the port's own copy
// of cython3dmodelrenderer_tpu/native/objparse.cpp (importing that package
// imports jax). The line-parsing hot loop of the pure-Python parser
// (reference: crender/py/data_structures/model.py:6-77) in C++.
//
// Semantics match the Python fallback exactly:
//   * lenient line-by-line parsing: malformed lines are skipped;
//   * 'v' takes the first three floats (>=3 required), 'vt' up to three,
//     'vn' exactly three;
//   * faces fan-triangulate, support v, v/vt, v//vn, v/vt/vn forms;
//   * 1-based indices -> 0-based, non-positive pass through (relative);
//   * any missing vt (resp. vn) component drops the whole per-triangle
//     table (all-or-nothing, like model.py:49-57);
//   * mtllib names are collected in order for Python to resolve (file IO
//     and texture decode stay in Python).
//
// Exposed as a C ABI for ctypes; all memory is owned by a context object
// freed with obj_free.

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct ObjResult {
  std::vector<float> vertices;        // 3 per vertex
  std::vector<float> texcoords;       // 3 per vt (w default 0)
  std::vector<int32_t> texcoord_dims; // actual component count per vt
  std::vector<float> normals;         // 3 per vn
  std::vector<int32_t> faces_v;       // 3 per triangle
  std::vector<int32_t> faces_vt;
  std::vector<int32_t> faces_vn;
  bool have_vt = true;
  bool have_vn = true;
  std::string mtllibs;                // '\n'-joined raw names
  int32_t max_tc_dim = 0;
};

inline int32_t fix_index(long idx) { return idx > 0 ? (int32_t)(idx - 1) : (int32_t)idx; }

// Parse ALL whitespace-separated floats from `s` (python-parity: every token
// must be a float or the whole line is malformed). Stores the first
// `max_store`; returns total token count, or -1 on any malformed token.
int parse_floats(const char* s, float* out, int max_store) {
  int n = 0;
  char* end = nullptr;
  for (;;) {
    while (*s == ' ' || *s == '\t' || *s == '\r') ++s;
    if (*s == '\0' || *s == '\n') break;
    float v = strtof(s, &end);
    if (end == s) return -1;  // malformed token → skip line
    // token must terminate at whitespace/EOL (reject "1.5x")
    if (*end != ' ' && *end != '\t' && *end != '\r' && *end != '\n' &&
        *end != '\0')
      return -1;
    if (n < max_store) out[n] = v;
    ++n;
    s = end;
  }
  return n;
}

struct Corner {
  int32_t v;
  int32_t vt;
  int32_t vn;
  bool has_vt;
  bool has_vn;
};

inline bool is_term(char ch) {
  return ch == '\0' || ch == ' ' || ch == '\t' || ch == '\r' || ch == '\n';
}

// Python-parity corner parse: ``(comp + "//").split("/")[:3]`` — empty vt/vn
// components are "absent", and everything past the third '/'-separated
// component is ignored regardless of content.
bool parse_corner(const char*& s, Corner* c) {
  while (*s == ' ' || *s == '\t' || *s == '\r') ++s;
  if (*s == '\0' || *s == '\n') return false;
  char* end = nullptr;
  long v = strtol(s, &end, 10);
  if (end == s) return false;
  s = end;
  c->v = fix_index(v);
  c->has_vt = false;
  c->has_vn = false;
  if (*s == '/') {
    ++s;
    if (*s != '/' && !is_term(*s)) {
      long vt = strtol(s, &end, 10);
      if (end == s) return false;
      s = end;
      c->vt = fix_index(vt);
      c->has_vt = true;
    }
    if (*s == '/') {
      ++s;
      if (*s != '/' && !is_term(*s)) {
        long vn = strtol(s, &end, 10);
        if (end == s) return false;
        s = end;
        c->vn = fix_index(vn);
        c->has_vn = true;
      }
      if (*s == '/')  // extra components: consume and ignore
        while (!is_term(*s)) ++s;
    }
  }
  return true;
}

}  // namespace

extern "C" {

void* obj_parse(const char* filename) {
  FILE* f = fopen(filename, "rb");
  if (!f) return nullptr;
  auto* r = new ObjResult();

  char line[65536];
  std::vector<Corner> corners;
  while (fgets(line, sizeof(line), f)) {
    const char* s = line;
    if (s[0] == '\0' || s[0] == '#') continue;
    // command = text up to first space; data follows (split(' ', 1))
    const char* sp = strchr(s, ' ');
    if (!sp) continue;  // invalid line (no space-separated data)
    size_t cmdlen = (size_t)(sp - s);
    const char* data = sp + 1;

    if (cmdlen == 1 && s[0] == 'v') {
      float xyz[4];
      int n = parse_floats(data, xyz, 4);
      if (n >= 3) {
        r->vertices.push_back(xyz[0]);
        r->vertices.push_back(xyz[1]);
        r->vertices.push_back(xyz[2]);
      }
    } else if (cmdlen == 2 && s[0] == 'v' && s[1] == 't') {
      float uvw[3] = {0, 0, 0};
      int n = parse_floats(data, uvw, 3);
      if (n >= 1) {
        r->texcoords.push_back(uvw[0]);
        r->texcoords.push_back(uvw[1]);
        r->texcoords.push_back(uvw[2]);
        r->texcoord_dims.push_back(n);
        if (n > r->max_tc_dim) r->max_tc_dim = n;
      }
    } else if (cmdlen == 2 && s[0] == 'v' && s[1] == 'n') {
      float xyz[3];
      int n = parse_floats(data, xyz, 3);
      if (n == 3) {
        r->normals.push_back(xyz[0]);
        r->normals.push_back(xyz[1]);
        r->normals.push_back(xyz[2]);
      }
    } else if (cmdlen == 1 && s[0] == 'f') {
      corners.clear();
      const char* p = data;
      Corner c;
      bool ok = true;
      while (parse_corner(p, &c)) corners.push_back(c);
      // trailing garbage check: any non-space residue means malformed
      while (*p == ' ' || *p == '\t' || *p == '\r') ++p;
      if (*p != '\0' && *p != '\n') ok = false;
      if (!ok || corners.size() < 3) continue;
      for (size_t i = 0; i + 2 < corners.size(); ++i) {
        const Corner tri[3] = {corners[0], corners[i + 1], corners[i + 2]};
        bool tri_vt = tri[0].has_vt && tri[1].has_vt && tri[2].has_vt;
        bool tri_vn = tri[0].has_vn && tri[1].has_vn && tri[2].has_vn;
        if (!tri_vt) r->have_vt = false;
        if (!tri_vn) r->have_vn = false;
        for (int k = 0; k < 3; ++k) {
          r->faces_v.push_back(tri[k].v);
          r->faces_vt.push_back(tri[k].has_vt ? tri[k].vt : 0);
          r->faces_vn.push_back(tri[k].has_vn ? tri[k].vn : 0);
        }
      }
    } else if (cmdlen == 6 && strncmp(s, "mtllib", 6) == 0) {
      std::string name(data);
      while (!name.empty() && (name.back() == '\n' || name.back() == '\r'))
        name.pop_back();
      if (!name.empty()) {
        if (!r->mtllibs.empty()) r->mtllibs += '\n';
        r->mtllibs += name;
      }
    }
  }
  fclose(f);
  return r;
}

void obj_free(void* ctx) { delete static_cast<ObjResult*>(ctx); }

int64_t obj_num_vertices(void* ctx) { return static_cast<ObjResult*>(ctx)->vertices.size() / 3; }
int64_t obj_num_texcoords(void* ctx) { return static_cast<ObjResult*>(ctx)->texcoords.size() / 3; }
int64_t obj_num_normals(void* ctx) { return static_cast<ObjResult*>(ctx)->normals.size() / 3; }
int64_t obj_num_triangles(void* ctx) { return static_cast<ObjResult*>(ctx)->faces_v.size() / 3; }
int32_t obj_have_vt(void* ctx) { return static_cast<ObjResult*>(ctx)->have_vt ? 1 : 0; }
int32_t obj_have_vn(void* ctx) { return static_cast<ObjResult*>(ctx)->have_vn ? 1 : 0; }
int32_t obj_max_tc_dim(void* ctx) { return static_cast<ObjResult*>(ctx)->max_tc_dim; }

const float* obj_vertices(void* ctx) { return static_cast<ObjResult*>(ctx)->vertices.data(); }
const float* obj_texcoords(void* ctx) { return static_cast<ObjResult*>(ctx)->texcoords.data(); }
const int32_t* obj_texcoord_dims(void* ctx) { return static_cast<ObjResult*>(ctx)->texcoord_dims.data(); }
const float* obj_normals(void* ctx) { return static_cast<ObjResult*>(ctx)->normals.data(); }
const int32_t* obj_faces_v(void* ctx) { return static_cast<ObjResult*>(ctx)->faces_v.data(); }
const int32_t* obj_faces_vt(void* ctx) { return static_cast<ObjResult*>(ctx)->faces_vt.data(); }
const int32_t* obj_faces_vn(void* ctx) { return static_cast<ObjResult*>(ctx)->faces_vn.data(); }
const char* obj_mtllibs(void* ctx) { return static_cast<ObjResult*>(ctx)->mtllibs.c_str(); }

}  // extern "C"
