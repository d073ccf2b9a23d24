// Fast OBJ parser for ash_renderer_tpu_torch (a copy of the JAX package's
// native/objparse.cpp).
//
// Built with the host C++ compiler by _build.py and bound with ctypes by
// native.py (parse_obj); models/obj.py uses it when a compiler is found and
// its pure-Python parser otherwise.  It handles the same grammar as
// models/obj.py (v / vt / vn / f with polygon fan triangulation, negative
// indices, v//vn and v/vt/vn corner forms, (v,vt,vn)-triple deduplication)
// and gives the same arrays.
//
// C ABI:
//   void*  ash_parse_obj(const char* path)            -> handle or NULL
//   void   ash_obj_counts(void*, int64* nv, int64* nf)
//   void   ash_obj_fill(void*, float* pos3, float* uv2, float* nrm3,
//                       int32* faces3)
//   void   ash_obj_free(void*)

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct ObjData {
  std::vector<float> pos;   // deduped, 3 per vertex
  std::vector<float> uv;    // 2 per vertex
  std::vector<float> nrm;   // 3 per vertex
  std::vector<int32_t> faces;  // 3 per triangle
};

struct Key {
  int32_t v, t, n;
  bool operator==(const Key& o) const {
    return v == o.v && t == o.t && n == o.n;
  }
};

struct KeyHash {
  size_t operator()(const Key& k) const {
    uint64_t h = (uint64_t)(uint32_t)k.v;
    h = h * 1000003u ^ (uint64_t)(uint32_t)k.t;
    h = h * 1000003u ^ (uint64_t)(uint32_t)k.n;
    return (size_t)h;
  }
};

// Parse a float fast; falls back to strtof for exotic forms.
inline const char* skip_ws(const char* p) {
  while (*p == ' ' || *p == '\t' || *p == '\r') ++p;
  return p;
}

inline int32_t resolve(long idx, size_t n) {
  return idx > 0 ? (int32_t)(idx - 1) : (int32_t)((long)n + idx);
}

}  // namespace

extern "C" {

void* ash_parse_obj(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::string buf;
  buf.resize((size_t)size);
  if (size > 0 && fread(&buf[0], 1, (size_t)size, f) != (size_t)size) {
    fclose(f);
    return nullptr;
  }
  fclose(f);

  std::vector<float> vs, vts, vns;
  vs.reserve(1 << 16);
  auto* out = new ObjData();
  out->pos.reserve(1 << 16);
  std::unordered_map<Key, int32_t, KeyHash> dedup;
  dedup.reserve(1 << 16);
  std::vector<int32_t> poly;

  const char* p = buf.c_str();
  const char* end = p + buf.size();
  while (p < end) {
    p = skip_ws(p);
    if (p[0] == 'v' && p[1] == ' ') {
      p += 2;
      for (int i = 0; i < 3; ++i) {
        char* q;
        vs.push_back(strtof(p, &q));
        p = q;
      }
    } else if (p[0] == 'v' && p[1] == 't') {
      p += 3;
      char* q;
      float u = strtof(p, &q);
      p = q;
      float v = strtof(p, &q);
      p = q;
      vts.push_back(u);
      vts.push_back(1.0f - v);  // OBJ uv origin bottom-left (matches obj.py)
    } else if (p[0] == 'v' && p[1] == 'n') {
      p += 3;
      for (int i = 0; i < 3; ++i) {
        char* q;
        vns.push_back(strtof(p, &q));
        p = q;
      }
    } else if (p[0] == 'f' && (p[1] == ' ' || p[1] == '\t')) {
      p += 2;
      poly.clear();
      while (p < end && *p != '\n' && *p != '#') {
        p = skip_ws(p);
        if (*p == '\n' || *p == '#' || p >= end) break;
        char* q;
        long vi = strtol(p, &q, 10);
        if (q == p) break;
        p = q;
        long ti = 0, ni = 0;
        bool has_t = false, has_n = false;
        if (*p == '/') {
          ++p;
          if (*p != '/') {
            ti = strtol(p, &q, 10);
            has_t = q != p;
            p = q;
          }
          if (*p == '/') {
            ++p;
            ni = strtol(p, &q, 10);
            has_n = q != p;
            p = q;
          }
        }
        Key key{resolve(vi, vs.size() / 3),
                has_t ? resolve(ti, vts.size() / 2) : -1,
                has_n ? resolve(ni, vns.size() / 3) : -1};
        auto it = dedup.find(key);
        int32_t id;
        if (it != dedup.end()) {
          id = it->second;
        } else {
          id = (int32_t)(out->pos.size() / 3);
          dedup.emplace(key, id);
          out->pos.push_back(vs[(size_t)key.v * 3 + 0]);
          out->pos.push_back(vs[(size_t)key.v * 3 + 1]);
          out->pos.push_back(vs[(size_t)key.v * 3 + 2]);
          if (key.t >= 0) {
            out->uv.push_back(vts[(size_t)key.t * 2 + 0]);
            out->uv.push_back(vts[(size_t)key.t * 2 + 1]);
          } else {
            out->uv.push_back(0.0f);
            out->uv.push_back(0.0f);
          }
          if (key.n >= 0) {
            out->nrm.push_back(vns[(size_t)key.n * 3 + 0]);
            out->nrm.push_back(vns[(size_t)key.n * 3 + 1]);
            out->nrm.push_back(vns[(size_t)key.n * 3 + 2]);
          } else {
            out->nrm.push_back(0.0f);
            out->nrm.push_back(0.0f);
            out->nrm.push_back(0.0f);
          }
        }
        poly.push_back(id);
      }
      for (size_t k = 1; k + 1 < poly.size(); ++k) {
        out->faces.push_back(poly[0]);
        out->faces.push_back(poly[k]);
        out->faces.push_back(poly[k + 1]);
      }
    }
    while (p < end && *p != '\n') ++p;
    ++p;
  }
  return out;
}

void ash_obj_counts(void* handle, int64_t* nv, int64_t* nf) {
  auto* d = (ObjData*)handle;
  *nv = (int64_t)(d->pos.size() / 3);
  *nf = (int64_t)(d->faces.size() / 3);
}

void ash_obj_fill(void* handle, float* pos, float* uv, float* nrm,
                  int32_t* faces) {
  auto* d = (ObjData*)handle;
  memcpy(pos, d->pos.data(), d->pos.size() * sizeof(float));
  memcpy(uv, d->uv.data(), d->uv.size() * sizeof(float));
  memcpy(nrm, d->nrm.data(), d->nrm.size() * sizeof(float));
  memcpy(faces, d->faces.data(), d->faces.size() * sizeof(int32_t));
}

void ash_obj_free(void* handle) { delete (ObjData*)handle; }

}  // extern "C"
