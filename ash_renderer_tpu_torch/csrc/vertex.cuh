// The vertex transform's arithmetic, one definition for K8 and K8C
// (transform.cu) and K10 (geometry.cu), which transforms the corners it
// needs itself: specmath.apply_mat4_point / apply_mat3_vec op for op, the
// reference's geometry.transform_vertices
// (ash_renderer_tpu/ops/geometry.py:43).
//
// Exactness:
// * a 4x4 row is ((m0*x + m1*y) + (m2*z + m3)), a 3x3 row
//   (m0*x + m1*y) + m2*z, every op rounded (fmul / fadd under
//   --fmad=false), subnormals kept;
// * colour and uv are copied as bits (a NaN payload survives);
// * with one object its matrices are broadcast; with several, each vertex
//   takes those of vert_obj[v], clamped to [0, n_obj) as XLA's gather
//   clamps.
#pragma once

#include <stdint.h>

#include "specmath.cuh"

namespace ash {
namespace vertex {

constexpr int MAT = 16;             // floats of a 4x4 matrix
constexpr int SMEM_OBJECTS = 128;   // objects whose matrices go to shared memory
constexpr int N_ROWS = 16;          // values a vertex
// a vertex's values: clip 4 | colour 4 | world normal 3 | uv 2 | world pos 3
constexpr int R_CLIP = 0, R_COLOR = 4, R_NORMAL = 8, R_UV = 11, R_WORLD = 13;

// apply_mat4_point's row r: ((m0*x + m1*y) + (m2*z + m3))
__device__ __forceinline__ float mat4_row(const float* m, int r, float x,
                                          float y, float z) {
  return fadd(fadd(fmul(m[r * 4 + 0], x), fmul(m[r * 4 + 1], y)),
              fadd(fmul(m[r * 4 + 2], z), m[r * 4 + 3]));
}

// apply_mat3_vec's row r: (m0*x + m1*y) + m2*z
__device__ __forceinline__ float mat3_row(const float* m, int r, float x,
                                          float y, float z) {
  return fadd(fadd(fmul(m[r * 4 + 0], x), fmul(m[r * 4 + 1], y)),
              fmul(m[r * 4 + 2], z));
}

// the scene's vertex tensors and the (n_obj, 4, 4) model and MVP matrices
struct Scene {
  const float* pos;   // (V, 3)
  const int* vobj;    // (V,)
  const float* nrm;   // (V, 3)
  const int* col;     // (V, 4) float32 bits
  const int* uv;      // (V, 2) float32 bits
  const float* model;
  const float* mvp;
  int n_obj;
};

// the first min(n_obj, SMEM_OBJECTS) objects' matrices into `mats`
// (model [n][16], then mvp [n][16]) by thread t of nt; the caller
// synchronizes before reading them
__device__ __forceinline__ void stage_mats(const Scene& S, float* mats, int t,
                                           int nt) {
  const int n_sm = min(S.n_obj, SMEM_OBJECTS);
  for (int i = t; i < n_sm * MAT; i += nt) {
    mats[i] = S.model[i];
    mats[n_sm * MAT + i] = S.mvp[i];
  }
}

// vertex v's model and MVP matrices, from `mats` where staged
struct Mats {
  const float* model;
  const float* mvp;
};

__device__ __forceinline__ Mats mats_of(const Scene& S, const float* mats,
                                        int v) {
  const int n_sm = min(S.n_obj, SMEM_OBJECTS);
  const int o =
      S.n_obj > 1 ? min(max(__ldg(S.vobj + v), 0), S.n_obj - 1) : 0;
  if (o < n_sm) return Mats{mats + o * MAT, mats + (n_sm + o) * MAT};
  return Mats{S.model + (size_t)o * MAT, S.mvp + (size_t)o * MAT};
}

// vertex v's clip position
__device__ __forceinline__ float4 clip_of(const Scene& S, const float* mats,
                                          int v) {
  const Mats M = mats_of(S, mats, v);
  const float* p = S.pos + (size_t)v * 3;
  const float px = __ldg(p), py = __ldg(p + 1), pz = __ldg(p + 2);
  return make_float4(mat4_row(M.mvp, 0, px, py, pz),
                     mat4_row(M.mvp, 1, px, py, pz),
                     mat4_row(M.mvp, 2, px, py, pz),
                     mat4_row(M.mvp, 3, px, py, pz));
}

// vertex v's 16 values as float32 bits (R_* order)
__device__ __forceinline__ void values(const Scene& S, const float* mats,
                                       int v, int (&r)[N_ROWS]) {
  const Mats M = mats_of(S, mats, v);
  const float* p = S.pos + (size_t)v * 3;
  const float* n = S.nrm + (size_t)v * 3;
  const float px = __ldg(p), py = __ldg(p + 1), pz = __ldg(p + 2);
  const float nx = __ldg(n), ny = __ldg(n + 1), nz = __ldg(n + 2);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    r[R_CLIP + k] = bits(mat4_row(M.mvp, k, px, py, pz));
#pragma unroll
  for (int k = 0; k < 4; ++k)
    r[R_COLOR + k] = __ldg(S.col + (size_t)v * 4 + k);
#pragma unroll
  for (int k = 0; k < 3; ++k)
    r[R_NORMAL + k] = bits(mat3_row(M.model, k, nx, ny, nz));
#pragma unroll
  for (int k = 0; k < 2; ++k) r[R_UV + k] = __ldg(S.uv + (size_t)v * 2 + k);
#pragma unroll
  for (int k = 0; k < 3; ++k)
    r[R_WORLD + k] = bits(mat4_row(M.model, k, px, py, pz));
}

// value ch (R_* order) of vertex v alone, as a float
__device__ __forceinline__ float value(const Scene& S, const float* mats,
                                       int v, int ch) {
  const Mats M = mats_of(S, mats, v);
  const float* p = S.pos + (size_t)v * 3;
  if (ch < R_COLOR)
    return mat4_row(M.mvp, ch - R_CLIP, __ldg(p), __ldg(p + 1), __ldg(p + 2));
  if (ch < R_NORMAL)
    return fbits(__ldg(S.col + (size_t)v * 4 + ch - R_COLOR));
  if (ch < R_UV) {
    const float* n = S.nrm + (size_t)v * 3;
    return mat3_row(M.model, ch - R_NORMAL, __ldg(n), __ldg(n + 1),
                    __ldg(n + 2));
  }
  if (ch < R_WORLD) return fbits(__ldg(S.uv + (size_t)v * 2 + ch - R_UV));
  return mat4_row(M.model, ch - R_WORLD, __ldg(p), __ldg(p + 1),
                  __ldg(p + 2));
}

}  // namespace vertex
}  // namespace ash
