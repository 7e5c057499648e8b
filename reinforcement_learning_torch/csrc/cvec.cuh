// Vector / rotation helpers for the arena-step kernel: the per-thread
// counterpart of ops/cvec.py.  A rotation matrix holds the body's
// forward/right/up axes as COLUMNS and is stored row-major: m[i][j] is
// row i, column j, so forward = (m[0][0], m[1][0], m[2][0]).
// Every function mirrors the plain PyTorch version's arithmetic order so
// the kernel and ops/ctick.py round alike.
#pragma once

#include <math.h>

struct V3 {
  float x, y, z;
};

struct M3 {
  float m[3][3];
};

__device__ __forceinline__ V3 v3(float x, float y, float z) {
  V3 r; r.x = x; r.y = y; r.z = z; return r;
}
__device__ __forceinline__ V3 vzero() { return v3(0.f, 0.f, 0.f); }
__device__ __forceinline__ V3 operator+(V3 a, V3 b) {
  return v3(a.x + b.x, a.y + b.y, a.z + b.z);
}
__device__ __forceinline__ V3 operator-(V3 a, V3 b) {
  return v3(a.x - b.x, a.y - b.y, a.z - b.z);
}
__device__ __forceinline__ V3 operator-(V3 a) { return v3(-a.x, -a.y, -a.z); }
__device__ __forceinline__ V3 operator*(V3 a, float s) {
  return v3(a.x * s, a.y * s, a.z * s);
}
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x);
}
__device__ __forceinline__ float norm(V3 a) { return sqrtf(dot(a, a)); }
__device__ __forceinline__ V3 sel(bool m, V3 a, V3 b) { return m ? a : b; }

// 0 for near-zero vectors (maths.normalize)
__device__ __forceinline__ V3 normalize(V3 a) {
  float n = norm(a);
  float inv = n > 1e-12f ? 1.0f / fmaxf(n, 1e-12f) : 0.0f;
  return a * inv;
}
__device__ __forceinline__ V3 clamp_norm(V3 a, float max_norm) {
  float n = norm(a);
  float s = n > max_norm ? max_norm / fmaxf(n, 1e-12f) : 1.0f;
  return a * s;
}
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ float signf(float x) {
  return x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
}

__device__ __forceinline__ V3 col(const M3& R, int j) {
  return v3(R.m[0][j], R.m[1][j], R.m[2][j]);
}
__device__ __forceinline__ V3 fwd_of(const M3& R) { return col(R, 0); }
__device__ __forceinline__ V3 right_of(const M3& R) { return col(R, 1); }
__device__ __forceinline__ V3 up_of(const M3& R) { return col(R, 2); }

// R @ a: local vector into the world frame
__device__ __forceinline__ V3 matvec(const M3& R, V3 a) {
  return v3(R.m[0][0] * a.x + R.m[0][1] * a.y + R.m[0][2] * a.z,
            R.m[1][0] * a.x + R.m[1][1] * a.y + R.m[1][2] * a.z,
            R.m[2][0] * a.x + R.m[2][1] * a.y + R.m[2][2] * a.z);
}
// R^T @ a: world vector into the body frame
__device__ __forceinline__ V3 mat_t_vec(const M3& R, V3 a) {
  return v3(R.m[0][0] * a.x + R.m[1][0] * a.y + R.m[2][0] * a.z,
            R.m[0][1] * a.x + R.m[1][1] * a.y + R.m[2][1] * a.z,
            R.m[0][2] * a.x + R.m[1][2] * a.y + R.m[2][2] * a.z);
}
__device__ __forceinline__ M3 matmul(const M3& A, const M3& B) {
  M3 r;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      r.m[i][j] = A.m[i][0] * B.m[0][j] + A.m[i][1] * B.m[1][j] +
                  A.m[i][2] * B.m[2][j];
  return r;
}
// R diag(d) R^T (symmetric)
__device__ __forceinline__ M3 inv_inertia_world(const M3& R, float d0,
                                                float d1, float d2) {
  M3 r;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int k = 0; k < 3; ++k)
      r.m[i][k] = R.m[i][0] * d0 * R.m[k][0] + R.m[i][1] * d1 * R.m[k][1] +
                  R.m[i][2] * d2 * R.m[k][2];
  return r;
}
__device__ __forceinline__ M3 diag3(float s) {
  M3 r;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) r.m[i][j] = i == j ? s : 0.f;
  return r;
}
// Gram-Schmidt on the forward/right/up columns
__device__ __forceinline__ M3 orthonormalize(const M3& R) {
  V3 f = normalize(fwd_of(R));
  V3 r = right_of(R);
  r = normalize(r - f * dot(f, r));
  V3 u = cross(f, r);
  M3 o;
  o.m[0][0] = f.x; o.m[0][1] = r.x; o.m[0][2] = u.x;
  o.m[1][0] = f.y; o.m[1][1] = r.y; o.m[1][2] = u.y;
  o.m[2][0] = f.z; o.m[2][1] = r.z; o.m[2][2] = u.z;
  return o;
}
// exponential map (Rodrigues) + orthonormalize
__device__ __forceinline__ M3 integrate_rotation(const M3& R, V3 w,
                                                 float dt) {
  float theta = norm(w);
  float inv = theta > 1e-12f ? 1.0f / fmaxf(theta, 1e-12f) : 0.0f;
  V3 a = w * inv;
  float angle = theta * dt;
  float c = cosf(angle), s = sinf(angle);
  float C = 1.0f - c;
  M3 rot;
  rot.m[0][0] = c + a.x * a.x * C;
  rot.m[0][1] = a.x * a.y * C - a.z * s;
  rot.m[0][2] = a.x * a.z * C + a.y * s;
  rot.m[1][0] = a.y * a.x * C + a.z * s;
  rot.m[1][1] = c + a.y * a.y * C;
  rot.m[1][2] = a.y * a.z * C - a.x * s;
  rot.m[2][0] = a.z * a.x * C - a.y * s;
  rot.m[2][1] = a.z * a.y * C + a.x * s;
  rot.m[2][2] = c + a.z * a.z * C;
  return orthonormalize(matmul(rot, R));
}
__device__ __forceinline__ M3 yaw_mat(float yaw) {
  float cy = cosf(yaw), sy = sinf(yaw);
  M3 r;
  r.m[0][0] = cy; r.m[0][1] = -sy; r.m[0][2] = 0.f;
  r.m[1][0] = sy; r.m[1][1] = cy;  r.m[1][2] = 0.f;
  r.m[2][0] = 0.f; r.m[2][1] = 0.f; r.m[2][2] = 1.f;
  return r;
}

// LinearPieceCurve, clamped at both ends: one select per segment, the same
// arithmetic as cvec.curve.  dx/dy hold x1-x0 and y1-y0 per segment.
struct Curve {
  float n;          // number of points (2..6)
  float xs[6], ys[6];
  float dx[5], dy[5];
};

__device__ __forceinline__ float curve(const Curve& c, float x) {
  float out = c.ys[0];
  int n = (int)c.n;
  for (int k = 0; k < n - 1; ++k) {
    float t = clampf((x - c.xs[k]) / c.dx[k], 0.f, 1.f);
    float seg = c.ys[k] + t * c.dy[k];
    out = x >= c.xs[k] ? seg : out;
  }
  return out;
}
