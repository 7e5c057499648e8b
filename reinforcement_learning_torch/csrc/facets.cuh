// facets.cuh: the closed-form facet arena, per thread.
//
// The per-thread counterpart of reinforcement_learning_torch/physics/
// facet_arena.py (which mirrors the TPU kernel's reinforcement_learning_tpu/
// physics/facet_arena.py): the procedural soccar mesh queried per profile
// band, folded octagon side and goal rectangle.  A query is split into
// items (one side's band, one goal rectangle), each evaluated on its own
// by any lane after a conservative cull, and each live row goes to a
// visitor with its index in the plain version's stacked row order, so a
// caller can keep what it needs without storing the 240 candidates of a
// car:
//
//   sphere:  side * 76 + kind * 19 + band (kinds: face or clamp, lateral
//            seam duplicate, fan partner, its mirror), then 228 + 2 * rect
//            + {0, 1} for the goal rectangles;
//   box:     side * 76 + kind * 19 + band (kinds: face, lateral seam
//            duplicate, top band seam, bottom band seam), then 228 + rect;
//   sheets:  the floor grid's 4 region rows, then the ceiling's.
//
// Arithmetic follows the plain version operation for operation (the build
// passes -fmad=false), including its quadrant fold (sign 0 folds to +1),
// its division in floor(x / cell), and its constants rounded from double.
#pragma once

#include "cvec.cuh"

namespace facets {

constexpr int NB = 19;         // profile bands
constexpr int NSIDE = 3;       // folded sides
constexpr int NLEN = 8;        // lateral quads per wall strip
constexpr int SPHERE_ROWS = 236;
constexpr int BOX_ROWS = 232;

// per-band rows of Tables.band, per-side rows of Tables.side
enum { BZ0, BW0, BTW, BTZ, BL, BNW, BNZ, BLOF, BHIF, BCUT0, BCUTS, NBANDF };
enum { SNX, SNY, SD, SUX, SUY, SLO0, SLOS, SHI0, SHIS, NSIDEF };

// The arena's tables as float32, packed by ops/arena_step.py from
// facet_arena.band_table and FacetTables.
struct Tables {
  float band[NBANDF][NB];
  float side[NSIDE][NSIDEF];
};

constexpr double GW = 892.755, GH = 642.775, GD = 880.0, EY = 5120.0;
constexpr float GOAL_HW = (float)GW;
constexpr float SHEET_CELL = 1024.0f;
constexpr float SHEET_HALF = 512.0f;
constexpr float INV_SQRT2 = (float)0.7071067811865476;

// Goal-box rectangles in folded coordinates (facet_arena.goal_rects): the
// plane (axis, value, inward sign), the two in-plane extents, the mouth
// axis (-1: none), and the extents widened by 1 (box rows) and 0.5 (rays).
struct Rect {
  int axis;
  float value, nsign;
  int ua;
  float ulo, uhi;
  int va;
  float vlo, vhi;
  int mouth;
  float ulo_b, uhi_b, vlo_b, vhi_b, ulo_r, uhi_r, vlo_r, vhi_r;
};
#define FACET_RECT(ax, val, ns, ua, ulo, uhi, va, vlo, vhi, mouth)           \
  {ax, (float)(val), (float)(ns), ua, (float)(ulo), (float)(uhi), va,        \
   (float)(vlo), (float)(vhi), mouth, (float)((ulo)-1.0),                    \
   (float)((uhi) + 1.0), (float)((vlo)-1.0), (float)((vhi) + 1.0),           \
   (float)((ulo)-0.5), (float)((uhi) + 0.5), (float)((vlo)-0.5),             \
   (float)((vhi) + 0.5)}
__device__ const Rect RECTS[4] = {
    FACET_RECT(2, 0.0, 1.0, 0, 0.0, GW, 1, EY, EY + GD, -1),   // floor
    FACET_RECT(2, GH, -1.0, 0, 0.0, GW, 1, EY, EY + GD, 1),    // ceiling
    FACET_RECT(0, GW, -1.0, 1, EY, EY + GD, 2, 0.0, GH, 1),    // side wall
    FACET_RECT(1, EY + GD, -1.0, 0, 0.0, GW, 2, 0.0, GH, -1),  // back wall
};
#undef FACET_RECT
// goal patch seams per folded axis: origin, spacing (facet_arena.goal_seams)
__device__ const float SEAM_O[3] = {0.0f, (float)EY, 0.0f};
__device__ const float SEAM_S[3] = {(float)(2 * GW / 8), (float)(GD / 2),
                                    (float)(GH / 2)};

__device__ __forceinline__ float fold_sign(float p) {
  float s = signf(p);
  return s == 0.f ? 1.f : s;
}
__device__ __forceinline__ float comp(V3 v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : v.z);
}
__device__ __forceinline__ float sq(float x) { return x * x; }
__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

struct Side {
  float nx, ny, d, ux, uy, lo0, loS, hi0, hiS;
};
__device__ __forceinline__ Side side_of(const Tables& T, int s) {
  const float* r = T.side[s];
  Side o;
  o.nx = r[SNX]; o.ny = r[SNY]; o.d = r[SD]; o.ux = r[SUX]; o.uy = r[SUY];
  o.lo0 = r[SLO0]; o.loS = r[SLOS]; o.hi0 = r[SHI0]; o.hiS = r[SHIS];
  return o;
}
__device__ __forceinline__ float side_w(const Side& S, float px, float py) {
  return S.nx * px + S.ny * py - S.d;
}
__device__ __forceinline__ float side_t(const Side& S, float px, float py) {
  return S.ux * px + S.uy * py;
}
__device__ __forceinline__ V3 unfold(const Side& S, float n_w, float n_t,
                                     float n_z, float sx, float sy) {
  return v3((S.nx * n_w + S.ux * n_t) * sx, (S.ny * n_w + S.uy * n_t) * sy,
            n_z);
}

struct Band {
  float z0, w0, tw, tz, L, nw, nz, cut_t0, cut_ts;
  bool lo_flat, hi_flat, has_cut;
};
__device__ __forceinline__ Band band_of(const Tables& T, int side, int b) {
  Band o;
  o.z0 = T.band[BZ0][b]; o.w0 = T.band[BW0][b]; o.tw = T.band[BTW][b];
  o.tz = T.band[BTZ][b]; o.L = T.band[BL][b]; o.nw = T.band[BNW][b];
  o.nz = T.band[BNZ][b];
  o.lo_flat = T.band[BLOF][b] > 0.f;
  o.hi_flat = T.band[BHIF][b] > 0.f;
  o.cut_t0 = T.band[BCUT0][b];
  o.cut_ts = T.band[BCUTS][b];
  o.has_cut = side == 2 && o.cut_t0 > 0.f;
  return o;
}

// ---------------------------------------------------------------------------
// Culls.  A query is split into items (a side's band, a goal rectangle, a
// sheet) and an item is skipped only where none of its rows could be live:
// each test below bounds from below every row distance the item can yield
// and rejects it when that bound reaches the break gap.  CULL_SLACK (1 uu)
// covers the rounding of the bound against the rows' own arithmetic, which
// differs from it by a few float ulps of arena coordinates (~1e-2 uu at
// most).  The same predicates, in torch, are held against the plain
// queries' live rows and hits in tests/test_torch_kernel_cull.py.

constexpr float CULL_SLACK = 1.0f;

// The w extent of all profile bands (every band lies in wlo <= w <= whi
// of its side's frame), so a point at w farther than ``reach`` outside it
// is farther than ``reach`` from every band of the side.
struct Extent {
  float wlo, whi;
};
__device__ __forceinline__ Extent band_extent(const Tables& T) {
  Extent x;
  x.wlo = INFINITY;
  x.whi = -INFINITY;
  for (int b = 0; b < NB; ++b) {
    const float w1 = T.band[BW0][b] + T.band[BTW][b] * T.band[BL][b];
    x.wlo = fminf(x.wlo, fminf(T.band[BW0][b], w1));
    x.whi = fmaxf(x.whi, fmaxf(T.band[BW0][b], w1));
  }
  return x;
}
__device__ __forceinline__ bool side_out_of_reach(const Extent& X, float w,
                                                  float reach) {
  return (w < X.wlo - reach) | (w > X.whi + reach);
}

// Distance in a side's (w, z) plane from (w, z) to band b's profile
// segment.  The side frame (w, t) is orthonormal and a band is the strip
// {segment} x [t_lo, t_hi], so no point of the band is nearer in 3D.
__device__ __forceinline__ float band_seg_dist(const Tables& T, int b,
                                               float w, float z) {
  const float w0 = T.band[BW0][b], z0 = T.band[BZ0][b];
  const float tw = T.band[BTW][b], tz = T.band[BTZ][b];
  const float ell = clip((w - w0) * tw + (z - z0) * tz, 0.f, T.band[BL][b]);
  const float dw = w - (w0 + tw * ell), dz = z - (z0 + tz * ell);
  return sqrtf(dw * dw + dz * dz);
}

// ---------------------------------------------------------------------------
// Sphere (facet_arena.sphere_contacts, _goal_sphere).
// visit(idx, n, gap) for every row with gap < break_gap.

struct SphereQ {
  V3 p;
  float radius, bg, sx, sy, ax, ay;
};
__device__ __forceinline__ SphereQ sphere_q(V3 p, float radius, float bg) {
  SphereQ q;
  q.p = p; q.radius = radius; q.bg = bg;
  q.sx = fold_sign(p.x); q.sy = fold_sign(p.y);
  q.ax = p.x * q.sx; q.ay = p.y * q.sy;
  return q;
}

// Every row of a band measures the centre's distance to a point of the
// band (the clamped closest point, or with face_ok the foot on the band's
// plane, |s_d| = the segment distance), so gap >= segment distance - r.
__device__ __forceinline__ bool sphere_band_dead(const Tables& T,
                                                 const Extent& X,
                                                 const SphereQ& q, int side,
                                                 int b) {
  const Side S = side_of(T, side);
  const float w_q = side_w(S, q.ax, q.ay);
  const float reach = q.radius + q.bg + CULL_SLACK;
  return side_out_of_reach(X, w_q, reach) ||
         band_seg_dist(T, b, w_q, q.p.z) >= reach;
}

template <class F>
__device__ void sphere_band(const Tables& T, const SphereQ& q, int side,
                            int b, F& visit) {
  const float sx = q.sx, sy = q.sy, ax = q.ax, ay = q.ay, pz = q.p.z;
  const float radius = q.radius, bg = q.bg;
  const Side S = side_of(T, side);
  const float w_q = side_w(S, ax, ay), t_q = side_t(S, ax, ay);
  const Band B = band_of(T, side, b);
  const float ell_raw = (w_q - B.w0) * B.tw + (pz - B.z0) * B.tz;
  const float ell = clip(ell_raw, 0.f, B.L);
  const float w_c = B.w0 + B.tw * ell;
  const float z_c = B.z0 + B.tz * ell;
  const float t_lo = S.lo0 - S.loS * w_c;
  const float t_hi = S.hi0 - S.hiS * w_c;
  float t_c = clip(t_q, t_lo, t_hi);
  const bool clamped_prof = (ell_raw < 0.f) | (ell_raw > B.L);
  const bool clamped_lat = (t_q < t_lo) | (t_q > t_hi);
  const float cut = B.cut_t0 - B.cut_ts * w_c;
  const bool in_cut = B.has_cut & (fabsf(t_c) < cut);
  float t_rim = signf(t_q) * cut;
  t_rim = t_rim == 0.f ? cut : t_rim;
  t_c = in_cut ? t_rim : t_c;
  const float dw = w_q - w_c, dt = t_q - t_c, dz = pz - z_c;
  const float dist = sqrtf(dw * dw + dt * dt + dz * dz);
  const float s_d = (w_q - B.w0) * B.nw + (pz - B.z0) * B.nz;
  const float sgn = s_d >= 0.f ? 1.f : -1.f;
  const float fn_w = B.nw * sgn, fn_z = B.nz * sgn;
  const bool ell_lo = ell <= 0.f;
  const bool raw_prof =
      clamped_prof & !((ell_lo & B.lo_flat) | (!ell_lo & B.hi_flat));
  const bool use_raw = (raw_prof | clamped_lat | in_cut) & (dist > 1e-6f);
  const float inv = 1.0f / fmaxf(dist, 1e-6f);
  const int base = side * 4 * NB + b;
  const float gap0 = dist - radius;
  if (gap0 < bg)
    visit(base, unfold(S, use_raw ? dw * inv : fn_w,
                       use_raw ? dt * inv : 0.f,
                       use_raw ? dz * inv : fn_z, sx, sy),
          gap0);

  // lateral u-break duplicate (coplanar seam: face normal)
  const bool face_ok = !(clamped_prof | clamped_lat | in_cut);
  const V3 fn = unfold(S, fn_w, 0.f, fn_z, sx, sy);
  const float span = t_hi - t_lo;
  const float u_frac = (t_c - t_lo) / span;
  const float perp2 = s_d * s_d;
  const float t_s = t_lo + span * (rintf(u_frac * (float)NLEN) /
                                   (float)NLEN);
  float d_lat = fabsf(t_c - t_s);
  if (side == 2) d_lat = fminf(d_lat, fabsf(fabsf(t_c) - GOAL_HW));
  const float gap_lat =
      face_ok ? sqrtf(perp2 + d_lat * d_lat) - radius : 1e9f;
  if (gap_lat < bg) visit(base + NB, fn, gap_lat);

  // fan-partner triangle of the containing quad
  const float j0 = clip(floorf(u_frac * (float)NLEN), 0.f,
                        (float)(NLEN - 1));
  const float t_a = t_lo + span * (j0 / (float)NLEN);
  const float dgt = span / (float)NLEN;
  const float t_b = t_a + dgt;
  const bool below = ell * dgt <= (t_c - t_a) * B.L;
  float d2[3], wt[3], wl[3];
  const float prof_l = below ? B.L : 0.f;
  const float lat_t = below ? t_a : t_b;
  const float sa[3][4] = {{t_a, 0.f, t_b, B.L + 0.f},
                          {t_a, prof_l, t_b, prof_l},
                          {lat_t, 0.f, lat_t, B.L + 0.f}};
  for (int k = 0; k < 3; ++k) {
    const float axp = sa[k][0], ayp = sa[k][1];
    const float dx_ = sa[k][2] - axp, dy_ = sa[k][3] - ayp;
    const float ss = clip(((t_c - axp) * dx_ + (ell - ayp) * dy_) /
                              fmaxf(dx_ * dx_ + dy_ * dy_, 1e-12f),
                          0.f, 1.f);
    wt[k] = axp + dx_ * ss;
    wl[k] = ayp + dy_ * ss;
    d2[k] = sq(t_c - wt[k]) + sq(ell - wl[k]);
  }
  const bool prof_best = (d2[1] <= d2[0]) & (d2[1] <= d2[2]);
  const float d2_p = fminf(d2[0], fminf(d2[1], d2[2]));
  const bool dg_la = d2[0] <= d2[2];
  const float t_w = prof_best ? wt[1] : (dg_la ? wt[0] : wt[2]);
  const float ell_w = prof_best ? wl[1] : (dg_la ? wl[0] : wl[2]);
  const float dist_p = sqrtf(perp2 + d2_p);
  const float pdw = w_q - (B.w0 + B.tw * ell_w);
  const float pdt = t_q - t_w;
  const float pdz = pz - (B.z0 + B.tz * ell_w);
  const float pinv = 1.0f / fmaxf(dist_p, 1e-6f);
  const bool not_flat = (below & !B.hi_flat) | (!below & !B.lo_flat);
  const bool p_raw = prof_best & not_flat & (dist_p > 1e-6f);
  const V3 pn = unfold(S, p_raw ? pdw * pinv : fn_w,
                       p_raw ? pdt * pinv : 0.f,
                       p_raw ? pdz * pinv : fn_z, sx, sy);
  const float gap_p = face_ok ? dist_p - radius : 1e9f;
  if (gap_p < bg) visit(base + 2 * NB, pn, gap_p);
  // the mirrored quad across the nearest lateral seam
  const float gap_m = gap_lat < bg ? gap_p : 1e9f;
  if (gap_m < bg) visit(base + 3 * NB, pn, gap_m);
}

// Goal-box rectangle r: the closest-point row and the nearest seam row.
// Both gaps are at least the distance to the rectangle minus the radius
// (the seam row is only live inside the rectangle's extents), which is
// the cull.
template <class F>
__device__ void sphere_rect(const SphereQ& q, int r, F& visit) {
  const float coords[3] = {q.ax, q.ay, q.p.z};
  const float radius = q.radius, bg = q.bg, sx = q.sx, sy = q.sy;
  const Rect& R = RECTS[r];
  const float w_q = coords[R.axis] - R.value;
  const float u_q = coords[R.ua], v_q = coords[R.va];
  const float du = u_q - clip(u_q, R.ulo, R.uhi);
  const float dv = v_q - clip(v_q, R.vlo, R.vhi);
  const float dist = sqrtf(w_q * w_q + du * du + dv * dv);
  if (dist - radius >= bg + CULL_SLACK) return;
  const float sgn = w_q * R.nsign >= 0.f ? R.nsign : -R.nsign;
  float c[3];
  if (R.mouth >= 0) {
    const bool at_mouth = R.ua == R.mouth ? (u_q < R.ulo) : (v_q < R.vlo);
    const float inv = 1.0f / fmaxf(dist, 1e-6f);
    const bool use_delta = at_mouth & (dist > 1e-6f);
    c[R.axis] = use_delta ? w_q * inv : sgn;
    c[R.ua] = use_delta ? du * inv : 0.f;
    c[R.va] = use_delta ? dv * inv : 0.f;
  } else {
    c[R.axis] = sgn;
    c[R.ua] = c[R.va] = 0.f;
  }
  const float gap = dist - radius;
  if (gap < bg) visit(228 + 2 * r, v3(c[0] * sx, c[1] * sy, c[2]), gap);

  const bool in_u = R.ua == 0 ? (u_q < R.uhi) : ((u_q > R.ulo) & (u_q < R.uhi));
  const bool in_v = R.va == 0 ? (v_q < R.vhi) : ((v_q > R.vlo) & (v_q < R.vhi));
  float d_seam = 1e9f;
  for (int k = 0; k < 2; ++k) {
    const int aid = k == 0 ? R.ua : R.va;
    const float o = SEAM_O[aid], s = SEAM_S[aid], qq = coords[aid];
    d_seam = fminf(d_seam, fabsf(qq - (o + s * rintf((qq - o) / s))));
  }
  const float gap_s =
      (in_u & in_v) ? sqrtf(w_q * w_q + d_seam * d_seam) - radius : 1e9f;
  float f[3];
  f[R.axis] = sgn;
  f[R.ua] = f[R.va] = 0.f;
  if (gap_s < bg) visit(229 + 2 * r, v3(f[0] * sx, f[1] * sy, f[2]), gap_s);
}

// Sphere vs one horizontal sheet (facet_arena.sheet_sphere_contacts): the 4
// rows' (witness x, y, gap); the normal is (0, 0, up_sign).
__device__ __forceinline__ void sheet_sphere(V3 p, float radius, float z0,
                                             float up, float cx[4],
                                             float cy[4], float gap[4]) {
  const float h = up * (p.z - z0);
  const float ox = floorf(p.x / SHEET_CELL) * SHEET_CELL;
  const float oy = floorf(p.y / SHEET_CELL) * SHEET_CELL;
  const float fx = p.x - ox, fy = p.y - oy;
  const float xs = fx < SHEET_HALF ? ox : ox + SHEET_CELL;
  const float ys = fy < SHEET_HALF ? oy : oy + SHEET_CELL;
  const float h2 = h * h;
  gap[0] = fabsf(h) - radius;
  cx[0] = p.x; cy[0] = p.y;
  const float d_diag = fabsf(fx - fy) * INV_SQRT2;
  const float t_d = (fx + fy) * 0.5f;
  gap[1] = sqrtf(h2 + d_diag * d_diag) - radius;
  cx[1] = ox + t_d; cy[1] = oy + t_d;
  const float d_x = fabsf(p.x - xs);
  gap[2] = sqrtf(h2 + d_x * d_x) - radius;
  cx[2] = xs; cy[2] = p.y;
  const float d_y = fabsf(p.y - ys);
  gap[3] = sqrtf(h2 + d_y * d_y) - radius;
  cx[3] = p.x; cy[3] = ys;
}

// Every sheet row's gap is at least the centre's height above the sheet
// minus the radius.
__device__ __forceinline__ bool sheet_sphere_dead(V3 p, float radius,
                                                  float bg, float z0,
                                                  float up) {
  return fabsf(up * (p.z - z0)) - radius >= bg + CULL_SLACK;
}

// Inside the sheet's octagon clip at inset - eps (facet_arena.sheet_clip_ok);
// ``lim`` = -inset + eps.
__device__ __forceinline__ bool sheet_clip_ok(const Tables& T, float cx,
                                              float cy, float lim) {
  const float ax = cx * (cx >= 0.f ? 1.f : -1.f);
  const float ay = cy * (cy >= 0.f ? 1.f : -1.f);
  bool ok = true;
  for (int s = 0; s < NSIDE; ++s) ok = ok & (side_w(side_of(T, s), ax, ay) <= lim);
  return ok;
}

// ---------------------------------------------------------------------------
// Box (facet_arena.box_contacts, _box_support).  ``pc`` the box centre,
// ``R`` its rotation, ``hc`` the core half extents (he - margin), ``he``
// the half extents.  visit(idx, n, pa, dist) for every live row.

struct BoxQ {
  V3 pc;
  M3 R;
  const float *he, *hc;
  float dist_m, brk, sx, sy, ax, ay;
  float rc, rf;  // bounding radii of the core box and of the box
};
__device__ __forceinline__ BoxQ box_q(V3 pc, const M3& R, const float* he,
                                      const float* hc, float dist_m,
                                      float brk) {
  BoxQ q;
  q.pc = pc; q.R = R; q.he = he; q.hc = hc; q.dist_m = dist_m; q.brk = brk;
  q.sx = fold_sign(pc.x); q.sy = fold_sign(pc.y);
  q.ax = pc.x * q.sx; q.ay = pc.y * q.sy;
  q.rc = sqrtf(hc[0] * hc[0] + hc[1] * hc[1] + hc[2] * hc[2]);
  q.rf = sqrtf(he[0] * he[0] + he[1] * he[1] + he[2] * he[2]);
  return q;
}

// A band's rows are all dead for the box when either
// - the core corners' band-plane heights h_i, which equal the centre's
//   |s_d| minus at most the core support radius along the band normal,
//   all reach brk + dist_m: the face row needs h_sup - dist_m < brk, the
//   lateral duplicate needs the face row, and a seam row's distance is at
//   least its corner's h > 0; or
// - the centre is farther from the band's profile segment (in the side's
//   (w, z) plane) than any live row allows: the face row's support corner
//   lies within 1 uu of the segment along it (in_prof) and within
//   max(core radius, brk + dist_m) across it (h_sup >= -support radius),
//   a seam row's corner within brk + dist_m of the segment's end, and
//   every corner within the core radius of the centre.
__device__ __forceinline__ bool box_band_dead(const Tables& T,
                                              const Extent& X,
                                              const BoxQ& q, int side,
                                              int b) {
  const Side S = side_of(T, side);
  const float w_q = side_w(S, q.ax, q.ay), pz = q.pc.z;
  const float seg_reach =
      q.rc + 1.0f + fmaxf(q.rc, q.brk + q.dist_m) + CULL_SLACK;
  if (side_out_of_reach(X, w_q, seg_reach)) return true;
  const float nw = T.band[BNW][b], nz = T.band[BNZ][b];
  const float s_d = (w_q - T.band[BW0][b]) * nw + (pz - T.band[BZ0][b]) * nz;
  // the band normal unfolded into the world by the centre's signs
  const float mx = S.nx * nw * q.sx, my = S.ny * nw * q.sy, mz = nz;
  float r_sup = 0.f;
  for (int j = 0; j < 3; ++j)
    r_sup = r_sup + q.hc[j] * fabsf(mx * q.R.m[0][j] + my * q.R.m[1][j] +
                                    mz * q.R.m[2][j]);
  const float reach = q.brk + q.dist_m;
  if (fabsf(s_d) - r_sup >= reach + CULL_SLACK) return true;
  return band_seg_dist(T, b, w_q, pz) >= seg_reach;
}

template <class F>
__device__ void box_band(const Tables& T, const BoxQ& q, int side, int b,
                         F& visit) {
  const V3 pc = q.pc;
  const M3& R = q.R;
  const float* hc = q.hc;
  const float sx = q.sx, sy = q.sy, pz = pc.z;
  const float dist_m = q.dist_m, brk = q.brk;
  V3 cw[8];
  for (int i = 0; i < 8; ++i) {
    const float lx = (i & 4) ? hc[0] : -hc[0];
    const float ly = (i & 2) ? hc[1] : -hc[1];
    const float lz = (i & 1) ? hc[2] : -hc[2];
    cw[i] = v3(pc.x + R.m[0][0] * lx + R.m[0][1] * ly + R.m[0][2] * lz,
               pc.y + R.m[1][0] * lx + R.m[1][1] * ly + R.m[1][2] * lz,
               pc.z + R.m[2][0] * lx + R.m[2][1] * ly + R.m[2][2] * lz);
  }
  const Side S = side_of(T, side);
  const float w_q = side_w(S, q.ax, q.ay);
  float caw[8], ct[8];
  for (int i = 0; i < 8; ++i) {
    caw[i] = side_w(S, cw[i].x * sx, cw[i].y * sy);
    ct[i] = side_t(S, cw[i].x * sx, cw[i].y * sy);
  }
  const Band B = band_of(T, side, b);
  const float s_d = (w_q - B.w0) * B.nw + (pz - B.z0) * B.nz;
  const float sgn = s_d >= 0.f ? 1.f : -1.f;
  const float fnw = B.nw * sgn, fnz = B.nz * sgn;
  const V3 n = unfold(S, fnw, 0.f, fnz, sx, sy);

  float h[8], ell[8];
  float h_sup = 0.f, t_sup = 0.f, ell_sup = 0.f;
  V3 c_s = vzero();
  float d_top = 0.f, t_top = 0.f, htop = 0.f, elltop = 0.f;
  float d_bot = 0.f, t_bot = 0.f, hbot = 0.f, ellbot = 0.f;
  for (int i = 0; i < 8; ++i) {
    h[i] = sgn * ((caw[i] - B.w0) * B.nw + (cw[i].z - B.z0) * B.nz);
    ell[i] = (caw[i] - B.w0) * B.tw + (cw[i].z - B.z0) * B.tz;
    const float dti = sqrtf(sq(ell[i] - B.L) + h[i] * h[i]);
    const float dbi = sqrtf(ell[i] * ell[i] + h[i] * h[i]);
    if (i == 0) {
      h_sup = h[0]; t_sup = ct[0]; ell_sup = ell[0]; c_s = cw[0];
      d_top = dti; t_top = ct[0]; htop = h[0]; elltop = ell[0];
      d_bot = dbi; t_bot = ct[0]; hbot = h[0]; ellbot = ell[0];
    } else {
      if (h[i] < h_sup) {
        t_sup = ct[i]; ell_sup = ell[i]; c_s = cw[i];
      }
      h_sup = fminf(h[i], h_sup);
      if (dti < d_top) { t_top = ct[i]; htop = h[i]; elltop = ell[i]; }
      d_top = fminf(dti, d_top);
      if (dbi < d_bot) { t_bot = ct[i]; hbot = h[i]; ellbot = ell[i]; }
      d_bot = fminf(dbi, d_bot);
    }
  }
  const int base = side * 4 * NB + b;

  // face row
  const float dist_f = h_sup - dist_m;
  const float w_c = B.w0 + B.tw * clip(ell_sup, 0.f, B.L);
  const float t_lo = S.lo0 - S.loS * w_c;
  const float t_hi = S.hi0 - S.hiS * w_c;
  const bool in_prof = (ell_sup >= -1.0f) & (ell_sup <= B.L + 1.0f);
  const bool in_lat = (t_sup >= t_lo - 1.0f) & (t_sup <= t_hi + 1.0f);
  const float cut = B.cut_t0 - B.cut_ts * w_c;
  const bool act_f = (dist_f < brk) & in_prof & in_lat &
                     !(B.has_cut & (fabsf(t_sup) < cut - 1.0f));
  if (act_f) visit(base, n, c_s - n * dist_m, dist_f);

  // lateral u-break duplicate
  const float span = t_hi - t_lo;
  const float u_frac = clip((t_sup - t_lo) / span, 0.f, 1.f);
  float t_s = t_lo + span * (rintf(u_frac * (float)NLEN) / (float)NLEN);
  if (side == 2) {
    const float d_post = fabsf(fabsf(t_sup) - GOAL_HW);
    const float t_post = signf(t_sup) * GOAL_HW;
    t_s = d_post < fabsf(t_sup - t_s) ? t_post : t_s;
  }
  const bool side_of_s = t_sup >= t_s;
  float dmin_R = 1e9f, t_R = t_sup, ell_R = ell_sup;
  float d_seam = 1e9f, ell_sm = ell_sup;
  for (int i = 0; i < 8; ++i) {
    const float hh = ((ct[i] >= t_s) != side_of_s) ? h[i] : 1e9f;
    if (hh < dmin_R) { t_R = ct[i]; ell_R = ell[i]; }
    dmin_R = fminf(hh, dmin_R);
    const float ds = sqrtf(sq(ct[i] - t_s) + h[i] * h[i]);
    if (ds < d_seam) ell_sm = ell[i];
    d_seam = fminf(ds, d_seam);
  }
  const bool overlap_R = dmin_R < 0.f;
  const bool use_corner = dmin_R < d_seam;
  const float dist_l = (overlap_R ? h_sup : fminf(dmin_R, d_seam)) - dist_m;
  const float t_wit = overlap_R ? t_s : (use_corner ? t_R : t_s);
  const float ell_wit = clip(
      overlap_R ? ell_sup : (use_corner ? ell_R : ell_sm), 0.f, B.L);
  if ((dist_l < brk) & in_prof & act_f) {
    const float w_s = B.w0 + B.tw * ell_wit;
    const V3 ww = v3((S.nx * (w_s + S.d) + S.ux * t_wit) * sx,
                     (S.ny * (w_s + S.d) + S.uy * t_wit) * sy,
                     B.z0 + B.tz * ell_wit);
    visit(base + NB, n, ww + n * dist_l, dist_l);
  }

  // band-seam rows (top, bottom): raw interpolated edge normals
  for (int k = 0; k < 2; ++k) {
    const float d_sm = k == 0 ? d_top : d_bot;
    const float t_sm = k == 0 ? t_top : t_bot;
    const float h_sm = k == 0 ? htop : hbot;
    const float dl_raw = k == 0 ? elltop - B.L : ellbot;
    const float ell_pos = k == 0 ? B.L : 0.f;
    const bool flat = k == 0 ? B.hi_flat : B.lo_flat;
    const float dist_s = d_sm - dist_m;
    const bool act_s = (dist_s < brk) & !flat & (h_sm > 0.f) &
                       (t_sm >= t_lo - 1.0f) & (t_sm <= t_hi + 1.0f);
    if (!act_s) continue;
    const float w_s = B.w0 + B.tw * ell_pos;
    const float t_w2 = clip(t_sm, t_lo, t_hi);
    const V3 w2 = v3((S.nx * (w_s + S.d) + S.ux * t_w2) * sx,
                     (S.ny * (w_s + S.d) + S.uy * t_w2) * sy,
                     B.z0 + B.tz * ell_pos);
    const float inv = 1.0f / fmaxf(d_sm, 1e-6f);
    const float dl = dl_raw * inv, dh = h_sm * inv;
    const V3 rn = unfold(S, B.tw * dl + fnw * dh, 0.f,
                         B.tz * dl + fnz * dh, sx, sy);
    visit(base + (2 + k) * NB, rn, w2 + rn * dist_s, dist_s);
  }
}

// Goal-box rectangle r: the support point against its plane.  Culled where
// the plane is farther than the box's bounding radius plus brk (the
// support radius along a unit normal is at most |he|), or the centre lies
// farther than that radius outside the extents the support point must
// reach.
template <class F>
__device__ void box_rect(const BoxQ& q, int r, F& visit) {
  const float coords[3] = {q.ax, q.ay, q.pc.z};
  const Rect& G = RECTS[r];
  const float w_q = coords[G.axis] - G.value;
  const float u_q = coords[G.ua], v_q = coords[G.va];
  const float far = q.rf + CULL_SLACK;
  if ((fabsf(w_q) - q.rf >= q.brk + CULL_SLACK) | (u_q < G.ulo_b - far) |
      (u_q > G.uhi_b + far) | (v_q < G.vlo_b - far) | (v_q > G.vhi_b + far))
    return;
  const M3& R = q.R;
  const float* he = q.he;
  const float sx = q.sx, sy = q.sy;
  const float sgn = w_q * G.nsign >= 0.f ? G.nsign : -G.nsign;
  float c[3];
  c[G.axis] = sgn;
  c[G.ua] = c[G.va] = 0.f;
  const V3 n = v3(c[0] * sx * 1.0f, c[1] * sy * 1.0f, c[2] * 1.0f);
  V3 sup = q.pc;
  float r_eff = 0.f;
  for (int j = 0; j < 3; ++j) {
    const V3 a = col(R, j);
    const float d = n.x * a.x + n.y * a.y + n.z * a.z;
    r_eff = r_eff + fabsf(d) * he[j];
    const float s = d >= 0.f ? -he[j] : he[j];
    sup = sup + a * s;
  }
  const float dist = fabsf(w_q) - r_eff;
  const V3 supf = v3(sup.x * sx, sup.y * sy, sup.z);
  const float su = comp(supf, G.ua), sv = comp(supf, G.va);
  if ((dist < q.brk) & (su >= G.ulo_b) & (su <= G.uhi_b) & (sv >= G.vlo_b) &
      (sv <= G.vhi_b))
    visit(228 + r, n, sup, dist);
}

// The box's 12 edges as corner pairs, in facet_arena.SHEET_EDGES order.
__device__ const unsigned char EDGE_I[12] = {0, 0, 0, 1, 1, 2, 2, 3, 4, 4, 5, 6};
__device__ const unsigned char EDGE_J[12] = {4, 2, 1, 5, 3, 6, 3, 7, 6, 5, 7, 7};

// Closest pair between segment [a, b] (heights ah, bh) and the line
// q0 + t (ux, uy) in the sheet plane (facet_arena._seg_line_closest).
__device__ __forceinline__ float seg_line(float ax, float ay, float ah,
                                          float bx, float by, float bh,
                                          float q0x, float q0y, float ux,
                                          float uy, float& cx, float& cy) {
  const float dx = bx - ax, dy = by - ay, dh = bh - ah;
  const float wx = ax - q0x, wy = ay - q0y;
  const float b = dx * ux + dy * uy;
  const float e = wx * ux + wy * uy;
  const float rx = dx - b * ux, ry = dy - b * uy, rh = dh;
  const float vx = wx - e * ux, vy = wy - e * uy, vh = ah;
  const float denom = rx * rx + ry * ry + rh * rh;
  float s = denom > 1e-12f ? -(vx * rx + vy * ry + vh * rh) /
                                 fmaxf(denom, 1e-12f)
                           : 0.f;
  s = clip(s, 0.f, 1.f);
  const float t = e + s * b;
  cx = q0x + t * ux;
  cy = q0y + t * uy;
  const float px_ = ax + s * dx, py_ = ay + s * dy, ph_ = ah + s * dh;
  return sqrtf(sq(px_ - cx) + sq(py_ - cy) + ph_ * ph_);
}

// Box vs one horizontal sheet (facet_arena.sheet_box_contacts): 4 rows of
// (witness cx, cy on the sheet, dist).  ``pos`` the car's position,
// ``off`` the hitbox offset, ``hc`` the core half extents, ``core_local``
// the 8 core corners in the car frame (offset + signs * hc).
__device__ __forceinline__ void sheet_box(V3 pos, const M3& R,
                                          const float* off, const float* hc,
                                          const float (*core_local)[3],
                                          float z0, float up, float dist_m,
                                          float cxo[4], float cyo[4],
                                          float dist[4]) {
  V3 sup = pos;
  for (int j = 0; j < 3; ++j) {
    const V3 a = col(R, j);
    sup = sup + a * off[j];
    const float s = -(up * a.z) >= 0.f ? hc[j] : -hc[j];
    sup = sup + a * s;
  }
  const float h_sup = up * (sup.z - z0);
  float cx[8], cy[8], ch[8];
  for (int i = 0; i < 8; ++i) {
    const float* l = core_local[i];
    cx[i] = pos.x + R.m[0][0] * l[0] + R.m[0][1] * l[1] + R.m[0][2] * l[2];
    cy[i] = pos.y + R.m[1][0] * l[0] + R.m[1][1] * l[1] + R.m[1][2] * l[2];
    ch[i] = up * ((pos.z + R.m[2][0] * l[0] + R.m[2][1] * l[1] +
                   R.m[2][2] * l[2]) - z0);
  }
  const float ox = floorf(sup.x / SHEET_CELL) * SHEET_CELL;
  const float oy = floorf(sup.y / SHEET_CELL) * SHEET_CELL;
  const float fx = sup.x - ox, fy = sup.y - oy;
  const float xs = fx < SHEET_HALF ? ox : ox + SHEET_CELL;
  const float ys = fy < SHEET_HALF ? oy : oy + SHEET_CELL;
  const bool sup_lower = (fx - fy) >= 0.f;
  const bool sup_right = sup.x >= xs, sup_above = sup.y >= ys;

  dist[0] = h_sup - dist_m;
  cxo[0] = sup.x;
  cyo[0] = sup.y;
  const float td = ((sup.x - ox) + (sup.y - oy)) * 0.5f;
  for (int r = 1; r < 4; ++r) {
    float q0x, q0y, ux, uy, clx, cly;
    if (r == 1) {
      q0x = ox; q0y = oy; ux = INV_SQRT2; uy = INV_SQRT2;
      clx = ox + td; cly = oy + td;
    } else if (r == 2) {
      q0x = xs; q0y = oy; ux = 0.f + 0.f; uy = 1.0f;
      clx = xs; cly = sup.y;
    } else {
      q0x = ox; q0y = ys; ux = 1.0f; uy = 0.f + 0.f;
      clx = sup.x; cly = ys;
    }
    float dmin = INFINITY, wx_c = 0.f, wy_c = 0.f;
    for (int i = 0; i < 8; ++i) {
      bool inside;
      if (r == 1) inside = (((cx[i] - ox) - (cy[i] - oy)) >= 0.f) != sup_lower;
      else if (r == 2) inside = (cx[i] >= xs) != sup_right;
      else inside = (cy[i] >= ys) != sup_above;
      if (inside & (ch[i] < dmin)) {
        dmin = ch[i]; wx_c = cx[i]; wy_c = cy[i];
      }
    }
    float d_seam = INFINITY, sx_w = 0.f, sy_w = 0.f;
    for (int e = 0; e < 12; ++e) {
      const int i = EDGE_I[e], j = EDGE_J[e];
      float ex, ey;
      const float ed = seg_line(cx[i], cy[i], ch[i], cx[j], cy[j], ch[j],
                                q0x, q0y, ux, uy, ex, ey);
      if (ed < d_seam) { d_seam = ed; sx_w = ex; sy_w = ey; }
    }
    const bool overlap = dmin < 0.f;
    const bool use_corner = dmin < d_seam;
    dist[r] = (overlap ? h_sup : fminf(dmin, d_seam)) - dist_m;
    cxo[r] = overlap ? clx : (use_corner ? wx_c : sx_w);
    cyo[r] = overlap ? cly : (use_corner ? wy_c : sy_w);
  }
}

// Every sheet row's distance is at least the lowest core corner's height
// above the sheet minus dist_m: the core centre's height minus the core
// support radius along the vertical.
__device__ __forceinline__ bool sheet_box_dead(V3 pos, const M3& R,
                                               const float* off,
                                               const float* hc, float z0,
                                               float up, float dist_m,
                                               float brk) {
  const float cz = pos.z + R.m[2][0] * off[0] + R.m[2][1] * off[1] +
                   R.m[2][2] * off[2];
  const float r = hc[0] * fabsf(R.m[2][0]) + hc[1] * fabsf(R.m[2][1]) +
                  hc[2] * fabsf(R.m[2][2]);
  return up * (cz - z0) - r - dist_m >= brk + CULL_SLACK;
}

// ---------------------------------------------------------------------------
// Rays (facet_arena.raycasts): the nearest facet hit within max_len; out of
// line, like the other full-fidelity solvers.

static __device__ __noinline__ void raycast(const Tables& T,
                                            const Extent& X, V3 o, V3 d,
                                            float max_len, bool& hit,
                                            float& dist, V3& n) {
  const float sx = fold_sign(o.x), sy = fold_sign(o.y);
  const float ax = o.x * sx, ay = o.y * sy;
  const float adx = d.x * sx, ady = d.y * sy;
  float best = INFINITY;
  n = vzero();
#pragma unroll 1
  for (int side = 0; side < NSIDE; ++side) {
    const Side S = side_of(T, side);
    const float w_o = side_w(S, ax, ay), t_o = side_t(S, ax, ay);
    const float reach = max_len + 0.5f + CULL_SLACK;
    // every band of the side out of reach (the band test below, for all)
    if (side_out_of_reach(X, w_o, reach)) continue;
    const float w_d = S.nx * adx + S.ny * ady;
    const float t_d = S.ux * adx + S.uy * ady;
    float side_best = INFINITY;
    V3 side_n = vzero();
    bool first = true;
#pragma unroll 1
    for (int b = 0; b < NB; ++b) {
      // a hit lies within 0.5 uu of the band's segment (in the side's
      // (w, z) plane) and within max_len of the origin: no band farther
      // can be hit; skipping it keeps the first band of the arg-min
      if (band_seg_dist(T, b, w_o, o.z) > reach) continue;
      const Band B = band_of(T, side, b);
      const float denom = w_d * B.nw + d.z * B.nz;
      const float s_o = (w_o - B.w0) * B.nw + (o.z - B.z0) * B.nz;
      const float safe = fabsf(denom) < 1e-9f ? 1e-9f : denom;
      float t_hit = -s_o / safe;
      const float w_h = w_o + w_d * t_hit;
      const float t_h = t_o + t_d * t_hit;
      const float z_h = o.z + d.z * t_hit;
      const float ell = (w_h - B.w0) * B.tw + (z_h - B.z0) * B.tz;
      const float t_lo = S.lo0 - S.loS * w_h;
      const float t_hi = S.hi0 - S.hiS * w_h;
      const float cut = B.cut_t0 - B.cut_ts * w_h;
      const bool ok = (fabsf(denom) > 1e-9f) & (ell >= -0.5f) &
                      (ell <= B.L + 0.5f) & (t_h >= t_lo - 0.5f) &
                      (t_h <= t_hi + 0.5f) &
                      !(B.has_cut & (fabsf(t_h) < cut - 0.5f));
      t_hit = (ok & (t_hit >= 0.f) & (t_hit <= max_len)) ? t_hit : INFINITY;
      // the band arg-min (first band on ties) keeps band 0's normal when
      // no band hits
      if (first || t_hit < side_best) {
        const float flip = denom > 0.f ? -1.f : 1.f;
        side_n = unfold(S, B.nw * flip, 0.f, B.nz * flip, sx, sy);
        side_best = t_hit;
        first = false;
      }
    }
    if (side_best < best) { best = side_best; n = side_n; }
  }
  const float co[3] = {ax, ay, o.z}, cd[3] = {adx, ady, d.z};
#pragma unroll 1
  for (int r = 0; r < 4; ++r) {
    const Rect& G = RECTS[r];
    // a hit lies on the rectangle widened by 0.5 uu, within max_len
    const float du = co[G.ua] - clip(co[G.ua], G.ulo_r, G.uhi_r);
    const float dv = co[G.va] - clip(co[G.va], G.vlo_r, G.vhi_r);
    const float dw = co[G.axis] - G.value;
    if (sqrtf(dw * dw + du * du + dv * dv) > max_len + CULL_SLACK) continue;
    const float denom = cd[G.axis];
    const float safe = fabsf(denom) < 1e-9f ? 1e-9f : denom;
    float t_hit = (G.value - co[G.axis]) / safe;
    const float u_h = co[G.ua] + cd[G.ua] * t_hit;
    const float v_h = co[G.va] + cd[G.va] * t_hit;
    const bool ok = (fabsf(denom) > 1e-9f) & (u_h >= G.ulo_r) &
                    (u_h <= G.uhi_r) & (v_h >= G.vlo_r) & (v_h <= G.vhi_r);
    t_hit = (ok & (t_hit >= 0.f) & (t_hit <= max_len)) ? t_hit : INFINITY;
    if (t_hit < best) {
      float c[3];
      c[G.axis] = denom > 0.f ? -1.f : 1.f;
      c[G.ua] = c[G.va] = 0.f;
      n = v3(c[0] * sx, c[1] * sy, c[2]);
      best = t_hit;
    }
  }
  hit = isfinite(best);
  dist = hit ? best : max_len;
}

}  // namespace facets
