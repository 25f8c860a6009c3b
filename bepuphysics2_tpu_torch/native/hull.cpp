// Native convex hull builder: the engine's own quickhull, so the host-side shape pipeline
// depends on no third-party hull code. The same builder as the JAX package's
// bepuphysics2_tpu/native/src/hull.cpp, kept here so that the PyTorch port imports
// nothing of that package.
//
// Reference parity: BepuPhysics/Collidables/ConvexHullHelper.cs:87 (ComputeHull, the
// reference's own quickhull with face merging), MeshInertiaHelper.cs (tetrahedral inertia).
//
// Exposed C ABI (ctypes):
//   int bepu_quickhull(const double* pts, int n,
//                      int* out_vertex_ids, int* out_nverts,
//                      int* out_tris, int* out_ntris,
//                      double* out_centroid /*3*/, double* out_volume /*1*/);
//     Returns 0 on success, <0 on degenerate input (caller falls back).
//     out_vertex_ids: caller-allocated n ints — indices of hull vertices (unique).
//     out_tris: caller-allocated 3*(2n) ints — CCW (outward) triangles into pts.
//   int bepu_hull_inertia(const double* pts, int n, const int* tris, int ntris,
//                         double mass, double* out_inv_inertia /*6: xx yx yy zx zy zz*/,
//                         double* out_inv_mass /*1*/);
//     Inertia of the uniform-density solid bounded by the triangles about the ORIGIN
//     (recenter points on the volume centroid first), tetrahedral decomposition.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>
#include <array>
#include <algorithm>

namespace {

struct V3 {
  double x, y, z;
  V3 operator-(const V3& o) const { return {x - o.x, y - o.y, z - o.z}; }
  V3 operator+(const V3& o) const { return {x + o.x, y + o.y, z + o.z}; }
  V3 operator*(double s) const { return {x * s, y * s, z * s}; }
};
inline V3 cross(const V3& a, const V3& b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
inline double dot(const V3& a, const V3& b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
inline double norm(const V3& a) { return std::sqrt(dot(a, a)); }

struct Face {
  int a, b, c;       // vertex indices, CCW seen from outside
  V3 normal;         // unit outward normal
  double offset;     // plane offset: dot(normal, p) == offset on the plane
  std::vector<int> outside;  // points strictly outside this face
  bool alive = true;
};

inline V3 pt(const double* pts, int i) { return {pts[3 * i], pts[3 * i + 1], pts[3 * i + 2]}; }

void face_plane(const double* pts, Face& f) {
  V3 a = pt(pts, f.a), b = pt(pts, f.b), c = pt(pts, f.c);
  V3 n = cross(b - a, c - a);
  double l = norm(n);
  f.normal = l > 0 ? n * (1.0 / l) : V3{0, 0, 0};
  f.offset = dot(f.normal, a);
}

struct Edge {
  int u, v;
  bool operator==(const Edge& o) const { return u == o.u && v == o.v; }
};

}  // namespace

extern "C" {

int bepu_quickhull(const double* pts, int n, int* out_vertex_ids, int* out_nverts,
                   int* out_tris, int* out_ntris, double* out_centroid,
                   double* out_volume) {
  if (n < 4) return -1;

  // Scale-aware epsilon (the reference uses a similar planarity epsilon).
  double maxc = 0;
  for (int i = 0; i < 3 * n; i++) maxc = std::max(maxc, std::fabs(pts[i]));
  const double eps = 1e-10 * std::max(1.0, maxc) * 3;

  // --- Initial simplex: extremes on x, then farthest point pair, triangle, tetra.
  int i0 = 0, i1 = 0;
  for (int i = 1; i < n; i++) {
    if (pts[3 * i] < pts[3 * i0]) i0 = i;
    if (pts[3 * i] > pts[3 * i1]) i1 = i;
  }
  if (i0 == i1) {  // all same x; pick extreme y instead
    for (int i = 1; i < n; i++)
      if (pts[3 * i + 1] < pts[3 * i0 + 1]) i0 = i;
    for (int i = 0; i < n; i++)
      if (pts[3 * i + 1] > pts[3 * i1 + 1]) i1 = i;
    if (i0 == i1) return -2;
  }
  V3 p0 = pt(pts, i0), p1 = pt(pts, i1);
  // Farthest from the line p0-p1.
  int i2 = -1;
  double best = eps;
  V3 d01 = p1 - p0;
  for (int i = 0; i < n; i++) {
    double dist = norm(cross(d01, pt(pts, i) - p0));
    if (dist > best) { best = dist; i2 = i; }
  }
  if (i2 < 0) return -3;  // collinear
  V3 p2 = pt(pts, i2);
  // Farthest from the plane (p0,p1,p2).
  V3 nrm = cross(p1 - p0, p2 - p0);
  double ln = norm(nrm);
  if (ln <= 0) return -3;
  nrm = nrm * (1.0 / ln);
  double off = dot(nrm, p0);
  int i3 = -1;
  best = eps;
  for (int i = 0; i < n; i++) {
    double dist = std::fabs(dot(nrm, pt(pts, i)) - off);
    if (dist > best) { best = dist; i3 = i; }
  }
  if (i3 < 0) return -4;  // coplanar
  if (dot(nrm, pt(pts, i3)) - off > 0) std::swap(i1, i2);  // orient tetra outward

  std::vector<Face> faces;
  faces.reserve(4 * (size_t)n);
  auto add_face = [&](int a, int b, int c) -> int {
    Face f;
    f.a = a; f.b = b; f.c = c;
    face_plane(pts, f);
    faces.push_back(std::move(f));
    return (int)faces.size() - 1;
  };
  add_face(i0, i1, i2);
  add_face(i0, i2, i3);
  add_face(i0, i3, i1);
  add_face(i1, i3, i2);

  // Assign every point to the first face it lies outside of.
  for (int i = 0; i < n; i++) {
    if (i == i0 || i == i1 || i == i2 || i == i3) continue;
    for (auto& f : faces) {
      if (dot(f.normal, pt(pts, i)) - f.offset > eps) { f.outside.push_back(i); break; }
    }
  }

  // --- Expansion loop.
  std::vector<int> stack;
  for (int fi = 0; fi < (int)faces.size(); fi++)
    if (!faces[fi].outside.empty()) stack.push_back(fi);

  std::vector<int> visible;
  std::vector<Edge> horizon;
  std::vector<int> orphan;
  size_t guard = 16u * (size_t)n + 64u;

  while (!stack.empty()) {
    if (--guard == 0) return -5;  // non-convergence safeguard (numerical pathology)
    int fi = stack.back();
    stack.pop_back();
    Face& f = faces[fi];
    if (!f.alive || f.outside.empty()) continue;
    // Farthest outside point of this face.
    int far_i = -1;
    double far_d = -1;
    for (int p : f.outside) {
      double d = dot(f.normal, pt(pts, p)) - f.offset;
      if (d > far_d) { far_d = d; far_i = p; }
    }
    V3 eye = pt(pts, far_i);

    // Find all faces visible from the eye (flood fill is unnecessary at these sizes:
    // scan all alive faces — hull shape counts are small for physics colliders).
    visible.clear();
    for (int gi = 0; gi < (int)faces.size(); gi++) {
      Face& g = faces[gi];
      if (g.alive && dot(g.normal, eye) - g.offset > eps) visible.push_back(gi);
    }
    // Horizon = directed edges of visible faces whose reverse edge borders a hidden face.
    horizon.clear();
    orphan.clear();
    auto edge_hidden = [&](int u, int v) {
      for (int gi : visible) {
        Face& g = faces[gi];
        if ((g.a == v && g.b == u) || (g.b == v && g.c == u) || (g.c == v && g.a == u))
          return false;  // reverse edge belongs to a visible face → interior edge
      }
      return true;
    };
    for (int gi : visible) {
      Face& g = faces[gi];
      const int e[3][2] = {{g.a, g.b}, {g.b, g.c}, {g.c, g.a}};
      for (auto& uv : e)
        if (edge_hidden(uv[0], uv[1])) horizon.push_back({uv[0], uv[1]});
      for (int p : g.outside)
        if (p != far_i) orphan.push_back(p);
      g.alive = false;
      g.outside.clear();
    }
    // New fan from the eye over the horizon.
    std::vector<int> fresh;
    for (auto& e : horizon) fresh.push_back(add_face(e.u, e.v, far_i));
    // Re-home orphaned outside points.
    for (int p : orphan) {
      for (int gi : fresh) {
        Face& g = faces[gi];
        if (dot(g.normal, pt(pts, p)) - g.offset > eps) { g.outside.push_back(p); break; }
      }
    }
    for (int gi : fresh)
      if (!faces[gi].outside.empty()) stack.push_back(gi);
  }

  // --- Emit triangles + unique vertices; volume centroid by signed tetrahedra.
  int ntris = 0;
  std::vector<char> used(n, 0);
  double vol6 = 0;
  V3 cent{0, 0, 0};
  for (auto& f : faces) {
    if (!f.alive) continue;
    if (3 * ntris + 2 >= 6 * n) return -6;  // output overflow (cannot happen: 2n-4 faces)
    out_tris[3 * ntris] = f.a;
    out_tris[3 * ntris + 1] = f.b;
    out_tris[3 * ntris + 2] = f.c;
    ntris++;
    used[f.a] = used[f.b] = used[f.c] = 1;
    V3 a = pt(pts, f.a), b = pt(pts, f.b), c = pt(pts, f.c);
    double v = dot(a, cross(b, c));  // 6 * signed tet volume against origin
    vol6 += v;
    cent = cent + (a + b + c) * (v / 4.0);
  }
  int nv = 0;
  for (int i = 0; i < n; i++)
    if (used[i]) out_vertex_ids[nv++] = i;
  *out_nverts = nv;
  *out_ntris = ntris;
  double vol = vol6 / 6.0;
  *out_volume = vol;
  if (std::fabs(vol6) > 1e-30) {
    out_centroid[0] = cent.x / vol6;
    out_centroid[1] = cent.y / vol6;
    out_centroid[2] = cent.z / vol6;
  } else {
    out_centroid[0] = out_centroid[1] = out_centroid[2] = 0;
  }
  return 0;
}

int bepu_hull_inertia(const double* pts, int n, const int* tris, int ntris, double mass,
                      double* out_inv_inertia, double* out_inv_mass) {
  (void)n;
  // Tetrahedral decomposition against the origin; canonical unit-tet covariance
  // (reference MeshInertiaHelper semantics).
  const double C_diag = 1.0 / 60.0, C_off = 1.0 / 120.0;
  double cov[3][3] = {{0, 0, 0}, {0, 0, 0}, {0, 0, 0}};
  double total_v = 0;
  for (int t = 0; t < ntris; t++) {
    V3 a = pt(pts, tris[3 * t]), b = pt(pts, tris[3 * t + 1]), c = pt(pts, tris[3 * t + 2]);
    double A[3][3] = {{a.x, a.y, a.z}, {b.x, b.y, b.z}, {c.x, c.y, c.z}};
    double det = a.x * (b.y * c.z - b.z * c.y) - a.y * (b.x * c.z - b.z * c.x) +
                 a.z * (b.x * c.y - b.y * c.x);
    total_v += det / 6.0;
    // cov += det * A^T * Ccanon * A
    double CA[3][3];
    for (int i = 0; i < 3; i++)
      for (int j = 0; j < 3; j++) {
        double s = 0;
        for (int k = 0; k < 3; k++) s += (i == k ? C_diag : C_off) * A[k][j];
        CA[i][j] = s;
      }
    for (int i = 0; i < 3; i++)
      for (int j = 0; j < 3; j++) {
        double s = 0;
        for (int k = 0; k < 3; k++) s += A[k][i] * CA[k][j];
        cov[i][j] += det * s;
      }
  }
  if (std::fabs(total_v) < 1e-30) return -1;
  double density = mass / total_v;
  double trace = (cov[0][0] + cov[1][1] + cov[2][2]) * density;
  double I[3][3];
  for (int i = 0; i < 3; i++)
    for (int j = 0; j < 3; j++)
      I[i][j] = (i == j ? trace : 0.0) - density * cov[i][j];
  // Invert the symmetric 3x3.
  double det = I[0][0] * (I[1][1] * I[2][2] - I[1][2] * I[2][1]) -
               I[0][1] * (I[1][0] * I[2][2] - I[1][2] * I[2][0]) +
               I[0][2] * (I[1][0] * I[2][1] - I[1][1] * I[2][0]);
  if (std::fabs(det) < 1e-30) return -2;
  double inv = 1.0 / det;
  double xx = (I[1][1] * I[2][2] - I[1][2] * I[2][1]) * inv;
  double yx = -(I[0][1] * I[2][2] - I[0][2] * I[2][1]) * inv;
  double yy = (I[0][0] * I[2][2] - I[0][2] * I[2][0]) * inv;
  double zx = (I[0][1] * I[1][2] - I[0][2] * I[1][1]) * inv;
  double zy = -(I[0][0] * I[1][2] - I[0][2] * I[1][0]) * inv;
  double zz = (I[0][0] * I[1][1] - I[0][1] * I[1][0]) * inv;
  out_inv_inertia[0] = xx;
  out_inv_inertia[1] = yx;
  out_inv_inertia[2] = yy;
  out_inv_inertia[3] = zx;
  out_inv_inertia[4] = zy;
  out_inv_inertia[5] = zz;
  *out_inv_mass = mass > 0 ? 1.0 / mass : 0.0;
  return 0;
}

}  // extern "C"
