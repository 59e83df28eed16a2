// Marching tetrahedra iso-surface extraction (C ABI, ctypes-loaded).
//
// A copy of regen3d_tpu/native/marching.cpp for the PyTorch port, which
// builds it on its own (regen3d_tpu_torch/ops/marching_cubes.py).
// Replacement for the reference's octree marching-cubes shape decode
// (Hunyuan3D-2 pipeline, src/2d_to_3d_models/run.py:77-84): the SDF or
// indicator grid is evaluated on the device; this host-side pass extracts
// the triangle mesh. Tetrahedral decomposition
// (6 tets/cube) needs no 256-entry case tables and yields watertight,
// consistently-oriented surfaces.
//
// Interface (two-phase to keep the ABI allocation-free):
//   mt_extract(sdf, nx, ny, nz, iso) -> handle; fills internal buffers
//   mt_counts(handle, &nv, &nt)
//   mt_fetch(handle, verts_out, tris_out); mt_free(handle)
// Vertices are welded on shared cube edges via a hash map, so the mesh is
// indexed (not a triangle soup). Grid index convention: sdf[z][y][x]
// (z-major, matching decode_grid), vertex coords in grid units.

#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct MeshBuf {
  std::vector<float> verts;   // xyz triples (grid units)
  std::vector<int32_t> tris;  // index triples
};

// Edge key: the two grid-vertex linear ids, packed (smaller first).
inline uint64_t edge_key(uint64_t a, uint64_t b) {
  if (a > b) std::swap(a, b);
  return (a << 32) | b;
}

struct Extractor {
  const float* sdf;
  int64_t nx, ny, nz;
  float iso;
  MeshBuf out;
  std::unordered_map<uint64_t, int32_t> edge_cache;

  inline float val(int64_t x, int64_t y, int64_t z) const {
    return sdf[(z * ny + y) * nx + x];
  }
  inline uint64_t vid(int64_t x, int64_t y, int64_t z) const {
    return (z * ny + y) * nx + x;
  }

  int32_t edge_vertex(const int64_t a[3], const int64_t b[3]) {
    uint64_t key = edge_key(vid(a[0], a[1], a[2]), vid(b[0], b[1], b[2]));
    auto it = edge_cache.find(key);
    if (it != edge_cache.end()) return it->second;
    float va = val(a[0], a[1], a[2]);
    float vb = val(b[0], b[1], b[2]);
    float denom = vb - va;
    float t = denom == 0.0f ? 0.5f : (iso - va) / denom;
    if (t < 0.f) t = 0.f;
    if (t > 1.f) t = 1.f;
    int32_t idx = static_cast<int32_t>(out.verts.size() / 3);
    out.verts.push_back(static_cast<float>(a[0]) + t * (b[0] - a[0]));
    out.verts.push_back(static_cast<float>(a[1]) + t * (b[1] - a[1]));
    out.verts.push_back(static_cast<float>(a[2]) + t * (b[2] - a[2]));
    edge_cache.emplace(key, idx);
    return idx;
  }

  // Emit a triangle wound so its normal aligns with `dir` (inside→outside).
  void emit_oriented(int32_t i0, int32_t i1, int32_t i2, const float dir[3]) {
    const float* a = &out.verts[3 * i0];
    const float* b = &out.verts[3 * i1];
    const float* c = &out.verts[3 * i2];
    float e1[3] = {b[0] - a[0], b[1] - a[1], b[2] - a[2]};
    float e2[3] = {c[0] - a[0], c[1] - a[1], c[2] - a[2]};
    float n[3] = {e1[1] * e2[2] - e1[2] * e2[1],
                  e1[2] * e2[0] - e1[0] * e2[2],
                  e1[0] * e2[1] - e1[1] * e2[0]};
    float d = n[0] * dir[0] + n[1] * dir[1] + n[2] * dir[2];
    if (d < 0.0f) std::swap(i1, i2);
    out.tris.push_back(i0);
    out.tris.push_back(i1);
    out.tris.push_back(i2);
  }

  // Process one tetrahedron given its 4 grid-corner coords. Winding is
  // resolved geometrically — normals aligned with the inside→outside corner
  // centroid direction — so no hand-derived per-case orientation tables.
  void tet(const int64_t p[4][3]) {
    float v[4];
    for (int i = 0; i < 4; ++i) v[i] = val(p[i][0], p[i][1], p[i][2]);
    int in_ids[4], out_ids[4];
    int n_in = 0, n_out = 0;
    for (int i = 0; i < 4; ++i) {
      if (v[i] < iso)
        in_ids[n_in++] = i;
      else
        out_ids[n_out++] = i;
    }
    if (n_in == 0 || n_in == 4) return;

    float cin[3] = {0, 0, 0}, cout[3] = {0, 0, 0};
    for (int i = 0; i < n_in; ++i)
      for (int d = 0; d < 3; ++d) cin[d] += p[in_ids[i]][d] / float(n_in);
    for (int i = 0; i < n_out; ++i)
      for (int d = 0; d < 3; ++d) cout[d] += p[out_ids[i]][d] / float(n_out);
    float dir[3] = {cout[0] - cin[0], cout[1] - cin[1], cout[2] - cin[2]};

    if (n_in == 1 || n_in == 3) {
      int apex = (n_in == 1) ? in_ids[0] : out_ids[0];
      const int* others = (n_in == 1) ? out_ids : in_ids;
      int32_t e0 = edge_vertex(p[apex], p[others[0]]);
      int32_t e1 = edge_vertex(p[apex], p[others[1]]);
      int32_t e2 = edge_vertex(p[apex], p[others[2]]);
      emit_oriented(e0, e1, e2, dir);
    } else {  // 2 in / 2 out: quad split into two triangles
      int i = in_ids[0], j = in_ids[1], k = out_ids[0], l = out_ids[1];
      int32_t ik = edge_vertex(p[i], p[k]);
      int32_t il = edge_vertex(p[i], p[l]);
      int32_t jk = edge_vertex(p[j], p[k]);
      int32_t jl = edge_vertex(p[j], p[l]);
      emit_oriented(ik, jk, jl, dir);
      emit_oriented(ik, jl, il, dir);
    }
  }

  void run() {
    // 6-tet decomposition of each cube around the main diagonal (0,0,0)-(1,1,1)
    static const int tets[6][4][3] = {
        {{0, 0, 0}, {1, 0, 0}, {1, 1, 0}, {1, 1, 1}},
        {{0, 0, 0}, {1, 1, 0}, {0, 1, 0}, {1, 1, 1}},
        {{0, 0, 0}, {0, 1, 0}, {0, 1, 1}, {1, 1, 1}},
        {{0, 0, 0}, {0, 1, 1}, {0, 0, 1}, {1, 1, 1}},
        {{0, 0, 0}, {0, 0, 1}, {1, 0, 1}, {1, 1, 1}},
        {{0, 0, 0}, {1, 0, 1}, {1, 0, 0}, {1, 1, 1}},
    };
    for (int64_t z = 0; z + 1 < nz; ++z)
      for (int64_t y = 0; y + 1 < ny; ++y)
        for (int64_t x = 0; x + 1 < nx; ++x) {
          // cube-level early out
          bool any_in = false, any_out = false;
          for (int dz = 0; dz < 2; ++dz)
            for (int dy = 0; dy < 2; ++dy)
              for (int dx = 0; dx < 2; ++dx) {
                (val(x + dx, y + dy, z + dz) < iso ? any_in : any_out) = true;
              }
          if (!any_in || !any_out) continue;
          for (auto& t : tets) {
            int64_t p[4][3];
            for (int i = 0; i < 4; ++i) {
              p[i][0] = x + t[i][0];
              p[i][1] = y + t[i][1];
              p[i][2] = z + t[i][2];
            }
            tet(p);
          }
        }
  }
};

}  // namespace

extern "C" {

void* mt_extract(const float* sdf, int64_t nx, int64_t ny, int64_t nz,
                 float iso) {
  auto* ex = new Extractor{sdf, nx, ny, nz, iso, {}, {}};
  ex->run();
  return ex;
}

void mt_counts(void* handle, int64_t* nv, int64_t* nt) {
  auto* ex = static_cast<Extractor*>(handle);
  *nv = static_cast<int64_t>(ex->out.verts.size() / 3);
  *nt = static_cast<int64_t>(ex->out.tris.size() / 3);
}

void mt_fetch(void* handle, float* verts, int32_t* tris) {
  auto* ex = static_cast<Extractor*>(handle);
  std::memcpy(verts, ex->out.verts.data(), ex->out.verts.size() * sizeof(float));
  std::memcpy(tris, ex->out.tris.data(), ex->out.tris.size() * sizeof(int32_t));
}

void mt_free(void* handle) { delete static_cast<Extractor*>(handle); }

}  // extern "C"
