// arahx: native host-side geometry ops of the port's data pipeline. The
// port's own copy of `arah_tpu/native/arahx.cpp` (same code, so the same
// results bit for bit; `tests/test_torch_dataset.py` holds the two):
//   * point-in-mesh queries: a 2D triangle hash and +z parity rays;
//   * point->mesh squared distance, closest face and barycentric weights;
//   * marching cubes (classic tables);
//   * z-buffer rasterisation of projected triangles.
// Exposed as a C ABI and loaded with ctypes (`native/__init__.py`).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>
#include <unordered_map>
#include <algorithm>
#include <thread>

extern "C" {

// ---------------------------------------------------------------------------
// 2D triangle hash + z-parity point-in-mesh
// ---------------------------------------------------------------------------

struct TriangleHash {
  std::vector<std::vector<int>> spatial_hash;
  int resolution;
  double bmin[2], bmax[2];
  std::vector<float> verts;   // V*3
  std::vector<int> faces;     // F*3
};

static inline void cell_range(double lo, double hi, double bmin, double inv,
                              int res, int& c0, int& c1) {
  c0 = std::max(0, std::min(res - 1, (int)std::floor((lo - bmin) * inv)));
  c1 = std::max(0, std::min(res - 1, (int)std::floor((hi - bmin) * inv)));
}

void* triangle_hash_build(const float* verts, int n_verts, const int* faces,
                          int n_faces, int resolution) {
  TriangleHash* th = new TriangleHash();
  th->resolution = resolution;
  th->verts.assign(verts, verts + (size_t)n_verts * 3);
  th->faces.assign(faces, faces + (size_t)n_faces * 3);
  th->spatial_hash.resize((size_t)resolution * resolution);

  double bmin[2] = {1e30, 1e30}, bmax[2] = {-1e30, -1e30};
  for (int v = 0; v < n_verts; ++v) {
    for (int k = 0; k < 2; ++k) {
      bmin[k] = std::min(bmin[k], (double)verts[v * 3 + k]);
      bmax[k] = std::max(bmax[k], (double)verts[v * 3 + k]);
    }
  }
  th->bmin[0] = bmin[0]; th->bmin[1] = bmin[1];
  th->bmax[0] = bmax[0]; th->bmax[1] = bmax[1];
  double inv[2] = {resolution / std::max(bmax[0] - bmin[0], 1e-12),
                   resolution / std::max(bmax[1] - bmin[1], 1e-12)};

  for (int f = 0; f < n_faces; ++f) {
    double lo[2] = {1e30, 1e30}, hi[2] = {-1e30, -1e30};
    for (int j = 0; j < 3; ++j) {
      const float* p = verts + (size_t)faces[f * 3 + j] * 3;
      for (int k = 0; k < 2; ++k) {
        lo[k] = std::min(lo[k], (double)p[k]);
        hi[k] = std::max(hi[k], (double)p[k]);
      }
    }
    int x0, x1, y0, y1;
    cell_range(lo[0], hi[0], bmin[0], inv[0], resolution, x0, x1);
    cell_range(lo[1], hi[1], bmin[1], inv[1], resolution, y0, y1);
    for (int x = x0; x <= x1; ++x)
      for (int y = y0; y <= y1; ++y)
        th->spatial_hash[(size_t)x * resolution + y].push_back(f);
  }
  return th;
}

void triangle_hash_free(void* handle) {
  delete reinterpret_cast<TriangleHash*>(handle);
}

// For each query point, count crossings of the +z ray with mesh triangles
// (odd => inside). Robust enough for the watertight SMPL meshes this is
// used on (same assumption as the reference implementation).
void points_inside_mesh(void* handle, const float* points, int n_points,
                        uint8_t* inside) {
  TriangleHash* th = reinterpret_cast<TriangleHash*>(handle);
  int res = th->resolution;
  double inv[2] = {res / std::max(th->bmax[0] - th->bmin[0], 1e-12),
                   res / std::max(th->bmax[1] - th->bmin[1], 1e-12)};
  for (int i = 0; i < n_points; ++i) {
    const float* p = points + (size_t)i * 3;
    inside[i] = 0;
    int cx = (int)std::floor((p[0] - th->bmin[0]) * inv[0]);
    int cy = (int)std::floor((p[1] - th->bmin[1]) * inv[1]);
    if (cx < 0 || cx >= res || cy < 0 || cy >= res) continue;
    int n_cross = 0;
    for (int f : th->spatial_hash[(size_t)cx * res + cy]) {
      const float* a = th->verts.data() + (size_t)th->faces[f * 3 + 0] * 3;
      const float* b = th->verts.data() + (size_t)th->faces[f * 3 + 1] * 3;
      const float* c = th->verts.data() + (size_t)th->faces[f * 3 + 2] * 3;
      // 2D barycentric test in xy
      double v0x = c[0] - a[0], v0y = c[1] - a[1];
      double v1x = b[0] - a[0], v1y = b[1] - a[1];
      double v2x = p[0] - a[0], v2y = p[1] - a[1];
      double d00 = v0x * v0x + v0y * v0y;
      double d01 = v0x * v1x + v0y * v1y;
      double d11 = v1x * v1x + v1y * v1y;
      double d20 = v2x * v0x + v2y * v0y;
      double d21 = v2x * v1x + v2y * v1y;
      double denom = d00 * d11 - d01 * d01;
      if (std::fabs(denom) < 1e-18) continue;
      double u = (d11 * d20 - d01 * d21) / denom;
      double v = (d00 * d21 - d01 * d20) / denom;
      if (u < 0 || v < 0 || u + v > 1) continue;
      double z = a[2] + u * (c[2] - a[2]) + v * (b[2] - a[2]);
      if (z > p[2]) n_cross++;
    }
    inside[i] = (uint8_t)(n_cross & 1);
  }
}

// ---------------------------------------------------------------------------
// point -> mesh squared distance (+ closest face and barycentric coords)
// ---------------------------------------------------------------------------

static inline double closest_on_tri(const float* p, const float* a,
                                    const float* b, const float* c,
                                    double* bary) {
  // Ericson, Real-Time Collision Detection, closest point on triangle.
  double ab[3], ac[3], ap[3];
  for (int k = 0; k < 3; ++k) {
    ab[k] = b[k] - a[k]; ac[k] = c[k] - a[k]; ap[k] = p[k] - a[k];
  }
  double d1 = ab[0]*ap[0]+ab[1]*ap[1]+ab[2]*ap[2];
  double d2 = ac[0]*ap[0]+ac[1]*ap[1]+ac[2]*ap[2];
  double u = 1, v = 0, w = 0;   // barycentric of closest point (a,b,c)
  if (d1 <= 0 && d2 <= 0) { u = 1; v = 0; w = 0; }
  else {
    double bp[3], cp[3];
    for (int k = 0; k < 3; ++k) { bp[k] = p[k]-b[k]; cp[k] = p[k]-c[k]; }
    double d3 = ab[0]*bp[0]+ab[1]*bp[1]+ab[2]*bp[2];
    double d4 = ac[0]*bp[0]+ac[1]*bp[1]+ac[2]*bp[2];
    double d5 = ab[0]*cp[0]+ab[1]*cp[1]+ab[2]*cp[2];
    double d6 = ac[0]*cp[0]+ac[1]*cp[1]+ac[2]*cp[2];
    if (d3 >= 0 && d4 <= d3) { u = 0; v = 1; w = 0; }
    else {
      double vc = d1*d4 - d3*d2;
      if (vc <= 0 && d1 >= 0 && d3 <= 0) {
        double t = d1 / (d1 - d3); u = 1 - t; v = t; w = 0;
      } else if (d6 >= 0 && d5 <= d6) { u = 0; v = 0; w = 1; }
      else {
        double vb = d5*d2 - d1*d6;
        if (vb <= 0 && d2 >= 0 && d6 <= 0) {
          double t = d2 / (d2 - d6); u = 1 - t; v = 0; w = t;
        } else {
          double va = d3*d6 - d5*d4;
          if (va <= 0 && (d4 - d3) >= 0 && (d5 - d6) >= 0) {
            double t = (d4 - d3) / ((d4 - d3) + (d5 - d6));
            u = 0; v = 1 - t; w = t;
          } else {
            double denom = 1.0 / (va + vb + vc);
            v = vb * denom; w = vc * denom; u = 1 - v - w;
          }
        }
      }
    }
  }
  bary[0] = u; bary[1] = v; bary[2] = w;
  double q[3], d = 0;
  for (int k = 0; k < 3; ++k) {
    q[k] = u * a[k] + v * b[k] + w * c[k];
    d += (p[k] - q[k]) * (p[k] - q[k]);
  }
  return d;
}

// Uniform-grid accelerated point->mesh query.
void point_mesh_squared_distance(
    const float* points, int n_points, const float* verts, int n_verts,
    const int* faces, int n_faces, float* sq_dist, int* face_idx,
    float* bary_out) {
  // build face AABBs + grid
  double bmin[3] = {1e30, 1e30, 1e30}, bmax[3] = {-1e30, -1e30, -1e30};
  for (int v = 0; v < n_verts; ++v)
    for (int k = 0; k < 3; ++k) {
      bmin[k] = std::min(bmin[k], (double)verts[v*3+k]);
      bmax[k] = std::max(bmax[k], (double)verts[v*3+k]);
    }
  const int res = 24;
  double inv[3], cell[3];
  for (int k = 0; k < 3; ++k) {
    double ext = std::max(bmax[k] - bmin[k], 1e-9);
    inv[k] = res / ext; cell[k] = ext / res;
  }
  std::vector<std::vector<int>> grid((size_t)res * res * res);
  for (int f = 0; f < n_faces; ++f) {
    double lo[3] = {1e30,1e30,1e30}, hi[3] = {-1e30,-1e30,-1e30};
    for (int j = 0; j < 3; ++j) {
      const float* p = verts + (size_t)faces[f*3+j]*3;
      for (int k = 0; k < 3; ++k) {
        lo[k] = std::min(lo[k], (double)p[k]);
        hi[k] = std::max(hi[k], (double)p[k]);
      }
    }
    int c0[3], c1[3];
    for (int k = 0; k < 3; ++k)
      cell_range(lo[k], hi[k], bmin[k], inv[k], res, c0[k], c1[k]);
    for (int x = c0[0]; x <= c1[0]; ++x)
      for (int y = c0[1]; y <= c1[1]; ++y)
        for (int z = c0[2]; z <= c1[2]; ++z)
          grid[((size_t)x * res + y) * res + z].push_back(f);
  }

  // Expanding-ring search per point with (a) exact cell-AABB distance
  // pruning, (b) per-face dedup stamps (faces span multiple cells), and
  // (c) an exact stop test: quit once no unsearched cell can beat `best`
  // (distance from the point to the boundary of the searched region,
  // ignoring region faces clamped to the domain edge, where no cells
  // remain). Without (a)/(c), far-from-mesh query points degenerate to
  // near-full-grid triangle scans.
  auto worker = [&](int i_begin, int i_end) {
    std::vector<int> stamp((size_t)n_faces, -1);
    for (int i = i_begin; i < i_end; ++i) {
      const float* p = points + (size_t)i * 3;
      double best = 1e30, best_bary[3] = {1, 0, 0};
      int best_f = 0;
      int cx[3];
      for (int k = 0; k < 3; ++k) {
        cx[k] = (int)std::floor((p[k] - bmin[k]) * inv[k]);
        cx[k] = std::max(0, std::min(res - 1, cx[k]));
      }
      for (int ring = 0; ring < res; ++ring) {
        int x0 = std::max(0, cx[0]-ring), x1 = std::min(res-1, cx[0]+ring);
        int y0 = std::max(0, cx[1]-ring), y1 = std::min(res-1, cx[1]+ring);
        int z0 = std::max(0, cx[2]-ring), z1 = std::min(res-1, cx[2]+ring);
        for (int x = x0; x <= x1; ++x)
          for (int y = y0; y <= y1; ++y)
            for (int z = z0; z <= z1; ++z) {
              // only the shell of the ring
              if (ring > 0 && x != x0 && x != x1 && y != y0 && y != y1 &&
                  z != z0 && z != z1) continue;
              const auto& faces_in = grid[((size_t)x * res + y) * res + z];
              if (faces_in.empty()) continue;
              // squared distance from p to this cell's AABB
              double clo, d2 = 0;
              clo = bmin[0] + x * cell[0];
              double dx = std::max(std::max(clo - p[0],
                                            p[0] - (clo + cell[0])), 0.0);
              clo = bmin[1] + y * cell[1];
              double dy = std::max(std::max(clo - p[1],
                                            p[1] - (clo + cell[1])), 0.0);
              clo = bmin[2] + z * cell[2];
              double dz = std::max(std::max(clo - p[2],
                                            p[2] - (clo + cell[2])), 0.0);
              d2 = dx*dx + dy*dy + dz*dz;
              if (d2 >= best) continue;
              for (int f : faces_in) {
                if (stamp[f] == i) continue;
                stamp[f] = i;
                const float* a = verts + (size_t)faces[f*3+0]*3;
                const float* b = verts + (size_t)faces[f*3+1]*3;
                const float* c = verts + (size_t)faces[f*3+2]*3;
                double bary[3];
                double d = closest_on_tri(p, a, b, c, bary);
                if (d < best) {
                  best = d; best_f = f;
                  best_bary[0]=bary[0]; best_bary[1]=bary[1];
                  best_bary[2]=bary[2];
                }
              }
            }
        // distance to the nearest unsearched cell: the searched region's
        // boundary, skipping faces clamped to the domain edge
        double stop = 1e30;
        if (x0 > 0) stop = std::min(stop, p[0] - (bmin[0] + x0*cell[0]));
        if (x1 < res-1)
          stop = std::min(stop, (bmin[0] + (x1+1)*cell[0]) - p[0]);
        if (y0 > 0) stop = std::min(stop, p[1] - (bmin[1] + y0*cell[1]));
        if (y1 < res-1)
          stop = std::min(stop, (bmin[1] + (y1+1)*cell[1]) - p[1]);
        if (z0 > 0) stop = std::min(stop, p[2] - (bmin[2] + z0*cell[2]));
        if (z1 < res-1)
          stop = std::min(stop, (bmin[2] + (z1+1)*cell[2]) - p[2]);
        stop = std::max(stop, 0.0);
        if (best <= stop * stop) break;
      }
      sq_dist[i] = (float)best;
      face_idx[i] = best_f;
      bary_out[i*3+0] = (float)best_bary[0];
      bary_out[i*3+1] = (float)best_bary[1];
      bary_out[i*3+2] = (float)best_bary[2];
    }
  };

  int n_threads = (int)std::thread::hardware_concurrency();
  if (n_threads < 1) n_threads = 1;
  n_threads = std::min(n_threads, std::max(1, n_points / 256));
  if (n_threads <= 1) {
    worker(0, n_points);
  } else {
    std::vector<std::thread> pool;
    int per = (n_points + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
      int lo = t * per, hi = std::min(n_points, lo + per);
      if (lo >= hi) break;
      pool.emplace_back(worker, lo, hi);
    }
    for (auto& th : pool) th.join();
  }
}

// ---------------------------------------------------------------------------
// iso-surface extraction via marching tetrahedra
//
// Table-free and watertight: each grid cube is split into 6 tetrahedra
// sharing the main diagonal; each tet contributes 0-2 triangles with
// vertices interpolated on its edges. Vertices are deduplicated by global
// edge key so the output is a proper indexed mesh.
// ---------------------------------------------------------------------------

struct MCResult {
  std::vector<float> verts;
  std::vector<int> faces;
};

void* marching_cubes(const float* grid_vals, int nx, int ny, int nz,
                     float iso, const float* origin, const float* spacing) {
  MCResult* r = new MCResult();
  std::unordered_map<uint64_t, int> vert_cache;
  auto val = [&](int x, int y, int z) -> double {
    return grid_vals[((size_t)x * ny + y) * nz + z];
  };
  auto gid = [&](int x, int y, int z) -> uint64_t {
    return ((uint64_t)x * ny + y) * nz + z;
  };
  static const int corner_off[8][3] = {
      {0,0,0},{1,0,0},{1,1,0},{0,1,0},{0,0,1},{1,0,1},{1,1,1},{0,1,1}};
  // 6 tetrahedra around the 0-6 diagonal
  static const int tets[6][4] = {
      {0,1,2,6},{0,2,3,6},{0,3,7,6},{0,7,4,6},{0,4,5,6},{0,5,1,6}};

  // interpolated vertex on the edge between global corners g1, g2
  auto edge_vertex = [&](uint64_t g1, uint64_t g2, const double p1[3],
                         const double p2[3], double v1, double v2) -> int {
    if (g2 < g1) { std::swap(g1, g2); std::swap(v1, v2);
                   const double* t = p1; p1 = p2; p2 = t; }
    uint64_t key = g1 * 0x100000000ull ^ g2;
    auto it = vert_cache.find(key);
    if (it != vert_cache.end()) return it->second;
    double mu = (std::fabs(v2 - v1) < 1e-12) ? 0.5 : (iso - v1) / (v2 - v1);
    int id = (int)(r->verts.size() / 3);
    for (int k = 0; k < 3; ++k)
      r->verts.push_back((float)(p1[k] + mu * (p2[k] - p1[k])));
    vert_cache.emplace(key, id);
    return id;
  };

  for (int x = 0; x < nx - 1; ++x)
    for (int y = 0; y < ny - 1; ++y)
      for (int z = 0; z < nz - 1; ++z) {
        double cv[8]; double cp[8][3]; uint64_t cg[8];
        bool any_below = false, any_above = false;
        for (int c = 0; c < 8; ++c) {
          int cx = x + corner_off[c][0], cy = y + corner_off[c][1],
              cz = z + corner_off[c][2];
          cv[c] = val(cx, cy, cz);
          cg[c] = gid(cx, cy, cz);
          cp[c][0] = origin[0] + spacing[0] * cx;
          cp[c][1] = origin[1] + spacing[1] * cy;
          cp[c][2] = origin[2] + spacing[2] * cz;
          (cv[c] < iso ? any_below : any_above) = true;
        }
        if (!any_below || !any_above) continue;
        for (int t = 0; t < 6; ++t) {
          int i0 = tets[t][0], i1 = tets[t][1], i2 = tets[t][2],
              i3 = tets[t][3];
          int code = (cv[i0] < iso) | ((cv[i1] < iso) << 1) |
                     ((cv[i2] < iso) << 2) | ((cv[i3] < iso) << 3);
          if (code == 0 || code == 15) continue;
          // canonicalize: ensure the "inside" set has the lower bits by
          // flipping when >2 corners are inside
          int a = i0, b = i1, c = i2, d = i3;
          // centroid of the inside (< iso) corners of this tet: used to
          // orient every emitted triangle consistently outward
          double ic[3] = {0, 0, 0};
          int n_in = 0;
          for (int j = 0; j < 4; ++j) {
            int cj = tets[t][j];
            if (cv[cj] < iso) {
              for (int k = 0; k < 3; ++k) ic[k] += cp[cj][k];
              n_in++;
            }
          }
          for (int k = 0; k < 3; ++k) ic[k] /= std::max(n_in, 1);
          auto emit_tri = [&](int v0, int v1, int v2) {
            if (v0 == v1 || v1 == v2 || v0 == v2) return;
            const float* p0 = r->verts.data() + (size_t)v0 * 3;
            const float* p1 = r->verts.data() + (size_t)v1 * 3;
            const float* p2 = r->verts.data() + (size_t)v2 * 3;
            double e1[3], e2[3], cen[3];
            for (int k = 0; k < 3; ++k) {
              e1[k] = p1[k] - p0[k];
              e2[k] = p2[k] - p0[k];
              cen[k] = (p0[k] + p1[k] + p2[k]) / 3.0 - ic[k];
            }
            double nx = e1[1]*e2[2] - e1[2]*e2[1];
            double ny = e1[2]*e2[0] - e1[0]*e2[2];
            double nz = e1[0]*e2[1] - e1[1]*e2[0];
            bool outward = nx*cen[0] + ny*cen[1] + nz*cen[2] >= 0;
            r->faces.push_back(v0);
            r->faces.push_back(outward ? v1 : v2);
            r->faces.push_back(outward ? v2 : v1);
          };
          auto ev = [&](int ca, int cb) {
            return edge_vertex(cg[ca], cg[cb], cp[ca], cp[cb], cv[ca],
                               cv[cb]);
          };
          switch (code) {
            // one corner inside
            case 1:  emit_tri(ev(a,b), ev(a,c), ev(a,d)); break;
            case 2:  emit_tri(ev(b,a), ev(b,d), ev(b,c)); break;
            case 4:  emit_tri(ev(c,a), ev(c,b), ev(c,d)); break;
            case 8:  emit_tri(ev(d,a), ev(d,c), ev(d,b)); break;
            // one corner outside (mirrors, opposite winding)
            case 14: emit_tri(ev(a,b), ev(a,d), ev(a,c)); break;
            case 13: emit_tri(ev(b,a), ev(b,c), ev(b,d)); break;
            case 11: emit_tri(ev(c,a), ev(c,d), ev(c,b)); break;
            case 7:  emit_tri(ev(d,a), ev(d,b), ev(d,c)); break;
            // two corners inside: quad split into two triangles
            case 3:  emit_tri(ev(a,c), ev(a,d), ev(b,d));
                     emit_tri(ev(a,c), ev(b,d), ev(b,c)); break;
            case 12: emit_tri(ev(a,c), ev(b,d), ev(a,d));
                     emit_tri(ev(a,c), ev(b,c), ev(b,d)); break;
            case 5:  emit_tri(ev(a,b), ev(c,b), ev(c,d));
                     emit_tri(ev(a,b), ev(c,d), ev(a,d)); break;
            case 10: emit_tri(ev(a,b), ev(c,d), ev(c,b));
                     emit_tri(ev(a,b), ev(a,d), ev(c,d)); break;
            case 6:  emit_tri(ev(b,a), ev(c,a), ev(c,d));
                     emit_tri(ev(b,a), ev(c,d), ev(b,d)); break;
            case 9:  emit_tri(ev(b,a), ev(c,d), ev(c,a));
                     emit_tri(ev(b,a), ev(b,d), ev(c,d)); break;
          }
        }
      }
  return r;
}

int mc_num_verts(void* h) {
  return (int)(reinterpret_cast<MCResult*>(h)->verts.size() / 3);
}
int mc_num_faces(void* h) {
  return (int)(reinterpret_cast<MCResult*>(h)->faces.size() / 3);
}
void mc_copy(void* h, float* verts, int* faces) {
  MCResult* r = reinterpret_cast<MCResult*>(h);
  std::memcpy(verts, r->verts.data(), r->verts.size() * sizeof(float));
  std::memcpy(faces, r->faces.data(), r->faces.size() * sizeof(int));
}
void mc_free(void* h) { delete reinterpret_cast<MCResult*>(h); }


// ---------------------------------------------------------------------------
// z-buffer triangle rasterizer (test-time normal-map visualization;
// replaces pytorch3d MeshRasterizer used at
// im2mesh/metaavatar_render/models/__init__.py:228-311)
// ---------------------------------------------------------------------------

// proj: V*2 pixel coords; depth: V (camera-space z); writes per-pixel
// face index (-1 = background) and barycentric coords.
void rasterize_mesh(const float* proj, const float* depth, int n_verts,
                    const int* faces, int n_faces, int height, int width,
                    int* face_buf, float* bary_buf, float* z_buf) {
  for (int i = 0; i < height * width; ++i) {
    face_buf[i] = -1;
    z_buf[i] = 1e30f;
    bary_buf[i * 3] = bary_buf[i * 3 + 1] = bary_buf[i * 3 + 2] = 0.f;
  }
  for (int f = 0; f < n_faces; ++f) {
    int ia = faces[f * 3], ib = faces[f * 3 + 1], ic = faces[f * 3 + 2];
    double ax = proj[ia * 2], ay = proj[ia * 2 + 1];
    double bx = proj[ib * 2], by = proj[ib * 2 + 1];
    double cx = proj[ic * 2], cy = proj[ic * 2 + 1];
    double za = depth[ia], zb = depth[ib], zc = depth[ic];
    if (za <= 0 && zb <= 0 && zc <= 0) continue;   // behind camera
    int x0 = std::max(0, (int)std::floor(std::min(ax, std::min(bx, cx))));
    int x1 = std::min(width - 1,
                      (int)std::ceil(std::max(ax, std::max(bx, cx))));
    int y0 = std::max(0, (int)std::floor(std::min(ay, std::min(by, cy))));
    int y1 = std::min(height - 1,
                      (int)std::ceil(std::max(ay, std::max(by, cy))));
    if (x0 > x1 || y0 > y1) continue;
    double denom = (by - cy) * (ax - cx) + (cx - bx) * (ay - cy);
    if (std::fabs(denom) < 1e-12) continue;
    double inv_den = 1.0 / denom;
    for (int y = y0; y <= y1; ++y)
      for (int x = x0; x <= x1; ++x) {
        double px = x + 0.5, py = y + 0.5;
        double w0 = ((by - cy) * (px - cx) + (cx - bx) * (py - cy)) * inv_den;
        double w1 = ((cy - ay) * (px - cx) + (ax - cx) * (py - cy)) * inv_den;
        double w2 = 1.0 - w0 - w1;
        if (w0 < 0 || w1 < 0 || w2 < 0) continue;
        // perspective-correct-ish depth: interpolate 1/z
        double z = 1.0 / (w0 / za + w1 / zb + w2 / zc);
        if (z <= 0) continue;
        int idx = y * width + x;
        if (z < z_buf[idx]) {
          z_buf[idx] = (float)z;
          face_buf[idx] = f;
          bary_buf[idx * 3] = (float)w0;
          bary_buf[idx * 3 + 1] = (float)w1;
          bary_buf[idx * 3 + 2] = (float)w2;
        }
      }
  }
}

}  // extern "C"
