// Marching-tetrahedra isosurface extraction.
//
// Native replacement for the reference's C++ `mcubes.marching_cubes`
// (used at ref: utils/network_utils.py:226).  Each grid cube is split into
// six tetrahedra; each tetrahedron emits 0-2 triangles with vertices
// linearly interpolated onto the isosurface.  Vertices are deduplicated on
// the shared-edge lattice so the mesh is watertight.
//
// Exposed as a C ABI for ctypes:
//   marching_tets(values, nx, ny, nz, iso,
//                 out_verts, out_tris, max_verts, max_tris,
//                 &n_verts, &n_tris)
// Vertex coordinates are in grid-index space (caller rescales to world).
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct EdgeKey {
    int64_t a, b;
    bool operator==(const EdgeKey& o) const { return a == o.a && b == o.b; }
};

struct EdgeKeyHash {
    size_t operator()(const EdgeKey& k) const {
        return std::hash<int64_t>()(k.a * 1000003ll ^ k.b);
    }
};

// the six tetrahedra of a cube, as corner indices (0..7, x-major bit order:
// corner = (dx<<2) | (dy<<1) | dz)
// Kuhn/Freudenthal split around the body diagonal 0-7: face diagonals are
// consistent across neighboring cubes, so the extracted surface is crack-free
const int kTets[6][4] = {
    {0, 5, 1, 7}, {0, 1, 3, 7}, {0, 3, 2, 7},
    {0, 2, 6, 7}, {0, 6, 4, 7}, {0, 4, 5, 7},
};

const int kCornerOff[8][3] = {
    {0, 0, 0}, {0, 0, 1}, {0, 1, 0}, {0, 1, 1},
    {1, 0, 0}, {1, 0, 1}, {1, 1, 0}, {1, 1, 1},
};

}  // namespace

extern "C" int marching_tets(
    const float* values, int nx, int ny, int nz, float iso,
    float* out_verts, int32_t* out_tris,
    int64_t max_verts, int64_t max_tris,
    int64_t* n_verts_out, int64_t* n_tris_out) {
    auto val = [&](int64_t x, int64_t y, int64_t z) -> float {
        return values[(x * ny + y) * nz + z];
    };
    auto corner_id = [&](int64_t x, int64_t y, int64_t z) -> int64_t {
        return (x * ny + y) * nz + z;
    };

    std::unordered_map<EdgeKey, int64_t, EdgeKeyHash> edge_verts;
    int64_t n_verts = 0, n_tris = 0;

    // emit (or reuse) the interpolated vertex on edge (ca, cb)
    auto edge_vertex = [&](int64_t cid[2][4], int ia, int ib,
                           const float v[4],
                           const int64_t pos[4][3]) -> int64_t {
        int64_t ka = cid[0][ia], kb = cid[0][ib];
        EdgeKey key = ka < kb ? EdgeKey{ka, kb} : EdgeKey{kb, ka};
        auto it = edge_verts.find(key);
        if (it != edge_verts.end()) return it->second;
        float t = (iso - v[ia]) / (v[ib] - v[ia] + 1e-20f);
        if (t < 0.f) t = 0.f;
        if (t > 1.f) t = 1.f;
        if (n_verts >= max_verts) return -1;
        for (int d = 0; d < 3; ++d) {
            out_verts[n_verts * 3 + d] =
                (float)pos[ia][d] + t * ((float)pos[ib][d] - (float)pos[ia][d]);
        }
        edge_verts.emplace(key, n_verts);
        return n_verts++;
    };

    for (int64_t x = 0; x + 1 < nx; ++x) {
        for (int64_t y = 0; y + 1 < ny; ++y) {
            for (int64_t z = 0; z + 1 < nz; ++z) {
                float cv[8];
                int64_t cids[8];
                int64_t cpos[8][3];
                bool all_above = true, all_below = true;
                for (int c = 0; c < 8; ++c) {
                    int64_t cx = x + kCornerOff[c][0];
                    int64_t cy = y + kCornerOff[c][1];
                    int64_t cz = z + kCornerOff[c][2];
                    cv[c] = val(cx, cy, cz);
                    cids[c] = corner_id(cx, cy, cz);
                    cpos[c][0] = cx; cpos[c][1] = cy; cpos[c][2] = cz;
                    all_above &= (cv[c] >= iso);
                    all_below &= (cv[c] < iso);
                }
                if (all_above || all_below) continue;

                for (int t = 0; t < 6; ++t) {
                    float v[4];
                    int64_t cid[2][4];
                    int64_t pos[4][3];
                    int inside = 0, in_idx[4], out_idx[4], ni = 0, no = 0;
                    for (int k = 0; k < 4; ++k) {
                        int c = kTets[t][k];
                        v[k] = cv[c];
                        cid[0][k] = cids[c];
                        for (int d = 0; d < 3; ++d) pos[k][d] = cpos[c][d];
                        if (v[k] < iso) { in_idx[ni++] = k; inside++; }
                        else out_idx[no++] = k;
                    }
                    if (inside == 0 || inside == 4) continue;

                    int64_t tri[4];
                    int tn = 0;
                    if (inside == 1) {
                        int a = in_idx[0];
                        for (int k = 0; k < 3; ++k) {
                            tri[k] = edge_vertex(cid, a, out_idx[k], v, pos);
                        }
                        tn = 1;
                        if (n_tris + tn > max_tris) return 1;
                        for (int k = 0; k < 3; ++k)
                            out_tris[n_tris * 3 + k] = (int32_t)tri[k];
                        ++n_tris;
                    } else if (inside == 3) {
                        int a = out_idx[0];
                        for (int k = 0; k < 3; ++k) {
                            tri[k] = edge_vertex(cid, a, in_idx[k], v, pos);
                        }
                        if (n_tris + 1 > max_tris) return 1;
                        // flip orientation vs the inside==1 case
                        out_tris[n_tris * 3 + 0] = (int32_t)tri[0];
                        out_tris[n_tris * 3 + 1] = (int32_t)tri[2];
                        out_tris[n_tris * 3 + 2] = (int32_t)tri[1];
                        ++n_tris;
                    } else {  // inside == 2 -> quad -> two triangles
                        int a0 = in_idx[0], a1 = in_idx[1];
                        int b0 = out_idx[0], b1 = out_idx[1];
                        int64_t q0 = edge_vertex(cid, a0, b0, v, pos);
                        int64_t q1 = edge_vertex(cid, a0, b1, v, pos);
                        int64_t q2 = edge_vertex(cid, a1, b1, v, pos);
                        int64_t q3 = edge_vertex(cid, a1, b0, v, pos);
                        if (q0 < 0 || q1 < 0 || q2 < 0 || q3 < 0) return 1;
                        if (n_tris + 2 > max_tris) return 1;
                        out_tris[n_tris * 3 + 0] = (int32_t)q0;
                        out_tris[n_tris * 3 + 1] = (int32_t)q1;
                        out_tris[n_tris * 3 + 2] = (int32_t)q2;
                        ++n_tris;
                        out_tris[n_tris * 3 + 0] = (int32_t)q0;
                        out_tris[n_tris * 3 + 1] = (int32_t)q2;
                        out_tris[n_tris * 3 + 2] = (int32_t)q3;
                        ++n_tris;
                    }
                    if (n_verts >= max_verts) return 1;
                }
            }
        }
    }
    *n_verts_out = n_verts;
    *n_tris_out = n_tris;
    return 0;
}
