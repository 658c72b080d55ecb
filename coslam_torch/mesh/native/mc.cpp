// Truncation-aware marching cubes over a dense TSDF volume.
//
// Native (CPU, C ABI) replacement for the reference's Cython/C++
// NumpyMarchingCubes extension (reference:
// external/NumpyMarchingCubes/marching_cubes/src/marching_cubes.cpp),
// re-implemented from its observable semantics:
//
//  * Each cell is evaluated on the DUAL grid: the 8 cube corners are
//    trilinear interpolations at cell-center +/- 0.5 offsets; a corner is
//    valid only if all 8 of its own source voxels are finite and
//    |tsdf| < truncation. Cells with any invalid corner emit nothing.
//  * A cell is also rejected when any pair of corner values is
//    inconsistent: opposite signs with |a|+|b| > thresh, or same sign
//    with |a-b| > thresh, or any |corner| > thresh (thresh = 10).
//  * Standard Bourke edge/tri case tables (mc_tables.h) with corner
//    order (bit0..bit7) = p010 p110 p100 p000 p011 p111 p101 p001.
//  * Output cleanup: vertices within 1e-5 are merged via a spatial hash
//    (approximate nearest-neighbor), duplicate and degenerate faces
//    removed.
//
// Exposed as a C ABI for ctypes:
//   mc_run(vol, nx, ny, nz, isolevel, truncation) -> opaque handle
//   mc_num_vertices / mc_num_faces / mc_copy / mc_free

#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <unordered_map>
#include <unordered_set>
#include <vector>

#include "mc_tables.h"

namespace {

struct V3 {
    float x, y, z;
};

struct MCResult {
    std::vector<float> verts;     // 3 * n_verts
    std::vector<int64_t> faces;   // 3 * n_faces
};

struct Volume {
    const float* data;
    int nx, ny, nz;
    inline float at(int x, int y, int z) const {
        return data[(static_cast<size_t>(x) * ny + y) * nz + z];
    }
};

inline void get_voxel(const Volume& vol, float px, float py, float pz,
                      float truncation, float* d, int* w) {
    int x = static_cast<int>(std::lround(px));
    int y = static_cast<int>(std::lround(py));
    int z = static_cast<int>(std::lround(pz));
    if (x >= 0 && x < vol.nx && y >= 0 && y < vol.ny && z >= 0 && z < vol.nz) {
        *d = vol.at(x, y, z);
        *w = (*d != -std::numeric_limits<float>::infinity() &&
              std::isfinite(*d) && std::fabs(*d) < truncation) ? 1 : 0;
    } else {
        *d = -std::numeric_limits<float>::infinity();
        *w = 0;
    }
}

// Trilinear interpolation on the dual grid with validity gating: fails if
// any of the 8 contributing voxels is invalid.
inline bool trilerp(const Volume& vol, float px, float py, float pz,
                    float truncation, float* dist) {
    const float hx = px - 0.5f, hy = py - 0.5f, hz = pz - 0.5f;
    const float wx = px - std::floor(px);
    const float wy = py - std::floor(py);
    const float wz = pz - std::floor(pz);

    *dist = 0.0f;
    float d;
    int w;
    const float cw[2][3] = {{1.0f - wx, 1.0f - wy, 1.0f - wz}, {wx, wy, wz}};
    for (int cx = 0; cx < 2; ++cx)
        for (int cy = 0; cy < 2; ++cy)
            for (int cz = 0; cz < 2; ++cz) {
                get_voxel(vol, hx + cx, hy + cy, hz + cz, truncation, &d, &w);
                if (w == 0) return false;
                *dist += cw[cx][0] * cw[cy][1] * cw[cz][2] * d;
            }
    return true;
}

inline V3 vertex_interp(float isolevel, const V3& p1, const V3& p2,
                        float d1, float d2) {
    if (std::fabs(isolevel - d1) < 1e-5f) return p1;
    if (std::fabs(isolevel - d2) < 1e-5f) return p2;
    if (std::fabs(d1 - d2) < 1e-5f) return p1;
    float mu = (isolevel - d1) / (d2 - d1);
    return V3{p1.x + mu * (p2.x - p1.x),
              p1.y + mu * (p2.y - p1.y),
              p1.z + mu * (p2.z - p1.z)};
}

void extract_cell(const Volume& vol, int i, int j, int k, float truncation,
                  float isolevel, float thresh, std::vector<V3>* tri_verts) {
    const float P = 0.5f, M = -0.5f;
    // Corner positions in Bourke order bit0..bit7.
    const float off[8][3] = {
        {M, P, M}, {P, P, M}, {P, M, M}, {M, M, M},
        {M, P, P}, {P, P, P}, {P, M, P}, {M, M, P}};
    V3 p[8];
    float dist[8];
    for (int c = 0; c < 8; ++c) {
        p[c] = V3{i + off[c][0], j + off[c][1], k + off[c][2]};
        if (!trilerp(vol, p[c].x, p[c].y, p[c].z, truncation, &dist[c]))
            return;
    }

    unsigned cubeindex = 0;
    for (int c = 0; c < 8; ++c)
        if (dist[c] < isolevel) cubeindex |= (1u << c);

    // Consistency rejection: wildly differing corner magnitudes indicate a
    // truncation boundary rather than a real surface.
    for (int a = 0; a < 8; ++a) {
        if (std::fabs(dist[a]) > thresh) return;
        for (int b = 0; b < 8; ++b) {
            if (dist[a] * dist[b] < 0.0f) {
                if (std::fabs(dist[a]) + std::fabs(dist[b]) > thresh) return;
            } else {
                if (std::fabs(dist[a] - dist[b]) > thresh) return;
            }
        }
    }

    const int edges = kEdgeTable[cubeindex];
    if (edges == 0 || edges == 255) return;

    // Edge endpoints in Bourke order.
    static const int kEdgeCorners[12][2] = {
        {0, 1}, {1, 2}, {2, 3}, {3, 0},
        {4, 5}, {5, 6}, {6, 7}, {7, 4},
        {0, 4}, {1, 5}, {2, 6}, {3, 7}};
    V3 vertlist[12];
    for (int e = 0; e < 12; ++e)
        if (edges & (1 << e)) {
            int a = kEdgeCorners[e][0], b = kEdgeCorners[e][1];
            vertlist[e] = vertex_interp(isolevel, p[a], p[b], dist[a], dist[b]);
        }

    for (int t = 0; kTriTable[cubeindex][t] != -1; t += 3) {
        tri_verts->push_back(vertlist[kTriTable[cubeindex][t]]);
        tri_verts->push_back(vertlist[kTriTable[cubeindex][t + 1]]);
        tri_verts->push_back(vertlist[kTriTable[cubeindex][t + 2]]);
    }
}

struct CellKey {
    int64_t x, y, z;
    bool operator==(const CellKey& o) const {
        return x == o.x && y == o.y && z == o.z;
    }
};
struct CellHash {
    size_t operator()(const CellKey& c) const {
        return (static_cast<size_t>(c.x) * 73856093u) ^
               (static_cast<size_t>(c.y) * 19349669u) ^
               (static_cast<size_t>(c.z) * 83492791u);
    }
};

// Merge vertices within `thresh` using an approximate spatial hash (first
// occupant of any of the 27 neighboring cells wins), then drop degenerate
// and duplicate faces.
MCResult* cleanup(const std::vector<V3>& tri_verts, float thresh) {
    auto* out = new MCResult();
    const size_t n = tri_verts.size();
    std::vector<int64_t> lookup(n);
    std::unordered_map<CellKey, int64_t, CellHash> grid;
    grid.reserve(n * 2);

    auto cell_of = [thresh](float v) {
        return static_cast<int64_t>(v / thresh + (v >= 0 ? 0.5f : -0.5f));
    };

    int64_t cnt = 0;
    for (size_t v = 0; v < n; ++v) {
        const V3& vert = tri_verts[v];
        CellKey key{cell_of(vert.x), cell_of(vert.y), cell_of(vert.z)};
        int64_t found = -1;
        for (int dx = -1; dx <= 1 && found < 0; ++dx)
            for (int dy = -1; dy <= 1 && found < 0; ++dy)
                for (int dz = -1; dz <= 1 && found < 0; ++dz) {
                    auto it = grid.find(
                        CellKey{key.x + dx, key.y + dy, key.z + dz});
                    if (it != grid.end()) found = it->second;
                }
        if (found < 0) {
            grid.emplace(key, cnt);
            out->verts.push_back(vert.x);
            out->verts.push_back(vert.y);
            out->verts.push_back(vert.z);
            lookup[v] = cnt++;
        } else {
            lookup[v] = found;
        }
    }

    std::unordered_set<uint64_t> seen_faces;
    seen_faces.reserve(n / 3);
    for (size_t f = 0; f + 2 < n; f += 3) {
        int64_t a = lookup[f], b = lookup[f + 1], c = lookup[f + 2];
        if (a == b || b == c || a == c) continue;  // degenerate
        int64_t s0 = a, s1 = b, s2 = c;            // sorted key
        if (s0 > s1) std::swap(s0, s1);
        if (s1 > s2) std::swap(s1, s2);
        if (s0 > s1) std::swap(s0, s1);
        uint64_t key = (static_cast<uint64_t>(s0) * 73856093u) ^
                       (static_cast<uint64_t>(s1) * 19349669u) ^
                       (static_cast<uint64_t>(s2) * 83492791u);
        if (!seen_faces.insert(key).second) continue;  // duplicate
        out->faces.push_back(a);
        out->faces.push_back(b);
        out->faces.push_back(c);
    }
    return out;
}

}  // namespace

extern "C" {

void* mc_run(const float* volume, int nx, int ny, int nz, float isolevel,
             float truncation) {
    Volume vol{volume, nx, ny, nz};
    std::vector<V3> tri_verts;
    for (int i = 0; i < nx; ++i)
        for (int j = 0; j < ny; ++j)
            for (int k = 0; k < nz; ++k)
                extract_cell(vol, i, j, k, truncation, isolevel, 10.0f,
                             &tri_verts);
    return cleanup(tri_verts, 1e-5f);
}

int64_t mc_num_vertices(void* handle) {
    return static_cast<MCResult*>(handle)->verts.size() / 3;
}

int64_t mc_num_faces(void* handle) {
    return static_cast<MCResult*>(handle)->faces.size() / 3;
}

void mc_copy(void* handle, float* verts_out, int64_t* faces_out) {
    auto* r = static_cast<MCResult*>(handle);
    std::memcpy(verts_out, r->verts.data(), r->verts.size() * sizeof(float));
    std::memcpy(faces_out, r->faces.data(), r->faces.size() * sizeof(int64_t));
}

void mc_free(void* handle) { delete static_cast<MCResult*>(handle); }

}  // extern "C"
