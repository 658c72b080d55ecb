// Minimal perspective z-buffer triangle rasterizer (CPU, C ABI).
//
// Replaces open3d/pyrender offscreen depth rendering in the evaluation
// tooling (reconstruction depth-L1, mesh culling occlusion tests —
// reference: evaluation/eval_recon.py:174-340, evaluation/cull_mesh.py:48-89).
// Renders a depth map of a triangle mesh from a pinhole camera given a
// world-to-camera transform (OpenCV convention: +z forward). Double-sided
// (no backface culling), matching pyrender's culling-disabled usage in the
// reference culling protocol.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <limits>
#include <vector>

extern "C" {

// verts: [n_verts, 3] float32 world coords; faces: [n_faces, 3] int64;
// w2c: [4, 4] row-major float32 (OpenCV camera: +z forward);
// K: fx, fy, cx, cy; output depth: [H, W] float32 (0 where no hit).
void raster_depth(const float* verts, int64_t n_verts, const int64_t* faces,
                  int64_t n_faces, const float* w2c, float fx, float fy,
                  float cx, float cy, int H, int W, float near, float far,
                  float* depth_out) {
    const float INF = std::numeric_limits<float>::infinity();
    for (int64_t i = 0; i < static_cast<int64_t>(H) * W; ++i)
        depth_out[i] = INF;

    // Transform all vertices to camera space, project.
    std::vector<float> cam(n_verts * 3);
    std::vector<float> px(n_verts), py(n_verts);
    for (int64_t v = 0; v < n_verts; ++v) {
        const float* p = verts + 3 * v;
        for (int r = 0; r < 3; ++r)
            cam[3 * v + r] = w2c[4 * r + 0] * p[0] + w2c[4 * r + 1] * p[1] +
                             w2c[4 * r + 2] * p[2] + w2c[4 * r + 3];
        float z = cam[3 * v + 2];
        if (z > 1e-8f) {
            px[v] = fx * cam[3 * v + 0] / z + cx;
            py[v] = fy * cam[3 * v + 1] / z + cy;
        } else {
            px[v] = py[v] = -1e9f;
        }
    }

    for (int64_t f = 0; f < n_faces; ++f) {
        int64_t a = faces[3 * f], b = faces[3 * f + 1], c = faces[3 * f + 2];
        float za = cam[3 * a + 2], zb = cam[3 * b + 2], zc = cam[3 * c + 2];
        // Skip triangles entirely behind the camera or out of range.
        if (za <= near && zb <= near && zc <= near) continue;
        if (za <= 1e-8f || zb <= 1e-8f || zc <= 1e-8f) continue;  // clip
        if (za > far && zb > far && zc > far) continue;

        float xa = px[a], ya = py[a], xb = px[b], yb = py[b],
              xc = px[c], yc = py[c];
        int x0 = std::max(0, (int)std::floor(std::min({xa, xb, xc})));
        int x1 = std::min(W - 1, (int)std::ceil(std::max({xa, xb, xc})));
        int y0 = std::max(0, (int)std::floor(std::min({ya, yb, yc})));
        int y1 = std::min(H - 1, (int)std::ceil(std::max({ya, yb, yc})));
        if (x0 > x1 || y0 > y1) continue;

        float denom = (yb - yc) * (xa - xc) + (xc - xb) * (ya - yc);
        if (std::fabs(denom) < 1e-12f) continue;
        float inv_den = 1.0f / denom;
        // Perspective-correct: interpolate 1/z with screen barycentrics.
        float iza = 1.0f / za, izb = 1.0f / zb, izc = 1.0f / zc;

        for (int y = y0; y <= y1; ++y) {
            for (int x = x0; x <= x1; ++x) {
                float pxf = x + 0.0f, pyf = y + 0.0f;
                float w0 = ((yb - yc) * (pxf - xc) + (xc - xb) * (pyf - yc)) * inv_den;
                float w1 = ((yc - ya) * (pxf - xc) + (xa - xc) * (pyf - yc)) * inv_den;
                float w2 = 1.0f - w0 - w1;
                if (w0 < -1e-6f || w1 < -1e-6f || w2 < -1e-6f) continue;
                float iz = w0 * iza + w1 * izb + w2 * izc;
                float z = 1.0f / iz;
                if (z < near || z > far) continue;
                float* dst = depth_out + static_cast<int64_t>(y) * W + x;
                if (z < *dst) *dst = z;
            }
        }
    }

    for (int64_t i = 0; i < static_cast<int64_t>(H) * W; ++i)
        if (depth_out[i] == INF) depth_out[i] = 0.0f;
}

}  // extern "C"
