// Per-ray oracle tracer of bvh_tpu_torch/tools/check_oracle.py.
//
// It traces a ray set through a tree with the repo's own native runtime,
// native/bvh_c.cpp (an original, self-contained implementation of the
// reference C API; it shares no code with madmann91/bvh), and tests each
// leaf's triangles with the reference's precomputed Moller-Trumbore
// (src/bvh/v2/tri.h:56-74, the form geom/tri.py ports), as the JAX
// package's tools/oracle_trace.cpp does with the reference library.
// The tree is a bvh3f handle of the same library: this file is linked
// with native/bvh_c.cpp into one shared library, built with
// -ffp-contract=off so that every product and sum is rounded on its own.
//
// Triangles are given in primitive order ([n, 9] f32: p0 p1 p2) and are
// precomputed in the tree's leaf order (position i tests
// tris[prim_ids[i]]). Rays are [R, 8] f32 (org dir tmin tmax). Per ray
// the tracer writes the position in prim_ids of the closest hit
// (0xFFFFFFFF on a miss) and t, u, v (t is the ray's final tmax).
#include "bvh_c.h"

#include <algorithm>
#include <cstdint>
#include <limits>
#include <thread>
#include <vector>

namespace {

constexpr uint32_t kInvalid = 0xFFFFFFFFu;

struct PrecomputedTri {
    float p0[3], e1[3], e2[3], n[3];
};

void cross(const float* a, const float* b, float* out) {
    out[0] = a[1] * b[2] - a[2] * b[1];
    out[1] = a[2] * b[0] - a[0] * b[2];
    out[2] = a[0] * b[1] - a[1] * b[0];
}

float dot(const float* a, const float* b) {
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// reference: tri.h:29-45 (e1 = p0 - p1, e2 = p2 - p0, n = cross(e1, e2))
PrecomputedTri precompute(const float* t) {
    PrecomputedTri p;
    for (int i = 0; i < 3; ++i) {
        p.p0[i] = t[i];
        p.e1[i] = t[i] - t[3 + i];
        p.e2[i] = t[6 + i] - t[i];
    }
    cross(p.e1, p.e2, p.n);
    return p;
}

struct RayState {
    const PrecomputedTri* tris;
    uint32_t prim;
    float t, u, v;
};

// The closest-hit leaf callback (JAX tools/oracle_trace.cpp:59-69): every
// triangle of the leaf, Moller-Trumbore as tri.h:56-74, a hit shortens
// the ray. `ray` is {org[3], dir[3], tmin, tmax}.
bool closest_leaf(void* user, float* ray, size_t begin, size_t end) {
    auto* s = static_cast<RayState*>(user);
    const float* org = ray;
    const float* dir = ray + 3;
    const float tolerance = -std::numeric_limits<float>::epsilon();
    for (size_t i = begin; i < end; ++i) {
        const PrecomputedTri& tri = s->tris[i];
        float c[3] = {tri.p0[0] - org[0], tri.p0[1] - org[1],
                      tri.p0[2] - org[2]};
        float r[3];
        cross(dir, c, r);
        float inv_det = 1.0f / dot(tri.n, dir);
        float u = dot(r, tri.e2) * inv_det;
        float v = dot(r, tri.e1) * inv_det;
        float w = 1.0f - u - v;
        if (u >= tolerance && v >= tolerance && w >= tolerance) {
            float t = dot(tri.n, c) * inv_det;
            if (t >= ray[6] && t <= ray[7]) {
                s->prim = uint32_t(i);
                ray[7] = t;
                s->t = t;
                s->u = u;
                s->v = v;
            }
        }
    }
    return false;
}

}  // namespace

extern "C" BVH_API int bvh_oracle_trace3f(
    const struct bvh3f* bvh, const float* tris, size_t tri_count,
    const float* rays, size_t ray_count, int robust, size_t threads,
    uint32_t* out_prim, float* out_tuv) {
    size_t prims = bvh3f_get_prim_count(bvh);
    std::vector<PrecomputedTri> pre(prims);
    for (size_t i = 0; i < prims; ++i) {
        size_t id = bvh3f_get_prim_id(bvh, i);
        if (id >= tri_count) return 1;
        pre[i] = precompute(tris + 9 * id);
    }
    auto trace = robust ? bvh3f_intersect_ray_robust : bvh3f_intersect_ray;
    auto work = [&](size_t lo, size_t hi) {
        for (size_t r = lo; r < hi; ++r) {
            const float* rp = rays + 8 * r;
            struct bvh_ray3f ray = {{rp[0], rp[1], rp[2]},
                                    {rp[3], rp[4], rp[5]}, rp[6], rp[7]};
            RayState s = {pre.data(), kInvalid, rp[7], 0.0f, 0.0f};
            struct bvh_intersect_callbackf cb = {&s, closest_leaf};
            trace(bvh, &ray, &cb);
            out_prim[r] = s.prim;
            out_tuv[3 * r + 0] = s.t;
            out_tuv[3 * r + 1] = s.u;
            out_tuv[3 * r + 2] = s.v;
        }
    };
    size_t n = std::max<size_t>(1, std::min(threads, ray_count));
    size_t chunk = (ray_count + n - 1) / n;
    std::vector<std::thread> pool;
    for (size_t k = 1; k < n; ++k)
        pool.emplace_back(work, std::min(ray_count, k * chunk),
                          std::min(ray_count, (k + 1) * chunk));
    work(0, std::min(ray_count, chunk));
    for (auto& th : pool) th.join();
    return 0;
}
