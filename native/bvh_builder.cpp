// Native binned-SAH BVH builder for tungsten-tpu.
//
// The host-side analog of the reference's Bvh::BvhBuilder
// (src/core/bvh/BvhBuilder.cpp:29-125, binned SAH) and of embree's builders —
// built fresh for the flat skip-pointer layout the device traversal
// consumes (see tungsten_tpu/accel/bvh.py for the layout contract):
//
//   nodes in DFS preorder; inner hit -> next index, miss/leaf -> skip[i];
//   leaves cover contiguous [first, first+count) primitive ranges.
//
// Exposed via a plain C ABI for ctypes (no pybind11 in this image).
// Build: make -C native   (produces libtungsten_native.so)

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr int N_BINS = 16;

struct Vec3 {
    float x, y, z;
    Vec3() : x(0), y(0), z(0) {}
    Vec3(float a, float b, float c) : x(a), y(b), z(c) {}
    Vec3 min(const Vec3 &o) const { return Vec3(std::min(x, o.x), std::min(y, o.y), std::min(z, o.z)); }
    Vec3 max(const Vec3 &o) const { return Vec3(std::max(x, o.x), std::max(y, o.y), std::max(z, o.z)); }
    float operator[](int i) const { return i == 0 ? x : (i == 1 ? y : z); }
};

struct Box {
    Vec3 lo, hi;
    Box()
        : lo(std::numeric_limits<float>::max(), std::numeric_limits<float>::max(),
             std::numeric_limits<float>::max()),
          hi(-std::numeric_limits<float>::max(), -std::numeric_limits<float>::max(),
             -std::numeric_limits<float>::max()) {}
    void grow(const Box &o) {
        lo = lo.min(o.lo);
        hi = hi.max(o.hi);
    }
    float area() const {
        float dx = std::max(hi.x - lo.x, 0.f);
        float dy = std::max(hi.y - lo.y, 0.f);
        float dz = std::max(hi.z - lo.z, 0.f);
        return 2.f * (dx * dy + dy * dz + dz * dx);
    }
};

struct Node {
    Box box;
    int32_t start = 0, count = 0;  // leaf range (count > 0 for leaves)
    int32_t left = -1, right = -1;
};

struct Builder {
    const float *bmin, *bmax;
    std::vector<Vec3> centroid;
    std::vector<int32_t> order;
    std::vector<Node> nodes;
    int leaf_size;

    Box prim_box(int32_t i) const {
        Box b;
        b.lo = Vec3(bmin[3 * i], bmin[3 * i + 1], bmin[3 * i + 2]);
        b.hi = Vec3(bmax[3 * i], bmax[3 * i + 1], bmax[3 * i + 2]);
        return b;
    }

    int32_t build(int32_t start, int32_t count) {
        Box bounds, cbounds;
        for (int32_t k = start; k < start + count; ++k) {
            Box pb = prim_box(order[k]);
            bounds.grow(pb);
            Box cb;
            cb.lo = cb.hi = centroid[order[k]];
            cbounds.grow(cb);
        }
        int32_t idx = (int32_t)nodes.size();
        nodes.push_back(Node{});
        nodes[idx].box = bounds;

        if (count <= leaf_size) {
            nodes[idx].start = start;
            nodes[idx].count = count;
            return idx;
        }

        // binned SAH over the largest-extent axes
        float best_cost = std::numeric_limits<float>::max();
        int best_axis = -1, best_bin = -1;
        Vec3 ext(cbounds.hi.x - cbounds.lo.x, cbounds.hi.y - cbounds.lo.y,
                 cbounds.hi.z - cbounds.lo.z);
        for (int axis = 0; axis < 3; ++axis) {
            if (ext[axis] <= 0.f) continue;
            Box bin_box[N_BINS];
            int bin_cnt[N_BINS] = {0};
            float scale = N_BINS / ext[axis];
            float base = cbounds.lo[axis];
            for (int32_t k = start; k < start + count; ++k) {
                int b = std::min(int((centroid[order[k]][axis] - base) * scale), N_BINS - 1);
                bin_box[b].grow(prim_box(order[k]));
                bin_cnt[b]++;
            }
            Box right_box[N_BINS];
            Box acc;
            for (int b = N_BINS - 1; b >= 1; --b) {
                acc.grow(bin_box[b]);
                right_box[b] = acc;
            }
            Box lacc;
            int lcount = 0;
            for (int b = 0; b < N_BINS - 1; ++b) {
                lacc.grow(bin_box[b]);
                lcount += bin_cnt[b];
                int rcount = count - lcount;
                if (lcount == 0 || rcount == 0) continue;
                float cost = lacc.area() * lcount + right_box[b + 1].area() * rcount;
                if (cost < best_cost) {
                    best_cost = cost;
                    best_axis = axis;
                    best_bin = b;
                }
            }
        }

        int32_t mid;
        if (best_axis < 0) {
            // degenerate centroids: median split on the largest box axis
            Vec3 bext(bounds.hi.x - bounds.lo.x, bounds.hi.y - bounds.lo.y,
                      bounds.hi.z - bounds.lo.z);
            int axis = bext.x > bext.y ? (bext.x > bext.z ? 0 : 2) : (bext.y > bext.z ? 1 : 2);
            std::nth_element(
                order.begin() + start, order.begin() + start + count / 2,
                order.begin() + start + count,
                [&](int32_t a, int32_t b) { return centroid[a][axis] < centroid[b][axis]; });
            mid = start + count / 2;
        } else {
            float scale = N_BINS / ext[best_axis];
            float base = cbounds.lo[best_axis];
            auto it = std::partition(
                order.begin() + start, order.begin() + start + count, [&](int32_t i) {
                    int b = std::min(int((centroid[i][best_axis] - base) * scale), N_BINS - 1);
                    return b <= best_bin;
                });
            mid = (int32_t)(it - order.begin());
            if (mid == start || mid == start + count) mid = start + count / 2;
        }

        nodes[idx].left = build(start, mid - start);
        nodes[idx].right = build(mid, start + count - mid);
        return idx;
    }
};

// DFS preorder flatten with skip pointers
void flatten(const std::vector<Node> &tree, int32_t root, float *node_min,
             float *node_max, int32_t *first, int32_t *count, int32_t *skip,
             int32_t &cursor) {
    struct Item {
        int32_t node;
    };
    // compute subtree sizes iteratively (post-order)
    std::vector<int32_t> size(tree.size(), 1);
    {
        std::vector<std::pair<int32_t, bool>> st;
        st.push_back({root, false});
        while (!st.empty()) {
            auto [n, done] = st.back();
            st.pop_back();
            if (tree[n].left < 0) continue;
            if (done) {
                size[n] = 1 + size[tree[n].left] + size[tree[n].right];
            } else {
                st.push_back({n, true});
                st.push_back({tree[n].left, false});
                st.push_back({tree[n].right, false});
            }
        }
    }
    std::vector<int32_t> st;
    st.push_back(root);
    while (!st.empty()) {
        int32_t n = st.back();
        st.pop_back();
        int32_t i = cursor++;
        const Node &nd = tree[n];
        node_min[3 * i] = nd.box.lo.x;
        node_min[3 * i + 1] = nd.box.lo.y;
        node_min[3 * i + 2] = nd.box.lo.z;
        node_max[3 * i] = nd.box.hi.x;
        node_max[3 * i + 1] = nd.box.hi.y;
        node_max[3 * i + 2] = nd.box.hi.z;
        skip[i] = i + size[n];
        if (nd.left < 0) {
            first[i] = nd.start;
            count[i] = nd.count;
        } else {
            first[i] = 0;
            count[i] = 0;
            st.push_back(nd.right);
            st.push_back(nd.left);
        }
    }
}

}  // namespace

extern "C" {

// Returns the node count. Caller allocates outputs:
//   node_min/node_max: (2*n,3) f32 worst case, first/count/skip: (2*n,) i32,
//   prim_order: (n,) i32.
int32_t tungsten_build_bvh(const float *bmin, const float *bmax, int32_t n,
                           int32_t leaf_size, float *node_min, float *node_max,
                           int32_t *first, int32_t *count, int32_t *skip,
                           int32_t *prim_order) {
    if (n <= 0) return 0;
    Builder b;
    b.bmin = bmin;
    b.bmax = bmax;
    b.leaf_size = leaf_size;
    b.centroid.resize(n);
    b.order.resize(n);
    for (int32_t i = 0; i < n; ++i) {
        b.centroid[i] = Vec3(0.5f * (bmin[3 * i] + bmax[3 * i]),
                             0.5f * (bmin[3 * i + 1] + bmax[3 * i + 1]),
                             0.5f * (bmin[3 * i + 2] + bmax[3 * i + 2]));
        b.order[i] = i;
    }
    b.nodes.reserve(2 * n);
    int32_t root = b.build(0, n);
    int32_t cursor = 0;
    flatten(b.nodes, root, node_min, node_max, first, count, skip, cursor);
    std::memcpy(prim_order, b.order.data(), n * sizeof(int32_t));
    return cursor;
}

}  // extern "C"
