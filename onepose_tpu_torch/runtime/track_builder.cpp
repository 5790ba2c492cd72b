// Union-find track builder for the SfM match graph, the port's own copy
// of onepose_tpu/runtime/track_builder.cpp.
//
// The host-side hot loop of track construction: connected components over
// flat keypoint-node arrays, O(E alpha(N)). Python orchestration stays in
// onepose_tpu_torch/sfm/triangulate.py.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -o libtrack_builder.so track_builder.cpp
// (done on demand by onepose_tpu_torch/runtime/native.py; C ABI only,
// loaded with ctypes).

#include <cstdint>
#include <vector>

extern "C" {

// Connected components over n_nodes with n_edges (a, b) pairs.
// edges: [n_edges * 2] int64. roots out: [n_nodes] int64 — the
// representative (smallest-index member) of each node's component.
void uf_components(int64_t n_nodes, int64_t n_edges, const int64_t* edges,
                   int64_t* roots) {
    std::vector<int64_t> parent(n_nodes);
    std::vector<int32_t> rank(n_nodes, 0);
    for (int64_t i = 0; i < n_nodes; ++i) parent[i] = i;

    // iterative find with path halving
    auto find = [&](int64_t x) {
        while (parent[x] != x) {
            parent[x] = parent[parent[x]];
            x = parent[x];
        }
        return x;
    };

    for (int64_t e = 0; e < n_edges; ++e) {
        int64_t a = find(edges[2 * e]);
        int64_t b = find(edges[2 * e + 1]);
        if (a == b) continue;
        if (rank[a] < rank[b]) std::swap(a, b);
        parent[b] = a;
        if (rank[a] == rank[b]) ++rank[a];
    }

    // canonicalize: root = min index in component for deterministic output
    std::vector<int64_t> min_of(n_nodes);
    for (int64_t i = 0; i < n_nodes; ++i) min_of[i] = i;
    for (int64_t i = 0; i < n_nodes; ++i) {
        int64_t r = find(i);
        if (i < min_of[r]) min_of[r] = i;
    }
    for (int64_t i = 0; i < n_nodes; ++i) roots[i] = min_of[find(i)];
}

// Count component sizes: sizes[i] = size of the component whose canonical
// root is i (0 for non-roots).
void uf_component_sizes(int64_t n_nodes, const int64_t* roots,
                        int64_t* sizes) {
    for (int64_t i = 0; i < n_nodes; ++i) sizes[i] = 0;
    for (int64_t i = 0; i < n_nodes; ++i) ++sizes[roots[i]];
}

// Conflict-aware connected components (COLMAP's track-merging rule): a
// union is REFUSED when the two components already observe a common
// image — two different keypoints of one image in one track is the
// signature of an outlier link, and merging would corrupt BOTH physical
// points' tracks. Plain union-find loses ~4x recall at 30% outlier
// matches (giant merged components that per-track consensus splitting
// cannot unpick: one recovered point per round); with the rule the match
// graph stays near the percolation-safe regime and recall holds.
//
// node_img: [n_nodes] image id per keypoint node. Components track their
// image sets; smaller set merges into larger (O(N log N) total).
// Deterministic for a fixed edge order (callers pass pair-list order).
void uf_components_imgsafe(int64_t n_nodes, int64_t n_edges,
                           const int64_t* edges, const int32_t* node_img,
                           int64_t* roots) {
    std::vector<int64_t> parent(n_nodes);
    std::vector<int32_t> rank(n_nodes, 0);
    // per-ROOT sorted image-id vectors (small: <= images-per-track)
    std::vector<std::vector<int32_t>> imgs(n_nodes);
    for (int64_t i = 0; i < n_nodes; ++i) {
        parent[i] = i;
        imgs[i].push_back(node_img[i]);
    }

    auto find = [&](int64_t x) {
        while (parent[x] != x) {
            parent[x] = parent[parent[x]];
            x = parent[x];
        }
        return x;
    };

    auto intersects = [](const std::vector<int32_t>& a,
                         const std::vector<int32_t>& b) {
        std::size_t i = 0, j = 0;
        while (i < a.size() && j < b.size()) {
            if (a[i] == b[j]) return true;
            if (a[i] < b[j]) ++i; else ++j;
        }
        return false;
    };

    for (int64_t e = 0; e < n_edges; ++e) {
        int64_t a = find(edges[2 * e]);
        int64_t b = find(edges[2 * e + 1]);
        if (a == b) continue;
        if (intersects(imgs[a], imgs[b])) continue;  // refuse bad merge
        if (rank[a] < rank[b]) std::swap(a, b);
        parent[b] = a;
        if (rank[a] == rank[b]) ++rank[a];
        // merge sorted image sets b -> a
        std::vector<int32_t> merged;
        merged.reserve(imgs[a].size() + imgs[b].size());
        std::size_t i = 0, j = 0;
        const auto& va = imgs[a];
        const auto& vb = imgs[b];
        while (i < va.size() || j < vb.size()) {
            if (j >= vb.size() || (i < va.size() && va[i] < vb[j]))
                merged.push_back(va[i++]);
            else
                merged.push_back(vb[j++]);
        }
        imgs[a] = std::move(merged);
        imgs[b].clear();
        imgs[b].shrink_to_fit();
    }

    std::vector<int64_t> min_of(n_nodes);
    for (int64_t i = 0; i < n_nodes; ++i) min_of[i] = i;
    for (int64_t i = 0; i < n_nodes; ++i) {
        int64_t r = find(i);
        if (i < min_of[r]) min_of[r] = i;
    }
    for (int64_t i = 0; i < n_nodes; ++i) roots[i] = min_of[find(i)];
}

}  // extern "C"
