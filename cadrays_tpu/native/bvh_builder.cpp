// Threaded-BVH builder — native host-side component.
//
// Role parity: the reference's acceleration structures are built in
// native code inside OCCT (BVH_* templates) [OCCT-contract, SURVEY.md
// §2.5]; this is the framework's native equivalent. Output layout is
// identical to the Python builder (geometry/bvh.py): DFS preorder nodes
// with skip links, leaf-contiguous triangle order — ready for upload.
//
// Build: g++ -O3 -march=native -shared -fPIC -std=c++17 (see build.py).
// Binding: plain C ABI consumed via ctypes — no pybind11 dependency.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <limits>
#include <thread>
#include <vector>

namespace {

struct Vec3 {
  float x, y, z;
};

static inline Vec3 vmin(const Vec3& a, const Vec3& b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline Vec3 vmax(const Vec3& a, const Vec3& b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct AABB {
  Vec3 lo{std::numeric_limits<float>::infinity(),
          std::numeric_limits<float>::infinity(),
          std::numeric_limits<float>::infinity()};
  Vec3 hi{-std::numeric_limits<float>::infinity(),
          -std::numeric_limits<float>::infinity(),
          -std::numeric_limits<float>::infinity()};
  void grow(const AABB& o) {
    lo = vmin(lo, o.lo);
    hi = vmax(hi, o.hi);
  }
  void grow(const Vec3& p) {
    lo = vmin(lo, p);
    hi = vmax(hi, p);
  }
  float area() const {
    float dx = std::max(hi.x - lo.x, 0.f);
    float dy = std::max(hi.y - lo.y, 0.f);
    float dz = std::max(hi.z - lo.z, 0.f);
    return dx * dy + dy * dz + dz * dx;
  }
};

struct BuildNode {
  AABB box;
  int32_t left = -1;   // DFS id of left child (right = skip of left subtree)
  int32_t right = -1;
  int32_t first = -1;  // leaf range into `order`
  int32_t count = 0;
  bool leaf() const { return count > 0; }
};

struct Builder {
  const float* verts;        // (V,3)
  const int32_t* tris;       // (T,3)
  std::vector<AABB> tri_box;
  std::vector<Vec3> centroid;
  std::vector<int32_t> order;
  std::vector<BuildNode> nodes;
  int max_leaf;

  static constexpr int kBins = 16;

  int32_t build(int32_t* prims, int32_t n) {
    int32_t nid = (int32_t)nodes.size();
    nodes.emplace_back();
    AABB box;
    for (int32_t i = 0; i < n; ++i) box.grow(tri_box[prims[i]]);
    nodes[nid].box = box;

    if (n <= max_leaf) {
      nodes[nid].first = (int32_t)order.size();
      nodes[nid].count = n;
      order.insert(order.end(), prims, prims + n);
      return nid;
    }

    // centroid bounds + widest axis
    AABB cb;
    for (int32_t i = 0; i < n; ++i) cb.grow(centroid[prims[i]]);
    float ext[3] = {cb.hi.x - cb.lo.x, cb.hi.y - cb.lo.y, cb.hi.z - cb.lo.z};
    int axis = 0;
    if (ext[1] > ext[0]) axis = 1;
    if (ext[2] > ext[axis]) axis = 2;

    int32_t mid = -1;
    if (ext[axis] > 1e-12f) {
      // binned SAH
      const float clo = axis == 0 ? cb.lo.x : (axis == 1 ? cb.lo.y : cb.lo.z);
      const float scale = kBins / ext[axis];
      int32_t cnt[kBins] = {0};
      AABB bbox[kBins];
      auto bin_of = [&](int32_t p) {
        const Vec3& c = centroid[p];
        float v = axis == 0 ? c.x : (axis == 1 ? c.y : c.z);
        int b = (int)((v - clo) * scale);
        return std::min(std::max(b, 0), kBins - 1);
      };
      for (int32_t i = 0; i < n; ++i) {
        int b = bin_of(prims[i]);
        cnt[b]++;
        bbox[b].grow(tri_box[prims[i]]);
      }
      // sweep
      float rarea[kBins];
      AABB acc;
      int32_t rcnt = 0;
      for (int b = kBins - 1; b > 0; --b) {
        acc.grow(bbox[b]);
        rcnt += cnt[b];
        rarea[b] = rcnt ? acc.area() * rcnt : 0.f;
      }
      AABB lacc;
      int32_t lcnt = 0;
      float best = std::numeric_limits<float>::infinity();
      int best_b = -1;
      for (int b = 0; b < kBins - 1; ++b) {
        lacc.grow(bbox[b]);
        lcnt += cnt[b];
        if (lcnt == 0 || lcnt == n) continue;
        float cost = lacc.area() * lcnt + rarea[b + 1];
        if (cost < best) {
          best = cost;
          best_b = b;
        }
      }
      if (best_b >= 0) {
        auto it = std::partition(prims, prims + n, [&](int32_t p) {
          return bin_of(p) <= best_b;
        });
        mid = (int32_t)(it - prims);
        if (mid == 0 || mid == n) mid = -1;
      }
    }
    if (mid < 0) {
      // median fallback
      mid = n / 2;
      std::nth_element(prims, prims + mid, prims + n,
                       [&](int32_t a, int32_t b) {
                         const Vec3 &ca = centroid[a], &cb2 = centroid[b];
                         float va = axis == 0 ? ca.x : (axis == 1 ? ca.y : ca.z);
                         float vb = axis == 0 ? cb2.x : (axis == 1 ? cb2.y : cb2.z);
                         return va < vb;
                       });
    }

    int32_t l = build(prims, mid);
    int32_t r = build(prims + mid, n - mid);
    nodes[nid].left = l;
    nodes[nid].right = r;
    return nid;
  }
};

}  // namespace

extern "C" {

// Returns the number of nodes; call with out_* == nullptr first to size,
// then again with buffers. Simpler: caller allocates worst case 2T nodes.
// out_nodes layout per node: min[3], max[3] into separate arrays.
int32_t crt_build_bvh(const float* verts, int64_t n_verts,
                      const int32_t* tris, int64_t n_tris, int32_t max_leaf,
                      float* out_min, float* out_max, int32_t* out_skip,
                      int32_t* out_first, int32_t* out_count,
                      int32_t* out_order) {
  (void)n_verts;
  if (n_tris <= 0) return 0;
  Builder b;
  b.verts = verts;
  b.tris = tris;
  b.max_leaf = max_leaf > 0 ? max_leaf : 4;
  b.tri_box.resize(n_tris);
  b.centroid.resize(n_tris);
  for (int64_t t = 0; t < n_tris; ++t) {
    AABB box;
    for (int k = 0; k < 3; ++k) {
      const float* p = verts + 3 * (int64_t)tris[3 * t + k];
      box.grow(Vec3{p[0], p[1], p[2]});
    }
    b.tri_box[t] = box;
    b.centroid[t] = {(box.lo.x + box.hi.x) * 0.5f,
                     (box.lo.y + box.hi.y) * 0.5f,
                     (box.lo.z + box.hi.z) * 0.5f};
  }
  std::vector<int32_t> prims(n_tris);
  for (int64_t i = 0; i < n_tris; ++i) prims[i] = (int32_t)i;
  b.nodes.reserve(2 * n_tris);
  b.order.reserve(n_tris);
  b.build(prims.data(), (int32_t)n_tris);

  // emit skip links: node ids are already DFS preorder.
  const int32_t N = (int32_t)b.nodes.size();
  // iterative fill to avoid recursion depth limits on huge meshes
  struct Item {
    int32_t nid, skip;
  };
  std::vector<Item> stack;
  stack.push_back({0, -1});
  while (!stack.empty()) {
    Item it = stack.back();
    stack.pop_back();
    const BuildNode& nd = b.nodes[it.nid];
    out_min[3 * it.nid + 0] = nd.box.lo.x;
    out_min[3 * it.nid + 1] = nd.box.lo.y;
    out_min[3 * it.nid + 2] = nd.box.lo.z;
    out_max[3 * it.nid + 0] = nd.box.hi.x;
    out_max[3 * it.nid + 1] = nd.box.hi.y;
    out_max[3 * it.nid + 2] = nd.box.hi.z;
    out_skip[it.nid] = it.skip;
    if (nd.leaf()) {
      out_first[it.nid] = nd.first;
      out_count[it.nid] = nd.count;
    } else {
      out_first[it.nid] = -1;
      out_count[it.nid] = 0;
      // left subtree's skip is the right child; right's is ours.
      stack.push_back({nd.right, it.skip});
      stack.push_back({nd.left, nd.right});
    }
  }
  std::memcpy(out_order, b.order.data(), sizeof(int32_t) * n_tris);
  return N;
}

}  // extern "C"
