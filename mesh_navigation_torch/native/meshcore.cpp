// meshcore — native host core for mesh preprocessing and CPU baselines.
//
// TPU-native replacement for the host-side work the reference delegates to
// lvr2's C++ (PMPMesh construction, incidence tables, neighborhood visitors —
// SURVEY.md §2.2) plus a heap Dijkstra that serves as the C++ latency
// baseline the reference never published (SURVEY.md §6). Exposed through a
// plain C ABI consumed via ctypes (no pybind11 in the image).
//
// Build: g++ -O3 -march=native -shared -fPIC meshcore.cpp -o libmeshcore.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <queue>
#include <unordered_map>
#include <vector>

namespace {

struct MeshCore {
  int32_t V = 0, F = 0, E = 0;
  std::vector<int32_t> faces;        // [F*3]
  std::vector<float> vertices;       // [V*3]
  std::vector<int32_t> edges;        // [E*2] lo<hi
  std::vector<float> edge_dist;      // [E]
  std::vector<int32_t> face_edges;   // [F*3] edge opposite corner k
  std::vector<int32_t> edge_face_count;  // [E]
  // CSR vertex->(neighbor, edge)
  std::vector<int32_t> adj_offsets;  // [V+1]
  std::vector<int32_t> adj_vertex;   // [nnz]
  std::vector<int32_t> adj_edge;     // [nnz]
  // CSR vertex->(face, corner)
  std::vector<int32_t> vf_offsets;   // [V+1]
  std::vector<int32_t> vf_face;      // [nnz]
  std::vector<int32_t> vf_corner;    // [nnz]
  std::vector<uint8_t> boundary;     // [V]
  std::vector<uint8_t> invalid;      // [V]
};

inline uint64_t ekey(int32_t a, int32_t b) {
  if (a > b) std::swap(a, b);
  return (uint64_t(uint32_t(a)) << 32) | uint32_t(b);
}

}  // namespace

extern "C" {

// Build the full incidence structure. Degenerate faces (repeated vertex ids)
// are dropped, mirroring the reference's load-time repair
// (mesh_map.cpp:276-300). Returns an opaque handle.
void* meshcore_build(int32_t V, int32_t F_in, const float* vertices,
                     const int32_t* faces_in) {
  auto* mc = new MeshCore();
  mc->V = V;
  mc->vertices.assign(vertices, vertices + size_t(V) * 3);

  mc->faces.reserve(size_t(F_in) * 3);
  for (int32_t f = 0; f < F_in; ++f) {
    int32_t a = faces_in[f * 3], b = faces_in[f * 3 + 1], c = faces_in[f * 3 + 2];
    if (a == b || b == c || a == c) continue;
    mc->faces.push_back(a);
    mc->faces.push_back(b);
    mc->faces.push_back(c);
  }
  mc->F = int32_t(mc->faces.size() / 3);

  std::unordered_map<uint64_t, int32_t> edge_ids;
  edge_ids.reserve(size_t(mc->F) * 2);
  mc->face_edges.resize(size_t(mc->F) * 3);
  auto get_edge = [&](int32_t a, int32_t b) -> int32_t {
    uint64_t k = ekey(a, b);
    auto it = edge_ids.find(k);
    if (it != edge_ids.end()) return it->second;
    int32_t id = int32_t(mc->edges.size() / 2);
    edge_ids.emplace(k, id);
    int32_t lo = std::min(a, b), hi = std::max(a, b);
    mc->edges.push_back(lo);
    mc->edges.push_back(hi);
    return id;
  };
  for (int32_t f = 0; f < mc->F; ++f) {
    int32_t a = mc->faces[f * 3], b = mc->faces[f * 3 + 1], c = mc->faces[f * 3 + 2];
    // face_edges[f,k] = edge between corners k+1, k+2 (opposite corner k)
    mc->face_edges[f * 3 + 0] = get_edge(b, c);
    mc->face_edges[f * 3 + 1] = get_edge(c, a);
    mc->face_edges[f * 3 + 2] = get_edge(a, b);
  }
  mc->E = int32_t(mc->edges.size() / 2);

  mc->edge_dist.resize(mc->E);
  for (int32_t e = 0; e < mc->E; ++e) {
    const float* p = &mc->vertices[size_t(mc->edges[e * 2]) * 3];
    const float* q = &mc->vertices[size_t(mc->edges[e * 2 + 1]) * 3];
    float dx = p[0] - q[0], dy = p[1] - q[1], dz = p[2] - q[2];
    mc->edge_dist[e] = std::sqrt(dx * dx + dy * dy + dz * dz);
  }

  mc->edge_face_count.assign(mc->E, 0);
  for (size_t i = 0; i < mc->face_edges.size(); ++i)
    mc->edge_face_count[mc->face_edges[i]]++;

  mc->boundary.assign(V, 0);
  mc->invalid.assign(V, 0);
  for (int32_t e = 0; e < mc->E; ++e) {
    if (mc->edge_face_count[e] == 1) {
      mc->boundary[mc->edges[e * 2]] = 1;
      mc->boundary[mc->edges[e * 2 + 1]] = 1;
    } else if (mc->edge_face_count[e] > 2) {
      mc->invalid[mc->edges[e * 2]] = 1;   // non-manifold edge
      mc->invalid[mc->edges[e * 2 + 1]] = 1;
    }
  }

  // vertex -> (neighbor, edge) CSR via counting sort
  mc->adj_offsets.assign(V + 1, 0);
  for (int32_t e = 0; e < mc->E; ++e) {
    mc->adj_offsets[mc->edges[e * 2] + 1]++;
    mc->adj_offsets[mc->edges[e * 2 + 1] + 1]++;
  }
  for (int32_t v = 0; v < V; ++v) mc->adj_offsets[v + 1] += mc->adj_offsets[v];
  mc->adj_vertex.resize(size_t(mc->E) * 2);
  mc->adj_edge.resize(size_t(mc->E) * 2);
  {
    std::vector<int32_t> cur(mc->adj_offsets.begin(), mc->adj_offsets.end() - 1);
    for (int32_t e = 0; e < mc->E; ++e) {
      int32_t a = mc->edges[e * 2], b = mc->edges[e * 2 + 1];
      mc->adj_vertex[cur[a]] = b;
      mc->adj_edge[cur[a]++] = e;
      mc->adj_vertex[cur[b]] = a;
      mc->adj_edge[cur[b]++] = e;
    }
  }

  // vertex -> (face, corner) CSR
  mc->vf_offsets.assign(V + 1, 0);
  for (size_t i = 0; i < mc->faces.size(); ++i) mc->vf_offsets[mc->faces[i] + 1]++;
  for (int32_t v = 0; v < V; ++v) mc->vf_offsets[v + 1] += mc->vf_offsets[v];
  mc->vf_face.resize(mc->faces.size());
  mc->vf_corner.resize(mc->faces.size());
  {
    std::vector<int32_t> cur(mc->vf_offsets.begin(), mc->vf_offsets.end() - 1);
    for (int32_t f = 0; f < mc->F; ++f)
      for (int32_t k = 0; k < 3; ++k) {
        int32_t v = mc->faces[f * 3 + k];
        mc->vf_face[cur[v]] = f;
        mc->vf_corner[cur[v]++] = k;
      }
  }
  return mc;
}

void meshcore_free(void* h) { delete static_cast<MeshCore*>(h); }

int32_t meshcore_num_faces(void* h) { return static_cast<MeshCore*>(h)->F; }
int32_t meshcore_num_edges(void* h) { return static_cast<MeshCore*>(h)->E; }

int32_t meshcore_max_degree(void* h) {
  auto* mc = static_cast<MeshCore*>(h);
  int32_t m = 1;
  for (int32_t v = 0; v < mc->V; ++v)
    m = std::max(m, mc->adj_offsets[v + 1] - mc->adj_offsets[v]);
  return m;
}

int32_t meshcore_max_vertex_faces(void* h) {
  auto* mc = static_cast<MeshCore*>(h);
  int32_t m = 1;
  for (int32_t v = 0; v < mc->V; ++v)
    m = std::max(m, mc->vf_offsets[v + 1] - mc->vf_offsets[v]);
  return m;
}

// Fill the padded tables (shapes dictated by the maxima above). Padding:
// adj_vertex pads with the vertex's own id, faces/edges pad with 0.
void meshcore_fill(void* h,
                   int32_t* faces_out,        // [F*3]
                   int32_t* edges_out,        // [E*2]
                   float* edge_dist_out,      // [E]
                   int32_t* face_edges_out,   // [F*3]
                   int32_t D,
                   int32_t* adj_vertex_out,   // [V*D]
                   int32_t* adj_edge_out,     // [V*D]
                   uint8_t* adj_mask_out,     // [V*D]
                   int32_t FD,
                   int32_t* vf_face_out,      // [V*FD]
                   int32_t* vf_corner_out,    // [V*FD]
                   uint8_t* vf_mask_out,      // [V*FD]
                   uint8_t* boundary_out,     // [V]
                   uint8_t* invalid_out) {    // [V]
  auto* mc = static_cast<MeshCore*>(h);
  std::memcpy(faces_out, mc->faces.data(), mc->faces.size() * 4);
  std::memcpy(edges_out, mc->edges.data(), mc->edges.size() * 4);
  std::memcpy(edge_dist_out, mc->edge_dist.data(), mc->edge_dist.size() * 4);
  std::memcpy(face_edges_out, mc->face_edges.data(), mc->face_edges.size() * 4);
  std::memcpy(boundary_out, mc->boundary.data(), mc->boundary.size());
  std::memcpy(invalid_out, mc->invalid.data(), mc->invalid.size());
  for (int32_t v = 0; v < mc->V; ++v) {
    int32_t deg = mc->adj_offsets[v + 1] - mc->adj_offsets[v];
    for (int32_t j = 0; j < D; ++j) {
      bool ok = j < deg;
      adj_vertex_out[size_t(v) * D + j] = ok ? mc->adj_vertex[mc->adj_offsets[v] + j] : v;
      adj_edge_out[size_t(v) * D + j] = ok ? mc->adj_edge[mc->adj_offsets[v] + j] : 0;
      adj_mask_out[size_t(v) * D + j] = ok;
    }
    int32_t nvf = mc->vf_offsets[v + 1] - mc->vf_offsets[v];
    for (int32_t j = 0; j < FD; ++j) {
      bool ok = j < nvf;
      vf_face_out[size_t(v) * FD + j] = ok ? mc->vf_face[mc->vf_offsets[v] + j] : 0;
      vf_corner_out[size_t(v) * FD + j] = ok ? mc->vf_corner[mc->vf_offsets[v] + j] : 0;
      vf_mask_out[size_t(v) * FD + j] = ok;
    }
  }
}

// Radius-bounded BFS neighborhoods (lvr2::visitLocalVertexNeighborhood
// semantics, ridge_layer.cpp:155-184): per vertex, all vertices reachable
// along edges whose Euclidean distance from the center is <= radius.
// Two-pass: pass 0 (neigh == nullptr) returns max row length; pass 1 fills.
int32_t meshcore_radius_neighborhood(void* h, float radius, int32_t K,
                                     int32_t* neigh,     // [V*K] or nullptr
                                     uint8_t* mask) {    // [V*K] or nullptr
  auto* mc = static_cast<MeshCore*>(h);
  const float r2 = radius * radius;
  int32_t maxlen = 1;
  std::vector<int32_t> stamp(mc->V, -1);
  std::vector<int32_t> queue;
  std::vector<int32_t> out;
  for (int32_t v = 0; v < mc->V; ++v) {
    const float* pv = &mc->vertices[size_t(v) * 3];
    queue.clear();
    out.clear();
    stamp[v] = v;
    for (int32_t j = mc->adj_offsets[v]; j < mc->adj_offsets[v + 1]; ++j) {
      int32_t u = mc->adj_vertex[j];
      if (stamp[u] != v) { stamp[u] = v; queue.push_back(u); }
    }
    for (size_t qi = 0; qi < queue.size(); ++qi) {
      int32_t u = queue[qi];
      const float* pu = &mc->vertices[size_t(u) * 3];
      float dx = pu[0] - pv[0], dy = pu[1] - pv[1], dz = pu[2] - pv[2];
      if (dx * dx + dy * dy + dz * dz > r2) continue;
      out.push_back(u);
      for (int32_t j = mc->adj_offsets[u]; j < mc->adj_offsets[u + 1]; ++j) {
        int32_t w = mc->adj_vertex[j];
        if (stamp[w] != v) { stamp[w] = v; queue.push_back(w); }
      }
    }
    maxlen = std::max(maxlen, int32_t(out.size()));
    if (neigh != nullptr) {
      for (int32_t j = 0; j < K; ++j) {
        bool ok = j < int32_t(out.size());
        neigh[size_t(v) * K + j] = ok ? out[j] : v;
        mask[size_t(v) * K + j] = ok;
      }
    }
  }
  return maxlen;
}

namespace {

// Scalar CVP geometric-unfolding triangle update
// (cvp_mesh_planner.cpp:369-556 semantics; mirrors utils/oracle.py
// _unfolding_update so the native and Python oracles agree bit-for-bit in
// double precision). Returns the candidate label for the free vertex and
// sets *pred_is_v1 / *theta.
inline double cvp_unfold(double u1, double u2, double a, double b, double c,
                         bool* pred_is_v1, double* theta) {
  double sx = (c * c + u1 * u1 - u2 * u2) / (2 * c);
  double sy = -std::sqrt(std::max(u1 * u1 - sx * sx, 0.0));
  double p = (b * b + c * c - a * a) / (2 * c);
  double hc = std::sqrt(std::max(b * b - p * p, 0.0));
  double dx = p - sx, dy = hc - sy;
  double u3_sq = dx * dx + dy * dy;
  double u3 = std::sqrt(u3_sq);
  double t0a = (a * a + b * b - c * c) / (2 * a * b);
  double t1a = u3 > 0 ? (u3_sq + b * b - u1 * u1) / (2 * u3 * b) : 2.0;
  double t2a = u3 > 0 ? (a * a + u3_sq - u2 * u2) / (2 * a * u3) : 2.0;
  if (std::abs(t1a) > 1) { *pred_is_v1 = true; *theta = 0.0; return u1 + b; }
  if (std::abs(t2a) > 1) { *pred_is_v1 = false; *theta = 0.0; return u2 + a; }
  double th0 = std::acos(std::max(-1.0, std::min(1.0, t0a)));
  double th1 = std::acos(std::max(-1.0, std::min(1.0, t1a)));
  double th2 = std::acos(std::max(-1.0, std::min(1.0, t2a)));
  if (th1 < th0 && th2 < th0) {
    if (th1 < th2) { *pred_is_v1 = true; *theta = th1; return u3; }
    *pred_is_v1 = false; *theta = -th2; return u3;
  }
  if (th1 < th2) { *pred_is_v1 = true; *theta = 0.0; return u1 + b; }
  *pred_is_v1 = false; *theta = 0.0; return u2 + a;
}

}  // namespace

// Heap-ordered CVP fast marching (waveFrontPropagation,
// cvp_mesh_planner.cpp:747-886): pop-min, fix, per incident face with
// exactly one free vertex run the unfolding update. side_weights holds the
// per-edge triangle side lengths (the reference feeds edge weights here).
// The native counterpart of utils/oracle.cvp_oracle — fast enough to serve
// as the 1M-vertex parity gate in bench.py.
void meshcore_cvp(void* h, const float* side_weights,
                  const float* vertex_costs, float cost_limit,
                  const int32_t* seeds, const float* seed_dists,
                  int32_t n_seeds, float* dist_out, int32_t* pred_out,
                  float* theta_out) {
  auto* mc = static_cast<MeshCore*>(h);
  const double inf = std::numeric_limits<double>::infinity();
  std::vector<double> dist(mc->V, inf);
  std::vector<uint8_t> fixed(mc->V, 0);
  for (int32_t v = 0; v < mc->V; ++v) {
    pred_out[v] = v;
    theta_out[v] = 0.f;
  }
  using QE = std::pair<double, int32_t>;
  std::priority_queue<QE, std::vector<QE>, std::greater<QE>> pq;
  for (int32_t i = 0; i < n_seeds; ++i) {
    int32_t v = seeds[i];
    dist[v] = seed_dists[i];
    fixed[v] = 1;
    pq.push({dist[v], v});
  }
  while (!pq.empty()) {
    auto [d, v] = pq.top();
    pq.pop();
    fixed[v] = 1;
    if (vertex_costs[v] >= cost_limit) continue;
    for (int32_t j = mc->vf_offsets[v]; j < mc->vf_offsets[v + 1]; ++j) {
      int32_t f = mc->vf_face[j];
      const int32_t* corners = &mc->faces[size_t(f) * 3];
      int32_t n_fixed = fixed[corners[0]] + fixed[corners[1]] + fixed[corners[2]];
      if (n_fixed != 2) continue;
      int32_t k = !fixed[corners[0]] ? 0 : (!fixed[corners[1]] ? 1 : 2);
      int32_t v3 = corners[k];
      if (vertex_costs[v3] >= cost_limit) continue;
      int32_t v1 = corners[(k + 1) % 3];
      int32_t v2 = corners[(k + 2) % 3];
      double c = side_weights[mc->face_edges[size_t(f) * 3 + k]];
      double bb = side_weights[mc->face_edges[size_t(f) * 3 + (k + 2) % 3]];
      double aa = side_weights[mc->face_edges[size_t(f) * 3 + (k + 1) % 3]];
      bool pv1 = true;
      double th = 0.0;
      double cand = cvp_unfold(dist[v1], dist[v2], aa, bb, c, &pv1, &th);
      if (cand < dist[v3]) {
        dist[v3] = cand;
        pred_out[v3] = pv1 ? v1 : v2;
        theta_out[v3] = float(th);
        pq.push({cand, v3});
      }
    }
  }
  for (int32_t v = 0; v < mc->V; ++v) dist_out[v] = float(dist[v]);
}

// Heap Dijkstra with the reference's popped-vertex cost skip
// (dijkstra_mesh_planner.cpp:287-348) — the CPU latency/correctness baseline.
void meshcore_dijkstra(void* h, const float* edge_weights,
                       const float* vertex_costs, float cost_limit,
                       int32_t seed, float* dist_out, int32_t* pred_out) {
  auto* mc = static_cast<MeshCore*>(h);
  const float inf = std::numeric_limits<float>::infinity();
  std::vector<uint8_t> fixed(mc->V, 0);
  for (int32_t v = 0; v < mc->V; ++v) {
    dist_out[v] = inf;
    pred_out[v] = v;
  }
  dist_out[seed] = 0.f;
  using QE = std::pair<float, int32_t>;
  std::priority_queue<QE, std::vector<QE>, std::greater<QE>> pq;
  pq.push({0.f, seed});
  while (!pq.empty()) {
    auto [d, v] = pq.top();
    pq.pop();
    if (fixed[v]) continue;
    fixed[v] = 1;
    if (vertex_costs[v] > cost_limit) continue;
    for (int32_t j = mc->adj_offsets[v]; j < mc->adj_offsets[v + 1]; ++j) {
      int32_t u = mc->adj_vertex[j];
      if (fixed[u]) continue;
      float nd = d + edge_weights[mc->adj_edge[j]];
      if (nd < dist_out[u]) {
        dist_out[u] = nd;
        pred_out[u] = v;
        pq.push({nd, u});
      }
    }
  }
}

}  // extern "C"
