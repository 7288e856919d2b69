// spgt_native -- the host library of superpoint_graph_tpu_torch.
//
// The port's own copy of native/spgt_native.cpp, the JAX package's C++
// host library, with the same entry points, arithmetic and order of
// operations, so that its integer outputs (voxel order, histograms,
// components, subgraphs, matchings, cut-pursuit labels) are bit-equal to
// that library's and its float outputs agree to rounding:
//   * prune            (reference partition/ply_c/ply_c.cpp:288-380)
//   * compute_geof     (reference partition/ply_c/ply_c.cpp:384-462)
//   * connected_comp   (reference partition/ply_c/connected_components.cpp)
//   * random_subgraph  (reference partition/ply_c/random_subgraph.cpp)
//   * cutpursuit       (reference libcp submodule; l0 cut pursuit with
//                       max-flow binary splits, SIAM J. Imaging Sci. 2017)
//   * greedy_matching  (the conflict scan of the cut-pursuit merge rounds)
//
// Host code, compiled by g++ (ops/_build.py::build_host, with
// -ffp-contract=off so that no multiply-add is fused and the library gives
// the same numbers on every x86-64 host) and bound with ctypes
// (superpoint_graph_tpu_torch/native.py). It runs where the JAX package
// runs its library: the merge rounds' matching, relabel_connected, the
// room's cp_cutoff fuse and every prune above PRUNE_DEVICE_MAX rows.
//
// Self-contained: hash-map voxel grid instead of Boost maps, analytic 3x3
// eigensolver instead of Eigen, Dinic max-flow instead of Boost max-flow.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <queue>
#include <random>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// prune: voxel-grid pruning with label/object histograms
// ---------------------------------------------------------------------------
// Outputs are preallocated to n rows by the caller; returns the number of
// occupied voxels (first-occurrence order, matching the reference's
// insertion-ordered index handout, ply_c.cpp:171-183).
uint64_t spgt_prune(const float* xyz, uint64_t n, float voxel_size,
                    const uint8_t* rgb, const int32_t* labels,
                    const int32_t* objects, int32_t n_labels,
                    int32_t n_objects, float* out_xyz, float* out_rgb,
                    uint32_t* out_label_hist, uint32_t* out_obj_hist,
                    uint32_t* out_counts, int32_t* out_point_voxel) {
  if (n == 0) return 0;
  float mins[3] = {xyz[0], xyz[1], xyz[2]};
  float maxs[3] = {xyz[0], xyz[1], xyz[2]};
  for (uint64_t i = 0; i < n; ++i)
    for (int c = 0; c < 3; ++c) {
      const float v = xyz[3 * i + c];
      if (v < mins[c]) mins[c] = v;
      if (v > maxs[c]) maxs[c] = v;
    }
  uint64_t nb[3];
  for (int c = 0; c < 3; ++c)
    nb[c] = (uint64_t)std::ceil((maxs[c] - mins[c]) / voxel_size) + 2;

  std::unordered_map<uint64_t, uint32_t> vox;
  vox.reserve(n);
  uint32_t n_vox = 0;
  const int lh = n_labels + 1, oh = n_objects + 1;
  for (uint64_t i = 0; i < n; ++i) {
    uint64_t bx = (uint64_t)std::floor((xyz[3 * i] - mins[0]) / voxel_size);
    uint64_t by = (uint64_t)std::floor((xyz[3 * i + 1] - mins[1]) / voxel_size);
    uint64_t bz = (uint64_t)std::floor((xyz[3 * i + 2] - mins[2]) / voxel_size);
    uint64_t key = (bx * nb[1] + by) * nb[2] + bz;
    auto it = vox.find(key);
    uint32_t v;
    if (it == vox.end()) {
      v = n_vox++;
      vox.emplace(key, v);
      out_counts[v] = 0;
      for (int c = 0; c < 3; ++c) out_xyz[3 * v + c] = 0.f;
      for (int c = 0; c < 3; ++c) out_rgb[3 * v + c] = 0.f;
      if (n_labels > 0)
        std::memset(out_label_hist + (uint64_t)v * lh, 0, sizeof(uint32_t) * lh);
      if (n_objects > 0)
        std::memset(out_obj_hist + (uint64_t)v * oh, 0, sizeof(uint32_t) * oh);
    } else {
      v = it->second;
    }
    out_point_voxel[i] = (int32_t)v;
    out_counts[v]++;
    for (int c = 0; c < 3; ++c) out_xyz[3 * v + c] += xyz[3 * i + c];
    for (int c = 0; c < 3; ++c) out_rgb[3 * v + c] += (float)rgb[3 * i + c];
    if (n_labels > 0) out_label_hist[(uint64_t)v * lh + labels[i]]++;
    if (n_objects > 0) out_obj_hist[(uint64_t)v * oh + objects[i]]++;
  }
  for (uint32_t v = 0; v < n_vox; ++v) {
    const float cnt = (float)out_counts[v];
    for (int c = 0; c < 3; ++c) out_xyz[3 * v + c] /= cnt;
    for (int c = 0; c < 3; ++c) out_rgb[3 * v + c] /= cnt;
  }
  return n_vox;
}

// ---------------------------------------------------------------------------
// compute_geof: analytic symmetric 3x3 eigen + dimensionality features
// ---------------------------------------------------------------------------
static void eig3_sym(const double a[3][3], double lam[3], double vec[3][3]) {
  const double q = (a[0][0] + a[1][1] + a[2][2]) / 3.0;
  const double p1 =
      a[0][1] * a[0][1] + a[0][2] * a[0][2] + a[1][2] * a[1][2];
  const double p2 = (a[0][0] - q) * (a[0][0] - q) +
                    (a[1][1] - q) * (a[1][1] - q) +
                    (a[2][2] - q) * (a[2][2] - q) + 2.0 * p1;
  if (p2 < 1e-30) {
    lam[0] = a[0][0]; lam[1] = a[1][1]; lam[2] = a[2][2];
    std::sort(lam, lam + 3, std::greater<double>());
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) vec[i][j] = (i == j) ? 1.0 : 0.0;
    return;
  }
  const double p = std::sqrt(p2 / 6.0);
  double b[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      b[i][j] = (a[i][j] - (i == j ? q : 0.0)) / p;
  const double detb =
      b[0][0] * (b[1][1] * b[2][2] - b[1][2] * b[2][1]) -
      b[0][1] * (b[1][0] * b[2][2] - b[1][2] * b[2][0]) +
      b[0][2] * (b[1][0] * b[2][1] - b[1][1] * b[2][0]);
  double r = detb / 2.0;
  r = std::max(-1.0, std::min(1.0, r));
  const double phi = std::acos(r) / 3.0;
  lam[0] = q + 2.0 * p * std::cos(phi);
  lam[2] = q + 2.0 * p * std::cos(phi + 2.0 * M_PI / 3.0);
  lam[1] = 3.0 * q - lam[0] - lam[2];
  // eigenvectors: longest cross product of rows of (A - lam I)
  for (int e = 0; e < 3; ++e) {
    double m[3][3];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j)
        m[i][j] = a[i][j] - (i == j ? lam[e] : 0.0);
    double best[3] = {0, 0, 1}, bestn = -1.0;
    const int pairs[3][2] = {{0, 1}, {0, 2}, {1, 2}};
    for (int pth = 0; pth < 3; ++pth) {
      const double* r0 = m[pairs[pth][0]];
      const double* r1 = m[pairs[pth][1]];
      double c[3] = {r0[1] * r1[2] - r0[2] * r1[1],
                     r0[2] * r1[0] - r0[0] * r1[2],
                     r0[0] * r1[1] - r0[1] * r1[0]};
      const double nn = c[0] * c[0] + c[1] * c[1] + c[2] * c[2];
      if (nn > bestn) {
        bestn = nn;
        best[0] = c[0]; best[1] = c[1]; best[2] = c[2];
      }
    }
    double nn = std::sqrt(std::max(bestn, 1e-30));
    if (bestn <= 1e-30) { best[0] = 0; best[1] = 0; best[2] = 1; nn = 1.0; }
    for (int i = 0; i < 3; ++i) vec[i][e] = best[i] / nn;
  }
}

void spgt_compute_geof(const float* xyz, const uint32_t* nbrs, uint64_t n,
                       int32_t k, float* out) {
  for (uint64_t i = 0; i < n; ++i) {
    double mean[3] = {xyz[3 * i], xyz[3 * i + 1], xyz[3 * i + 2]};
    for (int32_t j = 0; j < k; ++j) {
      const uint64_t nb = nbrs[(uint64_t)i * k + j];
      for (int c = 0; c < 3; ++c) mean[c] += xyz[3 * nb + c];
    }
    for (int c = 0; c < 3; ++c) mean[c] /= (double)(k + 1);
    double cov[3][3] = {{0, 0, 0}, {0, 0, 0}, {0, 0, 0}};
    auto acc = [&](const float* p) {
      double d[3] = {p[0] - mean[0], p[1] - mean[1], p[2] - mean[2]};
      for (int a = 0; a < 3; ++a)
        for (int b = 0; b < 3; ++b) cov[a][b] += d[a] * d[b];
    };
    acc(xyz + 3 * i);
    for (int32_t j = 0; j < k; ++j) acc(xyz + 3 * nbrs[(uint64_t)i * k + j]);
    for (int a = 0; a < 3; ++a)
      for (int b = 0; b < 3; ++b) cov[a][b] /= (double)(k + 1);
    double lam[3], vec[3][3];
    eig3_sym(cov, lam, vec);
    for (int a = 0; a < 3; ++a) lam[a] = std::max(lam[a], 0.0);
    const double s0 = std::sqrt(lam[0] + 1e-30);
    const double s1 = std::sqrt(lam[1]);
    const double s2 = std::sqrt(lam[2]);
    double unary[3] = {0, 0, 0};
    for (int c = 0; c < 3; ++c)
      unary[c] = lam[0] * std::fabs(vec[c][0]) + lam[1] * std::fabs(vec[c][1]) +
                 lam[2] * std::fabs(vec[c][2]);
    const double un = std::sqrt(unary[0] * unary[0] + unary[1] * unary[1] +
                                unary[2] * unary[2]) + 1e-30;
    out[4 * i + 0] = (float)((s0 - s1) / s0);
    out[4 * i + 1] = (float)((s1 - s2) / s0);
    out[4 * i + 2] = (float)(s2 / s0);
    out[4 * i + 3] = (float)(unary[2] / un);
  }
}

// ---------------------------------------------------------------------------
// union-find
// ---------------------------------------------------------------------------
struct UF {
  // int32 parents: half the random-access footprint of int64 ones (the
  // walk over a multi-10M-edge kNN list is bound by cache misses; vertex
  // counts here are far below 2^31)
  std::vector<int32_t> p;
  explicit UF(int64_t n) : p(n) { std::iota(p.begin(), p.end(), 0); }
  int32_t find(int32_t x) {
    while (p[x] != x) { p[x] = p[p[x]]; x = p[x]; }
    return x;
  }
  void unite(int32_t a, int32_t b) {
    a = find(a); b = find(b);
    if (a != b) p[std::max(a, b)] = std::min(a, b);
  }
};

static int64_t densify_first_occurrence(std::vector<int64_t>& lab) {
  // fast path: labels already bounded (UF roots are vertex ids), so a flat
  // remap table replaces the hash map
  int64_t mx = -1;
  for (auto l : lab) mx = std::max(mx, l);
  if (mx >= 0 && mx < (int64_t)(4 * lab.size() + 1024)) {
    std::vector<int32_t> remap(mx + 1, -1);
    int64_t next = 0;
    for (auto& l : lab) {
      if (remap[l] < 0) remap[l] = (int32_t)next++;
      l = remap[l];
    }
    return next;
  }
  std::unordered_map<int64_t, int64_t> remap;
  remap.reserve(lab.size());
  int64_t next = 0;
  for (auto& l : lab) {
    auto it = remap.find(l);
    if (it == remap.end()) { remap.emplace(l, next); l = next++; }
    else l = it->second;
  }
  return next;
}

// connected components of the active subgraph + fuse-small semantics
// (connected_components.cpp:17-110)
int64_t spgt_connected_comp(int64_t n_ver, int64_t n_edg, const uint32_t* src,
                            const uint32_t* tgt, const uint8_t* active,
                            int32_t cutoff, int32_t* out_comp) {
  UF uf(n_ver);
  for (int64_t e = 0; e < n_edg; ++e)
    if (active[e]) uf.unite(src[e], tgt[e]);
  std::vector<int64_t> lab(n_ver);
  for (int64_t i = 0; i < n_ver; ++i) lab[i] = uf.find(i);
  int64_t n_comp = densify_first_occurrence(lab);

  if (cutoff > 0 && n_comp > 1) {
    // compact the inactive (label-crossing) edges ONCE: the fuse rounds
    // below only ever look at them (~3-10% of a kNN list), and each round
    // previously rescanned the full multi-10M-edge list
    std::vector<uint32_t> isrc, itgt;
    for (int64_t e = 0; e < n_edg; ++e)
      if (!active[e]) { isrc.push_back(src[e]); itgt.push_back(tgt[e]); }
    const int64_t n_inact = (int64_t)isrc.size();
    for (int round = 0; round < 64; ++round) {
      std::vector<int64_t> sizes(n_comp, 0);
      for (int64_t i = 0; i < n_ver; ++i) sizes[lab[i]]++;
      // best (largest) neighbor per small comp through inactive edges
      std::vector<int64_t> best(n_comp, -1);
      auto consider = [&](int64_t a, int64_t b) {
        if (a == b || sizes[a] >= cutoff) return;
        if (best[a] < 0 || sizes[b] > sizes[best[a]] ||
            (sizes[b] == sizes[best[a]] && b < best[a]))
          best[a] = b;
      };
      for (int64_t e = 0; e < n_inact; ++e) {
        consider(lab[isrc[e]], lab[itgt[e]]);
        consider(lab[itgt[e]], lab[isrc[e]]);
      }
      std::vector<int64_t> map(n_comp);
      std::iota(map.begin(), map.end(), 0);
      bool changed = false;
      for (int64_t c = 0; c < n_comp; ++c) {
        if (best[c] < 0) continue;
        const int64_t t = best[c];
        if (sizes[t] > sizes[c] || (sizes[t] == sizes[c] && t < c)) {
          map[c] = t;
          changed = true;
        }
      }
      if (!changed) break;
      for (int64_t i = 0; i < n_ver; ++i) lab[i] = map[lab[i]];
      n_comp = densify_first_occurrence(lab);
      if (n_comp == 1) break;
    }
  }
  for (int64_t i = 0; i < n_ver; ++i) out_comp[i] = (int32_t)lab[i];
  return n_comp;
}

// ---------------------------------------------------------------------------
// random_subgraph: BFS forest from random seeds (random_subgraph.cpp:22-98)
// ---------------------------------------------------------------------------
void spgt_random_subgraph(int64_t n_ver, int64_t n_edg, const uint32_t* src,
                          const uint32_t* tgt, int64_t subgraph_size,
                          uint32_t seed, uint8_t* out_edge, uint8_t* out_ver) {
  if (n_ver <= subgraph_size) {
    std::fill(out_ver, out_ver + n_ver, 1);
    std::fill(out_edge, out_edge + n_edg, 1);
    return;
  }
  // adjacency CSR
  std::vector<int64_t> deg(n_ver + 1, 0);
  for (int64_t e = 0; e < n_edg; ++e) { deg[src[e] + 1]++; deg[tgt[e] + 1]++; }
  for (int64_t i = 0; i < n_ver; ++i) deg[i + 1] += deg[i];
  std::vector<int64_t> adj(2 * n_edg);
  std::vector<int64_t> pos(deg.begin(), deg.end() - 1);
  for (int64_t e = 0; e < n_edg; ++e) {
    adj[pos[src[e]]++] = tgt[e];
    adj[pos[tgt[e]]++] = src[e];
  }
  std::fill(out_ver, out_ver + n_ver, 0);
  std::mt19937 rng(seed);
  int64_t selected = 0;
  std::queue<int64_t> q;
  while (selected < subgraph_size) {
    int64_t s = (int64_t)(rng() % n_ver);
    if (out_ver[s]) continue;
    q.push(s);
    out_ver[s] = 1;
    selected++;
    while (!q.empty() && selected < subgraph_size) {
      const int64_t v = q.front(); q.pop();
      for (int64_t a = deg[v]; a < deg[v + 1]; ++a) {
        const int64_t u = adj[a];
        if (!out_ver[u]) {
          out_ver[u] = 1;
          if (++selected >= subgraph_size) break;
          q.push(u);
        }
      }
    }
    while (!q.empty()) q.pop();
  }
  for (int64_t e = 0; e < n_edg; ++e)
    out_edge[e] = out_ver[src[e]] && out_ver[tgt[e]];
}

// ---------------------------------------------------------------------------
// Dinic max-flow (replaces Boost max-flow of the reference's libcp)
// ---------------------------------------------------------------------------
struct Dinic {
  struct Arc { int64_t to; int64_t rev; double cap; };
  std::vector<std::vector<Arc>> g;
  std::vector<int64_t> level, it;
  explicit Dinic(int64_t n) : g(n), level(n), it(n) {}
  void add(int64_t u, int64_t v, double cap, double rcap = 0.0) {
    g[u].push_back({v, (int64_t)g[v].size(), cap});
    g[v].push_back({u, (int64_t)g[u].size() - 1, rcap});
  }
  bool bfs(int64_t s, int64_t t) {
    std::fill(level.begin(), level.end(), -1);
    std::queue<int64_t> q;
    level[s] = 0; q.push(s);
    while (!q.empty()) {
      int64_t v = q.front(); q.pop();
      for (const auto& a : g[v])
        if (a.cap > 1e-12 && level[a.to] < 0) {
          level[a.to] = level[v] + 1;
          q.push(a.to);
        }
    }
    return level[t] >= 0;
  }
  double dfs(int64_t v, int64_t t, double f) {
    if (v == t) return f;
    for (int64_t& i = it[v]; i < (int64_t)g[v].size(); ++i) {
      Arc& a = g[v][i];
      if (a.cap > 1e-12 && level[v] < level[a.to]) {
        const double d = dfs(a.to, t, std::min(f, a.cap));
        if (d > 1e-12) {
          a.cap -= d;
          g[a.to][a.rev].cap += d;
          return d;
        }
      }
    }
    return 0.0;
  }
  void maxflow(int64_t s, int64_t t) {
    while (bfs(s, t)) {
      std::fill(it.begin(), it.end(), 0);
      while (dfs(s, t, 1e30) > 1e-12) {}
    }
  }
  // source side after maxflow
  void min_cut_side(int64_t s, std::vector<uint8_t>& side) {
    std::fill(side.begin(), side.end(), 0);
    std::queue<int64_t> q;
    q.push(s); side[s] = 1;
    while (!q.empty()) {
      int64_t v = q.front(); q.pop();
      for (const auto& a : g[v])
        if (a.cap > 1e-12 && !side[a.to]) { side[a.to] = 1; q.push(a.to); }
    }
  }
};

// ---------------------------------------------------------------------------
// l0 cut pursuit (reconstructed libcp.cutpursuit semantics; SURVEY.md §2.3)
// ---------------------------------------------------------------------------
static double partition_energy(const float* f, const float* nw, int64_t n,
                               int32_t d, const std::vector<int64_t>& comp,
                               int64_t n_comp, const uint32_t* src,
                               const uint32_t* tgt, const float* ew,
                               int64_t n_edg, double reg,
                               std::vector<double>* means_out) {
  std::vector<double> wsum(n_comp, 0.0), mean((size_t)n_comp * d, 0.0);
  for (int64_t i = 0; i < n; ++i) {
    wsum[comp[i]] += nw[i];
    for (int32_t c = 0; c < d; ++c)
      mean[comp[i] * d + c] += (double)f[i * d + c] * nw[i];
  }
  for (int64_t k = 0; k < n_comp; ++k)
    for (int32_t c = 0; c < d; ++c)
      mean[k * d + c] /= std::max(wsum[k], 1e-12);
  double fid = 0.0;
  for (int64_t i = 0; i < n; ++i)
    for (int32_t c = 0; c < d; ++c) {
      const double dv = f[i * d + c] - mean[comp[i] * d + c];
      fid += nw[i] * dv * dv;
    }
  double cross = 0.0;
  for (int64_t e = 0; e < n_edg; ++e)
    if (comp[src[e]] != comp[tgt[e]]) cross += ew[e];
  if (means_out) *means_out = std::move(mean);
  return fid + reg * cross;
}

int64_t spgt_cutpursuit(const float* f, int64_t n, int32_t d, int64_t n_edg,
                        const uint32_t* src, const uint32_t* tgt,
                        const float* ew, const float* nw, float reg_f,
                        int32_t cutoff, int32_t max_iter, int32_t flow_steps,
                        int32_t* out_comp) {
  const double reg = reg_f;
  std::vector<int64_t> comp(n, 0);
  int64_t n_comp = 1;
  std::vector<double> mean;
  double energy = partition_energy(f, nw, n, d, comp, n_comp, src, tgt, ew,
                                   n_edg, reg, &mean);
  std::vector<uint8_t> saturated(1, 0);

  for (int32_t iter = 0; iter < max_iter; ++iter) {
    // --- split init: principal direction of residuals per component
    std::vector<double> cov((size_t)n_comp * 9, 0.0);  // only d<=3 exact; for
    // d>3 use a power iteration on the full covariance accumulated below
    std::vector<double> covfull((size_t)n_comp * d * d, 0.0);
    for (int64_t i = 0; i < n; ++i) {
      const int64_t k = comp[i];
      for (int32_t a = 0; a < d; ++a) {
        const double ra = f[i * d + a] - mean[k * d + a];
        for (int32_t b = 0; b < d; ++b) {
          const double rb = f[i * d + b] - mean[k * d + b];
          covfull[(k * d + a) * d + b] += ra * rb;
        }
      }
    }
    std::vector<double> dir((size_t)n_comp * d, 0.0);
    for (int64_t k = 0; k < n_comp; ++k) {
      if (saturated[k]) continue;
      // power iteration
      std::vector<double> v(d, 1.0);
      for (int32_t c = 0; c < d; ++c) v[c] += 0.01 * c;
      for (int it2 = 0; it2 < 12; ++it2) {
        std::vector<double> nv(d, 0.0);
        for (int32_t a = 0; a < d; ++a)
          for (int32_t b = 0; b < d; ++b)
            nv[a] += covfull[(k * d + a) * d + b] * v[b];
        double nn = 0.0;
        for (int32_t c = 0; c < d; ++c) nn += nv[c] * nv[c];
        nn = std::sqrt(std::max(nn, 1e-30));
        for (int32_t c = 0; c < d; ++c) v[c] = nv[c] / nn;
      }
      for (int32_t c = 0; c < d; ++c) dir[k * d + c] = v[c];
    }
    std::vector<uint8_t> b(n, 0);
    for (int64_t i = 0; i < n; ++i) {
      const int64_t k = comp[i];
      double s = 0.0;
      for (int32_t c = 0; c < d; ++c)
        s += (f[i * d + c] - mean[k * d + c]) * dir[k * d + c];
      b[i] = (!saturated[k] && s > 0) ? 1 : 0;
    }

    // --- alternating min: centroids + global min-cut over all regions
    for (int32_t step = 0; step < flow_steps; ++step) {
      std::vector<double> hp((size_t)n_comp * d, 0.0), hm((size_t)n_comp * d, 0.0);
      std::vector<double> wp(n_comp, 0.0), wm(n_comp, 0.0);
      for (int64_t i = 0; i < n; ++i) {
        const int64_t k = comp[i];
        if (b[i]) {
          wp[k] += nw[i];
          for (int32_t c = 0; c < d; ++c) hp[k * d + c] += nw[i] * f[i * d + c];
        } else {
          wm[k] += nw[i];
          for (int32_t c = 0; c < d; ++c) hm[k * d + c] += nw[i] * f[i * d + c];
        }
      }
      for (int64_t k = 0; k < n_comp; ++k)
        for (int32_t c = 0; c < d; ++c) {
          hp[k * d + c] = wp[k] > 0 ? hp[k * d + c] / wp[k] : mean[k * d + c];
          hm[k * d + c] = wm[k] > 0 ? hm[k * d + c] / wm[k] : mean[k * d + c];
        }
      Dinic dinic(n + 2);
      const int64_t S = n, T = n + 1;
      for (int64_t i = 0; i < n; ++i) {
        const int64_t k = comp[i];
        double u1 = 0.0, u0 = 0.0;
        if (saturated[k]) { u1 = 1.0; u0 = 0.0; }
        else {
          for (int32_t c = 0; c < d; ++c) {
            const double d1 = f[i * d + c] - hp[k * d + c];
            const double d0 = f[i * d + c] - hm[k * d + c];
            u1 += d1 * d1;
            u0 += d0 * d0;
          }
          u1 *= nw[i]; u0 *= nw[i];
        }
        if (u0 > 0) dinic.add(S, i, u0);
        if (u1 > 0) dinic.add(i, T, u1);
      }
      for (int64_t e = 0; e < n_edg; ++e) {
        if (comp[src[e]] != comp[tgt[e]]) continue;
        const double w = reg * ew[e];
        if (w > 0) dinic.add(src[e], tgt[e], w, w);
      }
      dinic.maxflow(S, T);
      std::vector<uint8_t> side(n + 2, 0);
      dinic.min_cut_side(S, side);
      for (int64_t i = 0; i < n; ++i) b[i] = side[i];
    }

    // --- new components: same (comp, b) connectivity
    UF uf(n);
    for (int64_t e = 0; e < n_edg; ++e)
      if (comp[src[e]] == comp[tgt[e]] && b[src[e]] == b[tgt[e]])
        uf.unite(src[e], tgt[e]);
    std::vector<int64_t> newcomp(n);
    for (int64_t i = 0; i < n; ++i) newcomp[i] = uf.find(i);
    const int64_t n_new = densify_first_occurrence(newcomp);
    std::vector<double> new_mean;
    const double new_energy = partition_energy(
        f, nw, n, d, newcomp, n_new, src, tgt, ew, n_edg, reg, &new_mean);
    if (new_energy < energy - 1e-9 * std::max(std::fabs(energy), 1.0)) {
      // saturate new comps whose old comp did not split
      std::vector<int64_t> lo(n_comp, INT64_MAX), hi(n_comp, -1);
      for (int64_t i = 0; i < n; ++i) {
        lo[comp[i]] = std::min(lo[comp[i]], newcomp[i]);
        hi[comp[i]] = std::max(hi[comp[i]], newcomp[i]);
      }
      std::vector<uint8_t> sat_new(n_new, 0);
      for (int64_t i = 0; i < n; ++i)
        if (lo[comp[i]] == hi[comp[i]]) sat_new[newcomp[i]] = 1;
      comp = std::move(newcomp);
      mean = std::move(new_mean);
      energy = new_energy;
      saturated = std::move(sat_new);
      n_comp = n_new;
    } else {
      break;
    }
  }

  if (cutoff > 0) {
    std::vector<uint8_t> active(n_edg);
    for (int64_t e = 0; e < n_edg; ++e)
      active[e] = comp[src[e]] == comp[tgt[e]];
    std::vector<int32_t> fused(n);
    n_comp = spgt_connected_comp(n, n_edg, src, tgt, active.data(), cutoff,
                                 fused.data());
    for (int64_t i = 0; i < n; ++i) out_comp[i] = fused[i];
    return n_comp;
  }
  for (int64_t i = 0; i < n; ++i) out_comp[i] = (int32_t)comp[i];
  return n_comp;
}

// ---------------------------------------------------------------------------
// greedy_matching: conflict resolution of the cut-pursuit backward merge
// ---------------------------------------------------------------------------
// Candidates (a[i], b[i]) arrive in ascending energy-delta order; accept a
// candidate iff neither endpoint was touched by an earlier ACCEPTED one
// (ops/cutpursuit.py::greedy_matching_plain is the same scan in Python,
// where ~1e6 candidates of the giant-cloud heal take most of a second).
// Returns the number accepted; `accept` is a [p] 0/1 mask.
uint64_t spgt_greedy_matching(const int64_t* a, const int64_t* b, uint64_t p,
                              uint64_t n_comp, uint8_t* accept) {
  std::vector<uint8_t> used(n_comp, 0);
  uint64_t cnt = 0;
  for (uint64_t i = 0; i < p; ++i) {
    const int64_t ai = a[i], bi = b[i];
    if (used[ai] || used[bi]) {
      accept[i] = 0;
      continue;
    }
    used[ai] = 1;
    used[bi] = 1;
    accept[i] = 1;
    ++cnt;
  }
  return cnt;
}

}  // extern "C"
