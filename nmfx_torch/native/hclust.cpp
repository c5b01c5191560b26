// Host path for the rank-selection step: average-linkage (UPGMA)
// hierarchical clustering, cophenetic distances, dendrogram leaf order, and
// cut-tree memberships -- the port's own copy of nmfx/native/hclust.cpp.
//
// The rank selection the reference delegates to base R's
// hclust/cophenetic/cutree (nmf.r:165-177) is inherently sequential host
// work; this library runs it in about O(n^2) in practice (a per-row
// nearest-neighbour cache) instead of the numpy path's O(n^3). Results are byte-equal to nmfx_torch/cophenetic.py's
// linkage_numpy / cut_tree_numpy (tests/test_torch_native.py).
//
// Built with the host compiler at first use by nmfx_torch/native/__init__.py
// (g++ -O3 -std=c++17 -fPIC -shared, no dependencies) into
// nmfx_torch/_build/. ABI: plain C, loaded with ctypes, which releases the
// interpreter lock for the call.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {
constexpr double kInf = std::numeric_limits<double>::infinity();
}

extern "C" {

// dist: n*n row-major symmetric, zero diagonal (not modified)
// linkage: out, (n-1)*4 rows [id_a, id_b, height, size], scipy id convention
// coph: out, n*n cophenetic distances
// order: out, n dendrogram leaf order
// returns 0 on success, nonzero on bad input
int nmfx_average_linkage(const double* dist, int64_t n, double* linkage,
                         double* coph, int32_t* order) {
  if (n < 2) return 1;
  std::vector<double> d(dist, dist + n * n);
  for (int64_t i = 0; i < n; ++i) d[i * n + i] = kInf;

  std::vector<uint8_t> active(n, 1);
  std::vector<double> size(n, 1.0);
  std::vector<int64_t> cid(n);
  std::vector<std::vector<int32_t>> members(n);
  // children[t] = ids merged at step t (cluster id n+t)
  std::vector<std::pair<int64_t, int64_t>> children(n - 1);
  for (int64_t i = 0; i < n; ++i) {
    cid[i] = i;
    members[i].push_back(static_cast<int32_t>(i));
  }
  std::memset(coph, 0, sizeof(double) * n * n);

  // Per-row nearest-neighbor cache over the upper triangle: nn_j[i] is the
  // FIRST j > i minimizing d[i][j] among active columns (strict <, so ties
  // keep the smallest j), nn_d[i] its distance. The globally closest pair is
  // then the first row attaining the minimum of nn_d — identical pair choice
  // (and tie-breaking) to the naive full row-major rescan, but each merge
  // costs O(n + r·n) with r = #rows whose cached neighbor was invalidated,
  // instead of O(n²): ~O(n²) total in practice vs the old O(n³) (28× slower
  // than scipy at n=2000; see benchmarks/RESULTS.md rank-selection rows).
  std::vector<double> nn_d(n, kInf);
  std::vector<int64_t> nn_j(n, -1);
  auto recompute_nn = [&](int64_t i) {
    double bd = kInf;
    int64_t bj2 = -1;
    const double* row = d.data() + i * n;
    for (int64_t j = i + 1; j < n; ++j) {
      if (active[j] && row[j] < bd) {
        bd = row[j];
        bj2 = j;
      }
    }
    nn_d[i] = bd;
    nn_j[i] = bj2;
  };
  for (int64_t i = 0; i < n - 1; ++i) recompute_nn(i);

  for (int64_t t = 0; t < n - 1; ++t) {
    // closest active pair from the caches (first row with the min distance)
    double best = kInf;
    int64_t bi = -1;
    for (int64_t i = 0; i < n; ++i) {
      if (active[i] && nn_d[i] < best) {
        best = nn_d[i];
        bi = i;
      }
    }
    if (bi < 0 || nn_j[bi] < 0) return 2;
    int64_t bj = nn_j[bi];

    int64_t a = std::min(cid[bi], cid[bj]);
    int64_t b = std::max(cid[bi], cid[bj]);
    double new_size = size[bi] + size[bj];
    linkage[t * 4 + 0] = static_cast<double>(a);
    linkage[t * 4 + 1] = static_cast<double>(b);
    linkage[t * 4 + 2] = best;
    linkage[t * 4 + 3] = new_size;

    for (int32_t mi : members[bi])
      for (int32_t mj : members[bj]) {
        coph[static_cast<int64_t>(mi) * n + mj] = best;
        coph[static_cast<int64_t>(mj) * n + mi] = best;
      }

    // UPGMA distance update into slot bi
    for (int64_t kcol = 0; kcol < n; ++kcol) {
      double merged =
          (size[bi] * d[bi * n + kcol] + size[bj] * d[bj * n + kcol]) /
          new_size;
      d[bi * n + kcol] = merged;
      d[kcol * n + bi] = merged;
    }
    d[bi * n + bi] = kInf;
    active[bj] = 0;
    // cache maintenance. Row bi's distances all changed: full recompute.
    // Any other active row whose cached neighbor was bi (distance changed —
    // the UPGMA average can move either way) or bj (deactivated) rescans;
    // otherwise only the refreshed d[i][bi] can displace the cached entry,
    // taking it on strict improvement OR an equal distance at smaller j
    // (the first-minimum convention the full rescan would apply)
    recompute_nn(bi);
    for (int64_t i = 0; i < n; ++i) {
      if (!active[i] || i == bi) continue;
      if (nn_j[i] == bi || nn_j[i] == bj) {
        recompute_nn(i);
      } else if (i < bi) {
        double di = d[i * n + bi];
        if (di < nn_d[i] || (di == nn_d[i] && bi < nn_j[i])) {
          nn_d[i] = di;
          nn_j[i] = bi;
        }
      }
    }
    children[t] = {a, b};
    auto& mj = members[bj];
    members[bi].insert(members[bi].end(), mj.begin(), mj.end());
    mj.clear();
    mj.shrink_to_fit();
    size[bi] = new_size;
    cid[bi] = n + t;
  }

  // depth-first leaf order, left child first
  std::vector<int64_t> stack;
  stack.push_back(2 * n - 2);
  int64_t pos = 0;
  while (!stack.empty()) {
    int64_t node = stack.back();
    stack.pop_back();
    if (node < n) {
      order[pos++] = static_cast<int32_t>(node);
    } else {
      auto [left, right] = children[node - n];
      stack.push_back(right);
      stack.push_back(left);
    }
  }
  return pos == n ? 0 : 3;
}

// linkage: (n-1)*4 as produced above; labels out: n entries in 1..k,
// numbered by first appearance in leaf index order (R cutree convention)
int nmfx_cut_tree(const double* linkage, int64_t n, int64_t k,
                  int32_t* labels) {
  if (k < 1 || k > n) return 1;
  std::vector<int64_t> parent(2 * n - 1);
  for (int64_t i = 0; i < 2 * n - 1; ++i) parent[i] = i;
  auto find = [&](int64_t x) {
    while (parent[x] != x) {
      parent[x] = parent[parent[x]];
      x = parent[x];
    }
    return x;
  };
  for (int64_t t = 0; t < n - k; ++t) {
    int64_t a = static_cast<int64_t>(linkage[t * 4 + 0]);
    int64_t b = static_cast<int64_t>(linkage[t * 4 + 1]);
    parent[find(a)] = n + t;
    parent[find(b)] = n + t;
  }
  std::vector<int64_t> seen(2 * n - 1, 0);
  int32_t next_label = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t root = find(i);
    if (seen[root] == 0) seen[root] = ++next_label;
    labels[i] = static_cast<int32_t>(seen[root]);
  }
  return 0;
}

}  // extern "C"
