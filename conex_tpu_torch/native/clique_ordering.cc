// Native host-side clique-tree analysis for conex_tpu_torch.
//
// C++ implementation of the elimination-ordering pipeline in
// conex_tpu_torch/supernodal/ordering.py (itself modeled on the reference's
// clique_ordering.cc / tree_utils.cc): greedy DFS over the
// clique-intersection graph, root re-selection by max weighted degree,
// supernode/separator splitting, and fill-in via the running-intersection
// property.  This is sequential graph preprocessing — the part of the
// runtime that stays on the host — and is exposed through a plain C ABI
// consumed via ctypes (see conex_tpu_torch/native/__init__.py).
//
// Build: conex_tpu_torch/native/__init__.py runs g++ -O2 -std=c++17
// -shared -fPIC at first use.

#include <algorithm>
#include <cstdint>
#include <map>
#include <set>
#include <vector>

namespace {

using std::vector;

vector<int> intersection_sorted(const vector<int>& a, const vector<int>& b) {
  vector<int> out;
  std::set_intersection(a.begin(), a.end(), b.begin(), b.end(),
                        std::back_inserter(out));
  return out;
}

struct Analysis {
  vector<int> order;
  vector<vector<int>> supernodes;
  vector<vector<int>> separators;
  vector<int> parent;
  vector<int> height;
};

vector<int> path_in_tree(int x, int y, const vector<int>& parent,
                         const vector<int>& height) {
  vector<int> path;
  while (x != y) {
    if (height[x] < height[y]) {
      path.push_back(y);
      y = parent[y];
    } else {
      path.push_back(x);
      x = parent[x];
    }
  }
  path.push_back(x);
  return path;
}

int pick_order_helper(const vector<vector<int>>& cliques,
                      const vector<int>& valid_leaf, int root_in,
                      std::map<std::pair<int, int>, vector<int>>* memo,
                      vector<vector<int>>* separators, vector<int>* order,
                      vector<int>* parent, vector<int>* height) {
  const int n = static_cast<int>(cliques.size());

  auto get_intersection = [&](int a, int b) -> const vector<int>& {
    auto key = std::make_pair(std::min(a, b), std::max(a, b));
    auto it = memo->find(key);
    if (it == memo->end()) {
      it = memo->emplace(key, intersection_sorted(cliques[a], cliques[b]))
               .first;
    }
    return it->second;
  };
  auto get_weight = [&](int active, int i) -> long {
    long w = static_cast<long>(get_intersection(active, i).size());
    if (!valid_leaf.empty()) {
      if (!valid_leaf[i]) w += 10000;
      if (!valid_leaf[active]) w += 10000;
    }
    return w;
  };

  vector<int> visited(n, 0);
  vector<int> stack;
  stack.push_back(root_in < 0 ? 0 : root_in);
  vector<std::pair<int, int>> edges;
  order->clear();

  while (static_cast<int>(order->size()) < n) {
    int active = stack.back();
    if (!visited[active]) {
      order->push_back(active);
      visited[active] = 1;
      (*parent)[active] = active;
      (*height)[active] = 0;
    }

    long max_weight = 1;
    vector<int> argmax;
    for (int i = 0; i < n; i++) {
      if (i == active) continue;
      long w = get_weight(active, i);
      if (w >= max_weight && !visited[i]) {
        if (w > max_weight) {
          argmax.clear();
          max_weight = w;
        }
        argmax.push_back(i);
      }
    }

    for (int e : argmax) {
      (*separators)[e] = get_intersection(active, e);
      stack.push_back(e);
      order->push_back(e);
      visited[e] = 1;
      edges.emplace_back(active, e);
      (*parent)[e] = active;
      (*height)[e] = (*height)[active] + 1;
      if (!valid_leaf.empty() && !valid_leaf[e]) break;
    }

    if (argmax.empty()) {
      stack.pop_back();
      if (stack.empty()) {
        auto it = std::find(visited.begin(), visited.end(), 0);
        if (it == visited.end()) break;
        stack.push_back(static_cast<int>(it - visited.begin()));
      }
    }
  }

  vector<long> weights(n, 0);
  for (auto& e : edges) {
    long w = static_cast<long>(get_intersection(e.first, e.second).size());
    weights[e.first] += w;
    weights[e.second] += w;
  }
  int root_node = static_cast<int>(
      std::max_element(weights.begin(), weights.end()) - weights.begin());
  std::reverse(order->begin(), order->end());
  return root_node;
}

Analysis analyze(const vector<vector<int>>& cliques_in,
                 const vector<int>& valid_leaf, int root) {
  vector<vector<int>> cliques = cliques_in;
  for (auto& c : cliques) std::sort(c.begin(), c.end());
  const int n = static_cast<int>(cliques.size());

  Analysis a;
  std::map<std::pair<int, int>, vector<int>> memo;
  a.separators.assign(n, {});
  a.parent.resize(n);
  for (int i = 0; i < n; i++) a.parent[i] = i;
  a.height.assign(n, 0);
  int better = pick_order_helper(cliques, valid_leaf, root, &memo,
                                 &a.separators, &a.order, &a.parent,
                                 &a.height);
  if (root == -1) {
    a.separators.assign(n, {});
    a.order.clear();
    for (int i = 0; i < n; i++) a.parent[i] = i;
    a.height.assign(n, 0);
    pick_order_helper(cliques, valid_leaf, better, &memo, &a.separators,
                      &a.order, &a.parent, &a.height);
  }

  a.supernodes.assign(n, {});
  for (int e : a.order) {
    std::set<int> sep(a.separators[e].begin(), a.separators[e].end());
    for (int v : cliques[e]) {
      if (!sep.count(v)) a.supernodes[e].push_back(v);
    }
  }

  int num_vars = 0;
  for (auto& c : cliques) {
    for (int v : c) num_vars = std::max(num_vars, v + 1);
  }

  // Fill-in via running intersection property.
  vector<int> eliminated(num_vars, n + 1);
  for (size_t i = 0; i < a.order.size(); i++) {
    for (int v : a.supernodes[a.order[i]]) {
      if (eliminated[v] < n) {
        auto path = path_in_tree(a.order[i], eliminated[v], a.parent,
                                 a.height);
        for (size_t j = 0; j + 1 < path.size(); j++) {
          auto& sep = a.separators[path[j]];
          if (!std::binary_search(sep.begin(), sep.end(), v)) {
            sep.insert(std::upper_bound(sep.begin(), sep.end(), v), v);
          }
        }
        eliminated[v] = path.back();
      } else {
        eliminated[v] = a.order[i];
      }
    }
  }
  for (auto& s : a.supernodes) s.clear();
  for (int v = 0; v < num_vars; v++) {
    if (eliminated[v] < n) a.supernodes[eliminated[v]].push_back(v);
  }
  for (auto& s : a.supernodes) std::sort(s.begin(), s.end());
  for (auto& s : a.separators) std::sort(s.begin(), s.end());
  return a;
}

void write_ragged(const vector<vector<int>>& rows, int32_t* offsets,
                  int32_t* data) {
  int32_t pos = 0;
  for (size_t i = 0; i < rows.size(); i++) {
    offsets[i] = pos;
    for (int v : rows[i]) data[pos++] = v;
  }
  offsets[rows.size()] = pos;
}

}  // namespace

extern "C" {

// Inputs: ragged cliques (offsets of size n+1, data), optional valid_leaf
// (null => none), root (-1 => auto).  Outputs: order (n), parent (n),
// height (n), supernode offsets (n+1) + data, separator offsets (n+1) +
// data.  Data buffers must hold >= n * num_vars entries.  Returns 0.
int conex_tpu_clique_order(int n_cliques, const int32_t* clique_offsets,
                           const int32_t* clique_data,
                           const int32_t* valid_leaf, int root,
                           int32_t* order, int32_t* parent, int32_t* height,
                           int32_t* sup_offsets, int32_t* sup_data,
                           int32_t* sep_offsets, int32_t* sep_data) {
  vector<vector<int>> cliques(n_cliques);
  for (int i = 0; i < n_cliques; i++) {
    for (int32_t j = clique_offsets[i]; j < clique_offsets[i + 1]; j++) {
      cliques[i].push_back(clique_data[j]);
    }
  }
  vector<int> vl;
  if (valid_leaf) vl.assign(valid_leaf, valid_leaf + n_cliques);

  Analysis a = analyze(cliques, vl, root);

  for (int i = 0; i < n_cliques; i++) {
    order[i] = a.order[i];
    parent[i] = a.parent[i];
    height[i] = a.height[i];
  }
  write_ragged(a.supernodes, sup_offsets, sup_data);
  write_ragged(a.separators, sep_offsets, sep_data);
  return 0;
}

}  // extern "C"
