// fedml_tpu_torch native scheduler (the port's copy of the JAX package's
// native/scheduler.cpp; built into fedml_tpu_torch/native/build/).
//
// Native implementation of the heterogeneity-aware workload scheduler
// (reference: python/fedml/core/schedule/scheduler.py — DP /
// branch-and-bound makespan minimization). Two entry points exported
// with C linkage for the ctypes binding (fedml_tpu_torch/core/native.py):
//
//   lpt_makespan  — heap-based LPT greedy, O(n log n + n log m)
//   bnb_makespan  — exact branch & bound (LPT seed as incumbent,
//                   load-max + remaining-work lower bounds, symmetry
//                   breaking on empty resources, node budget cap)
//
// Assignments are returned as per-job resource ids.

#include <algorithm>
#include <cstdint>
#include <numeric>
#include <queue>
#include <vector>

namespace {

struct Res {
  double load;
  int id;
  bool operator>(const Res& o) const { return load > o.load; }
};

double lpt(const double* w, int n, int m, int* assign) {
  std::vector<int> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::sort(order.begin(), order.end(),
            [&](int a, int b) { return w[a] > w[b]; });
  std::priority_queue<Res, std::vector<Res>, std::greater<Res>> heap;
  for (int r = 0; r < m; ++r) heap.push({0.0, r});
  double makespan = 0.0;
  for (int j : order) {
    Res r = heap.top();
    heap.pop();
    assign[j] = r.id;
    r.load += w[j];
    makespan = std::max(makespan, r.load);
    heap.push(r);
  }
  return makespan;
}

struct BnB {
  const double* w;
  int n, m;
  std::vector<int> order;       // jobs sorted descending
  std::vector<double> suffix;   // remaining work from position i
  std::vector<int> best_assign; // per sorted-position resource
  double best;
  int64_t nodes, node_budget;

  void dfs(int pos, std::vector<double>& loads, std::vector<int>& cur) {
    if (nodes++ > node_budget) return;
    if (pos == n) {
      double ms = *std::max_element(loads.begin(), loads.end());
      if (ms < best) {
        best = ms;
        best_assign = cur;
      }
      return;
    }
    // lower bound: max(current max load, avg of remaining over gaps)
    double mx = *std::max_element(loads.begin(), loads.end());
    double total = std::accumulate(loads.begin(), loads.end(), 0.0) + suffix[pos];
    double lb = std::max(mx, total / m);
    if (lb >= best) return;
    int job = order[pos];
    bool tried_empty = false;
    for (int r = 0; r < m; ++r) {
      if (loads[r] == 0.0) {
        if (tried_empty) continue;  // symmetry: all empty resources equal
        tried_empty = true;
      }
      if (loads[r] + w[job] >= best) continue;
      loads[r] += w[job];
      cur[pos] = r;
      dfs(pos + 1, loads, cur);
      loads[r] -= w[job];
    }
  }
};

}  // namespace

extern "C" {

// Returns the makespan; fills assign[n] with resource ids.
double lpt_makespan(const double* workloads, int n_jobs, int n_resources,
                    int* assign) {
  if (n_jobs <= 0 || n_resources <= 0) return 0.0;
  return lpt(workloads, n_jobs, n_resources, assign);
}

// Exact (within node budget) makespan. Returns achieved makespan and
// fills assign. Falls back to the LPT incumbent when the budget trips.
double bnb_makespan(const double* workloads, int n_jobs, int n_resources,
                    int64_t node_budget, int* assign) {
  if (n_jobs <= 0 || n_resources <= 0) return 0.0;
  std::vector<int> lpt_assign(n_jobs);
  double ub = lpt(workloads, n_jobs, n_resources, lpt_assign.data());

  BnB b;
  b.w = workloads;
  b.n = n_jobs;
  b.m = n_resources;
  b.order.resize(n_jobs);
  std::iota(b.order.begin(), b.order.end(), 0);
  std::sort(b.order.begin(), b.order.end(),
            [&](int x, int y) { return workloads[x] > workloads[y]; });
  b.suffix.assign(n_jobs + 1, 0.0);
  for (int i = n_jobs - 1; i >= 0; --i)
    b.suffix[i] = b.suffix[i + 1] + workloads[b.order[i]];
  b.best = ub + 1e-12;
  b.nodes = 0;
  b.node_budget = node_budget > 0 ? node_budget : (1 << 22);
  std::vector<double> loads(n_resources, 0.0);
  std::vector<int> cur(n_jobs, 0);
  b.dfs(0, loads, cur);

  if (b.best_assign.empty()) {
    std::copy(lpt_assign.begin(), lpt_assign.end(), assign);
    return ub;
  }
  for (int pos = 0; pos < n_jobs; ++pos) assign[b.order[pos]] = b.best_assign[pos];
  return b.best;
}
}
