// Single-period demand-driven hydraulic solver — C++ component.
//
// Native equivalent of the EPANET C library the reference drives through
// ctypes (reference: epynet's EN_runH at Executorv7.py:325-347, EN_set*
// wrappers at epynet_utils.py:94-254). Implements the Global Gradient
// Algorithm exactly as gnn_pressure_estimation_tpu/simgen/solver_py.py (the
// NumPy oracle); both operate in EPANET internal units (feet, cfs) with
// EPANET's constants (4.727 Hazen-Williams, 0.02517 minor loss, 2g = 64.4).
//
// The linear system (SPD junction-head matrix) is solved exactly with a
// sparse Cholesky factorization under a minimum-degree ordering — the same
// approach as EPANET's own smatrix.c (MDO + sparse LDL). The sparsity
// pattern is fixed across GGA iterations (only values change), so the
// ordering + symbolic analysis run once per solve and each iteration does a
// numeric refactor + two triangular solves (O(fill) work; a 23k-junction
// grid network factors in ~10 ms where the previous Jacobi-CG burned ~1000
// iterations per GGA step — 33 s/scenario → ~0.3 s). The hydraulic matrix
// spans ~16 orders of magnitude (closed links 1/CBIG, PRV rows CBIG, the
// 1e-12 isolated-junction floor), which defeats incomplete-factorization
// preconditioners, so the direct factorization is also the robust choice.
// An IC(0)-preconditioned CG remains as fallback for the (numerically
// near-singular) cases where a Cholesky pivot goes nonpositive. The
// scenario-generation hot loop calls hyd_solve once per scenario from a
// host process pool.
//
// Build: make -C gnn_pressure_estimation_tpu/simgen/solver  (produces
// libhydraulic.so; the Python binding is simgen/solver_cpp.py via ctypes).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <queue>
#include <vector>

namespace {

constexpr double CBIG = 1e8;
constexpr double CSMALL = 1e-6;
constexpr double RQTOL = 1e-7;
constexpr double QTOL = 1e-4;
constexpr double HTOL = 5e-4;
constexpr double TINY_Q = 1e-6;
constexpr double HW_EXP = 1.852;
constexpr double GRAV2 = 64.4;
constexpr double PI = 3.14159265358979323846;

enum Status { ST_CLOSED = 0, ST_OPEN = 1, ST_ACTIVE = 2 };
enum LinkType { LT_PIPE = 0, LT_PUMP = 1, LT_VALVE = 2 };
enum ValveType { V_PRV = 0, V_PSV = 1, V_PBV = 2, V_FCV = 3, V_TCV = 4, V_GPV = 5 };

struct Net {
  int n_nodes, n_junctions, n_links;
  const int *link_type, *node1, *node2, *valve_type;
  const uint8_t* check_valve;
  const double *elevation, *fixed_head, *demand;
  const double *length, *diameter, *roughness, *minor_loss;
  const double *pump_h0, *pump_r, *pump_n, *pump_speed, *pump_power;
  const double* valve_setting;
  int headloss_model;
  double viscosity;
};

inline double sgn(double x) { return x >= 0 ? 1.0 : -1.0; }

// Assembled SPD junction system: separate diagonal + strict-lower-triangle
// CSR (columns sorted ascending within each row).  The pattern is fixed for
// the whole GGA solve — parallel links between the same junction pair share
// one slot — so it is built once and only the values are refilled each
// iteration.  An IC(0) factor on the same pattern preconditions CG; if the
// incomplete factorization hits a nonpositive pivot (possible off the
// M-matrix path, e.g. under extreme CBIG rows) the factorization retries
// with a boosted diagonal and finally falls back to Jacobi.
struct JuncSys {
  int n = 0;
  std::vector<int> lptr, lcol;      // strict lower CSR pattern
  std::vector<int> slot;            // per-link slot into vals, or -1
  std::vector<double> vals, diag;   // A (lower) values + diagonal
  std::vector<double> Lv, Ld;       // IC(0) factor on the same pattern
  bool ic_ok = false;
  // PCG work vectors (persist across GGA iterations)
  std::vector<double> r, z, p, Ap, y;

  void build_pattern(int nj, int L, const int* node1, const int* node2) {
    n = nj;
    slot.assign(L, -1);
    // unique (hi, lo) junction pairs, sorted → CSR rows by hi
    std::vector<std::pair<int, int>> pairs;
    pairs.reserve(L);
    for (int k = 0; k < L; ++k) {
      int a = node1[k], b = node2[k];
      if (a < nj && b < nj && a != b)
        pairs.emplace_back(std::max(a, b), std::min(a, b));
    }
    std::sort(pairs.begin(), pairs.end());
    pairs.erase(std::unique(pairs.begin(), pairs.end()), pairs.end());
    lptr.assign(n + 1, 0);
    lcol.resize(pairs.size());
    for (size_t s = 0; s < pairs.size(); ++s) {
      lptr[pairs[s].first + 1]++;
      lcol[s] = pairs[s].second;
    }
    for (int i = 0; i < n; ++i) lptr[i + 1] += lptr[i];
    for (int k = 0; k < L; ++k) {
      int a = node1[k], b = node2[k];
      if (!(a < nj && b < nj && a != b)) continue;
      std::pair<int, int> key(std::max(a, b), std::min(a, b));
      size_t s = std::lower_bound(pairs.begin(), pairs.end(), key) - pairs.begin();
      slot[k] = (int)s;
    }
    vals.resize(pairs.size());
    Lv.resize(pairs.size());
    diag.resize(n);
    Ld.resize(n);
    r.resize(n); z.resize(n); p.resize(n); Ap.resize(n); y.resize(n);
  }

  // IC(0): L L^T ≈ A on A's own pattern; `boost` scales the diagonal.
  bool factor(double boost) {
    for (int i = 0; i < n; ++i) {
      const int s0 = lptr[i], s1 = lptr[i + 1];
      double d = diag[i] * boost;
      for (int s = s0; s < s1; ++s) {
        const int j = lcol[s];
        double sum = vals[s];
        // intersect row i's earlier columns with row j's columns
        int si = s0, sj = lptr[j];
        const int sj1 = lptr[j + 1];
        while (si < s && sj < sj1) {
          const int ci = lcol[si], cj = lcol[sj];
          if (ci == cj) { sum -= Lv[si] * Lv[sj]; ++si; ++sj; }
          else if (ci < cj) ++si;
          else ++sj;
        }
        Lv[s] = sum / Ld[j];
        d -= Lv[s] * Lv[s];
      }
      if (!(d > 0.0) || !std::isfinite(d)) return false;
      Ld[i] = std::sqrt(d);
    }
    return true;
  }

  void refactor() {
    ic_ok = factor(1.0) || factor(1.0 + 1e-3) || factor(1.0 + 1e-1);
  }

  void matvec(const std::vector<double>& v, std::vector<double>& out) const {
    for (int i = 0; i < n; ++i) out[i] = diag[i] * v[i];
    for (int i = 0; i < n; ++i) {
      const double vi = v[i];
      double acc = 0;
      for (int s = lptr[i]; s < lptr[i + 1]; ++s) {
        const int j = lcol[s];
        acc += vals[s] * v[j];
        out[j] += vals[s] * vi;
      }
      out[i] += acc;
    }
  }

  // z = (L L^T)^{-1} rhs, or Jacobi when the IC factor is unavailable
  void precond(const std::vector<double>& rhs, std::vector<double>& out) {
    if (!ic_ok) {
      for (int i = 0; i < n; ++i) out[i] = rhs[i] / diag[i];
      return;
    }
    for (int i = 0; i < n; ++i) {          // forward:  L y = rhs
      double t = rhs[i];
      for (int s = lptr[i]; s < lptr[i + 1]; ++s) t -= Lv[s] * y[lcol[s]];
      y[i] = t / Ld[i];
    }
    out = y;                               // backward: L^T z = y
    for (int i = n - 1; i >= 0; --i) {
      out[i] /= Ld[i];
      const double zi = out[i];
      for (int s = lptr[i]; s < lptr[i + 1]; ++s) out[lcol[s]] -= Lv[s] * zi;
    }
  }

  // Preconditioned CG; returns false on breakdown / non-convergence.
  bool solve(const std::vector<double>& b, std::vector<double>& x) {
    refactor();
    matvec(x, Ap);
    double bnorm = 0;
    for (int i = 0; i < n; ++i) {
      r[i] = b[i] - Ap[i];
      bnorm += b[i] * b[i];
    }
    bnorm = std::sqrt(bnorm);
    if (bnorm < 1e-30) { std::fill(x.begin(), x.end(), 0.0); return true; }
    precond(r, z);
    p = z;
    double rz = 0;
    for (int i = 0; i < n; ++i) rz += r[i] * z[i];
    const double tol = 1e-12 * bnorm;
    const int max_it = std::max(200, 4 * n);
    for (int it = 0; it < max_it; ++it) {
      double rn = 0;
      for (int i = 0; i < n; ++i) rn += r[i] * r[i];
      if (std::sqrt(rn) < tol) return true;
      matvec(p, Ap);
      double pAp = 0;
      for (int i = 0; i < n; ++i) pAp += p[i] * Ap[i];
      if (pAp <= 0 || !std::isfinite(pAp)) return false;
      const double alpha = rz / pAp;
      for (int i = 0; i < n; ++i) {
        x[i] += alpha * p[i];
        r[i] -= alpha * Ap[i];
      }
      precond(r, z);
      double rz_new = 0;
      for (int i = 0; i < n; ++i) rz_new += r[i] * z[i];
      const double beta = rz_new / rz;
      rz = rz_new;
      for (int i = 0; i < n; ++i) p[i] = z[i] + beta * p[i];
    }
    double rn = 0;
    for (int i = 0; i < n; ++i) rn += r[i] * r[i];
    return std::sqrt(rn) < 1e-6 * bnorm;  // loose acceptance
  }
};

// Minimum-degree ordering on the junction graph (lazy-heap elimination-graph
// variant with stale-entry skipping; clique merges keep adjacency sorted).
// Quality is what matters — it runs once per hydraulic solve.
//
// Degree-cap bailout: clique merges materialize full fill adjacency, which
// can degrade superlinearly on irregular high-fill inputs.  Once a pivot's
// eliminated degree exceeds max(64, 4·√n) we stop updating the elimination
// graph for that pivot — remaining nodes still drain in (now approximate)
// degree order.  Any permutation is valid (the symbolic analysis computes
// the true fill for whatever order we emit); the cap only bounds ordering
// cost.  WDN grids never hit it; adversarial dense inputs stay O(n·cap²).
std::vector<int> mindeg_order(int n, std::vector<std::vector<int>> adj) {
  std::vector<int> order;
  order.reserve(n);
  std::vector<char> dead(n, 0);
  const int degree_cap = std::max(64, 4 * (int)std::sqrt((double)n));
  using DN = std::pair<int, int>;  // (degree, node)
  std::priority_queue<DN, std::vector<DN>, std::greater<DN>> pq;
  for (int i = 0; i < n; ++i) pq.push({(int)adj[i].size(), i});
  std::vector<int> nbrs, merged;
  while (!pq.empty()) {
    auto [d, v] = pq.top();
    pq.pop();
    if (dead[v] || d != (int)adj[v].size()) continue;  // stale entry
    dead[v] = 1;
    order.push_back(v);
    if (d > degree_cap) {  // bailout: eliminate without clique merge
      adj[v].clear();
      adj[v].shrink_to_fit();
      continue;
    }
    nbrs.clear();
    for (int u : adj[v])
      if (!dead[u]) nbrs.push_back(u);
    adj[v].clear();
    adj[v].shrink_to_fit();
    for (int u : nbrs) {
      // adj[u] ← (alive(adj[u]) ∪ nbrs) \ {u}
      merged.clear();
      size_t a = 0, b = 0;
      const auto& au = adj[u];
      while (a < au.size() || b < nbrs.size()) {
        int ca = a < au.size() ? au[a] : INT32_MAX;
        int cb = b < nbrs.size() ? nbrs[b] : INT32_MAX;
        int c = std::min(ca, cb);
        if (ca == c) ++a;
        if (cb == c) ++b;
        if (c != u && !dead[c]) merged.push_back(c);
      }
      adj[u].swap(merged);
      pq.push({(int)adj[u].size(), u});
    }
  }
  // isolated / unreached nodes (shouldn't happen, but stay total)
  for (int i = 0; i < n; ++i)
    if (!dead[i]) order.push_back(i);
  return order;
}

// Exact sparse Cholesky (up-looking, CSparse-style) on the junction system
// under a minimum-degree permutation.  Symbolic analysis (etree, column
// counts, L pattern, per-row reach lists) happens once; `factor` refills the
// numeric values each GGA iteration in O(fill) time.
struct SparseChol {
  int n = 0;
  std::vector<int> order, pos;           // order[k] = orig node; pos = inverse
  std::vector<int> acol_ptr, acol_row;   // A col k: permuted rows i < k
  std::vector<int> acol_slot;            //   matching slots into JuncSys vals
  std::vector<int> er_ptr, er_idx;       // per-row ereach lists (topo order)
  std::vector<int> Lp, Li, c;            // L columns (rows ascending), cursor
  std::vector<double> Lx, x, yw;

  void build(int nj, const std::vector<int>& lptr,
             const std::vector<int>& lcol) {
    n = nj;
    // junction adjacency from the assembled lower pattern
    std::vector<std::vector<int>> adj(n);
    for (int i = 0; i < n; ++i)
      for (int s = lptr[i]; s < lptr[i + 1]; ++s) {
        adj[i].push_back(lcol[s]);
        adj[lcol[s]].push_back(i);
      }
    for (auto& a : adj) std::sort(a.begin(), a.end());
    order = mindeg_order(n, std::move(adj));
    pos.assign(n, 0);
    for (int k = 0; k < n; ++k) pos[order[k]] = k;

    // permuted A columns: entry (hi, lo) at slot s lands in column
    // max(pos) with row min(pos)
    std::vector<int> cnt(n + 1, 0);
    for (int i = 0; i < n; ++i)
      for (int s = lptr[i]; s < lptr[i + 1]; ++s)
        cnt[std::max(pos[i], pos[lcol[s]]) + 1]++;
    acol_ptr.assign(n + 1, 0);
    for (int k = 0; k < n; ++k) acol_ptr[k + 1] = acol_ptr[k] + cnt[k + 1];
    acol_row.resize(acol_ptr[n]);
    acol_slot.resize(acol_ptr[n]);
    std::vector<int> fill = acol_ptr;
    for (int i = 0; i < n; ++i)
      for (int s = lptr[i]; s < lptr[i + 1]; ++s) {
        int a = pos[i], b = pos[lcol[s]];
        int K = std::max(a, b), I = std::min(a, b);
        acol_row[fill[K]] = I;
        acol_slot[fill[K]] = s;
        fill[K]++;
      }

    // elimination tree (ancestor path compression)
    std::vector<int> parent(n, -1), ancestor(n, -1);
    for (int k = 0; k < n; ++k)
      for (int p = acol_ptr[k]; p < acol_ptr[k + 1]; ++p) {
        int j = acol_row[p];
        while (j != -1 && j < k) {
          int jn = ancestor[j];
          ancestor[j] = k;
          if (jn == -1) { parent[j] = k; break; }
          j = jn;
        }
      }

    // ereach per row k (topological order) + column counts
    std::vector<int> mark(n, -1), stack(n), colcount(n, 1);  // 1 = diagonal
    er_ptr.assign(n + 1, 0);
    er_idx.clear();
    er_idx.reserve(4 * acol_ptr[n]);
    for (int k = 0; k < n; ++k) {
      mark[k] = k;
      int base = (int)er_idx.size();
      for (int p = acol_ptr[k]; p < acol_ptr[k + 1]; ++p) {
        int top = 0;
        for (int j = acol_row[p]; j >= 0 && j < k && mark[j] != k;
             j = parent[j]) {
          stack[top++] = j;
          mark[j] = k;
        }
        for (int t = 0; t < top; ++t) er_idx.push_back(stack[t]);
      }
      // ascending index order is a topological order of the etree
      // (parent[j] > j), which is what the up-looking factor requires
      std::sort(er_idx.begin() + base, er_idx.end());
      for (size_t q = base; q < er_idx.size(); ++q) colcount[er_idx[q]]++;
      er_ptr[k + 1] = (int)er_idx.size();
    }

    Lp.assign(n + 1, 0);
    for (int j = 0; j < n; ++j) Lp[j + 1] = Lp[j] + colcount[j];
    Li.assign(Lp[n], 0);
    Lx.assign(Lp[n], 0.0);
    c.assign(n, 0);
    // prefill the fixed row pattern: column j gets row k appended when row
    // k's reach contains j (ascending k ⇒ ascending rows)
    for (int j = 0; j < n; ++j) {
      c[j] = Lp[j];
      Li[c[j]++] = j;  // diagonal first
    }
    for (int k = 0; k < n; ++k)
      for (int p = er_ptr[k]; p < er_ptr[k + 1]; ++p) Li[c[er_idx[p]]++] = k;
    x.assign(n, 0.0);
    yw.assign(n, 0.0);
  }

  // Numeric refactor from the assembled values; false on nonpositive pivot.
  bool factor(const std::vector<double>& vals, const std::vector<double>& diag) {
    for (int j = 0; j < n; ++j) c[j] = Lp[j] + 1;
    for (int k = 0; k < n; ++k) {
      for (int p = acol_ptr[k]; p < acol_ptr[k + 1]; ++p)
        x[acol_row[p]] = vals[acol_slot[p]];
      double d = diag[order[k]];
      for (int q = er_ptr[k]; q < er_ptr[k + 1]; ++q) {
        const int i = er_idx[q];
        const double lki = x[i] / Lx[Lp[i]];
        x[i] = 0.0;
        for (int p = Lp[i] + 1; p < c[i]; ++p) x[Li[p]] -= Lx[p] * lki;
        d -= lki * lki;
        Lx[c[i]++] = lki;
      }
      if (!(d > 0.0) || !std::isfinite(d)) {
        // clear any scattered values before bailing (x is reused)
        for (int p = acol_ptr[k]; p < acol_ptr[k + 1]; ++p)
          x[acol_row[p]] = 0.0;
        for (int q = er_ptr[k]; q < er_ptr[k + 1]; ++q) x[er_idx[q]] = 0.0;
        return false;
      }
      Lx[Lp[k]] = std::sqrt(d);
    }
    return true;
  }

  // Solve A x = b (original index space) via P A Pᵀ = L Lᵀ.
  void solve(const std::vector<double>& b, std::vector<double>& out) {
    for (int k = 0; k < n; ++k) yw[k] = b[order[k]];
    for (int j = 0; j < n; ++j) {
      yw[j] /= Lx[Lp[j]];
      const double yj = yw[j];
      for (int p = Lp[j] + 1; p < Lp[j + 1]; ++p) yw[Li[p]] -= Lx[p] * yj;
    }
    for (int j = n - 1; j >= 0; --j) {
      double t = yw[j];
      for (int p = Lp[j] + 1; p < Lp[j + 1]; ++p) t -= Lx[p] * yw[Li[p]];
      yw[j] = t / Lx[Lp[j]];
    }
    for (int k = 0; k < n; ++k) out[order[k]] = yw[k];
  }
};

double dw_friction(double e, double d, double q, double visc) {
  double Re = std::max(4.0 * std::fabs(q) / (PI * d * visc), 1.0);
  if (Re < 2000.0) return 64.0 / Re;
  double arg4 = e / (3.7 * d) + 5.74 / std::pow(4000.0, 0.9);
  double f_hi = 0.25 / std::pow(std::log10(arg4), 2);
  if (Re > 4000.0) {
    double arg = e / (3.7 * d) + 5.74 / std::pow(Re, 0.9);
    return 0.25 / std::pow(std::log10(arg), 2);
  }
  double x = (Re - 2000.0) / 2000.0;
  double blend = x * x * (3.0 - 2.0 * x);
  double f_lo = 64.0 / 2000.0;
  return f_lo + blend * (f_hi - f_lo);
}

}  // namespace

extern "C" {

// Returns warn code: 0 ok, 1 unbalanced, 110 linear-solve failure.
// Outputs: head [n_nodes] ft, flow [n_links] cfs, status_out [n_links].
int hyd_solve(
    int n_nodes, int n_junctions, int n_links,
    const double* elevation, const double* fixed_head, const double* demand,
    const int* link_type, const int* node1, const int* node2,
    const int* status_in, const uint8_t* check_valve,
    const double* length, const double* diameter, const double* roughness,
    const double* minor_loss,
    const double* pump_h0, const double* pump_r, const double* pump_n,
    const double* pump_speed, const double* pump_power,
    const int* valve_type, const double* valve_setting,
    int headloss_model, double viscosity,
    int max_iter, double accuracy,
    double* head, double* flow, int* status_out, int* iters_out) {
  const int n = n_nodes, nj = n_junctions, L = n_links;

  std::vector<int> status(status_in, status_in + L);
  std::vector<double> q(L), area(L), r_pipe(L, 0.0), m_minor(L, 0.0);

  for (int k = 0; k < L; ++k) {
    double d = std::max(diameter[k], 1e-6);
    area[k] = PI * d * d / 4.0;
    m_minor[k] = 0.02517 * minor_loss[k] / (d * d * d * d);
    if (link_type[k] == LT_PIPE) {
      double Ld = length[k], c = std::max(roughness[k], 1e-6);
      if (headloss_model == 0) {
        r_pipe[k] = 4.727 * Ld / std::pow(c, HW_EXP) / std::pow(d, 4.871);
      } else if (headloss_model == 2) {
        double Rh = d / 4.0;
        r_pipe[k] = Ld * std::pow(c / 1.49, 2) / (area[k] * area[k] * std::pow(Rh, 4.0 / 3.0));
      } else {
        r_pipe[k] = Ld / (GRAV2 * d * area[k] * area[k]);
      }
    }
    // initial flow: 1 fps; pumps start near curve reference flow
    if (link_type[k] == LT_PUMP) {
      if (pump_r[k] > 0 && pump_h0[k] > 0) {
        q[k] = std::max(std::pow(pump_h0[k] / (4.0 * pump_r[k]), 1.0 / pump_n[k]), TINY_Q);
      } else {
        q[k] = std::max(area[k], TINY_Q);
      }
    } else {
      q[k] = std::max(PI * std::max(diameter[k], 1e-3) * std::max(diameter[k], 1e-3) / 4.0, TINY_Q);
    }
    // valves with unset settings behave as open
    if (link_type[k] == LT_VALVE && status[k] == ST_ACTIVE &&
        (valve_type[k] == V_PRV || valve_type[k] == V_PSV ||
         valve_type[k] == V_PBV || valve_type[k] == V_FCV) &&
        valve_setting[k] <= 0.0) {
      status[k] = ST_OPEN;
    }
  }

  std::vector<double> H(fixed_head, fixed_head + n);
  for (int i = 0; i < nj; ++i) H[i] = elevation[i] + 30.0;

  std::vector<double> p(L), y(L), X(n), F(nj);
  JuncSys sys;
  sys.build_pattern(nj, L, node1, node2);  // pattern fixed across iterations
  SparseChol chol;
  chol.build(nj, sys.lptr, sys.lcol);      // ordering + symbolic, once
  double relerr = 1e30;
  bool status_changed = true;
  int it = 1;

  for (it = 1; it <= max_iter; ++it) {
    std::fill(X.begin(), X.end(), 0.0);
    for (int k = 0; k < L; ++k) {
      X[node2[k]] += q[k];
      X[node1[k]] -= q[k];
    }
    for (int i = 0; i < n; ++i) X[i] -= demand[i];

    std::vector<std::pair<int, double>> prv_rows;

    for (int k = 0; k < L; ++k) {
      double qa = std::max(std::fabs(q[k]), TINY_Q);
      switch (link_type[k]) {
        case LT_PIPE: {
          if (status[k] == ST_CLOSED) { p[k] = 1.0 / CBIG; y[k] = q[k]; break; }
          double hl, grad, r = r_pipe[k];
          if (headloss_model == 0) {
            hl = r * std::pow(qa, HW_EXP);
            grad = HW_EXP * r * std::pow(qa, HW_EXP - 1.0);
          } else {
            if (headloss_model == 1) r *= dw_friction(roughness[k], std::max(diameter[k], 1e-6), q[k], viscosity);
            hl = r * qa * qa;
            grad = 2.0 * r * qa;
          }
          hl += m_minor[k] * qa * qa;
          grad += 2.0 * m_minor[k] * qa;
          grad = std::max(grad, RQTOL);
          p[k] = 1.0 / grad;
          y[k] = hl * sgn(q[k]) / grad;
          break;
        }
        case LT_PUMP: {
          double w = pump_speed[k];
          if (status[k] == ST_CLOSED || w <= TINY_Q) { p[k] = 1.0 / CBIG; y[k] = q[k]; break; }
          double qq = std::max(q[k], TINY_Q), hgain, grad;
          if (pump_power[k] > 0) {
            hgain = 8.814 * pump_power[k] / qq;
            grad = std::min(8.814 * pump_power[k] / (qq * qq), CBIG);
          } else {
            double h0 = pump_h0[k] * w * w;
            double nn = pump_n[k];
            double rr = pump_r[k] * std::pow(w, 2.0 - nn);
            hgain = h0 - rr * std::pow(qq, nn);
            grad = std::max(nn * rr * std::pow(qq, nn - 1.0), RQTOL);
          }
          p[k] = 1.0 / grad;
          y[k] = -hgain / grad;
          break;
        }
        case LT_VALVE: {
          int vt = valve_type[k];
          int st = status[k];
          if (st == ST_CLOSED) { p[k] = 1.0 / CBIG; y[k] = q[k]; break; }
          if (st == ST_ACTIVE && vt == V_PRV) {
            p[k] = 0.0;
            y[k] = X[node2[k]];
            prv_rows.emplace_back(node2[k], elevation[node2[k]] + valve_setting[k]);
            break;
          }
          if (st == ST_ACTIVE && vt == V_PSV) {
            p[k] = 0.0;
            y[k] = -X[node1[k]];
            prv_rows.emplace_back(node1[k], elevation[node1[k]] + valve_setting[k]);
            break;
          }
          if (st == ST_ACTIVE && vt == V_PBV) { p[k] = CBIG; y[k] = CBIG * valve_setting[k]; break; }
          if (st == ST_ACTIVE && vt == V_FCV) {
            // EPANET fcvcoeff: fixed-flow injection through a tiny
            // conductance (q_new = setting + dh/CBIG) so junction
            // continuity stays exact even for an infeasible setting
            p[k] = 1.0 / CBIG;
            y[k] = q[k] - valve_setting[k];
            break;
          }
          double K = (vt == V_TCV && st == ST_ACTIVE) ? valve_setting[k] : minor_loss[k];
          double m = 0.02517 * K / std::pow(std::max(diameter[k], 1e-6), 4);
          double grad = std::max(2.0 * m * qa, CSMALL);
          p[k] = 1.0 / grad;
          y[k] = m * qa * qa * sgn(q[k]) / grad;
          break;
        }
      }
    }

    // assemble junction system into the fixed pattern (values only)
    std::fill(sys.vals.begin(), sys.vals.end(), 0.0);
    for (int i = 0; i < nj; ++i) {
      sys.diag[i] = 1e-12;
      F[i] = -demand[i];
    }
    for (int k = 0; k < L; ++k) {
      int a = node1[k], b = node2[k];
      if (a == b) continue;  // self-loop link: no net junction contribution
      double qy = q[k] - y[k];
      if (b < nj) F[b] += qy;
      if (a < nj) F[a] -= qy;
      double pl = p[k];
      if (pl == 0.0) continue;
      bool ja = a < nj, jb = b < nj;
      if (ja) {
        sys.diag[a] += pl;
        if (!jb) F[a] += pl * H[b];
      }
      if (jb) {
        sys.diag[b] += pl;
        if (!ja) F[b] += pl * H[a];
      }
      if (ja && jb) sys.vals[sys.slot[k]] -= pl;
    }
    for (auto& pr : prv_rows) {
      if (pr.first < nj) { sys.diag[pr.first] += CBIG; F[pr.first] += CBIG * pr.second; }
    }

    std::vector<double> Hj(H.begin(), H.begin() + nj);
    bool solved;
    if (chol.factor(sys.vals, sys.diag)) {
      chol.solve(F, Hj);
      solved = true;
    } else {
      // near-singular pivot: fall back to IC(0)/Jacobi-preconditioned CG
      solved = sys.solve(F, Hj);
    }
    if (!solved) {
      for (int i = 0; i < n; ++i) head[i] = H[i];
      for (int k = 0; k < L; ++k) { flow[k] = q[k]; status_out[k] = status[k]; }
      *iters_out = it;
      return 110;
    }
    bool finite = true;
    for (int i = 0; i < nj; ++i) finite = finite && std::isfinite(Hj[i]);
    if (!finite) {
      for (int i = 0; i < n; ++i) head[i] = H[i];
      for (int k = 0; k < L; ++k) { flow[k] = q[k]; status_out[k] = status[k]; }
      *iters_out = it;
      return 110;
    }
    for (int i = 0; i < nj; ++i) H[i] = Hj[i];

    // flow update
    double sum_dq = 0, sum_q = 0;
    for (int k = 0; k < L; ++k) {
      double dh = H[node1[k]] - H[node2[k]];
      double qn = (q[k] - y[k]) + p[k] * dh;
      sum_dq += std::fabs(qn - q[k]);
      sum_q += std::fabs(qn);
      q[k] = qn;
    }
    relerr = sum_dq / std::max(sum_q, TINY_Q);

    // status checks — EPANET schedule: pumps/CVs every CheckFreq=2 while
    // it<=MaxCheck=10, PRV/PSV every iteration while it<=MaxCheck; after
    // that only at flow convergence (prevents parallel-pump flip-flop).
    const int MAXCHECK = 10, CHECKFREQ = 2;
    bool flow_conv = relerr < accuracy;
    bool check_links = (it <= MAXCHECK && it % CHECKFREQ == 0) || flow_conv;
    bool check_valves = (it <= MAXCHECK) || flow_conv;
    status_changed = false;
    for (int k = 0; k < L; ++k) {
      double dh = H[node1[k]] - H[node2[k]];
      if (!check_links && (link_type[k] == LT_PIPE || link_type[k] == LT_PUMP)) continue;
      if (!check_valves && link_type[k] == LT_VALVE) continue;
      if (link_type[k] == LT_PIPE && check_valve[k]) {
        if (status[k] == ST_OPEN && (dh < -HTOL || q[k] < -QTOL)) {
          status[k] = ST_CLOSED; q[k] = TINY_Q; status_changed = true;
        } else if (status[k] == ST_CLOSED && dh > HTOL) {
          status[k] = ST_OPEN; q[k] = TINY_Q; status_changed = true;
        }
      } else if (link_type[k] == LT_PUMP && status_in[k] != ST_CLOSED) {
        double w = pump_speed[k];
        double hmax = (pump_power[k] == 0) ? pump_h0[k] * w * w : CBIG;
        if (status[k] == ST_OPEN && -dh > hmax + HTOL) {
          status[k] = ST_CLOSED; q[k] = TINY_Q; status_changed = true;
        } else if (status[k] == ST_CLOSED && -dh < hmax - HTOL) {
          status[k] = ST_OPEN; q[k] = TINY_Q; status_changed = true;
        }
      } else if (link_type[k] == LT_VALVE && status_in[k] != ST_CLOSED) {
        int vt = valve_type[k];
        double h1 = H[node1[k]], h2 = H[node2[k]];
        int st = status[k], nw = st;
        if (vt == V_PRV && valve_setting[k] > 0) {
          double hset = elevation[node2[k]] + valve_setting[k];
          if (st == ST_ACTIVE) {
            if (q[k] < -QTOL) nw = ST_CLOSED;
            else if (h1 < hset - HTOL) nw = ST_OPEN;
          } else if (st == ST_OPEN) {
            if (q[k] < -QTOL) nw = ST_CLOSED;
            else if (h2 >= hset + HTOL) nw = ST_ACTIVE;
          } else {
            if (h1 >= hset + HTOL && h2 < hset - HTOL) nw = ST_ACTIVE;
            else if (h1 < hset - HTOL && h1 > h2 + HTOL) nw = ST_OPEN;
          }
        } else if (vt == V_PSV && valve_setting[k] > 0) {
          double hset = elevation[node1[k]] + valve_setting[k];
          if (st == ST_ACTIVE) {
            if (q[k] < -QTOL) nw = ST_CLOSED;
            else if (h2 > hset + HTOL) nw = ST_OPEN;
          } else if (st == ST_OPEN) {
            if (q[k] < -QTOL) nw = ST_CLOSED;
            else if (h1 <= hset - HTOL) nw = ST_ACTIVE;
          } else {
            if (h2 <= hset - HTOL && h1 > hset + HTOL) nw = ST_ACTIVE;
            else if (h2 > hset + HTOL && h1 > h2 + HTOL) nw = ST_OPEN;
          }
        } else if (vt == V_FCV && st == ST_ACTIVE) {
          if (h1 < h2 - HTOL) nw = ST_OPEN;
        }
        if (nw != st) { status[k] = nw; q[k] = TINY_Q; status_changed = true; }
      }
    }

    if (relerr < accuracy && !status_changed && it > 1) break;
  }

  for (int i = 0; i < n; ++i) head[i] = H[i];
  for (int k = 0; k < L; ++k) { flow[k] = q[k]; status_out[k] = status[k]; }
  *iters_out = std::min(it, max_iter);
  return (relerr < accuracy) ? 0 : 1;
}

// Batched entry: solves n_scen scenarios that share topology but differ in
// node/link parameters (demands, elevations, roughness, settings...). The
// scenario executor uses this to amortize call overhead across a batch.
int hyd_solve_batch(
    int n_scen,
    int n_nodes, int n_junctions, int n_links,
    const double* elevation, const double* fixed_head, const double* demand,
    const int* link_type, const int* node1, const int* node2,
    const int* status_in, const uint8_t* check_valve,
    const double* length, const double* diameter, const double* roughness,
    const double* minor_loss,
    const double* pump_h0, const double* pump_r, const double* pump_n,
    const double* pump_speed, const double* pump_power,
    const int* valve_type, const double* valve_setting,
    int headloss_model, double viscosity,
    int max_iter, double accuracy,
    double* head, double* flow, int* status_out, int* iters_out,
    int* warn_out) {
  for (int s = 0; s < n_scen; ++s) {
    warn_out[s] = hyd_solve(
        n_nodes, n_junctions, n_links,
        elevation + (size_t)s * n_nodes, fixed_head + (size_t)s * n_nodes,
        demand + (size_t)s * n_nodes,
        link_type, node1, node2,
        status_in + (size_t)s * n_links, check_valve,
        length + (size_t)s * n_links, diameter + (size_t)s * n_links,
        roughness + (size_t)s * n_links, minor_loss + (size_t)s * n_links,
        pump_h0 + (size_t)s * n_links, pump_r + (size_t)s * n_links,
        pump_n + (size_t)s * n_links, pump_speed + (size_t)s * n_links,
        pump_power + (size_t)s * n_links,
        valve_type, valve_setting + (size_t)s * n_links,
        headloss_model, viscosity, max_iter, accuracy,
        head + (size_t)s * n_nodes, flow + (size_t)s * n_links,
        status_out + (size_t)s * n_links, iters_out + s);
  }
  return 0;
}

}  // extern "C"
