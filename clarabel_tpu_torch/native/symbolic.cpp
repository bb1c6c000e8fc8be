// Native symbolic-analysis engine for clarabel_tpu_torch (the port's copy
// of the JAX package's native/symbolic.cpp; built by native.py with g++).
//
// Provides the graph/ordering machinery that the reference solver obtains
// from its native `amd` crate and QDLDL's symbolic phase
// (reference: src/qdldl/qdldl.rs:433-464, 905-922): a minimum-degree
// fill-reducing ordering, elimination-tree construction, and the full
// symbolic Cholesky pattern.  Used at setup by the chordal
// decomposition pipeline and by the sparse KKT path's host-side
// analysis (kkt/mf_symbolic.py).  Exposed with a plain C ABI for ctypes.
//
// All inputs are 0-based CSC-style arrays of int64.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------
// Minimum-degree ordering of an undirected graph.
//
//   n         : number of vertices
//   adj_ptr   : size n+1, CSR row pointers of the adjacency structure
//   adj_idx   : neighbor lists (no self loops required)
//   perm_out  : size n, perm_out[k] = vertex eliminated at step k
//
// Elimination-graph based: eliminating v connects its neighbors into a
// clique.  Degrees are tracked exactly; ties break by vertex index so the
// ordering is deterministic.
// ---------------------------------------------------------------------
int cl_minimum_degree(
    int64_t n,
    const int64_t* adj_ptr,
    const int64_t* adj_idx,
    int64_t* perm_out)
{
    if (n <= 0) return 0;

    std::vector<std::vector<int64_t>> adj(n);
    for (int64_t v = 0; v < n; ++v) {
        adj[v].assign(adj_idx + adj_ptr[v], adj_idx + adj_ptr[v + 1]);
        std::sort(adj[v].begin(), adj[v].end());
        adj[v].erase(std::unique(adj[v].begin(), adj[v].end()), adj[v].end());
        // drop self loops
        adj[v].erase(std::remove(adj[v].begin(), adj[v].end(), v), adj[v].end());
    }

    std::vector<char> eliminated(n, 0);
    std::vector<int64_t> scratch;

    for (int64_t k = 0; k < n; ++k) {
        // select min-degree vertex
        int64_t best = -1;
        size_t best_deg = SIZE_MAX;
        for (int64_t v = 0; v < n; ++v) {
            if (!eliminated[v] && adj[v].size() < best_deg) {
                best = v;
                best_deg = adj[v].size();
            }
        }
        const int64_t v = best;
        eliminated[v] = 1;
        perm_out[k] = v;

        // connect neighbors into a clique
        std::vector<int64_t>& nbrs = adj[v];
        for (int64_t u : nbrs) {
            std::vector<int64_t>& au = adj[u];
            // au = (au ∪ nbrs) \ {u, v}
            scratch.clear();
            scratch.reserve(au.size() + nbrs.size());
            std::set_union(au.begin(), au.end(), nbrs.begin(), nbrs.end(),
                           std::back_inserter(scratch));
            scratch.erase(std::remove(scratch.begin(), scratch.end(), u),
                          scratch.end());
            scratch.erase(std::remove(scratch.begin(), scratch.end(), v),
                          scratch.end());
            au.swap(scratch);
        }
        nbrs.clear();
        nbrs.shrink_to_fit();
    }
    return 0;
}

// ---------------------------------------------------------------------
// Symbolic Cholesky of a symmetric pattern given by its strictly-lower
// columns, via the elimination tree with per-column pattern merging.
//
//   n          : dimension
//   col_ptr    : size n+1, pointers into row_idx
//   row_idx    : strictly-below-diagonal row indices per column (sorted)
//   parent_out : size n, elimination-tree parent (-1 for roots)
//   lnz_out    : size n, number of below-diagonal entries per L column
//
// Two-phase C ABI: call cl_symbolic_count to size the output, then
// cl_symbolic_pattern to fill it.
// ---------------------------------------------------------------------

static void symbolic_build(
    int64_t n,
    const int64_t* col_ptr,
    const int64_t* row_idx,
    std::vector<std::vector<int64_t>>& pattern,
    int64_t* parent_out)
{
    pattern.assign(n, {});
    std::vector<std::vector<int64_t>> children(n);
    std::vector<int64_t> merged;

    for (int64_t j = 0; j < n; ++j) {
        std::vector<int64_t>& pat = pattern[j];
        pat.assign(row_idx + col_ptr[j], row_idx + col_ptr[j + 1]);
        std::sort(pat.begin(), pat.end());

        for (int64_t c : children[j]) {
            const std::vector<int64_t>& cp = pattern[c];
            merged.clear();
            merged.reserve(pat.size() + cp.size());
            std::set_union(pat.begin(), pat.end(), cp.begin(), cp.end(),
                           std::back_inserter(merged));
            merged.erase(std::remove(merged.begin(), merged.end(), j),
                         merged.end());
            pat.swap(merged);
        }

        if (!pat.empty()) {
            const int64_t p = pat.front();  // min element (sorted)
            parent_out[j] = p;
            children[p].push_back(j);
        } else {
            parent_out[j] = -1;
        }
    }
}

int cl_symbolic_count(
    int64_t n,
    const int64_t* col_ptr,
    const int64_t* row_idx,
    int64_t* parent_out,
    int64_t* lnz_out)
{
    std::vector<std::vector<int64_t>> pattern;
    symbolic_build(n, col_ptr, row_idx, pattern, parent_out);
    for (int64_t j = 0; j < n; ++j) lnz_out[j] = (int64_t)pattern[j].size();
    return 0;
}

int cl_symbolic_pattern(
    int64_t n,
    const int64_t* col_ptr,
    const int64_t* row_idx,
    int64_t* parent_out,
    int64_t* out_col_ptr,   // size n+1
    int64_t* out_row_idx)   // size sum(lnz)
{
    std::vector<std::vector<int64_t>> pattern;
    symbolic_build(n, col_ptr, row_idx, pattern, parent_out);

    int64_t nnz = 0;
    for (int64_t j = 0; j < n; ++j) {
        out_col_ptr[j] = nnz;
        std::memcpy(out_row_idx + nnz, pattern[j].data(),
                    pattern[j].size() * sizeof(int64_t));
        nnz += (int64_t)pattern[j].size();
    }
    out_col_ptr[n] = nnz;
    return 0;
}

// ---------------------------------------------------------------------
// Elimination-tree postorder (depth-first, children in ascending order).
//   parent   : size n, -1 marks roots
//   post_out : size n
// ---------------------------------------------------------------------
int cl_postorder(int64_t n, const int64_t* parent, int64_t* post_out)
{
    std::vector<std::vector<int64_t>> children(n);
    std::vector<int64_t> roots;
    for (int64_t v = 0; v < n; ++v) {
        if (parent[v] < 0) roots.push_back(v);
        else children[parent[v]].push_back(v);
    }
    int64_t k = 0;
    std::vector<int64_t> stack;
    // match the reference's traversal: process roots/children so the
    // result is a valid postorder with deterministic tie-breaking
    for (auto it = roots.rbegin(); it != roots.rend(); ++it) stack.push_back(*it);
    std::vector<int64_t> order(n, -1);
    std::vector<int64_t> visit;
    while (!stack.empty()) {
        int64_t v = stack.back(); stack.pop_back();
        visit.push_back(v);
        for (int64_t c : children[v]) stack.push_back(c);
    }
    // visit[] is a preorder from the top; a postorder index assignment that
    // descends from n-1 mirrors the reference implementation
    for (size_t i = 0; i < visit.size(); ++i) {
        order[visit[i]] = (int64_t)n - 1 - (int64_t)i;
    }
    std::vector<int64_t> idx(n);
    std::iota(idx.begin(), idx.end(), 0);
    std::sort(idx.begin(), idx.end(),
              [&](int64_t a, int64_t b) { return order[a] < order[b]; });
    for (int64_t i = 0; i < n; ++i) post_out[i] = idx[i];
    (void)k;
    return 0;
}

// ---------------------------------------------------------------------
// Relaxed supernode amalgamation (CHOLMOD-style, TPU-tuned thresholds).
//
// Mirrors clarabel_tpu/kkt/mf_symbolic.py::_amalgamate exactly: visiting
// nodes in the given postorder, a child merges into its parent when the
// merged panel's explicit-zero fraction stays under a size-dependent
// threshold.  The Python loop is the host-setup hot spot at large N
// (~2.4 s of per-node NumPy set algebra at n+m = 210k); this native
// version does the same sorted-array merges in C++.
//
//   n_nodes        : node count (post-split supernodes)
//   cols_ptr/idx   : per-node sorted pivot columns (flattened)
//   rows_ptr/idx   : per-node sorted update rows (flattened)
//   parent         : size n_nodes, -1 marks roots
//   post           : postorder of node indices (computed pre-merge)
//   max_cols       : pivot-column cap per merged node
//   relax_frac     : zero-fraction cap for the largest panels
// Outputs:
//   alive          : 1 for surviving nodes
//   out_cols_ptr/idx, out_rows_ptr/idx : merged arrays (dead nodes empty;
//     capacities: cols <= total input cols, rows <= total input rows)
//   parent_out     : updated parents over surviving nodes
// ---------------------------------------------------------------------
int cl_amalgamate(
    int64_t n_nodes,
    const int64_t* cols_ptr, const int64_t* cols_idx,
    const int64_t* rows_ptr, const int64_t* rows_idx,
    const int64_t* parent,
    const int64_t* post,
    int64_t max_cols,
    double relax_frac,
    uint8_t* alive,
    int64_t* out_cols_ptr, int64_t* out_cols_idx,
    int64_t* out_rows_ptr, int64_t* out_rows_idx,
    int64_t* parent_out)
{
    if (n_nodes <= 0) { out_cols_ptr[0] = 0; out_rows_ptr[0] = 0; return 0; }

    std::vector<std::vector<int64_t>> cols(n_nodes), rows(n_nodes);
    std::vector<std::vector<int64_t>> children(n_nodes);
    std::vector<int64_t> par(parent, parent + n_nodes);
    std::vector<double> nz(n_nodes);

    auto panel_cells = [](int64_t c, int64_t r) -> double {
        return (double)c * (double)r - (double)(c * (c - 1)) / 2.0;
    };

    for (int64_t i = 0; i < n_nodes; ++i) {
        cols[i].assign(cols_idx + cols_ptr[i], cols_idx + cols_ptr[i + 1]);
        rows[i].assign(rows_idx + rows_ptr[i], rows_idx + rows_ptr[i + 1]);
        alive[i] = 1;
        int64_t c = (int64_t)cols[i].size();
        nz[i] = panel_cells(c, c + (int64_t)rows[i].size());
        if (par[i] >= 0) children[par[i]].push_back(i);
    }

    auto threshold = [&](int64_t c_m) -> double {
        if (c_m <= 32) return 1.0;
        if (c_m <= 128) return 0.8;
        if (c_m <= 256) return 0.5;
        return relax_frac;
    };

    std::vector<int64_t> m_cols, rows_u, m_rows;
    for (int64_t k = 0; k < n_nodes; ++k) {
        int64_t s = post[k];
        if (!alive[s]) continue;
        int64_t p = par[s];
        if (p < 0) continue;
        int64_t c_m = (int64_t)(cols[s].size() + cols[p].size());
        if (c_m > max_cols) continue;

        // disjoint sorted column union
        m_cols.resize(cols[s].size() + cols[p].size());
        std::merge(cols[s].begin(), cols[s].end(),
                   cols[p].begin(), cols[p].end(), m_cols.begin());
        // row union, deduplicated, minus the merged columns
        rows_u.resize(rows[s].size() + rows[p].size());
        std::merge(rows[s].begin(), rows[s].end(),
                   rows[p].begin(), rows[p].end(), rows_u.begin());
        rows_u.erase(std::unique(rows_u.begin(), rows_u.end()), rows_u.end());
        m_rows.clear();
        m_rows.reserve(rows_u.size());
        std::set_difference(rows_u.begin(), rows_u.end(),
                            m_cols.begin(), m_cols.end(),
                            std::back_inserter(m_rows));

        double cells_m = panel_cells(c_m, c_m + (int64_t)m_rows.size());
        double nz_m = nz[s] + nz[p];
        double zfrac = 1.0 - nz_m / std::max(cells_m, 1.0);
        if (zfrac <= threshold(c_m)) {
            cols[p].swap(m_cols);
            rows[p].swap(m_rows);
            auto& pc = children[p];
            pc.erase(std::remove(pc.begin(), pc.end(), s), pc.end());
            for (int64_t c : children[s]) {
                par[c] = p;
                pc.push_back(c);
            }
            alive[s] = 0;
            nz[p] = nz_m;
        }
    }

    int64_t cpos = 0, rpos = 0;
    for (int64_t i = 0; i < n_nodes; ++i) {
        out_cols_ptr[i] = cpos;
        out_rows_ptr[i] = rpos;
        if (alive[i]) {
            std::memcpy(out_cols_idx + cpos, cols[i].data(),
                        cols[i].size() * sizeof(int64_t));
            cpos += (int64_t)cols[i].size();
            std::memcpy(out_rows_idx + rpos, rows[i].data(),
                        rows[i].size() * sizeof(int64_t));
            rpos += (int64_t)rows[i].size();
        }
        parent_out[i] = par[i];
    }
    out_cols_ptr[n_nodes] = cpos;
    out_rows_ptr[n_nodes] = rpos;
    return 0;
}

// ---------------------------------------------------------------------
// Forest postorder over an arbitrary node-parent array, replicating
// mf_symbolic._postorder exactly: roots ascending, DFS that visits the
// smallest child first, node emitted after its children.
// ---------------------------------------------------------------------
int cl_postorder_forest(int64_t n, const int64_t* parent, int64_t* post_out)
{
    std::vector<std::vector<int64_t>> children(n);
    std::vector<int64_t> roots;
    for (int64_t v = 0; v < n; ++v) {
        if (parent[v] < 0) roots.push_back(v);
        else children[parent[v]].push_back(v);
    }
    std::vector<std::pair<int64_t, char>> stack;
    for (auto it = roots.rbegin(); it != roots.rend(); ++it)
        stack.push_back({*it, 0});
    int64_t k = 0;
    while (!stack.empty()) {
        auto [v, done] = stack.back();
        stack.pop_back();
        if (done) {
            post_out[k++] = v;
        } else {
            stack.push_back({v, 1});
            auto& ch = children[v];
            for (auto it = ch.rbegin(); it != ch.rend(); ++it)
                stack.push_back({*it, 0});
        }
    }
    return 0;
}

}  // extern "C"


