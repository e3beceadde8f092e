// Native host-side core for the TPU-native NK preconditioner framework.
//
// The reference delegates its heavy host-side work to external native
// libraries (libnetcdf for IO, SuperLU_DIST/ParMETIS for symbolic
// analysis); this module is the rebuild's native layer for the hot
// host-side paths that feed the TPU:
//
//   canonicalize_coo:  COO -> canonical CSR with the reference's
//       semantics (duplicates summed in emission order, exact zeros
//       stripped, columns sorted; the vectorized-python equivalent is
//       ops/assemble.py::to_csr). At 1-degree scale the entry streams
//       reach hundreds of millions of triplets; this one-pass
//       sort+reduce keeps assembly host time in seconds.
//
//   route_entries: multifrontal A-assembly routing — for every CSR entry
//       (r, c), the owning front is the one whose column block is
//       eliminated earlier (solver/mf_jax.py::build_plan); emitted here
//       as a single pass for the plan compiler.
//
// Compiled on demand (g++ -O3 -shared) and loaded via ctypes; python
// fallbacks exist for every function.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

extern "C" {

// Sort (rows, cols, vals) by (row, col) with input order preserved inside
// equal (row, col) groups, sum each group left-to-right, drop exact
// zeros, and emit CSR. Returns the output nnz.
int64_t canonicalize_coo(const int64_t* rows, const int64_t* cols,
                         const double* vals, int64_t nnz_in,
                         int64_t flat_len, int64_t* out_rowptr,
                         int64_t* out_cols, double* out_vals) {
    std::vector<int64_t> idx(nnz_in);
    std::iota(idx.begin(), idx.end(), int64_t(0));
    std::stable_sort(idx.begin(), idx.end(),
                     [&](int64_t a, int64_t b) {
                         if (rows[a] != rows[b]) return rows[a] < rows[b];
                         return cols[a] < cols[b];
                     });
    int64_t out = 0;
    std::memset(out_rowptr, 0, sizeof(int64_t) * (flat_len + 1));
    int64_t i = 0;
    while (i < nnz_in) {
        const int64_t r = rows[idx[i]];
        const int64_t c = cols[idx[i]];
        double acc = vals[idx[i]];
        int64_t j = i + 1;
        while (j < nnz_in && rows[idx[j]] == r && cols[idx[j]] == c) {
            acc += vals[idx[j]];   // left-to-right, matching sum_dup order
            ++j;
        }
        if (acc != 0.0) {
            out_cols[out] = c;
            out_vals[out] = acc;
            ++out_rowptr[r + 1];
            ++out;
        }
        i = j;
    }
    for (int64_t r = 0; r < flat_len; ++r)
        out_rowptr[r + 1] += out_rowptr[r];
    return out;
}

// For each CSR entry (r, c): its assembly node is the owner of the
// earlier-eliminated of cell r / cell c. rows are implicit via rowptr.
void route_entries(const int64_t* rowptr, const int64_t* colind,
                   int64_t flat_len, const int64_t* cell_node,
                   const int64_t* cell_elim, int64_t* entry_node) {
    for (int64_t r = 0; r < flat_len; ++r) {
        const int64_t er = cell_elim[r];
        for (int64_t k = rowptr[r]; k < rowptr[r + 1]; ++k) {
            const int64_t c = colind[k];
            entry_node[k] = (cell_elim[c] <= er) ? cell_node[c] : cell_node[r];
        }
    }
}

// Multifrontal assembly-plan entry grouping, fused: route every CSR
// entry (r, c) to its owning front (the owner of the earlier-eliminated
// endpoint — same rule as route_entries) and counting-sort the entries
// by front, emitting per-front contiguous (row, col, nzval-index)
// triples in int32. Replaces an argsort + two nnz-sized numpy
// temporaries in build_plan (13s + 17s at 1-degree scale on this
// ~0.25 GB/s-bandwidth host). Two routing passes instead of a stored
// entry_node temporary: recomputing the route is cheaper than another
// 0.4 GB round trip.
void plan_entries(const int64_t* rowptr, const int64_t* colind,
                  int64_t flat_len, const int64_t* cell_node,
                  const int64_t* cell_elim, int64_t nfronts,
                  int32_t* ent_row, int32_t* ent_col, int32_t* ent_src,
                  int64_t* bounds) {
    std::memset(bounds, 0, sizeof(int64_t) * (nfronts + 1));
    for (int64_t r = 0; r < flat_len; ++r) {
        const int64_t er = cell_elim[r];
        for (int64_t k = rowptr[r]; k < rowptr[r + 1]; ++k) {
            const int64_t c = colind[k];
            const int64_t node =
                (cell_elim[c] <= er) ? cell_node[c] : cell_node[r];
            ++bounds[node + 1];
        }
    }
    for (int64_t n = 0; n < nfronts; ++n) bounds[n + 1] += bounds[n];
    std::vector<int64_t> cur(bounds, bounds + nfronts);
    for (int64_t r = 0; r < flat_len; ++r) {
        const int64_t er = cell_elim[r];
        for (int64_t k = rowptr[r]; k < rowptr[r + 1]; ++k) {
            const int64_t c = colind[k];
            const int64_t node =
                (cell_elim[c] <= er) ? cell_node[c] : cell_node[r];
            const int64_t o = cur[node]++;
            ent_row[o] = static_cast<int32_t>(r);
            ent_col[o] = static_cast<int32_t>(c);
            ent_src[o] = static_cast<int32_t>(k);
        }
    }
}

// Column-column adjacency from the CSR pattern in ONE pass over colind
// (the host here has ~0.25 GB/s memory bandwidth; the numpy formulation
// needs ~8 full passes over nnz-sized temporaries and dominated the
// 1-degree symbolic phase). col_of_row maps each matrix row to its water
// column. Dedupe via a per-destination stamp array — exact within each
// contiguous run of rows of one column; the few duplicates that survive
// interleaved tracer blocks are removed by the (tiny) caller-side unique.
// Returns the emitted pair count, or -1 if max_pairs was too small.
int64_t column_adjacency(const int64_t* rowptr, const int64_t* colind,
                         int64_t flat_len, const int32_t* col_of_row,
                         int64_t ncols, int64_t* out_src, int64_t* out_dst,
                         int64_t max_pairs) {
    std::vector<int64_t> stamp(ncols, -1);
    int64_t out = 0;
    for (int64_t r = 0; r < flat_len; ++r) {
        const int64_t rc = col_of_row[r];
        for (int64_t k = rowptr[r]; k < rowptr[r + 1]; ++k) {
            const int64_t cc = col_of_row[colind[k]];
            if (cc != rc && stamp[cc] != rc) {
                stamp[cc] = rc;
                if (out >= max_pairs) return -1;
                out_src[out] = rc;
                out_dst[out] = cc;
                ++out;
            }
        }
    }
    return out;
}

}  // extern "C"
