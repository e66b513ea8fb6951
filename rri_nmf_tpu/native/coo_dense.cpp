// Host data-path kernels for rri_nmf_tpu (C, OpenMP).
//
// The reference builds its dense training matrix + binary observation mask
// from COO rating triples through scipy (reference
// sklearn_interface.py:78-102): two sparse-matrix materializations and two
// full-matrix zero-fills per fit. At production recommender scale
// (BASELINE.md: MovieLens-1M and beyond) that host step serializes before
// any device work can start. These kernels do the scatter in one
// OpenMP-parallel pass each, writing float32 buffers that device_put can
// ship without further conversion.
//
// Exposed via ctypes (no pybind11 in the build image); see
// rri_nmf_tpu/native/__init__.py.

#include <cstdint>
#include <cstring>

extern "C" {

// ABI version of this library. Bumped whenever an exported signature or
// buffer width changes (v3: the sparse-plan bucketing exports were
// removed). The loader refuses a library reporting a different version
// and rebuilds from source — an mtime check alone cannot catch a stale
// .so whose timestamp survived a copy (archived mtimes, rsync -t).
int64_t nmfdata_abi_version(void) { return 3; }

// Scatter COO triples into a dense row-major (n x d) matrix and a binary
// mask. Duplicate (i, j) pairs ACCUMULATE (scipy.sparse.coo_matrix sums
// duplicates before toarray(), reference sklearn_interface.py:78-83) and
// the mask is derived from the final nonzero pattern (the reference builds
// it from Xtr.nonzero(), sklearn_interface.py:100-102 — so an entry whose
// accumulated value is exactly zero counts as unobserved).
// Returns 0 on success, -1 on out-of-range index.
int coo_to_dense_mask(const int64_t* rows, const int64_t* cols,
                      const double* vals, int64_t nnz,
                      int64_t n, int64_t d,
                      float* X_out, float* M_out) {
    // zero-fill in parallel (first-touch friendly for NUMA)
    #pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        std::memset(X_out + i * d, 0, sizeof(float) * (size_t)d);
        std::memset(M_out + i * d, 0, sizeof(float) * (size_t)d);
    }

    int bad = 0;
    #pragma omp parallel for schedule(static) reduction(|:bad)
    for (int64_t t = 0; t < nnz; ++t) {
        int64_t i = rows[t], j = cols[t];
        if (i < 0 || i >= n || j < 0 || j >= d) { bad |= 1; continue; }
        #pragma omp atomic
        X_out[i * d + j] += (float)vals[t];
    }
    if (bad) return -1;

    #pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i)
        for (int64_t j = 0; j < d; ++j)
            M_out[i * d + j] = (X_out[i * d + j] != 0.0f) ? 1.0f : 0.0f;
    return 0;
}

// Column document frequencies of a dense count matrix (tfidf prep,
// called by rri_nmf_tpu.matrixops.tfidf's host path):
// df[j] = #rows with X[i,j] > 0. Parallel over columns.
void column_df(const double* X, int64_t n, int64_t d, int64_t* df_out) {
    #pragma omp parallel for schedule(static)
    for (int64_t j = 0; j < d; ++j) {
        int64_t c = 0;
        for (int64_t i = 0; i < n; ++i) c += (X[i * d + j] > 0.0);
        df_out[j] = c;
    }
}

}  // extern "C"
