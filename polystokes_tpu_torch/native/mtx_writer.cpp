// MatrixMarket writers, the port's copy of the JAX package's native
// helpers (ps_write_mtx, ps_write_mtx_vector): a sparse matrix in
// coordinate format and a dense vector in array format, values as %.17g,
// so either package's writer gives the same bytes for the same values.
// The offline-verification export of the reference
// (exec/HDK_PolyStokesSolver.cpp:533-566) writes these files.
//
// A plain C ABI for ctypes, built with union_find.cpp into one library
// (polystokes_tpu_torch/native/__init__.py).

#include <cstdint>
#include <cstdio>

extern "C" {

// MatrixMarket coordinate-format sparse export (general real).
int ps_write_mtx(const char* path, int64_t nrows, int64_t ncols, int64_t nnz,
                 const int64_t* rows, const int64_t* cols,
                 const double* vals) {
  FILE* f = std::fopen(path, "w");
  if (!f) return -1;
  std::fprintf(f, "%%%%MatrixMarket matrix coordinate real general\n");
  std::fprintf(f, "%lld %lld %lld\n", (long long)nrows, (long long)ncols,
               (long long)nnz);
  for (int64_t i = 0; i < nnz; ++i)
    std::fprintf(f, "%lld %lld %.17g\n", (long long)(rows[i] + 1),
                 (long long)(cols[i] + 1), vals[i]);
  std::fclose(f);
  return 0;
}

// MatrixMarket dense-vector export (array format).
int ps_write_mtx_vector(const char* path, int64_t n, const double* vals) {
  FILE* f = std::fopen(path, "w");
  if (!f) return -1;
  std::fprintf(f, "%%%%MatrixMarket matrix array real general\n");
  std::fprintf(f, "%lld 1\n", (long long)n);
  for (int64_t i = 0; i < n; ++i) std::fprintf(f, "%.17g\n", vals[i]);
  std::fclose(f);
  return 0;
}

}  // extern "C"
