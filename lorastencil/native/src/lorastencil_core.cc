// Native host-side core for lorastencil.
//
// The reference implements its entire host layer in C++ (coefficient
// factorization, banded parameter-matrix construction, wall-clock metric
// emission -- reference/src/2d/gpu.cu:280-387, src/*/gpu_*.cu timing
// blocks).  This library is the framework's native equivalent of that
// layer: the numerical host preprocessing runs here in C++ (exposed to
// Python over a C ABI via ctypes), while the device compute path stays
// JAX.  A pure-NumPy fallback with identical semantics lives in
// models/factorize.py; tests assert bit-equality between the two.
//
// Build: cmake -S . -B build && cmake --build build   (see CMakeLists.txt)

#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// ---------------------------------------------------------------------
// pivot_peel: Gaussian rank-1 peeling at given pivots.
//   S: n*n row-major (modified in place to the residual)
//   pivots: npiv pairs (pi, pj)
//   terms_out: buffer for up to npiv*(2n) doubles, layout per term:
//     [u (n), v (n)]
//   returns number of peeled terms.
int ls_pivot_peel(double* S, int n, const int* pivots, int npiv,
                  double tol, double* terms_out) {
  int nterms = 0;
  for (int t = 0; t < npiv; ++t) {
    const int pi = pivots[2 * t], pj = pivots[2 * t + 1];
    const double p = S[pi * n + pj];
    if (std::fabs(p) <= tol) continue;
    double* u = terms_out + nterms * 2 * n;
    double* v = u + n;
    for (int i = 0; i < n; ++i) u[i] = S[i * n + pj] / p;
    for (int j = 0; j < n; ++j) v[j] = S[pi * n + j];
    for (int i = 0; i < n; ++i)
      for (int j = 0; j < n; ++j) S[i * n + j] -= u[i] * v[j];
    ++nterms;
  }
  return nterms;
}

// ---------------------------------------------------------------------
// banded_matrix: B[(c + k), c] = taps[k]  for k in [0, w), c in [0, n_out)
// B is (n_out + w - 1) x n_out row-major, zero-initialized here.
void ls_banded_matrix(const double* taps, int w, int n_out, double* B) {
  const int rows = n_out + w - 1;
  std::memset(B, 0, sizeof(double) * rows * n_out);
  for (int k = 0; k < w; ++k)
    for (int c = 0; c < n_out; ++c) B[(c + k) * n_out + c] = taps[k];
}

// ---------------------------------------------------------------------
// fuse_taps: k-fold self-convolution of 1-D taps (temporal fusion).
//   taps: length w; out: length k*(w-1)+1.
void ls_fuse_taps(const double* taps, int w, int k, double* out) {
  std::vector<double> cur(1, 1.0);
  for (int rep = 0; rep < k; ++rep) {
    std::vector<double> next(cur.size() + w - 1, 0.0);
    for (size_t i = 0; i < cur.size(); ++i)
      for (int j = 0; j < w; ++j) next[i + j] += cur[i] * taps[j];
    cur.swap(next);
  }
  std::memcpy(out, cur.data(), sizeof(double) * cur.size());
}

// ---------------------------------------------------------------------
// fuse_coeffs_2d: k-fold self-convolution of a dense 2-D coefficient
// matrix (w x w).  out must hold (k*(w-1)+1)^2 doubles.
void ls_fuse_coeffs_2d(const double* S, int w, int k, double* out) {
  std::vector<double> cur(1, 1.0);
  int cw = 1;
  for (int rep = 0; rep < k; ++rep) {
    const int nw = cw + w - 1;
    std::vector<double> next(static_cast<size_t>(nw) * nw, 0.0);
    for (int i = 0; i < cw; ++i)
      for (int j = 0; j < cw; ++j) {
        const double a = cur[i * cw + j];
        if (a == 0.0) continue;
        for (int x = 0; x < w; ++x)
          for (int y = 0; y < w; ++y)
            next[(i + x) * nw + (j + y)] += a * S[x * w + y];
      }
    cur.swap(next);
    cw = nw;
  }
  std::memcpy(out, cur.data(), sizeof(double) * cur.size());
}

// ---------------------------------------------------------------------
// dense reference stencil step (fp64), the C++ twin of
// utils/reference.dense_step -- interior = stencil, halo = 0.
//   grid: (mp, np_) padded row-major input
//   S: (2r+1)^2 coefficients; halo (hm, hn) >= r
void ls_dense_step_2d(const double* grid, double* out, int mp, int np_,
                      int hm, int hn, const double* S, int r) {
  std::memset(out, 0, sizeof(double) * mp * np_);
  const int w = 2 * r + 1;
  // sparse tap list: the reference shapes are mostly zeros in the
  // (2r+1)^2 box (star2d1r: 13 of 49 nonzero)
  std::vector<int> offs;
  std::vector<double> ws;
  for (int di = -r; di <= r; ++di)
    for (int dj = -r; dj <= r; ++dj) {
      const double c = S[(di + r) * w + (dj + r)];
      if (c != 0.0) { offs.push_back(di * np_ + dj); ws.push_back(c); }
    }
  const int nt = static_cast<int>(ws.size());
#pragma omp parallel for schedule(static)
  for (int i = hm; i < mp - hm; ++i) {
    for (int j = hn; j < np_ - hn; ++j) {
      double acc = 0.0;
      const double* g = grid + i * np_ + j;
      for (int t = 0; t < nt; ++t) acc += ws[t] * g[offs[t]];
      out[i * np_ + j] = acc;
    }
  }
}

// ---------------------------------------------------------------------
// dense reference stencil step (fp64), 1-D twin.
void ls_dense_step_1d(const double* grid, double* out, int n_pad, int h,
                      const double* taps, int r) {
  std::memset(out, 0, sizeof(double) * n_pad);
#pragma omp parallel for schedule(static)
  for (int i = h; i < n_pad - h; ++i) {
    double acc = 0.0;
    for (int d = -r; d <= r; ++d) acc += taps[d + r] * grid[i + d];
    out[i] = acc;
  }
}

// ---------------------------------------------------------------------
// dense reference stencil step (fp64), 3-D twin.
//   grid: (hp, mp, np_) padded row-major; halos (hz, hm, hn) >= r.
void ls_dense_step_3d(const double* grid, double* out, int hp, int mp,
                      int np_, int hz, int hm, int hn, const double* S,
                      int r) {
  std::memset(out, 0, sizeof(double) * hp * mp * np_);
  const int w = 2 * r + 1;
  const long pm = static_cast<long>(mp) * np_;
  std::vector<long> offs;
  std::vector<double> ws;
  for (int dz = -r; dz <= r; ++dz)
    for (int di = -r; di <= r; ++di)
      for (int dj = -r; dj <= r; ++dj) {
        const double c = S[((dz + r) * w + (di + r)) * w + (dj + r)];
        if (c != 0.0) { offs.push_back(dz * pm + di * np_ + dj);
                        ws.push_back(c); }
      }
  const int nt = static_cast<int>(ws.size());
#pragma omp parallel for schedule(static) collapse(2)
  for (int z = hz; z < hp - hz; ++z) {
    for (int i = hm; i < mp - hm; ++i) {
      for (int j = hn; j < np_ - hn; ++j) {
        double acc = 0.0;
        const double* g = grid + z * pm + i * np_ + j;
        for (int t = 0; t < nt; ++t) acc += ws[t] * g[offs[t]];
        out[z * pm + i * np_ + j] = acc;
      }
    }
  }
}

// ---------------------------------------------------------------------
// steady-clock nanosecond timestamp (metric emitter parity with the
// reference's std::chrono::steady_clock usage).
int64_t ls_monotonic_ns() {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

int ls_abi_version() { return 2; }

}  // extern "C"
