// Native float64 GP factor engine (host side).
//
// The reference outsources its linear algebra to GPy, which bottoms out
// in NumPy/LAPACK plus Cython helpers; this is the equivalent native
// component of the rebuild: the O(n^2)/O(n^3) small-n factor math that
// backs safeopt_tpu.gp.host_math. The TPU executes all O(N) grid work;
// this engine owns the float64 island (gram construction, Cholesky,
// triangular inverse, bordered append) without Python/NumPy dispatch
// overhead on the per-observation update path.
//
// Layout conventions: row-major, lower-triangular factors. All
// functions return 0 on success, nonzero on numerical failure.
//
// Build: g++ -O3 -march=native -shared -fPIC host_factor.cpp -o libhostfactor.so
// Bound via ctypes in safeopt_tpu/native/__init__.py (no pybind11 in
// this toolchain).

#include <cmath>
#include <cstddef>
#include <cstdint>

extern "C" {

// Squared scaled Euclidean distances: out[i*m + j] = |(x_i - z_j)/ls|^2
static inline double sq_scaled_dist(const double* x, const double* z,
                                    const double* inv_ls, int d) {
    double acc = 0.0;
    for (int k = 0; k < d; ++k) {
        const double t = (x[k] - z[k]) * inv_ls[k];
        acc += t * t;
    }
    return acc;
}

// RBF gram: k(x, z) = var * exp(-r^2 / 2). ls has length d (ARD) —
// callers broadcast scalar lengthscales.
int gram_rbf(const double* X, int n, const double* Z, int m, int d,
             const double* ls, double var, double* out) {
    double inv_ls[64];
    if (d > 64) return 1;
    for (int k = 0; k < d; ++k) inv_ls[k] = 1.0 / ls[k];
    for (int i = 0; i < n; ++i) {
        const double* xi = X + (size_t)i * d;
        for (int j = 0; j < m; ++j) {
            const double r2 = sq_scaled_dist(xi, Z + (size_t)j * d,
                                             inv_ls, d);
            out[(size_t)i * m + j] = var * std::exp(-0.5 * r2);
        }
    }
    return 0;
}

// Matern-3/2 gram: k = var * (1 + sqrt(3) r) * exp(-sqrt(3) r).
int gram_matern32(const double* X, int n, const double* Z, int m, int d,
                  const double* ls, double var, double* out) {
    double inv_ls[64];
    if (d > 64) return 1;
    for (int k = 0; k < d; ++k) inv_ls[k] = 1.0 / ls[k];
    const double s3 = std::sqrt(3.0);
    for (int i = 0; i < n; ++i) {
        const double* xi = X + (size_t)i * d;
        for (int j = 0; j < m; ++j) {
            const double r = std::sqrt(sq_scaled_dist(
                xi, Z + (size_t)j * d, inv_ls, d));
            out[(size_t)i * m + j] = var * (1.0 + s3 * r)
                                     * std::exp(-s3 * r);
        }
    }
    return 0;
}

// Matern-5/2 gram: k = var * (1 + sqrt(5) r + 5 r^2 / 3) * exp(-sqrt(5) r).
int gram_matern52(const double* X, int n, const double* Z, int m, int d,
                  const double* ls, double var, double* out) {
    double inv_ls[64];
    if (d > 64) return 1;
    for (int k = 0; k < d; ++k) inv_ls[k] = 1.0 / ls[k];
    const double s5 = std::sqrt(5.0);
    for (int i = 0; i < n; ++i) {
        const double* xi = X + (size_t)i * d;
        for (int j = 0; j < m; ++j) {
            const double r2 = sq_scaled_dist(xi, Z + (size_t)j * d,
                                             inv_ls, d);
            const double r = std::sqrt(r2);
            out[(size_t)i * m + j] = var
                * (1.0 + s5 * r + (5.0 / 3.0) * r2)
                * std::exp(-s5 * r);
        }
    }
    return 0;
}

// Exponential (Matern-1/2 / OU) gram: k = var * exp(-r).
int gram_exponential(const double* X, int n, const double* Z, int m, int d,
                     const double* ls, double var, double* out) {
    double inv_ls[64];
    if (d > 64) return 1;
    for (int k = 0; k < d; ++k) inv_ls[k] = 1.0 / ls[k];
    for (int i = 0; i < n; ++i) {
        const double* xi = X + (size_t)i * d;
        for (int j = 0; j < m; ++j) {
            const double r = std::sqrt(sq_scaled_dist(
                xi, Z + (size_t)j * d, inv_ls, d));
            out[(size_t)i * m + j] = var * std::exp(-r);
        }
    }
    return 0;
}

// Rational quadratic gram: k = var * (1 + r^2/2)^(-power)
// (GPy.kern.RatQuad; a scale mixture of RBFs).
int gram_ratquad(const double* X, int n, const double* Z, int m, int d,
                 const double* ls, double var, double power, double* out) {
    double inv_ls[64];
    if (d > 64) return 1;
    for (int k = 0; k < d; ++k) inv_ls[k] = 1.0 / ls[k];
    for (int i = 0; i < n; ++i) {
        const double* xi = X + (size_t)i * d;
        for (int j = 0; j < m; ++j) {
            const double r2 = sq_scaled_dist(xi, Z + (size_t)j * d,
                                             inv_ls, d);
            out[(size_t)i * m + j] = var * std::pow(1.0 + 0.5 * r2,
                                                    -power);
        }
    }
    return 0;
}

// Standard periodic gram (GPy.kern.StdPeriodic convention):
// k = var * exp(-0.5 * sum_j (sin(pi (x_j - z_j) / T_j) / l_j)^2)
int gram_stdperiodic(const double* X, int n, const double* Z, int m,
                     int d, const double* period, const double* ls,
                     double var, double* out) {
    double inv_ls[64], inv_T[64];
    if (d > 64) return 1;
    for (int k = 0; k < d; ++k) {
        inv_ls[k] = 1.0 / ls[k];
        inv_T[k] = M_PI / period[k];
    }
    for (int i = 0; i < n; ++i) {
        const double* xi = X + (size_t)i * d;
        for (int j = 0; j < m; ++j) {
            const double* zj = Z + (size_t)j * d;
            double s2 = 0.0;
            for (int k = 0; k < d; ++k) {
                const double s = std::sin((xi[k] - zj[k]) * inv_T[k])
                                 * inv_ls[k];
                s2 += s * s;
            }
            out[(size_t)i * m + j] = var * std::exp(-0.5 * s2);
        }
    }
    return 0;
}

// Cosine gram: k = var * cos(r) (GPy.kern.Cosine convention).
int gram_cosine(const double* X, int n, const double* Z, int m, int d,
                const double* ls, double var, double* out) {
    double inv_ls[64];
    if (d > 64) return 1;
    for (int k = 0; k < d; ++k) inv_ls[k] = 1.0 / ls[k];
    for (int i = 0; i < n; ++i) {
        const double* xi = X + (size_t)i * d;
        for (int j = 0; j < m; ++j) {
            const double r2 = sq_scaled_dist(xi, Z + (size_t)j * d,
                                             inv_ls, d);
            out[(size_t)i * m + j] = var * std::cos(std::sqrt(r2));
        }
    }
    return 0;
}

// Polynomial gram (GPy.kern.Poly convention):
// k(x, z) = var * (scale * x.z + bias)^order
int gram_poly(const double* X, int n, const double* Z, int m, int d,
              double var, double scale, double bias, double order,
              double* out) {
    for (int i = 0; i < n; ++i) {
        const double* xi = X + (size_t)i * d;
        for (int j = 0; j < m; ++j) {
            const double* zj = Z + (size_t)j * d;
            double acc = 0.0;
            for (int k = 0; k < d; ++k) acc += xi[k] * zj[k];
            out[(size_t)i * m + j] = var * std::pow(scale * acc + bias,
                                                    order);
        }
    }
    return 0;
}

// MLP (arcsine) gram (GPy.kern.MLP convention):
// k(x, z) = var * (2/pi) * asin((w.x.z + b) /
//           sqrt((w.x.x + b + 1)(w.z.z + b + 1)))
// w has length d (ARD) — callers broadcast scalar weight variances.
// One m-length heap allocation for the z-side denominators is noise
// next to the O(n m d) loop.
int gram_mlp(const double* X, int n, const double* Z, int m, int d,
             const double* w, double var, double b, double* out) {
    const double two_over_pi = 2.0 / M_PI;
    double* zden = new double[m];
    for (int j = 0; j < m; ++j) {
        const double* zj = Z + (size_t)j * d;
        double acc = b + 1.0;
        for (int k = 0; k < d; ++k) acc += w[k] * zj[k] * zj[k];
        zden[j] = std::sqrt(acc);
    }
    for (int i = 0; i < n; ++i) {
        const double* xi = X + (size_t)i * d;
        double xacc = b + 1.0;
        for (int k = 0; k < d; ++k) xacc += w[k] * xi[k] * xi[k];
        const double xden = std::sqrt(xacc);
        for (int j = 0; j < m; ++j) {
            const double* zj = Z + (size_t)j * d;
            double acc = b;
            for (int k = 0; k < d; ++k) acc += w[k] * xi[k] * zj[k];
            double c = acc / (xden * zden[j]);
            if (c > 1.0) c = 1.0;
            if (c < -1.0) c = -1.0;
            out[(size_t)i * m + j] = var * two_over_pi * std::asin(c);
        }
    }
    delete[] zden;
    return 0;
}

// Linear (dot-product) gram (GPy.kern.Linear convention):
// k(x, z) = sum_j w_j x_j z_j — per-dim weights ride the length-d slot.
int gram_linear(const double* X, int n, const double* Z, int m, int d,
                const double* w, double* out) {
    // no d cap: unlike the stationary grams there is no stack-local
    // inv_ls[64] buffer — w is read directly, any d works
    for (int i = 0; i < n; ++i) {
        const double* xi = X + (size_t)i * d;
        for (int j = 0; j < m; ++j) {
            const double* zj = Z + (size_t)j * d;
            double acc = 0.0;
            for (int k = 0; k < d; ++k) acc += w[k] * xi[k] * zj[k];
            out[(size_t)i * m + j] = acc;
        }
    }
    return 0;
}

// In-place lower Cholesky of the leading n x n block of A (row-major,
// stride = lda). Upper triangle is zeroed. Returns the 1-based index of
// a non-positive pivot, or 0 on success.
int cholesky_lower(double* A, int n, int lda) {
    for (int j = 0; j < n; ++j) {
        double diag = A[(size_t)j * lda + j];
        for (int k = 0; k < j; ++k) {
            const double v = A[(size_t)j * lda + k];
            diag -= v * v;
        }
        if (diag <= 0.0 || !std::isfinite(diag)) return j + 1;
        const double dj = std::sqrt(diag);
        A[(size_t)j * lda + j] = dj;
        const double inv_dj = 1.0 / dj;
        for (int i = j + 1; i < n; ++i) {
            double acc = A[(size_t)i * lda + j];
            const double* ri = A + (size_t)i * lda;
            const double* rj = A + (size_t)j * lda;
            for (int k = 0; k < j; ++k) acc -= ri[k] * rj[k];
            A[(size_t)i * lda + j] = acc * inv_dj;
        }
        for (int k = j + 1; k < n; ++k) A[(size_t)j * lda + k] = 0.0;
    }
    return 0;
}

// Lower-triangular inverse: out = L^{-1} (forward substitution per
// column), both n x n with stride lda.
int tri_inverse_lower(const double* L, int n, int lda, double* out) {
    for (int j = 0; j < n; ++j) {
        for (int i = 0; i < n; ++i) out[(size_t)i * lda + j] = 0.0;
        out[(size_t)j * lda + j] = 1.0 / L[(size_t)j * lda + j];
        for (int i = j + 1; i < n; ++i) {
            double acc = 0.0;
            const double* ri = L + (size_t)i * lda;
            for (int k = j; k < i; ++k)
                acc -= ri[k] * out[(size_t)k * lda + j];
            out[(size_t)i * lda + j] = acc / ri[i];
        }
    }
    return 0;
}

// Bordered Cholesky append at row `pos` of capacity-stride buffers.
// kvec = k(X[:pos], x) (length pos), kxx = k(x,x) + noise.
// Updates L, Linv, w in place; writes the new diagonal through *dd_out.
int border_append(double* L, double* Linv, double* w, int pos, int lda,
                  const double* kvec, double kxx, double y,
                  double* dd_out) {
    // c = Linv[:pos,:pos] @ kvec
    double c[4096];
    if (pos > 4096) return 1;
    for (int i = 0; i < pos; ++i) {
        double acc = 0.0;
        const double* ri = Linv + (size_t)i * lda;
        for (int k = 0; k <= i; ++k) acc += ri[k] * kvec[k];
        c[i] = acc;
    }
    double cc = 0.0, mu = 0.0;
    for (int i = 0; i < pos; ++i) {
        cc += c[i] * c[i];
        mu += c[i] * w[i];
    }
    double dd2 = kxx - cc;
    if (dd2 <= 0.0 || !std::isfinite(dd2)) return 2;
    const double dd = std::sqrt(dd2);
    *dd_out = dd;

    // L row: [c^T, dd]
    double* lrow = L + (size_t)pos * lda;
    for (int k = 0; k < pos; ++k) lrow[k] = c[k];
    lrow[pos] = dd;

    // Linv row: -(c^T Linv)/dd, diag 1/dd  (column k: sum_i c_i Linv[i,k])
    double* vrow = Linv + (size_t)pos * lda;
    const double inv_dd = 1.0 / dd;
    for (int k = 0; k < pos; ++k) {
        double acc = 0.0;
        for (int i = k; i < pos; ++i)
            acc += c[i] * Linv[(size_t)i * lda + k];
        vrow[k] = -acc * inv_dd;
    }
    vrow[pos] = inv_dd;

    w[pos] = (y - mu) * inv_dd;
    return 0;
}

}  // extern "C"
