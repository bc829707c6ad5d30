// Image-source RIR accumulation kernel.
//
// The port's copy of sarssl_tpu/data/csrc/ism.cpp: the native equivalent of
// the image loop in sarssl_torch/data/ism.py (which itself replaces the gpuRIR
// CUDA kernel the reference calls, data_generation/utils_simu_rir_sig.py
// :475-508).
//
// For every (x, y, z) image triple within the propagation-time limit, place a
// 16-tap windowed-sinc fractional-delay pulse scaled by the product of the
// per-axis reflection amplitudes and 1/(4*pi*dist) spreading into each mic's
// RIR. OpenMP-parallel over microphones x x-slabs.
//
// Built at first use into sarssl_torch/_build/ by sarssl_torch/data/native.py,
// or ahead of time with: python -m sarssl_torch.data.build_native

#include <cmath>
#include <cstdint>
#include <vector>

namespace {
constexpr int kSincHalf = 8;  // 16 taps total
constexpr double kPi = 3.14159265358979323846;

inline double sinc(double x) {
  if (std::fabs(x) < 1e-12) return 1.0;
  const double px = kPi * x;
  return std::sin(px) / px;
}
}  // namespace

extern "C" void ism_core(
    const double* cx, const double* ax, int nx,
    const double* cy, const double* ay, int ny,
    const double* cz, const double* az, int nz,
    const double* mics, int nmic,
    double* rir, int nsamp,
    double fs, double c, double t_lim) {
  const double max_dist = t_lim * c;
  const double max_dist2 = max_dist * max_dist;

  for (int m = 0; m < nmic; ++m) {
    const double mx = mics[3 * m + 0];
    const double my = mics[3 * m + 1];
    const double mz = mics[3 * m + 2];
    double* out = rir + static_cast<int64_t>(m) * nsamp;

#pragma omp parallel
    {
      std::vector<double> local(nsamp, 0.0);
#pragma omp for schedule(dynamic, 1) nowait
      for (int i = 0; i < nx; ++i) {
        const double dx = cx[i] - mx;
        const double dx2 = dx * dx;
        if (dx2 > max_dist2) continue;
        for (int j = 0; j < ny; ++j) {
          const double dy = cy[j] - my;
          const double dxy2 = dx2 + dy * dy;
          if (dxy2 > max_dist2) continue;
          const double axy = ax[i] * ay[j];
          for (int k = 0; k < nz; ++k) {
            const double dz = cz[k] - mz;
            const double d2 = dxy2 + dz * dz;
            if (d2 > max_dist2) continue;
            const double dist = std::sqrt(d2);
            const double amp =
                axy * az[k] / (4.0 * kPi * (dist < 1e-2 ? 1e-2 : dist));
            const double t0 = dist / c * fs;
            const int base = static_cast<int>(std::floor(t0));
            const double frac = t0 - base;
            for (int t = -kSincHalf + 1; t <= kSincHalf; ++t) {
              const int idx = base + t;
              if (idx < 0 || idx >= nsamp) continue;
              const double arg = t - frac;
              const double win =
                  0.5 * (1.0 + std::cos(kPi * arg / kSincHalf));
              local[idx] += amp * sinc(arg) * win;
            }
          }
        }
      }
#pragma omp critical
      for (int s = 0; s < nsamp; ++s) out[s] += local[s];
    }
  }
}
