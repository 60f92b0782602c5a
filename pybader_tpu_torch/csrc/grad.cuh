// The transformed central-difference gradient of a voxel, shared by the
// walk-row builds (neargrid.cu: the exact rows' march calls gradient_of on
// staged planes, the q-rows transformed_gradient) and the nginit codes
// (stencil.cu).
//
// JAX's _gd_components (pybader_tpu/ops/neargrid.py:64) and the gradient of
// neargrid_init_codes (pybader_tpu/ops/stencil.py:136-147):
//     g_j  = (rho[up_j] - rho[dn_j]) * 0.5, 0 where the voxel is flat along j
//     gd_i = ((0 + T[i,0] g_0) + T[i,1] g_1) + T[i,2] g_2
// "Flat" is rho[up] < rho and rho[dn] < rho when strict, <= otherwise.  Each
// sum and product is rounded on its own (the library builds with
// -fmad=false), so the kernels equal the plain PyTorch versions bit for bit.
#pragma once

#include "common.cuh"

namespace pb {

__device__ __forceinline__ int wrap(int v, int n) {
    v %= n;
    return v < 0 ? v + n : v;
}

// Fills gd[3] from the density rp of a voxel and its axis neighbours
// ru[j] (up) and rd[j] (down), and returns max_i |gd_i|.  t: the 3x3
// transform, row-major (a pointer, or an array passed by value).
template <class T>
__device__ __forceinline__ double gradient_of(double rp, const double (&ru)[3],
                                              const double (&rd)[3],
                                              const T& t, bool strict,
                                              double gd[3]) {
    double grad[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
        const bool flat = strict ? (ru[j] < rp && rd[j] < rp)
                                 : (ru[j] <= rp && rd[j] <= rp);
        grad[j] = flat ? 0.0 : __dmul_rn(__dsub_rn(ru[j], rd[j]), 0.5);
    }
#pragma unroll
    for (int r = 0; r < 3; ++r) {
        double acc = 0.0;
#pragma unroll
        for (int j = 0; j < 3; ++j)
            acc = __dadd_rn(acc, __dmul_rn(t[r * 3 + j], grad[j]));
        gd[r] = acc;
    }
    return fmax(fmax(fabs(gd[0]), fabs(gd[1])), fabs(gd[2]));
}

// gradient_of for voxel i = (x, y, z), its neighbours read from rho.
__device__ __forceinline__ double transformed_gradient(
        const double* __restrict__ rho, long long i, int x, int y, int z,
        int nx, int ny, int nz, const double* t, bool strict, double gd[3]) {
    const long long up[3] = {
        (static_cast<long long>(wrap(x + 1, nx)) * ny + y) * nz + z,
        (static_cast<long long>(x) * ny + wrap(y + 1, ny)) * nz + z,
        (static_cast<long long>(x) * ny + y) * nz + wrap(z + 1, nz)};
    const long long dn[3] = {
        (static_cast<long long>(wrap(x - 1, nx)) * ny + y) * nz + z,
        (static_cast<long long>(x) * ny + wrap(y - 1, ny)) * nz + z,
        (static_cast<long long>(x) * ny + y) * nz + wrap(z - 1, nz)};
    double ru[3], rd[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
        ru[j] = rho[up[j]];
        rd[j] = rho[dn[j]];
    }
    return gradient_of(rho[i], ru, rd, t, strict, gd);
}

}  // namespace pb
