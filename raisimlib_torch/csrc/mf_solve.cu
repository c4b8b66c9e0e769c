// Matrix-free Gauss-Seidel contact-dynamics solve, one world per thread.
//
// Replaces the TPU kernel raisimlib_tpu/ops/pallas_contact.py `_mf_kernel`
// (pallas_call in `_mf_impl`, public entry `solve_dynamics_batch`), with the
// cone solve of cone_solve.cuh inlined as the TPU kernel inlines
// `_cone_solve_vec`. Per world it solves
//
//   u_new = vf + M^-1 J^T lam,   lam = GS-cone-solve(G = J M^-1 J^T, c0),
//
// without forming G: it hoists the 3x3 diagonal blocks Gii and c0_i = J_i vf
// - bias_i, keeps z = M^-1 J^T lam up to date through `sweeps` sweeps (so
// (G lam)_i = J_i z), and returns u_new = vf + z and lam.
//
// Layout: batch-last, as on the TPU, so that neighbouring threads (worlds)
// read neighbouring addresses: Jr, Wt (3nc, nv, B); vf (nv, B); bias (3nc, B);
// mu, act (nc, B); outputs u (nv, B), lam (3nc, B). `kinds` (nc,) holds 0 =
// cone, 1 = lin (frictionless unilateral: only the 3rd component), 2 =
// bilateral (unconstrained 3x3 solve). Kinds are uniform across threads, so
// the row branches do not diverge.
//
// What bounds it on an H100: at the ANYmal shapes (nc = 24, nv = 18) a world
// reads about 10.9 KB (Jr and Wt dominate) and writes 0.36 KB, and does about
// 3e5 float operations, most of them in the 32-point angular grids of the
// cone rows (12 sweeps x 12 cone rows). At B = 16384 that is about 0.19 GB
// (56 us at 3.35 TB/s) against about 5 GFLOP (74 us at 67 TFLOP/s): the
// operations bound it, narrowly. This first version is simple on purpose:
// z, lam and the hoisted blocks live in per-thread local memory (indexed at
// run time), and every row re-reads its Jr/Wt rows from device memory (L2
// catches the re-reads across sweeps). Each cone row evaluates the full grid
// whatever its case, as the TPU kernel does. Measured with chip_smoke.py on an
// H100 80GB HBM3 at 700 W: 2.77 ms at B = 16384, 36x the bound.

#include <cuda_runtime.h>
#include <math.h>

#include "cone_solve.cuh"

#ifndef MF_MAX_NC
#define MF_MAX_NC 48
#endif
#ifndef MF_MAX_NV
#define MF_MAX_NV 64
#endif

namespace {

constexpr int kBlock = 128;

__global__ void __launch_bounds__(kBlock)
mf_solve_kernel(const float* __restrict__ Jr, const float* __restrict__ Wt,
                const float* __restrict__ vf, const float* __restrict__ bias,
                const float* __restrict__ mu, const float* __restrict__ act,
                const int* __restrict__ kinds, float* __restrict__ u,
                float* __restrict__ lam, int B, int nc, int nv, int sweeps,
                rsl::ConeConsts cc) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t sB = (size_t)B;
  // element (row r, dof k) of a (3nc, nv, B) array for this world
#define ROW(p, r, k) (p)[((size_t)(r) * nv + (k)) * sB + b]

  float z[MF_MAX_NV];
  float lm[3 * MF_MAX_NC];
  float gii[6 * MF_MAX_NC];
  float ci0[3 * MF_MAX_NC];

  // ---- hoisted per-row invariants: Gii and c0_i ----
  for (int i = 0; i < nc; ++i) {
    const int kind = kinds[i];
    for (int a = 0; a < 3; ++a) {
      const int r = 3 * i + a;
      if (kind == 1 && a < 2) {
        ci0[r] = 0.0f;
        continue;
      }
      float acc = 0.0f;
      for (int k = 0; k < nv; ++k) acc += ROW(Jr, r, k) * vf[(size_t)k * sB + b];
      ci0[r] = acc - bias[(size_t)r * sB + b];
    }
    // unique entries (00, 01, 02, 11, 12, 22); a lin row uses only 22
    int e = 0;
    for (int a = 0; a < 3; ++a) {
      for (int c = a; c < 3; ++c, ++e) {
        float acc = 0.0f;
        if (kind != 1 || (a == 2 && c == 2)) {
          for (int k = 0; k < nv; ++k) acc += ROW(Jr, 3 * i + a, k) * ROW(Wt, 3 * i + c, k);
        }
        gii[6 * i + e] = acc;
      }
    }
  }
  for (int k = 0; k < nv; ++k) z[k] = 0.0f;
  for (int r = 0; r < 3 * nc; ++r) lm[r] = 0.0f;

  // ---- Gauss-Seidel sweeps ----
  for (int sw = 0; sw < sweeps; ++sw) {
    for (int i = 0; i < nc; ++i) {
      const int kind = kinds[i];
      const float* g = &gii[6 * i];
      const float ai = act[(size_t)i * sB + b];
      if (kind == 1) {
        const int r = 3 * i + 2;
        const float li2 = lm[r];
        float jz = 0.0f;
        for (int k = 0; k < nv; ++k) jz += ROW(Jr, r, k) * z[k];
        const float c2 = ci0[r] + jz - g[5] * li2;
        const float x = -c2 / (g[5] + 1e-20f);
        const float ln2 = (x != x ? x : (x > 0.0f ? x : 0.0f)) * ai;
        const float d2 = ln2 - li2;
        for (int k = 0; k < nv; ++k) z[k] += ROW(Wt, r, k) * d2;
        lm[r] = ln2;
        continue;
      }
      const float li0 = lm[3 * i], li1 = lm[3 * i + 1], li2 = lm[3 * i + 2];
      float jz0 = 0.0f, jz1 = 0.0f, jz2 = 0.0f;
      for (int k = 0; k < nv; ++k) {
        const float zk = z[k];
        jz0 += ROW(Jr, 3 * i, k) * zk;
        jz1 += ROW(Jr, 3 * i + 1, k) * zk;
        jz2 += ROW(Jr, 3 * i + 2, k) * zk;
      }
      const float c0 = ci0[3 * i] + jz0 - (g[0] * li0 + g[1] * li1 + g[2] * li2);
      const float c1 = ci0[3 * i + 1] + jz1 - (g[1] * li0 + g[3] * li1 + g[4] * li2);
      const float c2 = ci0[3 * i + 2] + jz2 - (g[2] * li0 + g[4] * li1 + g[5] * li2);
      float ln[3];
      if (kind == 2) {
        rsl::stick_solve(g, c0, c1, c2, ln);
      } else {
        rsl::cone_solve(g, c0, c1, c2, mu[(size_t)i * sB + b], cc, ln);
      }
      const float la0 = ln[0] * ai, la1 = ln[1] * ai, la2 = ln[2] * ai;
      const float d0 = la0 - li0, d1 = la1 - li1, d2 = la2 - li2;
      for (int k = 0; k < nv; ++k) {
        float dz = ROW(Wt, 3 * i, k) * d0;
        dz = dz + ROW(Wt, 3 * i + 1, k) * d1;
        dz = dz + ROW(Wt, 3 * i + 2, k) * d2;
        z[k] += dz;
      }
      lm[3 * i] = la0;
      lm[3 * i + 1] = la1;
      lm[3 * i + 2] = la2;
    }
  }

  for (int k = 0; k < nv; ++k) u[(size_t)k * sB + b] = vf[(size_t)k * sB + b] + z[k];
  for (int r = 0; r < 3 * nc; ++r) lam[(size_t)r * sB + b] = lm[r];
#undef ROW
}

}  // namespace

// Plain C entry point for ctypes. Launches on `stream` and returns
// cudaGetLastError() (0 = launched), so that a refused launch is reported
// instead of silently skipped.
extern "C" int mf_solve_launch(const void* Jr, const void* Wt, const void* vf,
                               const void* bias, const void* mu, const void* act,
                               const void* kinds, void* u, void* lam, int B,
                               int nc, int nv, int sweeps, int n_grid,
                               void* stream) {
  if (B < 1 || nc < 1 || nc > MF_MAX_NC || nv < 1 || nv > MF_MAX_NV ||
      sweeps < 0 || n_grid < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const double dth = 2.0 * M_PI / (double)n_grid;
  rsl::ConeConsts cc;
  cc.n_grid = n_grid;
  cc.dtheta = (float)dth;
  cc.span1 = (float)(0.5 * dth);
  cc.span2 = (float)(0.125 * dth);
  cc.h = (float)(dth / 16.0);
  const int blocks = (B + kBlock - 1) / kBlock;
  mf_solve_kernel<<<blocks, kBlock, 0, (cudaStream_t)stream>>>(
      (const float*)Jr, (const float*)Wt, (const float*)vf, (const float*)bias,
      (const float*)mu, (const float*)act, (const int*)kinds, (float*)u,
      (float*)lam, B, nc, nv, sweeps, cc);
  return (int)cudaGetLastError();
}
