// Exact per-contact Coulomb-cone impulse, `cone_solve_lanes`: the solve with
// its angular grid split over the FS_LANES lanes of one world. Both kernels
// that solve contacts call it, each defining the lane regions first: the
// fused full step (whose generated head defines them) and the matrix-free
// solve (mf_solve.cu).
//
// Replaces the TPU device function raisimlib_tpu/ops/pallas_contact.py
// `_cone_solve_vec` + `_stick_vec`, which the TPU kernels inline into their
// Gauss-Seidel loops. All are __device__ functions, inlined by their
// kernels.
//
// Cases, as in ops/contact.py `cone_solve` (RA-L 2018 semantics):
//   stick: lam = -Gii^-1 c (cofactor inverse), accepted strictly inside the
//          cone, or always when mu > 1e6 (the bilateral sentinel);
//   open:  c2 >= 0 gives lam = 0;
//   slip:  lam = s(theta) [mu cos, mu sin, 1] with v_n+ = 0, theta minimising
//          E on an n_grid-point angular grid, then two shrinking 5-point
//          refinements and a parabolic fit through the last bracket.
// The arithmetic follows the TPU kernel: big = 3e38 marks infeasible angles,
// the argmin is the first index that attains the minimum, and the 5-point
// neighbours wrap (minimum at point 0 takes point 4 as its left neighbour).
// Compile without --use_fast_math: sincosf and division must be IEEE.

#pragma once

namespace rsl {

constexpr float kConeBig = 3e38f;

// Angular constants, computed on the host in double and rounded once, as the
// TPU kernel's Python-float constants are.
struct ConeConsts {
  int n_grid;
  float dtheta;  // 2 pi / n_grid
  float span1;   // first refinement half-spacing: dtheta / 2
  float span2;   // second refinement half-spacing: dtheta / 8
  float h;       // parabolic-fit spacing: dtheta / 16
};

// g = (g00, g01, g02, g11, g12, g22): the 6 unique entries of the 3x3 block.
__device__ __forceinline__ void stick_solve(const float* g, float c0, float c1,
                                            float c2, float* out) {
  const float g00 = g[0], g01 = g[1], g02 = g[2], g11 = g[3], g12 = g[4], g22 = g[5];
  const float k00 = g11 * g22 - g12 * g12;
  const float k01 = g02 * g12 - g01 * g22;
  const float k02 = g01 * g12 - g02 * g11;
  const float k11 = g00 * g22 - g02 * g02;
  const float k12 = g01 * g02 - g00 * g12;
  const float k22 = g00 * g11 - g01 * g01;
  const float det = g00 * k00 + g01 * k01 + g02 * k02;
  const float inv_det = 1.0f / (det + 1e-20f);
  out[0] = -(k00 * c0 + k01 * c1 + k02 * c2) * inv_det;
  out[1] = -(k01 * c0 + k11 * c1 + k12 * c2) * inv_det;
  out[2] = -(k02 * c0 + k12 * c1 + k22 * c2) * inv_det;
}

// E on the slip curve at the angle whose sine and cosine are sn, cs
// (kConeBig where infeasible); also s, d0, d1.
__device__ __forceinline__ float cone_curve_sc(const float* g, float c0, float c1,
                                               float c2, float mu, float sn, float cs,
                                               float* s_out, float* d0_out,
                                               float* d1_out) {
  const float d0 = mu * cs;
  const float d1 = mu * sn;
  const float gd0 = g[0] * d0 + g[1] * d1 + g[2];
  const float gd1 = g[1] * d0 + g[3] * d1 + g[4];
  const float gd2 = g[2] * d0 + g[4] * d1 + g[5];
  const bool den_ok = gd2 > 1e-12f;
  float s = -c2 / (den_ok ? gd2 : 1.0f);
  const bool feas = den_ok && (s > 0.0f);
  s = feas ? s : 0.0f;
  const float dgd = d0 * gd0 + d1 * gd1 + gd2;
  const float dc = d0 * c0 + d1 * c1 + c2;
  const float E = 0.5f * s * s * dgd + s * dc;
  *s_out = s;
  *d0_out = d0;
  *d1_out = d1;
  return feas ? E : kConeBig;
}

// E(theta) on the slip curve; also s, d0, d1.
__device__ __forceinline__ float cone_curve(const float* g, float c0, float c1,
                                            float c2, float mu, float theta,
                                            float* s_out, float* d0_out,
                                            float* d1_out) {
  float sn, cs;
  sincosf(theta, &sn, &cs);
  return cone_curve_sc(g, c0, c1, c2, mu, sn, cs, s_out, d0_out, d1_out);
}

__device__ __forceinline__ float cone_curve_E(const float* g, float c0, float c1,
                                              float c2, float mu, float theta) {
  float s, d0, d1;
  return cone_curve(g, c0, c1, c2, mu, theta, &s, &d0, &d1);
}

#ifdef FS_LANES_BEGIN
// The grid's sines and cosines, trig[2 k] and trig[2 k + 1] = sincosf(k
// dtheta), written in a lane region: they are the same for every solve.
__device__ __forceinline__ void cone_grid_trig(const ConeConsts& cc, float* trig,
                                               const int fs_lane) {
  FS_LANES_BEGIN
  for (int k = l; k < cc.n_grid; k += FS_LANES)
    sincosf((float)k * cc.dtheta, trig + 2 * k, trig + 2 * k + 1);
  FS_LANES_END
}

// The cone solve with the angular search split over the FS_LANES lanes of
// one world (the includer's lane regions): lane l evaluates the grid points
// k = l (mod FS_LANES) into the world's shared E (n_grid floats), from the
// sines and cosines of cone_grid_trig, then, in each refinement, the points
// j = l (mod FS_LANES) of the 5 into E[0..4]. Everything else, the
// first-match argmins over E included, every lane runs alike and gets the
// same values. Each value is the expression of the one-thread solve it
// replaced and of the plain twin (ops/gpu_contact.py `_cone_solve_grid`):
// sincosf of the same angle, and a refinement point's offset, 0.5 (j - 2)
// times the span, is exact. So the impulse is the same for any FS_LANES.
__device__ __forceinline__ void cone_solve_lanes(const float* gs, float c0, float c1,
                                                 float c2, float mu, const ConeConsts& cc,
                                                 const float* trig, float* E,
                                                 const int fs_lane, float* out) {
  float g[6];                         // gs may be shared: read it once, before the syncs
#pragma unroll
  for (int k = 0; k < 6; ++k) g[k] = gs[k];
  float ls[3];
  stick_solve(g, c0, c1, c2, ls);
  const float t_norm = sqrtf(ls[0] * ls[0] + ls[1] * ls[1] + 1e-20f);
  const bool stick_ok = ((ls[2] > 0.0f) && (t_norm <= mu * ls[2])) || (mu > 1e6f);
  const bool open_ok = c2 >= 0.0f;

  FS_LANES_BEGIN
#pragma unroll
  for (int i = 0; i < (cc.n_grid + FS_LANES - 1) / FS_LANES; ++i) {
    const int k = l + i * FS_LANES;
    float s, d0, d1;
    if (k < cc.n_grid)
      E[k] = cone_curve_sc(g, c0, c1, c2, mu, trig[2 * k], trig[2 * k + 1], &s, &d0, &d1);
  }
  FS_LANES_END
  bool grid_nan = false;
  int kmin = 0;
  float Emin = kConeBig;
#pragma unroll
  for (int k = 0; k < cc.n_grid; ++k) {
    const float Ek = E[k];
    if (Ek != Ek) {
      grid_nan = true;
    } else if (k == 0 || Ek < Emin) {
      Emin = Ek;
      kmin = k;
    }
  }
  const bool any_feas = !grid_nan && (Emin < kConeBig);
  float theta_b = grid_nan ? 0.0f : (float)kmin * cc.dtheta;

  float E0 = 0.0f, Em = 0.0f, Ep = 0.0f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float span = r == 0 ? cc.span1 : cc.span2;
    FS_LANES_BEGIN
#pragma unroll 1
    for (int j = l; j < 5; j += FS_LANES)
      E[j] = cone_curve_E(g, c0, c1, c2, mu, theta_b + 0.5f * (float)(j - 2) * span);
    FS_LANES_END
    float E5[5];
    bool nan5 = false;
    int k5 = 0;
#pragma unroll
    for (int j = 0; j < 5; ++j) E5[j] = E[j];
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      if (E5[j] != E5[j]) nan5 = true;
      else if (E5[j] < E5[k5] || E5[k5] != E5[k5]) k5 = j;
    }
    if (nan5) {
      theta_b = E0 = Em = Ep = 0.0f;
    } else {
      theta_b = theta_b + 0.5f * (float)(k5 - 2) * span;
      E0 = E5[k5];
      Em = E5[(k5 + 4) % 5];
      Ep = E5[(k5 + 1) % 5];
    }
  }
  const float denom = Em - 2.0f * E0 + Ep;
  float off = fabsf(denom) > 1e-30f ? 0.5f * (Em - Ep) / (denom + 1e-30f) : 0.0f;
  off = fminf(fmaxf(off, -1.0f), 1.0f);
  theta_b = theta_b + off * cc.h;

  float s_b, d0_b, d1_b;
  cone_curve(g, c0, c1, c2, mu, theta_b, &s_b, &d0_b, &d1_b);
  const float s_safe = any_feas ? s_b : -c2 / (g[5] + 1e-20f);
  const float l0 = any_feas ? s_safe * d0_b : 0.0f;
  const float l1 = any_feas ? s_safe * d1_b : 0.0f;

  out[0] = stick_ok ? ls[0] : (open_ok ? 0.0f : l0);
  out[1] = stick_ok ? ls[1] : (open_ok ? 0.0f : l1);
  out[2] = stick_ok ? ls[2] : (open_ok ? 0.0f : s_safe);
}
#endif  // FS_LANES_BEGIN

}  // namespace rsl
