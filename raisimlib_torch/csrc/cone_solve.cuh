// Exact per-contact Coulomb-cone impulse, `cone_solve_lanes`: the solve with
// its angular grid split over the FS_LANES lanes of one world. Both kernels
// that solve contacts call it, each defining the lane regions first: the
// fused full step (whose generated head defines them) and the matrix-free
// solve (mf_solve.cu).
//
// Replaces the TPU device function raisimlib_tpu/ops/pallas_contact.py
// `_cone_solve_vec` + `_stick_vec`, which the TPU kernels inline into their
// Gauss-Seidel loops. All are __device__ functions inlined where they are
// called, except `cone_solve_lanes` itself, whose attribute the includer
// may choose by defining RSL_CONE_SOLVE_ATTR before the include (default
// __forceinline__): the fused step, which calls it from one site per
// contact slot in every sweep, defines __noinline__ where its sweep holds
// enough slots for one called copy to beat a copy a slot
// (ops/gpu_step.py `solve_called`); the matrix-free solve, one call site in
// its row loop, keeps the default.
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
// Compile without --use_fast_math: sincosf and division must be IEEE. The
// FMAs are written out (fmaf), each where a * b + c of the twin's order
// stood, so that a build with --fmad=false, as the fused step's are,
// rounds each value as written here, whatever code its includer puts
// around the solve.

#pragma once

#ifndef RSL_CONE_SOLVE_ATTR
#define RSL_CONE_SOLVE_ATTR __forceinline__
#endif

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
  const float k00 = fmaf(g11, g22, -g12 * g12);
  const float k01 = fmaf(g02, g12, -g01 * g22);
  const float k02 = fmaf(g01, g12, -g02 * g11);
  const float k11 = fmaf(g00, g22, -g02 * g02);
  const float k12 = fmaf(g01, g02, -g00 * g12);
  const float k22 = fmaf(g00, g11, -g01 * g01);
  const float det = fmaf(g02, k02, fmaf(g01, k01, g00 * k00));
  const float inv_det = 1.0f / (det + 1e-20f);
  out[0] = -fmaf(k02, c2, fmaf(k01, c1, k00 * c0)) * inv_det;
  out[1] = -fmaf(k12, c2, fmaf(k11, c1, k01 * c0)) * inv_det;
  out[2] = -fmaf(k22, c2, fmaf(k12, c1, k02 * c0)) * inv_det;
}

// E on the slip curve at the angle whose sine and cosine are sn, cs
// (kConeBig where infeasible); also s, d0, d1.
__device__ __forceinline__ float cone_curve_sc(const float* g, float c0, float c1,
                                               float c2, float mu, float sn, float cs,
                                               float* s_out, float* d0_out,
                                               float* d1_out) {
  const float d0 = mu * cs;
  const float d1 = mu * sn;
  const float gd0 = fmaf(g[1], d1, g[0] * d0) + g[2];
  const float gd1 = fmaf(g[3], d1, g[1] * d0) + g[4];
  const float gd2 = fmaf(g[4], d1, g[2] * d0) + g[5];
  const bool den_ok = gd2 > 1e-12f;
  float s = -c2 / (den_ok ? gd2 : 1.0f);
  const bool feas = den_ok && (s > 0.0f);
  s = feas ? s : 0.0f;
  const float dgd = fmaf(d1, gd1, d0 * gd0) + gd2;
  const float dc = fmaf(d1, c1, d0 * c0) + c2;
  const float E = fmaf(0.5f * s * s, dgd, s * dc);
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
// The key of an energy in the first-match argmin: unsigned order is the
// order of the floats, the two zeros are one key, and a NaN comes first (0;
// any NaN marks the search). A key selects and computes nothing.
__device__ __forceinline__ unsigned cone_key(float e) {
  const unsigned b = __float_as_uint(e + 0.0f);       // -0 + 0 = +0
  return e != e ? 0u : ((b & 0x80000000u) ? ~b : (b | 0x80000000u));
}

// A lane's own values and the exchanges between the lanes of one world, in
// the card's forms (a host build of a body defines its own first, where one
// thread runs a world's lanes in turn):
//   FS_EACH_BEGIN ... FS_EACH_END  a lane loop: lane l = fs_lane runs the
//                                  body for its own l; no sync, for the body
//                                  writes no shared memory, only its own values;
//   FS_OWN(T, x, n)                n values of type T that each lane holds
//                                  its own of, FS_MINE(x, i) inside a lane loop;
//   FS_FROM(x, i, src)             the i-th of lane src's x, in every lane
//                                  (i a constant);
//   FS_ARGMIN(key, k, kmin_key, kmin)  the least key[0] over the world's
//                                  lanes, and the least k[0] of the lanes that
//                                  hold it, in every lane.
// A world's lanes are FS_LANES adjacent lanes of a warp, from a multiple of
// FS_LANES. The includer names in FS_LANE_MASK the warp's lanes that take
// part: every world of the warp passes the same exchanges in the same order.
#ifndef FS_EACH_BEGIN
#define FS_EACH_BEGIN { const int l = fs_lane;
#define FS_EACH_END }
#define FS_OWN(T, x, n) T x[n]
#define FS_MINE(x, i) x[i]
#define FS_FROM(x, i, src) __shfl_sync(FS_LANE_MASK, x[i], src, FS_LANES)
#define FS_ARGMIN(key, k, kmin_key, kmin) rsl::lanes_argmin(key[0], k[0], &kmin_key, &kmin)

// One world a warp: two warp reductions (redux.sync), the least key, then
// the least index of the lanes that hold it. Several worlds a warp:
// log2(FS_LANES) rounds of __shfl_xor_sync within each world's lanes, each
// lane keeping the pair that comes first (redux.sync over each world's part
// of the warp ran K1's 8-lane build 18% slower on an H100).
__device__ __forceinline__ void lanes_argmin(unsigned key, int k, unsigned* kmin_key, int* kmin) {
  if (FS_LANES == 32) {
    const unsigned m = __reduce_min_sync(FS_LANE_MASK, key);
    *kmin_key = m;
    *kmin = (int)__reduce_min_sync(FS_LANE_MASK, key == m ? (unsigned)k : 0xffffffffu);
    return;
  }
#pragma unroll
  for (int m = 1; m < FS_LANES; m <<= 1) {
    const unsigned ko_key = __shfl_xor_sync(FS_LANE_MASK, key, m, FS_LANES);
    const int ko = __shfl_xor_sync(FS_LANE_MASK, k, m, FS_LANES);
    if (ko_key < key || (ko_key == key && ko < k)) {
      key = ko_key;
      k = ko;
    }
  }
  *kmin_key = key;
  *kmin = k;
}
#endif  // FS_EACH_BEGIN

// The points of a refinement a lane holds: j = l + i FS_LANES < 5.
constexpr int kConeRefineItems = (5 + FS_LANES - 1) / FS_LANES;

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
// one world (the includer's lane loops and exchanges): lane l evaluates the
// grid points k = l (mod FS_LANES), from the sines and cosines of
// cone_grid_trig, and keeps the first of its least key (cone_key);
// FS_ARGMIN then gives every lane the grid's first-match argmin. In each
// refinement the lanes j of the 5 points evaluate them and every lane takes
// all 5 (FS_FROM), then scans them as the one-thread solve did. Everything
// else every lane runs alike and gets the same values, in registers: the
// solve writes no shared memory. Each value has one expression at any
// FS_LANES, that of the plain twin (ops/gpu_contact.py `_cone_solve_grid`)
// up to the FMAs: sincosf of the same angle, and a refinement point's
// offset, 0.5 (j - 2) times the span, is exact; the argmins select, and ties
// go to the lowest index. So the impulse is the same for any FS_LANES.
__device__ RSL_CONE_SOLVE_ATTR void cone_solve_lanes(const float* gs, float c0, float c1,
                                                     float c2, float mu, const ConeConsts& cc,
                                                     const float* trig, const int fs_lane,
                                                     float* out) {
  float g[6];                         // gs may be shared: read it once
#pragma unroll
  for (int k = 0; k < 6; ++k) g[k] = gs[k];
  float ls[3];
  stick_solve(g, c0, c1, c2, ls);
  const float t_norm = sqrtf(fmaf(ls[1], ls[1], ls[0] * ls[0]) + 1e-20f);
  const bool stick_ok = ((ls[2] > 0.0f) && (t_norm <= mu * ls[2])) || (mu > 1e6f);
  const bool open_ok = c2 >= 0.0f;

  FS_OWN(unsigned, keys, 1);
  FS_OWN(int, ks, 1);
  FS_EACH_BEGIN
  unsigned best = 0xffffffffu;        // no point yet: after every key
  int kbest = cc.n_grid;
#pragma unroll
  for (int i = 0; i < (cc.n_grid + FS_LANES - 1) / FS_LANES; ++i) {
    const int k = l + i * FS_LANES;
    float s, d0, d1;
    if (k < cc.n_grid) {
      const unsigned key = cone_key(
          cone_curve_sc(g, c0, c1, c2, mu, trig[2 * k], trig[2 * k + 1], &s, &d0, &d1));
      if (key < best) {
        best = key;
        kbest = k;
      }
    }
  }
  FS_MINE(keys, 0) = best;
  FS_MINE(ks, 0) = kbest;
  FS_EACH_END
  unsigned kmin_key;
  int kmin;
  FS_ARGMIN(keys, ks, kmin_key, kmin);
  const bool grid_nan = kmin_key == 0u;
  const bool any_feas = !grid_nan && (kmin_key < cone_key(kConeBig));
  float theta_b = grid_nan ? 0.0f : (float)kmin * cc.dtheta;

  float E0 = 0.0f, Em = 0.0f, Ep = 0.0f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float span = r == 0 ? cc.span1 : cc.span2;
    FS_OWN(float, e5, kConeRefineItems);
    FS_EACH_BEGIN
#pragma unroll
    for (int i = 0; i < kConeRefineItems; ++i) {
      const int j = l + i * FS_LANES;
      FS_MINE(e5, i) = 0.0f;
      if (j < 5)
        FS_MINE(e5, i) = cone_curve_E(g, c0, c1, c2, mu, theta_b + 0.5f * (float)(j - 2) * span);
    }
    FS_EACH_END
    float E5[5];
    bool nan5 = false;
    int k5 = 0;
#pragma unroll
    for (int j = 0; j < 5; ++j) E5[j] = FS_FROM(e5, j / FS_LANES, j % FS_LANES);
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
