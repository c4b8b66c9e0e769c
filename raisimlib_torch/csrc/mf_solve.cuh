// One world's matrix-free Gauss-Seidel contact solve (K2's body), run by the
// FS_LANES lanes of the world. csrc/mf_solve.cu gives it its CUDA frame; the
// tests build it as host C++, where the lane regions run lane after lane.
//
// The includer defines FS_LANES, FS_LANES_BEGIN / FS_LANES_END (a lane
// region: lane l = fs_lane of the world runs the body for its own l, with a
// sync on both sides) and FS_LANE_MASK (the threads of the block, which the
// cone solve's exchanges between lanes take).
//
// The lanes run the serial parts alike, each in its own registers: the J.z
// dots, c and the stick solve. They split the independent parts in lane
// regions: the staging of the world's rows, the hoisted Gii and c0 dots (one
// dot per item, each in the one-thread order), the cone solve's angular grid
// and refinements, whose argmins the lanes reduce between them
// (rsl::cone_solve_lanes), the W updates of z (by dof) and the stores (each
// output entry by one lane).
// Every value keeps the expression and summation order of the one-thread
// kernel this body replaced, so the impulses do not depend on FS_LANES.
// Serial code writes no shared memory; shared pointers are never
// __restrict__ (other lanes write through them, and restrict would let the
// compiler move their loads across the syncs).

#pragma once

#include <math.h>

#include "cone_solve.cuh"

namespace rsl {

// Kinds of solver rows (`kinds` of the row table): 0 = cone, 1 = lin (only
// the third component, frictionless unilateral), 2 = bilateral.
constexpr int kMfLin = 1;
constexpr int kMfBilateral = 2;

// Offsets (floats) of one world's shared arrays, in order: js (J rows) and
// ws (W rows), nrow x nv each, only the rows the kinds use (3 of a cone or
// bilateral row, the third of a lin row), present in the staged layout only;
// vf (nv); z (nv); lam (3 nc); gii (6 nc: 00, 01, 02, 11, 12, 22); c0 (3 nc);
// mu and act (nc each); trig, the cone solve's grid's sines and cosines (2
// n_grid).
struct MfLayout {
  int js, ws, vf, z, lam, gii, c0, mu, act, trig, total;
};

__host__ __device__ inline MfLayout mf_layout(int nc, int nv, int nrow, int n_grid,
                                              bool staged) {
  const int rows = staged ? nrow * nv : 0;
  MfLayout o;
  int off = 0;
  o.js = off;
  off += rows;
  o.ws = off;
  off += rows;
  o.vf = off;
  off += nv;
  o.z = off;
  off += nv;
  o.lam = off;
  off += 3 * nc;
  o.gii = off;
  off += 6 * nc;
  o.c0 = off;
  off += 3 * nc;
  o.mu = off;
  off += nc;
  o.act = off;
  off += nc;
  o.trig = off;
  off += 2 * n_grid;
  o.total = off;
  return o;
}

// The most shared memory one block may hold on an H100 (227 KB).
constexpr int kMfSmemBlockLimit = 232448;

// Worlds per block at these shapes, and the layout (*staged): the staged
// layout (the world's used J and W rows in shared memory) in a one-warp block
// of 32 / FS_LANES worlds, or, where their shared arrays would pass
// kMfSmemBlockLimit, as many as fit (a partial warp of wpb x FS_LANES
// threads); where one world's rows do not fit, the device-memory layout (J
// and W read from the inputs each sweep, the small arrays in shared memory)
// at 32 / FS_LANES worlds, or as many as fit; 0 where one world's small
// arrays do not fit. *bytes gets the block's shared memory (dynamic, in
// bytes). Built with MF_DEVICE_ROWS, the device-memory layout is taken
// whenever it fits (for comparisons of the two).
__host__ __device__ inline int mf_block(int nc, int nv, int nrow, int n_grid, int* bytes,
                                        int* staged) {
#ifdef MF_DEVICE_ROWS
  int layout = 0;
#else
  int layout = 1;
#endif
  int wpb = 0, per_world = 0;
  for (; layout >= 0 && wpb < 1; --layout) {
    per_world = (int)sizeof(float) * mf_layout(nc, nv, nrow, n_grid, layout == 1).total;
    wpb = kMfSmemBlockLimit / per_world;
    *staged = layout;
  }
  if (wpb > 32 / FS_LANES) wpb = 32 / FS_LANES;
  *bytes = wpb * per_world;
  return wpb;
}

// A row entry at p: a plain load from shared memory (staged), a read-only
// load from device memory otherwise.
template <bool kStaged>
__device__ __forceinline__ float mf_ld(const float* p) {
  if constexpr (kStaged) {
    return *p;
  } else {
    return __ldg(p);
  }
}

// The angular constants of an n_grid-point search, computed in double and
// rounded once, as the TPU kernel's Python-float constants are.
inline ConeConsts mf_cone_consts(int n_grid) {
  const double dth = 2.0 * M_PI / (double)n_grid;
  ConeConsts cc;
  cc.n_grid = n_grid;
  cc.dtheta = (float)dth;
  cc.span1 = (float)(0.5 * dth);
  cc.span2 = (float)(0.125 * dth);
  cc.h = (float)(dth / 16.0);
  return cc;
}

// Items a lane takes in a batch of the staging: their loads are issued
// together, so that each lane keeps that many in flight.
constexpr int kMfStageBatch = 8;

// One world. Jr, Wt (nc, 3, nv), vf (nv), bias (nc, 3), mu, act (nc) are the
// world's rows of the batch-first inputs; rows (2 nc + nrow ints) holds the
// row kinds, then each solver row's first slot among the used rows, then
// each used row's row in Jr and Wt (0 to 3 nc - 1); u (nv) and lam (nc, 3)
// are null where the world stores nothing (a world past the batch). smem is
// the world's slice of shared memory (mf_layout). kStaged: the used J and W
// rows are staged in shared memory once; otherwise they are read from Jr and
// Wt wherever the staged layout reads its copy, so that both layouts give the
// same bits.
template <bool kStaged>
__device__ __forceinline__ void mf_world(
    const float* __restrict__ Jr, const float* __restrict__ Wt,
    const float* __restrict__ vf, const float* __restrict__ bias,
    const float* __restrict__ mu, const float* __restrict__ act,
    const int* __restrict__ rows, float* __restrict__ u, float* __restrict__ lam,
    const int nc, const int nv, const int nrow, const int sweeps, const ConeConsts& cc,
    float* smem, const int fs_lane) {
  const MfLayout L = mf_layout(nc, nv, nrow, cc.n_grid, kStaged);
  float* const js = smem + L.js;
  float* const ws = smem + L.ws;
  float* const vfs = smem + L.vf;
  float* const z = smem + L.z;
  float* const lm = smem + L.lam;
  float* const gii = smem + L.gii;
  float* const ci0 = smem + L.c0;
  float* const mus = smem + L.mu;
  float* const acts = smem + L.act;
  const int* const kinds = rows;
  const int* const slot = rows + nc;
  const int* const src = rows + 2 * nc;
  // the first used J (or W) row of solver row i: a lin row's third; the
  // others follow nv floats apart; in shared memory (staged) or in the inputs
#define MF_J(i) (kStaged ? (const float*)js + (size_t)__ldg(slot + (i)) * nv \
                         : Jr + (size_t)__ldg(src + __ldg(slot + (i))) * nv)
#define MF_W(i) (kStaged ? (const float*)ws + (size_t)__ldg(slot + (i)) * nv \
                         : Wt + (size_t)__ldg(src + __ldg(slot + (i))) * nv)
#define MF_LD(p) mf_ld<kStaged>(p)

  // ---- the world's rows into shared memory, read once (staged layout); z
  // and lambda zeroed. Item t of the nrow x nv staged floats is entry k of
  // staged row p; lane l takes t = l (mod FS_LANES), kMfStageBatch items at a
  // time.
  FS_LANES_BEGIN
  int p = 0, k = l;
  while (k >= nv) {
    k -= nv;
    ++p;
  }
  for (int t0 = l; kStaged && t0 < nrow * nv; t0 += kMfStageBatch * FS_LANES) {
    size_t from[kMfStageBatch];
    float wv[kMfStageBatch], jv[kMfStageBatch];
#pragma unroll
    for (int b = 0; b < kMfStageBatch; ++b) {
      from[b] = t0 + b * FS_LANES < nrow * nv ? (size_t)__ldg(src + p) * nv + k : 0;
      wv[b] = __ldg(Wt + from[b]);
      jv[b] = __ldg(Jr + from[b]);
      k += FS_LANES;
      while (k >= nv) {
        k -= nv;
        ++p;
      }
    }
#pragma unroll
    for (int b = 0; b < kMfStageBatch; ++b) {
      const int t = t0 + b * FS_LANES;
      if (t < nrow * nv) {
        ws[t] = wv[b];
        js[t] = jv[b];
      }
    }
  }
  for (int k = l; k < nv; k += FS_LANES) {
    vfs[k] = __ldg(vf + k);
    z[k] = 0.0f;
  }
  for (int i = l; i < nc; i += FS_LANES) {
    mus[i] = __ldg(mu + i);
    acts[i] = __ldg(act + i);
  }
  for (int r = l; r < 3 * nc; r += FS_LANES) lm[r] = 0.0f;
  FS_LANES_END
  rsl::cone_grid_trig(cc, smem + L.trig, fs_lane);

  // ---- hoisted per-row invariants: Gii (6 entries) and c0 (3), one dot per item
  FS_LANES_BEGIN
  for (int t = l; t < 9 * nc; t += FS_LANES) {
    const int i = t / 9, e = t % 9;
    const int lin = __ldg(kinds + i) == kMfLin;
    const float* const J = MF_J(i);
    if (e < 6) {                      // entry (a, c) of the 3x3 block
      const int a = e < 3 ? 0 : (e < 5 ? 1 : 2);
      const int c = e < 3 ? e : (e < 5 ? e - 2 : 2);
      float acc = 0.0f;
      if (!lin || e == 5) {           // a lin row uses only 22, its rows' offsets 0
        const float* const Ja = lin ? J : J + a * nv;
        const float* const Wc = MF_W(i) + (lin ? 0 : c * nv);
#pragma unroll 8
        for (int k = 0; k < nv; ++k) acc += MF_LD(Ja + k) * MF_LD(Wc + k);
      }
      gii[6 * i + e] = acc;
    } else {
      const int a = e - 6;
      if (lin && a < 2) {
        ci0[3 * i + a] = 0.0f;
      } else {
        const float* const Ja = lin ? J : J + a * nv;
        float acc = 0.0f;
#pragma unroll 8
        for (int k = 0; k < nv; ++k) acc += MF_LD(Ja + k) * vfs[k];
        ci0[3 * i + a] = acc - __ldg(bias + 3 * i + a);
      }
    }
  }
  FS_LANES_END

  // ---- Gauss-Seidel sweeps
  for (int sw = 0; sw < sweeps; ++sw) {
    for (int i = 0; i < nc; ++i) {
      const int kind = __ldg(kinds + i);
      const float* const g = gii + 6 * i;
      const float* const J = MF_J(i);
      const float* const W = MF_W(i);
      const float ai = acts[i];
      if (kind == kMfLin) {
        const float li2 = lm[3 * i + 2];
        float jz = 0.0f;
#pragma unroll 8
        for (int k = 0; k < nv; ++k) jz += MF_LD(J + k) * z[k];
        const float g22 = g[5];
        const float c2 = ci0[3 * i + 2] + jz - g22 * li2;
        const float x = -c2 / (g22 + 1e-20f);
        const float ln2 = (x != x ? x : (x > 0.0f ? x : 0.0f)) * ai;
        const float d2 = ln2 - li2;
        FS_LANES_BEGIN
        for (int k = l; k < nv; k += FS_LANES) z[k] += MF_LD(W + k) * d2;
        if (l == 0) lm[3 * i + 2] = ln2;
        FS_LANES_END
        continue;
      }
      const float li0 = lm[3 * i], li1 = lm[3 * i + 1], li2 = lm[3 * i + 2];
      const float* const J1 = J + nv;
      const float* const J2 = J + 2 * nv;
      float jz0 = 0.0f, jz1 = 0.0f, jz2 = 0.0f;
#pragma unroll 8
      for (int k = 0; k < nv; ++k) {
        const float zk = z[k];
        jz0 += MF_LD(J + k) * zk;
        jz1 += MF_LD(J1 + k) * zk;
        jz2 += MF_LD(J2 + k) * zk;
      }
      float gr[6];                    // gii is shared: read it once, before the syncs
#pragma unroll
      for (int k = 0; k < 6; ++k) gr[k] = g[k];
      const float c0 = ci0[3 * i] + jz0 - (gr[0] * li0 + gr[1] * li1 + gr[2] * li2);
      const float c1 = ci0[3 * i + 1] + jz1 - (gr[1] * li0 + gr[3] * li1 + gr[4] * li2);
      const float c2 = ci0[3 * i + 2] + jz2 - (gr[2] * li0 + gr[4] * li1 + gr[5] * li2);
      float ln[3];
      if (kind == kMfBilateral) {
        rsl::stick_solve(gr, c0, c1, c2, ln);
      } else {
        rsl::cone_solve_lanes(gr, c0, c1, c2, mus[i], cc, smem + L.trig, fs_lane, ln);
      }
      const float la0 = ln[0] * ai, la1 = ln[1] * ai, la2 = ln[2] * ai;
      const float d0 = la0 - li0, d1 = la1 - li1, d2 = la2 - li2;
      FS_LANES_BEGIN
      for (int k = l; k < nv; k += FS_LANES) {
        float dz = MF_LD(W + k) * d0;
        dz = dz + MF_LD(W + nv + k) * d1;
        dz = dz + MF_LD(W + 2 * nv + k) * d2;
        z[k] += dz;
      }
      if (l == 0) {
        lm[3 * i] = la0;
        lm[3 * i + 1] = la1;
        lm[3 * i + 2] = la2;
      }
      FS_LANES_END
    }
  }
#undef MF_J
#undef MF_W
#undef MF_LD

  // ---- stores, each entry by one lane (the region is passed by every world
  // of the warp, a world that stores nothing included)
  FS_LANES_BEGIN
  if (u != nullptr) {
    for (int k = l; k < nv; k += FS_LANES) u[k] = vfs[k] + z[k];
    for (int r = l; r < 3 * nc; r += FS_LANES) lam[r] = lm[r];
  }
  FS_LANES_END
}

// World slot w (of wpb) of block blk: the world b = blk wpb + w, or, past the
// batch, world B - 1, computed alike and stored nowhere. The world's offsets
// into the inputs are size_t (B nc 3 nv passes 2^31 at large batches).
template <bool kStaged>
__device__ __forceinline__ void mf_slot(
    const float* __restrict__ Jr, const float* __restrict__ Wt,
    const float* __restrict__ vf, const float* __restrict__ bias,
    const float* __restrict__ mu, const float* __restrict__ act,
    const int* __restrict__ rows, float* __restrict__ u, float* __restrict__ lam,
    const int B, const int nc, const int nv, const int nrow, const int sweeps,
    const ConeConsts& cc, float* smem, const int blk, const int wpb, const int w,
    const int fs_lane) {
  const int b = blk * wpb + w;
  const size_t bc = (size_t)(b < B ? b : B - 1);
  const bool store = b < B;
  const size_t nr = (size_t)3 * nc * nv;
  const MfLayout L = mf_layout(nc, nv, nrow, cc.n_grid, kStaged);
  mf_world<kStaged>(Jr + bc * nr, Wt + bc * nr, vf + bc * nv, bias + bc * 3 * nc, mu + bc * nc,
           act + bc * nc, rows, store ? u + bc * nv : nullptr,
           store ? lam + bc * 3 * nc : nullptr, nc, nv, nrow, sweeps, cc,
           smem + (size_t)w * L.total, fs_lane);
}

}  // namespace rsl
