// Matrix-free Gauss-Seidel contact-dynamics solve (K2): MF_LANES lanes of a
// warp per world, the world's rows staged once in shared memory.
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
// (G lam)_i = J_i z), and returns u_new = vf + z and lam. The world's body is
// mf_solve.cuh (`mf_world`); this file is its frame and the C entry point.
//
// What bounds it on an H100: operations (ops/gpu_contact.py
// `mf_solve_cost`). At the ANYmal shapes (nc = 24: 12 cone + 12 lin rows, nv =
// 18) a world reads 10.9 KB and writes 0.36 KB, and does about 3.1e5
// operations, most of them in the 32-point angular grids of the cone rows (12
// sweeps x 12 cone rows): at B = 16384 0.076 ms of operations against 0.055
// ms of bytes. What holds a world back is the latency of its serial chain of
// cone solves. The TPU design carried over (one world per thread, 128-thread
// blocks) left that chain on one thread, the per-world arrays in local
// memory, the J and W rows re-read from device memory every sweep, and a
// small batch on a few SMs (B = 2048 made 16 blocks). So here:
//   - MF_LANES lanes of a warp share a world (16, _build.MF_LANES),
//     in one-warp blocks of 32 / MF_LANES worlds; the lanes split the grid of
//     each cone solve, the hoisted dots and the W updates (mf_solve.cuh);
//   - the warp stages each world's used J and W rows into shared memory once
//     (neighbouring lanes on neighbouring floats, 8 items in flight a lane),
//     and keeps z, lambda, Gii, c0, the energies and the grid's
//     sines and cosines there too (J left in device memory, with more
//     worlds an SM, was 4% faster at B = 16384 and 27% slower at 2048);
//   - the inputs and outputs are the batch-first tensors of
//     pipeline.solver_inputs, read and written without a layout copy.
// Shared memory is dynamic, sized at launch from nc, nv, the rows the kinds
// use and n_grid (mf_layout); where a block's worlds would need more than the
// 227 KB a block can hold, the launch gives the block fewer worlds, a partial
// warp of wpb x MF_LANES threads (mf_block), and refuses a shape of which one
// world does not fit.
//
// Lane regions: FS_LANES_BEGIN ... FS_LANES_END sync the block's threads
// (one warp, or its first wpb x MF_LANES lanes) on both sides. Every world of
// a block passes the same regions in the same order (the kinds are the same
// for every world), so a world past B computes on world B - 1 and stores
// nothing.
//
// Measured with tools/mf_sweep.py on an NVIDIA H100 80GB HBM3 at 700 W,
// kernel alone: 0.398 ms at B = 384, 0.433 at 2048 and 2.712 at 16384, 222,
// 46 and 36 times the bound (the one-thread design: 1.73, 1.72 and 2.76 ms).
// Of one world's cycles at B = 2048, 59% are the cone solves, 24% the cone
// rows' dots and W updates, 13% the lin rows and 4% the staging and the
// hoisted dots (--clocks). Up to about 3,200 worlds every world is resident
// at once and the time is one world's chain; at B = 16384 shared memory
// holds 24 worlds an SM, so the batch runs in about 5 waves (PERF.md).

#include <cuda_runtime.h>
#include <math.h>

#ifndef MF_LANES
#define MF_LANES 16
#endif

// the threads of a block: one warp, or its first blockDim.x lanes
__device__ __forceinline__ unsigned mf_block_mask() {
  return blockDim.x >= 32 ? 0xffffffffu : (1u << blockDim.x) - 1u;
}

#define FS_LANES MF_LANES
#define FS_LANES_BEGIN __syncwarp(mf_block_mask()); { const int l = fs_lane;
#define FS_LANES_END } __syncwarp(mf_block_mask());

#include "mf_solve.cuh"

static_assert(32 % MF_LANES == 0, "a world's lanes lie in one warp");

namespace {

__global__ void __launch_bounds__(32)
mf_solve_kernel(const float* __restrict__ Jr, const float* __restrict__ Wt,
                const float* __restrict__ vf, const float* __restrict__ bias,
                const float* __restrict__ mu, const float* __restrict__ act,
                const int* __restrict__ rows, float* __restrict__ u,
                float* __restrict__ lam, int B, int nc, int nv, int nrow, int sweeps,
                rsl::ConeConsts cc, int wpb) {
  extern __shared__ float mf_smem[];
  rsl::mf_slot(Jr, Wt, vf, bias, mu, act, rows, u, lam, B, nc, nv, nrow, sweeps, cc, mf_smem,
               blockIdx.x, wpb, threadIdx.x / MF_LANES, threadIdx.x % MF_LANES);
}

}  // namespace

// Worlds per block at these shapes (0 where one world does not fit) and, in
// *bytes, the block's shared memory: what mf_solve_launch launches.
extern "C" int mf_solve_block(int nc, int nv, int nrow, int n_grid, int* bytes) {
  return rsl::mf_block(nc, nv, nrow, n_grid, bytes);
}

// Plain C entry point for ctypes. `rows` is the int table of mf_world (the
// kinds, each solver row's first staged row, and the input row of each of
// the nrow staged rows). Launches ceil(B / wpb) blocks of wpb x MF_LANES
// threads (wpb from mf_block) on `stream` and returns cudaGetLastError() (0 =
// launched), so that a refused launch is reported instead of silently
// skipped; cudaErrorInvalidValue where one world's shared arrays do not fit a
// block.
extern "C" int mf_solve_launch(const void* Jr, const void* Wt, const void* vf,
                               const void* bias, const void* mu, const void* act,
                               const void* rows, void* u, void* lam, int B, int nc,
                               int nv, int nrow, int sweeps, int n_grid, void* stream) {
  if (B < 1 || nc < 1 || nv < 1 || nrow < nc || nrow > 3 * nc || sweeps < 0 || n_grid < 1) {
    return (int)cudaErrorInvalidValue;
  }
  int smem = 0;
  const int wpb = rsl::mf_block(nc, nv, nrow, n_grid, &smem);
  if (wpb < 1) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        mf_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (B + wpb - 1) / wpb;
  mf_solve_kernel<<<blocks, wpb * MF_LANES, smem, (cudaStream_t)stream>>>(
      (const float*)Jr, (const float*)Wt, (const float*)vf, (const float*)bias,
      (const float*)mu, (const float*)act, (const int*)rows, (float*)u, (float*)lam, B, nc,
      nv, nrow, sweeps, rsl::mf_cone_consts(n_grid), wpb);
  return (int)cudaGetLastError();
}
