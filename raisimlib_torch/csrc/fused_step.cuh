// Frame of the fused full physics step (K1): FS_LANES lanes per world.
//
// Replaces the TPU kernel raisimlib_tpu/ops/pallas_step.py `_step_kernel`
// (pallas_call in `build_fused_step_lane`) for all its scene classes: K1a
// (plane contacts, `plane_pt`), K1b (a sphere against a sphere, a box or a
// capsule, on a body or static: `ss`, `sb`, `sc`) and K1c (a heightmap:
// points and spheres, `hm_pt`; a cylinder's or a cone's rim and apex probes in
// its runtime downhill frame, `hm_cylpt`, `hm_conept`; the 4 deepest vertex
// probes of a convex mesh, `hm_mesh`). The body `fs_body` is generated per
// scene by raisimlib_torch/ops/gpu_step.py (`kernel_source`), which defines
// FS_NQ, FS_NV, FS_USE_PD, FS_HAS_HM, FS_LANES, FS_SMEM_WORLD and the lane
// regions, then includes this file. The body runs the whole step of one
// world: PD, FK, RNEA, CRBA, Cholesky, contact and limit rows (with each
// slot's narrow phase), the triangular solves for W = J M^-1 and v_free, the
// Gauss-Seidel sweeps (with cone_solve.cuh's lane-split cone solve) and the
// integration.
//
// What bounds it on an H100: operations, and then the latency of one world's
// chain of them. At the ANYmal shapes a world reads 0.29 KB and writes 0.15
// KB, and runs about 3.4e5 float operations, 87% of them in the sweeps. On the
// TPU a lane ran one world; a thread per world leaves that whole chain on one
// thread, with the W rows in local memory, and a small batch on a few SMs. So
// here FS_LANES lanes (8) of a warp share one world. They run the serial parts
// alike, each in its own registers, and split the parts that are parallel
// within a world in lane regions: phase F's right-hand columns, the 32 points
// of each cone solve's angular grid (and the 5 of each refinement), and the
// nv entries of z in each W update. The world's slice of shared memory,
// FS_SMEM_WORLD floats, holds the W rows with the v_free column, z and the
// cone solve's energies, which the lanes share, and also J, the cones' Gii
// blocks and the grid's sines and cosines, which would otherwise sit in
// registers through the sweeps (gpu_step._smem_layout).
//
// Lane regions: FS_LANES_BEGIN ... FS_LANES_END. Each starts and ends with
// __syncwarp(), so that the region's shared writes come after every lane's
// earlier reads and before its later ones; serial code writes no shared
// memory. Every world of a warp passes the same regions in the same order
// (their number is static), so no lane may leave early: a world past B
// computes on world B - 1's inputs and stores nothing. Only lane 0 of a world
// stores (fs_body gets null qo, uo in the others). No pointer to shared
// memory is __restrict__: other lanes write through it, and restrict would let
// the compiler move its loads across the syncs.
//
// Layout: batch-major, as the public State is: q, qo (B, FS_NQ); u, tau, pd,
// uo (B, FS_NV). The lanes of a world read the same rows (one broadcast).
//
// Heightmap: hts holds world b's heights (nx, ny) at hts + b * hts_stride; a
// stride of 0 lets every world read one shared field without a copy. The
// probes load (__ldg) the 4 heights of each cell they land in.
//
// Block size: 32 threads, one warp, FS_BLOCK / FS_LANES worlds. Small blocks
// spread a small batch over many SMs: the trot MPPI's B = 384 makes 96 blocks.
// At a large batch an SM runs as many warps as registers and shared memory
// let it; FS_MIN_BLOCKS (gpu_step.min_blocks) caps the registers where
// shared memory would hold 16 blocks. The block's shared arrays are static up
// to 48 KB and dynamic above that (cudaFuncSetAttribute); gpu_step.smem_bytes
// refuses a scene whose block would need more than the 227 KB an SM gives
// one block.

#pragma once

#include <cuda_runtime.h>

#define FS_BLOCK 32
#define FS_WPB (FS_BLOCK / FS_LANES)
#define FS_SMEM_BLOCK (FS_WPB * FS_SMEM_WORLD)
#define FS_SMEM_DYNAMIC (FS_SMEM_BLOCK * 4 > 48 * 1024)

static_assert(FS_BLOCK == 32 && FS_BLOCK % FS_LANES == 0,
              "a block is one warp, whose lane regions sync with __syncwarp()");

namespace {

__global__ void __launch_bounds__(FS_BLOCK, FS_MIN_BLOCKS)
fused_step_kernel(const float* __restrict__ q, const float* __restrict__ u,
                  const float* __restrict__ tau, const float* __restrict__ pd,
                  const float* __restrict__ hts, long long hts_stride,
                  float* __restrict__ qo, float* __restrict__ uo, int B) {
#if FS_SMEM_DYNAMIC
  extern __shared__ float fs_smem[];
#else
  __shared__ float fs_smem[FS_SMEM_BLOCK];
#endif
  const int w = threadIdx.x / FS_LANES;                  // the block's world
  const int lane = threadIdx.x % FS_LANES;
  const int b = blockIdx.x * FS_WPB + w;
  const int bc = b < B ? b : B - 1;
  const bool store = b < B && lane == 0;
  const size_t rq = (size_t)bc * FS_NQ;
  const size_t rv = (size_t)bc * FS_NV;
  fs_body(q + rq, u + rv, tau + rv, FS_USE_PD ? pd + rv : nullptr,
          FS_HAS_HM ? hts + (size_t)bc * hts_stride : nullptr,
          store ? qo + rq : nullptr, store ? uo + rv : nullptr,
          fs_smem + w * FS_SMEM_WORLD, lane);
}

}  // namespace

// Plain C entry point for ctypes. Launches ceil(B / FS_WPB) blocks on
// `stream` and returns cudaGetLastError() (0 = launched), so that a refused
// launch is reported instead of silently skipped.
extern "C" int fused_step_launch(const void* q, const void* u, const void* tau,
                                 const void* pd, const void* hts, long long hts_stride,
                                 void* qo, void* uo, int B, void* stream) {
  if (B < 1 || (FS_USE_PD && pd == nullptr) || (FS_HAS_HM && hts == nullptr))
    return (int)cudaErrorInvalidValue;
  const int blocks = (B + FS_WPB - 1) / FS_WPB;
  const size_t dyn = FS_SMEM_DYNAMIC ? sizeof(float) * FS_SMEM_BLOCK : 0;
  if (dyn) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
    if (e != cudaSuccess) return (int)e;
  }
  fused_step_kernel<<<blocks, FS_BLOCK, dyn, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)u, (const float*)tau, (const float*)pd,
      (const float*)hts, hts_stride, (float*)qo, (float*)uo, B);
  return (int)cudaGetLastError();
}
