// Frame of the fused full physics step (K1), one world per thread.
//
// Replaces the TPU kernel raisimlib_tpu/ops/pallas_step.py `_step_kernel`
// (pallas_call in `build_fused_step_lane`) for its scene classes K1a (plane
// contacts), K1b (a sphere against a sphere, a box or a capsule, on a body
// or static: `ss`, `sb`, `sc` slots, whose narrow phase reads only q) and
// K1c's `hm_pt` slots (points and spheres against a heightmap). The body
// `fs_body` is generated per scene by
// raisimlib_torch/ops/gpu_step.py (`kernel_source`), which defines FS_NQ,
// FS_NV, FS_USE_PD and FS_HAS_HM and then includes this file. The body runs
// the whole step of one world: PD, FK, RNEA, CRBA, Cholesky, contact and
// limit rows (on a heightmap: the narrow phase of each contact point, riser
// march included), the triangular solves for W = J M^-1 and v_free (a loop
// over the right-hand columns of a per-thread array), the Gauss-Seidel
// sweeps (a loop, with the cone solve of cone_solve.cuh inlined per contact)
// and the integration.
//
// What bounds it on an H100: operations. At the ANYmal shapes a world reads
// 0.29 KB and writes 0.15 KB, and runs about 3.6e5 float operations (most of
// them in the cone solves of the 12 sweeps). A TPU lane becomes a thread; the
// TPU kernel's one-hot reads and writes of its scratch become direct indexing,
// and no lane padding is needed: threads past B return.
//
// Layout: batch-major, as the public State is: q, qo (B, FS_NQ); u, tau, pd,
// uo (B, FS_NV). Each thread reads and writes its own rows; next to the work
// per world the strided rows cost little, and the wrapper needs no transposes.
//
// Heightmap: hts holds world b's heights (nx, ny) at hts + b * hts_stride; a
// stride of 0 lets every world read one shared field without a copy. A thread
// loads (__ldg) the 4 heights of each cell its probes land in, about 300 per
// ANYmal world; the TPU kernel's per-world patch, cut by its wrapper because
// a TPU kernel has no vector gather, is not needed. 64 terrains of 4.6 KB
// each stay in the L2 cache.
//
// Block size: 32 threads, one warp. A world per thread is a lot of serial
// work, so the kernel wants as many SMs busy as the batch allows: at the MPPI
// batch (B = 2048) 32-thread blocks reach 64 of the 132 SMs, 128-thread blocks
// only 16. At B = 16384 registers, not the block size, cap the warps per SM.

#pragma once

#include <cuda_runtime.h>

#ifndef FS_BLOCK
#define FS_BLOCK 32
#endif

namespace {

__global__ void __launch_bounds__(FS_BLOCK)
fused_step_kernel(const float* __restrict__ q, const float* __restrict__ u,
                  const float* __restrict__ tau, const float* __restrict__ pd,
                  const float* __restrict__ hts, long long hts_stride,
                  float* __restrict__ qo, float* __restrict__ uo, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t rq = (size_t)b * FS_NQ;
  const size_t rv = (size_t)b * FS_NV;
  fs_body(q + rq, u + rv, tau + rv, FS_USE_PD ? pd + rv : nullptr,
          FS_HAS_HM ? hts + (size_t)b * hts_stride : nullptr, qo + rq, uo + rv);
}

}  // namespace

// Plain C entry point for ctypes. Launches on `stream` and returns
// cudaGetLastError() (0 = launched), so that a refused launch is reported
// instead of silently skipped.
extern "C" int fused_step_launch(const void* q, const void* u, const void* tau,
                                 const void* pd, const void* hts, long long hts_stride,
                                 void* qo, void* uo, int B, void* stream) {
  if (B < 1 || (FS_USE_PD && pd == nullptr) || (FS_HAS_HM && hts == nullptr))
    return (int)cudaErrorInvalidValue;
  const int blocks = (B + FS_BLOCK - 1) / FS_BLOCK;
  fused_step_kernel<<<blocks, FS_BLOCK, 0, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)u, (const float*)tau, (const float*)pd,
      (const float*)hts, hts_stride, (float*)qo, (float*)uo, B);
  return (int)cudaGetLastError();
}
