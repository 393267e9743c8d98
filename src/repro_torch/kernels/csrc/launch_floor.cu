// A kernel that does nothing, for measurement only: chip_smoke.py times
// it on a kernel's own grid (blocks, threads, dynamic shared bytes) to
// show how much of a small launch's time is the launch itself, which no
// kernel design can remove.  No path of the port launches it.

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

extern "C" int launch_floor(int blocks, int threads, int smem,
                            void* stream) {
  if (blocks < 1 || threads < 1) return 0;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        empty_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  empty_kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
