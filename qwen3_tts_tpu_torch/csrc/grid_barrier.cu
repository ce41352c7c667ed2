// The cost of one grid-wide barrier of the persistent megakernels K1 and K2
// (w8a8.cuh: cooperative_groups' grid.sync() over one block of PK_NT
// threads per SM): a cooperative launch that runs n barriers and nothing
// else. A measurement entry point (ops/cuda/persistent.py::grid_barriers);
// no model path calls it.

#include "w8a8.cuh"

namespace {

__global__ void __launch_bounds__(PK_NT, 1) qt_grid_barrier_kernel(int n) {
  for (int i = 0; i < n; ++i) qt_grid_sync();
}

}  // namespace

extern "C" int qt_grid_barrier_grid(int smem, int* blocks) {
  return qt_persistent_grid(qt_grid_barrier_kernel, smem, blocks);
}

extern "C" int qt_grid_barriers(int n, int grid, int smem, void* stream) {
  QtPlan plan{};
  plan.grid = grid;
  plan.smem = smem;
  return qt_persistent_launch(qt_grid_barrier_kernel, &n, plan, stream);
}
