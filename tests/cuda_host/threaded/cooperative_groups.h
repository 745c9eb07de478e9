// Host stand-in for cooperative_groups (see cuda_runtime.h): grid.sync()
// is a barrier of every thread of the cooperative launch.
#pragma once

#include "cuda_runtime.h"

namespace cooperative_groups {
struct grid_group {
  void sync() { emu_grid_bar->arrive_and_wait(); }
};
inline grid_group this_grid() { return grid_group{}; }
}  // namespace cooperative_groups
