// Launch counters on the card: every kernel of the port adds one to its
// wrapper's slot when it runs, from the first thread of its first CTA, so that
// the launches of a replayed CUDA graph (which calls no wrapper) are counted
// where they happen. ops/cuda_lib.py `DeviceLaunches` reads the slots; the
// slots' order is cuda_lib.LAUNCH_SLOTS. Each library holds the counters'
// address in a device global of its own, set per device by
// ed3dgs_set_launch_counters; while it is null (a library no wrapper has armed,
// such as a variant built by a script) nothing is counted.
//
// Every source includes this header once (one translation unit a library).

#pragma once

#include <cuda_runtime.h>

enum LaunchSlot {
  SLOT_FORWARD_BLEND = 0,     // K1  rasterize_cuda.rasterize_forward
  SLOT_BACKWARD_BLEND = 1,    // K2  rasterize_cuda.rasterize_backward
  SLOT_SEGMENT_SUM = 2,       // K3  segment_sum.segment_sum_rows (the gathered instance)
  SLOT_SEGMENT_SUM_ROWS = 3,  // K8  segment_sum.segment_sum_rows_packed (the plain instance)
  SLOT_BIN_SCANS = 4,         // K4  binning_scan.fused_bin_scans
  SLOT_UNPACK = 5,            // K5a relayout.unpack_image
  SLOT_PACK = 6,              // K5b relayout.pack_image
  SLOT_KNN_ROWS = 7,          // K6  knn_loss.knn_rows
  SLOT_KNN_REVERSE = 8,       // K7  knn_loss.knn_reverse
  SLOT_KNN = 9,               // X1  knn.knn
  SLOT_TRACE_STAMP = 10,      // T1  trace.stamp
  SLOT_BOUNDARY_DELTAS = 11,  // X2  binning_scan.boundary_deltas
};

static __device__ unsigned long long* g_launch_counters = nullptr;

__device__ __forceinline__ void count_launch(int slot) {
  if (threadIdx.x == 0 && threadIdx.y == 0 && threadIdx.z == 0 && blockIdx.x == 0 &&
      blockIdx.y == 0 && blockIdx.z == 0) {
    unsigned long long* counters = g_launch_counters;
    if (counters != nullptr) atomicAdd(counters + slot, 1ull);
  }
}

// Point this library's kernels at `counters` (LAUNCH_SLOTS uint64 on the
// current device); called once per device before the library's first launch.
extern "C" int ed3dgs_set_launch_counters(unsigned long long* counters) {
  return (int)cudaMemcpyToSymbol(g_launch_counters, &counters, sizeof(counters));
}
