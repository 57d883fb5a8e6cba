// Stage stamps on the card (utils/trace.py): one thread writes the card's
// nanosecond clock (%globaltimer) into a region's ring at a stage boundary.
//
// A region (the train step, a frame, a densify step, the 3D filter, the KNN
// refresh) owns a ring of `rows` rows, one per call, and a call counter, both
// int64 on the card. A row holds one accumulator per stage (the stage's
// device nanoseconds in this call) and META columns (utils/trace.py `META`):
//   BEGIN   the call's first stamp        LAST    the latest stamp
//   CUR     the stage the card is in      REPLAYED 1 for a stamp captured in
//   CALL    the call's number                      a CUDA graph, 0 eager
//   DONE    CALL once the call has ended  STAMPS  stamps of the call
// The counter picks the row (call % rows) and the call's last stamp advances
// it, so a replayed graph fills the next row by itself, with no host work.
// Each stamp adds the time since the last one to the stage the card was in,
// so a call's stages sum to LAST - BEGIN exactly, a stage entered twice (a
// batch's cameras) summed. The stamps of a call run in order on one stream;
// nothing else writes the ring.
//
// Bound: latency. One thread, a few loads and stores (~2 us of the card a
// stamp in a graph). It reads and writes no tensor of the program.
//
// `trace_clock` writes the clock alone, for the host's calibration of the
// two clocks; it counts nothing, so `trace.stamp`'s slot counts the stamps.

#include <cuda_runtime.h>

#include "launch_count.cuh"

namespace {

enum Meta { BEGIN = 0, LAST = 1, CUR = 2, REPLAYED = 3, CALL = 4, DONE = 5, STAMPS = 6, META = 7 };
enum Op { OP_BEGIN = 0, OP_ENTER = 1, OP_END = 2 };

__device__ __forceinline__ long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return (long long)t;
}

__global__ void trace_stamp(long long* ring, long long* calls, int rows, int stages, int stage,
                            int op, int replayed) {
  count_launch(SLOT_TRACE_STAMP);
  const long long now = global_ns();
  const long long call = calls[0];
  long long* acc = ring + (call % rows) * (long long)(stages + META);
  long long* meta = acc + stages;
  if (op == OP_BEGIN) {
    for (int i = 0; i < stages; ++i) acc[i] = 0;
    meta[BEGIN] = now;
    meta[REPLAYED] = replayed;
    meta[CALL] = call;
    meta[DONE] = -1;
    meta[STAMPS] = 1;
  } else {
    acc[meta[CUR]] += now - meta[LAST];
    meta[STAMPS] += 1;
    if (op == OP_END) {
      meta[DONE] = call;
      calls[0] = call + 1;
    }
  }
  meta[CUR] = stage;
  meta[LAST] = now;
}

__global__ void trace_clock(long long* out) {
  out[0] = global_ns();
}

}  // namespace

extern "C" int ed3dgs_trace_stamp(long long* ring, long long* calls, int rows, int stages,
                                  int stage, int op, int replayed, void* stream) {
  trace_stamp<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(ring, calls, rows, stages, stage,
                                                              op, replayed);
  return (int)cudaGetLastError();
}

extern "C" int ed3dgs_trace_clock(long long* out, void* stream) {
  trace_clock<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(out);
  return (int)cudaGetLastError();
}
