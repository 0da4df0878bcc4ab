// The frame record's two writes (utils/profiling.FrameRecord), CUDA C++ for
// Hopper (sm_90a).
//
// The record is an int64 ring of R rows, one a frame, row frame_index % R:
//   [0]                  the frame index
//   [1 .. passes + 1]    a device timestamp before the first pass and after
//                        each pass (%globaltimer, ns)
//   [passes + 2 ..]      the frame's counters
// A captured frame replays these launches with the frame-index tensor it
// takes as an input, so the row is chosen on the device and nothing is read
// back. Each launch is one thread; the stream orders it after the pass
// before it, so a timestamp is taken when that pass's last kernel is done.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ long long* frame_row(long long* ring, const int* frame_index,
                                                int rows, int width) {
  long long r = static_cast<long long>(*frame_index) % rows;
  if (r < 0) r += rows;
  return ring + r * width;
}

// The timestamp into column ``slot``. ``start`` (the frame's first write)
// also writes the frame index and zeroes the counters from ``counters_from``.
__global__ void frame_stamp_kernel(long long* ring, const int* frame_index, int rows,
                                   int width, int slot, int start, int counters_from) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  long long* row = frame_row(ring, frame_index, rows, width);
  if (start) {
    row[0] = *frame_index;
    for (int k = counters_from; k < width; ++k) row[k] = 0;
  }
  row[slot] = static_cast<long long>(t);
}

// Adds the 0-d value (int32, or int64 when ``is64``) to column ``slot``.
__global__ void frame_count_kernel(long long* ring, const int* frame_index, int rows,
                                   int width, int slot, const void* value, int is64) {
  long long v = is64 ? *static_cast<const long long*>(value)
                     : static_cast<long long>(*static_cast<const int*>(value));
  frame_row(ring, frame_index, rows, width)[slot] += v;
}

}  // namespace

extern "C" int frame_stamp_launch(long long* ring, const int* frame_index, int rows,
                                  int width, int slot, int start, int counters_from,
                                  void* stream) {
  if (rows <= 0 || slot <= 0 || slot >= width) return (int)cudaErrorInvalidValue;
  frame_stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      ring, frame_index, rows, width, slot, start, counters_from);
  return (int)cudaGetLastError();
}

extern "C" int frame_count_launch(long long* ring, const int* frame_index, int rows,
                                  int width, int slot, const void* value, int is64,
                                  void* stream) {
  if (rows <= 0 || slot <= 0 || slot >= width) return (int)cudaErrorInvalidValue;
  frame_count_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      ring, frame_index, rows, width, slot, value, is64);
  return (int)cudaGetLastError();
}
