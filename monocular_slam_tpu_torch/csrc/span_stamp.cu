// The device's clock at a point of a stream, for the session's tracer, with a
// plain C interface (`ops/span_stamp.py`).
//
// One thread reads %globaltimer (nanoseconds, the clock the profiler's device
// timestamps come from) and writes it into slot k of an int64 buffer, then
// zeroes the `n_clear` slots after it. Launched on the stream of a program,
// or captured into its CUDA graph, it runs once every operation before it on
// that stream has finished, so the difference of two slots is the device
// time of the operations between the two launches. A slot that a replay did
// not reach holds 0 when the first launch cleared it.

#include <cuda_runtime.h>

extern "C" __global__ void span_stamp(long long* buf, int k, int n_clear) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  buf[k] = static_cast<long long>(t);
  for (int c = 1; c <= n_clear; ++c) buf[k + c] = 0;
}

// Launches one `span_stamp` on `stream` and returns cudaGetLastError() (0 on
// success). `buf` is an int64 device buffer of at least k + n_clear + 1
// slots; k >= 0, n_clear >= 0.
extern "C" int launch_span_stamp(void* buf, int k, int n_clear, void* stream) {
  if (k < 0 || n_clear < 0) return static_cast<int>(cudaErrorInvalidValue);
  span_stamp<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<long long*>(buf), k,
                                                             n_clear);
  return static_cast<int>(cudaGetLastError());
}
