// Span stamps of the train step (basd_tpu_torch/utils/spans.py).
//
// `basd_span_stamp` is one thread. When the recorder's flag (an int32 on
// the card) is set it reads the device's nanosecond clock (%globaltimer)
// and writes it into ring[slot % steps][boundary], a row of `width` int64
// boundaries per step; the step's closing stamp then advances `slot`, a
// device counter. With the flag clear it returns at once. So a CUDA graph
// can hold the stamps whatever the flag, and turning spans on or off is a
// write of the flag between steps, with no recapture.
//
// Stamps on one stream run in stream order: a stamp's clock reading falls
// after every kernel launched before it on that stream has finished and
// before any kernel launched after it starts, so the interval between two
// stamps holds the device work of the span they bound, and its gaps.

#include <cuda_runtime.h>

extern "C" __global__ void basd_span_stamp(const int* flag, long long* ring,
                                           unsigned long long* slot, int boundary,
                                           int width, int steps, int closing) {
  if (*flag == 0) return;
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  const unsigned long long s = *slot;
  ring[(s % (unsigned long long)steps) * width + boundary] = (long long)now;
  if (closing) *slot = s + 1;
}

// flag, ring, slot, boundary, width, steps, closing, stream
extern "C" int basd_span_stamp_launch(const void* flag, void* ring, void* slot,
                                      int boundary, int width, int steps, int closing,
                                      void* stream) {
  if (boundary < 0 || boundary >= width || steps < 1) return (int)cudaErrorInvalidValue;
  basd_span_stamp<<<1, 1, 0, (cudaStream_t)stream>>>(
      (const int*)flag, (long long*)ring, (unsigned long long*)slot, boundary, width,
      steps, closing);
  return (int)cudaGetLastError();
}
