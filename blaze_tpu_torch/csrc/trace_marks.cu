// Stage marks: one one-thread kernel per stage of the MSM, launched on the
// caller's stream between the stage before it and the stage it opens.
//
// The port's own instrument, not the counterpart of a pallas_call.  An MSM
// chunk is one CUDA graph replay (msm/pippenger.py MSM._chunk), so a host
// span inside the chunk is recorded once, at capture, and every device
// operation of a replay correlates to the one cudaGraphLaunch.  A mark is an
// ordinary launch: the capture records it and every replay runs it, so the
// stage's name (in the kernel's name, mark_<stage>_kernel) sits in the
// device trace between the stage's operations and the stage before.
//
// Each mark also reads %globaltimer and adds the time since the previous
// mark to the stage that mark opened, in a small device array (`clock`,
// owned by the caller; a graph keeps its pointer):
//   clock[0]      the previous mark's %globaltimer (ns)
//   clock[1]      the stage it opened + 1 (0: none: after msm_done)
//   clock[2 + s]  the ns stage s has taken, summed
//   clock[2 + kStages]  the msm_done marks (the calls measured)
// A null clock times nothing.  Bound: the launch (~2 us of one thread on the
// stream); the marks of one caller run in stream order, so the read-modify-
// write of the clock needs no atomics.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kStages = 5;   // msm_sort, msm_layout, msm_scan, msm_bucket, msm_stream
constexpr int kDone = kStages;

__device__ __forceinline__ void mark_body(unsigned long long* clock, int stage) {
  if (clock == nullptr) return;
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  const unsigned long long open = clock[1];
  if (open > 0) clock[1 + open] += now - clock[0];
  clock[0] = now;
  if (stage == kDone) {
    clock[1] = 0;
    clock[2 + kStages] += 1;
  } else {
    clock[1] = stage + 1;
  }
}

}  // namespace

#define BLZ_MARK(name, stage) \
  __global__ void mark_##name##_kernel(unsigned long long* clock) { mark_body(clock, stage); }

BLZ_MARK(msm_sort, 0)
BLZ_MARK(msm_layout, 1)
BLZ_MARK(msm_scan, 2)
BLZ_MARK(msm_bucket, 3)
BLZ_MARK(msm_stream, 4)
BLZ_MARK(msm_done, kDone)

// Launch the mark of stage `stage` (0-4 the stages in the order above, 5
// msm_done) on `stream`, timing into `clock` (may be null).  Returns
// cudaGetLastError() (0 = ok).
extern "C" int blz_mark(int stage, void* clock, void* stream) {
  auto* c = (unsigned long long*)clock;
  auto s = (cudaStream_t)stream;
  switch (stage) {
    case 0: mark_msm_sort_kernel<<<1, 1, 0, s>>>(c); break;
    case 1: mark_msm_layout_kernel<<<1, 1, 0, s>>>(c); break;
    case 2: mark_msm_scan_kernel<<<1, 1, 0, s>>>(c); break;
    case 3: mark_msm_bucket_kernel<<<1, 1, 0, s>>>(c); break;
    case 4: mark_msm_stream_kernel<<<1, 1, 0, s>>>(c); break;
    case kDone: mark_msm_done_kernel<<<1, 1, 0, s>>>(c); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The clock's length in 64-bit words.
extern "C" int blz_mark_clock_words() { return 3 + kStages; }
