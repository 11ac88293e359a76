// Device stamps of the program's spans (profiling.py): a one-thread
// kernel that reads the device's global nanosecond timer and appends one
// record (site code, replay ordinal, ns) to a ring in device memory.
//
// Replaces no TPU kernel: the JAX package's spans are host annotations
// around jitted calls. Here a span inside a captured CUDA graph has no host
// side at replay, and the kernels of a conditional node's body never reach
// torch.profiler's device timeline; a stamp captured as a node of the graph
// (or of a WHILE or IF body) runs at every replay where its node runs, so
// each replay, each LM iteration and each taken branch leaves its records.
// Bound by launch latency: one thread, 16 bytes written.
//
// The ring is [1 + capacity] records; slot 0 is the header: the head (the
// records appended so far, counted past the capacity, so a full ring drops
// records and counts them), the next replay ordinal, and the current one.
// A stamp with `fresh` set (a graph's first node, or an eager span with no
// span around it) takes a new ordinal; the others record the current one.
// The stamps of one process run in stream order, one at a time.

#include <cuda_runtime.h>
#include <time.h>

namespace {

struct Record {
  int code;      // site * 2 + (1 at a span's end)
  int ordinal;   // the replay (or eager root span) the record belongs to
  unsigned long long ns;
};

struct Header {
  unsigned long long head;
  unsigned int ordinal;
  unsigned int current;
};

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long ns;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
  return ns;
}

__global__ void span_stamp_kernel(Record* ring, unsigned long long capacity, int code,
                                  int fresh) {
  const unsigned long long ns = global_ns();
  Header* h = reinterpret_cast<Header*>(ring);
  unsigned int ordinal;
  if (fresh) {
    ordinal = atomicAdd(&h->ordinal, 1u);
    h->current = ordinal;
  } else {
    ordinal = h->current;
  }
  const unsigned long long i = atomicAdd(&h->head, 1ull);
  if (i < capacity) {
    Record r;
    r.code = code;
    r.ordinal = (int)ordinal;
    r.ns = ns;
    ring[1 + i] = r;
  }
}

__global__ void global_ns_kernel(unsigned long long* out) { *out = global_ns(); }

}  // namespace

// Append a stamp on `stream` (a launch, or a node where the stream
// captures). Returns a cudaError_t.
extern "C" int span_stamp(void* stream, void* ring, long long capacity, int code, int fresh) {
  span_stamp_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (Record*)ring, (unsigned long long)capacity, code, fresh);
  return (int)cudaGetLastError();
}

// One bracket of the clock calibration: the host's CLOCK_REALTIME (the
// clock of torch.profiler's events and of time.time_ns) read before a
// launch of the timer kernel on `stream` and after the stream synchronizes;
// the device's ns go to `out` (device memory). Returns a cudaError_t.
extern "C" int span_clock(void* stream, void* out, long long* host_before,
                          long long* host_after) {
  timespec t;
  clock_gettime(CLOCK_REALTIME, &t);
  *host_before = (long long)t.tv_sec * 1000000000LL + t.tv_nsec;
  global_ns_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((unsigned long long*)out);
  cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess) e = cudaStreamSynchronize((cudaStream_t)stream);
  clock_gettime(CLOCK_REALTIME, &t);
  *host_after = (long long)t.tv_sec * 1000000000LL + t.tv_nsec;
  return (int)e;
}
