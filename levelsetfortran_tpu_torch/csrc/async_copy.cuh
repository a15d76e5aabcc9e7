// Asynchronous copies from device memory into shared memory (cp.async,
// sm_80 and later): a thread prefetches planes of a field into a shared
// ring without holding the loads in registers, commits one group per plane
// and waits until all but the N newest groups have landed.  Another
// thread's copies are visible after its wait and a __syncthreads().
#pragma once

#include <cuda_runtime.h>

namespace lsf {

__device__ __forceinline__ void async_copy4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace lsf
