// Asynchronous global -> shared copies (cp.async, sm_80 and later), shared
// by the attention forward (flash_attn.cu) and backward (flash_attn_bwd.cu):
// a copy is queued by the issuing thread, a commit closes the thread's group
// of queued copies, and a wait returns once at most N of its groups are
// still in flight. Other threads see the copied bytes after a barrier that
// follows the wait.
#pragma once

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
