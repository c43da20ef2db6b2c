// Page-table gather for the paged decode plane.
//
// Replaces: deeplearning4j_tpu/ops/paged_attention.py, _gather_kernel (the
// pallas_call in _paged_gather_pallas at :79; entry paged_gather).
//
// Computes out[c, p * ps + s, h, d] = pool[table[c, p], s, h, d]: each slot's
// logical KV view [P * ps, H, D] materialized through its page-table row.
// Page 0 (the trash page) is gathered like any other page.
//
// What bounds it on the H100: bytes. It is pure data movement, one read and
// one write of every gathered page, with no arithmetic at all.
//
// What the design does about it: one block per (slot, page). The block loads
// its own physical page id from the table (the counterpart of the TPU
// kernel's scalar prefetch), then copies the page, which is contiguous in
// both the pool and the output, with 16-byte vector loads and stores,
// neighbouring threads on neighbouring addresses. The copy moves raw bytes, so
// the result is bitwise equal to an index_select over the page axis. A page id
// outside the pool traps, as a device-side assert would.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
paged_gather_kernel(const uint8_t* __restrict__ pool,
                    const int32_t* __restrict__ table,
                    uint8_t* __restrict__ out, long long page_bytes,
                    int n_total, int vec16) {
  const long long slot_page = blockIdx.x;  // c * P + p
  const int pid = table[slot_page];
  if (pid < 0 || pid >= n_total) __trap();
  const uint8_t* src = pool + (long long)pid * page_bytes;
  uint8_t* dst = out + slot_page * page_bytes;
  if (vec16) {
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    const long long n = page_bytes / 16;
    for (long long i = threadIdx.x; i < n; i += THREADS) d4[i] = s4[i];
  } else {
    for (long long i = threadIdx.x; i < page_bytes; i += THREADS) dst[i] = src[i];
  }
}

}  // namespace

extern "C" int paged_gather(const void* pool, const void* table, void* out,
                            int n_total, int n_slot_pages, long long page_bytes,
                            void* stream) {
  const int vec16 = (page_bytes % 16 == 0) &&
                    (reinterpret_cast<uintptr_t>(pool) % 16 == 0) &&
                    (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  paged_gather_kernel<<<n_slot_pages, THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(pool), static_cast<const int32_t*>(table),
      static_cast<uint8_t*>(out), page_bytes, n_total, vec16);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
