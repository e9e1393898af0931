// take_many: out[j][i] = src[j][idx[i]] for a batch of columns that share one
// index vector, with JAX's gather index semantics.
//
// Replaces the TPU kernel nds_tpu/engine/jax_backend/pallas_kernels.py
// `_gather_call` (entry point `take_many`), which stages each source column
// whole in VMEM and streams index tiles through it.
//
// Bound on the H100: bytes. The least work reads idx once, reads each
// gathered element once and writes each output once. This design loads each
// index once per row and copies that row of every column in the batch (up
// to 16 per launch) with a copy of the column's own width (1, 2, 4 or
// 8 bytes), so idx is read once for the whole batch instead of once per
// column. Output writes are coalesced; source reads are as random as the
// index, and the 50 MB L2 holds dimension-sized sources. There is no
// staging budget: the TPU's 4 MB VMEM limit does not apply here.
//
// Index semantics (JAX gather): a negative index counts from the end of the
// column, and the result is then clamped into [0, len - 1].
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxCols = 16;
constexpr int kThreads = 256;

struct GatherArgs {
  const void* src[kMaxCols];
  void* dst[kMaxCols];
  int64_t len[kMaxCols];
  int width[kMaxCols];
  int ncols;
};

template <typename T>
__device__ __forceinline__ void copy_elem(const void* src, void* dst,
                                          int64_t from, int64_t to) {
  static_cast<T*>(dst)[to] = static_cast<const T*>(src)[from];
}

__global__ void take_kernel(const int32_t* idx, int64_t n, GatherArgs a) {
  for (int64_t i = blockIdx.x * int64_t(blockDim.x) + threadIdx.x; i < n;
       i += int64_t(gridDim.x) * blockDim.x) {
    const int64_t k = idx[i];
    for (int c = 0; c < a.ncols; ++c) {
      const int64_t len = a.len[c];
      int64_t j = k < 0 ? k + len : k;
      j = j < 0 ? 0 : (j >= len ? len - 1 : j);
      switch (a.width[c]) {
        case 1: copy_elem<uint8_t>(a.src[c], a.dst[c], j, i); break;
        case 2: copy_elem<uint16_t>(a.src[c], a.dst[c], j, i); break;
        case 4: copy_elem<uint32_t>(a.src[c], a.dst[c], j, i); break;
        default: copy_elem<uint64_t>(a.src[c], a.dst[c], j, i); break;
      }
    }
  }
}

}  // namespace

// idx: n int32 indices. srcs/dsts/lens/widths: host arrays of ncols
// (1..16) source pointers, output pointers (n elements each), source
// lengths (>= 1) and element widths in bytes (1, 2, 4 or 8). Launches on
// `stream`; returns a cudaError_t.
extern "C" int take_many_launch(const void* idx, int64_t n, int ncols,
                                void* const* srcs, void* const* dsts,
                                const int64_t* lens, const int* widths,
                                void* stream) {
  if (ncols < 1 || ncols > kMaxCols) return int(cudaErrorInvalidValue);
  GatherArgs a;
  for (int c = 0; c < ncols; ++c) {
    if (lens[c] < 1) return int(cudaErrorInvalidValue);
    const int w = widths[c];
    if (w != 1 && w != 2 && w != 4 && w != 8) return int(cudaErrorInvalidValue);
    a.src[c] = srcs[c];
    a.dst[c] = dsts[c];
    a.len[c] = lens[c];
    a.width[c] = w;
  }
  a.ncols = ncols;
  if (n < 1) return 0;
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  take_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(idx), n, a);
  return int(cudaGetLastError());
}
