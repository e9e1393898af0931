// sort_pairs: sort (key, idx) pairs ascending by the total order (key, idx).
//
// Replaces the TPU kernel nds_tpu/engine/jax_backend/pallas_kernels.py
// `_sort_call` (entry point `sort_pairs`): a VMEM-blocked bitonic network.
//
// Bound on the H100: bytes. The least work reads and writes each 12-byte
// (int64 key, int32 idx) pair once. A bitonic network makes
// log2(N)(log2(N)+1)/2 passes over a power-of-two padding of the input; this
// design is a least-significant-digit radix sort instead: one stable
// counting pass per 8-bit digit over exactly n pairs, 4 passes for an int32
// key and 8 for an int64 key, plus 4 over the idx digits first unless the
// caller promises that idx is ascending (the engine passes an iota, and
// says so). Each pass reads the digits once to count them and the pairs
// once to move them, and writes the pairs once.
//
// A pass is three kernels: per-block digit counts (shared-memory atomics),
// a per-digit exclusive scan over the blocks, and a stable scatter in which
// each warp ranks equal digits with __match_any_sync and the block ranks
// its warps in order, so pairs of equal digit keep their input order.
// Keys and idx compare as signed integers (the sign bit is flipped to order
// the digits). Every launch returns cudaGetLastError() to the caller.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;  // pairs per block
constexpr int kRadix = 256;

template <typename T>
struct Ordered;
template <>
struct Ordered<int32_t> {
  __device__ static uint32_t digit(int32_t v, int shift) {
    return ((static_cast<uint32_t>(v) ^ 0x80000000u) >> shift) & 0xFFu;
  }
};
template <>
struct Ordered<int64_t> {
  __device__ static uint32_t digit(int64_t v, int shift) {
    return static_cast<uint32_t>(
        ((static_cast<uint64_t>(v) ^ 0x8000000000000000ull) >> shift) & 0xFFu);
  }
};

// The digit of pair i: of the key (by_idx == 0) or of the idx.
template <typename K>
__device__ __forceinline__ uint32_t pair_digit(const K* key, const int32_t* idx,
                                               int64_t i, int by_idx, int shift) {
  return by_idx ? Ordered<int32_t>::digit(idx[i], shift)
                : Ordered<K>::digit(key[i], shift);
}

template <typename K>
__global__ void count_kernel(const K* key, const int32_t* idx, int64_t n,
                             int by_idx, int shift, uint32_t* block_hist,
                             int nblocks) {
  __shared__ uint32_t h[kRadix];
  for (int d = threadIdx.x; d < kRadix; d += blockDim.x) h[d] = 0;
  __syncthreads();
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  for (int r = 0; r < kItems; ++r) {
    const int64_t i = base + r * kThreads + threadIdx.x;
    if (i < n) atomicAdd(&h[pair_digit(key, idx, i, by_idx, shift)], 1u);
  }
  __syncthreads();
  for (int d = threadIdx.x; d < kRadix; d += blockDim.x)
    block_hist[static_cast<int64_t>(d) * nblocks + blockIdx.x] = h[d];
}

// One block per digit: exclusive scan of that digit's counts over the
// blocks, in place, and the digit's total.
__global__ void scan_kernel(uint32_t* block_hist, int nblocks,
                            uint32_t* digit_total) {
  __shared__ uint32_t s[1024];
  uint32_t* row = block_hist + static_cast<int64_t>(blockIdx.x) * nblocks;
  const int t = threadIdx.x;
  uint32_t carry = 0;
  for (int start = 0; start < nblocks; start += 1024) {
    const int j = start + t;
    const uint32_t v = j < nblocks ? row[j] : 0u;
    s[t] = v;
    __syncthreads();
    for (int off = 1; off < 1024; off <<= 1) {
      const uint32_t add = t >= off ? s[t - off] : 0u;
      __syncthreads();
      s[t] += add;
      __syncthreads();
    }
    if (j < nblocks) row[j] = carry + s[t] - v;
    carry += s[1023];
    __syncthreads();
  }
  if (t == 0) digit_total[blockIdx.x] = carry;
}

template <typename K>
__global__ void scatter_kernel(const K* kin, const int32_t* iin, K* kout,
                               int32_t* iout, int64_t n, int by_idx, int shift,
                               const uint32_t* block_hist, int nblocks,
                               const uint32_t* digit_total) {
  __shared__ uint32_t base[kRadix];          // next output slot per digit
  __shared__ uint32_t wcnt[kWarps][kRadix];  // this round's count per warp
  __shared__ uint32_t woff[kWarps][kRadix];  // this round's slot per warp
  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane = t & 31;
  // exclusive scan of the digit totals, plus this block's offset
  {
    base[t] = digit_total[t];
    __syncthreads();
    for (int off = 1; off < kRadix; off <<= 1) {
      const uint32_t add = t >= off ? base[t - off] : 0u;
      __syncthreads();
      base[t] += add;
      __syncthreads();
    }
    const uint32_t excl = base[t] - digit_total[t];
    __syncthreads();
    base[t] = excl + block_hist[static_cast<int64_t>(t) * nblocks + blockIdx.x];
    for (int w = 0; w < kWarps; ++w) wcnt[w][t] = 0;
    __syncthreads();
  }
  const int64_t tile = static_cast<int64_t>(blockIdx.x) * kTile;
  const uint32_t lower_lanes = (1u << lane) - 1u;
  for (int r = 0; r < kItems; ++r) {
    const int64_t i = tile + r * kThreads + t;
    const bool valid = i < n;
    K k = 0;
    int32_t x = 0;
    uint32_t d = kRadix;  // lanes past the end match only each other
    if (valid) {
      k = kin[i];
      x = iin[i];
      d = by_idx ? Ordered<int32_t>::digit(x, shift) : Ordered<K>::digit(k, shift);
    }
    const uint32_t peers = __match_any_sync(0xFFFFFFFFu, d);
    const uint32_t below = __popc(peers & lower_lanes);
    if (valid && below == 0) wcnt[warp][d] = __popc(peers);
    __syncthreads();
    {  // thread t owns digit t: slots for each warp in warp order
      uint32_t run = base[t];
      for (int w = 0; w < kWarps; ++w) {
        woff[w][t] = run;
        run += wcnt[w][t];
        wcnt[w][t] = 0;
      }
      base[t] = run;
    }
    __syncthreads();
    if (valid) {
      const uint32_t pos = woff[warp][d] + below;
      kout[pos] = k;
      iout[pos] = x;
    }
  }
}

template <typename K>
int run(K* key, int32_t* idx, K* key_tmp, int32_t* idx_tmp, int64_t n,
        int sort_idx, uint32_t* block_hist, uint32_t* digit_total,
        cudaStream_t stream) {
  const int nblocks = static_cast<int>((n + kTile - 1) / kTile);
  K* kbuf[2] = {key, key_tmp};
  int32_t* ibuf[2] = {idx, idx_tmp};
  int cur = 0;
  const int key_digits = static_cast<int>(sizeof(K));
  for (int p = sort_idx ? -4 : 0; p < key_digits; ++p) {
    const int by_idx = p < 0;
    const int shift = 8 * (by_idx ? p + 4 : p);
    count_kernel<K><<<nblocks, kThreads, 0, stream>>>(
        kbuf[cur], ibuf[cur], n, by_idx, shift, block_hist, nblocks);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
    scan_kernel<<<kRadix, 1024, 0, stream>>>(block_hist, nblocks, digit_total);
    err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
    scatter_kernel<K><<<nblocks, kThreads, 0, stream>>>(
        kbuf[cur], ibuf[cur], kbuf[1 - cur], ibuf[1 - cur], n, by_idx, shift,
        block_hist, nblocks, digit_total);
    err = cudaGetLastError();
    if (err != cudaSuccess) return int(err);
    cur = 1 - cur;
  }
  return cur == 0 ? 0 : int(cudaErrorInvalidValue);  // even pass count
}

}  // namespace

// Number of 4-byte words of block_hist scratch that n pairs need.
extern "C" int64_t sort_pairs_scratch_words(int64_t n) {
  return static_cast<int64_t>(kRadix) * ((n + kTile - 1) / kTile);
}

// key: n int32 (key_bytes 4) or int64 (key_bytes 8) values; idx: n int32.
// Both are sorted in place by (key, idx) on `stream`, using key_tmp/idx_tmp
// (n values each), block_hist (sort_pairs_scratch_words(n) words) and
// digit_total (256 words) as scratch. sort_idx == 0 promises that idx is
// ascending, which lets the idx digit passes be skipped. Returns a
// cudaError_t.
extern "C" int sort_pairs_launch(void* key, void* idx, void* key_tmp,
                                 void* idx_tmp, int64_t n, int key_bytes,
                                 int sort_idx, void* block_hist,
                                 void* digit_total, void* stream) {
  if (n < 2) return 0;
  if (n > 0x7FFFFFFFLL) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int32_t* i = static_cast<int32_t*>(idx);
  int32_t* it = static_cast<int32_t*>(idx_tmp);
  uint32_t* h = static_cast<uint32_t*>(block_hist);
  uint32_t* tot = static_cast<uint32_t*>(digit_total);
  if (key_bytes == 8)
    return run(static_cast<int64_t*>(key), i, static_cast<int64_t*>(key_tmp),
               it, n, sort_idx, h, tot, st);
  if (key_bytes == 4)
    return run(static_cast<int32_t*>(key), i, static_cast<int32_t*>(key_tmp),
               it, n, sort_idx, h, tot, st);
  return int(cudaErrorInvalidValue);
}
