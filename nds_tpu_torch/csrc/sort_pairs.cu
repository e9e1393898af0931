// sort_pairs: sort (key, idx) pairs ascending by the total order (key, idx).
//
// Replaces the TPU kernel nds_tpu/engine/jax_backend/pallas_kernels.py
// `_sort_call` (entry point `sort_pairs`): a VMEM-blocked bitonic network.
//
// Bound on the H100: bytes. The least work reads each pair once and writes
// it once: n x (key bytes + 4) x 2 over 3.35 TB/s. An LSD radix sort moves
// every pair once per 8-bit pass, so what it can do about that bound is make
// fewer passes and make each pass move its bytes at the memory's rate.
//
// Fewer passes: a range remap computed on the device. The keys the engine
// sorts rarely span their type: packed group keys, gids, 0/1 compaction
// flags and permutations, with TYPE_MAX as the dead-row sentinel. The sort
// takes its digits not from the key k but from
//     f(k) = (k == TYPE_MAX) ? hi - lo + 1 : k - lo      (unsigned 64-bit)
// where lo = min(key) and hi = the largest key below TYPE_MAX. f preserves
// order and ties, keeps the sentinels last, and cannot overflow; the pairs
// themselves are stored unchanged. A 0/1 key needs 1 pass instead of 4,
// keys that are all equal need none. The host launches the type's full pass
// count (it never waits on the device); each pass kernel reads the live pass
// count P from device memory and returns at once when it is not live.
//
// Each pass near the memory's rate: one kernel per pass, with decoupled
// look-back (Merrill & Garland's single-pass scan, as in the Onesweep radix
// sort). A persistent block takes tiles of 4096 pairs in order from an
// atomic counter; loads its tile coalesced (warp-striped: warp w owns 512
// consecutive pairs, a warp's load covers 32 neighbours); ranks it stably
// by digit (__match_any_sync within a warp, the warps in order); publishes
// its per-digit counts and looks back over earlier tiles for its global
// offsets; then reorders the tile in shared memory into digit order and
// writes it out, so that neighbouring threads store neighbouring addresses
// inside each digit's run. Per live pass that is 24 bytes per int64 pair (key + idx read and
// written once). The global digit bases of all passes come from one
// histogram kernel that reads the keys once (a thread folds runs of one
// digit in registers, so slowly varying high digits cost one shared atomic
// per run), after one range kernel that reads them once, 32 bytes a thread.
//
// Buffers: pass 0 reads the caller's tensors (they are never written), the
// last live pass writes the output, and the passes between alternate
// between the output and a temporary; every pass derives its buffers from
// P the same way. With no live pass one copy kernel writes the output.
// Keys order as signed integers; idx digits flip the sign bit, and when idx
// is not known to be ascending its 4 digit passes run first, always all 4.
// Every launch returns cudaGetLastError() to the caller.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // == kRadix: thread t owns digit t
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;            // pairs per thread and tile
constexpr int kPassBlocks = 2;        // pass_kernel blocks an SM holds
constexpr int kWarpTile = 32 * kItems;      // consecutive pairs per warp
constexpr int kTile = kThreads * kItems;    // pairs per tile
constexpr int kRadix = 256;
constexpr int kMaxPasses = 12;              // 4 idx digits + 8 key digits
constexpr int kMaxParts = 1024;             // range partials
constexpr uint32_t kAggregate = 1, kInclusive = 2;

// What the histogram kernel derives from the range partials; the passes
// and the copy read it.
struct Info {
  long long lo;               // min(key)
  unsigned long long sent;    // f(TYPE_MAX)
  long long passes;           // P, the live key digit passes
  long long pad;
};

template <typename K>
struct KeyMax;
template <>
struct KeyMax<int32_t> {
  static constexpr long long value = 0x7FFFFFFFLL;
};
template <>
struct KeyMax<int64_t> {
  static constexpr long long value = 0x7FFFFFFFFFFFFFFFLL;
};

struct Scratch {
  unsigned long long* status;  // [tiles][kRadix] look-back words (zeroed)
  uint32_t* counter;           // [kMaxPasses] tile counters (zeroed)
  uint32_t* hist;              // [kMaxPasses][kRadix] digit counts (zeroed)
  long long* parts;            // [nparts][3] range partials
  Info* info;
};

__device__ __forceinline__ unsigned long long fkey(long long k, long long kmax,
                                                   long long lo,
                                                   unsigned long long sent) {
  return k == kmax ? sent
                   : static_cast<unsigned long long>(k) -
                         static_cast<unsigned long long>(lo);
}

__device__ __forceinline__ uint32_t idx_digit(int32_t x, int shift) {
  return ((static_cast<uint32_t>(x) ^ 0x80000000u) >> shift) & 0xFFu;
}

__device__ __forceinline__ long long warp_min(long long v) {
  for (int o = 16; o; o >>= 1) v = min(v, __shfl_xor_sync(0xFFFFFFFFu, v, o));
  return v;
}
__device__ __forceinline__ long long warp_max(long long v) {
  for (int o = 16; o; o >>= 1) v = max(v, __shfl_xor_sync(0xFFFFFFFFu, v, o));
  return v;
}

// Block-wide (min, max, max) of three values; every thread gets the result.
__device__ void block_range(long long& a, long long& b, long long& c) {
  __shared__ long long s[3][kWarps];
  a = warp_min(a);
  b = warp_max(b);
  c = warp_max(c);
  const int w = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    s[0][w] = a;
    s[1][w] = b;
    s[2][w] = c;
  }
  __syncthreads();
  for (int q = 0; q < kWarps; ++q) {
    a = min(a, s[0][q]);
    b = max(b, s[1][q]);
    c = max(c, s[2][q]);
  }
  __syncthreads();
}

// Exclusive scan over the block's 256 threads (one value each).
__device__ uint32_t block_excl_scan(uint32_t v) {
  __shared__ uint32_t wsum[kWarps];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  uint32_t inc = v;
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(0xFFFFFFFFu, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) wsum[w] = inc;
  __syncthreads();
  uint32_t pre = 0;
  for (int q = 0; q < w; ++q) pre += wsum[q];
  __syncthreads();
  return pre + inc - v;
}

// Loads keys c * kChunk .. c * kChunk + kChunk - 1 (32 bytes) into v; ok[k]
// says which lie below n. vec: the keys are 16-byte aligned.
template <typename K>
struct Chunk {
  static constexpr int kN = 32 / sizeof(K);
};

template <typename K>
__device__ __forceinline__ void load_chunk(const K* key, int64_t c, int64_t n,
                                           bool vec, long long v[],
                                           bool ok[]) {
  constexpr int kN = Chunk<K>::kN;
  const int64_t i0 = c * kN;
  if (vec && i0 + kN <= n) {
    const int4* q = reinterpret_cast<const int4*>(key + i0);
    const int4 a = q[0], b = q[1];
    if (sizeof(K) == 8) {
      v[0] = (static_cast<long long>(a.y) << 32) | static_cast<uint32_t>(a.x);
      v[1] = (static_cast<long long>(a.w) << 32) | static_cast<uint32_t>(a.z);
      v[2] = (static_cast<long long>(b.y) << 32) | static_cast<uint32_t>(b.x);
      v[3] = (static_cast<long long>(b.w) << 32) | static_cast<uint32_t>(b.z);
    } else {
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      v[4 % kN] = b.x; v[5 % kN] = b.y; v[6 % kN] = b.z; v[7 % kN] = b.w;
    }
#pragma unroll
    for (int k = 0; k < kN; ++k) ok[k] = true;
  } else {
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      ok[k] = i0 + k < n;
      v[k] = ok[k] ? static_cast<long long>(key[i0 + k]) : 0;
    }
  }
}

// Per-block partials of min(key), max(key) and max(key below TYPE_MAX).
template <typename K>
__global__ void range_kernel(const K* key, int64_t n, int vec, Scratch s) {
  constexpr int kN = Chunk<K>::kN;
  const long long kmax = KeyMax<K>::value;
  long long lo = 0x7FFFFFFFFFFFFFFFLL, hi = -0x7FFFFFFFFFFFFFFFLL - 1;
  long long hi_ns = hi;
  const int64_t chunks = (n + kN - 1) / kN;
  for (int64_t c = blockIdx.x * int64_t(kThreads) + threadIdx.x; c < chunks;
       c += int64_t(gridDim.x) * kThreads) {
    long long v[kN];
    bool ok[kN];
    load_chunk(key, c, n, vec, v, ok);
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      if (ok[k]) {
        lo = min(lo, v[k]);
        hi = max(hi, v[k]);
        if (v[k] != kmax) hi_ns = max(hi_ns, v[k]);
      }
    }
  }
  block_range(lo, hi, hi_ns);
  if (threadIdx.x == 0) {
    s.parts[3 * blockIdx.x] = lo;
    s.parts[3 * blockIdx.x + 1] = hi;
    s.parts[3 * blockIdx.x + 2] = hi_ns;
  }
}

// A digit counter that folds runs of one digit in registers and adds a run
// to the shared histogram row when the digit changes: keys whose high
// digits hardly vary cost one shared atomic per run, not per key.
struct Run {
  uint32_t d = 0, c = 0;
  __device__ __forceinline__ void add(uint32_t* row, uint32_t digit) {
    if (digit == d) {
      ++c;
      return;
    }
    if (c) atomicAdd(&row[d], c);
    d = digit;
    c = 1;
  }
  __device__ __forceinline__ void flush(uint32_t* row) {
    if (c) atomicAdd(&row[d], c);
  }
};

// Reduces the range partials to (lo, sent, P), then counts every live digit
// of f(key) (and the idx digits when nidx == 4) in one read. Each thread
// takes 32 consecutive bytes of keys per step; the two halves of the block
// count into two copies of the histogram.
template <typename K>
__global__ void hist_kernel(const K* key, const int32_t* idx, int64_t n,
                            int nparts, int nidx, int vec, Scratch s) {
  constexpr int kN = Chunk<K>::kN;
  constexpr int kKeyDigits = static_cast<int>(sizeof(K));
  __shared__ uint32_t h[2][kMaxPasses][kRadix];
  const long long kmax = KeyMax<K>::value;
  long long lo = 0x7FFFFFFFFFFFFFFFLL, hi = -0x7FFFFFFFFFFFFFFFLL - 1;
  long long hi_ns = hi;
  for (int b = threadIdx.x; b < nparts; b += kThreads) {
    lo = min(lo, s.parts[3 * b]);
    hi = max(hi, s.parts[3 * b + 1]);
    hi_ns = max(hi_ns, s.parts[3 * b + 2]);
  }
  block_range(lo, hi, hi_ns);
  int P = 0;
  unsigned long long sent = 0;
  if (lo != hi) {  // else every key is equal: no key pass
    const unsigned long long base = static_cast<unsigned long long>(lo);
    // a sentinel exists only when hi == TYPE_MAX > lo, and then hi_ns >= lo
    sent = static_cast<unsigned long long>(hi_ns) - base + 1;
    const unsigned long long fmax =
        hi == kmax ? sent : static_cast<unsigned long long>(hi) - base;
    P = (64 - __clzll(static_cast<long long>(fmax)) + 7) / 8;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    s.info->lo = lo;
    s.info->sent = sent;
    s.info->passes = P;
  }
  const int npass = nidx + P;
  for (int i = threadIdx.x; i < 2 * kMaxPasses * kRadix; i += kThreads)
    (&h[0][0][0])[i] = 0;
  __syncthreads();
  uint32_t(*hh)[kRadix] = h[threadIdx.x >= kThreads / 2];
  Run key_run[kKeyDigits], idx_run[4];
  const int64_t chunks = (n + kN - 1) / kN;
  for (int64_t c = blockIdx.x * int64_t(kThreads) + threadIdx.x; c < chunks;
       c += int64_t(gridDim.x) * kThreads) {
    long long v[kN];
    bool ok[kN];
    load_chunk(key, c, n, vec, v, ok);
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      if (!ok[k]) continue;
      if (nidx) {
        const int32_t x = idx[c * kN + k];
#pragma unroll
        for (int p = 0; p < 4; ++p) idx_run[p].add(hh[p], idx_digit(x, 8 * p));
      }
      const unsigned long long f = fkey(v[k], kmax, lo, sent);
#pragma unroll
      for (int p = 0; p < kKeyDigits; ++p)
        if (p < P)
          key_run[p].add(hh[nidx + p], static_cast<uint32_t>((f >> (8 * p)) & 0xFF));
    }
  }
#pragma unroll
  for (int p = 0; p < 4; ++p)
    if (nidx) idx_run[p].flush(hh[p]);
#pragma unroll
  for (int p = 0; p < kKeyDigits; ++p)
    if (p < P) key_run[p].flush(hh[nidx + p]);
  __syncthreads();
  for (int i = threadIdx.x; i < npass * kRadix; i += kThreads) {
    const uint32_t c = (&h[0][0][0])[i] + (&h[1][0][0])[i];
    if (c) atomicAdd(&s.hist[i], c);
  }
}

__device__ __forceinline__ void publish(unsigned long long* w, int tag,
                                        uint32_t state, uint32_t value) {
  *reinterpret_cast<volatile unsigned long long*>(w) =
      (static_cast<unsigned long long>(tag) << 34) |
      (static_cast<unsigned long long>(state) << 32) | value;
}

// Pass j of the sequence (idx digits first when nidx == 4, then the key
// digits of f). Persistent: each block takes tiles until none is left.
template <typename K>
__global__ void __launch_bounds__(kThreads, kPassBlocks)
pass_kernel(const K* key_in, const int32_t* idx_in, K* key_out,
            int32_t* idx_out, K* key_tmp, int32_t* idx_tmp, int64_t n,
            int j, int nidx, Scratch s) {
  const int L = nidx + static_cast<int>(s.info->passes);
  if (j >= L) return;  // not a live pass
  extern __shared__ __align__(16) unsigned char smem[];
  K* skey = reinterpret_cast<K*>(smem);
  int32_t* sidx = reinterpret_cast<int32_t*>(skey + kTile);
  uint32_t* wcount = reinterpret_cast<uint32_t*>(sidx + kTile);  // [warp][digit]
  __shared__ int s_start[kRadix];  // tile-local start of each digit's run
  __shared__ int s_dest[kRadix];   // global slot of local position 0, by digit
  __shared__ int s_tile;

  const K* kin = key_in;
  const int32_t* iin = idx_in;
  if (j > 0) {
    const bool in_out = ((L - j) & 1) == 0;  // where pass j - 1 wrote
    kin = in_out ? key_out : key_tmp;
    iin = in_out ? idx_out : idx_tmp;
  }
  const bool to_out = ((L - 1 - j) & 1) == 0;
  K* kout = to_out ? key_out : key_tmp;
  int32_t* iout = to_out ? idx_out : idx_tmp;

  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const bool by_idx = j < nidx;
  const int shift = 8 * (by_idx ? j : j - nidx);
  const long long kmax = KeyMax<K>::value;
  const long long lo = s.info->lo;
  const unsigned long long sent = s.info->sent;
  const int tag = j + 1;
  const uint32_t lower = (1u << lane) - 1u;
  auto digit = [&](K k, int32_t x) -> uint32_t {
    return by_idx ? idx_digit(x, shift)
                  : static_cast<uint32_t>(
                        (fkey(static_cast<long long>(k), kmax, lo, sent) >>
                         shift) & 0xFF);
  };
  // global start of digit t in this pass: exclusive scan of the histogram
  const int digit_base = static_cast<int>(block_excl_scan(s.hist[j * kRadix + t]));
  const int64_t ntiles = (n + kTile - 1) / kTile;
  uint32_t* wc = wcount + w * kRadix;

  for (;;) {
    if (t == 0) s_tile = static_cast<int>(atomicAdd(&s.counter[j], 1u));
    for (int d = lane; d < kRadix; d += 32) wc[d] = 0;
    __syncthreads();
    const int tile = s_tile;
    if (tile >= ntiles) break;
    const int64_t base = static_cast<int64_t>(tile) * kTile + w * kWarpTile + lane;
    K k[kItems];
    int32_t x[kItems];
    uint32_t rank[kItems];
#pragma unroll
    for (int r = 0; r < kItems; ++r) {
      const int64_t i = base + r * 32;
      if (i < n) {
        k[r] = kin[i];
        x[r] = iin[i];
      }
    }
    // stable rank within the warp: earlier rounds, then lower lanes
#pragma unroll
    for (int r = 0; r < kItems; ++r) {
      const bool valid = base + r * 32 < n;
      const uint32_t d = valid ? digit(k[r], x[r]) : kRadix;
      const uint32_t peers = __match_any_sync(0xFFFFFFFFu, d);
      const int leader = __ffs(peers) - 1;
      uint32_t before = 0;
      if (lane == leader && valid) {
        before = wc[d];
        wc[d] = before + __popc(peers);
      }
      rank[r] = __shfl_sync(0xFFFFFFFFu, before, leader) + __popc(peers & lower);
      __syncwarp();
    }
    __syncthreads();
    // digit t: the warps' counts -> each warp's start within the digit
    uint32_t cnt = 0;
    for (int q = 0; q < kWarps; ++q) {
      const uint32_t c = wcount[q * kRadix + t];
      wcount[q * kRadix + t] = cnt;
      cnt += c;
    }
    unsigned long long* my = s.status + static_cast<int64_t>(tile) * kRadix + t;
    publish(my, tag, tile == 0 ? kInclusive : kAggregate, cnt);
    const int start = static_cast<int>(block_excl_scan(cnt));
    // decoupled look-back over the earlier tiles' words for digit t
    uint32_t excl = 0;
    if (tile > 0) {
      // tile 0 publishes an inclusive word at once, so the walk ends
      const volatile unsigned long long* p = my - kRadix;
      for (;;) {
        const unsigned long long v = *p;
        if (static_cast<int>(v >> 34) != tag) continue;  // not yet published
        excl += static_cast<uint32_t>(v);
        if (((v >> 32) & 3) == kInclusive) break;
        p -= kRadix;
      }
      publish(my, tag, kInclusive, excl + cnt);
    }
    s_start[t] = start;
    s_dest[t] = digit_base + static_cast<int>(excl) - start;
    __syncthreads();
    // reorder the tile in shared memory into digit order
#pragma unroll
    for (int r = 0; r < kItems; ++r) {
      if (base + r * 32 < n) {
        const uint32_t d = digit(k[r], x[r]);
        const int pos = s_start[d] + static_cast<int>(wcount[w * kRadix + d] + rank[r]);
        skey[pos] = k[r];
        sidx[pos] = x[r];
      }
    }
    __syncthreads();
    // write out: neighbouring threads, neighbouring slots within a digit run
    const int64_t left = n - static_cast<int64_t>(tile) * kTile;
    const int count = left < kTile ? static_cast<int>(left) : kTile;
#pragma unroll
    for (int r = 0; r < kItems; ++r) {
      const int q = t + r * kThreads;
      if (q < count) {
        const K kk = skey[q];
        const int32_t xx = sidx[q];
        const int pos = s_dest[digit(kk, xx)] + q;
        kout[pos] = kk;
        iout[pos] = xx;
      }
    }
    __syncthreads();
  }
}

// With no live pass the sorted pairs are the input (all keys equal, idx
// ascending): copy it to the output.
template <typename K>
__global__ void copy_kernel(const K* key_in, const int32_t* idx_in, K* key_out,
                            int32_t* idx_out, int64_t n, int nidx, Scratch s) {
  if (nidx + s.info->passes != 0) return;
  for (int64_t i = blockIdx.x * int64_t(blockDim.x) + threadIdx.x; i < n;
       i += int64_t(gridDim.x) * blockDim.x) {
    key_out[i] = key_in[i];
    idx_out[i] = idx_in[i];
  }
}

struct Layout {
  size_t status, counter, hist, zeroed, parts, total;
};

Layout layout(int64_t n) {
  Layout l;
  const int64_t tiles = (n + kTile - 1) / kTile;
  l.status = 0;
  l.counter = l.status + size_t(tiles) * kRadix * 8;
  l.hist = l.counter + 16 * 4;
  l.zeroed = l.hist + size_t(kMaxPasses) * kRadix * 4;
  l.parts = l.zeroed;
  l.total = l.parts + size_t(kMaxParts) * 3 * 8;
  return l;
}

int sms() {
  static int count = [] {
    int dev = 0, c = 132;
    if (cudaGetDevice(&dev) == cudaSuccess)
      cudaDeviceGetAttribute(&c, cudaDevAttrMultiProcessorCount, dev);
    return c;
  }();
  return count;
}

template <typename K>
int run(const K* key, const int32_t* idx, K* key_out, int32_t* idx_out,
        K* key_tmp, int32_t* idx_tmp, int64_t n, int sort_idx,
        unsigned char* scratch, Info* info, cudaStream_t st) {
  const Layout l = layout(n);
  Scratch s;
  s.status = reinterpret_cast<unsigned long long*>(scratch + l.status);
  s.counter = reinterpret_cast<uint32_t*>(scratch + l.counter);
  s.hist = reinterpret_cast<uint32_t*>(scratch + l.hist);
  s.parts = reinterpret_cast<long long*>(scratch + l.parts);
  s.info = info;
  cudaError_t err = cudaMemsetAsync(scratch, 0, l.zeroed, st);
  if (err != cudaSuccess) return int(err);
  const int nidx = sort_idx ? 4 : 0;
  const int vec = reinterpret_cast<uintptr_t>(key) % 16 == 0;
  const int64_t want = (n + 4 * kThreads - 1) / (4 * kThreads);
  const int64_t most = 4 * sms() < kMaxParts ? 4 * sms() : kMaxParts;
  const int nparts = int(want < most ? (want < 1 ? 1 : want) : most);
  range_kernel<K><<<nparts, kThreads, 0, st>>>(key, n, vec, s);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  hist_kernel<K><<<nparts, kThreads, 0, st>>>(key, idx, n, nparts, nidx, vec,
                                              s);
  if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  const size_t smem = size_t(kTile) * (sizeof(K) + 4) + size_t(kWarps) * kRadix * 4;
  static int resident = -1;  // blocks of pass_kernel<K> per SM
  if (resident < 0) {
    err = cudaFuncSetAttribute(pass_kernel<K>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(smem));
    if (err != cudaSuccess) return int(err);
    int b = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, pass_kernel<K>,
                                                        kThreads, smem);
    if (err != cudaSuccess) return int(err);
    resident = b < 1 ? 1 : b;
  }
  const int64_t tiles = (n + kTile - 1) / kTile;
  const int64_t grid = tiles < int64_t(resident) * sms() ? tiles
                                                         : int64_t(resident) * sms();
  const int npass = nidx + int(sizeof(K));
  for (int j = 0; j < npass; ++j) {
    pass_kernel<K><<<unsigned(grid), kThreads, smem, st>>>(
        key, idx, key_out, idx_out, key_tmp, idx_tmp, n, j, nidx, s);
    if ((err = cudaGetLastError()) != cudaSuccess) return int(err);
  }
  copy_kernel<K><<<2 * sms(), kThreads, 0, st>>>(key, idx, key_out, idx_out,
                                                  n, nidx, s);
  return int(cudaGetLastError());
}

}  // namespace

// Bytes of device scratch that a sort of n pairs needs.
extern "C" int64_t sort_pairs_scratch_bytes(int64_t n) {
  return static_cast<int64_t>(layout(n).total);
}

// key: n int32 (key_bytes 4) or int64 (key_bytes 8) values; idx: n int32.
// Writes the pairs sorted by (key, idx) to key_out/idx_out on `stream`,
// using key_tmp/idx_tmp (n values each), scratch (sort_pairs_scratch_bytes(n)
// bytes) and info (32 bytes; info[2] holds the live key pass count P after
// the sort). key and idx are not modified. sort_idx == 0 promises that idx
// is ascending, which lets the idx digit passes be skipped. Returns a
// cudaError_t.
extern "C" int sort_pairs_launch(const void* key, const void* idx,
                                 void* key_out, void* idx_out, void* key_tmp,
                                 void* idx_tmp, int64_t n, int key_bytes,
                                 int sort_idx, void* scratch, void* info,
                                 void* stream) {
  if (n < 2) return 0;
  if (n > 0x7FFFFFFFLL) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* i = static_cast<const int32_t*>(idx);
  int32_t* io = static_cast<int32_t*>(idx_out);
  int32_t* it = static_cast<int32_t*>(idx_tmp);
  unsigned char* sc = static_cast<unsigned char*>(scratch);
  Info* inf = static_cast<Info*>(info);
  if (key_bytes == 8)
    return run(static_cast<const int64_t*>(key), i,
               static_cast<int64_t*>(key_out), io,
               static_cast<int64_t*>(key_tmp), it, n, sort_idx, sc, inf, st);
  if (key_bytes == 4)
    return run(static_cast<const int32_t*>(key), i,
               static_cast<int32_t*>(key_out), io,
               static_cast<int32_t*>(key_tmp), it, n, sort_idx, sc, inf, st);
  return int(cudaErrorInvalidValue);
}
