// seg_reduce_multi: fused per-segment SUM (integers), MIN and MAX of several
// operands over one gid vector, in one pass over the rows.
//
// Replaces the TPU kernel nds_tpu/engine/jax_backend/pallas_kernels.py
// `_seg_call` (entry point `seg_reduce_multi`), which reduces each row tile
// through a (segments x tile) membership mask in VMEM.
//
// Bound on the H100: bytes. The least work reads gid (4 B/row) and each
// operand once and writes S values per operand. What keeps a kernel from
// that bound is contention, not traffic. A global aggregate sends every
// row to one segment, and one shared-memory atomic per row and operand then
// serialises 32 ways in every warp; and the card has no native 64-bit
// shared-memory atomics, so each is a compare-and-swap loop that retries
// while other lanes hit its word. This design keeps runs in registers:
// each thread takes 4 consecutive rows per step (an int4 of gids and one
// 4-row vector load per operand, issued together for up to 4 operands) and,
// when every live row of the step in the whole warp continues one run per
// lane, folds them into register accumulators, flushing only when its gid
// changes. A global aggregate thus flushes once per thread, at the end,
// where a warp whose lanes hold one segment reduces through a
// __shfl_xor_sync tree and only lane 0 touches shared memory. A step whose
// gids change inside the warp (a grouped aggregate over unsorted rows) is
// done row by row instead, neighbouring lanes on neighbouring rows, each
// row folded straight into shared memory. When the rows are too few to
// fill the card 4 at a time, each thread takes 1 row a step instead
// (measured 1.2-1.9x faster at 4,096 to 50,001 rows). Sums fold into shared memory as two native
// 32-bit atomics, min and max through the swap loop. (Folding a step's
// equal segments across the warp first, by __match_any_sync and shuffles,
// measured slower on unsorted gids.) Both modes fold into the warp's
// private partials when warps x S x operands x 8 B (x 2 with a float
// operand, for its NaN words) fits 48 KB, else into the block's. The
// blocks, one grid sized from the SM count and the occupancy, merge their
// partials into device memory once with atomics (native there), and the
// last block to finish (an atomic ticket) writes the outputs and clears
// the device words it used, which the caller keeps between calls: one
// kernel launch and no memset per call.
//
// Arithmetic: every operand accumulates in 64 bits. Integer sums wrap in two's
// complement and are truncated to the operand width at the end, so they
// equal the wrapping sum in the operand's own type. Integer min/max compare
// the sign- or zero-extended values. Floats (widened exactly to double)
// compare through an order-preserving integer key, so -0.0 < +0.0, and any
// NaN in a segment makes the result that NaN (the largest NaN bit pattern
// when several differ), as the reference's NaN-propagating min/max does.
// Empty segments keep the identity: 0, the dtype's extreme, or -/+inf.
// MIN and MAX fold as an unsigned max over an order-mapped word whose
// identity is 0, so zeroed memory starts every accumulator, and a word
// still 0 at the end reads back as the identity. All of these are
// order-independent, so results are bit-identical to the plain version
// whatever the order of the folds.
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>

namespace {

constexpr int kMaxOps = 16;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// shared-memory bytes up to which every warp gets its own partials
constexpr int kPrivateBytes = 48 * 1024;
constexpr unsigned long long kSign = 0x8000000000000000ull;

enum DType { I8 = 0, I16 = 1, I32 = 2, I64 = 3, U8 = 4, F32 = 5, F64 = 6 };
enum Op { SUM = 0, MIN = 1, MAX = 2 };

struct SegArgs {
  const void* data[kMaxOps];
  void* out[kMaxOps];
  int dtype[kMaxOps];
  int op[kMaxOps];
  int nops;
  int has_float;
};

__device__ __forceinline__ long long float_key(double v) {
  long long b = __double_as_longlong(v);
  return b >= 0 ? b : (b ^ 0x7FFFFFFFFFFFFFFFLL);
}

__device__ __forceinline__ double key_float(long long k) {
  return __longlong_as_double(k >= 0 ? k : (k ^ 0x7FFFFFFFFFFFFFFFLL));
}

// The identity of one operand, in the value domain.
__device__ long long identity(int dt, int op) {
  if (op == SUM) return 0;
  const bool mn = op == MIN;
  switch (dt) {
    case I8: return mn ? 127LL : -128LL;
    case I16: return mn ? 32767LL : -32768LL;
    case I32: return mn ? 2147483647LL : -2147483648LL;
    case I64: return mn ? 0x7FFFFFFFFFFFFFFFLL : (-0x7FFFFFFFFFFFFFFFLL - 1);
    case U8: return mn ? 255LL : 0LL;
    default: {  // float: +inf for min, -inf for max
      const double inf = __longlong_as_double(0x7FF0000000000000LL);
      return float_key(mn ? inf : -inf);
    }
  }
}

// Value -> accumulator word: SUM adds the value; MAX takes the unsigned max
// of the order-preserving map, MIN of the order-reversing one. 0 is the
// identity of all three (it stands for INT64_MIN under MAX and INT64_MAX
// under MIN, the widest identities, which finalize narrows).
__device__ __forceinline__ unsigned long long to_acc(int op, long long v) {
  const unsigned long long u = static_cast<unsigned long long>(v) ^ kSign;
  return op == SUM ? static_cast<unsigned long long>(v) : (op == MAX ? u : ~u);
}

__device__ __forceinline__ unsigned long long combine(int op, unsigned long long a,
                                                      unsigned long long b) {
  return op == SUM ? a + b : (a > b ? a : b);
}

// A fold into device memory, where 64-bit atomics are native.
__device__ __forceinline__ void atomic_fold(unsigned long long* p, int op,
                                            unsigned long long v) {
  if (op == SUM) {
    atomicAdd(p, v);
  } else {
    atomicMax(p, v);
  }
}

// A fold into shared memory, which has no native 64-bit atomics: each
// compiles to a compare-and-swap loop that retries while other lanes hit
// the word. A sum therefore adds its two 32-bit halves with native 32-bit
// atomics, the low half's carry going into the high one, so that the
// 64-bit word, read once all folds are done, holds the wrapping sum. (A
// max has no such split; reading the word first to skip the swap when v
// does not raise it, or a swap loop of its own, measured slower.)
__device__ __forceinline__ void shared_fold(unsigned long long* p, int op,
                                            unsigned long long v) {
  if (op == SUM) {
    unsigned int* half = reinterpret_cast<unsigned int*>(p);
    const unsigned int lo = static_cast<unsigned int>(v);
    const unsigned int carry = atomicAdd(half, lo) + lo < lo;
    const unsigned int hi = static_cast<unsigned int>(v >> 32) + carry;
    if (hi) atomicAdd(half + 1, hi);
  } else {
    atomicMax(p, v);
  }
}

// Row r of an operand as raw 64-bit bits: integers sign- or zero-extended,
// floats as their bit pattern.
__device__ __forceinline__ unsigned long long load_raw(const void* p, int dt,
                                                       int64_t r) {
  switch (dt) {
    case I8: return static_cast<unsigned long long>(static_cast<const int8_t*>(p)[r]);
    case I16: return static_cast<unsigned long long>(static_cast<const int16_t*>(p)[r]);
    case I32: return static_cast<unsigned long long>(static_cast<const int32_t*>(p)[r]);
    case U8: return static_cast<const uint8_t*>(p)[r];
    case F32: return static_cast<const uint32_t*>(p)[r];
    default: return static_cast<const unsigned long long*>(p)[r];  // I64, F64
  }
}

// Rows r0..r0+3 of an operand as raw bits, by one vector load (the caller
// checked the alignment).
__device__ __forceinline__ void load4_raw(const void* p, int dt, int64_t r0,
                                          unsigned long long raw[4]) {
  switch (dt) {
    case I8: {
      const char4 c = *reinterpret_cast<const char4*>(static_cast<const int8_t*>(p) + r0);
      raw[0] = static_cast<long long>(c.x); raw[1] = static_cast<long long>(c.y);
      raw[2] = static_cast<long long>(c.z); raw[3] = static_cast<long long>(c.w);
      break;
    }
    case U8: {
      const uchar4 c = *reinterpret_cast<const uchar4*>(static_cast<const uint8_t*>(p) + r0);
      raw[0] = c.x; raw[1] = c.y; raw[2] = c.z; raw[3] = c.w;
      break;
    }
    case I16: {
      const short4 c = *reinterpret_cast<const short4*>(static_cast<const int16_t*>(p) + r0);
      raw[0] = static_cast<long long>(c.x); raw[1] = static_cast<long long>(c.y);
      raw[2] = static_cast<long long>(c.z); raw[3] = static_cast<long long>(c.w);
      break;
    }
    case I32: {
      const int4 c = *reinterpret_cast<const int4*>(static_cast<const int32_t*>(p) + r0);
      raw[0] = static_cast<long long>(c.x); raw[1] = static_cast<long long>(c.y);
      raw[2] = static_cast<long long>(c.z); raw[3] = static_cast<long long>(c.w);
      break;
    }
    case F32: {
      const uint4 c = *reinterpret_cast<const uint4*>(static_cast<const uint32_t*>(p) + r0);
      raw[0] = c.x; raw[1] = c.y; raw[2] = c.z; raw[3] = c.w;
      break;
    }
    default: {  // I64, F64
      const ulonglong2* q = reinterpret_cast<const ulonglong2*>(
          static_cast<const unsigned long long*>(p) + r0);
      const ulonglong2 a = q[0], b = q[1];
      raw[0] = a.x; raw[1] = a.y; raw[2] = b.x; raw[3] = b.y;
      break;
    }
  }
}

// Raw bits -> the 64-bit value an operand folds. For a float NaN, sets
// *nan_bits to its raw bit pattern (non-zero) instead.
__device__ __forceinline__ long long decode(int dt, unsigned long long raw,
                                            unsigned long long* nan_bits) {
  *nan_bits = 0;
  if (dt == F32) {
    const float v = __uint_as_float(static_cast<unsigned int>(raw));
    if (v != v) {
      *nan_bits = raw;
      return 0;
    }
    return float_key(static_cast<double>(v));
  }
  if (dt == F64) {
    const double v = __longlong_as_double(static_cast<long long>(raw));
    if (v != v) {
      *nan_bits = raw;
      return 0;
    }
    return float_key(v);
  }
  return static_cast<long long>(raw);
}

// kOps: the most operands this instantiation holds in registers (>= nops).
// kRows: rows a thread takes per step, 4 (vector loads) or, when there are
// too few rows to fill the card 4 at a time, 1.
// scratch: acc[nops * S], nan[nops * S], ticket; zero on entry, and zero
// again when the kernel ends.
template <int kOps, int kRows>
__global__ void __launch_bounds__(kThreads, 4)
seg_kernel(const int32_t* gid, int64_t n, int S, SegArgs a, int vec,
           int private_warps, unsigned long long* scratch) {
  extern __shared__ unsigned long long part[];
  const int nops = a.nops;
  const int cell = nops * S;
  unsigned long long* acc = scratch;
  unsigned long long* gnan = scratch + cell;
  unsigned int* ticket = reinterpret_cast<unsigned int*>(scratch + 2 * cell);
  const int per_copy = cell * (a.has_float ? 2 : 1);
  const int copies = private_warps ? kWarps : 1;
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  for (int i = t; i < copies * per_copy; i += kThreads) part[i] = 0;
  __syncthreads();
  unsigned long long* my = part + (private_warps ? w : 0) * per_copy;

  unsigned long long racc[kOps];
#pragma unroll
  for (int j = 0; j < kOps; ++j) racc[j] = 0;
  int cur = -1;  // the segment the registers hold
  auto flush = [&]() {
#pragma unroll
    for (int j = 0; j < kOps; ++j) {
      if (j < nops && racc[j]) shared_fold(&my[j * S + cur], a.op[j], racc[j]);
      racc[j] = 0;
    }
  };
  // One value of operand j for segment g: into the registers, or (into ==
  // false) straight into the partials. A NaN always goes straight to the
  // partials' NaN words: it is rare, and keeps no register.
  auto fold = [&](int j, unsigned long long raw, int g, bool into) {
    unsigned long long nb;
    const long long v = decode(a.dtype[j], raw, &nb);
    if (nb) {
      atomicMax(&my[cell + j * S + g], nb);
      return;
    }
    const unsigned long long u = to_acc(a.op[j], v);
    if (into) {
      racc[j] = combine(a.op[j], racc[j], u);
    } else if (u) {
      shared_fold(&my[j * S + g], a.op[j], u);
    }
  };

  // With few operands, every operand's rows load with the gids, before the
  // gids are read, so that each thread keeps them all in flight.
  constexpr bool kPrefetch = kOps <= 4 && kRows == 4;
  const int64_t steps = (n + kRows - 1) / kRows;
  const int64_t stride = int64_t(gridDim.x) * kThreads;
  // the loop is warp-uniform: the votes inside need every lane
  for (int64_t ws = blockIdx.x * int64_t(kThreads) + (t - lane); ws < steps;
       ws += stride) {
    const int64_t r0 = kRows * (ws + lane);
    const bool vfull = kRows == 4 && vec && r0 + 4 <= n;
    int g[kRows];
    unsigned long long pre[kPrefetch ? kOps : 1][4];
    if (vfull) {
      const int4 v = *reinterpret_cast<const int4*>(gid + r0);
      g[0] = v.x; g[1 % kRows] = v.y; g[2 % kRows] = v.z; g[3 % kRows] = v.w;
      if (kPrefetch) {
#pragma unroll
        for (int j = 0; j < kOps; ++j)
          if (j < nops) load4_raw(a.data[j], a.dtype[j], r0, pre[kPrefetch ? j : 0]);
      }
    } else {
#pragma unroll
      for (int k = 0; k < kRows; ++k) g[k] = r0 + k < n ? gid[r0 + k] : -1;
    }
    bool live[kRows];
    int first = -1;
    bool one = true;  // every live row of the step has one gid
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      live[k] = g[k] >= 0 && g[k] < S;  // outside [0, S): dropped
      if (live[k]) {
        if (first < 0) first = g[k];
        one = one && g[k] == first;
      }
    }
    if (__all_sync(0xFFFFFFFFu, first < 0 || (one && (kRows == 1 || vfull)))) {
      // run mode: each lane's live rows are one run, folded in registers
      if (first >= 0) {
        if (first != cur) {
          if (cur >= 0) flush();
          cur = first;
        }
#pragma unroll
        for (int j = 0; j < kOps; ++j) {
          if (j < nops) {
            unsigned long long raw[4];
            if (kPrefetch) {
#pragma unroll
              for (int k = 0; k < 4; ++k) raw[k] = pre[kPrefetch ? j : 0][k];
            } else if (kRows == 4) {
              load4_raw(a.data[j], a.dtype[j], r0, raw);
            } else {
              raw[0] = load_raw(a.data[j], a.dtype[j], r0);
            }
#pragma unroll
            for (int k = 0; k < kRows; ++k)
              if (live[k]) fold(j, raw[k], first, true);
          }
        }
      }
    } else {
      // row mode (the gids change within the warp's 128 rows): neighbouring
      // lanes take neighbouring rows, each straight into the partials
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        const int64_t r = kRows * ws + 32 * k + lane;
        const int gg = r < n ? gid[r] : -1;
        if (gg >= 0 && gg < S) {
#pragma unroll
          for (int j = 0; j < kOps; ++j)
            if (j < nops) fold(j, load_raw(a.data[j], a.dtype[j], r), gg, false);
        }
      }
    }
  }

  // the last flush: a warp whose lanes all hold one segment reduces through
  // shuffles and lane 0 folds it; otherwise every lane folds its own
  if (__all_sync(0xFFFFFFFFu, cur >= 0) &&
      __match_any_sync(0xFFFFFFFFu, cur) == 0xFFFFFFFFu) {
#pragma unroll
    for (int j = 0; j < kOps; ++j) {
      if (j < nops) {
        for (int o = 16; o; o >>= 1)
          racc[j] = combine(a.op[j], racc[j],
                            __shfl_xor_sync(0xFFFFFFFFu, racc[j], o));
      }
    }
    if (lane == 0) flush();
  } else if (cur >= 0) {
    flush();
  }
  __syncthreads();

  // the block's partials (summed over its warps) into device memory
  for (int i = t; i < cell; i += kThreads) {
    const int op = a.op[i / S];
    unsigned long long v = 0, nb = 0;
    for (int c = 0; c < copies; ++c) {
      v = combine(op, v, part[c * per_copy + i]);
      if (a.has_float) {
        const unsigned long long y = part[c * per_copy + cell + i];
        nb = nb > y ? nb : y;
      }
    }
    if (v) atomic_fold(&acc[i], op, v);
    if (nb) atomicMax(&gnan[i], nb);
  }
  __threadfence();
  __shared__ bool last;
  __syncthreads();
  if (t == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();

  // the last block: accumulator words (read past L1, where the other
  // blocks' atomics landed) -> outputs, and the words cleared for the
  // next call
  if (t == 0) *ticket = 0;
#pragma unroll 4
  for (int i = t; i < cell; i += kThreads) {
    const int j = i / S;
    const int g = i - j * S;
    const int op = a.op[j];
    const unsigned long long u = __ldcg(&acc[i]);
    const unsigned long long nb = a.has_float ? __ldcg(&gnan[i]) : 0;
    acc[i] = 0;
    if (a.has_float) gnan[i] = 0;
    long long v;
    if (op == SUM) {
      v = static_cast<long long>(u);
    } else if (u == 0) {
      v = identity(a.dtype[j], op);
    } else {
      v = static_cast<long long>((op == MAX ? u : ~u) ^ kSign);
    }
    void* o = a.out[j];
    switch (a.dtype[j]) {
      case I8: static_cast<int8_t*>(o)[g] = static_cast<int8_t>(v); break;
      case I16: static_cast<int16_t*>(o)[g] = static_cast<int16_t>(v); break;
      case I32: static_cast<int32_t*>(o)[g] = static_cast<int32_t>(v); break;
      case I64: static_cast<int64_t*>(o)[g] = v; break;
      case U8: static_cast<uint8_t*>(o)[g] = static_cast<uint8_t>(v); break;
      case F32:
        static_cast<float*>(o)[g] =
            nb ? __int_as_float(static_cast<int>(nb))
               : static_cast<float>(key_float(v));
        break;
      default:
        static_cast<double*>(o)[g] =
            nb ? __longlong_as_double(static_cast<long long>(nb)) : key_float(v);
        break;
    }
  }
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

// Blocks of seg_kernel<kOps, kRows> that one SM holds with `smem` bytes of
// dynamic shared memory, raising the kernel's limit first where `smem`
// needs it. Both answers are kept per instantiation and size: asking the
// runtime costs host time, and every call would ask again.
template <int kOps, int kRows>
cudaError_t blocks_per_sm(size_t smem, int* per_sm) {
  static std::mutex mu;
  static std::map<size_t, int> known;
  static size_t allowed = 48 * 1024;
  std::lock_guard<std::mutex> lock(mu);
  const auto it = known.find(smem);
  if (it != known.end()) {
    *per_sm = it->second;
    return cudaSuccess;
  }
  cudaError_t err;
  if (smem > allowed) {
    err = cudaFuncSetAttribute(seg_kernel<kOps, kRows>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(smem));
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, seg_kernel<kOps, kRows>, kThreads, smem);
  if (err == cudaSuccess) known[smem] = *per_sm;
  return err;
}

template <int kOps, int kRows>
int launch(const int32_t* gid, int64_t n, int S, const SegArgs& a, int vec,
           size_t smem, int private_warps, unsigned long long* scratch,
           cudaStream_t st) {
  int per_sm = 0;
  const cudaError_t err = blocks_per_sm<kOps, kRows>(smem, &per_sm);
  if (err != cudaSuccess) return int(err);
  const int64_t resident = int64_t(per_sm < 1 ? 1 : per_sm) * sms();
  if (kRows == 4 && (n + 3) / 4 < resident * kThreads)  // too few to fill it
    return launch<kOps, 1>(gid, n, S, a, vec, smem, private_warps, scratch, st);
  int64_t blocks = ((n + kRows - 1) / kRows + kThreads - 1) / kThreads;
  if (blocks > resident) blocks = resident;
  if (blocks < 1) blocks = 1;
  seg_kernel<kOps, kRows><<<unsigned(blocks), kThreads, smem, st>>>(
      gid, n, S, a, vec, private_warps, scratch);
  return int(cudaGetLastError());
}

// Sizes the shared partials and launches with 4 rows a thread per step.
template <int kOps>
int launch_ops(const int32_t* gid, int64_t n, int S, const SegArgs& a, int vec,
               unsigned long long* scratch, cudaStream_t st) {
  const size_t per_copy = size_t(a.nops) * S * 8 * (a.has_float ? 2 : 1);
  const int private_warps = kWarps * per_copy <= size_t(kPrivateBytes);
  const size_t smem = private_warps ? kWarps * per_copy : per_copy;
  return launch<kOps, 4>(gid, n, S, a, vec, smem, private_warps, scratch, st);
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

size_t width(int dt) {
  switch (dt) {
    case I8: case U8: return 1;
    case I16: return 2;
    case I32: case F32: return 4;
    default: return 8;
  }
}

}  // namespace

// gid: n int32 segment ids (outside [0, S) is dropped). data/out/dtypes/ops:
// host arrays of nops (<= 16) operand pointers, output pointers (S values of
// the operand's dtype each), dtype codes (I8..F64) and op codes (SUM, MIN,
// MAX). scratch: device memory of 2 * nops * S + 1 8-byte words, zero on
// entry and left zero for the next call on `stream` (which the caller
// keeps it for). Launches on `stream`; returns a cudaError_t.
extern "C" int seg_reduce_launch(const void* gid, int64_t n, int S, int nops,
                                 void* const* data, void* const* out,
                                 const int* dtypes, const int* ops,
                                 void* scratch, void* stream) {
  if (nops < 1 || nops > kMaxOps || S < 1) return int(cudaErrorInvalidValue);
  SegArgs a;
  a.has_float = 0;
  int vec = aligned(gid, 16);
  for (int j = 0; j < nops; ++j) {
    a.data[j] = data[j];
    a.out[j] = out[j];
    a.dtype[j] = dtypes[j];
    a.op[j] = ops[j];
    const bool fl = dtypes[j] == F32 || dtypes[j] == F64;
    if (ops[j] == SUM && fl)
      return int(cudaErrorInvalidValue);  // float sums are order-dependent
    a.has_float |= fl;
    const size_t w4 = 4 * width(dtypes[j]);
    vec = vec && aligned(data[j], w4 < 16 ? w4 : 16);
  }
  a.nops = nops;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned long long* sc = static_cast<unsigned long long*>(scratch);
  const int32_t* g = static_cast<const int32_t*>(gid);
  return nops <= 4 ? launch_ops<4>(g, n, S, a, vec, sc, st)
                   : launch_ops<kMaxOps>(g, n, S, a, vec, sc, st);
}
