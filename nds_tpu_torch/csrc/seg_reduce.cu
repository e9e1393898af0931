// seg_reduce_multi: fused per-segment SUM (integers), MIN and MAX of several
// operands over one gid vector, in one pass over the rows.
//
// Replaces the TPU kernel nds_tpu/engine/jax_backend/pallas_kernels.py
// `_seg_call` (entry point `seg_reduce_multi`), which reduces each row tile
// through a (segments x tile) membership mask in VMEM.
//
// Bound on the H100: bytes. The least work reads gid (4 B/row) and each
// operand once and writes S values per operand. This design reads each row
// exactly once: every block strides over rows and folds them into
// per-segment partials held in shared memory (S <= 2048 segments x 16 B x
// operands per launch) with shared-memory atomics, then merges its partials
// into the output with one global atomic per segment. Rows that share a hot
// segment serialise on its shared-memory atomic, which is what bounds the
// S = 1 (global aggregate) case.
//
// Arithmetic: every operand accumulates in 64 bits. Integer sums wrap in two's
// complement and are truncated to the operand width at the end, so they
// equal the wrapping sum in the operand's own type. Integer min/max compare
// the sign- or zero-extended values. Floats (widened exactly to double)
// compare through an order-preserving integer key, so -0.0 < +0.0, and any
// NaN in a segment makes the result that NaN (the largest NaN bit pattern
// when several differ), as the reference's NaN-propagating min/max does.
// Empty segments keep the identity: 0, the dtype's extreme, or -/+inf.
// All of these are order-independent, so results are bit-identical to the
// plain version whatever the order of the atomics.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxOps = 16;
constexpr int kThreads = 256;

enum DType { I8 = 0, I16 = 1, I32 = 2, I64 = 3, U8 = 4, F32 = 5, F64 = 6 };
enum Op { SUM = 0, MIN = 1, MAX = 2 };

struct SegArgs {
  const void* data[kMaxOps];
  void* out[kMaxOps];
  int dtype[kMaxOps];
  int op[kMaxOps];
  int nops;
};

__device__ __forceinline__ long long float_key(double v) {
  long long b = __double_as_longlong(v);
  return b >= 0 ? b : (b ^ 0x7FFFFFFFFFFFFFFFLL);
}

__device__ __forceinline__ double key_float(long long k) {
  return __longlong_as_double(k >= 0 ? k : (k ^ 0x7FFFFFFFFFFFFFFFLL));
}

__device__ __forceinline__ bool is_float(int dt) { return dt == F32 || dt == F64; }

// The accumulator's identity for one operand.
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

// Loads row r of an operand as its 64-bit accumulator value. For a float
// NaN, sets *nan_bits to its raw bit pattern (non-zero) instead.
__device__ __forceinline__ long long load(const void* p, int dt, int64_t r,
                                          unsigned long long* nan_bits) {
  *nan_bits = 0;
  switch (dt) {
    case I8: return static_cast<const int8_t*>(p)[r];
    case I16: return static_cast<const int16_t*>(p)[r];
    case I32: return static_cast<const int32_t*>(p)[r];
    case I64: return static_cast<const int64_t*>(p)[r];
    case U8: return static_cast<const uint8_t*>(p)[r];
    case F32: {
      const float v = static_cast<const float*>(p)[r];
      if (v != v) {
        *nan_bits = static_cast<unsigned int>(__float_as_int(v));
        return 0;
      }
      return float_key(static_cast<double>(v));
    }
    default: {
      const double v = static_cast<const double*>(p)[r];
      if (v != v) {
        *nan_bits = static_cast<unsigned long long>(__double_as_longlong(v));
        return 0;
      }
      return float_key(v);
    }
  }
}

__device__ __forceinline__ void fold(long long* acc, int op, long long v) {
  if (op == SUM) {
    atomicAdd(reinterpret_cast<unsigned long long*>(acc),
              static_cast<unsigned long long>(v));
  } else if (op == MIN) {
    atomicMin(acc, v);
  } else {
    atomicMax(acc, v);
  }
}

__global__ void init_kernel(SegArgs a, int S, long long* acc,
                            unsigned long long* nan) {
  const int total = a.nops * S;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += gridDim.x * blockDim.x) {
    const int j = i / S;
    acc[i] = identity(a.dtype[j], a.op[j]);
    nan[i] = 0;
  }
}

__global__ void reduce_kernel(const int32_t* gid, int64_t n, int S, SegArgs a,
                              long long* acc, unsigned long long* nan) {
  extern __shared__ long long smem[];
  long long* sacc = smem;
  unsigned long long* snan =
      reinterpret_cast<unsigned long long*>(smem + a.nops * S);
  const int total = a.nops * S;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int j = i / S;
    sacc[i] = identity(a.dtype[j], a.op[j]);
    snan[i] = 0;
  }
  __syncthreads();
  for (int64_t r = blockIdx.x * int64_t(blockDim.x) + threadIdx.x; r < n;
       r += int64_t(gridDim.x) * blockDim.x) {
    const int g = gid[r];
    if (g < 0 || g >= S) continue;  // dead-row sentinel: contributes nothing
    for (int j = 0; j < a.nops; ++j) {
      unsigned long long nb;
      const long long v = load(a.data[j], a.dtype[j], r, &nb);
      if (nb) {
        atomicMax(&snan[j * S + g], nb);
      } else {
        fold(&sacc[j * S + g], a.op[j], v);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int j = i / S;
    const long long v = sacc[i];
    if (v != identity(a.dtype[j], a.op[j])) fold(&acc[i], a.op[j], v);
    if (snan[i]) atomicMax(&nan[i], snan[i]);
  }
}

__global__ void finalize_kernel(SegArgs a, int S, const long long* acc,
                                const unsigned long long* nan) {
  const int total = a.nops * S;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += gridDim.x * blockDim.x) {
    const int j = i / S;
    const int g = i - j * S;
    const long long v = acc[i];
    void* o = a.out[j];
    switch (a.dtype[j]) {
      case I8: static_cast<int8_t*>(o)[g] = static_cast<int8_t>(v); break;
      case I16: static_cast<int16_t*>(o)[g] = static_cast<int16_t>(v); break;
      case I32: static_cast<int32_t*>(o)[g] = static_cast<int32_t>(v); break;
      case I64: static_cast<int64_t*>(o)[g] = v; break;
      case U8: static_cast<uint8_t*>(o)[g] = static_cast<uint8_t>(v); break;
      case F32:
        static_cast<float*>(o)[g] =
            nan[i] ? __int_as_float(static_cast<int>(nan[i]))
                   : static_cast<float>(key_float(v));
        break;
      default:
        static_cast<double*>(o)[g] =
            nan[i] ? __longlong_as_double(static_cast<long long>(nan[i]))
                   : key_float(v);
        break;
    }
  }
}

}  // namespace

// gid: n int32 segment ids (outside [0, S) is dropped). data/out/dtypes/ops:
// host arrays of nops (<= 16) operand pointers, output pointers (S values of
// the operand's dtype each), dtype codes (I8..F64) and op codes (SUM, MIN,
// MAX). acc and nan: device scratch of nops * S 8-byte words each. Launches
// on `stream`; returns a cudaError_t.
extern "C" int seg_reduce_launch(const void* gid, int64_t n, int S, int nops,
                                 void* const* data, void* const* out,
                                 const int* dtypes, const int* ops, void* acc,
                                 void* nan, void* stream) {
  if (nops < 1 || nops > kMaxOps || S < 1) return int(cudaErrorInvalidValue);
  SegArgs a;
  for (int j = 0; j < nops; ++j) {
    a.data[j] = data[j];
    a.out[j] = out[j];
    a.dtype[j] = dtypes[j];
    a.op[j] = ops[j];
    if (ops[j] == SUM && (dtypes[j] == F32 || dtypes[j] == F64))
      return int(cudaErrorInvalidValue);  // float sums are order-dependent
  }
  a.nops = nops;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  long long* gacc = static_cast<long long*>(acc);
  unsigned long long* gnan = static_cast<unsigned long long*>(nan);
  const int total = nops * S;
  const int small_grid = (total + kThreads - 1) / kThreads;
  init_kernel<<<small_grid, kThreads, 0, st>>>(a, S, gacc, gnan);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const size_t smem = size_t(total) * 16;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(reduce_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(smem));
    if (err != cudaSuccess) return int(err);
  }
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 132 * 4) blocks = 132 * 4;
  if (blocks < 1) blocks = 1;
  reduce_kernel<<<static_cast<unsigned>(blocks), kThreads, smem, st>>>(
      static_cast<const int32_t*>(gid), n, S, a, gacc, gnan);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  finalize_kernel<<<small_grid, kThreads, 0, st>>>(a, S, gacc, gnan);
  return int(cudaGetLastError());
}
