// Packed-SNP decode-matmul kernel for Hopper (sm_90a).
//
// One kernel, templated on the value type (float, double: the H100 has
// native FP64) and on HAS_NA, with a plain C interface loaded by ctypes from
// adelie_tpu_torch/matrix/snp_kernels.py.  Every entry point launches on the
// caller's stream, allocates nothing and returns cudaGetLastError().
//
//   adelie_snp_mul_{f32,f64}        (HAS_NA = true) replaces K3,
//       adelie_tpu/matrix/_snp_pallas.py:snp_mul_pallas;
//   adelie_snp_mul_no_na_{f32,f64}  (HAS_NA = false) replaces K4,
//       adelie_tpu/matrix/_snp_pallas.py:snp_mul_pallas_no_na.
//
// What it computes: out[j] = sum_i x(j, i) u_pad[i] for j < p, where row j
// of `packed` (p x nb bytes, row-major, never copied or padded) holds
// sample i in byte i / 4, bits 2 (i % 4); x(j, i) is the 2-bit code, except
// that with HAS_NA a code 3 (NA) reads impute[j].  u_pad has 16 ceil(nb / 4)
// entries, zero past the sample count n, so tail codes (a code 3 among
// them) contribute x * 0 = 0.
//
// Bound on the H100 (3.35 TB/s, 67 TFLOP/s FP32): bytes p nb + 4 (4 nb)
// + 4 p (+ 4 p impute), operations 2 p n.  At the GWAS shape (p = 200,000,
// n = 50,000: 2.5 GB of packed bytes) that is 0.75 ms of bytes against
// 0.30 ms of operations: the kernel is bound by the packed bytes it reads.
// What holds this first version above it is the decode: about 3.5 integer
// and FP32 operations per code, 1.4e10 integer operations at the GWAS
// shape, near 1 ms of the integer pipes alone (PERF.md has the times).
//
// Design against that bound:
//  * A block owns WORD_ROWS whole rows and walks the byte axis itself, so a
//    row's sum never leaves the block: no atomics, no second pass (the TPU
//    kernel's revisited output block has no counterpart here).
//  * Thread t reads 4-byte words t, t + 256, ... of each of its rows, all
//    WORD_ROWS of them before decoding any: WORD_ROWS loads in flight a
//    thread.  Row j starts at byte j nb, which is 4-byte aligned only when
//    nb % 4 == 0 (a sample count n = 487,409 gives nb % 4 = 1).  Aligned
//    rows read each word with one load.  Otherwise a row's word is read as
//    the two aligned words it straddles, joined by one funnel shift by the
//    row's offset, and a row's first word and its last one or two are
//    read byte by byte, with bytes past the row read as zero, so that no
//    load leaves the tensor.  The launch picks the load from the row
//    alignment (the ALIGNED flag): the one-load path is the faster, and
//    PERF.md has the times of both.  The decode is the same for both.
//  * u is read once per block and column step (from L2) and used for all
//    the block's rows in registers: its L2 traffic is about the packed
//    bytes (f32), not 16x them as one pass per row would be.
//  * A code becomes a float by the exponent trick: one byte permute puts it
//    into the mantissa of 1.5 * 2^23, one subtract removes that; I2F runs
//    at an eighth of the FP32 rate.  The products use explicit fma, exact
//    for the codes, so the build's -fmad=false does not split them.
//  * The NA test is one AND per word (x & x >> 1 & 0x55.. marks the code-3
//    lanes); only a word that holds an NA takes the select.  It is compiled
//    out for K4.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int SNP_THREADS = 256;
constexpr int WORD_ROWS = 16;  // rows a block owns

template <typename T> struct Num;
template <> struct Num<float> {
  // byte k of `plane` (a code 0..3) as a float: one byte permute builds
  // 0x4B4000cc from it and the exponent bytes (0x4B400000 is 1.5 * 2^23,
  // whose ulp is 1)
  static __device__ __forceinline__ float code_of_byte(uint32_t plane,
                                                       int k) {
    return __int_as_float(__byte_perm(plane, 0x4B400000u, 0x7640 | k)) -
           12582912.0f;
  }
  static __device__ __forceinline__ float fma(float a, float b, float c) {
    return __fmaf_rn(a, b, c);
  }
  // the 16 entries of u that 4-byte word w of a row meets
  static __device__ __forceinline__ void load_u16(const float* u, int64_t w,
                                                  float* v) {
    const float4* q = reinterpret_cast<const float4*>(u) + 4 * w;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float4 x = __ldg(q + k);
      v[4 * k] = x.x; v[4 * k + 1] = x.y; v[4 * k + 2] = x.z;
      v[4 * k + 3] = x.w;
    }
  }
};
template <> struct Num<double> {
  // the same with 0x4338000000000000, 1.5 * 2^52
  static __device__ __forceinline__ double code_of_byte(uint32_t plane,
                                                        int k) {
    return __hiloint2double(0x43380000,
                            (int)__byte_perm(plane, 0u, 0x4440 | k)) -
           6755399441055744.0;
  }
  static __device__ __forceinline__ double fma(double a, double b, double c) {
    return __fma_rn(a, b, c);
  }
  static __device__ __forceinline__ void load_u16(const double* u, int64_t w,
                                                  double* v) {
    const double2* q = reinterpret_cast<const double2*>(u) + 8 * w;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const double2 x = __ldg(q + k);
      v[2 * k] = x.x; v[2 * k + 1] = x.y;
    }
  }
};

// The block's WORD_ROWS row sums: reduce each thread's partials over the
// block and write out[j0 + r] for r < rows.
template <typename T>
__device__ __forceinline__ void write_rows(const T* acc,
                                           T (*part)[WORD_ROWS], T* out,
                                           int64_t j0, int rows) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < WORD_ROWS; ++r) {
    T s = acc[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) part[warp][r] = s;
  }
  __syncthreads();
  if ((int)threadIdx.x < rows) {
    T s = T(0);
#pragma unroll
    for (int w = 0; w < SNP_THREADS / 32; ++w) s += part[w][threadIdx.x];
    out[j0 + threadIdx.x] = s;
  }
}

// Bytes pos .. pos + 3 of the row that starts at byte `row0` of `packed`,
// read as the two aligned words they straddle joined by a funnel shift.
// Needs 4 <= pos and pos + 8 <= nb, so that both words lie in the row.
__device__ __forceinline__ uint32_t row_word(
    const uint8_t* __restrict__ packed, int64_t row0, int64_t pos) {
  const uintptr_t addr = (uintptr_t)(packed + row0 + pos);
  const uint32_t* lo = reinterpret_cast<const uint32_t*>(addr & ~uintptr_t(3));
  return __funnelshift_r(__ldg(lo), __ldg(lo + 1), 8 * (int)(addr & 3));
}

// The same for any pos < nb, byte by byte; bytes at or past the row's end
// read as zero.
__device__ __forceinline__ uint32_t row_word_edge(
    const uint8_t* __restrict__ packed, int64_t row0, int64_t pos,
    int64_t nb) {
  uint32_t x = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (pos + k < nb) x |= (uint32_t)__ldg(packed + row0 + pos + k) << (8 * k);
  return x;
}

// Word w of a row holds samples 16 w + q at bits 2 q.  An NA is first summed
// as the code 3 and then corrected by (impute - 3) u, in a branch taken only
// for words that hold one.
template <typename T, bool HAS_NA, bool ALIGNED>
__global__ void __launch_bounds__(SNP_THREADS, 2)
snp_mul_kernel(const uint8_t* __restrict__ packed, const T* __restrict__ u_pad,
               const T* __restrict__ impute, T* __restrict__ out, int64_t p,
               int64_t nb) {
  __shared__ T imp_s[WORD_ROWS];
  __shared__ T part[SNP_THREADS / 32][WORD_ROWS];

  const int64_t j0 = (int64_t)blockIdx.x * WORD_ROWS;
  const int rows = (int)(p - j0 < WORD_ROWS ? p - j0 : WORD_ROWS);
  if (HAS_NA) {
    const int t = threadIdx.x;
    if (t < WORD_ROWS) imp_s[t] = t < rows ? impute[j0 + t] : T(0);
    __syncthreads();
  }
  const int64_t nw = (nb + 3) >> 2;
  // the first byte of row r of the block; rows past p re-read row j0, and
  // their sums are never written
  auto row0 = [&](int r) { return (j0 + (r < rows ? r : 0)) * nb; };

  T acc[WORD_ROWS];
#pragma unroll
  for (int r = 0; r < WORD_ROWS; ++r) acc[r] = T(0);

  for (int64_t w = threadIdx.x; w < nw; w += SNP_THREADS) {
    // Unaligned rows: the first and last words of a row go byte by byte;
    // the test is the same for all rows, so the loads of the others are
    // issued together, before any is decoded.
    const int64_t pos = 4 * w;
    uint32_t word[WORD_ROWS];
    if (ALIGNED) {
#pragma unroll
      for (int r = 0; r < WORD_ROWS; ++r)
        word[r] = __ldg(
            reinterpret_cast<const uint32_t*>(packed + row0(r)) + w);
    } else if (pos >= 4 && pos + 8 <= nb) {
#pragma unroll
      for (int r = 0; r < WORD_ROWS; ++r)
        word[r] = row_word(packed, row0(r), pos);
    } else {
#pragma unroll
      for (int r = 0; r < WORD_ROWS; ++r)
        word[r] = row_word_edge(packed, row0(r), pos, nb);
    }
    T u[16];
    Num<T>::load_u16(u_pad, w, u);
#pragma unroll
    for (int r = 0; r < WORD_ROWS; ++r) {
      const uint32_t x = word[r];
      T s = acc[r];
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        // plane l: the code of sample 4 k + l in byte k
        const uint32_t plane = (x >> (2 * l)) & 0x03030303u;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          s = Num<T>::fma(Num<T>::code_of_byte(plane, k), u[4 * k + l], s);
      }
      if (HAS_NA) {
        const uint32_t na = x & (x >> 1) & 0x55555555u;
        if (na) {
          const T d = imp_s[r] - T(3);
#pragma unroll
          for (int q = 0; q < 16; ++q)
            if ((na >> (2 * q)) & 1u) s = Num<T>::fma(d, u[q], s);
        }
      }
      acc[r] = s;
    }
  }
  write_rows<T>(acc, part, out, j0, rows);
}

template <typename T, bool HAS_NA>
int launch_snp_mul(const void* packed, const void* u_pad, const void* impute,
                   void* out, int64_t p, int64_t nb, void* stream) {
  if (p < 1 || nb < 1) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (p + WORD_ROWS - 1) / WORD_ROWS;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  auto kernel = nb % 4 == 0 && (uintptr_t)packed % 4 == 0
                    ? snp_mul_kernel<T, HAS_NA, true>
                    : snp_mul_kernel<T, HAS_NA, false>;
  kernel<<<(unsigned)blocks, SNP_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)packed, (const T*)u_pad, (const T*)impute, (T*)out, p,
      nb);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int adelie_snp_mul_f32(const void* packed, const void* u_pad,
                       const void* impute, void* out, int64_t p, int64_t nb,
                       void* stream) {
  return launch_snp_mul<float, true>(packed, u_pad, impute, out, p, nb,
                                     stream);
}

int adelie_snp_mul_f64(const void* packed, const void* u_pad,
                       const void* impute, void* out, int64_t p, int64_t nb,
                       void* stream) {
  return launch_snp_mul<double, true>(packed, u_pad, impute, out, p, nb,
                                      stream);
}

int adelie_snp_mul_no_na_f32(const void* packed, const void* u_pad, void* out,
                             int64_t p, int64_t nb, void* stream) {
  return launch_snp_mul<float, false>(packed, u_pad, nullptr, out, p, nb,
                                      stream);
}

int adelie_snp_mul_no_na_f64(const void* packed, const void* u_pad, void* out,
                             int64_t p, int64_t nb, void* stream) {
  return launch_snp_mul<double, false>(packed, u_pad, nullptr, out, p, nb,
                                       stream);
}

}  // extern "C"
