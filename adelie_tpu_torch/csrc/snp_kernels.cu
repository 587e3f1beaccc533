// Packed-SNP decode-matmul kernels for Hopper (sm_90a).
//
// Two kernels, templated on the value type (float, double: the H100 has
// native FP64), with a plain C interface loaded by ctypes from
// adelie_tpu_torch/matrix/snp_kernels.py.  Every entry point launches on the
// caller's stream, allocates nothing and returns cudaGetLastError().
//
//   adelie_snp_mul_{f32,f64}        (HAS_NA = true) replaces K3,
//       adelie_tpu/matrix/_snp_pallas.py:snp_mul_pallas;
//   adelie_snp_mul_no_na_{f32,f64}  (HAS_NA = false) replaces K4,
//       adelie_tpu/matrix/_snp_pallas.py:snp_mul_pallas_no_na;
//   adelie_snp_mul_many_{f32,f64}   replaces K5,
//       adelie_tpu/matrix/_snp_pallas.py:snp_mul_many_pallas (its own
//       notes are further down, above snp_mul_many_kernel).
//
// The notes below are K3's and K4's.
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

// ---------------------------------------------------------------------------
// K5: snp_mul_many, C residuals in one pass over a tile of packed rows.
//
//   adelie_snp_mul_many_{f32,f64} replaces K5,
//       adelie_tpu/matrix/_snp_pallas.py:snp_mul_many_pallas.
//
// What it computes: out[j, c] = sum_i x(j, i) ut[i, c] for j < rows, c < C,
// with x(j, i) decoded as in K3 (a code 3 reads impute[j]).  ut is U^T, the
// C residuals laid out sample-major: 16 ceil(nb / 4) rows of Cp values, zero
// past the sample count n and past column C, so tail codes and padded
// columns contribute nothing.  Cp is C rounded up to the block's column
// width CN (8, 32 or 128 by C, see many_cols); the caller asks
// adelie_snp_mul_many_cols for it.
//
// Bound on the H100 (3.35 TB/s, 67 TFLOP/s FP32): it is a GEMM,
// (rows x n) . (n x C), whose A operand is decoded from 2-bit codes as it is
// loaded.  At the north-star tile (rows = 65,536, n = 100,000, C = 100) it
// reads 1.64 GB (0.49 ms) and does 2 rows n C = 1.31e12 operations
// (19.6 ms): bound by the FP32 operations, unlike K3 and K4.
//
// Design, simple first (wgmma, TMA rings and a persistent grid are later
// work):
//  * A block owns ROWS whole rows and CN columns and walks the byte axis
//    itself: no atomics, no second pass.  For C <= 128 one block covers
//    every column, so the packed bytes are read once; above, each column
//    block re-reads them.
//  * A step is one 4-byte word of each row (16 samples).  Thread t < ROWS
//    loads row t's word (one load when rows are 4-byte aligned, the
//    funnel-shift or byte-wise read of K3 when not), decodes its 16 codes
//    with K3's exponent trick and per-word NA select, and stores them to
//    shared memory once; the block stages the 16 x CN slice of ut beside
//    them.  The next step's word and ut slice are loaded into registers
//    before the current step's products, so their latency hides behind
//    them.
//  * Each thread keeps a TR x 8 register tile of outputs: a decoded code is
//    read from shared memory once per 8 columns, a ut value once per TR
//    rows.  Columns tx*4 .. +3 and CN/2 + tx*4 .. +3 keep the threads'
//    shared loads on distinct banks.  Products use explicit fma, so the
//    build's -fmad=false does not split them.

constexpr int MANY_THREADS = 256;
constexpr int MANY_KS = 16;  // samples a step: one 4-byte word of a row

template <typename T, int TR, int CG, bool ALIGNED>
__global__ void __launch_bounds__(MANY_THREADS)
snp_mul_many_kernel(const uint8_t* __restrict__ packed,
                    const T* __restrict__ ut, const T* __restrict__ impute,
                    T* __restrict__ out, int64_t p, int64_t nb, int64_t C,
                    int64_t Cp) {
  constexpr int RG = MANY_THREADS / CG;  // row groups of TR rows
  constexpr int ROWS = RG * TR;          // rows a block owns
  constexpr int CN = CG * 8;             // columns a block owns
  constexpr int HALF = CN / 2;
  constexpr int B_LD = (MANY_KS * CN + MANY_THREADS - 1) / MANY_THREADS;
  static_assert(ROWS <= MANY_THREADS, "one loading thread a row");
  __shared__ __align__(16) T as[MANY_KS][ROWS];
  __shared__ __align__(16) T bs[MANY_KS][CN];

  const int tid = threadIdx.x;
  const int tx = tid % CG, ty = tid / CG;
  const int64_t j0 = (int64_t)blockIdx.x * ROWS;
  const int64_t c0 = (int64_t)blockIdx.y * CN;
  const int rows = (int)(p - j0 < ROWS ? p - j0 : ROWS);
  const int64_t nw = (nb + 3) >> 2;

  // thread tid < ROWS loads row tid; rows past p re-read row j0, and their
  // sums are never written
  const bool loader = tid < ROWS;
  const int64_t row0 = (j0 + (tid < rows ? tid : 0)) * nb;
  const T imp = loader && tid < rows ? impute[j0 + tid] : T(0);

  auto load_word = [&](int64_t w) -> uint32_t {
    if (!loader) return 0u;
    const int64_t pos = 4 * w;
    if (ALIGNED)
      return __ldg(reinterpret_cast<const uint32_t*>(packed + row0) + w);
    if (pos >= 4 && pos + 8 <= nb) return row_word(packed, row0, pos);
    return row_word_edge(packed, row0, pos, nb);
  };
  auto load_b = [&](int64_t w, T* ub) {
#pragma unroll
    for (int i = 0; i < B_LD; ++i) {
      const int idx = tid + i * MANY_THREADS;
      if (idx < MANY_KS * CN)
        ub[i] = __ldg(ut + (MANY_KS * w + idx / CN) * Cp + c0 + idx % CN);
    }
  };

  T acc[TR][8];
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = T(0);

  uint32_t word = load_word(0);
  T ub[B_LD];
  load_b(0, ub);

  for (int64_t w = 0; w < nw; ++w) {
    if (loader) {
      // sample q of the word sits at bits 2 q: byte q / 4 of plane q % 4
      T v[MANY_KS];
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        const uint32_t plane = (word >> (2 * l)) & 0x03030303u;
#pragma unroll
        for (int k = 0; k < 4; ++k) v[4 * k + l] = Num<T>::code_of_byte(plane, k);
      }
      const uint32_t na = word & (word >> 1) & 0x55555555u;
      if (na) {
#pragma unroll
        for (int q = 0; q < MANY_KS; ++q)
          if ((na >> (2 * q)) & 1u) v[q] = imp;
      }
#pragma unroll
      for (int q = 0; q < MANY_KS; ++q) as[q][tid] = v[q];
    }
#pragma unroll
    for (int i = 0; i < B_LD; ++i) {
      const int idx = tid + i * MANY_THREADS;
      if (idx < MANY_KS * CN) bs[idx / CN][idx % CN] = ub[i];
    }
    __syncthreads();
    if (w + 1 < nw) {
      word = load_word(w + 1);
      load_b(w + 1, ub);
    }
#pragma unroll
    for (int k = 0; k < MANY_KS; ++k) {
      T a[TR], b[8];
#pragma unroll
      for (int i = 0; i < TR; ++i) a[i] = as[k][ty * TR + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b[j] = bs[k][tx * 4 + j];
        b[4 + j] = bs[k][HALF + tx * 4 + j];
      }
#pragma unroll
      for (int i = 0; i < TR; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc[i][j] = Num<T>::fma(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int r = ty * TR + i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int64_t c = c0 + (j < 4 ? tx * 4 + j : HALF + tx * 4 + j - 4);
      if (c < C) out[(j0 + r) * C + c] = acc[i][j];
    }
  }
}

// The column width CN a block owns for C residuals (the wrapper pads ut to
// a multiple of it): 8 for C <= 8 (256 rows a block, one output row a
// thread), 32 for C <= 32 (256 rows), else 128 (64 rows).
int64_t many_cols(int64_t C) { return C <= 8 ? 8 : C <= 32 ? 32 : 128; }

template <typename T, int TR, int CG>
int launch_many_cfg(const void* packed, const void* ut, const void* impute,
                    void* out, int64_t p, int64_t nb, int64_t C, int64_t Cp,
                    cudaStream_t stream) {
  constexpr int ROWS = MANY_THREADS / CG * TR;
  const int64_t bx = (p + ROWS - 1) / ROWS;
  const int64_t by = Cp / (CG * 8);
  if (bx > INT_MAX || by > 65535) return (int)cudaErrorInvalidValue;
  auto kernel = nb % 4 == 0 && (uintptr_t)packed % 4 == 0
                    ? snp_mul_many_kernel<T, TR, CG, true>
                    : snp_mul_many_kernel<T, TR, CG, false>;
  kernel<<<dim3((unsigned)bx, (unsigned)by), MANY_THREADS, 0, stream>>>(
      (const uint8_t*)packed, (const T*)ut, (const T*)impute, (T*)out, p, nb,
      C, Cp);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_snp_mul_many(const void* packed, const void* ut, const void* impute,
                        void* out, int64_t p, int64_t nb, int64_t C,
                        int64_t Cp, void* stream) {
  if (p < 1 || nb < 1 || C < 1) return (int)cudaErrorInvalidValue;
  const int64_t cn = many_cols(C);
  if (Cp != (C + cn - 1) / cn * cn) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (cn == 8)
    return launch_many_cfg<T, 1, 1>(packed, ut, impute, out, p, nb, C, Cp, s);
  if (cn == 32)
    return launch_many_cfg<T, 4, 4>(packed, ut, impute, out, p, nb, C, Cp, s);
  return launch_many_cfg<T, 4, 16>(packed, ut, impute, out, p, nb, C, Cp, s);
}

}  // namespace

extern "C" {

// the column count Cp the caller pads U^T to for C residuals
int64_t adelie_snp_mul_many_cols(int64_t C) {
  const int64_t cn = many_cols(C);
  return (C + cn - 1) / cn * cn;
}

int adelie_snp_mul_many_f32(const void* packed, const void* ut_pad,
                            const void* impute, void* out, int64_t p,
                            int64_t nb, int64_t C, int64_t Cp, void* stream) {
  return launch_snp_mul_many<float>(packed, ut_pad, impute, out, p, nb, C, Cp,
                                    stream);
}

int adelie_snp_mul_many_f64(const void* packed, const void* ut_pad,
                            const void* impute, void* out, int64_t p,
                            int64_t nb, int64_t C, int64_t Cp, void* stream) {
  return launch_snp_mul_many<double>(packed, ut_pad, impute, out, p, nb, C,
                                     Cp, stream);
}

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
