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
// that with HAS_NA a code 3 (NA) reads impute[j].  u_pad has 256 ceil(nb /
// 64) entries, zero past the sample count n, so tail codes (a code 3 among
// them) contribute x * 0 = 0.
//
// Bound on the H100 (3.35 TB/s, 67 TFLOP/s FP32): bytes p nb + 4 (4 nb)
// + 4 p (+ 4 p impute), operations 2 p n.  At the GWAS shape (p = 200,000,
// n = 50,000: 2.5 GB of packed bytes) that is 0.75 ms of bytes against
// 0.30 ms of operations: the kernel is bound by the packed bytes it reads.
// Decoding every code (a byte permute, an FADD and an FFMA a code, a
// shift and mask every four: about 3.5 instructions a code) is 3.5e10
// instructions at the GWAS shape, more than a millisecond of issue on 132
// SMs, past that bound.
//
// Design: one lookup in shared memory a byte, not four decodes.
//  * A stage is G bytes of every row, 4 G samples.  For each stage the
//    block builds a table from u: for byte value b and byte position g,
//    T[b][g] = sum_k code_k(b) u[4 g + k], as T_lo[b & 15] + T_hi[b >> 4]
//    (two samples a half), with a code 3 counted as 0 when HAS_NA, and
//    beside it NA[b][g] = sum_k [code_k(b) = 3] u[4 g + k].  An entry (the
//    value, or the pair (value, NA)) takes 256 / G bytes, so a table row is
//    256 bytes and the table 64 KB: G = 64 for K4 in float32, 32 for K3 in
//    float32 and K4 in float64, 16 for K3 in float64.  Then
//    out[j] = value_j + impute[j] NA_j, and with integer inputs every sum
//    is exact, so the kernel and its twin agree bit for bit.
//  * A row's stage is read as G / 4 words by G / 4 neighbouring lanes.  A
//    byte's lookup address is one byte permute, b 256 + g (256 / G)
//    (the permute puts the byte above the lane's own offset byte); then
//    one shared load and one FADD (two with NA): about 0.8 instructions a
//    code for K4 and 1.1 for K3, and one 4-, 8- or 16-byte shared load a
//    byte.  Each lane walks the four bytes of its word rotated by its own
//    amount, so the 32 lanes of a warp (16 and 8 for 8- and 16-byte
//    entries, the width of a shared-memory wavefront) read distinct banks
//    whatever the byte values.
//  * A block owns R = NW 1024 / G rows (NW = 16 words a lane a stage)
//    and walks the byte axis
//    itself, so a row's sum never leaves the block: no atomics, no second
//    pass.  A stage's build costs about two instructions an entry, 256 G
//    entries against R G bytes of lookups, a third to a half of the
//    lookups' issue.
//  * A lane loads its NW words of the next stage while the current stage
//    is built and looked up: R G bytes of every block in flight.  Aligned
//    rows (nb % 4 = 0) read a word with one load; others read the two
//    aligned words it straddles, joined by one funnel shift, and a row's
//    first word and its last one or two byte by byte, with bytes past the
//    row read as zero, so that no load leaves the tensor.
// On the card (PERF.md) the stages' builds and barriers, not the bytes,
// set the time: K3 at the GWAS shape runs at about 2.4 times its bound,
// and narrower stages (an NA half built only when a stage holds an NA,
// 32 bytes a stage without it) measured slower, not faster.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "async_copy.cuh"

namespace {

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
};

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

constexpr int SNP_THREADS = 256;
constexpr int NW = 16;  // words a lane a stage: rows a block NW RPS
constexpr int TAB_BYTES = 256 * 256;  // a stage's table: 256 rows of 256 B

// a table entry: the value, or the pair (value, NA sum)
template <typename T, bool HAS_NA> struct Entry;
template <> struct Entry<float, false> {
  using type = float;
  static __device__ __forceinline__ float value(float e) { return e; }
  static __device__ __forceinline__ float na(float) { return 0.0f; }
  static __device__ __forceinline__ float make(float v, float) { return v; }
};
template <> struct Entry<float, true> {
  using type = float2;
  static __device__ __forceinline__ float value(float2 e) { return e.x; }
  static __device__ __forceinline__ float na(float2 e) { return e.y; }
  static __device__ __forceinline__ float2 make(float v, float n) {
    return make_float2(v, n);
  }
};
template <> struct Entry<double, false> {
  using type = double;
  static __device__ __forceinline__ double value(double e) { return e; }
  static __device__ __forceinline__ double na(double) { return 0.0; }
  static __device__ __forceinline__ double make(double v, double) {
    return v;
  }
};
template <> struct Entry<double, true> {
  using type = double2;
  static __device__ __forceinline__ double value(double2 e) { return e.x; }
  static __device__ __forceinline__ double na(double2 e) { return e.y; }
  static __device__ __forceinline__ double2 make(double v, double n) {
    return make_double2(v, n);
  }
};

template <typename T, bool HAS_NA>
struct TabShape {
  static constexpr int ESZ = (int)sizeof(typename Entry<T, HAS_NA>::type);
  static constexpr int G = 256 / ESZ;      // bytes of a row a stage
  static constexpr int LPR = G / 4;        // lanes a row, a word each
  static constexpr int RPW = 32 / LPR;     // rows of a warp a load
  static constexpr int RPS = RPW * SNP_THREADS / 32;  // rows a block a load
};

template <typename T, bool HAS_NA, bool ALIGNED>
__global__ void __launch_bounds__(SNP_THREADS, 2)
snp_mul_kernel(const uint8_t* __restrict__ packed, const T* __restrict__ u_pad,
               const T* __restrict__ impute, T* __restrict__ out, int64_t p,
               int64_t nb) {
  using Ent = Entry<T, HAS_NA>;
  using E = typename Ent::type;
  using Sh = TabShape<T, HAS_NA>;
  constexpr int ESZ = Sh::ESZ, G = Sh::G, LPR = Sh::LPR, RPW = Sh::RPW,
                RPS = Sh::RPS;
  constexpr int HQ = SNP_THREADS / G;  // threads that build one position
  constexpr int NH = 16 / HQ;          // high nibbles a thread builds
  extern __shared__ __align__(16) unsigned char tab[];

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int rw = lane / LPR;  // the lane's row within the warp's load
  const int jl = lane % LPR;  // its word within the row's stage
  // Bank rotation: a shared-memory wavefront is two rows of G / 4 lanes;
  // lane (rw & 1, jl) takes byte (k + kq) & 3 of its word at step k, so
  // the wavefront's lanes read entries g = 4 jl + (k + kq) & 3 that are
  // distinct modulo G / 2, on distinct banks.
  const int kq = (jl / (G / 8) + 2 * (rw & 1)) & 3;
  uint32_t cofs[4];  // the entry's byte offset in a table row at step k
#pragma unroll
  for (int k = 0; k < 4; ++k)
    cofs[k] = (uint32_t)((4 * jl + ((k + kq) & 3)) * ESZ);

  const int64_t j0 = (int64_t)blockIdx.x * (NW * RPS);
  const int64_t jw = j0 + warp * RPW + rw;  // the lane's row in slot 0
  // rows past p re-read row p - 1, and their sums are never written
  auto row0 = [&](int i) {
    const int64_t j = jw + (int64_t)i * RPS;
    return (j < p ? j : p - 1) * nb;
  };
  auto load_stage = [&](int64_t s, uint32_t* w) {
    const int64_t pos = s * G + 4 * jl;
    if (ALIGNED) {
#pragma unroll
      for (int i = 0; i < NW; ++i)
        w[i] = pos < nb ? __ldg(reinterpret_cast<const uint32_t*>(
                              packed + row0(i) + pos))
                        : 0u;
    } else if (pos >= 4 && pos + 8 <= nb) {
#pragma unroll
      for (int i = 0; i < NW; ++i) w[i] = row_word(packed, row0(i), pos);
    } else {
#pragma unroll
      for (int i = 0; i < NW; ++i)
        w[i] = row_word_edge(packed, row0(i), pos, nb);
    }
  };

  // The table of stage s: thread t builds byte position g = t % G for the
  // high nibbles h = t / G + HQ m, all 16 low nibbles each.
  auto build = [&](int64_t s) {
    const int g = t % G;
    const int hq = t / G;
    const T* us = u_pad + (s * G + g) * 4;
    T u[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) u[k] = us[k];
    // code c of sample k: its value, and its share of the NA sum
    auto val = [&](int c, int k) {
      return (HAS_NA && c == 3) ? T(0) : T(c) * u[k];
    };
    auto nas = [&](int c, int k) { return c == 3 ? u[k] : T(0); };
    T lo_v[16], lo_n[16];
#pragma unroll
    for (int b = 0; b < 16; ++b) {
      lo_v[b] = val(b & 3, 0) + val(b >> 2, 1);
      lo_n[b] = nas(b & 3, 0) + nas(b >> 2, 1);
    }
    unsigned char* col = tab + g * ESZ;
#pragma unroll
    for (int m = 0; m < NH; ++m) {
      const int h = hq + HQ * m;
      const T hi_v = val(h & 3, 2) + val(h >> 2, 3);
      const T hi_n = nas(h & 3, 2) + nas(h >> 2, 3);
#pragma unroll
      for (int b = 0; b < 16; ++b)
        *reinterpret_cast<E*>(col + (16 * h + b) * 256) =
            Ent::make(lo_v[b] + hi_v, lo_n[b] + hi_n);
    }
  };

  T acc[NW], acc_na[NW];
#pragma unroll
  for (int i = 0; i < NW; ++i) acc[i] = acc_na[i] = T(0);
  uint32_t word[NW], next[NW];
  load_stage(0, word);
  const int64_t ns = (nb + G - 1) / G;
  for (int64_t s = 0; s < ns; ++s) {
    __syncthreads();  // the table of the stage before has been read
    if (s + 1 < ns) load_stage(s + 1, next);
    build(s);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      const uint32_t x = __funnelshift_r(word[i], word[i], 8 * kq);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        // (byte k of x) 256 + cofs[k]: the entry's address in the table
        const uint32_t at = __byte_perm(x, cofs[k], 0x6504u | (k << 4));
        const E e = *reinterpret_cast<const E*>(tab + at);
        acc[i] = acc[i] + Ent::value(e);
        if (HAS_NA) acc_na[i] = acc_na[i] + Ent::na(e);
      }
    }
#pragma unroll
    for (int i = 0; i < NW; ++i) word[i] = next[i];
  }

  // a row's sum over its LPR lanes, then out = value + impute NA
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    T v = acc[i], na = acc_na[i];
#pragma unroll
    for (int off = LPR / 2; off > 0; off >>= 1) {
      v += __shfl_xor_sync(0xffffffffu, v, off);
      if (HAS_NA) na += __shfl_xor_sync(0xffffffffu, na, off);
    }
    const int64_t j = jw + (int64_t)i * RPS;
    if (jl == 0 && j < p) out[j] = HAS_NA ? v + impute[j] * na : v;
  }
}

template <typename T, bool HAS_NA, bool ALIGNED>
int launch_snp_mul_rows(const uint8_t* packed, const T* u_pad,
                        const T* impute, T* out, int64_t p, int64_t nb,
                        cudaStream_t stream) {
  constexpr int R = NW * TabShape<T, HAS_NA>::RPS;
  const int64_t blocks = (p + R - 1) / R;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  auto kernel = snp_mul_kernel<T, HAS_NA, ALIGNED>;
  // the 64 KB table is dynamic shared memory, opted into once a kernel
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TAB_BYTES);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  kernel<<<(unsigned)blocks, SNP_THREADS, TAB_BYTES, stream>>>(
      packed, u_pad, impute, out, p, nb);
  return (int)cudaGetLastError();
}

template <typename T, bool HAS_NA>
int launch_snp_mul(const void* packed, const void* u_pad, const void* impute,
                   void* out, int64_t p, int64_t nb, void* stream) {
  if (p < 1 || nb < 1 || ((uintptr_t)u_pad & 15))
    return (int)cudaErrorInvalidValue;
  const auto* pk = (const uint8_t*)packed;
  cudaStream_t st = (cudaStream_t)stream;
  return nb % 4 == 0 && (uintptr_t)packed % 4 == 0
             ? launch_snp_mul_rows<T, HAS_NA, true>(pk, (const T*)u_pad,
                                                    (const T*)impute, (T*)out,
                                                    p, nb, st)
             : launch_snp_mul_rows<T, HAS_NA, false>(pk, (const T*)u_pad,
                                                     (const T*)impute,
                                                     (T*)out, p, nb, st);
}

// ---------------------------------------------------------------------------
// K5: snp_mul_many, C residuals in one pass over a tile of packed rows.
//
//   adelie_snp_mul_many_{f32,f64} replaces K5,
//       adelie_tpu/matrix/_snp_pallas.py:snp_mul_many_pallas.
//
// What it computes: out[j, c] = sum_i x(j, i) U[c, i] for j < rows, c < C,
// with x(j, i) decoded as in K3 (a code 3 reads impute[j]).  The residuals
// come as the operand `ut`: U^T cut into Cp / CN column blocks of CN
// columns, each block sample-major (n_pad rows of CN values, one sample a
// row), zero past the sample count n and past column C, so tail codes and
// padded columns contribute nothing.  CN is 2, 8, 32 or 64 by C
// (many_cols), Cp is C rounded up to it (adelie_snp_mul_many_cols), and
// n_pad = 64 ceil(nb / 16), whole stages of every row.
// matrix/snp_kernels.py:many_operand builds it, once a pass on the streamed
// path.
//
// Bound on the H100 (3.35 TB/s, 67 TFLOP/s FP32): it is a GEMM,
// (rows x n) . (n x C), whose A operand is decoded from 2-bit codes as it is
// loaded.  At the north-star tile (rows = 65,536, n = 100,000, C = 50) it
// reads 1.66 GB (0.49 ms) and does 2 rows n C = 6.55e11 operations
// (9.78 ms): bound by the FP32 operations, unlike K3 and K4.
//
// Order contract: every output is one fma chain over the samples in
// ascending order, from zero, through Num<T>::fma (the build has
// -fmad=false), in every column variant.  So a column's value does not
// depend on C (the streamed driver's dry fit at C = 1 and its chunk check
// at C = 50 meet the tie at lmda_max with the same bits), and the kernel is
// bit-equal to its twin on integer inputs, whose sums are exact.
//
// Design, on the CUDA cores: tensor cores would change the numerics, and
// on the north star the chunk pass waits on PCIe once K5 is under a tile's
// copy time (about 32-38 ms, PERF.md has the times).
//  * A block owns 256 whole rows and one column block and walks the sample
//    axis itself: no atomics, no second pass, no split of the sample axis.
//    Past 64 columns each column block re-reads and re-decodes the packed
//    bytes (1.6 GB at the north-star tile, half a millisecond of HBM).  The
//    column block is the grid's slow axis, so the blocks in flight share
//    one column block of U^T in L2 (25.6 MB at n = 100,000).
//  * A stage is 64 samples, 16 bytes of every row.  Thread t owns row t: it
//    loads the row's four words of the next stage into registers while the
//    current stage's products run (a stage is thousands of cycles, far
//    more than a load's latency), with K3's one-load, funnel-shift or
//    byte-wise read by the row's alignment (row_word, row_word_edge), and
//    decodes them by the exponent trick (Num::code_of_byte: one byte
//    permute puts a code into the mantissa of 1.5 2^23, one subtract
//    removes that) with a select for the words that hold an NA.
//  * The stage's slice of the column block of U^T is one contiguous run of
//    64 CN values.  Thread 0 fetches it with one bulk copy (TMA) into a
//    ring of RING stages, each completing on its own mbarrier
//    (async_copy.cuh), RING stages ahead of the products; one barrier a
//    stage frees a slot.
//  * Thread (tx, ty) keeps a TR x TC register tile of outputs over CG
//    column groups, TR = CG (CN = CG TC): 8 x 8 at CN = 64, 4 x 8 at 32.
//    The block's decoded codes go through a 64 x 256 tile of shared
//    memory (one more barrier a stage); per sample a thread reads TR codes
//    and TC U^T values in 16-byte loads and does TR TC fmas.  Columns
//    tx*TC/2 .. and CN/2 + tx*TC/2 .. keep a warp's loads of U^T on
//    distinct banks.
//  * At CN = 2 and 8 (C <= 8: the streamed driver's set-up and dry fits)
//    a thread owns a whole row, TR = 1, and its codes go from registers
//    straight into its TC products: no shared tile, no second barrier.
//    With so few columns the decode is most of the work, and a store, a
//    load and a barrier a code would cost more than the products.
//  * Shared memory at CN = 64: 64 KB of codes and RING x 16 KB of U^T in
//    float32 (RING = 4), 128 KB and 2 x 32 KB in float64: one block an SM.

constexpr int MANY_THREADS = 256;  // the rows a block owns, one a thread
constexpr int MANY_KS = 64;        // samples a stage: 16 bytes of a row
constexpr int MANY_WORDS = MANY_KS / 16;

// U^T stages in flight
template <typename T> constexpr int MANY_RING = sizeof(T) == 4 ? 4 : 2;

// dynamic shared memory of a block: the decoded codes, the U^T ring and its
// mbarriers
template <typename T, int CG, int TC>
constexpr int many_smem_bytes() {
  return ((CG == 1 ? 0 : MANY_KS * MANY_THREADS) +
          MANY_RING<T> * MANY_KS * CG * TC) *
             (int)sizeof(T) +
         MANY_RING<T> * (int)sizeof(uint64_t);
}

// N values at p in shared memory into v, in 16-byte loads when N fills
// whole vectors (p is then 16-byte aligned; 8-byte for two floats)
template <int N>
__device__ __forceinline__ void lds(const float* p, float* v) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 x = reinterpret_cast<const float4*>(p)[i];
      v[4 * i] = x.x; v[4 * i + 1] = x.y; v[4 * i + 2] = x.z;
      v[4 * i + 3] = x.w;
    }
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x; v[1] = x.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = p[i];
  }
}
template <int N>
__device__ __forceinline__ void lds(const double* p, double* v) {
  if constexpr (N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const double2 x = reinterpret_cast<const double2*>(p)[i];
      v[2 * i] = x.x; v[2 * i + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = p[i];
  }
}

// the 16 samples of a row's word x as values: sample q sits at bits 2 q,
// byte q / 4 of plane q % 4; a code 3 (NA) reads imp
template <typename T>
__device__ __forceinline__ void decode_word(uint32_t x, T imp, T* v) {
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    const uint32_t plane = (x >> (2 * l)) & 0x03030303u;
#pragma unroll
    for (int k = 0; k < 4; ++k) v[4 * k + l] = Num<T>::code_of_byte(plane, k);
  }
  const uint32_t na = x & (x >> 1) & 0x55555555u;
  if (na) {
#pragma unroll
    for (int q = 0; q < 16; ++q)
      if ((na >> (2 * q)) & 1u) v[q] = imp;
  }
}

template <typename T, int CG, int TC, bool ALIGNED>
__global__ void __launch_bounds__(MANY_THREADS)
snp_mul_many_kernel(const uint8_t* __restrict__ packed,
                    const T* __restrict__ ut, const T* __restrict__ impute,
                    T* __restrict__ out, int64_t p, int64_t nb, int64_t C) {
  constexpr int TR = CG;          // rows a thread owns
  constexpr int CN = TC * CG;     // columns a block owns
  constexpr int HALF = CN / 2, TH = TC / 2;
  constexpr int RING = MANY_RING<T>;
  constexpr int STAGE = MANY_KS * CN;  // U^T values a stage
  constexpr unsigned STAGE_BYTES = STAGE * sizeof(T);
  static_assert((MANY_THREADS / CG) * TR == MANY_THREADS, "a row a thread");
  extern __shared__ __align__(16) unsigned char smem_many[];
  // [MANY_KS][MANY_THREADS] codes (none when a thread owns a whole row),
  // then [RING][MANY_KS][CN] of U^T
  T* as = reinterpret_cast<T*>(smem_many);
  T* bs = as + (CG == 1 ? 0 : MANY_KS * MANY_THREADS);
  uint64_t* full = reinterpret_cast<uint64_t*>(bs + RING * STAGE);

  const int tid = threadIdx.x;
  const int tx = tid % CG, ty = tid / CG;
  const int64_t j0 = (int64_t)blockIdx.x * MANY_THREADS;
  const int rows = (int)(p - j0 < MANY_THREADS ? p - j0 : MANY_THREADS);
  const int64_t nst = (nb + 15) >> 4;  // stages
  // this block's column block of the operand: 64 nst rows of CN values
  const T* utb = ut + (int64_t)blockIdx.y * (MANY_KS * nst) * CN;

  // thread tid loads and decodes row tid; rows past p re-read row j0, and
  // their sums are never written
  const int64_t row0 = (j0 + (tid < rows ? tid : 0)) * nb;
  const T imp = tid < rows ? impute[j0 + tid] : T(0);

  if (tid == 0) {
    for (int i = 0; i < RING; ++i) mbar_init(&full[i], 1);
    mbar_init_fence();
    for (int i = 0; i < RING && i < nst; ++i) {
      mbar_expect_tx(&full[i], STAGE_BYTES);
      bulk_copy(bs + i * STAGE, utb + (int64_t)i * STAGE, STAGE_BYTES,
                &full[i]);
    }
  }
  __syncthreads();  // the mbarriers are initialised

  // the four words of row tid in stage s; bytes past the row read as zero
  auto load_stage = [&](int64_t s, uint32_t* w) {
#pragma unroll
    for (int q = 0; q < MANY_WORDS; ++q) {
      const int64_t pos = 16 * s + 4 * q;
      if (ALIGNED)
        w[q] = pos < nb ? __ldg(reinterpret_cast<const uint32_t*>(
                              packed + row0 + pos))
                        : 0u;
      else if (pos >= 4 && pos + 8 <= nb)
        w[q] = row_word(packed, row0, pos);
      else
        w[q] = row_word_edge(packed, row0, pos, nb);
    }
  };

  T acc[TR][TC];
#pragma unroll
  for (int i = 0; i < TR; ++i)
#pragma unroll
    for (int j = 0; j < TC; ++j) acc[i][j] = T(0);

  uint32_t w[MANY_WORDS];
  load_stage(0, w);
  for (int64_t s = 0; s < nst; ++s) {
    const int slot = (int)(s % RING);
    const T* b = bs + slot * STAGE;
    if constexpr (CG == 1) {
      // a row a thread and all CN columns: its codes go from registers
      // straight into the products
      uint32_t cur[MANY_WORDS];
#pragma unroll
      for (int q = 0; q < MANY_WORDS; ++q) cur[q] = w[q];
      if (s + 1 < nst) load_stage(s + 1, w);
      mbar_wait(&full[slot], (unsigned)(s / RING) & 1u);
#pragma unroll
      for (int q = 0; q < MANY_WORDS; ++q) {
        T v[16];
        decode_word<T>(cur[q], imp, v);
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          T bv[TC];
          lds<TC>(b + (16 * q + i) * CN, bv);
#pragma unroll
          for (int j = 0; j < TC; ++j)
            acc[0][j] = Num<T>::fma(v[i], bv[j], acc[0][j]);
        }
      }
    } else {
#pragma unroll
      for (int q = 0; q < MANY_WORDS; ++q) {
        T v[16];
        decode_word<T>(w[q], imp, v);
#pragma unroll
        for (int i = 0; i < 16; ++i)
          as[(16 * q + i) * MANY_THREADS + tid] = v[i];
      }
      if (s + 1 < nst) load_stage(s + 1, w);
      __syncthreads();  // the stage's codes are in `as`
      mbar_wait(&full[slot], (unsigned)(s / RING) & 1u);
#pragma unroll 8
      for (int k = 0; k < MANY_KS; ++k) {
        T av[TR], bv[TC];
        lds<TR>(as + k * MANY_THREADS + ty * TR, av);
        lds<TH>(b + k * CN + tx * TH, bv);
        lds<TH>(b + k * CN + HALF + tx * TH, bv + TH);
#pragma unroll
        for (int i = 0; i < TR; ++i)
#pragma unroll
          for (int j = 0; j < TC; ++j)
            acc[i][j] = Num<T>::fma(av[i], bv[j], acc[i][j]);
      }
    }
    __syncthreads();  // `as` and the slot are read
    if (tid == 0 && s + RING < nst) {
      fence_proxy_async();
      mbar_expect_tx(&full[slot], STAGE_BYTES);
      bulk_copy(bs + slot * STAGE, utb + (s + RING) * STAGE, STAGE_BYTES,
                &full[slot]);
    }
  }

  const int64_t c0 = (int64_t)blockIdx.y * CN;
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    const int r = ty * TR + i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      const int64_t c = c0 + (j < TH ? tx * TH + j : HALF + tx * TH + j - TH);
      if (c < C) out[(j0 + r) * C + c] = acc[i][j];
    }
  }
}

// The column width CN a block owns for C residuals (the operand is padded
// to a multiple of it): 2 for C <= 2 (the streamed driver's set-up and dry
// fits), 8 for C <= 8, 32 for C <= 32, else 64, in column blocks of 64
// past that.  At C = 50 and 100 the products are 1.28x those needed.
int64_t many_cols(int64_t C) {
  return C <= 2 ? 2 : C <= 8 ? 8 : C <= 32 ? 32 : 64;
}

// CG x TC: column groups of threads x columns a thread (CN = CG TC)
template <typename T, int CG, int TC>
int launch_many_cfg(const void* packed, const void* ut, const void* impute,
                    void* out, int64_t p, int64_t nb, int64_t C, int64_t Cp,
                    cudaStream_t stream) {
  constexpr int smem = many_smem_bytes<T, CG, TC>();
  const int64_t bx = (p + MANY_THREADS - 1) / MANY_THREADS;
  const int64_t by = Cp / (CG * TC);
  if (bx > INT_MAX || by > 65535) return (int)cudaErrorInvalidValue;
  auto kernel = nb % 4 == 0 && (uintptr_t)packed % 4 == 0
                    ? snp_mul_many_kernel<T, CG, TC, true>
                    : snp_mul_many_kernel<T, CG, TC, false>;
  // above 48 KB a block's dynamic shared memory must be opted into (on the
  // current device: set at every launch, it costs a microsecond)
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3((unsigned)bx, (unsigned)by), MANY_THREADS, smem, stream>>>(
      (const uint8_t*)packed, (const T*)ut, (const T*)impute, (T*)out, p, nb,
      C);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_snp_mul_many(const void* packed, const void* ut, const void* impute,
                        void* out, int64_t p, int64_t nb, int64_t C,
                        int64_t Cp, void* stream) {
  if (p < 1 || nb < 1 || C < 1) return (int)cudaErrorInvalidValue;
  const int64_t cn = many_cols(C);
  // the bulk copies need a 16-byte aligned operand
  if (Cp != (C + cn - 1) / cn * cn || (uintptr_t)ut % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (cn == 2)
    return launch_many_cfg<T, 1, 2>(packed, ut, impute, out, p, nb, C, Cp, s);
  if (cn == 8)
    return launch_many_cfg<T, 1, 8>(packed, ut, impute, out, p, nb, C, Cp, s);
  if (cn == 32)
    return launch_many_cfg<T, 4, 8>(packed, ut, impute, out, p, nb, C, Cp, s);
  return launch_many_cfg<T, 8, 8>(packed, ut, impute, out, p, nb, C, Cp, s);
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
