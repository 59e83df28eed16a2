// Shared pieces of the tensor-core attention kernels (flash_fwd.cu and
// flash_bwd.cu) for Hopper (sm_90a): the shared-memory layout of bf16 tiles,
// the PTX wrappers (cp.async, ldmatrix, mma.sync.m16n8k16 bf16 → f32), the
// tile copies and fragment loads built on them, the factored key-grid bias
// and its f32 slabs, and the host-side argument checks of the C entry points.
//
// Fragment layouts (m16n8k16, lane = 4·g4 + t4): an A fragment holds rows
// g4 and g4 + 8, columns 2·t4, 2·t4 + 1 and those + 8; a B fragment rows
// (depth) 2·t4, 2·t4 + 1 and those + 8 of column g4; the f32 C fragment
// rows g4 and g4 + 8, columns 2·t4 and 2·t4 + 1. Two neighbouring m16n8 C
// tiles, rounded to bf16, are one m16n8k16 A fragment.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr size_t SMEM_MAX = 232448;
typedef __nv_bfloat16 bf16;

constexpr int TC_ROWS = 64;       // rows per block of the backward kernels
constexpr int TC_NT = 128;        // threads per block: four warps
constexpr float LOG2E = 1.4426950408889634f;

// rows per streamed tile of the backward kernels: keys (dq) or queries (dkv)
template <int D>
struct Streamed {
  static constexpr int ROWS = D <= 64 ? 64 : 32;
};

// Element offset of (row, col) in a swizzled [rows][D] bf16 tile: the
// 16-byte chunk col / 8 of a row is XORed with the row's place among the
// eight rows that share one 128-byte span of banks.
template <int D>
__device__ __forceinline__ int swz(int row, int col) {
  constexpr int CPR = D / 8;                       // chunks per row
  constexpr int RPL = CPR >= 8 ? 1 : 8 / CPR;      // rows per 128 bytes
  constexpr int MASK = (CPR >= 8 ? 8 : CPR) - 1;
  return row * D + ((((col >> 3) ^ ((row / RPL) & MASK))) << 3) + (col & 7);
}

// The shared-memory layout of a bf16 tile of rows of D values: its row
// stride in elements and the offset of (row, col). D = 16, 32, 64, 128:
// rows of D values with swizzled chunks (swz). D = 80 and 96, ten and
// twelve 16-byte chunks, which a power-of-two XOR cannot permute within the
// row: rows padded by one chunk, to 88 and 104 values (176 and 208 bytes),
// no XOR. Row r then starts at bank 12·r or 20·r mod 32, so the eight
// consecutive rows of one ldmatrix phase cover all 32 banks once, and so
// do the eight rows × four lanes of a C-fragment store.
template <int D>
struct Tile {
  static constexpr int STRIDE = D;
  __device__ static __forceinline__ int off(int row, int col) {
    return swz<D>(row, col);
  }
};

template <int D>
struct PaddedTile {
  static constexpr int STRIDE = D + 8;
  __device__ static __forceinline__ int off(int row, int col) {
    return row * STRIDE + col;
  }
};

template <>
struct Tile<80> : PaddedTile<80> {};

template <>
struct Tile<96> : PaddedTile<96> {};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(in ? 8 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(in ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// four 8×8 bf16 matrices; lane t gives the address of row t % 8 of matrix
// t / 8 and receives, in register i, its two elements of matrix i
__device__ __forceinline__ void ldsm(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c (16×8 f32) += a (16×16 bf16, row-major) · b (16×8 bf16, column-major)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 → one register of two bf16, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the width a head dim D is computed at: mma.sync's depth is 16, so D is
// rounded up to a multiple of 16 (4, 8, 12 → 16; 24 → 32)
template <int D>
constexpr int DC = (D + 15) / 16 * 16;

// Copy rows [r0, r0 + ROWS) of a [n][DG] bf16 array into a tile laid out
// by Tile<D>; rows at or past n are zero-filled, and so are the columns at
// or past DG (DG < D: a head dim that is not a multiple of 16, widened in
// shared memory only). A row of DG values starts 16-byte aligned when DG
// is a multiple of 8 (16-byte copies, whole chunks past DG with no source
// bytes); at DG = 4 and 12 it is only 8-byte aligned, so each 16-byte chunk
// is two 8-byte copies, a half at or past DG with no source bytes.
template <int D, int ROWS, int DG = D>
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* src, int r0,
                                          int n, int tid) {
  constexpr int CPR = D / 8;
  static_assert(ROWS * CPR % TC_NT == 0, "whole chunks per thread");
  static_assert(DG % 4 == 0 && DG <= D, "whole 8-byte halves of chunks");
#pragma unroll
  for (int it = 0; it < ROWS * CPR / TC_NT; ++it) {
    const int i = tid + it * TC_NT;
    const int r = i / CPR, c = i % CPR;
    bool in = r0 + r < n;
    int col = c * 8;
    if constexpr (DG < D) {
      in = in && c < (DG + 7) / 8;
      col = in ? col : 0;
    }
    bf16* dst = tile + Tile<D>::off(r, c * 8);
    const bf16* from = src + (size_t)(in ? r0 + r : 0) * DG + col;
    if constexpr (DG % 8 != 0) {
      const bool hi = in && c * 8 + 4 < DG;   // the chunk's second half
      cp_async8(dst, from, in);
      cp_async8(dst + 4, hi ? from + 4 : from, hi);
    } else {
      cp_async16(dst, from, in);
    }
  }
}

// The A fragment (16×16, row-major) at rows r0.., cols c0.. of a tile.
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile,
                                       int r0, int c0, int lane) {
  ldsm(a, tile + Tile<D>::off(r0 + (lane & 15), c0 + ((lane >> 4) << 3)));
}

// The B fragments of two 8-column n-tiles (k 16 deep) from a tile stored
// [n][k] (rows are the product's columns): b[0], b[1] for n0..n0 + 7 and
// b[2], b[3] for n0 + 8..n0 + 15.
template <int D>
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[4], const bf16* tile,
                                          int n0, int k0, int lane) {
  ldsm(b, tile + Tile<D>::off(n0 + (lane & 7) + ((lane >> 4) << 3),
                              k0 + (((lane >> 3) & 1) << 3)));
}

// The same from a tile stored [k][n] (rows are the product's depth).
template <int D>
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4], const bf16* tile,
                                          int k0, int n0, int lane) {
  ldsm_t(b, tile + Tile<D>::off(k0 + (lane & 15), n0 + ((lane >> 4) << 3)));
}

// Write a warp's 16 × D f32 accumulators as bf16 into its rows r0.. of a
// tile, then copy the first DG columns of those rows to dst ([n][DG]) rows
// [g0, g0 + 16) below n with 16-byte stores (8-byte ones where DG is not a
// multiple of 8, whose rows are only 8-byte aligned). Columns at or past
// DG never leave the tile.
template <int D, int DG = D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 8][4],
                                           bf16* tile, int r0, bf16* dst,
                                           int g0, int n, int lane) {
  const int g4 = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = j * 8 + t4 * 2;
    *reinterpret_cast<uint32_t*>(tile + Tile<D>::off(r0 + g4, col)) =
        pack_bf16(acc[j][0], acc[j][1]);
    *reinterpret_cast<uint32_t*>(tile + Tile<D>::off(r0 + g4 + 8, col)) =
        pack_bf16(acc[j][2], acc[j][3]);
  }
  __syncwarp();
  constexpr int CPR = D / 8;
  static_assert(16 * CPR % 32 == 0, "whole chunks per lane");
#pragma unroll
  for (int it = 0; it < 16 * CPR / 32; ++it) {
    const int i = lane + it * 32;
    const int r = i / CPR, c = i % CPR;
    if constexpr (DG % 8 != 0) {
      if (g0 + r < n && c * 8 < DG) {
        bf16* to = dst + (size_t)(g0 + r) * DG + c * 8;
        const bf16* from = tile + Tile<D>::off(r0 + r, c * 8);
        *reinterpret_cast<uint2*>(to) = *reinterpret_cast<const uint2*>(from);
        if (c * 8 + 4 < DG)
          *reinterpret_cast<uint2*>(to + 4) =
              *reinterpret_cast<const uint2*>(from + 4);
      }
    } else if (g0 + r < n && (DG == D || c < DG / 8)) {
      *reinterpret_cast<uint4*>(dst + (size_t)(g0 + r) * DG + c * 8) =
          *reinterpret_cast<const uint4*>(tile + Tile<D>::off(r0 + r, c * 8));
    }
  }
}

constexpr int GB_D = 80;          // SAM-H's head dim, the grid-bias kernels'

// The factored key-grid bias.
struct GridBias {
  const float* h;   // bias_h (bh, sq, kh)
  const float* w;   // bias_w (bh, sq, kw)
  float* dh;        // dbias_h (bh, sq, kh), written by the dq kernel
  float* dw;        // dbias_w (bh, sq, kw), written by the dq kernel
  int kh, kw;
  bool vec;         // bias rows copied in 16-byte chunks: kh and kw are
                    // multiples of 4 and both bases 16-byte aligned
};

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }

// f32 row strides of the bias slabs. dq reads bias_w as float2 over four
// lanes and four rows per half-warp: a stride ≡ 8 (mod 32) puts the rows
// eight banks apart. dkv reads one float per lane from the rows of two
// neighbouring queries and eight keys' columns: ≡ 4 (mod 32) keeps them
// apart. Both hold at kw = 64 (72 and 68).
__host__ __device__ inline int gb_dq_stride(int cols) {
  return round4(cols) + 8;
}
__host__ __device__ inline int gb_dkv_stride(int cols) {
  return round4(cols) + 4;
}

// Copy columns [c0, c0 + cols) of rows [r0, r0 + TC_ROWS) of an (n, ld) f32
// array into a [TC_ROWS][stride] slab; rows at or past n are zero-filled.
// 16-byte copies when vec (ld, c0, cols and stride multiples of 4, the base
// 16-byte aligned), 4-byte ones otherwise.
__device__ __forceinline__ void load_rows_f32(float* dst, int stride,
                                              const float* src, int ld,
                                              int c0, int cols, int r0, int n,
                                              bool vec, int tid) {
  if (vec) {
    const int cpr = cols >> 2;
    for (int i = tid; i < TC_ROWS * cpr; i += TC_NT) {
      const int r = i / cpr, c = (i - r * cpr) << 2;
      const bool in = r0 + r < n;
      cp_async16(dst + r * stride + c,
                 src + (size_t)(in ? r0 + r : 0) * ld + c0 + c, in);
    }
  } else {
    for (int i = tid; i < TC_ROWS * cols; i += TC_NT) {
      const int r = i / cols, c = i - r * cols;
      const bool in = r0 + r < n;
      cp_async4(dst + r * stride + c,
                src + (size_t)(in ? r0 + r : 0) * ld + c0 + c, in);
    }
  }
}

// Host-side checks of the C entry points' arguments.

bool bad_shape(int bh, int sq, int sk) {
  return bh <= 0 || sq <= 0 || sk <= 0 || bh > 65535;
}

bool bad_grid(int sk, int kh, int kw) {
  return kh <= 0 || kw <= 0 || (long long)kh * kw != sk;
}

// the kernels copy 16-byte chunks of every bf16 row
bool misaligned(const void* a, const void* b, const void* c, const void* d,
                const void* e, const void* f = nullptr) {
  const uintptr_t any = reinterpret_cast<uintptr_t>(a) |
                        reinterpret_cast<uintptr_t>(b) |
                        reinterpret_cast<uintptr_t>(c) |
                        reinterpret_cast<uintptr_t>(d) |
                        reinterpret_cast<uintptr_t>(e) |
                        reinterpret_cast<uintptr_t>(f);
  return (any & 15) != 0;
}

// bias rows go by 16-byte copies when every row starts 16-byte aligned
bool bias_vec(const void* bias_h, const void* bias_w, int kh, int kw) {
  return kh % 4 == 0 && kw % 4 == 0 &&
         ((reinterpret_cast<uintptr_t>(bias_h) |
           reinterpret_cast<uintptr_t>(bias_w)) & 15) == 0;
}

}  // namespace
