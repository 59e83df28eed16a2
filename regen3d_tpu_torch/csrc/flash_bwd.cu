// Flash-attention backward for Hopper (sm_90a): the dq kernel and the dk/dv
// kernel, plain and with a factored key-grid bias (SAM's decomposed
// relative-position bias). bf16 q/k/v/g and dq/dk/dv; f32 lse, delta, bias
// factors, bias gradients and accumulation.
//
// Replaces: regen3d_tpu/ops/attention.py::_flash_bwd_dq_kernel and
// ::_flash_bwd_dkv_kernel (reached through _flash_vjp_bwd) with the
// tensor-core kernels bwd_dq_kernel and bwd_dkv_kernel, and
// ::_flash_bwd_gb_dq_kernel and ::_flash_bwd_gb_dkv_kernel (reached through
// _gb_vjp_bwd) with the CUDA-core kernels gb_bwd_dq_kernel and
// gb_bwd_dkv_kernel (Pallas, TPU).
//
// All four recompute the probabilities from the forward's row logsumexp, so
// the (Sq, Sk) matrices never exist in device memory:
//   s  = scale·q·kᵀ (+ bias_h[q, k / kw] + bias_w[q, k % kw]),
//   p  = exp(s − lse),   dp = g·vᵀ,   ds = p·(dp − delta)
//   with delta = Σ_d o·g (computed by the caller),
//   dq = scale·ds·k,   dk = scale·dsᵀ·q,   dv = pᵀ·g,
//   and with the grid bias (keys on a (kh, kw) grid, key k at row k / kw,
//   column k % kw):
//   dbias_h[q, m] = Σ_n ds[q, m·kw + n],   dbias_w[q, n] = Σ_m ds[q, m·kw + n].
// The bias enters the logits unscaled, so its gradient takes ds as it is.
//
// What bounds them on the H100: per head the dq kernel does 6·Sq·Sk·D
// operations and the dkv kernel 8·Sq·Sk·D against 2·(Sq + Sk)·D bf16
// values read (q, k, v, g), about 300 operations per byte at DiT-base's
// self-attention (Sq = Sk = 512, D = 64), the card's balance point, 800 at
// Sq = Sk = 1374 and more at SAM-H's global blocks ((1, 16, 4096, 80)). So
// operations bound them, the bf16 tensor cores' rate for the plain pair,
// except at DiT-base's cross-attention (Sk = 257), where reading and
// writing the bytes takes slightly longer.
//
// The plain pair: tensor cores, asynchronous copies, bf16 shared memory.
// * Gridded as in JAX, no atomics: dq over (batch·head, 64 query rows), dkv
//   over (batch·head, 64 keys). Both recompute s and dp; every gradient
//   element is summed by one thread in a fixed order and written once, so
//   two launches on the same inputs give the same bits.
// * Four warps, each owning 16 rows of the block's tile. Every product is
//   mma.sync.m16n8k16 bf16 × bf16 → f32, its operands brought from shared
//   memory by ldmatrix (.trans where the product needs the other major
//   order: k as B of ds·k, q and g as B of dsᵀ·q and pᵀ·g).
// * The f32 accumulator fragments of s and dp become p and ds in registers;
//   the m16n8 C layout of two neighbouring 8-column tiles is the m16n8k16 A
//   layout, so p and ds are converted to bf16 and used directly as the A
//   fragments of the next product and never touch shared memory. The dkv
//   kernel computes sᵀ = k·qᵀ and dpᵀ = v·gᵀ, keys as rows, so that pᵀ and
//   dsᵀ are already the A operands of pᵀ·g and dsᵀ·q.
// * Rounding: p (dkv) and scale·ds (both) are rounded to bf16 once, where
//   the accumulator fragment becomes an A fragment; dq, dk and dv are
//   rounded to bf16 once at the end. Everything else is f32.
// * The streamed tiles (K and V for dq; Q, g, lse and delta for dkv) arrive
//   by cp.async 16-byte copies (4-byte for lse and delta) into a two-stage
//   ring: the next tile is in flight while the current one is multiplied,
//   waited for with cp.async.wait_group. Rows past Sq or Sk are zero-filled
//   by the copy (source size 0) and masked in registers (p = 0); the caller
//   pads nothing.
// * Shared memory holds the bf16 tiles as rows of D values, their 16-byte
//   chunks XOR-swizzled by row, so the eight rows that one ldmatrix reads
//   fall in distinct banks: no f32 copies and no padding.
// * Epilogue: the f32 accumulators go to bf16 in the warp's own rows of the
//   resident tile (Q in dq; K and V in dkv, read by no other warp) and leave
//   with coalesced 16-byte stores.
// * Head dims 16, 32, 64 and 128 are template instances. At D = 128 the
//   streamed tile is 32 rows, which keeps the dk and dv accumulators (128
//   f32 registers a thread) beside s and dp in registers.
//
// The grid-bias pair: the CUDA-core kernels of the first port, f32 FMAs in
// the flash_fwd.cu tiling, bound by the shared-memory loads feeding them.
// dq: one block per (batch·head, 64-row q tile); K and V stream through
// shared memory in 64-key tiles; four threads own a query row, each with 16
// keys of the tile and D/4 dq accumulators in registers. dkv: one block per
// (batch·head, 64-key tile); Q, g, lse and delta stream in 64-row tiles;
// four threads own a key row. The grid-bias dq kernel keeps ds unscaled for
// the bias gradients and scales dq at the end; its dkv kernel scales ds
// where it forms it. The (S, S) bias never exists: the dq block keeps its
// 64 rows of bias_h and bias_w in shared memory; the dkv block loads, per q
// tile, the bias_w rows and only the bias_h columns of the key-grid rows its
// 64 keys touch, and each score reads bias_h[q, k / kw] and bias_w[q, k % kw]
// from there (no selector matmuls, which only worked around Mosaic). The
// bias gradients are sums over keys within one query row: the dq block keeps
// a row's partial sums in shared memory, next to its ds row, where only the
// row's four lanes (one warp) touch them, each lane owning the outputs whose
// index is its lane mod 4. Every dbias element is summed by one thread in a
// fixed order and written once: no atomics, deterministic, as JAX's is.
//
// Shared memory passes 48 KB, so the launches opt in with
// cudaFuncSetAttribute. Head dims: 16, 32, 64 and 128 without a bias, those
// of flash_fwd.cu; 80 (SAM-H) with the grid bias, that of flash_gb_fwd.cu.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr size_t SMEM_MAX = 232448;
typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------------------
// The plain pair on the tensor cores.

constexpr int TC_ROWS = 64;       // rows per block: q rows (dq), keys (dkv)
constexpr int TC_NT = 128;        // four warps of 16 rows
constexpr float LOG2E = 1.4426950408889634f;

// rows per streamed tile: keys (dq) or queries (dkv)
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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(in ? 16 : 0));
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

// Copy rows [r0, r0 + ROWS) of a [n][D] bf16 array into a swizzled tile;
// rows at or past n are zero-filled.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* src, int r0,
                                          int n, int tid) {
  constexpr int CPR = D / 8;
  static_assert(ROWS * CPR % TC_NT == 0, "whole chunks per thread");
#pragma unroll
  for (int it = 0; it < ROWS * CPR / TC_NT; ++it) {
    const int i = tid + it * TC_NT;
    const int r = i / CPR, c = i % CPR;
    const bool in = r0 + r < n;
    cp_async16(tile + swz<D>(r, c * 8),
               src + (size_t)(in ? r0 + r : 0) * D + c * 8, in);
  }
}

// The A fragment (16×16, row-major) at rows r0.., cols c0.. of a tile.
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile,
                                       int r0, int c0, int lane) {
  ldsm(a, tile + swz<D>(r0 + (lane & 15), c0 + ((lane >> 4) << 3)));
}

// The B fragments of two 8-column n-tiles (k 16 deep) from a tile stored
// [n][k] (rows are the product's columns): b[0], b[1] for n0..n0 + 7 and
// b[2], b[3] for n0 + 8..n0 + 15.
template <int D>
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[4], const bf16* tile,
                                          int n0, int k0, int lane) {
  ldsm(b, tile + swz<D>(n0 + (lane & 7) + ((lane >> 4) << 3),
                        k0 + (((lane >> 3) & 1) << 3)));
}

// The same from a tile stored [k][n] (rows are the product's depth).
template <int D>
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4], const bf16* tile,
                                          int k0, int n0, int lane) {
  ldsm_t(b, tile + swz<D>(k0 + (lane & 15), n0 + ((lane >> 4) << 3)));
}

// Write a warp's 16 × D f32 accumulators as bf16 into its rows r0.. of a
// swizzled tile, then copy those rows to dst rows [g0, g0 + 16) below n with
// 16-byte stores.
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 8][4],
                                           bf16* tile, int r0, bf16* dst,
                                           int g0, int n, int lane) {
  const int g4 = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = j * 8 + t4 * 2;
    *reinterpret_cast<uint32_t*>(tile + swz<D>(r0 + g4, col)) =
        pack_bf16(acc[j][0], acc[j][1]);
    *reinterpret_cast<uint32_t*>(tile + swz<D>(r0 + g4 + 8, col)) =
        pack_bf16(acc[j][2], acc[j][3]);
  }
  __syncwarp();
  constexpr int CPR = D / 8;
  static_assert(16 * CPR % 32 == 0, "whole chunks per lane");
#pragma unroll
  for (int it = 0; it < 16 * CPR / 32; ++it) {
    const int i = lane + it * 32;
    const int r = i / CPR, c = i % CPR;
    if (g0 + r < n)
      *reinterpret_cast<uint4*>(dst + (size_t)(g0 + r) * D + c * 8) =
          *reinterpret_cast<const uint4*>(tile + swz<D>(r0 + r, c * 8));
  }
}

template <int D>
__global__ void __launch_bounds__(TC_NT)
bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ g,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dq, int sq, int sk, float scale) {
  constexpr int BM = TC_ROWS, BN = Streamed<D>::ROWS;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [BM][D]
  bf16* gs = qs + BM * D;                        // [BM][D]
  bf16* ks = gs + BM * D;                        // [2][BN][D] ring
  bf16* vs = ks + 2 * BN * D;                    // [2][BN][D] ring

  const int bh = blockIdx.y, q0 = blockIdx.x * BM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g4 = lane >> 2, t4 = lane & 3;
  const bf16* qb = q + (size_t)bh * sq * D;
  const bf16* gb = g + (size_t)bh * sq * D;
  const bf16* kb = k + (size_t)bh * sk * D;
  const bf16* vb = v + (size_t)bh * sk * D;

  load_tile<D, BM>(qs, qb, q0, sq, tid);
  load_tile<D, BM>(gs, gb, q0, sq, tid);
  load_tile<D, BN>(ks, kb, 0, sk, tid);
  load_tile<D, BN>(vs, vb, 0, sk, tid);
  cp_async_commit();

  // this lane's two rows of the warp's 16: w0 + g4 and w0 + g4 + 8
  const int w0 = warp * 16;
  const int r_lo = q0 + w0 + g4, r_hi = r_lo + 8;
  const float* lb = lse + (size_t)bh * sq;
  const float* db = delta + (size_t)bh * sq;
  const float l_lo = r_lo < sq ? lb[r_lo] * LOG2E : 0.f;
  const float l_hi = r_hi < sq ? lb[r_hi] * LOG2E : 0.f;
  const float d_lo = r_lo < sq ? db[r_lo] : 0.f;
  const float d_hi = r_hi < sq ? db[r_hi] : 0.f;
  const float sl2 = scale * LOG2E;

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  const int nt = (sk + BN - 1) / BN;
  for (int t = 0; t < nt; ++t) {
    const int st = t & 1;
    if (t + 1 < nt) {  // the next K/V tile into the other stage
      load_tile<D, BN>(ks + (st ^ 1) * BN * D, kb, (t + 1) * BN, sk, tid);
      load_tile<D, BN>(vs + (st ^ 1) * BN * D, vb, (t + 1) * BN, sk, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // every thread's copies of this stage are in
    const bf16* kt = ks + st * BN * D;
    const bf16* vt = vs + st * BN * D;

    // s = q·kᵀ and dp = g·vᵀ, 16 × BN per warp
    float s[BN / 8][4], dp[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t qa[4], ga[4];
      load_a<D>(qa, qs, w0, kk, lane);
      load_a<D>(ga, gs, w0, kk, lane);
#pragma unroll
      for (int n = 0; n < BN; n += 16) {
        uint32_t kf[4], vf[4];
        load_b_nk<D>(kf, kt, n, kk, lane);
        load_b_nk<D>(vf, vt, n, kk, lane);
        mma(s[n / 8], qa, kf[0], kf[1]);
        mma(s[n / 8 + 1], qa, kf[2], kf[3]);
        mma(dp[n / 8], ga, vf[0], vf[1]);
        mma(dp[n / 8 + 1], ga, vf[2], vf[3]);
      }
    }

    // ds = p·(dp − delta)·scale, keys at or past sk masked (p = 0), as bf16
    // A fragments: 8-column tiles 2m and 2m + 1 make k-step m
    uint32_t dsa[BN / 16][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int key = t * BN + j * 8 + t4 * 2;
      const bool in0 = key < sk, in1 = key + 1 < sk;
      const float p0 = in0 ? exp2f(s[j][0] * sl2 - l_lo) : 0.f;
      const float p1 = in1 ? exp2f(s[j][1] * sl2 - l_lo) : 0.f;
      const float p2 = in0 ? exp2f(s[j][2] * sl2 - l_hi) : 0.f;
      const float p3 = in1 ? exp2f(s[j][3] * sl2 - l_hi) : 0.f;
      dsa[j / 2][(j & 1) * 2] = pack_bf16(p0 * (dp[j][0] - d_lo) * scale,
                                          p1 * (dp[j][1] - d_lo) * scale);
      dsa[j / 2][(j & 1) * 2 + 1] = pack_bf16(p2 * (dp[j][2] - d_hi) * scale,
                                              p3 * (dp[j][3] - d_hi) * scale);
    }

    // dq += ds·k: depth = the tile's keys, columns = D
#pragma unroll
    for (int m = 0; m < BN / 16; ++m) {
#pragma unroll
      for (int n = 0; n < D; n += 16) {
        uint32_t kf[4];
        load_b_kn<D>(kf, kt, m * 16, n, lane);
        mma(acc[n / 8], dsa[m], kf[0], kf[1]);
        mma(acc[n / 8 + 1], dsa[m], kf[2], kf[3]);
      }
    }
    __syncthreads();  // this stage is refilled by tile t + 2
  }

  store_rows<D>(acc, qs, w0, dq + (size_t)bh * sq * D, q0 + w0, sq, lane);
}

template <int D>
__global__ void __launch_bounds__(TC_NT)
bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ g,
               const float* __restrict__ lse, const float* __restrict__ delta,
               bf16* __restrict__ dk, bf16* __restrict__ dv, int sq, int sk,
               float scale) {
  constexpr int BM = TC_ROWS, BN = Streamed<D>::ROWS;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [BM][D]
  bf16* vs = ks + BM * D;                        // [BM][D]
  bf16* qs = vs + BM * D;                        // [2][BN][D] ring
  bf16* gs = qs + 2 * BN * D;                    // [2][BN][D] ring
  float* ls = reinterpret_cast<float*>(gs + 2 * BN * D);  // [2][BN] lse
  float* dls = ls + 2 * BN;                               // [2][BN] delta

  const int bh = blockIdx.y, k0 = blockIdx.x * BM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t4 = lane & 3;
  const bf16* qb = q + (size_t)bh * sq * D;
  const bf16* gb = g + (size_t)bh * sq * D;
  const bf16* kb = k + (size_t)bh * sk * D;
  const bf16* vb = v + (size_t)bh * sk * D;
  const float* lb = lse + (size_t)bh * sq;
  const float* db = delta + (size_t)bh * sq;

  // one streamed tile: BN rows of Q and g, and their lse and delta
  auto load_q_tile = [&](int stage, int r0) {
    load_tile<D, BN>(qs + stage * BN * D, qb, r0, sq, tid);
    load_tile<D, BN>(gs + stage * BN * D, gb, r0, sq, tid);
    for (int i = tid; i < BN; i += TC_NT) {
      const bool in = r0 + i < sq;
      const int row = in ? r0 + i : 0;
      cp_async4(ls + stage * BN + i, lb + row, in);
      cp_async4(dls + stage * BN + i, db + row, in);
    }
  };

  load_tile<D, BM>(ks, kb, k0, sk, tid);
  load_tile<D, BM>(vs, vb, k0, sk, tid);
  load_q_tile(0, 0);
  cp_async_commit();

  const int w0 = warp * 16;  // this warp's 16 keys of the block's 64
  const float sl2 = scale * LOG2E;

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  const int nt = (sq + BN - 1) / BN;
  for (int t = 0; t < nt; ++t) {
    const int st = t & 1;
    if (t + 1 < nt) {  // the next Q/g tile into the other stage
      load_q_tile(st ^ 1, (t + 1) * BN);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // every thread's copies of this stage are in
    const bf16* qt = qs + st * BN * D;
    const bf16* gt = gs + st * BN * D;
    const float* lt = ls + st * BN;
    const float* dlt = dls + st * BN;

    // sᵀ = k·qᵀ and dpᵀ = v·gᵀ, 16 keys × BN queries per warp
    float s[BN / 8][4], dp[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t ka[4], va[4];
      load_a<D>(ka, ks, w0, kk, lane);
      load_a<D>(va, vs, w0, kk, lane);
#pragma unroll
      for (int n = 0; n < BN; n += 16) {
        uint32_t qf[4], gf[4];
        load_b_nk<D>(qf, qt, n, kk, lane);
        load_b_nk<D>(gf, gt, n, kk, lane);
        mma(s[n / 8], ka, qf[0], qf[1]);
        mma(s[n / 8 + 1], ka, qf[2], qf[3]);
        mma(dp[n / 8], va, gf[0], gf[1]);
        mma(dp[n / 8 + 1], va, gf[2], gf[3]);
      }
    }

    // pᵀ and dsᵀ = pᵀ·(dpᵀ − delta)·scale, queries at or past sq masked
    // (p = 0), as bf16 A fragments
    uint32_t pa[BN / 16][4], dsa[BN / 16][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = j * 8 + t4 * 2;  // this lane's two query columns
      const bool in0 = t * BN + c < sq, in1 = t * BN + c + 1 < sq;
      const float l0 = lt[c] * LOG2E, l1 = lt[c + 1] * LOG2E;
      const float e0 = dlt[c], e1 = dlt[c + 1];
      const float p0 = in0 ? exp2f(s[j][0] * sl2 - l0) : 0.f;
      const float p1 = in1 ? exp2f(s[j][1] * sl2 - l1) : 0.f;
      const float p2 = in0 ? exp2f(s[j][2] * sl2 - l0) : 0.f;
      const float p3 = in1 ? exp2f(s[j][3] * sl2 - l1) : 0.f;
      pa[j / 2][(j & 1) * 2] = pack_bf16(p0, p1);
      pa[j / 2][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
      dsa[j / 2][(j & 1) * 2] = pack_bf16(p0 * (dp[j][0] - e0) * scale,
                                          p1 * (dp[j][1] - e1) * scale);
      dsa[j / 2][(j & 1) * 2 + 1] = pack_bf16(p2 * (dp[j][2] - e0) * scale,
                                              p3 * (dp[j][3] - e1) * scale);
    }

    // dv += pᵀ·g and dk += dsᵀ·q: depth = the tile's queries, columns = D
#pragma unroll
    for (int m = 0; m < BN / 16; ++m) {
#pragma unroll
      for (int n = 0; n < D; n += 16) {
        uint32_t gf[4], qf[4];
        load_b_kn<D>(gf, gt, m * 16, n, lane);
        load_b_kn<D>(qf, qt, m * 16, n, lane);
        mma(dva[n / 8], pa[m], gf[0], gf[1]);
        mma(dva[n / 8 + 1], pa[m], gf[2], gf[3]);
        mma(dka[n / 8], dsa[m], qf[0], qf[1]);
        mma(dka[n / 8 + 1], dsa[m], qf[2], qf[3]);
      }
    }
    __syncthreads();  // this stage is refilled by tile t + 2
  }

  const size_t off = (size_t)bh * sk * D;
  store_rows<D>(dka, ks, w0, dk + off, k0 + w0, sk, lane);
  store_rows<D>(dva, vs, w0, dv + off, k0 + w0, sk, lane);
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* g, const void* lse, const void* delta,
                      void* dq, int bh, int sq, int sk, float scale,
                      cudaStream_t stream) {
  constexpr int BN = Streamed<D>::ROWS;
  const size_t smem = sizeof(bf16) * (2 * TC_ROWS + 4 * BN) * D;
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + TC_ROWS - 1) / TC_ROWS, bh);
  bwd_dq_kernel<D><<<grid, TC_NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(g),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), sq, sk, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* g, const void* lse, const void* delta,
                       void* dk, void* dv, int bh, int sq, int sk, float scale,
                       cudaStream_t stream) {
  constexpr int BN = Streamed<D>::ROWS;
  const size_t smem = sizeof(bf16) * (2 * TC_ROWS + 4 * BN) * D +
                      sizeof(float) * 4 * BN;
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sk + TC_ROWS - 1) / TC_ROWS, bh);
  bwd_dkv_kernel<D><<<grid, TC_NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(g),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), sq, sk, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The grid-bias pair on the CUDA cores.

constexpr int BQ = 64;            // query rows per tile
constexpr int BK = 64;            // keys per tile
constexpr int NT = 256;           // threads: 4 per row

// The factored key-grid bias.
struct GridBias {
  const float* h;   // bias_h (bh, sq, kh)
  const float* w;   // bias_w (bh, sq, kw)
  float* dh;        // dbias_h (bh, sq, kh), written by the dq kernel
  float* dw;        // dbias_w (bh, sq, kw), written by the dq kernel
  int kh, kw;
  int nr;           // the most key-grid rows one key tile touches (dkv)
};

template <int D>
__global__ void __launch_bounds__(NT)
gb_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ g,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, bf16* __restrict__ dq,
                 GridBias gb, int sq, int sk, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                    // [BQ][D + 1], pre-scaled
  float* gs = qs + BQ * (D + 1);       // [BQ][D + 1]
  float* ks = gs + BQ * (D + 1);       // [BK][D + 1]
  float* vs = ks + BK * (D + 1);       // [BK][D + 1]
  float* dss = vs + BK * (D + 1);      // [BQ][BK + 1] ds of the tile
  float* hs = dss + BQ * (BK + 1);     // [BQ][kh + 1] bias_h rows
  float* ws = hs + BQ * (gb.kh + 1);   // [BQ][kw + 1] bias_w rows
  float* dhs = ws + BQ * (gb.kw + 1);  // [BQ][kh + 1] dbias_h sums
  float* dws = dhs + BQ * (gb.kh + 1); // [BQ][kw + 1] dbias_w sums

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int r = tid >> 2;           // query row within the tile
  const int c4 = tid & 3;           // column phase: keys c4 + 4j, dims c4 + 4i
  const size_t qoff = (size_t)bh * sq * D;
  const size_t koff = (size_t)bh * sk * D;
  const size_t hoff = (size_t)bh * sq * gb.kh;
  const size_t woff = (size_t)bh * sq * gb.kw;

  for (int i = tid; i < BQ * D; i += NT) {
    const int rr = i / D, dd = i % D, qi = q0 + rr;
    float qv = 0.f, gv = 0.f;
    if (qi < sq) {
      qv = __bfloat162float(q[qoff + (size_t)qi * D + dd]) * scale;
      gv = __bfloat162float(g[qoff + (size_t)qi * D + dd]);
    }
    qs[rr * (D + 1) + dd] = qv;
    gs[rr * (D + 1) + dd] = gv;
  }
  {
    const int kh = gb.kh, kw = gb.kw;
    for (int i = tid; i < BQ * kh; i += NT) {
      const int rr = i / kh, mm = i % kh, qi = q0 + rr;
      hs[rr * (kh + 1) + mm] = qi < sq ? gb.h[hoff + (size_t)qi * kh + mm] : 0.f;
      dhs[rr * (kh + 1) + mm] = 0.f;
    }
    for (int i = tid; i < BQ * kw; i += NT) {
      const int rr = i / kw, nn = i % kw, qi = q0 + rr;
      ws[rr * (kw + 1) + nn] = qi < sq ? gb.w[woff + (size_t)qi * kw + nn] : 0.f;
      dws[rr * (kw + 1) + nn] = 0.f;
    }
  }
  const int qi = q0 + r;
  const float lse_r = qi < sq ? lse[(size_t)bh * sq + qi] : 0.f;
  const float dl_r = qi < sq ? delta[(size_t)bh * sq + qi] : 0.f;

  constexpr int DPT = D / 4;
  constexpr int KPT = BK / 4;
  float acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;
  const float* hrow = hs + r * (gb.kh + 1);
  const float* wrow = ws + r * (gb.kw + 1);
  float* dhrow = dhs + r * (gb.kh + 1);
  float* dwrow = dws + r * (gb.kw + 1);
  float* dsrow = dss + r * (BK + 1);

  for (int kb = 0; kb < sk; kb += BK) {
    __syncthreads();  // q/g rows are in; the previous K/V/ds tiles are done
    for (int i = tid; i < BK * D; i += NT) {
      const int rr = i / D, dd = i % D, ki = kb + rr;
      float kv = 0.f, vv = 0.f;
      if (ki < sk) {
        kv = __bfloat162float(k[koff + (size_t)ki * D + dd]);
        vv = __bfloat162float(v[koff + (size_t)ki * D + dd]);
      }
      ks[rr * (D + 1) + dd] = kv;
      vs[rr * (D + 1) + dd] = vv;
    }
    __syncthreads();

    float s[KPT], dp[KPT];
#pragma unroll
    for (int j = 0; j < KPT; ++j) s[j] = dp[j] = 0.f;
    const float* qrow = qs + r * (D + 1);
    const float* grow = gs + r * (D + 1);
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qd = qrow[d], gd = grow[d];
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        s[j] += qd * ks[(c4 + 4 * j) * (D + 1) + d];
        dp[j] += gd * vs[(c4 + 4 * j) * (D + 1) + d];
      }
    }
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const int ki = kb + c4 + 4 * j;
      float p = 0.f;
      if (ki < sk) {
        const int row = ki / gb.kw;
        p = expf((s[j] + hrow[row]) + wrow[ki - row * gb.kw] - lse_r);
      }
      dsrow[c4 + 4 * j] = p * (dp[j] - dl_r);           // unscaled
    }
    __syncwarp();  // the row's four lanes (one warp) wrote its ds row

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float dsv = dsrow[c];
      const float* kr = ks + c * (D + 1) + c4;
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] += dsv * kr[4 * i];
    }
    {
      // the tile's contribution to the row's bias gradients: lane c4 owns
      // the columns n and the grid rows m that are c4 mod 4, in every tile
      const int kw = gb.kw;
      const int cmax = min(BK, sk - kb);
      const int kb_mod = kb % kw;
      for (int n = c4; n < kw; n += 4) {
        float t = 0.f;
        for (int c = (n - kb_mod + kw) % kw; c < cmax; c += kw) t += dsrow[c];
        dwrow[n] += t;
      }
      const int m0 = kb / kw, m1 = (kb + cmax - 1) / kw;
      for (int m = m0 + (c4 - m0 % 4 + 4) % 4; m <= m1; m += 4) {
        const int lo = max(m * kw - kb, 0), hi = min((m + 1) * kw - kb, cmax);
        float t = 0.f;
        for (int c = lo; c < hi; ++c) t += dsrow[c];
        dhrow[m] += t;
      }
    }
  }

  if (qi < sq) {
    bf16* out = dq + qoff + (size_t)qi * D + c4;
#pragma unroll
    for (int i = 0; i < DPT; ++i) out[4 * i] = __float2bfloat16(acc[i] * scale);
    for (int m = c4; m < gb.kh; m += 4)
      gb.dh[hoff + (size_t)qi * gb.kh + m] = dhrow[m];
    for (int n = c4; n < gb.kw; n += 4)
      gb.dw[woff + (size_t)qi * gb.kw + n] = dwrow[n];
  }
}

template <int D>
__global__ void __launch_bounds__(NT)
gb_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ g,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, bf16* __restrict__ dk,
                  bf16* __restrict__ dv, GridBias gb, int sq, int sk,
                  float scale) {
  extern __shared__ float smem[];
  float* ks = smem;                   // [BK][D + 1], pre-scaled
  float* vs = ks + BK * (D + 1);      // [BK][D + 1]
  float* qs = vs + BK * (D + 1);      // [BQ][D + 1]
  float* gs = qs + BQ * (D + 1);      // [BQ][D + 1]
  float* ps = gs + BQ * (D + 1);      // [BK][BQ + 1] p of the tile
  float* dss = ps + BK * (BQ + 1);    // [BK][BQ + 1] ds of the tile
  float* ls = dss + BK * (BQ + 1);    // [BQ] lse
  float* dls = ls + BQ;               // [BQ] delta
  float* hs = dls + BQ;               // [BQ][nr + 1] bias_h, this tile's rows
  float* ws = hs + BQ * (gb.nr + 1);  // [BQ][kw + 1] bias_w

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BK;
  const int tid = threadIdx.x;
  const int r = tid >> 2;           // key row within the tile
  const int c4 = tid & 3;           // column phase: queries c4 + 4j, dims c4 + 4i
  const size_t qoff = (size_t)bh * sq * D;
  const size_t koff = (size_t)bh * sk * D;
  const size_t hoff = (size_t)bh * sq * gb.kh;
  const size_t woff = (size_t)bh * sq * gb.kw;
  const int key = k0 + r;
  // key-grid rows m0 .. m0 + nt - 1 hold this tile's keys (nt <= nr); this
  // key reads column my_m of hs and column my_n of ws
  const int m0 = k0 / gb.kw;
  const int nt = (min(k0 + BK, sk) - 1) / gb.kw - m0 + 1;
  const int my_m = key < sk ? key / gb.kw - m0 : 0;
  const int my_n = key % gb.kw;

  for (int i = tid; i < BK * D; i += NT) {
    const int rr = i / D, dd = i % D, ki = k0 + rr;
    float kv = 0.f, vv = 0.f;
    if (ki < sk) {
      kv = __bfloat162float(k[koff + (size_t)ki * D + dd]) * scale;
      vv = __bfloat162float(v[koff + (size_t)ki * D + dd]);
    }
    ks[rr * (D + 1) + dd] = kv;
    vs[rr * (D + 1) + dd] = vv;
  }

  constexpr int DPT = D / 4;
  constexpr int QPT = BQ / 4;
  float dk_acc[DPT], dv_acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  const float* krow = ks + r * (D + 1);
  const float* vrow = vs + r * (D + 1);
  float* prow = ps + r * (BQ + 1);
  float* dsrow = dss + r * (BQ + 1);

  for (int qb = 0; qb < sq; qb += BQ) {
    __syncthreads();  // K/V rows are in; the previous Q/g/p/ds tiles are done
    for (int i = tid; i < BQ * D; i += NT) {
      const int rr = i / D, dd = i % D, qi = qb + rr;
      float qv = 0.f, gv = 0.f;
      if (qi < sq) {
        qv = __bfloat162float(q[qoff + (size_t)qi * D + dd]);
        gv = __bfloat162float(g[qoff + (size_t)qi * D + dd]);
      }
      qs[rr * (D + 1) + dd] = qv;
      gs[rr * (D + 1) + dd] = gv;
    }
    for (int i = tid; i < BQ; i += NT) {
      const bool in = qb + i < sq;
      ls[i] = in ? lse[(size_t)bh * sq + qb + i] : 0.f;
      dls[i] = in ? delta[(size_t)bh * sq + qb + i] : 0.f;
    }
    {
      const int nr = gb.nr, kh = gb.kh, kw = gb.kw;
      for (int i = tid; i < BQ * nt; i += NT) {
        const int rr = i / nt, mm = i % nt, qi = qb + rr;
        hs[rr * (nr + 1) + mm] =
            qi < sq ? gb.h[hoff + (size_t)qi * kh + m0 + mm] : 0.f;
      }
      for (int i = tid; i < BQ * kw; i += NT) {
        const int rr = i / kw, nn = i % kw, qi = qb + rr;
        ws[rr * (kw + 1) + nn] =
            qi < sq ? gb.w[woff + (size_t)qi * kw + nn] : 0.f;
      }
    }
    __syncthreads();

    float s[QPT], dp[QPT];
#pragma unroll
    for (int j = 0; j < QPT; ++j) s[j] = dp[j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float kd = krow[d], vd = vrow[d];
#pragma unroll
      for (int j = 0; j < QPT; ++j) {
        s[j] += kd * qs[(c4 + 4 * j) * (D + 1) + d];
        dp[j] += vd * gs[(c4 + 4 * j) * (D + 1) + d];
      }
    }
#pragma unroll
    for (int j = 0; j < QPT; ++j) {
      const int c = c4 + 4 * j;
      float p = 0.f;
      if (qb + c < sq)
        p = expf((s[j] + hs[c * (gb.nr + 1) + my_m]) +
                 ws[c * (gb.kw + 1) + my_n] - ls[c]);
      prow[c] = p;
      dsrow[c] = p * (dp[j] - dls[c]) * scale;
    }
    __syncwarp();  // the row's four lanes (one warp) wrote its p and ds rows

#pragma unroll 4
    for (int c = 0; c < BQ; ++c) {
      const float p = prow[c], dsv = dsrow[c];
      const float* qr = qs + c * (D + 1) + c4;
      const float* gr = gs + c * (D + 1) + c4;
#pragma unroll
      for (int i = 0; i < DPT; ++i) {
        dk_acc[i] += dsv * qr[4 * i];
        dv_acc[i] += p * gr[4 * i];
      }
    }
  }

  if (key < sk) {
    bf16* dko = dk + koff + (size_t)key * D + c4;
    bf16* dvo = dv + koff + (size_t)key * D + c4;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      dko[4 * i] = __float2bfloat16(dk_acc[i]);
      dvo[4 * i] = __float2bfloat16(dv_acc[i]);
    }
  }
}

template <int D>
cudaError_t launch_gb_dq(const void* q, const void* k, const void* v,
                         const void* g, const void* lse, const void* delta,
                         void* dq, GridBias gb, int bh, int sq, int sk,
                         float scale, cudaStream_t stream) {
  const size_t floats = 2 * (size_t)BQ * (D + 1) + 2 * BK * (D + 1) +
                        BQ * (BK + 1) + 2 * (size_t)BQ * (gb.kh + 1) +
                        2 * (size_t)BQ * (gb.kw + 1);
  const size_t smem = sizeof(float) * floats;
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      gb_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + BQ - 1) / BQ, bh);
  gb_bwd_dq_kernel<D><<<grid, NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(g),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), gb, sq, sk, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_gb_dkv(const void* q, const void* k, const void* v,
                          const void* g, const void* lse, const void* delta,
                          void* dk, void* dv, GridBias gb, int bh, int sq,
                          int sk, float scale, cudaStream_t stream) {
  // the most key-grid rows that one tile of BK consecutive keys can touch
  gb.nr = min(gb.kh, (BK - 1) / gb.kw + 2);
  const size_t floats = 2 * (size_t)BK * (D + 1) + 2 * BQ * (D + 1) +
                        2 * BK * (BQ + 1) + 2 * BQ +
                        (size_t)BQ * (gb.nr + 1) + (size_t)BQ * (gb.kw + 1);
  const size_t smem = sizeof(float) * floats;
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      gb_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sk + BK - 1) / BK, bh);
  gb_bwd_dkv_kernel<D><<<grid, NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(g),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), gb, sq, sk, scale);
  return cudaGetLastError();
}

bool bad_shape(int bh, int sq, int sk) {
  return bh <= 0 || sq <= 0 || sk <= 0 || bh > 65535;
}

bool bad_grid(int sk, int kh, int kw) {
  return kh <= 0 || kw <= 0 || (long long)kh * kw != sk;
}

// the tensor-core kernels copy 16-byte chunks of every bf16 row
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

}  // namespace

// q, g, dq (bh, sq, d); k, v (bh, sk, d): contiguous bf16, 16-byte aligned.
// lse and delta (bh, sq) f32. Returns cudaGetLastError() after the launch.
extern "C" int flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                 const void* g, const void* lse,
                                 const void* delta, void* dq, int bh, int sq,
                                 int sk, int d, float scale, void* stream) {
  if (bad_shape(bh, sq, sk) || misaligned(q, k, v, g, dq))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return (int)launch_dq<16>(q, k, v, g, lse, delta, dq, bh, sq, sk, scale, st);
    case 32: return (int)launch_dq<32>(q, k, v, g, lse, delta, dq, bh, sq, sk, scale, st);
    case 64: return (int)launch_dq<64>(q, k, v, g, lse, delta, dq, bh, sq, sk, scale, st);
    case 128: return (int)launch_dq<128>(q, k, v, g, lse, delta, dq, bh, sq, sk, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

// As flash_bwd_dq_bf16; dk and dv (bh, sk, d) contiguous bf16.
extern "C" int flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                  const void* g, const void* lse,
                                  const void* delta, void* dk, void* dv,
                                  int bh, int sq, int sk, int d, float scale,
                                  void* stream) {
  if (bad_shape(bh, sq, sk) || misaligned(q, k, v, g, dk, dv))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return (int)launch_dkv<16>(q, k, v, g, lse, delta, dk, dv, bh, sq, sk, scale, st);
    case 32: return (int)launch_dkv<32>(q, k, v, g, lse, delta, dk, dv, bh, sq, sk, scale, st);
    case 64: return (int)launch_dkv<64>(q, k, v, g, lse, delta, dk, dv, bh, sq, sk, scale, st);
    case 128: return (int)launch_dkv<128>(q, k, v, g, lse, delta, dk, dv, bh, sq, sk, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

// As flash_bwd_dq_bf16 (no alignment needed), with the grid bias: bias_h
// and dbias_h (bh, sq, kh), bias_w and dbias_w (bh, sq, kw), contiguous
// f32, sk = kh·kw.
extern "C" int flash_gb_bwd_dq_bf16(const void* q, const void* k,
                                    const void* v, const void* bias_h,
                                    const void* bias_w, const void* g,
                                    const void* lse, const void* delta,
                                    void* dq, void* dbias_h, void* dbias_w,
                                    int bh, int sq, int sk, int kh, int kw,
                                    int d, float scale, void* stream) {
  if (bad_shape(bh, sq, sk) || bad_grid(sk, kh, kw) || d != 80)
    return (int)cudaErrorInvalidValue;
  const GridBias gb{static_cast<const float*>(bias_h),
                    static_cast<const float*>(bias_w),
                    static_cast<float*>(dbias_h), static_cast<float*>(dbias_w),
                    kh, kw, 0};
  return (int)launch_gb_dq<80>(q, k, v, g, lse, delta, dq, gb, bh, sq, sk,
                               scale, static_cast<cudaStream_t>(stream));
}

// As flash_gb_bwd_dq_bf16; dk and dv (bh, sk, d) contiguous bf16.
extern "C" int flash_gb_bwd_dkv_bf16(const void* q, const void* k,
                                     const void* v, const void* bias_h,
                                     const void* bias_w, const void* g,
                                     const void* lse, const void* delta,
                                     void* dk, void* dv, int bh, int sq,
                                     int sk, int kh, int kw, int d,
                                     float scale, void* stream) {
  if (bad_shape(bh, sq, sk) || bad_grid(sk, kh, kw) || d != 80)
    return (int)cudaErrorInvalidValue;
  const GridBias gb{static_cast<const float*>(bias_h),
                    static_cast<const float*>(bias_w), nullptr, nullptr, kh,
                    kw, 0};
  return (int)launch_gb_dkv<80>(q, k, v, g, lse, delta, dk, dv, gb, bh, sq,
                                sk, scale, static_cast<cudaStream_t>(stream));
}
