// Flash-attention backward for Hopper (sm_90a): the dq kernel and the dk/dv
// kernel, plain and with a factored key-grid bias (SAM's decomposed
// relative-position bias). bf16 q/k/v/g and dq/dk/dv; f32 lse, delta, bias
// factors, bias gradients and accumulation.
//
// Replaces: regen3d_tpu/ops/attention.py::_flash_bwd_dq_kernel and
// ::_flash_bwd_dkv_kernel (reached through _flash_vjp_bwd) with
// bwd_dq_kernel and bwd_dkv_kernel, and ::_flash_bwd_gb_dq_kernel and
// ::_flash_bwd_gb_dkv_kernel (reached through _gb_vjp_bwd) with
// gb_bwd_dq_kernel and gb_bwd_dkv_kernel (Pallas, TPU). All four run their
// products on the tensor cores.
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
// operations bound them, the bf16 tensor cores' rate, except at DiT-base's
// cross-attention (Sk = 257), where reading and writing the bytes takes
// slightly longer.
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
// * Head dims 4, 8, 12 and 24 (the matting net's heads of `base`, the
//   distilled detector's and saliency net's) are computed at width 16 and
//   32 (DC<D>): load_tile zero-fills the columns past D in shared memory, so
//   q·kᵀ, g·vᵀ and the products with them see zeros there, the scale stays
//   1/√D of the true D, and store_rows writes only the first D columns. Each
//   is bit for bit the wider instance on zero-padded inputs.
//
// The grid-bias pair (D = 80): the same design, with the factored bias.
// * The (S, S) bias never exists. The dq block keeps its 64 rows of bias_h
//   and bias_w in shared memory; the dkv block streams, with each query
//   tile, its rows of bias_w and the bias_h columns of the key-grid rows its
//   64 keys touch. Each f32 element of the s fragment adds
//   bias_h[q, k / kw] + bias_w[q, k % kw] in fragment order before the
//   exp2, as the logits do in the JAX kernels (no selector matmuls, which
//   only worked around Mosaic).
// * The bias gradients sum the unscaled f32 ds before it is scaled and
//   rounded to bf16 for ds·k: at kw = 64 (SAM-H) a 64-key tile is one
//   key-grid row, dbias_h a quad-shuffled row sum of the ds fragment and
//   dbias_w 32 registers a lane across tiles; any other grid sums ds from a
//   shared slab. No atomics: each element is summed by one thread in a
//   fixed order.
// * A row of 80 bf16 values is ten 16-byte chunks, which the XOR swizzle
//   cannot permute in place: Tile<80> pads rows to 88 values instead. The
//   streamed tiles are 64 rows, which keeps dq (40 f32 registers a lane)
//   or dk and dv (80) beside s and dp.
//
// The tile layouts, the PTX wrappers and the fragment loads live in
// tc_tiles.cuh, shared with the forward kernel (flash_fwd.cu).
//
// Shared memory passes 48 KB, so the launches opt in with
// cudaFuncSetAttribute. Head dims: 4, 8, 12, 16, 24, 32, 64 and 128 without a
// bias, 80 (SAM-H) with the grid bias: those of the forward kernel but 96
// and 512.

#include "tc_tiles.cuh"

namespace {

// ---------------------------------------------------------------------------
// The plain pair on the tensor cores.

template <int D>
__global__ void __launch_bounds__(TC_NT)
bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ g,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dq, int sq, int sk, float scale) {
  constexpr int W = DC<D>;
  constexpr int BM = TC_ROWS, BN = Streamed<W>::ROWS;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [BM][W]
  bf16* gs = qs + BM * W;                        // [BM][W]
  bf16* ks = gs + BM * W;                        // [2][BN][W] ring
  bf16* vs = ks + 2 * BN * W;                    // [2][BN][W] ring

  const int bh = blockIdx.y, q0 = blockIdx.x * BM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g4 = lane >> 2, t4 = lane & 3;
  const bf16* qb = q + (size_t)bh * sq * D;
  const bf16* gb = g + (size_t)bh * sq * D;
  const bf16* kb = k + (size_t)bh * sk * D;
  const bf16* vb = v + (size_t)bh * sk * D;

  load_tile<W, BM, D>(qs, qb, q0, sq, tid);
  load_tile<W, BM, D>(gs, gb, q0, sq, tid);
  load_tile<W, BN, D>(ks, kb, 0, sk, tid);
  load_tile<W, BN, D>(vs, vb, 0, sk, tid);
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

  float acc[W / 8][4];
#pragma unroll
  for (int j = 0; j < W / 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  const int nt = (sk + BN - 1) / BN;
  for (int t = 0; t < nt; ++t) {
    const int st = t & 1;
    if (t + 1 < nt) {  // the next K/V tile into the other stage
      load_tile<W, BN, D>(ks + (st ^ 1) * BN * W, kb, (t + 1) * BN, sk, tid);
      load_tile<W, BN, D>(vs + (st ^ 1) * BN * W, vb, (t + 1) * BN, sk, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // every thread's copies of this stage are in
    const bf16* kt = ks + st * BN * W;
    const bf16* vt = vs + st * BN * W;

    // s = q·kᵀ and dp = g·vᵀ, 16 × BN per warp
    float s[BN / 8][4], dp[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < W; kk += 16) {
      uint32_t qa[4], ga[4];
      load_a<W>(qa, qs, w0, kk, lane);
      load_a<W>(ga, gs, w0, kk, lane);
#pragma unroll
      for (int n = 0; n < BN; n += 16) {
        uint32_t kf[4], vf[4];
        load_b_nk<W>(kf, kt, n, kk, lane);
        load_b_nk<W>(vf, vt, n, kk, lane);
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
      for (int n = 0; n < W; n += 16) {
        uint32_t kf[4];
        load_b_kn<W>(kf, kt, m * 16, n, lane);
        mma(acc[n / 8], dsa[m], kf[0], kf[1]);
        mma(acc[n / 8 + 1], dsa[m], kf[2], kf[3]);
      }
    }
    __syncthreads();  // this stage is refilled by tile t + 2
  }

  store_rows<W, D>(acc, qs, w0, dq + (size_t)bh * sq * D, q0 + w0, sq,
                   lane);
}

template <int D>
__global__ void __launch_bounds__(TC_NT)
bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ g,
               const float* __restrict__ lse, const float* __restrict__ delta,
               bf16* __restrict__ dk, bf16* __restrict__ dv, int sq, int sk,
               float scale) {
  constexpr int W = DC<D>;
  constexpr int BM = TC_ROWS, BN = Streamed<W>::ROWS;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [BM][W]
  bf16* vs = ks + BM * W;                        // [BM][W]
  bf16* qs = vs + BM * W;                        // [2][BN][W] ring
  bf16* gs = qs + 2 * BN * W;                    // [2][BN][W] ring
  float* ls = reinterpret_cast<float*>(gs + 2 * BN * W);  // [2][BN] lse
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
    load_tile<W, BN, D>(qs + stage * BN * W, qb, r0, sq, tid);
    load_tile<W, BN, D>(gs + stage * BN * W, gb, r0, sq, tid);
    for (int i = tid; i < BN; i += TC_NT) {
      const bool in = r0 + i < sq;
      const int row = in ? r0 + i : 0;
      cp_async4(ls + stage * BN + i, lb + row, in);
      cp_async4(dls + stage * BN + i, db + row, in);
    }
  };

  load_tile<W, BM, D>(ks, kb, k0, sk, tid);
  load_tile<W, BM, D>(vs, vb, k0, sk, tid);
  load_q_tile(0, 0);
  cp_async_commit();

  const int w0 = warp * 16;  // this warp's 16 keys of the block's 64
  const float sl2 = scale * LOG2E;

  float dka[W / 8][4], dva[W / 8][4];
#pragma unroll
  for (int j = 0; j < W / 8; ++j)
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
    const bf16* qt = qs + st * BN * W;
    const bf16* gt = gs + st * BN * W;
    const float* lt = ls + st * BN;
    const float* dlt = dls + st * BN;

    // sᵀ = k·qᵀ and dpᵀ = v·gᵀ, 16 keys × BN queries per warp
    float s[BN / 8][4], dp[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < W; kk += 16) {
      uint32_t ka[4], va[4];
      load_a<W>(ka, ks, w0, kk, lane);
      load_a<W>(va, vs, w0, kk, lane);
#pragma unroll
      for (int n = 0; n < BN; n += 16) {
        uint32_t qf[4], gf[4];
        load_b_nk<W>(qf, qt, n, kk, lane);
        load_b_nk<W>(gf, gt, n, kk, lane);
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
      for (int n = 0; n < W; n += 16) {
        uint32_t gf[4], qf[4];
        load_b_kn<W>(gf, gt, m * 16, n, lane);
        load_b_kn<W>(qf, qt, m * 16, n, lane);
        mma(dva[n / 8], pa[m], gf[0], gf[1]);
        mma(dva[n / 8 + 1], pa[m], gf[2], gf[3]);
        mma(dka[n / 8], dsa[m], qf[0], qf[1]);
        mma(dka[n / 8 + 1], dsa[m], qf[2], qf[3]);
      }
    }
    __syncthreads();  // this stage is refilled by tile t + 2
  }

  const size_t off = (size_t)bh * sk * D;
  store_rows<W, D>(dka, ks, w0, dk + off, k0 + w0, sk, lane);
  store_rows<W, D>(dva, vs, w0, dv + off, k0 + w0, sk, lane);
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* g, const void* lse, const void* delta,
                      void* dq, int bh, int sq, int sk, float scale,
                      cudaStream_t stream) {
  constexpr int W = DC<D>, BN = Streamed<W>::ROWS;
  const size_t smem = sizeof(bf16) * (2 * TC_ROWS + 4 * BN) * W;
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
  constexpr int W = DC<D>, BN = Streamed<W>::ROWS;
  const size_t smem = sizeof(bf16) * (2 * TC_ROWS + 4 * BN) * W +
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
// The grid-bias pair on the tensor cores (D = 80, SAM-H's heads).


// The grid-bias dq kernel: dq, dbias_h and dbias_w. One block per
// (batch·head, 64 query rows), four warps of 16 rows, the products as in
// bwd_dq_kernel. The block's rows of bias_h and bias_w come once, with its
// Q and g tiles. The bias gradients sum the f32 ds of each tile before it
// is scaled and rounded to bf16, by one of two policies:
// * ROW_TILE (kw = 64, SAM-H's 64 × 64 grid): a 64-key tile is key-grid row
//   t, so dbias_h[q, t] is the tile's row sum of ds: each lane sums its 16
//   values of a row, a quad shuffle (xor 1, 2) completes it and one lane
//   stores it, the only write of that element. dbias_w[q, n] takes column n
//   of every tile: each lane keeps its 2 rows × 16 columns in registers
//   across tiles and stores them at the end.
// * otherwise (any kh·kw = sk, such as the small SAM's 32 × 32 grid, or a
//   kw that does not divide 64): the warp writes its ds rows to a shared
//   [64][65] slab and sums them there into the warp's rows of dbias_h and
//   dbias_w sums kept in shared memory, two lanes to a row, each lane
//   owning the grid rows and columns of its parity; written at the end.
// Every element is summed in a fixed order by one thread: no atomics.
template <bool ROW_TILE>
__global__ void __launch_bounds__(TC_NT)
gb_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ g,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, bf16* __restrict__ dq,
                 GridBias bias, int sq, int sk, float scale) {
  constexpr int D = GB_D, BM = TC_ROWS, BN = TC_ROWS, S = Tile<D>::STRIDE;
  const int kh = bias.kh, kw = bias.kw;
  const int hst = gb_dq_stride(kh), wst = gb_dq_stride(kw);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [BM][S]
  bf16* gs = qs + BM * S;                        // [BM][S]
  bf16* ks = gs + BM * S;                        // [2][BN][S] ring
  bf16* vs = ks + 2 * BN * S;                    // [2][BN][S] ring
  float* hs = reinterpret_cast<float*>(vs + 2 * BN * S);  // [BM][hst] bias_h
  float* ws = hs + BM * hst;                              // [BM][wst] bias_w
  float* dss = ws + BM * wst;          // [BM][BN + 1] ds (not ROW_TILE)
  float* dhs = dss + BM * (BN + 1);    // [BM][kh + 1] dbias_h sums (ditto)
  float* dws = dhs + BM * (kh + 1);    // [BM][kw + 1] dbias_w sums (ditto)

  const int bh = blockIdx.y, q0 = blockIdx.x * BM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g4 = lane >> 2, t4 = lane & 3;
  const bf16* qb = q + (size_t)bh * sq * D;
  const bf16* gb = g + (size_t)bh * sq * D;
  const bf16* kb = k + (size_t)bh * sk * D;
  const bf16* vb = v + (size_t)bh * sk * D;

  load_tile<D, BM>(qs, qb, q0, sq, tid);
  load_tile<D, BM>(gs, gb, q0, sq, tid);
  load_rows_f32(hs, hst, bias.h + (size_t)bh * sq * kh, kh, 0, kh, q0, sq,
                bias.vec, tid);
  load_rows_f32(ws, wst, bias.w + (size_t)bh * sq * kw, kw, 0, kw, q0, sq,
                bias.vec, tid);
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
  const float* h_lo = hs + (w0 + g4) * hst;
  const float* h_hi = h_lo + 8 * hst;
  const float* w_lo = ws + (w0 + g4) * wst;
  const float* w_hi = w_lo + 8 * wst;

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  // ROW_TILE: dbias_w of this lane's rows and columns j·8 + 2·t4 (+ 1)
  float dbw[ROW_TILE ? BN / 8 : 1][4];
  if constexpr (ROW_TILE) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
      dbw[j][0] = dbw[j][1] = dbw[j][2] = dbw[j][3] = 0.f;
  } else {  // the warp's rows of the sums; visible after the loop's barrier
    for (int i = lane; i < 16 * (kh + 1); i += 32)
      dhs[w0 * (kh + 1) + i] = 0.f;
    for (int i = lane; i < 16 * (kw + 1); i += 32)
      dws[w0 * (kw + 1) + i] = 0.f;
  }

  const int nt = (sk + BN - 1) / BN;
  for (int t = 0; t < nt; ++t) {
    const int st = t & 1;
    if (t + 1 < nt) {  // the next K/V tile into the other stage
      load_tile<D, BN>(ks + (st ^ 1) * BN * S, kb, (t + 1) * BN, sk, tid);
      load_tile<D, BN>(vs + (st ^ 1) * BN * S, vb, (t + 1) * BN, sk, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // every thread's copies of this stage are in
    const bf16* kt = ks + st * BN * S;
    const bf16* vt = vs + st * BN * S;

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

    // p = exp(scale·s + bias_h[q, key / kw] + bias_w[q, key % kw] − lse) and
    // the unscaled ds = p·(dp − delta) in f32, keys at or past sk masked
    // (p = 0); scale·ds as bf16 A fragments, 8-column tiles 2m and 2m + 1
    // making k-step m
    const int kb0 = t * BN;
    float bh_lo = 0.f, bh_hi = 0.f, rs_lo = 0.f, rs_hi = 0.f;
    if constexpr (ROW_TILE) {
      bh_lo = h_lo[t];
      bh_hi = h_hi[t];
    }
    uint32_t dsa[BN / 16][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = j * 8 + t4 * 2;  // this lane's two key columns
      bool in0 = true, in1 = true;   // ROW_TILE: sk = 64·kh, tiles whole
      float b0, b1, b2, b3;
      if constexpr (ROW_TILE) {
        const float2 wl = *reinterpret_cast<const float2*>(w_lo + c);
        const float2 wh = *reinterpret_cast<const float2*>(w_hi + c);
        b0 = bh_lo + wl.x;
        b1 = bh_lo + wl.y;
        b2 = bh_hi + wh.x;
        b3 = bh_hi + wh.y;
      } else {
        const int key = kb0 + c;
        in0 = key < sk;
        in1 = key + 1 < sk;
        const int m0 = in0 ? key / kw : 0, n0 = in0 ? key - m0 * kw : 0;
        const int m1 = in1 ? (key + 1) / kw : 0;
        const int n1 = in1 ? key + 1 - m1 * kw : 0;
        b0 = h_lo[m0] + w_lo[n0];
        b1 = h_lo[m1] + w_lo[n1];
        b2 = h_hi[m0] + w_hi[n0];
        b3 = h_hi[m1] + w_hi[n1];
      }
      const float p0 = in0 ? exp2f(fmaf(s[j][0], scale, b0) * LOG2E - l_lo)
                           : 0.f;
      const float p1 = in1 ? exp2f(fmaf(s[j][1], scale, b1) * LOG2E - l_lo)
                           : 0.f;
      const float p2 = in0 ? exp2f(fmaf(s[j][2], scale, b2) * LOG2E - l_hi)
                           : 0.f;
      const float p3 = in1 ? exp2f(fmaf(s[j][3], scale, b3) * LOG2E - l_hi)
                           : 0.f;
      const float ds0 = p0 * (dp[j][0] - d_lo), ds1 = p1 * (dp[j][1] - d_lo);
      const float ds2 = p2 * (dp[j][2] - d_hi), ds3 = p3 * (dp[j][3] - d_hi);
      dsa[j / 2][(j & 1) * 2] = pack_bf16(ds0 * scale, ds1 * scale);
      dsa[j / 2][(j & 1) * 2 + 1] = pack_bf16(ds2 * scale, ds3 * scale);
      if constexpr (ROW_TILE) {
        rs_lo += ds0 + ds1;
        rs_hi += ds2 + ds3;
        dbw[j][0] += ds0;
        dbw[j][1] += ds1;
        dbw[j][2] += ds2;
        dbw[j][3] += ds3;
      } else {
        float* d = dss + (w0 + g4) * (BN + 1) + c;
        d[0] = ds0;
        d[1] = ds1;
        d[8 * (BN + 1)] = ds2;
        d[8 * (BN + 1) + 1] = ds3;
      }
    }

    if constexpr (ROW_TILE) {  // dbias_h[q, t]: the row sums of the tile
      rs_lo += __shfl_xor_sync(0xffffffffu, rs_lo, 1);
      rs_hi += __shfl_xor_sync(0xffffffffu, rs_hi, 1);
      rs_lo += __shfl_xor_sync(0xffffffffu, rs_lo, 2);
      rs_hi += __shfl_xor_sync(0xffffffffu, rs_hi, 2);
      if (t4 == 0) {
        float* dhb = bias.dh + (size_t)bh * sq * kh + t;
        if (r_lo < sq) dhb[(size_t)r_lo * kh] = rs_lo;
        if (r_hi < sq) dhb[(size_t)r_hi * kh] = rs_hi;
      }
    } else {  // the tile's part of the warp's rows of both sums
      __syncwarp();
      const int rr = w0 + (lane >> 1), par = lane & 1;
      const float* row = dss + rr * (BN + 1);
      const int cmax = min(BN, sk - kb0), kb_mod = kb0 % kw;
      float* dwr = dws + rr * (kw + 1);
      for (int n = par; n < kw; n += 2) {
        float sum = 0.f;
        for (int c = (n - kb_mod + kw) % kw; c < cmax; c += kw) sum += row[c];
        dwr[n] += sum;
      }
      float* dhr = dhs + rr * (kh + 1);
      const int m0 = kb0 / kw, m1 = (kb0 + cmax - 1) / kw;
      for (int m = m0 + ((m0 & 1) != par); m <= m1; m += 2) {
        const int lo = max(m * kw - kb0, 0), hi = min((m + 1) * kw - kb0, cmax);
        float sum = 0.f;
        for (int c = lo; c < hi; ++c) sum += row[c];
        dhr[m] += sum;
      }
      __syncwarp();  // the slab is rewritten by the next tile
    }

    // dq += (scale·ds)·k: depth = the tile's keys, columns = D
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
  float* dhb = bias.dh + (size_t)bh * sq * kh;
  float* dwb = bias.dw + (size_t)bh * sq * kw;
  if constexpr (ROW_TILE) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = j * 8 + t4 * 2;
      if (r_lo < sq) {
        dwb[(size_t)r_lo * kw + c] = dbw[j][0];
        dwb[(size_t)r_lo * kw + c + 1] = dbw[j][1];
      }
      if (r_hi < sq) {
        dwb[(size_t)r_hi * kw + c] = dbw[j][2];
        dwb[(size_t)r_hi * kw + c + 1] = dbw[j][3];
      }
    }
  } else {  // the warp's rows of the sums
    for (int i = lane; i < 16 * kh; i += 32) {
      const int r = i / kh, m = i - r * kh;
      if (q0 + w0 + r < sq)
        dhb[(size_t)(q0 + w0 + r) * kh + m] = dhs[(w0 + r) * (kh + 1) + m];
    }
    for (int i = lane; i < 16 * kw; i += 32) {
      const int r = i / kw, n = i - r * kw;
      if (q0 + w0 + r < sq)
        dwb[(size_t)(q0 + w0 + r) * kw + n] = dws[(w0 + r) * (kw + 1) + n];
    }
  }
}

// The grid-bias dkv kernel: dk and dv. One block per (batch·head, 64
// keys), four warps of 16 keys, the products as in bwd_dkv_kernel (sᵀ and
// dpᵀ with keys as rows, pᵀ and dsᵀ straight into A fragments). Each
// streamed query tile brings, on the same cp.async ring as its Q, g, lse and
// delta, its [64][kw] rows of bias_w and the columns of bias_h for the nr
// key-grid rows that the block's keys touch (one at kw = 64). A lane's two
// keys have fixed grid rows and columns, so each of its logits adds two
// shared-memory reads of the query's bias rows.
__global__ void __launch_bounds__(TC_NT)
gb_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ g,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, bf16* __restrict__ dk,
                  bf16* __restrict__ dv, GridBias bias, int nr, int sq, int sk,
                  float scale) {
  constexpr int D = GB_D, BM = TC_ROWS, BN = TC_ROWS, S = Tile<D>::STRIDE;
  const int kh = bias.kh, kw = bias.kw, wst = gb_dkv_stride(kw);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [BM][S]
  bf16* vs = ks + BM * S;                        // [BM][S]
  bf16* qs = vs + BM * S;                        // [2][BN][S] ring
  bf16* gs = qs + 2 * BN * S;                    // [2][BN][S] ring
  float* wsr = reinterpret_cast<float*>(gs + 2 * BN * S);  // [2][BN][wst]
  float* hsr = wsr + 2 * BN * wst;                         // [2][BN][nr]
  float* ls = hsr + 2 * BN * nr;                           // [2][BN] lse
  float* dls = ls + 2 * BN;                                // [2][BN] delta

  const int bh = blockIdx.y, k0 = blockIdx.x * BM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g4 = lane >> 2, t4 = lane & 3;
  const bf16* qb = q + (size_t)bh * sq * D;
  const bf16* gb = g + (size_t)bh * sq * D;
  const bf16* kb = k + (size_t)bh * sk * D;
  const bf16* vb = v + (size_t)bh * sk * D;
  const float* hb = bias.h + (size_t)bh * sq * kh;
  const float* wb = bias.w + (size_t)bh * sq * kw;
  const float* lb = lse + (size_t)bh * sq;
  const float* db = delta + (size_t)bh * sq;
  // the block's keys lie in key-grid rows m0 .. m0 + rows − 1 (rows ≤ nr)
  const int m0 = k0 / kw;
  const int rows = (min(k0 + BM, sk) - 1) / kw - m0 + 1;

  // one streamed tile: BN rows of Q and g, their bias rows, lse and delta
  auto load_q_tile = [&](int stage, int r0) {
    load_tile<D, BN>(qs + stage * BN * S, qb, r0, sq, tid);
    load_tile<D, BN>(gs + stage * BN * S, gb, r0, sq, tid);
    load_rows_f32(wsr + stage * BN * wst, wst, wb, kw, 0, kw, r0, sq,
                  bias.vec, tid);
    load_rows_f32(hsr + stage * BN * nr, nr, hb, kh, m0, rows, r0, sq, false,
                  tid);
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
  // this lane's keys k0 + w0 + g4 (lo) and + 8 (hi): their grid row, as a
  // column of the hs slab, and grid column; keys at or past sk read column
  // 0 (their rows are never stored)
  const int key_lo = k0 + w0 + g4, key_hi = key_lo + 8;
  const int mh_lo = key_lo < sk ? key_lo / kw - m0 : 0;
  const int mh_hi = key_hi < sk ? key_hi / kw - m0 : 0;
  const int nw_lo = key_lo < sk ? key_lo % kw : 0;
  const int nw_hi = key_hi < sk ? key_hi % kw : 0;

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  const int nt = (sq + BN - 1) / BN;
  for (int t = 0; t < nt; ++t) {
    const int st = t & 1;
    if (t + 1 < nt) {  // the next query tile into the other stage
      load_q_tile(st ^ 1, (t + 1) * BN);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // every thread's copies of this stage are in
    const bf16* qt = qs + st * BN * S;
    const bf16* gt = gs + st * BN * S;
    const float* wt = wsr + st * BN * wst;
    const float* ht = hsr + st * BN * nr;
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

    // pᵀ and dsᵀ = pᵀ·(dpᵀ − delta)·scale with the bias in the logits,
    // queries at or past sq masked (p = 0), as bf16 A fragments
    uint32_t pa[BN / 16][4], dsa[BN / 16][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = j * 8 + t4 * 2;  // this lane's two query columns
      const bool in0 = t * BN + c < sq, in1 = t * BN + c + 1 < sq;
      const float l0 = lt[c] * LOG2E, l1 = lt[c + 1] * LOG2E;
      const float e0 = dlt[c], e1 = dlt[c + 1];
      const float* h0 = ht + c * nr;   // query c's bias_h columns
      const float* h1 = h0 + nr;       // query c + 1's
      const float* v0 = wt + c * wst;  // query c's bias_w row
      const float* v1 = v0 + wst;
      const float b0 = h0[mh_lo] + v0[nw_lo], b1 = h1[mh_lo] + v1[nw_lo];
      const float b2 = h0[mh_hi] + v0[nw_hi], b3 = h1[mh_hi] + v1[nw_hi];
      const float p0 = in0 ? exp2f(fmaf(s[j][0], scale, b0) * LOG2E - l0)
                           : 0.f;
      const float p1 = in1 ? exp2f(fmaf(s[j][1], scale, b1) * LOG2E - l1)
                           : 0.f;
      const float p2 = in0 ? exp2f(fmaf(s[j][2], scale, b2) * LOG2E - l0)
                           : 0.f;
      const float p3 = in1 ? exp2f(fmaf(s[j][3], scale, b3) * LOG2E - l1)
                           : 0.f;
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

template <bool ROW_TILE>
cudaError_t launch_gb_dq(const void* q, const void* k, const void* v,
                         const void* g, const void* lse, const void* delta,
                         void* dq, GridBias gb, int bh, int sq, int sk,
                         float scale, cudaStream_t stream) {
  size_t smem = sizeof(bf16) * 6 * TC_ROWS * Tile<GB_D>::STRIDE +
                sizeof(float) * TC_ROWS *
                    (gb_dq_stride(gb.kh) + gb_dq_stride(gb.kw));
  if (!ROW_TILE)
    smem += sizeof(float) * TC_ROWS *
            ((size_t)(TC_ROWS + 1) + (gb.kh + 1) + (gb.kw + 1));
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      gb_bwd_dq_kernel<ROW_TILE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + TC_ROWS - 1) / TC_ROWS, bh);
  gb_bwd_dq_kernel<ROW_TILE><<<grid, TC_NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(g),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), gb, sq, sk, scale);
  return cudaGetLastError();
}

cudaError_t launch_gb_dkv(const void* q, const void* k, const void* v,
                          const void* g, const void* lse, const void* delta,
                          void* dk, void* dv, GridBias gb, int bh, int sq,
                          int sk, float scale, cudaStream_t stream) {
  // the most key-grid rows that one tile of TC_ROWS consecutive keys touches
  const int nr = min(gb.kh, (TC_ROWS - 1) / gb.kw + 2);
  const size_t smem =
      sizeof(bf16) * 6 * TC_ROWS * Tile<GB_D>::STRIDE +
      sizeof(float) * 2 * TC_ROWS * ((size_t)gb_dkv_stride(gb.kw) + nr + 2);
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      gb_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sk + TC_ROWS - 1) / TC_ROWS, bh);
  gb_bwd_dkv_kernel<<<grid, TC_NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(g),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), gb, nr, sq, sk, scale);
  return cudaGetLastError();
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
    case 4: return (int)launch_dq<4>(q, k, v, g, lse, delta, dq, bh, sq, sk, scale, st);
    case 8: return (int)launch_dq<8>(q, k, v, g, lse, delta, dq, bh, sq, sk, scale, st);
    case 12: return (int)launch_dq<12>(q, k, v, g, lse, delta, dq, bh, sq, sk, scale, st);
    case 16: return (int)launch_dq<16>(q, k, v, g, lse, delta, dq, bh, sq, sk, scale, st);
    case 24: return (int)launch_dq<24>(q, k, v, g, lse, delta, dq, bh, sq, sk, scale, st);
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
    case 4: return (int)launch_dkv<4>(q, k, v, g, lse, delta, dk, dv, bh, sq, sk, scale, st);
    case 8: return (int)launch_dkv<8>(q, k, v, g, lse, delta, dk, dv, bh, sq, sk, scale, st);
    case 12: return (int)launch_dkv<12>(q, k, v, g, lse, delta, dk, dv, bh, sq, sk, scale, st);
    case 16: return (int)launch_dkv<16>(q, k, v, g, lse, delta, dk, dv, bh, sq, sk, scale, st);
    case 24: return (int)launch_dkv<24>(q, k, v, g, lse, delta, dk, dv, bh, sq, sk, scale, st);
    case 32: return (int)launch_dkv<32>(q, k, v, g, lse, delta, dk, dv, bh, sq, sk, scale, st);
    case 64: return (int)launch_dkv<64>(q, k, v, g, lse, delta, dk, dv, bh, sq, sk, scale, st);
    case 128: return (int)launch_dkv<128>(q, k, v, g, lse, delta, dk, dv, bh, sq, sk, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

// As flash_bwd_dq_bf16 (q, k, v, g and dq 16-byte aligned), with the grid
// bias: bias_h and dbias_h (bh, sq, kh), bias_w and dbias_w (bh, sq, kw),
// contiguous f32, sk = kh·kw, d = 80.
extern "C" int flash_gb_bwd_dq_bf16(const void* q, const void* k,
                                    const void* v, const void* bias_h,
                                    const void* bias_w, const void* g,
                                    const void* lse, const void* delta,
                                    void* dq, void* dbias_h, void* dbias_w,
                                    int bh, int sq, int sk, int kh, int kw,
                                    int d, float scale, void* stream) {
  if (bad_shape(bh, sq, sk) || bad_grid(sk, kh, kw) || d != GB_D ||
      misaligned(q, k, v, g, dq))
    return (int)cudaErrorInvalidValue;
  const GridBias gb{static_cast<const float*>(bias_h),
                    static_cast<const float*>(bias_w),
                    static_cast<float*>(dbias_h), static_cast<float*>(dbias_w),
                    kh, kw, bias_vec(bias_h, bias_w, kh, kw)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kw == TC_ROWS)
    return (int)launch_gb_dq<true>(q, k, v, g, lse, delta, dq, gb, bh, sq, sk,
                                   scale, st);
  return (int)launch_gb_dq<false>(q, k, v, g, lse, delta, dq, gb, bh, sq, sk,
                                  scale, st);
}

// As flash_gb_bwd_dq_bf16; dk and dv (bh, sk, d) contiguous bf16, 16-byte
// aligned.
extern "C" int flash_gb_bwd_dkv_bf16(const void* q, const void* k,
                                     const void* v, const void* bias_h,
                                     const void* bias_w, const void* g,
                                     const void* lse, const void* delta,
                                     void* dk, void* dv, int bh, int sq,
                                     int sk, int kh, int kw, int d,
                                     float scale, void* stream) {
  if (bad_shape(bh, sq, sk) || bad_grid(sk, kh, kw) || d != GB_D ||
      misaligned(q, k, v, g, dk, dv))
    return (int)cudaErrorInvalidValue;
  const GridBias gb{static_cast<const float*>(bias_h),
                    static_cast<const float*>(bias_w), nullptr, nullptr, kh,
                    kw, bias_vec(bias_h, bias_w, kh, kw)};
  return (int)launch_gb_dkv(q, k, v, g, lse, delta, dk, dv, gb, bh, sq, sk,
                            scale, static_cast<cudaStream_t>(stream));
}
