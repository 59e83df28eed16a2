// Flash-attention forward for Hopper (sm_90a) on the tensor cores: plain
// (head dims 4, 8, 12, 16, 24, 32, 64, 96, 128 and 512) and with SAM's factored
// key-grid bias (D = 80). bf16 q, k, v and o; f32 bias factors; f32 row logsumexp in the
// natural log, which the backward kernels (flash_bwd.cu) read.
//
// Replaces: regen3d_tpu/ops/attention.py::_flash_fwd_kernel (reached through
// _flash_forward and flash_attention) and ::_flash_fwd_gb_kernel (reached
// through _gb_fwd_impl and flash_attention_grid_bias) (Pallas, TPU): both
// are instances of fwd_kernel here.
//
// Per (batch·head), with keys on a (kh, kw) grid for the grid bias
// (Sk = kh·kw, key k at row k / kw and column k % kw):
//   s[q, k] = scale·q·k (+ bias_h[q, k / kw] + bias_w[q, k % kw]),
//   o = softmax(s)·v,   lse[q] = log Σ_k exp(s[q, k]).
//
// What bounds it on the H100: 4·Sq·Sk·D operations per head against
// 2·(2·Sq + 2·Sk)·D bytes (q, k and v read, o written), so at VGGT-1B's and
// DiT-base's shapes (S = 257 to 2748, D = 64), SAM-H's global blocks
// ((1, 16, 4096, 80)) and the saliency net's stem ((1, 2, 3136, 96))
// operations bound it, the bf16 tensor cores' rate. At the mask decoder's
// 11-token shapes and the saliency decode's single key the bytes and the
// launch do.
//
// The design, the backward pair's (flash_bwd.cu) turned to the forward:
// * One block per (batch·head, BM query rows), four warps. A warp owns MT
//   m16 tiles of rows: 32 rows (MT = 2, 128-row blocks) at D ≤ 64, so that
//   each K and V fragment feeds two products (245 registers at D = 64, no
//   spills); 16 rows (64-row blocks) at D = 80 and 128, where two m16
//   tiles' o accumulators, Q fragments and s do not fit in 255 registers
//   (D = 80 spilled 120 bytes); D = 96 is the same: 16 rows a warp.
// * The Q fragments are loaded once by ldmatrix and stay in registers for
//   the whole key loop. The block's Q tile in shared memory is used again
//   only to stage o.
// * K and V stream by cp.async into a two-stage ring of 64-key bf16 tiles
//   (swizzled; Tile's padded rows at D = 80 and 96): the next tile is in flight
//   while the current one is multiplied. Keys past Sk are zero-filled by
//   the copy and masked in registers (p = 0); query rows past Sq are
//   zero-filled and never stored. The caller pads nothing.
// * s = q·kᵀ by mma.sync.m16n8k16, bf16 × bf16 → f32, q and k unscaled: the
//   products are exact in f32. The scale, times log2(e) for exp2, is
//   applied to the f32 s fragment (the bias added there in f32), so s
//   differs from the plain version only in the order of its sums.
// * The online softmax runs on the f32 C fragments: each row's max and sum
//   over its four lanes by quad shuffles, the running max m and sum l (of
//   the f32 p) in registers, o rescaled by alpha = exp2(m_old − m_new).
// * p becomes bf16 in registers: two neighbouring m16n8 C tiles are the A
//   fragment of p·v, so p never touches shared memory; v is the B operand
//   through ldmatrix.trans.
// * Rounding: p is rounded to bf16 once, where the C fragment becomes an A
//   fragment, and o once, normalised, at the end. Everything else is f32.
//   o leaves through the warp's own rows of the Q tile with 16-byte stores;
//   lse = (m + log2 l)·ln 2.
// * Short query sets (Sq ≤ 16 with more than one key tile, such as the mask
//   decoder's 11 prompt tokens against 4096 image tokens): one tile of rows
//   must not walk every key alone, so the block's four warps share its 16
//   rows and split the keys. A stage of the ring holds four 64-key tiles,
//   one per warp; each warp keeps its own (m, l, o), and warp 0 combines
//   the four through shared memory in a fixed order, so two launches give
//   the same bits. (D = 96 and 128 do not split: four 64-key tiles of K and
//   V in two stages would need 226 and 256 KB, one block an SM at best.)
// * The grid bias: the (S, S) bias never exists. Each f32 s element adds
//   bias_h[q, k / kw] + bias_w[q, k % kw] before the max, in fragment
//   order, as the backward's dq kernel does. At kw = 64 (SAM-H's 64 × 64
//   grid) a 64-key tile is key-grid row t: bias_w comes from the block's
//   [BM][72] f32 slab as float2, and the tile's column t of bias_h rides the
//   ring with K and V, one value a row. At any other grid (the small SAM's
//   32 × 32, a kw that does not divide 64) the block keeps its rows of both
//   factors in shared memory and each element indexes them.
//
// * D = 8 (the random-init tiny generator's condition encoder, 4 heads of
//   8, which the MIDI and DPA baselines build without a checkpoint) is
//   below mma.sync's depth of 16. Its instance computes at width
//   DC<8> = 16 in shared memory and registers, the D = 16 tiling: the
//   copies of q, k and v fill each row's second 16-byte chunk with zeros
//   (cp.async with no source bytes), so q·kᵀ adds exact zeros and s is
//   the same as at D = 8;
//   p·v skips the second 8-column tile of o, whose v columns are zero, and
//   the store writes o's 8 columns. Nothing is padded in device memory:
//   q, k, v and o are (bh, S, 8). On zero-padded inputs the D = 16
//   instance does the same arithmetic, so o's first 8 columns and lse
//   agree with it bit for bit. At the baselines' shapes (a few objects'
//   16 tokens, 4 heads) the launch bounds it, not bytes or operations.
//   D = 4 (the tiny SD UNet's heads) is the same at half a chunk: each
//   row's 8 bytes are copied and the other 24 zero-filled (tc_tiles.cuh's
//   load_tile), p·v skips the same second tile, and the store writes 8
//   bytes a row, so it agrees bit for bit with the D = 8 and D = 16
//   instances on zero-padded inputs.
//   D = 12 (the distilled detector's text tower, 4 heads of 48) and D = 24
//   (its image tower and the distilled saliency net, heads of 96 / 4 and
//   48 / 2) run the same way at width 16 and 32: a D = 12 row is 24 bytes,
//   only 8-byte aligned, so it comes as three 8-byte copies and one with no
//   source bytes; a D = 24 row is 48 bytes, three 16-byte copies and one
//   with none. The scale is 1/√D of the true D, p·v skips the last 8-column
//   tile at D = 24 (at D = 12 half of it is live), and the store writes the
//   first D columns only, so each agrees bit for bit with the width-16 or
//   width-32 instance on zero-padded inputs.
//
// * D = 512 (the SD VAE's mid-block attention: one head of 512 over the
//   64² latent grid) is its own kernel, fwd_wide_kernel. At D ≤ 128 a warp
//   keeps its rows' whole o in registers; a 16-row slice of o at D = 512 is
//   256 f32 registers a thread, past the 255 a thread has. So the block
//   (64 query rows, eight warps) splits the two products differently:
//   - s = q·kᵀ (64 rows × 64 keys, reduced over D in 32 steps of 16): warp
//     w takes m16 tile w % 4 and key half w / 4, its Q and K fragments
//     read by ldmatrix from the block's shared tiles at every step (the Q
//     fragments of a row at D = 512 are 128 registers, so they do not stay);
//   - the online softmax: each row's max over its key half by quad
//     shuffles, then over both halves through shared memory; both warps of
//     a row tile keep the same (m, alpha) and their own half's sum l, and
//     p goes to shared memory as bf16 (64 × 64), alpha beside it;
//   - o += p·v: warp w owns o's columns [64·w, 64·w + 64) for all 64 rows
//     (four m16 tiles × eight n8 tiles, 128 f32 registers a thread),
//     rescales them by each row's alpha, and multiplies the shared p by its
//     columns of V (ldmatrix.trans).
//   Q, one K tile and one V tile (64 KB each), p and the row statistics
//   take 201 KB of shared memory, so there is one stage of each: K tile
//   t + 1 streams in while p·v of tile t runs, V tile t + 1 while q·kᵀ of
//   tile t + 1 runs. Rounding is the other instances': p to bf16 once, o
//   once; keys past Sk are zero-filled and masked, rows past Sq never
//   stored. Operations bound it: at (B, 1, 4096, 4096, 512) 4·S²·D is
//   34.4 GFLOP a head against 16.8 MB of q, k, v and o. Each block reads
//   every key tile (64 query rows a block: 64 blocks a head, half of the
//   132 SMs at B = 1), and its fragments come from shared memory for
//   every product, which the D ≤ 128 instances keep in registers.
//
// Shared memory passes 48 KB, so the launches opt in with
// cudaFuncSetAttribute.

#include "tc_tiles.cuh"

namespace {

// bias policies
constexpr int NO_BIAS = 0;    // plain attention
constexpr int GRID_ROW = 1;   // grid bias, kw = 64: a key tile is a grid row
constexpr int GRID_ANY = 2;   // grid bias, any (kh, kw) with kh·kw = Sk

constexpr int FWD_BN = 64;    // keys of a warp's tile
constexpr float LN2 = 0.6931471805599453f;

// The block's tiling at head dim D, SPLIT: the keys split across the warps.
template <int D, bool SPLIT>
struct Fwd {
  static constexpr int MT = SPLIT || D > 64 ? 1 : 2;    // m16 tiles a warp
  static constexpr int BM = SPLIT ? 16 : 4 * 16 * MT;   // query rows a block
  static constexpr int QROWS = BM < TC_ROWS ? TC_ROWS : BM;  // Q tile rows
  static constexpr int KT = SPLIT ? 4 * FWD_BN : FWD_BN;     // keys a stage
};

// D is the head dim of q, k, v and o in device memory; W = DC<D> the width
// of the tiles and fragments
template <int D, int BIAS, bool SPLIT>
__global__ void __launch_bounds__(TC_NT)
fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, GridBias bias, bf16* __restrict__ o,
           float* __restrict__ lse, int sq, int sk, float scale) {
  constexpr int W = DC<D>;
  using F = Fwd<W, SPLIT>;
  constexpr int MT = F::MT, BM = F::BM, KT = F::KT, BN = FWD_BN;
  constexpr int S = Tile<W>::STRIDE;
  constexpr bool GB = BIAS != NO_BIAS;
  static_assert(!(GB && SPLIT), "the grid bias runs unsplit");
  const int kh = bias.kh, kw = bias.kw;
  const int wst = GB ? gb_dq_stride(kw) : 0;
  const int hst = BIAS == GRID_ANY ? gb_dq_stride(kh) : 0;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [QROWS][S]
  bf16* ks = qs + F::QROWS * S;                  // [2][KT][S] ring
  bf16* vs = ks + 2 * KT * S;                    // [2][KT][S] ring
  float* ws = reinterpret_cast<float*>(vs + 2 * KT * S);  // [BM][wst] bias_w
  float* hs = ws + BM * wst;  // GRID_ANY: [BM][hst] bias_h; GRID_ROW: [2][BM]
                              // bias_h columns on the ring

  const int bh = blockIdx.y, q0 = blockIdx.x * BM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g4 = lane >> 2, t4 = lane & 3;
  const int w0 = SPLIT ? 0 : warp * 16 * MT;  // the warp's first row
  const int kofs = SPLIT ? warp * BN : 0;     // the warp's keys in a stage
  const bf16* qb = q + (size_t)bh * sq * D;
  const bf16* kb = k + (size_t)bh * sk * D;
  const bf16* vb = v + (size_t)bh * sk * D;
  const float* hb = GB ? bias.h + (size_t)bh * sq * kh : nullptr;

  // column t of the block's bias_h rows, one 4-byte copy a row
  auto load_hcol = [&](int stage, int t) {
    for (int i = tid; i < BM; i += TC_NT) {
      const bool in = q0 + i < sq;
      cp_async4(hs + stage * BM + i, hb + (size_t)(in ? q0 + i : 0) * kh + t,
                in);
    }
  };

  // group 0: the Q tile and the bias slabs; group 1: the first K/V tile
  load_tile<W, F::QROWS, D>(qs, qb, q0, sq, tid);
  if constexpr (GB) {
    for (int r = 0; r < BM; r += TC_ROWS) {
      load_rows_f32(ws + r * wst, wst, bias.w + (size_t)bh * sq * kw, kw, 0,
                    kw, q0 + r, sq, bias.vec, tid);
      if constexpr (BIAS == GRID_ANY)
        load_rows_f32(hs + r * hst, hst, hb, kh, 0, kh, q0 + r, sq, bias.vec,
                      tid);
    }
  }
  cp_async_commit();
  load_tile<W, KT, D>(ks, kb, 0, sk, tid);
  load_tile<W, KT, D>(vs, vb, 0, sk, tid);
  if constexpr (BIAS == GRID_ROW) load_hcol(0, 0);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();  // every thread's copies of group 0 are in

  uint32_t qa[MT][W / 16][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int kk = 0; kk < W / 16; ++kk)
      load_a<W>(qa[mt][kk], qs, w0 + mt * 16, kk * 16, lane);

  float acc[MT][W / 8][4];
  float m[MT][2], l[MT][2];  // running max (log2 units) and sum, rows lo, hi
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int j = 0; j < W / 8; ++j)
      acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] = 0.f;
    m[mt][0] = m[mt][1] = -INFINITY;
    l[mt][0] = l[mt][1] = 0.f;
  }
  const float sl2 = scale * LOG2E;

  const int nt = (sk + KT - 1) / KT;
  for (int t = 0; t < nt; ++t) {
    const int st = t & 1;
    if (t + 1 < nt) {  // the next K/V tile into the other stage
      load_tile<W, KT, D>(ks + (st ^ 1) * KT * S, kb, (t + 1) * KT, sk, tid);
      load_tile<W, KT, D>(vs + (st ^ 1) * KT * S, vb, (t + 1) * KT, sk, tid);
      if constexpr (BIAS == GRID_ROW) load_hcol(st ^ 1, t + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // every thread's copies of this stage are in
    const bf16* kt = ks + (st * KT + kofs) * S;
    const bf16* vt = vs + (st * KT + kofs) * S;

    // s = q·kᵀ, MT·16 × BN per warp; each K fragment feeds MT products
    float s[MT][BN / 8][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
        s[mt][j][0] = s[mt][j][1] = s[mt][j][2] = s[mt][j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < W / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < BN; n += 16) {
        uint32_t kf[4];
        load_b_nk<W>(kf, kt, n, kk * 16, lane);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma(s[mt][n / 8], qa[mt][kk], kf[0], kf[1]);
          mma(s[mt][n / 8 + 1], qa[mt][kk], kf[2], kf[3]);
        }
      }
    }

    // the online softmax on the C fragments; p as bf16 A fragments,
    // 8-column tiles 2i and 2i + 1 making k-step i
    const int key0 = t * KT + kofs;
    uint32_t pa[MT][BN / 16][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int rl = w0 + mt * 16 + g4;  // this lane's rows: rl and rl + 8
      float bh_lo = 0.f, bh_hi = 0.f;
      if constexpr (BIAS == GRID_ROW) {
        bh_lo = hs[st * BM + rl];
        bh_hi = hs[st * BM + rl + 8];
      }
      const float* w_lo = ws + rl * wst;
      const float* w_hi = w_lo + 8 * wst;
      const float* h_lo = hs + rl * hst;
      const float* h_hi = h_lo + 8 * hst;
      // logits in log2 units, keys at or past sk at −inf
      float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = j * 8 + t4 * 2;  // this lane's two key columns
        float* x = s[mt][j];
        if constexpr (BIAS == NO_BIAS) {
          const int key = key0 + c;
          const bool in0 = key < sk, in1 = key + 1 < sk;
          x[0] = in0 ? x[0] * sl2 : -INFINITY;
          x[1] = in1 ? x[1] * sl2 : -INFINITY;
          x[2] = in0 ? x[2] * sl2 : -INFINITY;
          x[3] = in1 ? x[3] * sl2 : -INFINITY;
        } else if constexpr (BIAS == GRID_ROW) {  // sk = 64·kh: tiles whole
          const float2 wl = *reinterpret_cast<const float2*>(w_lo + c);
          const float2 wh = *reinterpret_cast<const float2*>(w_hi + c);
          x[0] = fmaf(x[0], scale, bh_lo + wl.x) * LOG2E;
          x[1] = fmaf(x[1], scale, bh_lo + wl.y) * LOG2E;
          x[2] = fmaf(x[2], scale, bh_hi + wh.x) * LOG2E;
          x[3] = fmaf(x[3], scale, bh_hi + wh.y) * LOG2E;
        } else {
          const int key = key0 + c;
          const bool in0 = key < sk, in1 = key + 1 < sk;
          const int m0 = in0 ? key / kw : 0, n0 = in0 ? key - m0 * kw : 0;
          const int m1 = in1 ? (key + 1) / kw : 0;
          const int n1 = in1 ? key + 1 - m1 * kw : 0;
          x[0] = in0 ? fmaf(x[0], scale, h_lo[m0] + w_lo[n0]) * LOG2E
                     : -INFINITY;
          x[1] = in1 ? fmaf(x[1], scale, h_lo[m1] + w_lo[n1]) * LOG2E
                     : -INFINITY;
          x[2] = in0 ? fmaf(x[2], scale, h_hi[m0] + w_hi[n0]) * LOG2E
                     : -INFINITY;
          x[3] = in1 ? fmaf(x[3], scale, h_hi[m1] + w_hi[n1]) * LOG2E
                     : -INFINITY;
        }
        mx_lo = fmaxf(mx_lo, fmaxf(x[0], x[1]));
        mx_hi = fmaxf(mx_hi, fmaxf(x[2], x[3]));
      }
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
      const float mn_lo = fmaxf(m[mt][0], mx_lo);
      const float mn_hi = fmaxf(m[mt][1], mx_hi);
      // a row that has met no key yet (a split warp past sk) keeps p = 0
      const float b_lo = mn_lo == -INFINITY ? 0.f : mn_lo;
      const float b_hi = mn_hi == -INFINITY ? 0.f : mn_hi;
      const float a_lo = exp2f(m[mt][0] - b_lo);
      const float a_hi = exp2f(m[mt][1] - b_hi);
      m[mt][0] = mn_lo;
      m[mt][1] = mn_hi;
      float rs_lo = 0.f, rs_hi = 0.f;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const float p0 = exp2f(s[mt][j][0] - b_lo);
        const float p1 = exp2f(s[mt][j][1] - b_lo);
        const float p2 = exp2f(s[mt][j][2] - b_hi);
        const float p3 = exp2f(s[mt][j][3] - b_hi);
        rs_lo += p0 + p1;
        rs_hi += p2 + p3;
        pa[mt][j / 2][(j & 1) * 2] = pack_bf16(p0, p1);
        pa[mt][j / 2][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
      }
      l[mt][0] = l[mt][0] * a_lo + rs_lo;
      l[mt][1] = l[mt][1] * a_hi + rs_hi;
#pragma unroll
      for (int j = 0; j < W / 8; ++j) {
        acc[mt][j][0] *= a_lo;
        acc[mt][j][1] *= a_lo;
        acc[mt][j][2] *= a_hi;
        acc[mt][j][3] *= a_hi;
      }
    }

    // o += p·v: depth = the tile's keys, columns = D; each V fragment feeds
    // MT products (an 8-column tile of o past D, all zeros, is skipped)
#pragma unroll
    for (int i = 0; i < BN / 16; ++i) {
#pragma unroll
      for (int n = 0; n < W; n += 16) {
        uint32_t vf[4];
        load_b_kn<W>(vf, vt, i * 16, n, lane);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma(acc[mt][n / 8], pa[mt][i], vf[0], vf[1]);
          if (W == D || n + 8 < D)
            mma(acc[mt][n / 8 + 1], pa[mt][i], vf[2], vf[3]);
        }
      }
    }
    __syncthreads();  // this stage is refilled by tile t + 2
  }

  // each row's sum over its four lanes
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[mt][h] += __shfl_xor_sync(0xffffffffu, l[mt][h], 1);
      l[mt][h] += __shfl_xor_sync(0xffffffffu, l[mt][h], 2);
    }

  if constexpr (SPLIT) {
    // the four warps' (m, l, o) of the same 16 rows through the free ring,
    // in fragment order; warp 0 combines them in warp order
    float* cml = reinterpret_cast<float*>(ks);  // [4][32][4]: m, l lo and hi
    float* cacc = cml + 4 * 32 * 4;              // [4][W / 8][32][4]
    *reinterpret_cast<float4*>(cml + (warp * 32 + lane) * 4) =
        make_float4(m[0][0], m[0][1], l[0][0], l[0][1]);
#pragma unroll
    for (int j = 0; j < W / 8; ++j)
      *reinterpret_cast<float4*>(cacc + ((warp * (W / 8) + j) * 32 + lane) *
                                            4) =
          make_float4(acc[0][j][0], acc[0][j][1], acc[0][j][2], acc[0][j][3]);
    __syncthreads();
    if (warp != 0) return;
    // warp 0 has met key 0, so its maxima, and the combined ones, are finite
    float f[4][2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mmax = -INFINITY;
#pragma unroll
      for (int w = 0; w < 4; ++w) mmax = fmaxf(mmax, cml[(w * 32 + lane) * 4 + h]);
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        f[w][h] = exp2f(cml[(w * 32 + lane) * 4 + h] - mmax);
        sum += cml[(w * 32 + lane) * 4 + 2 + h] * f[w][h];
      }
      m[0][h] = mmax;
      l[0][h] = sum;
    }
#pragma unroll
    for (int j = 0; j < W / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < 4; ++w)
          sum += cacc[((w * (W / 8) + j) * 32 + lane) * 4 + e] * f[w][e >> 1];
        acc[0][j][e] = sum;
      }
  }

  // o = acc / l, rounded to bf16 once, out through the warp's rows of the Q
  // tile (read by no other warp); lse in the natural log
  float* lb = lse + (size_t)bh * sq;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const float l_lo = fmaxf(l[mt][0], 1e-30f), l_hi = fmaxf(l[mt][1], 1e-30f);
    const float i_lo = 1.f / l_lo, i_hi = 1.f / l_hi;
#pragma unroll
    for (int j = 0; j < W / 8; ++j) {
      acc[mt][j][0] *= i_lo;
      acc[mt][j][1] *= i_lo;
      acc[mt][j][2] *= i_hi;
      acc[mt][j][3] *= i_hi;
    }
    const int r0 = w0 + mt * 16;
    store_rows<W, D>(acc[mt], qs, r0, o + (size_t)bh * sq * D, q0 + r0, sq,
                     lane);
    if (t4 == 0) {
      const int r_lo = q0 + r0 + g4, r_hi = r_lo + 8;
      if (r_lo < sq) lb[r_lo] = (m[mt][0] + log2f(l_lo)) * LN2;
      if (r_hi < sq) lb[r_hi] = (m[mt][1] + log2f(l_hi)) * LN2;
    }
  }
}

template <int D, int BIAS, bool SPLIT>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       GridBias gb, void* o, void* lse, int bh, int sq, int sk,
                       float scale, cudaStream_t stream) {
  using F = Fwd<DC<D>, SPLIT>;
  size_t smem = sizeof(bf16) * (F::QROWS + 4 * F::KT) * Tile<DC<D>>::STRIDE;
  if (BIAS != NO_BIAS) smem += sizeof(float) * F::BM * gb_dq_stride(gb.kw);
  if (BIAS == GRID_ROW) smem += sizeof(float) * 2 * F::BM;
  if (BIAS == GRID_ANY) smem += sizeof(float) * F::BM * gb_dq_stride(gb.kh);
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fwd_kernel<D, BIAS, SPLIT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + F::BM - 1) / F::BM, bh);
  fwd_kernel<D, BIAS, SPLIT><<<grid, TC_NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), gb, static_cast<bf16*>(o),
      static_cast<float*>(lse), sq, sk, scale);
  return cudaGetLastError();
}

// D = 512 (fwd_wide_kernel): rows a block, keys a tile, threads a block
constexpr int WIDE_D = 512;
constexpr int WIDE_BM = 64;
constexpr int WIDE_BN = 64;
constexpr int WIDE_NT = 256;

__global__ void __launch_bounds__(WIDE_NT, 1)
fwd_wide_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ o,
                float* __restrict__ lse, int sq, int sk, float scale) {
  constexpr int D = WIDE_D, BM = WIDE_BM, BN = WIDE_BN;
  constexpr int CPR = D / 8;         // 16-byte chunks a row
  constexpr int OC = D / 8;          // o's columns a warp: 64
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [BM][D], Tile<D>
  bf16* ks = qs + BM * D;                        // [BN][D]
  bf16* vs = ks + BN * D;                        // [BN][D]
  bf16* ps = vs + BN * D;                        // [BM][BN] p, Tile<BN>
  float* red = reinterpret_cast<float*>(ps + BM * BN);  // [2][BM] half maxima
  float* alpha = red + 2 * BM;                   // [BM] o's rescale
  float* lsum = alpha + BM;                      // [2][BM] half sums

  const int bh = blockIdx.y, q0 = blockIdx.x * BM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g4 = lane >> 2, t4 = lane & 3;
  const int mt = warp & 3, half = warp >> 2;  // q·kᵀ: row tile, key half
  const int c0 = warp * OC;                   // p·v: the warp's columns
  const bf16* qb = q + (size_t)bh * sq * D;
  const bf16* kb = k + (size_t)bh * sk * D;
  const bf16* vb = v + (size_t)bh * sk * D;

  // rows [r0, r0 + 64) of a [n][D] array into a tile; rows past n zeroed
  auto load = [&](bf16* tile, const bf16* src, int r0, int n) {
#pragma unroll 4
    for (int i = tid; i < BN * CPR; i += WIDE_NT) {
      const int r = i / CPR, c = i % CPR;
      const bool in = r0 + r < n;
      cp_async16(tile + Tile<D>::off(r, c * 8),
                 src + (size_t)(in ? r0 + r : 0) * D + c * 8, in);
    }
  };
  static_assert(BM == BN, "one copy loop for the Q, K and V tiles");

  load(qs, qb, q0, sq);
  load(ks, kb, 0, sk);
  cp_async_commit();  // group: Q and K tile 0
  load(vs, vb, 0, sk);
  cp_async_commit();  // group: V tile 0

  float acc[4][OC / 8][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < OC / 8; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
  // rows r_lo = 16·mt + g4 and r_lo + 8: running max (log2 units), and
  // this key half's running sum
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;
  const int r_lo = mt * 16 + g4, r_hi = r_lo + 8;
  const float sl2 = scale * LOG2E;

  const int nt = (sk + BN - 1) / BN;
  for (int t = 0; t < nt; ++t) {
    cp_async_wait<1>();
    __syncthreads();  // K tile t in

    // s = q·kᵀ: this warp's 16 rows × its 32 keys
    float s[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll 8
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4];
      load_a<D>(qa, qs, mt * 16, kk * 16, lane);
#pragma unroll
      for (int n = 0; n < 32; n += 16) {
        uint32_t kf[4];
        load_b_nk<D>(kf, ks, half * 32 + n, kk * 16, lane);
        mma(s[n / 8], qa, kf[0], kf[1]);
        mma(s[n / 8 + 1], qa, kf[2], kf[3]);
      }
    }

    // logits in log2 units, keys at or past sk at −inf; this half's maxima
    const int key0 = t * BN + half * 32;
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = key0 + j * 8 + t4 * 2;
      const bool in0 = key < sk, in1 = key + 1 < sk;
      s[j][0] = in0 ? s[j][0] * sl2 : -INFINITY;
      s[j][1] = in1 ? s[j][1] * sl2 : -INFINITY;
      s[j][2] = in0 ? s[j][2] * sl2 : -INFINITY;
      s[j][3] = in1 ? s[j][3] * sl2 : -INFINITY;
      mx_lo = fmaxf(mx_lo, fmaxf(s[j][0], s[j][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[j][2], s[j][3]));
    }
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
    if (t4 == 0) {
      red[half * BM + r_lo] = mx_lo;
      red[half * BM + r_hi] = mx_hi;
    }
    __syncthreads();  // every warp is done with K tile t; maxima in
    if (t + 1 < nt) load(ks, kb, (t + 1) * BN, sk);
    cp_async_commit();  // group: K tile t + 1 (empty after the last)

    // both halves' max; the two warps of a row tile compute the same
    // (m, alpha) from the same values
    const float mn_lo = fmaxf(m_lo, fmaxf(red[r_lo], red[BM + r_lo]));
    const float mn_hi = fmaxf(m_hi, fmaxf(red[r_hi], red[BM + r_hi]));
    const float b_lo = mn_lo == -INFINITY ? 0.f : mn_lo;
    const float b_hi = mn_hi == -INFINITY ? 0.f : mn_hi;
    const float a_lo = exp2f(m_lo - b_lo), a_hi = exp2f(m_hi - b_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    float rs_lo = 0.f, rs_hi = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float p0 = exp2f(s[j][0] - b_lo), p1 = exp2f(s[j][1] - b_lo);
      const float p2 = exp2f(s[j][2] - b_hi), p3 = exp2f(s[j][3] - b_hi);
      rs_lo += p0 + p1;
      rs_hi += p2 + p3;
      const int col = half * 32 + j * 8 + t4 * 2;
      *reinterpret_cast<uint32_t*>(ps + Tile<BN>::off(r_lo, col)) =
          pack_bf16(p0, p1);
      *reinterpret_cast<uint32_t*>(ps + Tile<BN>::off(r_hi, col)) =
          pack_bf16(p2, p3);
    }
    l_lo = l_lo * a_lo + rs_lo;
    l_hi = l_hi * a_hi + rs_hi;
    if (half == 0 && t4 == 0) {
      alpha[r_lo] = a_lo;
      alpha[r_hi] = a_hi;
    }
    cp_async_wait<1>();
    __syncthreads();  // V tile t in; p and alpha in

    // o = alpha·o + p·v over the warp's 64 columns of all 64 rows
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float al = alpha[i * 16 + g4], ah = alpha[i * 16 + g4 + 8];
#pragma unroll
      for (int j = 0; j < OC / 8; ++j) {
        acc[i][j][0] *= al;
        acc[i][j][1] *= al;
        acc[i][j][2] *= ah;
        acc[i][j][3] *= ah;
      }
    }
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t pa[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) load_a<BN>(pa[i], ps, i * 16, kk * 16, lane);
#pragma unroll
      for (int n = 0; n < OC; n += 16) {
        uint32_t vf[4];
        load_b_kn<D>(vf, vs, kk * 16, c0 + n, lane);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          mma(acc[i][n / 8], pa[i], vf[0], vf[1]);
          mma(acc[i][n / 8 + 1], pa[i], vf[2], vf[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with V tile t and p
    if (t + 1 < nt) load(vs, vb, (t + 1) * BN, sk);
    cp_async_commit();  // group: V tile t + 1 (empty after the last)
  }
  cp_async_wait<0>();

  // each row's sum: its four lanes, then the two key halves in order
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
  if (t4 == 0) {
    lsum[half * BM + r_lo] = l_lo;
    lsum[half * BM + r_hi] = l_hi;
  }
  __syncthreads();

  // o = acc / l, rounded to bf16 once; lse in the natural log
  bf16* ob = o + (size_t)bh * sq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int rl = i * 16 + g4, rh = rl + 8;
    const float il = 1.f / fmaxf(lsum[rl] + lsum[BM + rl], 1e-30f);
    const float ih = 1.f / fmaxf(lsum[rh] + lsum[BM + rh], 1e-30f);
#pragma unroll
    for (int j = 0; j < OC / 8; ++j) {
      const int col = c0 + j * 8 + t4 * 2;
      if (q0 + rl < sq)
        *reinterpret_cast<uint32_t*>(ob + (size_t)(q0 + rl) * D + col) =
            pack_bf16(acc[i][j][0] * il, acc[i][j][1] * il);
      if (q0 + rh < sq)
        *reinterpret_cast<uint32_t*>(ob + (size_t)(q0 + rh) * D + col) =
            pack_bf16(acc[i][j][2] * ih, acc[i][j][3] * ih);
    }
  }
  if (half == 0 && t4 == 0) {
    float* lb = lse + (size_t)bh * sq;
    const float ll = fmaxf(lsum[r_lo] + lsum[BM + r_lo], 1e-30f);
    const float lh = fmaxf(lsum[r_hi] + lsum[BM + r_hi], 1e-30f);
    if (q0 + r_lo < sq) lb[q0 + r_lo] = (m_lo + log2f(ll)) * LN2;
    if (q0 + r_hi < sq) lb[q0 + r_hi] = (m_hi + log2f(lh)) * LN2;
  }
}

cudaError_t launch_wide(const void* q, const void* k, const void* v, void* o,
                        void* lse, int bh, int sq, int sk, float scale,
                        cudaStream_t stream) {
  const size_t smem = sizeof(bf16) * ((WIDE_BM + 2 * WIDE_BN) * WIDE_D +
                                      WIDE_BM * WIDE_BN) +
                      sizeof(float) * 5 * WIDE_BM;
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fwd_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + WIDE_BM - 1) / WIDE_BM, bh);
  fwd_wide_kernel<<<grid, WIDE_NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), sq, sk, scale);
  return cudaGetLastError();
}

// the keys are split across the warps for a short query set
template <int D>
cudaError_t launch_plain(const void* q, const void* k, const void* v, void* o,
                         void* lse, int bh, int sq, int sk, float scale,
                         cudaStream_t stream) {
  const GridBias none{nullptr, nullptr, nullptr, nullptr, 0, 0, false};
  // D = 24's split instance spills (12 bytes at 128 registers, ptxas), and
  // no path gives it a short query set: it runs unsplit
  if constexpr (D <= 64 && D != 24) {
    if (sq <= 16 && sk > FWD_BN)
      return launch_fwd<D, NO_BIAS, true>(q, k, v, none, o, lse, bh, sq, sk,
                                          scale, stream);
  }
  return launch_fwd<D, NO_BIAS, false>(q, k, v, none, o, lse, bh, sq, sk,
                                       scale, stream);
}

}  // namespace

// q, o (bh, sq, d); k, v (bh, sk, d): contiguous bf16, 16-byte aligned.
// lse (bh, sq) f32. Returns cudaGetLastError() after the launch.
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              void* o, void* lse, int bh, int sq, int sk,
                              int d, float scale, void* stream) {
  if (bad_shape(bh, sq, sk) || misaligned(q, k, v, o, nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 4: return (int)launch_plain<4>(q, k, v, o, lse, bh, sq, sk, scale, st);
    case 8: return (int)launch_plain<8>(q, k, v, o, lse, bh, sq, sk, scale, st);
    case 12: return (int)launch_plain<12>(q, k, v, o, lse, bh, sq, sk, scale, st);
    case 16: return (int)launch_plain<16>(q, k, v, o, lse, bh, sq, sk, scale, st);
    case 24: return (int)launch_plain<24>(q, k, v, o, lse, bh, sq, sk, scale, st);
    case 32: return (int)launch_plain<32>(q, k, v, o, lse, bh, sq, sk, scale, st);
    case 64: return (int)launch_plain<64>(q, k, v, o, lse, bh, sq, sk, scale, st);
    case 96: return (int)launch_plain<96>(q, k, v, o, lse, bh, sq, sk, scale, st);
    case 128: return (int)launch_plain<128>(q, k, v, o, lse, bh, sq, sk, scale, st);
    case WIDE_D: return (int)launch_wide(q, k, v, o, lse, bh, sq, sk, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

// As flash_fwd_bf16, with the grid bias: bias_h (bh, sq, kh) and bias_w
// (bh, sq, kw), contiguous f32, sk = kh·kw, d = 80.
extern "C" int flash_gb_fwd_bf16(const void* q, const void* k, const void* v,
                                 const void* bias_h, const void* bias_w,
                                 void* o, void* lse, int bh, int sq, int sk,
                                 int kh, int kw, int d, float scale,
                                 void* stream) {
  if (bad_shape(bh, sq, sk) || bad_grid(sk, kh, kw) || d != GB_D ||
      misaligned(q, k, v, o, nullptr))
    return (int)cudaErrorInvalidValue;
  const GridBias gb{static_cast<const float*>(bias_h),
                    static_cast<const float*>(bias_w), nullptr, nullptr, kh,
                    kw, bias_vec(bias_h, bias_w, kh, kw)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kw == FWD_BN)
    return (int)launch_fwd<GB_D, GRID_ROW, false>(q, k, v, gb, o, lse, bh, sq,
                                                 sk, scale, st);
  return (int)launch_fwd<GB_D, GRID_ANY, false>(q, k, v, gb, o, lse, bh, sq,
                                               sk, scale, st);
}
