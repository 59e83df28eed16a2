// Flash-attention backward for Hopper (sm_90a): the dq kernel and the dk/dv
// kernel, plain and with a factored key-grid bias (SAM's decomposed
// relative-position bias). bf16 q/k/v/g and dq/dk/dv; f32 lse, delta, bias
// factors, bias gradients and arithmetic.
//
// Replaces: regen3d_tpu/ops/attention.py::_flash_bwd_dq_kernel and
// ::_flash_bwd_dkv_kernel (reached through _flash_vjp_bwd), and
// ::_flash_bwd_gb_dq_kernel and ::_flash_bwd_gb_dkv_kernel (reached through
// _gb_vjp_bwd) (Pallas, TPU).
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
// The bias enters the logits unscaled, so its gradient takes ds as it is:
// the grid-bias dq kernel keeps ds unscaled and scales dq at the end; the
// plain dq kernel and both dkv kernels scale ds where they form it.
//
// What bounds them on the H100: at the DiT-base shapes (D = 64, Sq = 512,
// Sk = 512 or 257) and SAM-H's global blocks ((1, 16, 4096, 80), a 64 × 64
// key grid) the dq kernel does 6·Sq·Sk·D operations per head and the dkv
// kernel 8·Sq·Sk·D against 2·(Sq + Sk)·D bf16 values read per head, so all
// are compute-bound. This first version does every product on the CUDA cores
// in f32, as csrc/flash_fwd.cu does, bound by the shared-memory loads feeding
// the FMAs; mma.sync / wgmma tiles are the next step.
//
// What the design does about it: the flash_fwd.cu tiling. dq: one block per
// (batch·head, 64-row q tile); K and V stream through shared memory in
// 64-key tiles; four threads own a query row, each with 16 keys of the tile
// and D/4 dq accumulators in registers. dkv: one block per (batch·head,
// 64-key tile); Q, g, lse and delta stream through shared memory in 64-row
// tiles; four threads own a key row, each with 16 queries of the tile and
// D/4 dk and D/4 dv accumulators in registers. The two kernels are gridded
// over different axes, so every gradient element is summed by one thread and
// written once: no atomics, and the result does not depend on the launch
// order. Ragged Sq and Sk are masked in the kernels (keys at or past Sk get
// p = 0 in the dq kernel, query rows at or past Sq get p = 0 in the dkv
// kernel, as in the Pallas kernels); the caller pads nothing.
//
// The grid bias is one template parameter of both kernels. The (S, S) bias
// never exists: the dq block keeps its 64 rows of bias_h and bias_w in shared
// memory; the dkv block loads, per q tile, the bias_w rows and only the
// bias_h columns of the key-grid rows its 64 keys touch, and each score reads
// bias_h[q, k / kw] and bias_w[q, k % kw] from there (no selector matmuls,
// which only worked around Mosaic). The bias gradients are sums over keys
// within one query row: the dq block keeps a row's partial sums in shared
// memory, next to its ds row, where only the row's four lanes (one warp)
// touch them, each lane owning the outputs whose index is its lane mod 4.
// Every dbias element is summed by one thread in a fixed order and written
// once: no atomics, deterministic, as JAX's is. Shared memory passes 48 KB
// (166 KB for the grid-bias dq kernel at SAM-H), so the launches opt in with
// cudaFuncSetAttribute.
//
// Head dims: 16, 32, 64 and 128 without a bias, those of flash_fwd.cu; 80
// (SAM-H) with the grid bias, that of flash_gb_fwd.cu.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;            // query rows per tile
constexpr int BK = 64;            // keys per tile
constexpr int NT = 256;           // threads: 4 per row
constexpr size_t SMEM_MAX = 232448;
typedef __nv_bfloat16 bf16;

// The factored key-grid bias of the grid-bias kernels; unused without it.
struct GridBias {
  const float* h;   // bias_h (bh, sq, kh)
  const float* w;   // bias_w (bh, sq, kw)
  float* dh;        // dbias_h (bh, sq, kh), written by the dq kernel
  float* dw;        // dbias_w (bh, sq, kw), written by the dq kernel
  int kh, kw;
  int nr;           // the most key-grid rows one key tile touches (dkv)
};

template <int D, bool GB>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
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
  // grid bias only
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
  if constexpr (GB) {
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
      if constexpr (GB) {
        float p = 0.f;
        if (ki < sk) {
          const int row = ki / gb.kw;
          p = expf((s[j] + hrow[row]) + wrow[ki - row * gb.kw] - lse_r);
        }
        dsrow[c4 + 4 * j] = p * (dp[j] - dl_r);           // unscaled
      } else {
        const float p = ki < sk ? expf(s[j] - lse_r) : 0.f;
        dsrow[c4 + 4 * j] = p * (dp[j] - dl_r) * scale;
      }
    }
    __syncwarp();  // the row's four lanes (one warp) wrote its ds row

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float dsv = dsrow[c];
      const float* kr = ks + c * (D + 1) + c4;
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] += dsv * kr[4 * i];
    }
    if constexpr (GB) {
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
    for (int i = 0; i < DPT; ++i)
      out[4 * i] = __float2bfloat16(GB ? acc[i] * scale : acc[i]);
    if constexpr (GB) {
      for (int m = c4; m < gb.kh; m += 4)
        gb.dh[hoff + (size_t)qi * gb.kh + m] = dhrow[m];
      for (int n = c4; n < gb.kw; n += 4)
        gb.dw[woff + (size_t)qi * gb.kw + n] = dwrow[n];
    }
  }
}

template <int D, bool GB>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
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
  // grid bias only
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
  int m0 = 0, nt = 0, my_m = 0, my_n = 0;
  if constexpr (GB) {
    m0 = k0 / gb.kw;
    nt = (min(k0 + BK, sk) - 1) / gb.kw - m0 + 1;
    my_m = key < sk ? key / gb.kw - m0 : 0;
    my_n = key % gb.kw;
  }

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
    if constexpr (GB) {
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
      if (qb + c < sq) {
        if constexpr (GB)
          p = expf((s[j] + hs[c * (gb.nr + 1) + my_m]) +
                   ws[c * (gb.kw + 1) + my_n] - ls[c]);
        else
          p = expf(s[j] - ls[c]);
      }
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

template <int D, bool GB>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* g, const void* lse, const void* delta,
                      void* dq, GridBias gb, int bh, int sq, int sk,
                      float scale, cudaStream_t stream) {
  size_t floats = 2 * (size_t)BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 1);
  if (GB) floats += 2 * (size_t)BQ * (gb.kh + 1) + 2 * (size_t)BQ * (gb.kw + 1);
  const size_t smem = sizeof(float) * floats;
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D, GB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + BQ - 1) / BQ, bh);
  flash_bwd_dq_kernel<D, GB><<<grid, NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(g),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), gb, sq, sk, scale);
  return cudaGetLastError();
}

template <int D, bool GB>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* g, const void* lse, const void* delta,
                       void* dk, void* dv, GridBias gb, int bh, int sq, int sk,
                       float scale, cudaStream_t stream) {
  size_t floats = 2 * (size_t)BK * (D + 1) + 2 * BQ * (D + 1) +
                  2 * BK * (BQ + 1) + 2 * BQ;
  if (GB) {
    // the most key-grid rows that one tile of BK consecutive keys can touch
    gb.nr = min(gb.kh, (BK - 1) / gb.kw + 2);
    floats += (size_t)BQ * (gb.nr + 1) + (size_t)BQ * (gb.kw + 1);
  }
  const size_t smem = sizeof(float) * floats;
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D, GB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sk + BK - 1) / BK, bh);
  flash_bwd_dkv_kernel<D, GB><<<grid, NT, smem, stream>>>(
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

}  // namespace

// q, g, dq (bh, sq, d); k, v (bh, sk, d): contiguous bf16. lse and delta
// (bh, sq) f32. Returns cudaGetLastError() after the launch.
extern "C" int flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                 const void* g, const void* lse,
                                 const void* delta, void* dq, int bh, int sq,
                                 int sk, int d, float scale, void* stream) {
  if (bad_shape(bh, sq, sk)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const GridBias none{};
  switch (d) {
    case 16: return (int)launch_dq<16, false>(q, k, v, g, lse, delta, dq, none, bh, sq, sk, scale, st);
    case 32: return (int)launch_dq<32, false>(q, k, v, g, lse, delta, dq, none, bh, sq, sk, scale, st);
    case 64: return (int)launch_dq<64, false>(q, k, v, g, lse, delta, dq, none, bh, sq, sk, scale, st);
    case 128: return (int)launch_dq<128, false>(q, k, v, g, lse, delta, dq, none, bh, sq, sk, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

// As flash_bwd_dq_bf16; dk and dv (bh, sk, d) contiguous bf16.
extern "C" int flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                  const void* g, const void* lse,
                                  const void* delta, void* dk, void* dv,
                                  int bh, int sq, int sk, int d, float scale,
                                  void* stream) {
  if (bad_shape(bh, sq, sk)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const GridBias none{};
  switch (d) {
    case 16: return (int)launch_dkv<16, false>(q, k, v, g, lse, delta, dk, dv, none, bh, sq, sk, scale, st);
    case 32: return (int)launch_dkv<32, false>(q, k, v, g, lse, delta, dk, dv, none, bh, sq, sk, scale, st);
    case 64: return (int)launch_dkv<64, false>(q, k, v, g, lse, delta, dk, dv, none, bh, sq, sk, scale, st);
    case 128: return (int)launch_dkv<128, false>(q, k, v, g, lse, delta, dk, dv, none, bh, sq, sk, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

// As flash_bwd_dq_bf16, with the grid bias: bias_h and dbias_h (bh, sq, kh),
// bias_w and dbias_w (bh, sq, kw), contiguous f32, sk = kh·kw.
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
  return (int)launch_dq<80, true>(q, k, v, g, lse, delta, dq, gb, bh, sq, sk,
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
  return (int)launch_dkv<80, true>(q, k, v, g, lse, delta, dk, dv, gb, bh, sq,
                                   sk, scale,
                                   static_cast<cudaStream_t>(stream));
}
