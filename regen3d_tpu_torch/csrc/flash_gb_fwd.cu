// Flash-attention forward with a factored key-grid bias (SAM's decomposed
// relative-position bias) for Hopper (sm_90a), bf16 q/k/v/o, f32 bias and
// f32 inside.
//
// Replaces: regen3d_tpu/ops/attention.py::_flash_fwd_gb_kernel (Pallas, TPU),
// reached through _gb_fwd_impl and flash_attention_grid_bias.
//
// Computes, for keys on a (kh, kw) grid (Sk = kh·kw, key k at row k / kw and
// column k % kw):
//   logits[q, k] = scale·q·k + bias_h[q, k / kw] + bias_w[q, k % kw]
// then the online softmax, and writes o and the row logsumexp (kept for the
// backward kernels).
//
// What bounds it on the H100: at SAM-H's global blocks, (1, 16, 4096, 80)
// with kh = kw = 64, the two products are 85.9 GFLOP against 76 MB of
// traffic (q, k, v, o in bf16, both bias factors in f32), so it is
// compute-bound. Like csrc/flash_fwd.cu this first version does the products
// on the CUDA cores in f32, bound by the shared-memory loads feeding the
// FMAs; tensor cores are later work.
//
// What the design does about it: the flash_fwd.cu tiling (one block per
// (batch·head, 64-row q tile), K and V streamed through shared memory in
// 64-key tiles, four threads own a query row). The (Sq, Sk) bias never
// exists: the block copies its 64 rows of bias_h (kh floats each) and
// bias_w (kw floats each) into shared memory once, 32 KB at SAM-H, and each
// score reads bias_h[q, k / kw] and bias_w[q, k % kw] from there. That
// replaces the Pallas kernel's 0/1 selector matmuls, which only worked
// around Mosaic's missing reshape. Ragged Sq and Sk (the 14×14 = 196-token
// windows, when routed here) are masked in the kernel; the caller pads
// nothing. Shared memory passes 48 KB, so the launch opts in with
// cudaFuncSetAttribute. The kernel is a template on the head dim; the one
// instantiated is SAM-H's 80 (1280 wide, 16 heads).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;            // query rows per block
constexpr int BK = 64;            // keys per shared-memory tile
constexpr int NT = 256;           // threads: 4 per query row
constexpr float NEG = -1e30f;     // the Pallas kernel's masked logit
constexpr size_t SMEM_MAX = 232448;

template <int D>
__global__ void __launch_bounds__(NT)
flash_gb_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const float* __restrict__ bias_h,
                    const float* __restrict__ bias_w,
                    __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                    int sq, int sk, int kh, int kw, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                   // [BQ][D + 1], pre-scaled
  float* ks = qs + BQ * (D + 1);      // [BK][D + 1]
  float* vs = ks + BK * (D + 1);      // [BK][D]
  float* ps = vs + BK * D;            // [BQ][BK + 1] probabilities
  float* hs = ps + BQ * (BK + 1);     // [BQ][kh + 1] bias_h rows
  float* ws = hs + BQ * (kh + 1);     // [BQ][kw + 1] bias_w rows

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int r = tid >> 2;             // query row within the tile
  const int c4 = tid & 3;             // column phase: keys c4 + 4j, dims c4 + 4i
  const size_t qoff = (size_t)bh * sq * D;
  const size_t koff = (size_t)bh * sk * D;
  const size_t hoff = (size_t)bh * sq * kh;
  const size_t woff = (size_t)bh * sq * kw;

  for (int i = tid; i < BQ * D; i += NT) {
    const int rr = i / D, dd = i % D, qi = q0 + rr;
    qs[rr * (D + 1) + dd] =
        qi < sq ? __bfloat162float(q[qoff + (size_t)qi * D + dd]) * scale : 0.f;
  }
  for (int i = tid; i < BQ * kh; i += NT) {
    const int rr = i / kh, mm = i % kh, qi = q0 + rr;
    hs[rr * (kh + 1) + mm] = qi < sq ? bias_h[hoff + (size_t)qi * kh + mm] : 0.f;
  }
  for (int i = tid; i < BQ * kw; i += NT) {
    const int rr = i / kw, nn = i % kw, qi = q0 + rr;
    ws[rr * (kw + 1) + nn] = qi < sq ? bias_w[woff + (size_t)qi * kw + nn] : 0.f;
  }

  constexpr int DPT = D / 4;
  constexpr int KPT = BK / 4;
  float acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;
  float m = NEG, l = 0.f;
  const float* hrow = hs + r * (kh + 1);
  const float* wrow = ws + r * (kw + 1);

  for (int kb = 0; kb < sk; kb += BK) {
    __syncthreads();  // bias rows are in; the previous K/V/P tiles are done
    for (int i = tid; i < BK * D; i += NT) {
      const int rr = i / D, dd = i % D, ki = kb + rr;
      float kv = 0.f, vv = 0.f;
      if (ki < sk) {
        kv = __bfloat162float(k[koff + (size_t)ki * D + dd]);
        vv = __bfloat162float(v[koff + (size_t)ki * D + dd]);
      }
      ks[rr * (D + 1) + dd] = kv;
      vs[rr * D + dd] = vv;
    }
    __syncthreads();

    float s[KPT];
#pragma unroll
    for (int j = 0; j < KPT; ++j) s[j] = 0.f;
    const float* qrow = qs + r * (D + 1);
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qd = qrow[d];
#pragma unroll
      for (int j = 0; j < KPT; ++j) s[j] += qd * ks[(c4 + 4 * j) * (D + 1) + d];
    }

    float mx = NEG;
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const int ki = kb + c4 + 4 * j;
      if (ki < sk) {
        const int row = ki / kw;
        s[j] = (s[j] + hrow[row]) + wrow[ki - row * kw];
      } else {
        s[j] = NEG;
      }
      mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const float p = expf(s[j] - m_new);
      ps[r * (BK + 1) + c4 + 4 * j] = p;
      rs += p;
    }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    rs += __shfl_xor_sync(0xffffffffu, rs, 2);
    l = l * alpha + rs;
    m = m_new;
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= alpha;
    __syncwarp();  // the row's four lanes (one warp) wrote its P row

    const float* prow = ps + r * (BK + 1);
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      const float p = prow[c];
      const float* vr = vs + c * D + c4;
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] += p * vr[4 * i];
    }
  }

  const int qi = q0 + r;
  if (qi < sq) {
    const float ls = fmaxf(l, 1e-30f);
    __nv_bfloat16* orow = o + qoff + (size_t)qi * D + c4;
#pragma unroll
    for (int i = 0; i < DPT; ++i) orow[4 * i] = __float2bfloat16(acc[i] / ls);
    if (c4 == 0) lse[(size_t)bh * sq + qi] = m + logf(ls);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* bias_h, const void* bias_w, void* o, void* lse,
                   int bh, int sq, int sk, int kh, int kw, float scale,
                   cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)BQ * (D + 1) + BK * (D + 1) + BK * D +
                       BQ * (BK + 1) + (size_t)BQ * (kh + 1) +
                       (size_t)BQ * (kw + 1));
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_gb_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + BQ - 1) / BQ, bh);
  flash_gb_fwd_kernel<D><<<grid, NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(bias_h),
      static_cast<const float*>(bias_w), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), sq, sk, kh, kw, scale);
  return cudaGetLastError();
}

}  // namespace

// q (bh, sq, d), k and v (bh, sk, d), o (bh, sq, d): contiguous bf16.
// bias_h (bh, sq, kh) and bias_w (bh, sq, kw): contiguous f32, sk = kh·kw.
// lse (bh, sq) f32. Returns cudaGetLastError() after the launch.
extern "C" int flash_gb_fwd_bf16(const void* q, const void* k, const void* v,
                                 const void* bias_h, const void* bias_w,
                                 void* o, void* lse, int bh, int sq, int sk,
                                 int kh, int kw, int d, float scale,
                                 void* stream) {
  if (bh <= 0 || sq <= 0 || sk <= 0 || bh > 65535 || kh <= 0 || kw <= 0 ||
      (long long)kh * kw != sk)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 80)
    return (int)launch<80>(q, k, v, bias_h, bias_w, o, lse, bh, sq, sk, kh, kw,
                           scale, st);
  return (int)cudaErrorInvalidValue;
}
