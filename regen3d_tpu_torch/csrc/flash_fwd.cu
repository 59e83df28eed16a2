// Flash-attention forward for Hopper (sm_90a), bf16 in and out, f32 inside.
//
// Replaces: regen3d_tpu/ops/attention.py::_flash_fwd_kernel (Pallas, TPU),
// reached through _flash_forward and flash_attention.
//
// What bounds it on the H100: at the VGGT-1B shapes (D = 64, S = 1370 to
// 2748) attention is compute-bound (4·S²·D flops against 4·S·D bytes per
// head), so the bound is the arithmetic rate. This first version does the
// two products on the CUDA cores in f32, not on the tensor cores, so it is
// bound by shared-memory loads feeding the FMAs, far below the bf16 tensor
// core peak; mma.sync / wgmma tiles are the next step.
//
// What the design does about it: one block per (batch·head, 64-row q tile);
// K and V stream through shared memory in 64-row tiles, so the (Sq, Sk)
// score matrix never exists in device memory and each K/V tile is read once
// per q tile. Four threads own one query row: each keeps 16 scores and D/4
// output accumulators in registers, the row max and sum reduce with two warp
// shuffles, and the online softmax rescales the accumulators per tile.
// Shared rows are padded by one float so the four column phases and the
// eight rows of a warp fall in distinct banks. Ragged Sq and Sk are masked
// in the kernel (keys at or past Sk score -1e30, as in the Pallas kernel);
// the caller pads nothing.
//
// Head dims: 64 and 128 (VGGT), 32 and 16 (SAM's mask decoder: token
// self-attention, and the cross-attentions at half width). The decoder's
// 11 prompt tokens are a ragged tail inside a single 64-key tile, both as
// keys (Sq = 4096 image tokens, Sk = 11) and as queries (Sq = 11, the other
// 53 rows of the q tile are masked out of the stores).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;            // query rows per block
constexpr int BK = 64;            // keys per shared-memory tile
constexpr int NT = 256;           // threads: 4 per query row
constexpr float NEG = -1e30f;     // the Pallas kernel's masked logit

template <int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int sq, int sk, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                 // [BQ][D + 1], pre-scaled
  float* ks = qs + BQ * (D + 1);    // [BK][D + 1]
  float* vs = ks + BK * (D + 1);    // [BK][D]
  float* ps = vs + BK * D;          // [BQ][BK + 1] probabilities

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int r = tid >> 2;           // query row within the tile
  const int c4 = tid & 3;           // column phase: keys c4 + 4j, dims c4 + 4i
  const size_t qoff = (size_t)bh * sq * D;
  const size_t koff = (size_t)bh * sk * D;

  for (int i = tid; i < BQ * D; i += NT) {
    const int rr = i / D, dd = i % D, qi = q0 + rr;
    qs[rr * (D + 1) + dd] =
        qi < sq ? __bfloat162float(q[qoff + (size_t)qi * D + dd]) * scale : 0.f;
  }

  constexpr int DPT = D / 4;
  constexpr int KPT = BK / 4;
  float acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;
  float m = NEG, l = 0.f;

  for (int kb = 0; kb < sk; kb += BK) {
    __syncthreads();  // every thread is done with the previous K/V/P tiles
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
      if (kb + c4 + 4 * j >= sk) s[j] = NEG;
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
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int bh, int sq, int sk, float scale,
                   cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + BQ - 1) / BQ, bh);
  flash_fwd_kernel<D><<<grid, NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), sq, sk, scale);
  return cudaGetLastError();
}

}  // namespace

// q (bh, sq, d), k and v (bh, sk, d), o (bh, sq, d): contiguous bf16.
// lse (bh, sq) f32. Returns cudaGetLastError() after the launch.
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              void* o, void* lse, int bh, int sq, int sk,
                              int d, float scale, void* stream) {
  if (bh <= 0 || sq <= 0 || sk <= 0 || bh > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 16) return (int)launch<16>(q, k, v, o, lse, bh, sq, sk, scale, st);
  if (d == 32) return (int)launch<32>(q, k, v, o, lse, bh, sq, sk, scale, st);
  if (d == 64) return (int)launch<64>(q, k, v, o, lse, bh, sq, sk, scale, st);
  if (d == 128) return (int)launch<128>(q, k, v, o, lse, bh, sq, sk, scale, st);
  return (int)cudaErrorInvalidValue;
}
