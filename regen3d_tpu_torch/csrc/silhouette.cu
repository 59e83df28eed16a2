// Tile-binned edge-function soft silhouette, forward and backward, for
// Hopper (sm_90a), all f32.
//
// Replaces: regen3d_tpu/ops/pallas_rasterize.py::_fwd_kernel (forward) and
// ::_bwd_kernel (backward), reached through pallas_edge_silhouette and
// soft_silhouette_edge_pallas.
//
// Per 32x32-pixel tile (P = 1024 pixels) and its K binned faces, with edge
// rows stored edge-major (row = edge·K + face, coefficients a, b, c):
//   e_j(p) = a_j·px + b_j·py + c_j     (px, py = tile origin + pixel offset)
//   d = min_j e_j,   z = d·|d|/σ
//   forward:  acc[p] = −Σ_k valid_k·softplus(z)
//   backward: s = g·(−sigmoid(z))·2|d|/σ·valid routed to the argmin edge
//             (ties left to right), dc_row = [Σ s·px, Σ s·py, Σ s].
//
// What bounds it on the H100: arithmetic on the CUDA cores. Each
// (pixel, face) pair costs about 20 f32 operations plus one exp and one
// log1p (forward) or one exp (backward), against 40 bytes of coefficients
// per face per tile; the data is tiny, so neither memory nor the tensor
// cores matter. The fit at 1024² covers a minority of tiles.
//
// What the design does about it: one block per (object, tile) over the whole
// ObjectBatch in one launch. A block reads its tile's valid-face count and
// writes zeros and returns when it is 0 (the Pallas kernel's scalar-
// prefetched empty-tile skip), so empty tiles cost one load. Invalid faces
// are skipped with a branch that is uniform across the block. The tile's
// coefficients (and in the backward the tile's upstream gradient) sit in
// shared memory and are read as broadcasts. Edge values use explicit
// round-to-nearest multiplies and adds (no FMA contraction), the operation
// order of the plain PyTorch version, so the argmin edge that routes the
// gradient is the same in both; pallas_rasterize.py:57-59 records that lower
// precision flips it. The backward gives one thread to each face and walks
// the 1024 pixels in a fixed order: no atomics, deterministic f32 sums.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 32;
constexpr int P = TILE * TILE;
constexpr int FWD_THREADS = 256;
constexpr int PPT = P / FWD_THREADS;   // pixels per forward thread

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

// a·x + b·y + c, rounded after every operation (the plain version's order)
__device__ __forceinline__ float line(float a, float b, float c, float x,
                                      float y) {
  return add(add(mul(a, x), mul(b, y)), c);
}

__device__ __forceinline__ float pix_u(int p, float ndc) {
  return mul(add((float)(p % TILE), 0.5f), ndc);
}
__device__ __forceinline__ float pix_v(int p, float ndc) {
  return mul(add((float)(p / TILE), 0.5f), ndc);
}

__global__ void __launch_bounds__(FWD_THREADS)
silhouette_fwd_kernel(const int* __restrict__ nvalid,
                      const float* __restrict__ coeffs,
                      const float* __restrict__ valid,
                      const float* __restrict__ tile_uv,
                      float* __restrict__ acc, int n_tiles, int k,
                      float inv_sigma, float ndc) {
  extern __shared__ float sm[];
  float* co = sm;           // [3K][3]: edge coefficients with the origin folded
  float* va = co + 9 * k;   // [K]
  const int t = blockIdx.x;  // flat (object, tile)
  const int tid = threadIdx.x;
  float* out = acc + (size_t)t * P;
  if (nvalid[t] == 0) {
    for (int p = tid; p < P; p += FWD_THREADS) out[p] = 0.f;
    return;
  }
  const float px0 = tile_uv[2 * (t % n_tiles)];
  const float py0 = tile_uv[2 * (t % n_tiles) + 1];
  const float* cg = coeffs + (size_t)t * 9 * k;
  for (int i = tid; i < 3 * k; i += FWD_THREADS) {
    const float a = cg[3 * i], b = cg[3 * i + 1], c = cg[3 * i + 2];
    co[3 * i] = a;
    co[3 * i + 1] = b;
    co[3 * i + 2] = line(a, b, c, px0, py0);   // c' = a·px0 + b·py0 + c
  }
  for (int i = tid; i < k; i += FWD_THREADS) va[i] = valid[(size_t)t * k + i];
  __syncthreads();

  float pu[PPT], pv[PPT], sum[PPT];
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int p = tid + j * FWD_THREADS;
    pu[j] = pix_u(p, ndc);
    pv[j] = pix_v(p, ndc);
    sum[j] = 0.f;
  }
  for (int f = 0; f < k; ++f) {
    const float w = va[f];
    if (w == 0.f) continue;   // uniform across the block
    const float* c0 = co + 3 * f;
    const float* c1 = co + 3 * (k + f);
    const float* c2 = co + 3 * (2 * k + f);
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      const float e0 = line(c0[0], c0[1], c0[2], pu[j], pv[j]);
      const float e1 = line(c1[0], c1[1], c1[2], pu[j], pv[j]);
      const float e2 = line(c2[0], c2[1], c2[2], pu[j], pv[j]);
      const float d = fminf(e0, fminf(e1, e2));
      const float z = mul(mul(d, fabsf(d)), inv_sigma);
      const float sp = add(fmaxf(z, 0.f), log1pf(expf(-fabsf(z))));
      sum[j] = add(sum[j], mul(w, sp));
    }
  }
#pragma unroll
  for (int j = 0; j < PPT; ++j) out[tid + j * FWD_THREADS] = -sum[j];
}

__global__ void silhouette_bwd_kernel(const int* __restrict__ nvalid,
                                      const float* __restrict__ coeffs,
                                      const float* __restrict__ valid,
                                      const float* __restrict__ tile_uv,
                                      const float* __restrict__ g,
                                      float* __restrict__ dc, int n_tiles,
                                      int k, float inv_sigma, float ndc) {
  __shared__ float gs[P];
  const int t = blockIdx.x;
  const int f = threadIdx.x;
  float* out = dc + (size_t)t * 9 * k;
  if (nvalid[t] == 0) {
    for (int i = f; i < 9 * k; i += blockDim.x) out[i] = 0.f;
    return;
  }
  for (int p = f; p < P; p += blockDim.x) gs[p] = g[(size_t)t * P + p];
  __syncthreads();
  if (f >= k) return;

  float su[3] = {0.f, 0.f, 0.f}, sv[3] = {0.f, 0.f, 0.f},
        ss[3] = {0.f, 0.f, 0.f};
  const float w = valid[(size_t)t * k + f];
  const float px0 = tile_uv[2 * (t % n_tiles)];
  const float py0 = tile_uv[2 * (t % n_tiles) + 1];
  const float* cg = coeffs + (size_t)t * 9 * k;
  if (w != 0.f) {
    float a[3], b[3], c[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float* r = cg + 3 * (j * k + f);
      a[j] = r[0];
      b[j] = r[1];
      c[j] = line(r[0], r[1], r[2], px0, py0);
    }
    for (int p = 0; p < P; ++p) {
      const float x = pix_u(p, ndc), y = pix_v(p, ndc);
      const float e0 = line(a[0], b[0], c[0], x, y);
      const float e1 = line(a[1], b[1], c[1], x, y);
      const float e2 = line(a[2], b[2], c[2], x, y);
      const float d = fminf(e0, fminf(e1, e2));
      const float z = mul(mul(d, fabsf(d)), inv_sigma);
      const float sig = 1.f / (1.f + expf(-z));
      const float s = mul(mul(mul(gs[p], -sig), mul(mul(2.f, fabsf(d)), inv_sigma)), w);
      const int j = (e0 == d) ? 0 : ((e1 == d) ? 1 : 2);
      su[j] = add(su[j], mul(s, x));
      sv[j] = add(sv[j], mul(s, y));
      ss[j] = add(ss[j], s);
    }
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    float* r = out + 3 * (j * k + f);
    r[0] = add(su[j], mul(px0, ss[j]));
    r[1] = add(sv[j], mul(py0, ss[j]));
    r[2] = ss[j];
  }
}

}  // namespace

// nvalid (n_blocks,) i32; coeffs (n_blocks, 3k, 3) f32 edge-major;
// valid (n_blocks, k) f32; tile_uv (n_tiles, 2) f32; acc (n_blocks, 1024)
// f32. n_blocks = objects · n_tiles. Returns cudaGetLastError().
extern "C" int silhouette_fwd(const void* nvalid, const void* coeffs,
                              const void* valid, const void* tile_uv,
                              void* acc, int n_blocks, int n_tiles, int k,
                              float inv_sigma, float ndc, void* stream) {
  if (n_blocks <= 0 || n_tiles <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * 10 * k;
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  silhouette_fwd_kernel<<<n_blocks, FWD_THREADS, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(nvalid), static_cast<const float*>(coeffs),
      static_cast<const float*>(valid), static_cast<const float*>(tile_uv),
      static_cast<float*>(acc), n_tiles, k, inv_sigma, ndc);
  return (int)cudaGetLastError();
}

// As silhouette_fwd, plus g (n_blocks, 1024) f32 → dc (n_blocks, 3k, 3) f32.
extern "C" int silhouette_bwd(const void* nvalid, const void* coeffs,
                              const void* valid, const void* tile_uv,
                              const void* g, void* dc, int n_blocks,
                              int n_tiles, int k, float inv_sigma, float ndc,
                              void* stream) {
  if (n_blocks <= 0 || n_tiles <= 0 || k <= 0 || k > 1024)
    return (int)cudaErrorInvalidValue;
  const int threads = (k + 31) / 32 * 32;
  silhouette_bwd_kernel<<<n_blocks, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(nvalid), static_cast<const float*>(coeffs),
      static_cast<const float*>(valid), static_cast<const float*>(tile_uv),
      static_cast<const float*>(g), static_cast<float*>(dc), n_tiles, k,
      inv_sigma, ndc);
  return (int)cudaGetLastError();
}
