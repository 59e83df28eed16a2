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
// The exact cull. In f32, exp(z), softplus(z) = log1p(exp(z)) and
// sigmoid(z) = 1/(1 + exp(−z)) are exactly 0 for z ≤ −104 (exp underflows
// past the smallest subnormal; exp(−z) overflows to inf); Z_CUT = −105
// leaves a margin. Let r = sqrt(−Z_CUT/inv_sigma)·(1 + 2⁻¹⁰), rounded to f32:
// at d = −r the f32 z is below Z_CUT by ~0.2%, far more than its rounding,
// and z is monotone in d, so every d < −r gives a term of exactly 0. The
// tile is cut into 16 pixel blocks of 8×8. For a (face, block) pair and an
// edge j, the exact linear function a·x + b·y + c' (c' the origin-folded
// offset, x and y the rounded pixel coordinates, monotone in the pixel
// index) is largest at the block's corner picked by the signs of a and b.
// Each rounded edge value is within δ ≤ 3.01·2⁻²⁴·M of that function,
// M = |a|·x_max + |b|·x_max + |c'|. The pair is culled when, for some j,
// fl(e_j(corner) + m_j) < −r with m_j = 2⁻²⁰·M ≥ 2δ: then every pixel of the
// block has e_j < −r, so d < −r and its term is exactly 0. A culled pair
// adds exactly nothing: the same function, computed with less work.
// silhouette_kernel.silhouette_cull_plain repeats the decision bit for bit.
// At phase 6's σ = 5e-7 on 1024², r is 3.7 px and the bins' 64-px motion
// margin leaves 1.8% of the binned (pixel, face) pairs in kept blocks; at
// σ = 1e-4 (r ≈ 52 px) almost nothing is culled and the kernels evaluate
// every pair, as before.
//
// What bounds them on the H100 now: the bytes of the outputs, from below.
// Both kernels write every (object, tile) row, the forward 4 KB of acc, the
// backward 36·K bytes of dc, zeros for the rows without faces; the phase-6
// batch has 806 busy rows of 8,192, and its kept pairs cost a few µs of f32
// issue. Measured on an H100 (chip_smoke.py's split, PERF.md), the zero
// rows run near torch's zero_ of the same bytes, and the rest is the
// latency of the busiest rows' chains of dependent work (the most faces in
// one block, the most items in one row), not the card's issue rate.
//
// What the design does about what held the first version back:
// - every binned pair was evaluated, 99.4% of them adding exactly 0: the
//   cull above, one test per (face, edge, block) corner;
// - forward: one block of 16 warps per (object, tile) row (an empty row
//   writes zeros and returns). Each warp owns one pixel block and builds,
//   with ballots, the list of its live faces in face order in shared
//   memory; each lane then sums its two pixels over the list in that
//   order, so a second launch gives the same bits;
// - backward: the first version gave one thread to each face and walked
//   the 1024 pixels in series (invalid faces idled). Now a lane tests one
//   (face, block) pair and a ballot gathers two faces' live masks; each
//   live (face, block) item goes to one of 16 warps, whose lanes cover the
//   block's 64 pixels, two each; the nine partial sums (Σs·x, Σs·y, Σs per
//   edge) are nine named registers updated with selects, never an array
//   indexed at run time; one xor-shuffle tree per item combines the lanes.
//   Items are listed face-major in shared memory; each face's items are
//   added in list order by one thread, with no atomics, so a second launch
//   gives the same bits. A face with no live item, or an invalid face, gets
//   exact zeros;
// - the sigmoid's IEEE division 1/(1 + exp(−z)) became __frcp_rn, the
//   correctly rounded reciprocal, which gives the same bits;
// - edge values keep explicit round-to-nearest multiplies and adds (no FMA
//   contraction) in the plain version's order, so the argmin edge that
//   routes the gradient is the plain version's (pallas_rasterize.py:57-59
//   records that lower precision flips it).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;
constexpr int P = TILE * TILE;
constexpr int PB = 8;                          // pixel block side
constexpr int NBX = TILE / PB;                 // blocks per tile row
constexpr int NPB = NBX * NBX;                 // 16 pixel blocks per tile
constexpr int THREADS = 512;               // a warp per pixel block
constexpr int WARPS = THREADS / 32;
constexpr int FWD_CHUNK = 256;                 // faces per forward list pass
constexpr int BWD_CHUNK = 128;                 // items per backward pass
constexpr int GS_STRIDE = TILE + 8;            // g's smem row: no bank conflicts
constexpr unsigned FULL = 0xffffffffu;
constexpr float Z_CUT = -105.f;
constexpr float R_WIDEN = 1.f + 1.f / 1024.f;
constexpr float MARGIN = 1.f / 1048576.f;      // 2^-20

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

// a·x + b·y + c, rounded after every operation (the plain version's order)
__device__ __forceinline__ float line(float a, float b, float c, float x,
                                      float y) {
  return add(add(mul(a, x), mul(b, y)), c);
}

// pixel coordinate of offset i in the tile: (i + 0.5)·ndc
__device__ __forceinline__ float pix(int i, float ndc) {
  return mul(add((float)i, 0.5f), ndc);
}

__device__ __forceinline__ float cull_radius(float inv_sigma) {
  return mul(__fsqrt_rn(__fdiv_rn(-Z_CUT, inv_sigma)), R_WIDEN);
}

// Shared-memory edge row {a, b, c' = a·px0 + b·py0 + c, m = 2^-20·M}.
__device__ __forceinline__ float4 edge_row(const float* r, float px0,
                                           float py0, float xmax) {
  const float a = r[0], b = r[1];
  const float c = line(a, b, r[2], px0, py0);
  const float m = mul(add(add(mul(fabsf(a), xmax), mul(fabsf(b), xmax)),
                          fabsf(c)), MARGIN);
  return make_float4(a, b, c, m);
}

// True when edge e is below −r at every pixel of the block whose corner
// pixel coordinates are [xlo, xhi] × [ylo, yhi].
__device__ __forceinline__ bool edge_out(float4 e, float xlo, float xhi,
                                         float ylo, float yhi, float r) {
  const float x = e.x >= 0.f ? xhi : xlo;
  const float y = e.y >= 0.f ? yhi : ylo;
  return add(line(e.x, e.y, e.z, x, y), e.w) < -r;
}

// Whether face f has a term that may be non-zero in pixel block (bx, by).
__device__ __forceinline__ bool block_live(const float4* co, int k, int f,
                                           int bx, int by, float ndc,
                                           float r) {
  const float xlo = pix(PB * bx, ndc), xhi = pix(PB * bx + PB - 1, ndc);
  const float ylo = pix(PB * by, ndc), yhi = pix(PB * by + PB - 1, ndc);
  return !(edge_out(co[f], xlo, xhi, ylo, yhi, r) ||
           edge_out(co[k + f], xlo, xhi, ylo, yhi, r) ||
           edge_out(co[2 * k + f], xlo, xhi, ylo, yhi, r));
}

__device__ __forceinline__ void load_edges(float4* co, const float* cg,
                                           int k, float px0, float py0,
                                           float ndc) {
  const float xmax = pix(TILE - 1, ndc);
  for (int i = threadIdx.x; i < 3 * k; i += THREADS)
    co[i] = edge_row(cg + 3 * i, px0, py0, xmax);
}

__global__ void __launch_bounds__(THREADS)
silhouette_fwd_kernel(const int* __restrict__ nvalid,
                      const float* __restrict__ coeffs,
                      const float* __restrict__ valid,
                      const float* __restrict__ tile_uv,
                      float* __restrict__ acc, int n_tiles, int k,
                      float inv_sigma, float ndc) {
  extern __shared__ float4 sm4[];
  float4* co = sm4;                                   // [3K] edge rows
  float* va = reinterpret_cast<float*>(co + 3 * k);   // [K]
  uint16_t* lists = reinterpret_cast<uint16_t*>(va + k);  // [WARPS][CHUNK]
  const int t = blockIdx.x;   // flat (object, tile)
  const int tid = threadIdx.x;
  float* out = acc + (size_t)t * P;
  if (nvalid[t] == 0) {
    if (tid < P / 4)
      reinterpret_cast<float4*>(out)[tid] = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  const float px0 = tile_uv[2 * (t % n_tiles)];
  const float py0 = tile_uv[2 * (t % n_tiles) + 1];
  load_edges(co, coeffs + (size_t)t * 9 * k, k, px0, py0, ndc);
  for (int i = tid; i < k; i += THREADS) va[i] = valid[(size_t)t * k + i];
  __syncthreads();

  // warp w owns pixel block (w % 4, w / 4); lane l its pixels in column
  // l % 8, rows l / 8 and l / 8 + 4
  const int warp = tid / 32, lane = tid % 32;
  const int bx = warp % NBX, by = warp / NBX;
  const int u = PB * bx + lane % 8, v = PB * by + lane / 8;
  const float x = pix(u, ndc), y0 = pix(v, ndc), y1 = pix(v + 4, ndc);
  float sum0 = 0.f, sum1 = 0.f;
  const float r = cull_radius(inv_sigma);
  const unsigned below = (1u << lane) - 1u;
  uint16_t* list = lists + warp * FWD_CHUNK;
  for (int f0 = 0; f0 < k; f0 += FWD_CHUNK) {
    const int fend = min(k, f0 + FWD_CHUNK);
    int n = 0;
    for (int fb = f0; fb < fend; fb += 32) {
      const int f = fb + lane;
      const bool l = f < fend && va[f] != 0.f &&
                     block_live(co, k, f, bx, by, ndc, r);
      const unsigned m = __ballot_sync(FULL, l);
      if (l) list[n + __popc(m & below)] = (uint16_t)f;
      n += __popc(m);
    }
    __syncwarp();
    for (int i = 0; i < n; ++i) {
      const int f = list[i];
      const float w = va[f];
      const float4 c0 = co[f], c1 = co[k + f], c2 = co[2 * k + f];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float y = h ? y1 : y0;
        const float e0 = line(c0.x, c0.y, c0.z, x, y);
        const float e1 = line(c1.x, c1.y, c1.z, x, y);
        const float e2 = line(c2.x, c2.y, c2.z, x, y);
        const float d = fminf(e0, fminf(e1, e2));
        const float z = mul(mul(d, fabsf(d)), inv_sigma);
        const float sp = add(fmaxf(z, 0.f), log1pf(expf(-fabsf(z))));
        if (h) sum1 = add(sum1, mul(w, sp));
        else sum0 = add(sum0, mul(w, sp));
      }
    }
    __syncwarp();   // the list is rewritten by the next chunk
  }
  out[v * TILE + u] = -sum0;
  out[(v + 4) * TILE + u] = -sum1;
}

__global__ void __launch_bounds__(THREADS)
silhouette_bwd_kernel(const int* __restrict__ nvalid,
                      const float* __restrict__ coeffs,
                      const float* __restrict__ valid,
                      const float* __restrict__ tile_uv,
                      const float* __restrict__ g,
                      float* __restrict__ dc, int n_tiles, int k,
                      float inv_sigma, float ndc) {
  extern __shared__ float4 sm4[];
  float* gs = reinterpret_cast<float*>(sm4);          // [TILE][GS_STRIDE]
  float4* co = sm4 + TILE * GS_STRIDE / 4;            // [3K] edge rows
  float* va = reinterpret_cast<float*>(co + 3 * k);   // [K]
  float* part = va + k;                               // [BWD_CHUNK][9]
  float* fsum = part + 9 * BWD_CHUNK;                 // [K][9]
  int* start = reinterpret_cast<int*>(fsum + 9 * k);  // [K + 1]
  unsigned* live = reinterpret_cast<unsigned*>(start + k + 1);  // [K]
  uint16_t* items = reinterpret_cast<uint16_t*>(live + k);      // [16K]
  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  float* out = dc + (size_t)t * 9 * k;
  if (nvalid[t] == 0) {
    if ((k & 3) == 0) {
      float4* o4 = reinterpret_cast<float4*>(out);
      for (int i = tid; i < 9 * k / 4; i += THREADS)
        o4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      for (int i = tid; i < 9 * k; i += THREADS) out[i] = 0.f;
    }
    return;
  }
  const float px0 = tile_uv[2 * (t % n_tiles)];
  const float py0 = tile_uv[2 * (t % n_tiles) + 1];
  if (tid < P / 4) {   // a float4 of g each
    const float4 v = reinterpret_cast<const float4*>(g + (size_t)t * P)[tid];
    *reinterpret_cast<float4*>(gs + (tid / 8) * GS_STRIDE + 4 * (tid % 8)) = v;
  }
  load_edges(co, coeffs + (size_t)t * 9 * k, k, px0, py0, ndc);
  for (int i = tid; i < k; i += THREADS) va[i] = valid[(size_t)t * k + i];
  __syncthreads();

  const float r = cull_radius(inv_sigma);
  const int warp = tid / 32, lane = tid % 32;
  // live[f]: bit pb set when (f, pb) is kept; a lane tests one (face, block)
  // pair, a ballot gathers two faces' masks
  for (int i0 = 32 * warp; i0 < NPB * k; i0 += THREADS) {
    const int i = i0 + lane, f = i / NPB, pb = i % NPB;
    const bool l = i < NPB * k && va[f] != 0.f &&
                   block_live(co, k, f, pb % NBX, pb / NBX, ndc, r);
    const unsigned m = __ballot_sync(FULL, l);
    if (pb == 0 && i < NPB * k) live[f] = lane ? m >> NPB : m & 0xffffu;
  }
  for (int i = tid; i < 9 * k; i += THREADS) fsum[i] = 0.f;
  __syncthreads();
  if (warp == 0) {   // start[f]: exclusive scan of the live counts, face order
    int base = 0;
    for (int f0 = 0; f0 < k; f0 += 32) {
      const int f = f0 + lane;
      const int n = f < k ? __popc(live[f]) : 0;
      int incl = n;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int v = __shfl_up_sync(FULL, incl, off);
        if (lane >= off) incl += v;
      }
      if (f < k) start[f] = base + incl - n;
      base += __shfl_sync(FULL, incl, 31);
    }
    if (lane == 0) start[k] = base;
  }
  __syncthreads();
  for (int f = tid; f < k; f += THREADS) {   // items: face-major, then block
    unsigned m = live[f];
    for (int i = start[f]; m; ++i, m &= m - 1)
      items[i] = (uint16_t)(f * NPB + __ffs(m) - 1);
  }
  __syncthreads();

  const int n_items = start[k];
  for (int i0 = 0; i0 < n_items; i0 += BWD_CHUNK) {
    const int iend = min(n_items, i0 + BWD_CHUNK);
    for (int i = i0 + warp; i < iend; i += WARPS) {
      const int f = items[i] / NPB, pb = items[i] % NPB;
      const float4 c0 = co[f], c1 = co[k + f], c2 = co[2 * k + f];
      const float w = va[f];
      const int u = PB * (pb % NBX) + lane % 8;
      const float x = pix(u, ndc);
      float su0 = 0.f, sv0 = 0.f, ss0 = 0.f, su1 = 0.f, sv1 = 0.f, ss1 = 0.f,
            su2 = 0.f, sv2 = 0.f, ss2 = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int v = PB * (pb / NBX) + lane / 8 + 4 * h;
        const float y = pix(v, ndc);
        const float e0 = line(c0.x, c0.y, c0.z, x, y);
        const float e1 = line(c1.x, c1.y, c1.z, x, y);
        const float e2 = line(c2.x, c2.y, c2.z, x, y);
        const float d = fminf(e0, fminf(e1, e2));
        const float z = mul(mul(d, fabsf(d)), inv_sigma);
        const float sig = __frcp_rn(add(1.f, expf(-z)));
        const float s = mul(mul(mul(gs[v * GS_STRIDE + u], -sig),
                                mul(mul(2.f, fabsf(d)), inv_sigma)), w);
        const bool r0 = e0 == d, r1 = !r0 && e1 == d, r2 = !r0 && !r1;
        const float sx = mul(s, x), sy = mul(s, y);
        su0 = add(su0, r0 ? sx : 0.f);
        sv0 = add(sv0, r0 ? sy : 0.f);
        ss0 = add(ss0, r0 ? s : 0.f);
        su1 = add(su1, r1 ? sx : 0.f);
        sv1 = add(sv1, r1 ? sy : 0.f);
        ss1 = add(ss1, r1 ? s : 0.f);
        su2 = add(su2, r2 ? sx : 0.f);
        sv2 = add(sv2, r2 ? sy : 0.f);
        ss2 = add(ss2, r2 ? s : 0.f);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        su0 = add(su0, __shfl_xor_sync(FULL, su0, off));
        sv0 = add(sv0, __shfl_xor_sync(FULL, sv0, off));
        ss0 = add(ss0, __shfl_xor_sync(FULL, ss0, off));
        su1 = add(su1, __shfl_xor_sync(FULL, su1, off));
        sv1 = add(sv1, __shfl_xor_sync(FULL, sv1, off));
        ss1 = add(ss1, __shfl_xor_sync(FULL, ss1, off));
        su2 = add(su2, __shfl_xor_sync(FULL, su2, off));
        sv2 = add(sv2, __shfl_xor_sync(FULL, sv2, off));
        ss2 = add(ss2, __shfl_xor_sync(FULL, ss2, off));
      }
      if (lane == 0) {
        float* pr = part + 9 * (i - i0);
        pr[0] = su0; pr[1] = sv0; pr[2] = ss0;
        pr[3] = su1; pr[4] = sv1; pr[5] = ss1;
        pr[6] = su2; pr[7] = sv2; pr[8] = ss2;
      }
    }
    __syncthreads();
    for (int f = tid; f < k; f += THREADS) {   // a face's items, in order
      const int a = max(start[f], i0), b = min(start[f + 1], iend);
      for (int i = a; i < b; ++i) {
#pragma unroll
        for (int q = 0; q < 9; ++q)
          fsum[9 * f + q] = add(fsum[9 * f + q], part[9 * (i - i0) + q]);
      }
    }
    __syncthreads();
  }
  for (int f = tid; f < k; f += THREADS) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float su = fsum[9 * f + 3 * j], sv = fsum[9 * f + 3 * j + 1];
      const float ss = fsum[9 * f + 3 * j + 2];
      float* row = out + 3 * (j * k + f);
      row[0] = add(su, mul(px0, ss));
      row[1] = add(sv, mul(py0, ss));
      row[2] = ss;
    }
  }
}

size_t fwd_smem(int k) {
  return 16 * (size_t)3 * k + 4 * (size_t)k + 2 * WARPS * FWD_CHUNK;
}

size_t bwd_smem(int k) {
  return 4 * (size_t)TILE * GS_STRIDE + 16 * (size_t)3 * k + 4 * (size_t)k
         + 4 * 9 * (size_t)BWD_CHUNK + 4 * 9 * (size_t)k
         + 4 * (size_t)(k + 1) + 4 * (size_t)k + 2 * (size_t)NPB * k;
}

template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

// nvalid (n_blocks,) i32; coeffs (n_blocks, 3k, 3) f32 edge-major;
// valid (n_blocks, k) f32; tile_uv (n_tiles, 2) f32; acc (n_blocks, 1024)
// f32, 16-byte aligned. n_blocks = objects · n_tiles; k ≤ 4096.
// Returns cudaGetLastError().
extern "C" int silhouette_fwd(const void* nvalid, const void* coeffs,
                              const void* valid, const void* tile_uv,
                              void* acc, int n_blocks, int n_tiles, int k,
                              float inv_sigma, float ndc, void* stream) {
  if (n_blocks <= 0 || n_tiles <= 0 || k <= 0 || k > 4096)
    return (int)cudaErrorInvalidValue;
  const size_t smem = fwd_smem(k);   // at most 216 KB of the 227 KB a block has
  if (const int err = allow_smem(silhouette_fwd_kernel, smem)) return err;
  silhouette_fwd_kernel<<<n_blocks, THREADS, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(nvalid), static_cast<const float*>(coeffs),
      static_cast<const float*>(valid), static_cast<const float*>(tile_uv),
      static_cast<float*>(acc), n_tiles, k, inv_sigma, ndc);
  return (int)cudaGetLastError();
}

// As silhouette_fwd, plus g (n_blocks, 1024) f32, 16-byte aligned →
// dc (n_blocks, 3k, 3) f32; k ≤ 1024.
extern "C" int silhouette_bwd(const void* nvalid, const void* coeffs,
                              const void* valid, const void* tile_uv,
                              const void* g, void* dc, int n_blocks,
                              int n_tiles, int k, float inv_sigma, float ndc,
                              void* stream) {
  if (n_blocks <= 0 || n_tiles <= 0 || k <= 0 || k > 1024)
    return (int)cudaErrorInvalidValue;
  const size_t smem = bwd_smem(k);   // at most 138 KB
  if (const int err = allow_smem(silhouette_bwd_kernel, smem)) return err;
  silhouette_bwd_kernel<<<n_blocks, THREADS, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(nvalid), static_cast<const float*>(coeffs),
      static_cast<const float*>(valid), static_cast<const float*>(tile_uv),
      static_cast<const float*>(g), static_cast<float*>(dc), n_tiles, k,
      inv_sigma, ndc);
  return (int)cudaGetLastError();
}
