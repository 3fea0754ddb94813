// Fused ray-major MLP + alpha composite (kernel B4).
//
// Replaces the TPU kernel nerf_shared_tpu/ops/pallas/fused_render.py:80
// _make_render_kernel (launched by _render_impl, entry fused_render_rays):
// the B3 network plus raw2outputs without sigma noise, so only per-ray
// values (rgb, disp, acc, depth: [N, 8]) and, when asked, the compositing
// weights [N, S] reach device memory.
//
// What bounds it on an H100: operations, as for B3 (~1.19 MFLOP per point
// at the lego width against ~8 bytes of input per point); the composite
// adds a few dozen operations per sample. The split-fp32 design's own
// bound is 3 x FLOPs over the 495 TFLOP/s TF32 rate (45.3 ms at 32768 rays
// x 192 samples), the fp32 CUDA-core bound FLOPs over 67 TFLOP/s (111.4).
//
// What the design does about it: the network is B3's tensor-core tile
// (mlp_tile_tc.cuh: split fp32 on wgmma, 128 points a tile, weights by
// bulk copies through an mbarrier ring). Tiles are flat over the
// samples (gp = r * S + s), so a tile spans rays and no tile is part
// empty at any S: each persistent block
// owns a contiguous range of whole rays, cut at multiples of
// 128 / gcd(S, 128) rays so that every tile but the launch's last is full.
// The composite keeps raw2outputs' cumprod form: a parallel pass over the
// tile's points forms alpha (the 1e10 sentinel interval on each ray's last
// sample) and the sigmoids; then one thread per ray segment in the tile
// walks its samples (T *= 1 - alpha + 1e-10), a segment continuing a ray
// of the previous tile starting from the carry in shared memory, and a
// segment whose ray runs on into the next tile leaving its carry there.
// The carry is double-buffered by tile parity: tile t reads carry[t & 1]
// and writes carry[(t + 1) & 1], since within one tile the reader (thread
// 0) and the writer (the tile's last segment) are in general different
// threads with no barrier between them.
//
// bf16 (nerf_render_bf16_kernel; --precision bf16): the TPU kernel's bf16
// instantiation (_make_render_kernel with compute_dtype bfloat16). The
// network is B3's bf16 tile (mlp_tile_bf16.cuh); after it the two consumer
// warpgroups wait for each other and run the same fp32 composite and
// carry, with named barriers of their 256 threads in place of the block's
// (the producer warpgroup takes no part); bound FLOPs over the 989 TFLOP/s
// bf16 rate (7.55 ms at 32768 rays x 192 samples).
#include "mlp_tile_bf16.cuh"

namespace nstt {
namespace tc {

// The composite of the tile at p0 (its raw rows in s_raw; rays end by
// pend): per point the rgb sigmoids in place, alpha -> col 4, depth ->
// col 6; then one thread per ray segment walks it (weight -> col 5), the
// ray's record when its last sample is in this tile, else the carry; then
// the weights. sync() is the barrier of the threads that run it, the
// first TP of which do the work; it ends with one.
template <class Sync>
__device__ __forceinline__ void composite_tile(float* s_raw, float (&carry)[2][6], long long t,
                                               long long p0, long long pend, int S,
                                               const float* __restrict__ z,
                                               const float* __restrict__ rays_d,
                                               float* __restrict__ out8,
                                               float* __restrict__ weights, int white_bkgd,
                                               Sync sync) {
  // per point: rgb sigmoids in place, alpha -> col 4, depth -> col 6
  if (threadIdx.x < TP) {
    const long long gp = p0 + threadIdx.x;
    if (gp < pend) {
      const long long r = gp / S;
      const int si = (int)(gp - r * S);
      float* rw = s_raw + threadIdx.x * RAW_LD;
      const float dx = __ldg(rays_d + r * 3), dy = __ldg(rays_d + r * 3 + 1);
      const float dz = __ldg(rays_d + r * 3 + 2);
      const float dn = sqrtf(dx * dx + dy * dy + dz * dz);
      const float zs = __ldg(z + gp);
      const float dist = (si < S - 1 ? __ldg(z + gp + 1) - zs : 1e10f) * dn;
      rw[4] = 1.f - expf(-fmaxf(rw[3], 0.f) * dist);
      rw[0] = 1.f / (1.f + expf(-rw[0]));
      rw[1] = 1.f / (1.f + expf(-rw[1]));
      rw[2] = 1.f / (1.f + expf(-rw[2]));
      rw[6] = zs;
    }
  }
  sync();

  // one thread per ray segment: weight -> col 5, the ray's record when
  // its last sample is in this tile, else the carry
  if (threadIdx.x < TP) {
    const int q0 = threadIdx.x;
    const long long gp0 = p0 + q0;
    const long long r = gp0 / S;
    const int s0 = gp0 < pend ? (int)(gp0 - r * S) : 0;
    if (gp0 < pend && (s0 == 0 || q0 == 0)) {
      float T = 1.f, cr = 0.f, cg = 0.f, cb = 0.f, dep = 0.f, acc = 0.f;
      if (s0 != 0) {
        const float* c = carry[t & 1];
        T = c[0]; cr = c[1]; cg = c[2]; cb = c[3]; dep = c[4]; acc = c[5];
      }
      const int n = (int)min((long long)(S - s0), min((long long)(TP - q0), pend - gp0));
      for (int k = 0; k < n; ++k) {
        float* rw = s_raw + (q0 + k) * RAW_LD;
        const float alpha = rw[4];
        const float w = alpha * T;
        T = T * ((1.f - alpha) + 1e-10f);
        cr += w * rw[0];
        cg += w * rw[1];
        cb += w * rw[2];
        dep += w * rw[6];
        acc += w;
        rw[5] = w;
      }
      if (s0 + n == S) {
        const float bg = white_bkgd ? 1.f - acc : 0.f;
        float* o = out8 + r * 8;
        o[0] = cr + bg;
        o[1] = cg + bg;
        o[2] = cb + bg;
        o[3] = 1.f / fmaxf(1e-10f, dep / fmaxf(acc, 1e-10f));
        o[4] = acc;
        o[5] = dep;
        o[6] = 0.f;
        o[7] = 0.f;
      } else {
        float* c = carry[(t + 1) & 1];
        c[0] = T; c[1] = cr; c[2] = cg; c[3] = cb; c[4] = dep; c[5] = acc;
      }
    }
  }
  sync();
  if (weights && threadIdx.x < TP && p0 + threadIdx.x < pend)
    weights[p0 + threadIdx.x] = s_raw[threadIdx.x * RAW_LD + 5];
}

struct BlockSync {
  __device__ __forceinline__ void operator()() const { __syncthreads(); }
};

struct ConsumerSync {
  __device__ __forceinline__ void operator()() const { bf16::consumers_sync(); }
};

__device__ inline void render_tiles(const Desc* __restrict__ gdesc, const float* __restrict__ wb,
                                    const float* __restrict__ A, const float* __restrict__ B,
                                    const float* __restrict__ z,
                                    const float* __restrict__ rays_d,
                                    float* __restrict__ out8, float* __restrict__ weights,
                                    long long n_rays, int S, int white_bkgd,
                                    long long rays_per_block, int R) {
  __shared__ Desc d;
  __shared__ float carry[2][6];   // T, r, g, b, depth, acc of the ray left open
  __shared__ unsigned long long bars[2 * MAX_SLOTS];
  extern __shared__ float4 dyn[];
  load_desc(d, gdesc);
  __syncthreads();
  const Smem s = carve(reinterpret_cast<float*>(dyn), (int)d.hdr[H_HS], RayEnc::ROW);
  const RayEnc e{A, B, z, S};
  const long long r0 = blockIdx.x * rays_per_block;
  const long long r1 = min(n_rays, r0 + rays_per_block);
  const long long pbeg = r0 * S, pend = r1 * S;
  const long long n_tiles = r1 > r0 ? (pend - pbeg + TP - 1) / TP : 0;
  Ring ring = start_ring(d, wb, s.ring, bars, R, n_tiles);

  for (long long t = 0; t < n_tiles; ++t) {
    const long long p0 = pbeg + t * TP;
    tile_rows(d, e, p0, pend, s);
    tile_network<RayEnc, false>(d, wb, e, s, ring);
    composite_tile(s.raw, carry, t, p0, pend, S, z, rays_d, out8, weights, white_bkgd,
                   BlockSync{});
  }
}

__global__ void __launch_bounds__(NTHREADS, 1)
nerf_render_tc_kernel(const Desc* __restrict__ gdesc, const float* __restrict__ wb,
                      const float* __restrict__ A, const float* __restrict__ B,
                      const float* __restrict__ z, const float* __restrict__ rays_d,
                      float* __restrict__ out8, float* __restrict__ weights,
                      long long n_rays, int S, int white_bkgd, long long rays_per_block,
                      int R) {
  render_tiles(gdesc, wb, A, B, z, rays_d, out8, weights, n_rays, S, white_bkgd,
               rays_per_block, R);
}

// B4 in bf16: the same inputs over pack_network_tc's bf16 pack; SLOT and E
// as for B1 and B3 in bf16. Both consumer warpgroups finish a tile's
// network, then run its composite, and wait for each other after it (the
// next tile's heads overwrite the raw rows it reads).
__global__ void __launch_bounds__(bf16::NTHREADS, 1)
nerf_render_bf16_kernel(const Desc* __restrict__ gdesc, const float* __restrict__ wb,
                        const float* __restrict__ A, const float* __restrict__ B,
                        const float* __restrict__ z, const float* __restrict__ rays_d,
                        float* __restrict__ out8, float* __restrict__ weights,
                        long long n_rays, int S, int white_bkgd, long long rays_per_block,
                        int R, int SLOT, int E) {
  __shared__ Desc d;
  __shared__ float carry[2][6];   // T, r, g, b, depth, acc of the ray left open
  __shared__ unsigned long long bars[2 * bf16::MAX_STAGES];
  extern __shared__ float4 dyn[];
  const long long r0 = blockIdx.x * rays_per_block;
  const long long r1 = min(n_rays, r0 + rays_per_block);
  const long long pbeg = r0 * S, pend = r1 * S;
  const long long n_tiles = r1 > r0 ? (pend - pbeg + TP - 1) / TP : 0;
  bf16::Smem s;
  bf16::Ring ring;
  if (!bf16::start(d, gdesc, wb, bars, reinterpret_cast<float*>(dyn), R, SLOT, E, n_tiles, s,
                   ring))
    return;
  const RayEnc e{A, B, z, S};
  const int wg = threadIdx.x >> 7;
  for (long long t = 0; t < n_tiles; ++t) {
    const long long p0 = pbeg + t * TP;
    bf16::tile(d, wb, e, s, ring, wg, p0, pend);
    bf16::consumers_sync();
    composite_tile(s.raw, carry, t, p0, pend, S, z, rays_d, out8, weights, white_bkgd,
                   ConsumerSync{});
    bf16::consumers_sync();
  }
}

}  // namespace tc
}  // namespace nstt

static long long gcd_ll(long long a, long long b) {
  while (b) {
    const long long t = a % b;
    a = b;
    b = t;
  }
  return a;
}

using RenderKernel = void (*)(const nstt::tc::Desc*, const float*, const float*,
                              const float*, const float*, const float*, float*, float*,
                              long long, int, int, long long, int);
using RenderBf16Kernel = void (*)(const nstt::tc::Desc*, const float*, const float*,
                                  const float*, const float*, const float*, float*, float*,
                                  long long, int, int, long long, int, int, int);

// whole rays a block, a multiple of the rays that fill whole tiles: the
// rays a block takes and the grid, over `sms` blocks at most
static void ray_blocks(long long n_rays, int S, int sms, long long* per_block,
                       unsigned* grid) {
  const long long chunk = nstt::tc::TP / gcd_ll(S, nstt::tc::TP);
  const long long n_chunks = (n_rays + chunk - 1) / chunk;
  const long long per = (n_chunks + sms - 1) / sms;
  *grid = (unsigned)((n_chunks + per - 1) / per);
  *per_block = per * chunk;
}

extern "C" int nstt_render_rays_tc(const void* desc_dev, int HS, int SLOT,
                                   const float* wb, const float* A, const float* B,
                                   const float* z, const float* rays_d, float* out8,
                                   float* weights, long long n_rays, int S,
                                   int white_bkgd, void* stream) {
  using namespace nstt::tc;
  RenderKernel kernel = nerf_render_tc_kernel;
  int R, sms;
  size_t bytes;
  int rc = plan((const void*)kernel, HS, SLOT, RayEnc::ROW, &R, &bytes, &sms);
  if (rc != 0) return rc;
  long long per_block;
  unsigned grid;
  ray_blocks(n_rays, S, sms, &per_block, &grid);
  cudaError_t e = cudaFuncSetAttribute(
      (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, NTHREADS, bytes, (cudaStream_t)stream>>>(
      (const Desc*)desc_dev, wb, A, B, z, rays_d, out8, weights, n_rays, S,
      white_bkgd, per_block, R);
  return (int)cudaGetLastError();
}

// B4 in bf16, over pack_network_tc(..., bf16=True): SLOT and E as for
// nstt_rays_forward_bf16, the other arguments as in fp32
extern "C" int nstt_render_rays_bf16(const void* desc_dev, int SLOT, int E,
                                     const float* wb, const float* A, const float* B,
                                     const float* z, const float* rays_d, float* out8,
                                     float* weights, long long n_rays, int S,
                                     int white_bkgd, void* stream) {
  using namespace nstt;
  RenderBf16Kernel kernel = tc::nerf_render_bf16_kernel;
  int R, sms;
  size_t bytes;
  int rc = bf16::plan((const void*)kernel, SLOT, E, tc::RayEnc::ROW, &R, &bytes, &sms);
  if (rc != 0) return rc;
  long long per_block;
  unsigned grid;
  ray_blocks(n_rays, S, sms, &per_block, &grid);
  cudaError_t e = cudaFuncSetAttribute(
      (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, bf16::NTHREADS, bytes, (cudaStream_t)stream>>>(
      (const tc::Desc*)desc_dev, wb, A, B, z, rays_d, out8, weights, n_rays, S,
      white_bkgd, per_block, R, SLOT, E);
  return (int)cudaGetLastError();
}
