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
#include "mlp_tile_tc.cuh"

namespace nstt {
namespace tc {

__global__ void __launch_bounds__(NTHREADS, 1)
nerf_render_tc_kernel(const Desc* __restrict__ gdesc, const float* __restrict__ wb,
                      const float* __restrict__ A, const float* __restrict__ B,
                      const float* __restrict__ z, const float* __restrict__ rays_d,
                      float* __restrict__ out8, float* __restrict__ weights,
                      long long n_rays, int S, int white_bkgd, long long rays_per_block,
                      int R) {
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
    tile_network(d, wb, e, s, ring);

    // per point: rgb sigmoids in place, alpha -> col 4, depth -> col 6
    if (threadIdx.x < TP) {
      const long long gp = p0 + threadIdx.x;
      if (gp < pend) {
        const long long r = gp / S;
        const int si = (int)(gp - r * S);
        float* rw = s.raw + threadIdx.x * RAW_LD;
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
    __syncthreads();

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
          float* rw = s.raw + (q0 + k) * RAW_LD;
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
    __syncthreads();
    if (weights && threadIdx.x < TP && p0 + threadIdx.x < pend)
      weights[p0 + threadIdx.x] = s.raw[threadIdx.x * RAW_LD + 5];
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

extern "C" int nstt_render_rays_tc(const void* desc_dev, int HS, int SLOT,
                                   const float* wb, const float* A, const float* B,
                                   const float* z, const float* rays_d, float* out8,
                                   float* weights, long long n_rays, int S,
                                   int white_bkgd, void* stream) {
  using namespace nstt::tc;
  int R, sms;
  size_t bytes;
  int rc = plan((const void*)nerf_render_tc_kernel, HS, SLOT, RayEnc::ROW, &R, &bytes, &sms);
  if (rc != 0) return rc;
  // whole rays a block, a multiple of the rays that fill whole tiles
  const long long chunk = TP / gcd_ll(S, TP);
  const long long n_chunks = (n_rays + chunk - 1) / chunk;
  const long long per_block = (n_chunks + sms - 1) / sms;
  const unsigned grid = (unsigned)((n_chunks + per_block - 1) / per_block);
  cudaError_t e = cudaFuncSetAttribute(
      nerf_render_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  nerf_render_tc_kernel<<<grid, NTHREADS, bytes, (cudaStream_t)stream>>>(
      (const Desc*)desc_dev, wb, A, B, z, rays_d, out8, weights, n_rays, S,
      white_bkgd, per_block * chunk, R);
  return (int)cudaGetLastError();
}
