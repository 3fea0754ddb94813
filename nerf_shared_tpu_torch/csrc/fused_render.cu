// Fused ray-major MLP + alpha composite (kernel B4).
//
// Replaces the TPU kernel nerf_shared_tpu/ops/pallas/fused_render.py
// _make_render_kernel (launched by _render_impl, entry fused_render_rays):
// the B3 network plus raw2outputs without sigma noise, so only per-ray
// values (rgb, disp, acc, depth: [N, 8]) and, when asked, the compositing
// weights [N, S] reach device memory.
//
// What bounds it on an H100: operations, as for B3 (~1.19 MFLOP per point
// at the lego width against ~8 bytes of input per point); the composite
// adds a few dozen operations per sample.
//
// What the design does about it: one block walks one ray at a time, its
// samples in tiles of 64 through the shared-memory MLP of mlp_tile.cuh.
// The TPU kernel turns the exclusive transmittance into a log-space matmul
// against a strict triangular matrix; here it is what it is, a sequential
// product along the ray, carried across tiles by one thread in shared
// memory (T *= 1 - alpha + 1e-10, the cumprod form of raw2outputs), which
// costs ~1% of a tile's MLP time. Alpha uses the 1e10 sentinel interval on
// the last sample, as raw2outputs does.
#include "mlp_tile.cuh"

namespace nstt {

__global__ void __launch_bounds__(NTHREADS)
nerf_render_kernel(const NetDesc* __restrict__ gdesc, const float* __restrict__ wb,
                   const float* __restrict__ A, const float* __restrict__ B,
                   const float* __restrict__ z, const float* __restrict__ rays_d,
                   float* __restrict__ out8, float* __restrict__ weights,
                   long long n_rays, int S, int white_bkgd) {
  __shared__ NetDesc d;
  __shared__ float st[6];   // T, r, g, b, depth, acc of the current ray
  extern __shared__ float4 dyn[];
  load_desc(d, gdesc);
  __syncthreads();
  const int HS = (int)d.hdr[H_HS], ES = (int)(d.hdr[H_P4] + d.hdr[H_V4]);
  const Smem s = carve(reinterpret_cast<float*>(dyn), HS, ES);
  for (int i = threadIdx.x; i < TILE_P * HS; i += NTHREADS) s.h[i] = 0.f;

  for (long long r = blockIdx.x; r < n_rays; r += gridDim.x) {
    const float* zr = z + r * S;
    if (threadIdx.x == 0) {
      st[0] = 1.f;
      for (int i = 1; i < 6; ++i) st[i] = 0.f;
    }
    for (int c0 = 0; c0 < S; c0 += TILE_P) {
      for (int i = threadIdx.x; i < TILE_P * ES; i += NTHREADS) {
        const int p = i / ES, cc = emb_col(d, i % ES);
        s.emb[i] = (cc >= 0 && c0 + p < S)
                       ? emb_value(d, A, B, r, __ldg(zr + c0 + p), cc) : 0.f;
      }
      __syncthreads();
      mlp_tile(d, wb, s);
      if (threadIdx.x == 0) {
        const float dx = rays_d[r * 3], dy = rays_d[r * 3 + 1], dz = rays_d[r * 3 + 2];
        const float dn = sqrtf(dx * dx + dy * dy + dz * dz);
        float T = st[0], cr = st[1], cg = st[2], cb = st[3], dep = st[4], acc = st[5];
        const int n = min(TILE_P, S - c0);
        for (int p = 0; p < n; ++p) {
          const int si = c0 + p;
          const float zs = zr[si];
          const float dist = (si < S - 1 ? zr[si + 1] - zs : 1e10f) * dn;
          const float* rw = s.raw + p * RAW_LD;
          const float alpha = 1.f - expf(-fmaxf(rw[3], 0.f) * dist);
          const float w = alpha * T;
          T = T * ((1.f - alpha) + 1e-10f);
          cr += w * (1.f / (1.f + expf(-rw[0])));
          cg += w * (1.f / (1.f + expf(-rw[1])));
          cb += w * (1.f / (1.f + expf(-rw[2])));
          dep += w * zs;
          acc += w;
          if (weights) weights[r * S + si] = w;
        }
        st[0] = T; st[1] = cr; st[2] = cg; st[3] = cb; st[4] = dep; st[5] = acc;
      }
      __syncthreads();
    }
    if (threadIdx.x == 0) {
      const float acc = st[5], dep = st[4];
      const float bg = white_bkgd ? 1.f - acc : 0.f;
      float* o = out8 + r * 8;
      o[0] = st[1] + bg;
      o[1] = st[2] + bg;
      o[2] = st[3] + bg;
      o[3] = 1.f / fmaxf(1e-10f, dep / fmaxf(acc, 1e-10f));
      o[4] = acc;
      o[5] = dep;
      o[6] = 0.f;
      o[7] = 0.f;
    }
  }
}

}  // namespace nstt

extern "C" int nstt_render_rays(const void* desc_dev, int HS, int ES,
                                const float* wb, const float* A, const float* B,
                                const float* z, const float* rays_d, float* out8,
                                float* weights, long long n_rays, int S,
                                int white_bkgd, void* stream) {
  using namespace nstt;
  const size_t bytes = smem_floats(HS, ES) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      nerf_render_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const unsigned grid = (unsigned)(n_rays < 0x7fffffffLL ? n_rays : 0x7fffffffLL);
  nerf_render_kernel<<<grid, NTHREADS, bytes, (cudaStream_t)stream>>>(
      (const NetDesc*)desc_dev, wb, A, B, z, rays_d, out8, weights, n_rays, S,
      white_bkgd);
  return (int)cudaGetLastError();
}
