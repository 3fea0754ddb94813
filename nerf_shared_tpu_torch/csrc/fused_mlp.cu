// Fused positional encoding + NeRF MLP forward: point-major (kernel B1) and
// ray-major (kernel B3).
//
// B1 replaces the TPU kernel nerf_shared_tpu/ops/pallas/fused_mlp.py
// _make_kernel (launched by _fused_forward_impl; entries fused_nerf_forward
// and fused_mlp_bwd.fused_train_op, the forward of every training step):
// points [N, 3] and per-ray view directions [N / S, 3] go in, raw [N, C]
// comes out. The TPU kernel reads a padded [N, 8] (pts, dirs, 0, 0) input
// and forms the encoding as x @ F + phase; here each embedding column reads
// its input and forms f * x, rounded as the plain embed rounds it, so for
// power-of-two f the sinusoid arguments are bit for bit the plain
// version's, and the directions are broadcast per ray inside the kernel.
//
// B3 replaces _make_ray_kernel (launched by _ray_forward_impl, entry
// fused_nerf_forward_rays): per-ray encoder coefficients A = [o, dir]·F and
// B = [d]·F plus depths z [N, S] go in, raw [N, S, out_ch] comes out, and the
// per-point input and embedded features never exist in device memory.
//
// Both share mlp_tile.cuh and differ only in how a tile is encoded.
//
// What bounds it on an H100: operations. At the lego width (8x256, skip at
// 4, viewdirs, multires 10/4) a point costs ~1.19 MFLOP against ~4 bytes of
// input (one z) and 16 bytes of output, ~6e4 FLOP/byte, so the fp32
// CUDA-core rate (no TF32: the encoder's sinusoid arguments reach 2^9·|x|)
// is the roof, not the 3.35 TB/s memory.
//
// What the design does about it: the TPU kernel keeps all nine weight
// matrices resident in VMEM; a Hopper block has 227 KB of shared memory and
// the fp32 net is ~2.4 MB, so here a block keeps one tile of 64 points'
// encodings and activations on chip for the whole network and streams the
// weights layer by layer through a shared staging tile (mlp_tile.cuh), with
// an 8x8 register tile per thread so each shared-memory load feeds 8 FMAs.
// Only the used output channels are written. Tensor cores (wgmma, bf16/TF32
// operands) are not used: that is later work.
#include "mlp_tile.cuh"

namespace nstt {

__global__ void __launch_bounds__(NTHREADS)
nerf_rays_kernel(const NetDesc* __restrict__ gdesc, const float* __restrict__ wb,
                 const float* __restrict__ A, const float* __restrict__ B,
                 const float* __restrict__ z, float* __restrict__ out,
                 long long total, int S) {
  __shared__ NetDesc d;
  extern __shared__ float4 dyn[];
  load_desc(d, gdesc);
  __syncthreads();
  const int HS = (int)d.hdr[H_HS], ES = (int)(d.hdr[H_P4] + d.hdr[H_V4]);
  const int OUT = (int)d.hdr[H_OUT];
  const Smem s = carve(reinterpret_cast<float*>(dyn), HS, ES);
  for (int i = threadIdx.x; i < TILE_P * HS; i += NTHREADS) s.h[i] = 0.f;

  const long long n_tiles = (total + TILE_P - 1) / TILE_P;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long p0 = t * TILE_P;   // flat point index r*S + s
    for (int i = threadIdx.x; i < TILE_P * ES; i += NTHREADS) {
      const int p = i / ES, cc = emb_col(d, i % ES);
      const long long gp = p0 + p;
      s.emb[i] = (cc >= 0 && gp < total)
                     ? emb_value(d, A, B, gp / S, __ldg(z + gp), cc) : 0.f;
    }
    __syncthreads();
    mlp_tile(d, wb, s);
    for (int i = threadIdx.x; i < TILE_P * OUT; i += NTHREADS) {
      const int p = i / OUT, o = i % OUT;
      const long long gp = p0 + p;
      if (gp < total) out[gp * OUT + o] = s.raw[p * RAW_LD + o];
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(NTHREADS)
nerf_points_kernel(const NetDesc* __restrict__ gdesc, const float* __restrict__ wb,
                   const float* __restrict__ enc, const float* __restrict__ pts,
                   const float* __restrict__ vd, float* __restrict__ out,
                   long long total, int S) {
  __shared__ NetDesc d;
  extern __shared__ float4 dyn[];
  load_desc(d, gdesc);
  __syncthreads();
  const int HS = (int)d.hdr[H_HS], ES = (int)(d.hdr[H_P4] + d.hdr[H_V4]);
  const int OUT = (int)d.hdr[H_OUT];
  const Smem s = carve(reinterpret_cast<float*>(dyn), HS, ES);
  for (int i = threadIdx.x; i < TILE_P * HS; i += NTHREADS) s.h[i] = 0.f;

  const long long n_tiles = (total + TILE_P - 1) / TILE_P;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long p0 = t * TILE_P;
    encode_points(d, enc, pts, vd, p0, total, S, s.emb, ES);
    __syncthreads();
    mlp_tile(d, wb, s);
    for (int i = threadIdx.x; i < TILE_P * OUT; i += NTHREADS) {
      const int p = i / OUT, o = i % OUT;
      const long long gp = p0 + p;
      if (gp < total) out[gp * OUT + o] = s.raw[p * RAW_LD + o];
    }
    __syncthreads();
  }
}

}  // namespace nstt

static unsigned grid_for(long long total) {
  const long long n_tiles = (total + nstt::TILE_P - 1) / nstt::TILE_P;
  return (unsigned)(n_tiles < 0x7fffffffLL ? n_tiles : 0x7fffffffLL);
}

extern "C" int nstt_points_forward(const void* desc_dev, int HS, int ES,
                                   const float* wb, const float* enc,
                                   const float* pts, const float* vd, float* out,
                                   long long total, int S, void* stream) {
  using namespace nstt;
  const size_t bytes = smem_floats(HS, ES) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      nerf_points_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  nerf_points_kernel<<<grid_for(total), NTHREADS, bytes, (cudaStream_t)stream>>>(
      (const NetDesc*)desc_dev, wb, enc, pts, vd, out, total, S);
  return (int)cudaGetLastError();
}

extern "C" int nstt_rays_forward(const void* desc_dev, int HS, int ES,
                                 const float* wb, const float* A, const float* B,
                                 const float* z, float* out, long long n_rays,
                                 int S, void* stream) {
  using namespace nstt;
  const size_t bytes = smem_floats(HS, ES) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      nerf_rays_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const long long total = n_rays * S;
  nerf_rays_kernel<<<grid_for(total), NTHREADS, bytes, (cudaStream_t)stream>>>(
      (const NetDesc*)desc_dev, wb, A, B, z, out, total, S);
  return (int)cudaGetLastError();
}
