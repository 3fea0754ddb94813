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
// B1 runs the fp32 CUDA-core tile of mlp_tile.cuh (64 points a block, an
// 8x8 register tile a thread; ~44% of the fp32 peak).
//
// B3 replaces nerf_shared_tpu/ops/pallas/fused_mlp.py:280 _make_ray_kernel
// (launched by _ray_forward_impl, entry fused_nerf_forward_rays): per-ray
// encoder coefficients A = [o, dir]·F and B = [d]·F plus depths z [N, S] go
// in, raw [N, S, out_ch] comes out, and the per-point input and embedded
// features never exist in device memory.
//
// What bounds B3 on an H100: operations. At the lego width (8x256, skip at
// 4, viewdirs, multires 10/4) a point costs ~1.19 MFLOP against ~4 bytes of
// input (one z) and 16 bytes of output. Its split-fp32 design does three
// TF32 products a multiply-add, so its own bound is 3 x FLOPs over the
// 495 TFLOP/s TF32 tensor-core rate (15.1 / 45.3 ms at a 32768-ray block
// of S = 64 / 192); the fp32 CUDA-core bound (FLOPs over 67 TFLOP/s,
// 37.2 / 111.4 ms) is what a CUDA-core kernel could reach at best.
//
// What the design does about it: mlp_tile_tc.cuh. The GEMMs run on the
// tensor cores (wgmma) in split fp32 (fp32 accuracy; the encoder's
// sinusoid arguments reach 2^9·|x|, so plain TF32 is not allowed), 128
// points a block, weights streamed in 8-row slices by bulk copies through
// a ring of shared-memory slots handed over by mbarriers, so the copy of
// the next slices overlaps the current slice's MMAs and no block-wide
// barrier separates two slices. Persistent blocks (one an SM) walk the
// tiles, so the ring never drains between tiles. Only the used output
// channels are written.
#include "mlp_tile.cuh"
#include "mlp_tile_tc.cuh"

namespace nstt {

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

namespace tc {

// B3: one persistent block an SM walks the flat point tiles (gp = r * S + s)
__global__ void __launch_bounds__(NTHREADS, 1)
nerf_rays_tc_kernel(const Desc* __restrict__ gdesc, const float* __restrict__ wb,
                    const float* __restrict__ A, const float* __restrict__ B,
                    const float* __restrict__ z, float* __restrict__ out,
                    long long total, int S, int R) {
  __shared__ Desc d;
  __shared__ unsigned long long bars[2 * MAX_SLOTS];
  extern __shared__ float4 dyn[];
  load_desc(d, gdesc);
  __syncthreads();
  const int OUT = (int)d.hdr[H_OUT];
  const Smem s = carve(reinterpret_cast<float*>(dyn), (int)d.hdr[H_HS]);
  const long long n_tiles = (total + TP - 1) / TP;
  const long long mine = n_tiles > blockIdx.x
                             ? (n_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
  Ring ring = start_ring(d, wb, s.ring, bars, R, mine);
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long p0 = t * TP;
    tile_rows(d, z, p0, total, S, s);
    tile_network(d, wb, A, B, s, ring);
    for (int i = threadIdx.x; i < TP * OUT; i += NTHREADS) {
      const int q = i / OUT, o = i - q * OUT;
      const long long gp = p0 + q;
      if (gp < total) out[gp * OUT + o] = s.raw[q * RAW_LD + o];
    }
  }
}

}  // namespace tc
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

// B3 on the tensor cores: HS is the activations' shared row stride of the
// pack and SLOT the floats of its largest weight slice.
extern "C" int nstt_rays_forward_tc(const void* desc_dev, int HS, int SLOT,
                                    const float* wb, const float* A, const float* B,
                                    const float* z, float* out, long long n_rays,
                                    int S, void* stream) {
  using namespace nstt::tc;
  int R, sms;
  size_t bytes;
  int rc = plan((const void*)nerf_rays_tc_kernel, HS, SLOT, &R, &bytes, &sms);
  if (rc != 0) return rc;
  const long long total = n_rays * S, n_tiles = (total + TP - 1) / TP;
  const unsigned grid = (unsigned)(n_tiles < sms ? n_tiles : sms);
  cudaError_t e = cudaFuncSetAttribute(
      nerf_rays_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  nerf_rays_tc_kernel<<<grid, NTHREADS, bytes, (cudaStream_t)stream>>>(
      (const Desc*)desc_dev, wb, A, B, z, out, total, S, R);
  return (int)cudaGetLastError();
}
