// Fused positional encoding + NeRF MLP forward: point-major (kernel B1) and
// ray-major (kernel B3), one tensor-core tile (mlp_tile_tc.cuh) with two
// encoders.
//
// B1 replaces the TPU kernel nerf_shared_tpu/ops/pallas/fused_mlp.py:253
// _make_kernel (launched at :348 by _fused_forward_impl; entries
// fused_nerf_forward and fused_mlp_bwd.fused_train_op, the forward of every
// training step, of the gated engine's passes and of the occupancy grid's
// probes): points [N, 3] and per-ray view directions [N / S, 3] go in, raw
// [N, C] comes out. The TPU kernel reads a padded [N, 8] (pts, dirs, 0, 0)
// input and forms the encoding as x @ F + phase; here each embedding column
// reads its input and forms f * x, rounded as the plain embed rounds it, so
// for power-of-two f the sinusoid arguments are bit for bit the plain
// version's, and the directions are broadcast per ray inside the kernel
// (mlp_tile_tc.cuh PointEnc).
//
// B3 replaces nerf_shared_tpu/ops/pallas/fused_mlp.py:280 _make_ray_kernel
// (launched by _ray_forward_impl, entry fused_nerf_forward_rays): per-ray
// encoder coefficients A = [o, dir]·F and B = [d]·F plus depths z [N, S] go
// in, raw [N, S, out_ch] comes out, and the per-point input and embedded
// features never exist in device memory (mlp_tile_tc.cuh RayEnc).
//
// What bounds both on an H100: operations. At the lego width (8x256, skip
// at 4, viewdirs, multires 10/4) a point costs ~1.19 MFLOP against 4 (B3:
// one z) or 12 (B1: the point) bytes of input and 16 bytes of output. The
// split-fp32 design does three TF32 products a multiply-add, so its own
// bound is 3 x FLOPs over the 495 TFLOP/s TF32 tensor-core rate (B1: 0.47 /
// 1.41 ms at a training step's 65,536 / 196,608 points; B3: 15.1 / 45.3 ms
// at a 32768-ray block of S = 64 / 192); the fp32 CUDA-core bound (FLOPs
// over 67 TFLOP/s; B1 1.16 / 3.48 ms, B3 37.2 / 111.4 ms) is what a
// CUDA-core kernel could reach at best.
//
// What the design does about it: mlp_tile_tc.cuh. The GEMMs run on the
// tensor cores (wgmma) in split fp32 (fp32 accuracy; the encoder's
// sinusoid arguments reach 2^9·|x|, so plain TF32 is not allowed), 128
// points a block, weights streamed in 8-row slices by bulk copies through
// a ring of shared-memory slots handed over by mbarriers, so the copy of
// the next slices overlaps the current slice's MMAs and no block-wide
// barrier separates two slices. Persistent blocks (one an SM) walk the
// tiles, so the ring never drains between tiles. The encoded inputs are
// formed where a GEMM reads them from a few floats a point, so the shared
// memory goes to the weight ring. Only the used output channels are
// written. B1 adds each 8-row slice's products in fp32 on the CUDA cores
// (the tensor cores' own running sum drifts: mlp_tile_tc.cuh); that costs
// it ~30% against B3's running sum, in registers (its slice sums beside
// the accumulators) and in one wait for the MMAs per m64 block and slice.
#include "mlp_tile_tc.cuh"

namespace nstt {
namespace tc {

// One persistent block an SM walks the flat point tiles (B3: gp = r * S +
// s), the ring running on from tile to tile; kSliceSums: tile_network's
// per-slice sums rounded to nearest (B1).
template <class Enc, bool kSliceSums>
__device__ inline void forward_tiles(const Desc* __restrict__ gdesc,
                                     const float* __restrict__ wb, const Enc& e,
                                     float* __restrict__ out, long long total, int R) {
  __shared__ Desc d;
  __shared__ unsigned long long bars[2 * MAX_SLOTS];
  extern __shared__ float4 dyn[];
  load_desc(d, gdesc);
  __syncthreads();
  const int OUT = (int)d.hdr[H_OUT];
  const Smem s = carve(reinterpret_cast<float*>(dyn), (int)d.hdr[H_HS], Enc::ROW);
  const long long n_tiles = (total + TP - 1) / TP;
  const long long mine = n_tiles > blockIdx.x
                             ? (n_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
  Ring ring = start_ring(d, wb, s.ring, bars, R, mine);
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long p0 = t * TP;
    tile_rows(d, e, p0, total, s);
    tile_network<Enc, kSliceSums>(d, wb, e, s, ring);
    for (int i = threadIdx.x; i < TP * OUT; i += NTHREADS) {
      const int q = i / OUT, o = i - q * OUT;
      const long long gp = p0 + q;
      if (gp < total) out[gp * OUT + o] = s.raw[q * RAW_LD + o];
    }
  }
}

// B1: points [total][3], directions [total / S][3] (null without viewdirs)
__global__ void __launch_bounds__(NTHREADS, 1)
nerf_points_tc_kernel(const Desc* __restrict__ gdesc, const float* __restrict__ wb,
                      const float* __restrict__ enc, const float* __restrict__ pts,
                      const float* __restrict__ vd, float* __restrict__ out,
                      long long total, int S, int R) {
  forward_tiles<PointEnc, true>(gdesc, wb, PointEnc{pts, vd, enc, S}, out, total, R);
}

// B3: rays' A, B [rays][EMB], depths z [rays][S]
__global__ void __launch_bounds__(NTHREADS, 1)
nerf_rays_tc_kernel(const Desc* __restrict__ gdesc, const float* __restrict__ wb,
                    const float* __restrict__ A, const float* __restrict__ B,
                    const float* __restrict__ z, float* __restrict__ out,
                    long long total, int S, int R) {
  forward_tiles<RayEnc, false>(gdesc, wb, RayEnc{A, B, z, S}, out, total, R);
}

// plan() the ring of a forward kernel and its persistent grid, min(tiles,
// SMs); 0 on success
template <class Enc>
int setup(const void* kernel, int HS, int SLOT, long long total, int* R, size_t* bytes,
          unsigned* grid) {
  int sms;
  int rc = plan(kernel, HS, SLOT, Enc::ROW, R, bytes, &sms);
  if (rc != 0) return rc;
  const long long n_tiles = (total + TP - 1) / TP;
  *grid = (unsigned)(n_tiles < sms ? n_tiles : sms);
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)*bytes);
}

}  // namespace tc
}  // namespace nstt

// B1 on the tensor cores: HS is the activations' shared row stride of the
// pack (pack_network_tc), SLOT the floats of its largest weight slice, enc
// the point-major encoder table (encoder_buffer).
extern "C" int nstt_points_forward_tc(const void* desc_dev, int HS, int SLOT,
                                      const float* wb, const float* enc,
                                      const float* pts, const float* vd, float* out,
                                      long long total, int S, void* stream) {
  using namespace nstt::tc;
  if (total <= 0) return 0;
  int R;
  size_t bytes;
  unsigned grid;
  int rc = setup<PointEnc>((const void*)nerf_points_tc_kernel, HS, SLOT, total, &R, &bytes,
                           &grid);
  if (rc != 0) return rc;
  nerf_points_tc_kernel<<<grid, NTHREADS, bytes, (cudaStream_t)stream>>>(
      (const Desc*)desc_dev, wb, enc, pts, vd, out, total, S, R);
  return (int)cudaGetLastError();
}

// B3 on the tensor cores: HS and SLOT as for B1.
extern "C" int nstt_rays_forward_tc(const void* desc_dev, int HS, int SLOT,
                                    const float* wb, const float* A, const float* B,
                                    const float* z, float* out, long long n_rays,
                                    int S, void* stream) {
  using namespace nstt::tc;
  const long long total = n_rays * S;
  if (total <= 0) return 0;
  int R;
  size_t bytes;
  unsigned grid;
  int rc = setup<RayEnc>((const void*)nerf_rays_tc_kernel, HS, SLOT, total, &R, &bytes,
                         &grid);
  if (rc != 0) return rc;
  nerf_rays_tc_kernel<<<grid, NTHREADS, bytes, (cudaStream_t)stream>>>(
      (const Desc*)desc_dev, wb, A, B, z, out, total, S, R);
  return (int)cudaGetLastError();
}
