// Alpha compositing of raw network outputs (kernel B5).
//
// Replaces the TPU kernel nerf_shared_tpu/ops/pallas/composite.py _kernel
// (launched by _composite_fused_impl, entry composite_fused): raw2outputs
// without sigma noise. raw [N, S, C >= 4], z [N, S] and rays_d [N, 3] go in;
// out8 [N, 8] (r, g, b, disp, acc, depth, 0, 0) and, when asked, the
// compositing weights [N, S] come out:
//
//   alpha_s = 1 - exp(-relu(sigma_s) * (z_{s+1} - z_s) * |d|)   (last: 1e10)
//   T_s     = prod_{j<s} ((1 - alpha_j) + 1e-10)
//   w_s     = alpha_s * T_s;  rgb = sum w sigmoid(raw[:3]) (+ 1 - acc)
//   acc = sum w, depth = sum w z, disp = 1 / max(1e-10, depth / max(acc, 1e-10))
//
// What bounds it on an H100: bytes. A sample reads 16 B of raw and 4 B of z
// and writes 4 B of weight against ~40 operations (four exp), ~1.7 op per
// byte, far below the card's ~20 fp32 operations per byte of memory rate.
//
// What the design does about it: the TPU kernel works on sample-major tiles
// (samples on sublanes, rays on lanes), so its caller transposes raw to
// [4, S, R], and it turns the exclusive transmittance into a log-space
// matmul with a strict triangular matrix. Here raw stays ray-major, as B3
// writes it: one warp per ray, lane i on sample c0 + i of each 32-sample
// chunk, so a chunk's raw is one coalesced 512-byte read (float4 per lane).
// The transmittance is a running product: a shuffle product-scan over the
// lanes times the carry of the earlier chunks, the cumprod of raw2outputs in
// another association order. Sums over samples stay in per-lane partials,
// reduced across the warp once per ray. Any S >= 1; the last sample of a ray
// gets the 1e10 interval, so at S = 1 the single sample does.
#include <cuda_runtime.h>
#include <stdint.h>

namespace nstt {

constexpr int COMP_WARPS = 8;  // rays per block
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(COMP_WARPS * 32)
composite_kernel(const float* __restrict__ raw, const float* __restrict__ z,
                 const float* __restrict__ rays_d, float* __restrict__ out8,
                 float* __restrict__ weights, long long n_rays, int S, int C,
                 int white_bkgd) {
  const int lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * COMP_WARPS + (threadIdx.x >> 5);
  if (r >= n_rays) return;  // the whole warp leaves together
  const float dx = __ldg(rays_d + r * 3), dy = __ldg(rays_d + r * 3 + 1),
              dz = __ldg(rays_d + r * 3 + 2);
  const float dn = sqrtf(dx * dx + dy * dy + dz * dz);
  const float* rr = raw + r * (long long)S * C;
  const float* zr = z + r * (long long)S;
  const bool vec = C == 4 && (reinterpret_cast<uintptr_t>(rr) & 15) == 0;

  float carry = 1.f;  // transmittance before this chunk
  float cr = 0.f, cg = 0.f, cb = 0.f, dep = 0.f, acc = 0.f;
  for (int c0 = 0; c0 < S; c0 += 32) {
    const int s = c0 + lane;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    float zs = 0.f, alpha = 0.f, t = 1.f;  // lanes past S: factor 1, weight 0
    if (s < S) {
      if (vec) {
        v = __ldg(reinterpret_cast<const float4*>(rr) + s);
      } else {
        const float* p = rr + (long long)s * C;
        v = make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
      }
      zs = __ldg(zr + s);
      const float dist = (s < S - 1 ? __ldg(zr + s + 1) - zs : 1e10f) * dn;
      alpha = 1.f - expf(-fmaxf(v.w, 0.f) * dist);
      t = (1.f - alpha) + 1e-10f;
    }
    float inc = t;  // inclusive product scan of t over the lanes
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(FULL, inc, off);
      if (lane >= off) inc *= o;
    }
    float exc = __shfl_up_sync(FULL, inc, 1);
    if (lane == 0) exc = 1.f;
    if (s < S) {
      const float w = alpha * (carry * exc);
      cr += w * (1.f / (1.f + expf(-v.x)));
      cg += w * (1.f / (1.f + expf(-v.y)));
      cb += w * (1.f / (1.f + expf(-v.z)));
      dep += w * zs;
      acc += w;
      if (weights) weights[r * S + s] = w;
    }
    carry *= __shfl_sync(FULL, inc, 31);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    cr += __shfl_xor_sync(FULL, cr, off);
    cg += __shfl_xor_sync(FULL, cg, off);
    cb += __shfl_xor_sync(FULL, cb, off);
    dep += __shfl_xor_sync(FULL, dep, off);
    acc += __shfl_xor_sync(FULL, acc, off);
  }
  if (lane == 0) {
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
  }
}

}  // namespace nstt

extern "C" int nstt_composite(const float* raw, const float* z, const float* rays_d,
                              float* out8, float* weights, long long n_rays, int S,
                              int C, int white_bkgd, void* stream) {
  using namespace nstt;
  const long long blocks = (n_rays + COMP_WARPS - 1) / COMP_WARPS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  composite_kernel<<<(unsigned)blocks, COMP_WARPS * 32, 0, (cudaStream_t)stream>>>(
      raw, z, rays_d, out8, weights, n_rays, S, C, white_bkgd);
  return (int)cudaGetLastError();
}
