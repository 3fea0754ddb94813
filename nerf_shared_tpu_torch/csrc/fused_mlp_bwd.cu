// Fused backward of the NeRF MLP (kernel B2): every parameter gradient and
// the input gradient of the points, the forward rematerialised per tile.
//
// Replaces the TPU kernel nerf_shared_tpu/ops/pallas/fused_mlp_bwd.py
// _make_bwd_kernel_closed (launched by fused_mlp_backward; paired with B1 as
// fused_train_op, the backward of every training step). Input: points
// [N, 3], per-ray view directions [N / S, 3] and the cotangent of the raw
// outputs g [N, C]. Output: the gradient of every weight and bias, in the
// packed [in][ld] layout of the forward weights (ops/cuda/fused_mlp.py
// pack_network), and dx [N, 6] (d/dpts, d/ddirs per point).
//
// What bounds it on an H100: operations. A point costs about three forward
// passes (rematerialised forward, input gradients through every layer, the
// weight-gradient products H^T·dZ), ~3.6 MFLOP at the lego width, all fp32
// on the CUDA cores.
//
// What the design does about it, and the two budgets that shape it:
//
// - Activations. The TPU kernel keeps a 512-point tile's activations in
//   VMEM. Backward needs, per point, the encoding (92 floats at the lego
//   width), eight trunk outputs (8 x 256), the feature (256) and hv (128):
//   ~9.9 KB, so a 64-point tile (TILE_P) needs ~646 KB, far above a block's
//   227 KB of shared memory. Here a block keeps two [64][256] activation
//   buffers (X: the running gradient, Y: the layer input or relu mask), the
//   encoding and its gradient, the cotangent tile and a 16-row weight
//   staging tile in shared memory (~199 KB at the lego width), and writes
//   each layer's output to a private scratch in device memory during the
//   forward, reading it back once in the backward (~0.64 MB per tile per
//   block; 132 blocks x 10 x 64 KB = 86 MB, about L2-sized).
// - Weight gradients across blocks. On the TPU the grid runs in order and
//   the gradients accumulate in revisited VMEM blocks. Here nothing carries
//   between blocks: one persistent block per SM walks its tiles in order
//   and accumulates into its own fp32 partial copy of all gradients in
//   device memory (2.38 MB per block at the lego width: a read-modify-write
//   of ~4.8 MB per tile, ~15 GB for the 196,608-point fine pass); a second
//   kernel then sums the partials over the blocks in a fixed order. The
//   result does not depend on scheduling, so it is the same on every run.
//   Per-tile atomics into the 595,844 gradient addresses were the other way
//   and are both slower and run-to-run different.
// - Input gradients through a layer are dZ·W, products with the weights in
//   PyTorch's [out][in] layout (a second packed copy, split at the skip and
//   view-direction concatenations), through the same 8x8-per-thread
//   register tile as the forward (mlp_tile.cuh gemm_acc). The weight
//   gradients are an outer-product accumulation over the tile's 64 points,
//   8x8 per thread, 128x128 per pass.
// - dx as the TPU kernel computes it (fused_mlp_bwd.py:299-300): through
//   identity columns 1, through sin(f·x) f·cos(f·x), through cos(f·x)
//   -f·sin(f·x), summed per input coordinate.
//
// fp32 throughout, no tensor cores: wgmma, TMA and bf16 are later work.
#include "mlp_tile.cuh"

namespace nstt {

constexpr int KC_BWD = 16;   // weight rows staged per step (shared memory)
constexpr int G_LD = 8;      // cotangent tile row: rgb 0-2, alpha 3, alpha 4

// PyTorch-layout ([out][in]) weight segments for the input-gradient
// products: {float offset, row stride}; offset -1 where there is none.
enum { BW_ALPHA, BW_FEATURE, BW_VIEWS_F, BW_VIEWS_D, BW_RGB, BW_OUTPUT };
struct BwdDesc {
  long long seg[MAX_LAYERS][2][2];   // layer l: [0] embedding part, [1] h part
  long long head[6][2];
};

// ops/cuda/fused_mlp_bwd.py smem_bytes mirrors this (plus the two
// descriptors in static shared memory) to refuse widths that do not fit
__host__ __device__ inline size_t bwd_smem_floats(int HS, int ES) {
  return (size_t)KC_BWD * MAXW + 2 * (size_t)TILE_P * HS
       + 2 * (size_t)TILE_P * ES + (size_t)TILE_P * G_LD;
}

// Epilogues of a gemm_acc without bias: store, add, or store where the
// relu mask (the layer's output) is positive.
enum { PUT_STORE, PUT_ADD, PUT_MASK };
template <int MODE>
__device__ __forceinline__ void put(const float (&acc)[8][8], int N, float* dst,
                                    int ds, const float* mask) {
  const int lane = threadIdx.x & 31, row0 = (threadIdx.x >> 5) * 8;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = acc_col(lane, j);
    if (col < N) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int k = (row0 + i) * ds + col;
        if (MODE == PUT_STORE) dst[k] = acc[i][j];
        if (MODE == PUT_ADD) dst[k] += acc[i][j];
        if (MODE == PUT_MASK) dst[k] = mask[k] > 0.f ? acc[i][j] : 0.f;
      }
    }
  }
}

__device__ __forceinline__ void copy_tile(float* __restrict__ dst,
                                          const float* __restrict__ src, int HS) {
  for (int i = threadIdx.x; i < TILE_P * HS / 4; i += NTHREADS)
    reinterpret_cast<float4*>(dst)[i] = reinterpret_cast<const float4*>(src)[i];
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// C[m*ldc + n] (+)= sum_p A[p*as + m] * B[p*bs + n] for m < M, n < N, p over
// the tile: the block's partial gradient in device memory, read back unless
// this is the block's first tile. A, B in shared memory, rows padded to a
// multiple of 4 with finite values; C rows padded to ldc (a multiple of 4).
// Thread (ty, tx) of 16x16 owns rows m0+ty*8..+7 and columns
// n0+tx*4..+3, n0+64+tx*4..+3 of each 128x128 pass.
__device__ void outer_acc(float* __restrict__ C, int ldc, int M, int N,
                          const float* A, int as, const float* B, int bs,
                          bool first) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int m0 = 0; m0 < M; m0 += 128) {
    for (int n0 = 0; n0 < N; n0 += 128) {
      const int ma = m0 + ty * 8, na = n0 + tx * 4, nb = n0 + 64 + tx * 4;
      float acc[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 c0 = (!first && ma + i < M && na < N)
                              ? ld4(C + (size_t)(ma + i) * ldc + na) : zero;
        const float4 c1 = (!first && ma + i < M && nb < N)
                              ? ld4(C + (size_t)(ma + i) * ldc + nb) : zero;
        acc[i][0] = c0.x; acc[i][1] = c0.y; acc[i][2] = c0.z; acc[i][3] = c0.w;
        acc[i][4] = c1.x; acc[i][5] = c1.y; acc[i][6] = c1.z; acc[i][7] = c1.w;
      }
      if (ma < M) {
        for (int p = 0; p < TILE_P; ++p) {
          const float* Ap = A + p * as;
          const float* Bp = B + p * bs;
          const float4 a0 = ld4(Ap + ma);
          const float4 a1 = ma + 4 < M ? ld4(Ap + ma + 4) : zero;
          const float4 b0 = na < N ? ld4(Bp + na) : zero;
          const float4 b1 = nb < N ? ld4(Bp + nb) : zero;
          const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
          const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (ma + i >= M) continue;
        if (na < N)
          *reinterpret_cast<float4*>(C + (size_t)(ma + i) * ldc + na) =
              make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        if (nb < N)
          *reinterpret_cast<float4*>(C + (size_t)(ma + i) * ldc + nb) =
              make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
      }
    }
  }
}

// db[n] (+)= sum_p B[p*bs + n], n < N.
__device__ void bias_acc(float* __restrict__ db, int N, const float* B, int bs,
                         bool first) {
  for (int n = threadIdx.x; n < N; n += NTHREADS) {
    float s = 0.f;
    for (int p = 0; p < TILE_P; ++p) s += B[p * bs + n];
    db[n] = first ? s : db[n] + s;
  }
}

__global__ void __launch_bounds__(NTHREADS)
nerf_bwd_kernel(const NetDesc* __restrict__ gdesc, const BwdDesc* __restrict__ gbd,
                const float* __restrict__ wb, const float* __restrict__ wbt,
                const float* __restrict__ enc, const float* __restrict__ pts,
                const float* __restrict__ vd, const float* __restrict__ g, int C,
                float* __restrict__ dx, float* __restrict__ part,
                float* __restrict__ act, long long wsize, long long total, int S) {
  __shared__ NetDesc d;
  __shared__ BwdDesc bd;
  extern __shared__ float4 dyn[];
  load_desc(d, gdesc);
  {
    const long long* src = reinterpret_cast<const long long*>(gbd);
    long long* dst = reinterpret_cast<long long*>(&bd);
    for (int i = threadIdx.x; i < (int)(sizeof(BwdDesc) / 8); i += NTHREADS)
      dst[i] = src[i];
  }
  __syncthreads();
  const int D = (int)d.hdr[H_D], W = (int)d.hdr[H_W], P = (int)d.hdr[H_P];
  const int V = (int)d.hdr[H_V], P4 = (int)d.hdr[H_P4], HS = (int)d.hdr[H_HS];
  const int ES = P4 + (int)d.hdr[H_V4], OUT = (int)d.hdr[H_OUT];
  const bool views = d.hdr[H_VIEWDIRS] != 0;
  const unsigned long long skips = (unsigned long long)d.hdr[H_SKIPS];

  float* wt = reinterpret_cast<float*>(dyn);
  float* X = wt + KC_BWD * MAXW;      // running activation / gradient
  float* Y = X + TILE_P * HS;         // layer input, relu mask
  float* emb = Y + TILE_P * HS;
  float* demb = emb + TILE_P * ES;
  float* gr = demb + TILE_P * ES;     // cotangent tile [TILE_P][G_LD]
  for (int i = threadIdx.x; i < 2 * TILE_P * HS; i += NTHREADS) X[i] = 0.f;

  float* my_act = act + (size_t)blockIdx.x * (D + 2) * TILE_P * HS;
  float* my_part = part + (size_t)blockIdx.x * wsize;
  float acc[8][8];
  bool first = true;

  const long long n_tiles = (total + TILE_P - 1) / TILE_P;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long p0 = t * TILE_P;
    encode_points(d, enc, pts, vd, p0, total, S, emb, ES);
    for (int i = threadIdx.x; i < TILE_P * ES; i += NTHREADS) demb[i] = 0.f;
    for (int i = threadIdx.x; i < TILE_P * G_LD; i += NTHREADS) {
      const int p = i / G_LD, c = i % G_LD;
      const long long gp = p0 + p;
      float v = 0.f;
      if (gp < total) {
        if (views) {
          if (c < 4) v = g[gp * C + c];
          else if (c == 4) v = g[gp * C + 3];
        } else if (c < C) {
          v = g[gp * C + c];
        }
      }
      gr[i] = v;
    }
    __syncthreads();

    // ---- forward, each layer's output kept in the block's scratch ----
    for (int l = 0; l < D; ++l) {
      const long long* L = d.layer[l];
      const int ld = (int)L[M_LD];
      const float* Wl = wb + L[M_W];
      zero_acc(acc);
      if (l == 0) {
        gemm_acc<KC_BWD>(acc, emb, ES, P, Wl, ld, wt);
      } else {
        int koff = 0;
        if ((skips >> l) & 1ull) {
          gemm_acc<KC_BWD>(acc, emb, ES, P, Wl, ld, wt);
          koff = P;
        }
        gemm_acc<KC_BWD>(acc, X, HS, W, Wl + (size_t)koff * ld, ld, wt);
      }
      epilogue(acc, wb + L[M_B], W, true, X, HS);
      __syncthreads();
      copy_tile(my_act + (size_t)l * TILE_P * HS, X, HS);
    }
    if (views) {
      const long long* Hf = d.head[HEAD_FEATURE];
      zero_acc(acc);
      gemm_acc<KC_BWD>(acc, X, HS, W, wb + Hf[M_W], (int)Hf[M_LD], wt);
      epilogue(acc, wb + Hf[M_B], W, false, X, HS);
      __syncthreads();
      copy_tile(my_act + (size_t)D * TILE_P * HS, X, HS);
      const long long* Hv = d.head[HEAD_VIEWS];
      const int ldv = (int)Hv[M_LD];
      zero_acc(acc);
      gemm_acc<KC_BWD>(acc, X, HS, W, wb + Hv[M_W], ldv, wt);
      gemm_acc<KC_BWD>(acc, emb + P4, ES, V, wb + Hv[M_W] + (size_t)W * ldv, ldv, wt);
      epilogue(acc, wb + Hv[M_B], W / 2, true, X, HS);
      __syncthreads();
    }
    // X: hv (viewdirs) or the last trunk output
    copy_tile(Y, X, HS);
    __syncthreads();

    // ---- head ----
    if (views) {
      // rgb = hv @ Wrgb + b; dhv = (g_rgb Wrgb^T) * (hv > 0)
      const long long* Hr = d.head[HEAD_RGB];
      outer_acc(my_part + Hr[M_W], (int)Hr[M_LD], W / 2, 3, Y, HS, gr, G_LD, first);
      bias_acc(my_part + Hr[M_B], 3, gr, G_LD, first);
      zero_acc(acc);
      gemm_acc<KC_BWD>(acc, gr, G_LD, 3, wbt + bd.head[BW_RGB][0],
                       (int)bd.head[BW_RGB][1], wt);
      put<PUT_MASK>(acc, W / 2, X, HS, Y);
      __syncthreads();
      // hv = relu([feature, emb_dirs] @ Wv + b)
      copy_tile(Y, my_act + (size_t)D * TILE_P * HS, HS);
      __syncthreads();
      const long long* Hv = d.head[HEAD_VIEWS];
      const int ldv = (int)Hv[M_LD];
      outer_acc(my_part + Hv[M_W], ldv, W, W / 2, Y, HS, X, HS, first);
      outer_acc(my_part + Hv[M_W] + (size_t)W * ldv, ldv, V, W / 2, emb + P4, ES,
                X, HS, first);
      bias_acc(my_part + Hv[M_B], W / 2, X, HS, first);
      zero_acc(acc);
      gemm_acc<KC_BWD>(acc, X, HS, W / 2, wbt + bd.head[BW_VIEWS_D][0],
                       (int)bd.head[BW_VIEWS_D][1], wt);
      put<PUT_ADD>(acc, V, demb + P4, ES, nullptr);
      zero_acc(acc);
      gemm_acc<KC_BWD>(acc, X, HS, W / 2, wbt + bd.head[BW_VIEWS_F][0],
                       (int)bd.head[BW_VIEWS_F][1], wt);
      put<PUT_STORE>(acc, W, X, HS, nullptr);   // dfeature
      __syncthreads();
      // feature = h @ Wf + b and alpha = h @ Wa + b, h the last trunk output
      copy_tile(Y, my_act + (size_t)(D - 1) * TILE_P * HS, HS);
      __syncthreads();
      const long long* Hf = d.head[HEAD_FEATURE];
      const long long* Ha = d.head[HEAD_ALPHA];
      outer_acc(my_part + Hf[M_W], (int)Hf[M_LD], W, W, Y, HS, X, HS, first);
      bias_acc(my_part + Hf[M_B], W, X, HS, first);
      outer_acc(my_part + Ha[M_W], (int)Ha[M_LD], W, 1, Y, HS, gr + 4, G_LD, first);
      bias_acc(my_part + Ha[M_B], 1, gr + 4, G_LD, first);
      zero_acc(acc);
      gemm_acc<KC_BWD>(acc, X, HS, W, wbt + bd.head[BW_FEATURE][0],
                       (int)bd.head[BW_FEATURE][1], wt);
      gemm_acc<KC_BWD>(acc, gr + 4, G_LD, 1, wbt + bd.head[BW_ALPHA][0],
                       (int)bd.head[BW_ALPHA][1], wt);
      put<PUT_STORE>(acc, W, X, HS, nullptr);
      __syncthreads();
    } else {
      const long long* Ho = d.head[HEAD_OUTPUT];
      outer_acc(my_part + Ho[M_W], (int)Ho[M_LD], W, OUT, Y, HS, gr, G_LD, first);
      bias_acc(my_part + Ho[M_B], OUT, gr, G_LD, first);
      zero_acc(acc);
      gemm_acc<KC_BWD>(acc, gr, G_LD, OUT, wbt + bd.head[BW_OUTPUT][0],
                       (int)bd.head[BW_OUTPUT][1], wt);
      put<PUT_STORE>(acc, W, X, HS, nullptr);
      __syncthreads();
    }

    // ---- trunk: X = dh_l, Y = h_l ----
    for (int l = D - 1; l >= 0; --l) {
      const long long* L = d.layer[l];
      const int ld = (int)L[M_LD];
      for (int i = threadIdx.x; i < TILE_P * HS; i += NTHREADS)
        if (!(Y[i] > 0.f)) X[i] = 0.f;   // dz_l
      __syncthreads();
      bias_acc(my_part + L[M_B], W, X, HS, first);
      if (l > 0) {
        copy_tile(Y, my_act + (size_t)(l - 1) * TILE_P * HS, HS);
        __syncthreads();
      }
      const bool from_emb = l == 0 || ((skips >> l) & 1ull);
      if (from_emb) outer_acc(my_part + L[M_W], ld, P, W, emb, ES, X, HS, first);
      if (l > 0)
        outer_acc(my_part + L[M_W] + (size_t)(from_emb ? P : 0) * ld, ld, W, W,
                  Y, HS, X, HS, first);
      if (from_emb) {
        zero_acc(acc);
        gemm_acc<KC_BWD>(acc, X, HS, W, wbt + bd.seg[l][0][0], (int)bd.seg[l][0][1], wt);
        put<PUT_ADD>(acc, P, demb, ES, nullptr);
      }
      if (l > 0) {
        zero_acc(acc);
        gemm_acc<KC_BWD>(acc, X, HS, W, wbt + bd.seg[l][1][0], (int)bd.seg[l][1][1], wt);
        put<PUT_STORE>(acc, W, X, HS, nullptr);
      }
      __syncthreads();
    }

    // ---- encoder: dx ----
    for (int i = threadIdx.x; i < TILE_P * 6; i += NTHREADS) {
      const int p = i / 6, dim = i % 6;
      const long long gp = p0 + p;
      if (gp >= total) continue;
      float s = 0.f;
      if (dim < 3 || views) {
        const float x = dim < 3 ? pts[gp * 3 + dim] : vd[(gp / S) * 3 + (dim - 3)];
        for (int c = 0; c < ES; ++c) {
          const int cc = emb_col(d, c);
          if (cc < 0 || (int)enc[MAX_EMB + cc] != dim) continue;
          const int k = d.kind[cc];
          const float f = enc[cc];
          const float arg = __fmul_rn(f, x);
          const float der = k == 0 ? 1.f : (k == 1 ? f * cosf(arg) : -f * sinf(arg));
          s = fmaf(demb[p * ES + c], der, s);
        }
      }
      dx[gp * 6 + dim] = s;
    }
    __syncthreads();
    first = false;
  }
}

// out[i] = sum over blocks b, in order, of part[b * n + i]
__global__ void grad_reduce_kernel(const float* __restrict__ part, int G,
                                   long long n, float* __restrict__ out) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int b = 0; b < G; ++b) s += part[(size_t)b * n + i];
    out[i] = s;
  }
}

}  // namespace nstt

// grid: blocks of the main kernel (at most one per tile); part [grid][wsize]
// and act [grid][D + 2][TILE_P][HS] are the wrapper's scratch.
extern "C" int nstt_mlp_backward(const void* desc_dev, const void* bdesc_dev,
                                 int HS, int ES, const float* wb,
                                 const float* wbt, const float* enc,
                                 const float* pts, const float* vd,
                                 const float* g, int C, float* dx, float* part,
                                 float* act, float* grads, long long wsize,
                                 long long total, int S, int grid, void* stream) {
  using namespace nstt;
  const size_t bytes = bwd_smem_floats(HS, ES) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      nerf_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  nerf_bwd_kernel<<<grid, NTHREADS, bytes, (cudaStream_t)stream>>>(
      (const NetDesc*)desc_dev, (const BwdDesc*)bdesc_dev, wb, wbt, enc, pts, vd,
      g, C, dx, part, act, wsize, total, S);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long rblocks = (wsize + 255) / 256;
  grad_reduce_kernel<<<(unsigned)(rblocks < 4096 ? rblocks : 4096), 256, 0,
                       (cudaStream_t)stream>>>(part, grid, wsize, grads);
  return (int)cudaGetLastError();
}
