// The pieces of the fp32 CUDA-core tile of 64 sample points that the MLP
// backward (fused_mlp_bwd.cu, B2) is built from: the descriptor of
// pack_network's layout, the point-major encoder, and a GEMM with its
// epilogue. The forward kernels B1, B3 and B4 run mlp_tile_tc.cuh.
//
// A block of 256 threads owns one tile. The tile's encoded inputs (emb) and
// its activations stay in shared memory; only the weights move, streamed
// from L2 / device memory KC rows at a time into a shared staging tile that
// all eight warps read. Each warp computes 8 points x 256 output columns
// of a layer: a thread holds an 8x8 fp32 accumulator (points
// row0..row0+7, columns lane*4..lane*4+3 and 128+lane*4..128+lane*4+3), so
// every weight value read from shared memory feeds 8 FMAs and every
// activation value 8 more. fp32 on the CUDA cores: no TF32, no tensor
// cores.
//
// Layer widths up to MAXW = 256; the encoded input up to MAX_EMB columns.
// Weight matrices are packed [K][ld] (input-major, ld = N rounded up to 4),
// so the staging loads are 16-byte vectors.
//
// B2's bf16 instantiation runs the same arithmetic on bf16-valued operands:
// the weights arrive rounded, and kRound rounds the encoder's output and
// each layer's output to bf16 as they are stored.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace nstt {

constexpr int TILE_P = 64;      // points per tile
constexpr int MAXW = 256;       // widest layer
constexpr int KC = 32;          // weight rows staged per step
constexpr int NTHREADS = 256;   // 8 warps x 8 points
constexpr int MAX_LAYERS = 32;
constexpr int MAX_EMB = 256;

// hdr[] indices
enum { H_D, H_W, H_P, H_V, H_EMB, H_OUT, H_VIEWDIRS, H_P4, H_V4, H_SKIPS, H_HS };
// per-matrix fields: float offsets of weight and bias, rows K, row stride ld
enum { M_W, M_B, M_K, M_LD };
enum { HEAD_ALPHA, HEAD_FEATURE, HEAD_VIEWS, HEAD_RGB, HEAD_OUTPUT };

// The network's layout, built by the Python wrapper (ops/cuda/fused_mlp.py
// pack_network) as int64 words and copied into shared memory per block.
struct NetDesc {
  long long hdr[16];
  long long layer[MAX_LAYERS][4];
  long long head[5][4];
  signed char kind[MAX_EMB];    // per embedding column: 0 identity, 1 sin, 2 cos
};

__device__ inline void load_desc(NetDesc& d, const NetDesc* __restrict__ g) {
  const long long* src = reinterpret_cast<const long long*>(g);
  long long* dst = reinterpret_cast<long long*>(&d);
  for (int i = threadIdx.x; i < (int)(sizeof(NetDesc) / 8); i += NTHREADS)
    dst[i] = src[i];
}

// shared-memory embedding column -> compact column of A/B (-1: padding)
__device__ __forceinline__ int emb_col(const NetDesc& d, int c) {
  const int P = (int)d.hdr[H_P], P4 = (int)d.hdr[H_P4], V = (int)d.hdr[H_V];
  if (c < P4) return c < P ? c : -1;
  c -= P4;
  return c < V ? P + c : -1;
}

// Encoded inputs of the points p0 .. p0 + TILE_P - 1 into emb [TILE_P][ES]
// (point-major): pts [total, 3], viewdirs [total / S, 3] shared
// by the S samples of a ray. enc holds, per compact column, its frequency
// (enc[cc]) and its input (enc[MAX_EMB + cc]: 0-2 point, 3-5 direction).
// The argument f*x is rounded once, as the plain embed's x * f is; points
// past total encode to zero. kRound: each value rounded to bf16.
template <bool kRound = false>
__device__ inline void encode_points(const NetDesc& d, const float* __restrict__ enc,
                                     const float* __restrict__ pts,
                                     const float* __restrict__ vd, long long p0,
                                     long long total, int S, float* emb, int ES) {
  for (int i = threadIdx.x; i < TILE_P * ES; i += NTHREADS) {
    const int p = i / ES, cc = emb_col(d, i % ES);
    const long long gp = p0 + p;
    float v = 0.f;
    if (cc >= 0 && gp < total) {
      const int src = (int)__ldg(enc + MAX_EMB + cc);
      const float x = src < 3 ? __ldg(pts + gp * 3 + src)
                              : __ldg(vd + (gp / S) * 3 + (src - 3));
      const int k = d.kind[cc];
      const float arg = __fmul_rn(__ldg(enc + cc), x);
      v = k == 0 ? x : (k == 1 ? sinf(arg) : cosf(arg));
    }
    emb[i] = kRound ? __bfloat162float(__float2bfloat16_rn(v)) : v;
  }
}

__device__ __forceinline__ int acc_col(int lane, int j) {
  return j < 4 ? lane * 4 + j : 128 + lane * 4 + (j - 4);
}

__device__ __forceinline__ void zero_acc(float (&acc)[8][8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
}

// acc[i][j] += sum_k src[(row0+i)*ss + k] * Wg[k*ld + col_j], k < K.
// src columns up to K rounded up to 4 must be finite (they meet zero
// weight rows). KCT weight rows are staged at a time through wt
// [KCT][MAXW]. Ends with a barrier: src may be overwritten afterwards.
template <int KCT = KC>
__device__ __forceinline__ void gemm_acc(float (&acc)[8][8],
                                         const float* src, int ss, int K,
                                         const float* __restrict__ Wg, int ld,
                                         float* wt) {
  const int tid = threadIdx.x, lane = tid & 31, row0 = (tid >> 5) * 8;
  for (int k0 = 0; k0 < K; k0 += KCT) {
    for (int idx = tid; idx < KCT * (MAXW / 4); idx += NTHREADS) {
      const int r = idx / (MAXW / 4), c = (idx % (MAXW / 4)) * 4;
      const int k = k0 + r;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k < K && c < ld)
        v = __ldg(reinterpret_cast<const float4*>(Wg + (size_t)k * ld + c));
      *reinterpret_cast<float4*>(wt + r * MAXW + c) = v;
    }
    __syncthreads();
    const int kn = min(KCT, K - k0);
    for (int kk = 0; kk < kn; kk += 4) {
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(src + (row0 + i) * ss + k0 + kk);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 b0 = *reinterpret_cast<const float4*>(wt + (kk + q) * MAXW + lane * 4);
        const float4 b1 = *reinterpret_cast<const float4*>(wt + (kk + q) * MAXW + 128 + lane * 4);
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float av = q == 0 ? a[i].x : q == 1 ? a[i].y : q == 2 ? a[i].z : a[i].w;
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av, b[j], acc[i][j]);
        }
      }
    }
    __syncthreads();
  }
}

// dst[(row0+i)*ds + col] = act(acc + bias) for col < N; kRound: rounded
// to bf16
template <bool kRound = false>
__device__ __forceinline__ void epilogue(const float (&acc)[8][8],
                                         const float* __restrict__ bias, int N,
                                         bool relu, float* dst, int ds) {
  const int lane = threadIdx.x & 31, row0 = (threadIdx.x >> 5) * 8;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = acc_col(lane, j);
    if (col < N) {
      const float bj = __ldg(bias + col);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float v = acc[i][j] + bj;
        if (relu) v = fmaxf(v, 0.f);
        dst[(row0 + i) * ds + col] = kRound ? __bfloat162float(__float2bfloat16_rn(v)) : v;
      }
    }
  }
}

}  // namespace nstt
