// The NeRF MLP on one tile of 64 sample points, shared by fused_mlp.cu (B1)
// and fused_mlp_bwd.cu (B2). B3 and B4 run mlp_tile_tc.cuh.
//
// A block of 256 threads owns one tile. The tile's encoded inputs (emb) and
// its activations (h) stay in shared memory from the first layer to the
// head; only the weights move, streamed from L2 / device memory KC rows at
// a time into a shared staging tile that all eight warps read. Each warp
// computes 8 points x 256 output columns of a layer: a thread holds an 8x8
// fp32 accumulator (points row0..row0+7, columns lane*4..lane*4+3 and
// 128+lane*4..128+lane*4+3), so every weight value read from shared memory
// feeds 8 FMAs and every activation value 8 more. fp32 on the CUDA cores:
// no TF32, no tensor cores.
//
// Layer widths up to MAXW = 256; the encoded input up to MAX_EMB columns.
// Weight matrices are packed [K][ld] (input-major, ld = N rounded up to 4),
// so the staging loads are 16-byte vectors.
#pragma once

#include <cuda_runtime.h>

namespace nstt {

constexpr int TILE_P = 64;      // points per tile
constexpr int MAXW = 256;       // widest layer
constexpr int KC = 32;          // weight rows staged per step
constexpr int NTHREADS = 256;   // 8 warps x 8 points
constexpr int MAX_LAYERS = 32;
constexpr int MAX_EMB = 256;
constexpr int RAW_LD = 8;       // raw outputs per point kept in shared memory

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

struct Smem {
  float* wt;    // [KC][MAXW]     staged weight rows
  float* h;     // [TILE_P][HS]   activations
  float* emb;   // [TILE_P][ES]   encoded input: pts block, then dirs block
  float* raw;   // [TILE_P][RAW_LD]
};

__host__ __device__ inline size_t smem_floats(int HS, int ES) {
  return (size_t)KC * MAXW + (size_t)TILE_P * HS + (size_t)TILE_P * ES
       + (size_t)TILE_P * RAW_LD;
}

__device__ inline Smem carve(float* base, int HS, int ES) {
  Smem s;
  s.wt = base;
  s.h = s.wt + KC * MAXW;
  s.emb = s.h + TILE_P * HS;
  s.raw = s.emb + TILE_P * ES;
  return s;
}

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

// Encoded input of compact column cc for depth zz on ray r: the pre-sine
// argument A + z*B, rounded exactly as f*(o + z*d) is for power-of-two f
// (no FMA contraction), then identity, sin or cos.
__device__ __forceinline__ float emb_value(const NetDesc& d,
                                           const float* __restrict__ A,
                                           const float* __restrict__ B,
                                           long long r, float zz, int cc) {
  const long long i = r * d.hdr[H_EMB] + cc;
  const float arg = __fadd_rn(__ldg(A + i), __fmul_rn(zz, __ldg(B + i)));
  const int k = d.kind[cc];
  return k == 0 ? arg : (k == 1 ? sinf(arg) : cosf(arg));
}

// Encoded inputs of the points p0 .. p0 + TILE_P - 1 into emb [TILE_P][ES]
// (point-major, B1 and B2): pts [total, 3], viewdirs [total / S, 3] shared
// by the S samples of a ray. enc holds, per compact column, its frequency
// (enc[cc]) and its input (enc[MAX_EMB + cc]: 0-2 point, 3-5 direction).
// The argument f*x is rounded once, as the plain embed's x * f is; points
// past total encode to zero.
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
    emb[i] = v;
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

// dst[(row0+i)*ds + col] = act(acc + bias) for col < N
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
        dst[(row0 + i) * ds + col] = v;
      }
    }
  }
}

// A narrow output layer (N <= RAW_LD): one warp per (point, output), the
// lanes split K and reduce with shuffles. Writes raw[p][col_off + o].
__device__ __forceinline__ void narrow(const float* src, int ss, int K,
                                       const float* __restrict__ Wg, int ld,
                                       const float* __restrict__ bias, int N,
                                       float* raw, int col_off) {
  const int lane = threadIdx.x & 31;
  for (int pair = threadIdx.x >> 5; pair < TILE_P * N; pair += NTHREADS / 32) {
    const int p = pair / N, o = pair % N;
    float s = 0.f;
    for (int k = lane; k < K; k += 32)
      s = fmaf(src[p * ss + k], __ldg(Wg + (size_t)k * ld + o), s);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) raw[p * RAW_LD + col_off + o] = s + __ldg(bias + o);
  }
}

// The whole network on the tile in s.emb -> s.raw (cols 0..2 rgb logits,
// col 3 sigma; or output_ch columns without viewdirs). Ends with a barrier.
__device__ inline void mlp_tile(const NetDesc& d, const float* __restrict__ wb,
                                const Smem& s) {
  const int D = (int)d.hdr[H_D], W = (int)d.hdr[H_W], P = (int)d.hdr[H_P];
  const int V = (int)d.hdr[H_V], P4 = (int)d.hdr[H_P4], HS = (int)d.hdr[H_HS];
  const int ES = P4 + (int)d.hdr[H_V4];
  const unsigned long long skips = (unsigned long long)d.hdr[H_SKIPS];
  float acc[8][8];

  for (int l = 0; l < D; ++l) {
    const long long* L = d.layer[l];
    const int ld = (int)L[M_LD];
    const float* Wl = wb + L[M_W];
    zero_acc(acc);
    if (l == 0) {
      gemm_acc(acc, s.emb, ES, P, Wl, ld, s.wt);
    } else {
      int koff = 0;
      if ((skips >> l) & 1ull) {   // input is [pts_emb, h]
        gemm_acc(acc, s.emb, ES, P, Wl, ld, s.wt);
        koff = P;
      }
      gemm_acc(acc, s.h, HS, W, Wl + (size_t)koff * ld, ld, s.wt);
    }
    epilogue(acc, wb + L[M_B], W, true, s.h, HS);
    __syncthreads();
  }

  if (d.hdr[H_VIEWDIRS]) {
    const long long* Ha = d.head[HEAD_ALPHA];
    narrow(s.h, HS, W, wb + Ha[M_W], (int)Ha[M_LD], wb + Ha[M_B], 1, s.raw, 3);
    const long long* Hf = d.head[HEAD_FEATURE];
    zero_acc(acc);
    gemm_acc(acc, s.h, HS, W, wb + Hf[M_W], (int)Hf[M_LD], s.wt);
    epilogue(acc, wb + Hf[M_B], W, false, s.h, HS);
    __syncthreads();
    const long long* Hv = d.head[HEAD_VIEWS];
    const int ldv = (int)Hv[M_LD];
    zero_acc(acc);
    gemm_acc(acc, s.h, HS, W, wb + Hv[M_W], ldv, s.wt);
    gemm_acc(acc, s.emb + P4, ES, V, wb + Hv[M_W] + (size_t)W * ldv, ldv, s.wt);
    epilogue(acc, wb + Hv[M_B], W / 2, true, s.h, HS);
    __syncthreads();
    const long long* Hr = d.head[HEAD_RGB];
    narrow(s.h, HS, W / 2, wb + Hr[M_W], (int)Hr[M_LD], wb + Hr[M_B], 3, s.raw, 0);
  } else {
    const long long* Ho = d.head[HEAD_OUTPUT];
    narrow(s.h, HS, W, wb + Ho[M_W], (int)Ho[M_LD], wb + Ho[M_B],
           (int)d.hdr[H_OUT], s.raw, 0);
  }
  __syncthreads();
}

}  // namespace nstt
