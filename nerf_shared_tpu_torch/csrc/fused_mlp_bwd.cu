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
// weight-gradient products H^T·dZ), ~3.6 MFLOP at the lego width.
//
// The TPU kernel runs its grid in order and carries the weight gradients
// in revisited VMEM blocks. Hopper's blocks run in no order and carry
// nothing, so B2 is two kernels and a reduction:
//
// 1. nerf_bwd_kernel, one persistent block per SM walking 64-point tiles
//    (TILE_P): the forward again and the input gradients through every
//    layer down to dx, fp32 on the CUDA cores through the 8x8-per-thread
//    register tile of mlp_tile.cuh (gemm_acc), two thirds of the FLOPs. A
//    tile's activations (~9.9 KB a point at the lego width) do not fit a
//    block's 227 KB of shared memory, which keeps two [64][256] buffers (X:
//    the running gradient, Y: the layer input or relu mask), the encoding
//    and its gradient, the cotangent tile and a 16-row weight staging tile
//    (~199 KB). Each weight matrix's layer input H and its post-mask
//    cotangent dZ go to two device buffers, one point-major segment per
//    activation (BwdDesc hseg / zseg; ops/cuda/fused_mlp_bwd.py act_layout,
//    ~19.8 KB a point); the backward reads each layer's input back from H.
//    Input-gradient products dZ·W use the weights in PyTorch's [out][in]
//    layout (a second packed copy, split at the skip and view-direction
//    concatenations). dx as the TPU kernel computes it
//    (fused_mlp_bwd.py:299-300): through identity columns 1, through
//    sin(f·x) f·cos(f·x), through cos(f·x) -f·sin(f·x), summed per input
//    coordinate.
// 2. nerf_dw_kernel: dW = H^T·dZ and db = sum dZ for every matrix, one
//    third of the FLOPs, as a GEMM over the points (K = up to 196,608). A
//    block owns one 128 x 128 output tile of one product over one range of
//    points (split K), streams H and dZ chunks of 32 points through a
//    three-stage cp.async ring in shared memory, and runs
//    mma.sync.m16n8k8 with tf32 operands in split fp32 (3xTF32: both
//    operands split in registers into big = tf32(x) and small = tf32(x -
//    big), small·big' + big·small' + big·big'). The tensor cores add into
//    their accumulator without rounding to nearest, which drifts toward
//    zero over a long sum, so each k8 step's three products are summed on
//    the tensor cores from zero and added to the fp32 accumulator on the
//    CUDA cores. The narrow heads (alpha, rgb, output: N <= 8) and the
//    bias sums run in fp32 on the CUDA cores in the same kernel. No
//    atomics: each range writes its own partial copy of the gradients.
// 3. grad_reduce_kernel sums the ranges' partials in a fixed order, so the
//    result is the same on every run.
//
// The 14.7 GB of per-block partial read-modify-write of the first design
// (one fp32 copy of all gradients per block, updated every tile) becomes
// ~7.8 GB of streaming writes and reads of H and dZ at 196,608 points.
//
// bf16 (nerf_bwd_bf16_kernel, nerf_dw_bf16_kernel; --precision bf16): the
// TPU kernel's bf16 instantiation (_make_bwd_kernel_closed with
// compute_dtype bfloat16, fused_mlp_bwd.py:176-300). The tile kernel keeps
// its fp32 CUDA-core arithmetic on bf16-rounded operands, which computes
// the JAX function (a product of two bf16 values is exact in fp32): the
// weights arrive rounded (ops/cuda/fused_mlp_bwd.py pack_forward /
// pack_backward), the encoding, every layer's output and the cotangent g
// are rounded as they are stored, and each dz (dhv, dfeature, dz_l) goes
// to the dZ buffer in fp32 and is then rounded in place (dz_c) before it
// enters dh = dz_c·Wᵀ. The ReLU masks read the bf16 activations. The dW
// kernel rounds dZ as it loads it and forms dW with one
// mma.sync.m16n8k16 bf16 product a 16-point step (each summed from zero
// and added in fp32), while its bias sums read the fp32 dZ (dbout the
// rounded g), as JAX's do. demb and dx stay fp32. Design bound: the tile
// kernel's FLOPs over the fp32 CUDA cores' 67 TFLOP/s plus dW's over the
// 989 TFLOP/s bf16 rate; all-bf16 bound: all FLOPs over 989 TFLOP/s.
#include "mlp_tile.cuh"

namespace nstt {

constexpr int KC_BWD = 16;   // weight rows staged per step (shared memory)
constexpr int G_LD = 8;      // cotangent tile row: rgb 0-2, alpha 3, alpha 4

// PyTorch-layout ([out][in]) weight segments for the input-gradient
// products: {float offset, row stride}; offset -1 where there is none.
enum { BW_ALPHA, BW_FEATURE, BW_VIEWS_F, BW_VIEWS_D, BW_RGB, BW_OUTPUT };
// Activation segments of the H and dZ buffers: {floats a point before the
// segment, row stride}; for n_pad points segment s starts at float
// n_pad * seg[s][0]. H: the embedding, h_l at 1 + l, the feature, hv;
// dZ: dz_l at l, dfeature, dhv, the cotangent tile.
constexpr int N_SEG = MAX_LAYERS + 3;
enum { HS_EMB = 0, HS_FEATURE = MAX_LAYERS + 1, HS_HV = MAX_LAYERS + 2 };
enum { ZS_DFEATURE = MAX_LAYERS, ZS_DHV = MAX_LAYERS + 1, ZS_GR = MAX_LAYERS + 2 };
struct BwdDesc {
  long long seg[MAX_LAYERS][2][2];   // layer l: [0] embedding part, [1] h part
  long long head[6][2];
  long long hseg[N_SEG][2];
  long long zseg[N_SEG][2];
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

// TILE_P rows of `cols` floats (a multiple of 4) from src (row stride ss)
// to dst (row stride ds); 16-byte aligned rows.
__device__ __forceinline__ void copy_rows(float* dst, int ds, const float* src,
                                          int ss, int cols) {
  const int q = cols / 4;
  for (int i = threadIdx.x; i < TILE_P * q; i += NTHREADS) {
    const int p = i / q, c = (i % q) * 4;
    *reinterpret_cast<float4*>(dst + (size_t)p * ds + c) =
        *reinterpret_cast<const float4*>(src + (size_t)p * ss + c);
  }
}

// copy_rows from src, then under kRound src's copied floats rounded to bf16
// in place, each by the thread that copied it (no barrier between)
template <bool kRound>
__device__ __forceinline__ void copy_rows_round(float* dst, int ds, float* src, int ss,
                                                int cols) {
  if (!kRound) {
    copy_rows(dst, ds, src, ss, cols);
    return;
  }
  const int q = cols / 4;
  for (int i = threadIdx.x; i < TILE_P * q; i += NTHREADS) {
    const int p = i / q, c = (i % q) * 4;
    float4* s4 = reinterpret_cast<float4*>(src + (size_t)p * ss + c);
    float4 v = *s4;
    *reinterpret_cast<float4*>(dst + (size_t)p * ds + c) = v;
    v.x = __bfloat162float(__float2bfloat16_rn(v.x));
    v.y = __bfloat162float(__float2bfloat16_rn(v.y));
    v.z = __bfloat162float(__float2bfloat16_rn(v.z));
    v.w = __bfloat162float(__float2bfloat16_rn(v.w));
    *s4 = v;
  }
}

// Row p0 of segment s of an H or dZ buffer.
__device__ __forceinline__ float* seg_rows(float* buf, const long long (&s)[2],
                                           long long n_pad, long long p0) {
  return buf + s[0] * n_pad + p0 * s[1];
}

template <bool kBf16>
__device__ inline void bwd_tiles(const NetDesc* __restrict__ gdesc,
                                 const BwdDesc* __restrict__ gbd,
                                 const float* __restrict__ wb, const float* __restrict__ wbt,
                                 const float* __restrict__ enc,
                                 const float* __restrict__ pts,
                                 const float* __restrict__ vd,
                                 const float* __restrict__ g, int C,
                                 float* __restrict__ dx, float* hbuf, float* zbuf,
                                 long long total, long long n_pad, int S) {
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
  const int W2S = (W / 2 + 3) / 4 * 4;
  const bool views = d.hdr[H_VIEWDIRS] != 0;
  const unsigned long long skips = (unsigned long long)d.hdr[H_SKIPS];

  float* wt = reinterpret_cast<float*>(dyn);
  float* X = wt + KC_BWD * MAXW;      // running activation / gradient
  float* Y = X + TILE_P * HS;         // layer input, relu mask
  float* emb = Y + TILE_P * HS;
  float* demb = emb + TILE_P * ES;
  float* gr = demb + TILE_P * ES;     // cotangent tile [TILE_P][G_LD]
  for (int i = threadIdx.x; i < 2 * TILE_P * HS; i += NTHREADS) X[i] = 0.f;

  float acc[8][8];
  const long long n_tiles = (total + TILE_P - 1) / TILE_P;
  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long p0 = t * TILE_P;
    // H or dZ rows of this tile in segment s
    auto hrows = [&](int s) { return seg_rows(hbuf, bd.hseg[s], n_pad, p0); };
    auto zrows = [&](int s) { return seg_rows(zbuf, bd.zseg[s], n_pad, p0); };
    encode_points<kBf16>(d, enc, pts, vd, p0, total, S, emb, ES);
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
      gr[i] = kBf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
    }
    __syncthreads();
    copy_rows(hrows(HS_EMB), ES, emb, ES, ES);
    copy_rows(zrows(ZS_GR), G_LD, gr, G_LD, G_LD);

    // ---- forward, each layer's output kept in H ----
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
      epilogue<kBf16>(acc, wb + L[M_B], W, true, X, HS);
      __syncthreads();
      copy_rows(hrows(1 + l), HS, X, HS, HS);
    }
    if (views) {
      const long long* Hf = d.head[HEAD_FEATURE];
      zero_acc(acc);
      gemm_acc<KC_BWD>(acc, X, HS, W, wb + Hf[M_W], (int)Hf[M_LD], wt);
      epilogue<kBf16>(acc, wb + Hf[M_B], W, false, X, HS);
      __syncthreads();
      copy_rows(hrows(HS_FEATURE), HS, X, HS, HS);
      const long long* Hv = d.head[HEAD_VIEWS];
      const int ldv = (int)Hv[M_LD];
      zero_acc(acc);
      gemm_acc<KC_BWD>(acc, X, HS, W, wb + Hv[M_W], ldv, wt);
      gemm_acc<KC_BWD>(acc, emb + P4, ES, V, wb + Hv[M_W] + (size_t)W * ldv, ldv, wt);
      epilogue<kBf16>(acc, wb + Hv[M_B], W / 2, true, X, HS);
      __syncthreads();
      copy_rows(hrows(HS_HV), W2S, X, HS, W2S);
    }
    // X: hv (viewdirs) or the last trunk output
    copy_rows(Y, HS, X, HS, HS);
    __syncthreads();

    // ---- head ----
    if (views) {
      // rgb = hv @ Wrgb + b; dhv = (g_rgb Wrgb^T) * (hv > 0)
      zero_acc(acc);
      gemm_acc<KC_BWD>(acc, gr, G_LD, 3, wbt + bd.head[BW_RGB][0],
                       (int)bd.head[BW_RGB][1], wt);
      put<PUT_MASK>(acc, W / 2, X, HS, Y);
      __syncthreads();
      copy_rows_round<kBf16>(zrows(ZS_DHV), W2S, X, HS, W2S);   // dhv, then dhv_c
      // hv = relu([feature, emb_dirs] @ Wv + b)
      zero_acc(acc);
      gemm_acc<KC_BWD>(acc, X, HS, W / 2, wbt + bd.head[BW_VIEWS_D][0],
                       (int)bd.head[BW_VIEWS_D][1], wt);
      put<PUT_ADD>(acc, V, demb + P4, ES, nullptr);
      zero_acc(acc);
      gemm_acc<KC_BWD>(acc, X, HS, W / 2, wbt + bd.head[BW_VIEWS_F][0],
                       (int)bd.head[BW_VIEWS_F][1], wt);
      put<PUT_STORE>(acc, W, X, HS, nullptr);   // dfeature
      __syncthreads();
      copy_rows_round<kBf16>(zrows(ZS_DFEATURE), HS, X, HS, HS);   // then dfeature_c
      // feature = h @ Wf + b and alpha = h @ Wa + b, h the last trunk output
      copy_rows(Y, HS, hrows(D), HS, HS);
      __syncthreads();
      zero_acc(acc);
      gemm_acc<KC_BWD>(acc, X, HS, W, wbt + bd.head[BW_FEATURE][0],
                       (int)bd.head[BW_FEATURE][1], wt);
      gemm_acc<KC_BWD>(acc, gr + 4, G_LD, 1, wbt + bd.head[BW_ALPHA][0],
                       (int)bd.head[BW_ALPHA][1], wt);
      put<PUT_STORE>(acc, W, X, HS, nullptr);
      __syncthreads();
    } else {
      zero_acc(acc);
      gemm_acc<KC_BWD>(acc, gr, G_LD, OUT, wbt + bd.head[BW_OUTPUT][0],
                       (int)bd.head[BW_OUTPUT][1], wt);
      put<PUT_STORE>(acc, W, X, HS, nullptr);
      __syncthreads();
    }

    // ---- trunk: X = dh_l, Y = h_l ----
    for (int l = D - 1; l >= 0; --l) {
      for (int i = threadIdx.x; i < TILE_P * HS; i += NTHREADS)
        if (!(Y[i] > 0.f)) X[i] = 0.f;   // dz_l
      __syncthreads();
      copy_rows_round<kBf16>(zrows(l), HS, X, HS, HS);   // dz_l, then dz_c
      if (l > 0) {
        copy_rows(Y, HS, hrows(l), HS, HS);   // h_{l-1}
        __syncthreads();
      }
      const bool from_emb = l == 0 || ((skips >> l) & 1ull);
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
  }
}

__global__ void __launch_bounds__(NTHREADS)
nerf_bwd_kernel(const NetDesc* __restrict__ gdesc, const BwdDesc* __restrict__ gbd,
                const float* __restrict__ wb, const float* __restrict__ wbt,
                const float* __restrict__ enc, const float* __restrict__ pts,
                const float* __restrict__ vd, const float* __restrict__ g, int C,
                float* __restrict__ dx, float* hbuf, float* zbuf, long long total,
                long long n_pad, int S) {
  bwd_tiles<false>(gdesc, gbd, wb, wbt, enc, pts, vd, g, C, dx, hbuf, zbuf, total, n_pad, S);
}

__global__ void __launch_bounds__(NTHREADS)
nerf_bwd_bf16_kernel(const NetDesc* __restrict__ gdesc, const BwdDesc* __restrict__ gbd,
                     const float* __restrict__ wb, const float* __restrict__ wbt,
                     const float* __restrict__ enc, const float* __restrict__ pts,
                     const float* __restrict__ vd, const float* __restrict__ g, int C,
                     float* __restrict__ dx, float* hbuf, float* zbuf, long long total,
                     long long n_pad, int S) {
  bwd_tiles<true>(gdesc, gbd, wb, wbt, enc, pts, vd, g, C, dx, hbuf, zbuf, total, n_pad, S);
}

// ---- nerf_dw_kernel ---------------------------------------------------------

constexpr int DW_BM = 128;       // output tile rows (of a product's input width)
constexpr int DW_BN = 128;       // output tile columns (of its output width)
constexpr int DW_KC = 32;        // points a staged chunk
constexpr int DW_STAGES = 3;     // chunks in flight
constexpr int DW_LD = DW_BM + 8; // staged row stride: 8 mod 32 floats, so the
                                 // fragment loads of a warp hit 32 banks
// ops/cuda/fused_mlp_bwd.py dw_jobs / dw_tiles: a product's fields and an
// output tile's
enum { J_KIND, J_HSLOT, J_HCOL, J_M, J_ZSLOT, J_ZCOL, J_N, J_W, J_LD, J_B, J_WORDS };
enum { T_JOB, T_M0, T_N0, T_WORDS };
enum { DW_WIDE, DW_NARROW };

// x rounded to tf32 (10 mantissa bits) to nearest, ties away from zero:
// cvt.rna.tf32.f32 for finite x, whose carry out of bit 12 rounds the
// magnitude. Two integer operations; cvt.rna compiles to four here (it
// tests for NaN first), and splitting is most of the kernel's ALU work.
__device__ __forceinline__ unsigned tf32_bits(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small (+ ~2^-22 |x|), both tf32
__device__ __forceinline__ void split_tf32(float x, unsigned& big, unsigned& small) {
  big = tf32_bits(x);
  small = tf32_bits(x - __uint_as_float(big));
}

// d = a (16 x 8, row) * b (8 x 8, col) + c on the tensor cores, tf32 in,
// fp32 out
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2], const float (&c)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

// d = a (16 x 16, row) * b (16 x 8, col) + c on the tensor cores, bf16 in
// (bf16x2 pairs, the lower k in the low half), fp32 out
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2], const float (&c)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

// (lo, hi) rounded to bf16 (to nearest, ties to even) in one register, lo
// in the low half
__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  unsigned r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// 16 bytes global -> shared, asynchronously; bytes 0 fills zeros
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Chunk rows k0 .. k0 + DW_KC of `cols` floats (a multiple of 4, at most
// 128) from src (row stride ld) into dst (row stride DW_LD); rows at or
// past total are zero. Thread t copies 16 bytes at column 4 (t % 32) of
// rows t / 32 + 8 i: no division in the loop.
static_assert(DW_BM == 128 && DW_BN == 128 && NTHREADS == 256 && DW_KC % 8 == 0,
              "stage_chunk's thread map");
__device__ __forceinline__ void stage_chunk(float* dst, const float* src, long long ld,
                                            int cols, long long k0, long long total) {
  const int c = (threadIdx.x & 31) * 4;
  if (c >= cols) return;
#pragma unroll
  for (int i = 0; i < DW_KC / 8; ++i) {
    const int r = (threadIdx.x >> 5) + 8 * i;
    const long long k = k0 + r;
    const bool in = k < total;
    cp_async16(dst + r * DW_LD + c, in ? src + k * ld + c : src, in ? 16 : 0);
  }
}

// dW_j[m][n] = sum_p H[p][hcol + m] dZ[p][zcol + n] and db_j[n] = sum_p
// dZ[p][zcol + n] over the points of range blockIdx.y, for the output tile
// blockIdx.x, into part + blockIdx.y * wsize (the packed gradient layout;
// the tile's padding columns of the row stride written as zero). Wide
// products: 8 warps as 4 (rows) x 2 (columns), a warp 32 x 64 of the tile
// as 2 x 8 m16n8 fragments, split fp32 on mma.sync, each k8 step's three
// products summed from zero and added in fp32. Narrow products (N <= 8):
// a thread a row, fp32 fma in point order. Bias sums: a thread a column,
// in point order. kBf16: the wide products as one bf16 MMA (m16n8k16) a
// 16-point step, H and dZ rounded to bf16 as the fragments are formed.
template <bool kBf16>
__device__ inline void dw_tiles(const BwdDesc* __restrict__ gbd,
                                const long long* __restrict__ jobs,
                                const long long* __restrict__ tiles,
                                const float* __restrict__ hbuf,
                                const float* __restrict__ zbuf, float* __restrict__ part,
                                long long wsize, long long total, long long n_pad) {
  extern __shared__ float4 dyn[];
  float* Hs = reinterpret_cast<float*>(dyn);            // [STAGES][KC][LD]
  float* Zs = Hs + DW_STAGES * DW_KC * DW_LD;           // [STAGES][KC][LD]
  const long long* T = tiles + (size_t)blockIdx.x * T_WORDS;
  const long long* J = jobs + (size_t)T[T_JOB] * J_WORDS;
  const int m0 = (int)T[T_M0], n0 = (int)T[T_N0];
  const bool wide = J[J_KIND] == DW_WIDE;
  const int M = (int)J[J_M], N = (int)J[J_N], zcol = (int)J[J_ZCOL];
  const int ldg = (int)J[J_LD];
  const long long b_off = m0 == 0 ? J[J_B] : -1;
  const int hslot = (int)J[J_HSLOT], zslot = (int)J[J_ZSLOT];
  const long long hld = gbd->hseg[hslot][1], zld = gbd->zseg[zslot][1];
  const float* hsrc = hbuf + gbd->hseg[hslot][0] * n_pad + J[J_HCOL] + m0;
  // wide: the tile's dZ columns; narrow: the whole cotangent row
  const float* zsrc = zbuf + gbd->zseg[zslot][0] * n_pad + (wide ? zcol + n0 : 0);
  const int hcols = min(DW_BM, (M + 3) / 4 * 4 - m0);
  const int zcols = wide ? min(DW_BN, (N + 3) / 4 * 4 - n0) : (int)zld;
  const int bn = wide ? min(DW_BN, N - n0) : N;   // this tile's columns

  // this range's chunks (ops/cuda/fused_mlp_bwd.py split_ranges)
  const long long n_chunks_all = n_pad / DW_KC;
  const long long c_begin = blockIdx.y * n_chunks_all / gridDim.y;
  const long long c_end = (blockIdx.y + 1) * n_chunks_all / gridDim.y;
  const int n_chunks = (int)(c_end - c_begin);

  // columns never staged stay zero
  for (int i = threadIdx.x; i < 2 * DW_STAGES * DW_KC * DW_LD; i += NTHREADS) Hs[i] = 0.f;
  __syncthreads();

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 64;
  // a warp whose 32 x 64 block lies past the product's rows or columns
  // (the embedding products' M of 3-93, views' N of 128) skips the MMAs
  const bool warp_on = m0 + wm < M && n0 + wn < N;
  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
  float bsum = 0.f;
  // narrow: thread tid < DW_BM owns row m0 + tid; bias: thread tid owns
  // column tid (wide) or, for a narrow product, thread DW_BM + c column c
  const int bcol = wide ? tid : tid - DW_BM;
  const bool does_bias = b_off >= 0 && bcol >= 0 && bcol < bn;

  auto stage = [&](int c) {
    const long long k0 = (c_begin + c) * DW_KC;
    const int st = c % DW_STAGES;
    stage_chunk(Hs + st * DW_KC * DW_LD, hsrc, hld, hcols, k0, total);
    stage_chunk(Zs + st * DW_KC * DW_LD, zsrc, zld, zcols, k0, total);
  };
#pragma unroll
  for (int c = 0; c < DW_STAGES - 1; ++c) {
    if (c < n_chunks) stage(c);
    cp_async_commit();
  }
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<DW_STAGES - 2>();
    __syncthreads();
    if (c + DW_STAGES - 1 < n_chunks) stage(c + DW_STAGES - 1);
    cp_async_commit();
    const float* hk = Hs + (c % DW_STAGES) * DW_KC * DW_LD;
    const float* zk = Zs + (c % DW_STAGES) * DW_KC * DW_LD;
    if (does_bias) {
      const int zc = wide ? bcol : zcol + bcol;
      for (int r = 0; r < DW_KC; ++r) bsum += zk[r * DW_LD + zc];
    }
    if (kBf16 && wide && warp_on) {
#pragma unroll
      for (int ks = 0; ks < DW_KC; ks += 16) {
        // A = H^T (m16 x k16): a0 (m g, k 2tg, +1), a1 (g + 8, ..), a2 (g,
        // 2tg + 8, +9), a3 (g + 8, ..); B = dZ (k16 x n8): b0 (k 2tg, +1,
        // n g), b1 (k 2tg + 8, +9, n g)
        const float* h0 = hk + (ks + 2 * tg) * DW_LD;
        const float* h8 = h0 + 8 * DW_LD;
        unsigned a[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = wm + i * 16 + g;
          a[i][0] = pack_bf16x2(h0[r], h0[DW_LD + r]);
          a[i][1] = pack_bf16x2(h0[r + 8], h0[DW_LD + r + 8]);
          a[i][2] = pack_bf16x2(h8[r], h8[DW_LD + r]);
          a[i][3] = pack_bf16x2(h8[r + 8], h8[DW_LD + r + 8]);
        }
        const float* z0 = zk + (ks + 2 * tg) * DW_LD;
        const float* z8 = z0 + 8 * DW_LD;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = wn + j * 8 + g;
          const unsigned b[2] = {pack_bf16x2(z0[col], z0[DW_LD + col]),
                                 pack_bf16x2(z8[col], z8[DW_LD + col])};
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float zero[4] = {0.f, 0.f, 0.f, 0.f};
            float s[4];
            mma_bf16(s, a[i], b, zero);
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[i][j][q] += s[q];
          }
        }
      }
    } else if (wide && warp_on) {
#pragma unroll
      for (int ks = 0; ks < DW_KC; ks += 8) {
        // A = H^T (m16 x k8): a0 (m g, k tg), a1 (g + 8, tg), a2 (g, tg + 4),
        // a3 (g + 8, tg + 4); B = dZ (k8 x n8): b0 (k tg, n g), b1 (tg + 4, g)
        const float* h0 = hk + (ks + tg) * DW_LD;
        const float* h4 = h0 + 4 * DW_LD;
        unsigned ab[2][4], as[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = wm + i * 16 + g;
          split_tf32(h0[r], ab[i][0], as[i][0]);
          split_tf32(h0[r + 8], ab[i][1], as[i][1]);
          split_tf32(h4[r], ab[i][2], as[i][2]);
          split_tf32(h4[r + 8], ab[i][3], as[i][3]);
        }
        const float* z0 = zk + (ks + tg) * DW_LD;
        const float* z4 = z0 + 4 * DW_LD;
        // no branch inside: columns and rows past the product's are zero
        // in shared memory or not stored, and ptxas interleaves the 16
        // independent three-MMA chains
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = wn + j * 8 + g;
          unsigned bb[2], bs[2];
          split_tf32(z0[col], bb[0], bs[0]);
          split_tf32(z4[col], bb[1], bs[1]);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float zero[4] = {0.f, 0.f, 0.f, 0.f};
            float s[4];
            mma_tf32(s, as[i], bb, zero);
            mma_tf32(s, ab[i], bs, s);
            mma_tf32(s, ab[i], bb, s);
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[i][j][q] += s[q];
          }
        }
      }
    } else if (tid < DW_BM && m0 + tid < M) {
      for (int r = 0; r < DW_KC; ++r) {
        const float h = hk[r * DW_LD + tid];
        const float* z = zk + r * DW_LD + zcol;
#pragma unroll
        for (int q = 0; q < 8; ++q)
          if (q < N) acc[0][q >> 2][q & 3] = fmaf(h, z[q], acc[0][q >> 2][q & 3]);
      }
    }
  }
  cp_async_wait<0>();

  // ---- epilogue: this range's partial gradients ----
  float* out = part + (size_t)blockIdx.y * wsize;
  float* dw = out + J[J_W];
  const int n_end = min(ldg, n0 + (wide ? DW_BN : ldg));   // columns of this tile
  if (wide) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int m = m0 + wm + i * 16 + g + (q >> 1) * 8;
          const int n = n0 + wn + j * 8 + 2 * tg + (q & 1);
          if (m < M && n < n_end) dw[(size_t)m * ldg + n] = n < N ? acc[i][j][q] : 0.f;
        }
      }
    }
  } else if (tid < DW_BM && m0 + tid < M) {
#pragma unroll
    for (int q = 0; q < 8; ++q)
      if (q < ldg) dw[(size_t)(m0 + tid) * ldg + q] = q < N ? acc[0][q >> 2][q & 3] : 0.f;
  }
  if (b_off >= 0) {
    const int c = wide ? tid : tid - DW_BM;
    if (c >= 0 && n0 + c < n_end) out[b_off + n0 + c] = c < bn ? bsum : 0.f;
  }
}

__global__ void __launch_bounds__(NTHREADS, 2)
nerf_dw_kernel(const BwdDesc* __restrict__ gbd, const long long* __restrict__ jobs,
               const long long* __restrict__ tiles, const float* __restrict__ hbuf,
               const float* __restrict__ zbuf, float* __restrict__ part,
               long long wsize, long long total, long long n_pad) {
  dw_tiles<false>(gbd, jobs, tiles, hbuf, zbuf, part, wsize, total, n_pad);
}

__global__ void __launch_bounds__(NTHREADS, 2)
nerf_dw_bf16_kernel(const BwdDesc* __restrict__ gbd, const long long* __restrict__ jobs,
                    const long long* __restrict__ tiles, const float* __restrict__ hbuf,
                    const float* __restrict__ zbuf, float* __restrict__ part,
                    long long wsize, long long total, long long n_pad) {
  dw_tiles<true>(gbd, jobs, tiles, hbuf, zbuf, part, wsize, total, n_pad);
}

// out[i] = sum over ranges b, in order, of part[b * n + i]
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

using BwdKernel = void (*)(const nstt::NetDesc*, const nstt::BwdDesc*, const float*,
                           const float*, const float*, const float*, const float*,
                           const float*, int, float*, float*, float*, long long, long long,
                           int);
using DwKernel = void (*)(const nstt::BwdDesc*, const long long*, const long long*,
                          const float*, const float*, float*, long long, long long,
                          long long);

static int mlp_backward(BwdKernel bwd_kernel, DwKernel dw_kernel, const void* desc_dev,
                        const void* bdesc_dev, int HS, int ES, const float* wb,
                        const float* wbt, const float* enc, const float* pts,
                        const float* vd, const float* g, int C, float* dx, float* hbuf,
                        float* zbuf, int n_dw_tiles, const long long* jobs,
                        const long long* tiles, float* part, float* grads,
                        long long wsize, long long total, long long n_pad, int S,
                        int grid, int splits, void* stream) {
  using namespace nstt;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t bytes = bwd_smem_floats(HS, ES) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      (const void*)bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  bwd_kernel<<<grid, NTHREADS, bytes, st>>>(
      (const NetDesc*)desc_dev, (const BwdDesc*)bdesc_dev, wb, wbt, enc, pts, vd,
      g, C, dx, hbuf, zbuf, total, n_pad, S);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t dw_bytes = 2 * (size_t)DW_STAGES * DW_KC * DW_LD * sizeof(float);
  e = cudaFuncSetAttribute((const void*)dw_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dw_bytes);
  if (e != cudaSuccess) return (int)e;
  dw_kernel<<<dim3((unsigned)n_dw_tiles, (unsigned)splits), NTHREADS, dw_bytes, st>>>(
      (const BwdDesc*)bdesc_dev, jobs, tiles, hbuf, zbuf, part, wsize, total, n_pad);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long rblocks = (wsize + 255) / 256;
  grad_reduce_kernel<<<(unsigned)(rblocks < 4096 ? rblocks : 4096), 256, 0, st>>>(
      part, splits, wsize, grads);
  return (int)cudaGetLastError();
}

// grid: blocks of the tile kernel (at most one per 64-point tile); hbuf,
// zbuf: H and dZ for n_pad points (act_layout); jobs [n_jobs][J_WORDS] and
// tiles [n_dw_tiles][T_WORDS] of nerf_dw_kernel, run over `splits` point
// ranges into part [splits][wsize]; grads [wsize] their fixed-order sum.
extern "C" int nstt_mlp_backward(const void* desc_dev, const void* bdesc_dev,
                                 int HS, int ES, const float* wb,
                                 const float* wbt, const float* enc,
                                 const float* pts, const float* vd,
                                 const float* g, int C, float* dx, float* hbuf,
                                 float* zbuf, int n_dw_tiles, const long long* jobs,
                                 const long long* tiles, float* part, float* grads,
                                 long long wsize, long long total, long long n_pad,
                                 int S, int grid, int splits, void* stream) {
  return mlp_backward(nstt::nerf_bwd_kernel, nstt::nerf_dw_kernel, desc_dev, bdesc_dev, HS,
                      ES, wb, wbt, enc, pts, vd, g, C, dx, hbuf, zbuf, n_dw_tiles, jobs,
                      tiles, part, grads, wsize, total, n_pad, S, grid, splits, stream);
}

// B2 in bf16: the same arguments, the weights rounded by the wrapper
extern "C" int nstt_mlp_backward_bf16(const void* desc_dev, const void* bdesc_dev,
                                      int HS, int ES, const float* wb,
                                      const float* wbt, const float* enc,
                                      const float* pts, const float* vd,
                                      const float* g, int C, float* dx, float* hbuf,
                                      float* zbuf, int n_dw_tiles, const long long* jobs,
                                      const long long* tiles, float* part, float* grads,
                                      long long wsize, long long total, long long n_pad,
                                      int S, int grid, int splits, void* stream) {
  return mlp_backward(nstt::nerf_bwd_bf16_kernel, nstt::nerf_dw_bf16_kernel, desc_dev,
                      bdesc_dev, HS, ES, wb, wbt, enc, pts, vd, g, C, dx, hbuf, zbuf,
                      n_dw_tiles, jobs, tiles, part, grads, wsize, total, n_pad, S, grid,
                      splits, stream);
}
