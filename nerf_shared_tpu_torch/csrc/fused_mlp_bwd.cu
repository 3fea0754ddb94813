// Fused backward of the NeRF MLP (kernel B2): every parameter gradient and
// the input gradient of the points, from the layer inputs that B1's
// training launch wrote.
//
// Replaces the TPU kernel nerf_shared_tpu/ops/pallas/fused_mlp_bwd.py
// _make_bwd_kernel_closed (launched by fused_mlp_backward; paired with B1 as
// fused_train_op, the backward of every training step). Input: points
// [N, 3], per-ray view directions [N / S, 3], the cotangent of the raw
// outputs g [N, C] and the H buffer (below) of the same points. Output:
// the gradient of every weight and bias, in the packed [in][ld] layout of
// ops/cuda/fused_mlp.py packed_layout, and dx [N, 6] (d/dpts, d/ddirs per
// point).
//
// What bounds it on an H100: operations. A point costs about two forward
// passes (the input gradients through every layer, the weight-gradient
// products H^T·dZ), ~2.4 MFLOP at the lego width.
//
// The data flow. B1's training launch (fused_mlp.cu nerf_points_tc_kernel
// <true>, under autograd: ops/cuda/fused_mlp_bwd.py fused_train_op) writes
// each weight matrix's layer input H to a device buffer as its GEMM
// epilogues form them: one point-major segment per activation (the
// embedding, h_l, the feature, hv; BwdDesc hseg, ops/cuda/fused_mlp_bwd.py
// act_layout, ~10 KB a point at the lego width), kept from the forward to
// the backward. B2 reads it and reruns no forward. The TPU kernel runs its
// grid in order and carries the weight gradients in revisited VMEM blocks;
// Hopper's blocks run in no order and carry nothing, so B2 is two kernels
// and a reduction:
//
// 1. nerf_bwd_kernel, one persistent block per SM walking 128-point tiles
//    (tc::TP), half of the FLOPs, on the tensor cores through B1's tile
//    (mlp_tile_tc.cuh): the input gradients dh = dz·W through every layer
//    down to dx (nerf_bwd_kernel<true>; where no input needs a gradient,
//    as in a training step without pose refinement, nerf_bwd_kernel<false>
//    runs no GEMM into the embedding and writes no dx). Every GEMM runs
//    on wgmma in split fp32 (3xTF32), each 8-row slice summed on the
//    tensor cores from zero and added in fp32 on the CUDA cores
//    (mma_slice_rn): the tensor cores' running sum drifts toward zero,
//    and dx feeds the pose gradients. The weights stream
//    through a ring of shared-memory slots (bulk copies, mbarriers) from
//    the backward pack (ops/cuda/fused_mlp_bwd.py pack_backward_tc: each
//    weight [out][in] as a [K = out][N = in] matrix in the forward pack's
//    K-major slices, split where the forward concatenates its input: the
//    skip layer's embedding and h columns, the views layer's feature and
//    direction columns). Shared memory holds one [128][HS] tile (the
//    running gradient, the A operand of every GEMM), the cotangent tile,
//    the encoder's rows (dx) and the ring. Each post-mask cotangent dZ goes
//    to a second device buffer (BwdDesc zseg, ~9.9 KB a point), written
//    from the accumulators in each GEMM's epilogue; the ReLU mask of dz_l
//    reads h_l from H, and the narrow heads' one reads hv (or h_{D-1}).
//    The narrow heads' transposed products (K = 1, 3 or output_ch) run in
//    fp32 on the CUDA cores. dx as the TPU kernel computes it
//    (fused_mlp_bwd.py:299-300): through identity columns 1, through
//    sin(f·x) f·cos(f·x), through cos(f·x) -f·sin(f·x), summed per input
//    coordinate, formed in the epilogue of each GEMM into the embedding
//    (layer 0, the skip layer, the views layer's directions) and added per
//    point and coordinate in shared memory in a fixed order.
// 2. nerf_dw_kernel: dW = H^T·dZ and db = sum dZ for every matrix, the
//    other half of the FLOPs, as a GEMM over the points (K = up to
//    524,288). A block owns one 128 x 128 output tile of one product over
//    one range of points (split K), streams H and dZ chunks of 32 points
//    through a three-stage cp.async ring in shared memory, and runs
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
// H is bit for bit what the tile formed when it reran the forward itself
// (B1's tile, the same slice sums and epilogue), so the gradients are too.
//
// mip-NeRF (nerf_bwd_ipe_kernel): the tile kernel over H from B1's IPE
// launch (nerf_points_ipe_kernel<true>); its backward pack has no GEMMs
// into the embedding (mip-NeRF trains no poses), so it reads no encoder
// rows and writes no dx. nerf_dw_kernel and the reduction are the same.
//
// bf16 (nerf_bwd_bf16_kernel, nerf_dw_bf16_kernel; --precision bf16): the
// TPU kernel's bf16 instantiation (_make_bwd_kernel_closed with
// compute_dtype bfloat16, fused_mlp_bwd.py:176-300). Its B1 runs another
// tile (mlp_tile_bf16.cuh), so this tile reruns the forward before the
// backward, as tile_network runs it, and writes H itself: one
// wgmma.m64nNk16 bf16 product a 16-row slice of both packs (rounded to
// bf16 by the wrappers), its A operand the bf16-rounded activations or
// dz_c as bf16x2 pairs in registers, fp32 accumulators. The encoding,
// every layer's output and the cotangent g are rounded as they are stored;
// each dz (dhv, dfeature, dz_l) goes to the dZ buffer in fp32 and is
// rounded (dz_c) as it is stored in shared memory, the operand of dh =
// dz_c·Wᵀ, as JAX's _dot_nt(dz_c, W). The ReLU masks read the bf16
// activations. The dW kernel rounds dZ as it loads it and forms dW with
// one mma.sync.m16n8k16 bf16 product a 16-point step (each summed from
// zero and added in fp32), while its bias sums read the fp32 dZ (dbout the
// rounded g), as JAX's do. demb and dx stay fp32. Bound: all FLOPs over
// the 989 TFLOP/s bf16 rate.
#include <type_traits>

#include "mlp_tile_tc.cuh"

namespace nstt {

constexpr int NTHREADS = tc::NTHREADS;
using tc::MAX_LAYERS;
constexpr int G_LD = tc::RAW_LD;  // cotangent tile row: rgb 0-2, alpha 3, alpha 4
constexpr int DX_LD = 6;          // dx scratch row: d/dpts, d/ddirs

// The input-gradient GEMMs in the order the tile runs them (pack_backward_tc
// bwd_gemms): the views layer's direction and feature columns, the feature
// layer, then per layer from the last its embedding columns (layer 0 and
// the skip layer) and its h columns. A row holds the forward's fields
// G_W (float offset in the backward pack), G_NP, G_NS0 and G_NS1 (0) that
// the ring reads, the kind of its epilogue and its argument.
constexpr int MAX_BGEMMS = 3 + 2 * MAX_LAYERS;
enum { BG_KIND = tc::G_B, BG_ARG = tc::G_SRC0 };
// epilogues: dx through the embedding (arg 0 the points' columns, 1 the
// directions'); dfeature; dz_arg = dh_arg ⊙ 1[h_arg > 0], under
// BK_DZ_ALPHA with g_alpha·W_alpha added first
enum { BK_DEMB, BK_DFEATURE, BK_DZ, BK_DZ_ALPHA };
enum { BH_NB, BH_SLOT };
// Activation segments of the H and dZ buffers: {floats a point before the
// segment, row stride}; for n_pad points segment s starts at float
// n_pad * seg[s][0]. H (mlp_tile_tc.cuh N_SEG, HS_*): the embedding, h_l
// at 1 + l, the feature, hv; dZ: dz_l at l, dfeature, dhv, the cotangent
// tile.
using tc::N_SEG;
using tc::HS_EMB;
using tc::HS_FEATURE;
using tc::HS_HV;
enum { ZS_DFEATURE = MAX_LAYERS, ZS_DHV = MAX_LAYERS + 1, ZS_GR = MAX_LAYERS + 2 };
struct BwdDesc {
  long long hdr[8];
  long long gemm[MAX_BGEMMS][8];
  long long hseg[N_SEG][2];
  long long zseg[N_SEG][2];
};

// dynamic shared memory of the tile kernel, in floats: the activation tile,
// the cotangent tile, the encoder's rows, two warpgroups' dx sums and R
// ring slots of SLOT floats (ops/cuda/fused_mlp_bwd.py smem_bytes mirrors
// it, plus the descriptors and barriers in static shared memory)
__host__ __device__ inline size_t bwd_smem_floats(int HS, int SLOT, int R,
                                                  int ROW = tc::PointEnc::ROW) {
  return (size_t)tc::TP * (HS + G_LD + ROW + 2 * DX_LD) + (size_t)R * SLOT;
}

// Row p0 of segment s of an H or dZ buffer.
__device__ __forceinline__ float* seg_rows(float* buf, const long long (&s)[2],
                                           long long n_pad, long long p0) {
  return buf + s[0] * n_pad + p0 * s[1];
}

namespace tc {

// mbar_wait without its printf: an extern call in the kernel makes ptxas
// serialise its wgmma (C7510). A phase that never completes still traps.
__device__ __forceinline__ void bar_wait(unsigned long long* bar, unsigned parity) {
  const unsigned addr = smem_addr(bar);
  for (int tries = 0;; ++tries) {
    unsigned done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n" : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (tries == (1 << 24)) __trap();
  }
}

// The ring over B2's sequence, tile after tile: the forward's first nf
// GEMMs of d (weights wb; nf 0 where the tile reads H, the forward's NG
// where it reruns the forward), then the backward's NB of bd (weights wbt).
struct Sweep {
  const Desc* d;
  const BwdDesc* bd;
  const float* wb;
  const float* wbt;
  int nf;
};

template <bool kBf16>
__device__ inline void produce(Ring& r, const Sweep& w) {
  if (r.pk >= r.ntiles) return;
  if (r.pissued >= r.R) bar_wait(r.empty + r.pslot, r.pphase ^ 1);
  const int NF = w.nf;
  const bool fwd = r.pg < NF;
  const long long* G = fwd ? w.d->gemm[r.pg] : w.bd->gemm[r.pg - NF];
  const unsigned floats = slice_floats_per_col<kBf16>() * (unsigned)G[G_NP];
  bulk_load(r.slots + r.pslot * r.SLOT, (fwd ? w.wb : w.wbt) + G[G_W] + (long long)r.ps * floats,
            floats * 4u, r.full + r.pslot);
  ++r.pissued;
  if (++r.pslot == r.R) {
    r.pslot = 0;
    r.pphase ^= 1;
  }
  if (++r.ps == (int)(G[G_NS0] + G[G_NS1])) {
    r.ps = 0;
    if (++r.pg == NF + (int)w.bd->hdr[BH_NB]) {
      r.pg = 0;
      ++r.pk;
    }
  }
}

template <bool kBf16>
__device__ inline Ring start_sweep(const Sweep& w, float* slots, unsigned long long* bars,
                                   int R, int SLOT, long long ntiles) {
  Ring r;
  r.slots = slots;
  r.full = bars;
  r.empty = bars + MAX_SLOTS;
  r.R = R;
  r.SLOT = SLOT;
  r.cslot = r.cphase = r.cq = r.pslot = r.pphase = r.pg = r.ps = 0;
  r.pissued = r.pk = 0;
  r.ntiles = ntiles;
  if (threadIdx.x == 0) {
    for (int i = 0; i < R; ++i) {
      mbar_init(r.full + i, 1);
      mbar_init(r.empty + i, NWARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int i = 0; i < R - 1; ++i) produce<kBf16>(r, w);
  }
  return r;
}

template <bool kBf16>
__device__ __forceinline__ const float* take(Ring& r, const Sweep& w) {
  if (threadIdx.x == 0) produce<kBf16>(r, w);
  bar_wait(r.full + r.cslot, r.cphase);
  __syncwarp();
  return r.slots + r.cslot * r.SLOT;
}

// acc = the GEMM's product over all its slices: A from s.h (src SRC_H) or
// the encoder, the weights from the ring; as tile_network runs it (fp32:
// slice sums rounded to nearest; bf16: one k16 product a slice). The
// backward passes SRC_H as a run-time value: folded to a constant, it let
// ptxas spill the fp32 tiles (PERF.md, Findings).
template <bool kBf16, class Enc>
__device__ __forceinline__ void sweep_gemm(float (&acc)[2][NACC], const long long* G,
                                           int src0, int src1, const Desc& d,
                                           const Enc& e, const Smem& s, Ring& r,
                                           const Sweep& w) {
  const int HS = (int)d.hdr[H_HS];
  const int np = (int)G[G_NP], nh = np >> 1, n0 = (threadIdx.x >> 7) * nh;
  const int ns0 = (int)G[G_NS0], ns = ns0 + (int)G[G_NS1];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[m][i] = 0.f;
  for (int i = 0; i < ns; ++i) {
    const float* slice = take<kBf16>(r, w);
    const bool first = i < ns0;
    const int src = first ? src0 : src1;
    const int k0 = (first ? i : i - ns0) * (kBf16 ? 2 * SLICE_K : SLICE_K);
    const float* big = slice + n0 * 8;
    const float* small = slice + 8 * np + n0 * 8;
    if constexpr (kBf16) {
      unsigned a[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) a_frag_bf16(d, e, s, src, k0, HS, m, a[m]);
      const unsigned long long b = b_desc(big);
      switch (nh) {
        case 128: mma_slice_bf16<128>(acc, a, b); break;
        case 64: mma_slice_bf16<64>(acc, a, b); break;
        case 32: mma_slice_bf16<32>(acc, a, b); break;
        default: mma_slice_bf16<16>(acc, a, b); break;
      }
    } else {
      const auto frag = [&](int m, unsigned (&fb)[4], unsigned (&fs)[4]) {
        a_frag(d, e, s, src, k0, HS, m, fb, fs);
      };
      switch (nh) {
        case 128: mma_slice_rn<128, 1>(acc, frag, big, small); break;
        case 64: mma_slice_rn<64, 1>(acc, frag, big, small); break;
        case 32: mma_slice_rn<32, 1>(acc, frag, big, small); break;
        default: mma_slice_rn<16, 1>(acc, frag, big, small); break;
      }
    }
    release(r);
  }
}

// The thread's accumulator (m, 4 j + q) holds tile row 64 m + r0 + 8 (q >> 1)
// and column n0 + 8 j + 2 t + (q & 1).
__device__ __forceinline__ int frag_row0() {
  return 16 * ((threadIdx.x >> 5) & 3) + ((threadIdx.x & 31) >> 2);
}

__device__ __forceinline__ int frag_col(int n0, int j) {
  return n0 + 8 * j + 2 * (threadIdx.x & 3);
}

// acc -> s.h (all nh columns of the warpgroup; kRound: rounded to bf16),
// once every warp is done reading s.h. Ends with a barrier.
template <bool kRound>
__device__ __forceinline__ void to_tile(const float (&acc)[2][NACC], int nh, int n0,
                                        float* h, int HS) {
  const int r0 = frag_row0();
  __syncthreads();
#pragma unroll
  for (int j = 0; j < NACC / 4; ++j) {
    if (8 * j < nh) {
      const int col = frag_col(n0, j);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int r = 64 * m + r0;
        float v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q] = kRound ? round_bf16(acc[m][4 * j + q]) : acc[m][4 * j + q];
        *reinterpret_cast<float2*>(h + r * HS + col) = make_float2(v[0], v[1]);
        *reinterpret_cast<float2*>(h + (r + 8) * HS + col) = make_float2(v[2], v[3]);
      }
    }
  }
  __syncthreads();
}

// acc's columns below ld -> rows of a segment (row stride ld, a multiple
// of 4) of the H or dZ buffer
__device__ __forceinline__ void to_segment(const float (&acc)[2][NACC], int nh, int n0,
                                           float* rows, int ld) {
  const int r0 = frag_row0();
#pragma unroll
  for (int j = 0; j < NACC / 4; ++j) {
    const int col = frag_col(n0, j);
    if (8 * j < nh && col < ld) {
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int r = 64 * m + r0;
        __stcg(reinterpret_cast<float2*>(rows + (size_t)r * ld + col),
               make_float2(acc[m][4 * j], acc[m][4 * j + 1]));
        __stcg(reinterpret_cast<float2*>(rows + (size_t)(r + 8) * ld + col),
               make_float2(acc[m][4 * j + 2], acc[m][4 * j + 3]));
      }
    }
  }
}

// forward epilogue: acc = act(acc + bias) (kBf16: rounded), as
// tile_network's epilogue forms it
template <bool kBf16>
__device__ __forceinline__ void bias_act(float (&acc)[2][NACC], const float* __restrict__ bias,
                                         bool relu, int nh, int n0) {
#pragma unroll
  for (int j = 0; j < NACC / 4; ++j) {
    if (8 * j < nh) {
      const int col = frag_col(n0, j);
      const float b[2] = {__ldg(bias + col), __ldg(bias + col + 1)};
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float v = acc[m][4 * j + q] + b[q & 1];
          if (relu) v = fmaxf(v, 0.f);
          acc[m][4 * j + q] = kBf16 ? round_bf16(v) : v;
        }
    }
  }
}

// dz = dh ⊙ 1[h > 0] in place, h the forward's output in rows (row stride
// ldh; columns past it 0) of the H buffer, which this thread wrote; wa
// (non-null): first dh += g_alpha · W_alpha, wa the alpha head's K weights,
// g_alpha column 4 of the cotangent tile
__device__ __forceinline__ void relu_mask(float (&acc)[2][NACC], int nh, int n0,
                                          const float* hrows, int ldh, const float* wa,
                                          int K, const float* gr) {
  const int r0 = frag_row0();
#pragma unroll
  for (int j = 0; j < NACC / 4; ++j) {
    if (8 * j < nh) {
      const int col = frag_col(n0, j);
      float w0 = 0.f, w1 = 0.f;
      if (wa) {
        w0 = col < K ? __ldg(wa + col) : 0.f;
        w1 = col + 1 < K ? __ldg(wa + col + 1) : 0.f;
      }
#pragma unroll
      for (int m = 0; m < 2; ++m) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = 64 * m + r0 + 8 * hh;
          float2 h = make_float2(0.f, 0.f);
          if (col < ldh) h = __ldcg(reinterpret_cast<const float2*>(hrows + (size_t)r * ldh + col));
          float v0 = acc[m][4 * j + 2 * hh], v1 = acc[m][4 * j + 2 * hh + 1];
          if (wa) {
            const float ga = gr[r * G_LD + 4];
            v0 = fmaf(ga, w0, v0);
            v1 = fmaf(ga, w1, v1);
          }
          acc[m][4 * j + 2 * hh] = h.x > 0.f ? v0 : 0.f;
          acc[m][4 * j + 2 * hh + 1] = h.y > 0.f ? v1 : 0.f;
        }
      }
    }
  }
}

// dx through the embedding: acc holds demb's columns [n0, n0 + nh) of the
// segment of compact embedding columns [base, base + width), which read
// inputs dim0 .. dim0 + 2 (the point or the direction). Each thread sums
// acc·d(emb)/dx over its columns per row and input, the quad's four
// threads add theirs, and lane 0 of the quad adds the sum to the
// warpgroup's dx row in shared memory (one thread per row and input: a
// fixed order).
__device__ __forceinline__ void demb_to_dx(const float (&acc)[2][NACC], const Desc& d,
                                           const float* __restrict__ enc, const float* rows,
                                           int nh, int n0, int base, int width, int dim0,
                                           float* dxs) {
  const int r0 = frag_row0();
  float sx[2][2][3];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int i = 0; i < 3; ++i) sx[m][hh][i] = 0.f;
#pragma unroll
  for (int j = 0; j < NACC / 4; ++j) {
#pragma unroll
    for (int q2 = 0; q2 < 2; ++q2) {
      const int col = frag_col(n0, j) + q2;
      if (8 * j < nh && col < width) {
        const int cc = base + col;
        const int dim = (int)__ldg(enc + MAX_EMB + cc);
        const int k = d.kind[cc];
        const float f = __ldg(enc + cc);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int r = 64 * m + r0 + 8 * hh;
            float der = 1.f;
            if (k != 0) {
              const float arg = __fmul_rn(f, rows[r * PointEnc::ROW + dim]);
              der = k == 1 ? f * cosf(arg) : -f * sinf(arg);
            }
            const float v = acc[m][4 * j + 2 * hh + q2] * der;
            const int i = dim - dim0;
            sx[m][hh][0] += i == 0 ? v : 0.f;
            sx[m][hh][1] += i == 1 ? v : 0.f;
            sx[m][hh][2] += i == 2 ? v : 0.f;
          }
        }
      }
    }
  }
  const int wg = threadIdx.x >> 7;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        float v = sx[m][hh][i];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if ((threadIdx.x & 3) == 0)
          dxs[(wg * TP + 64 * m + r0 + 8 * hh) * DX_LD + dim0 + i] += v;
      }
}

// The narrow heads' transposed products on the CUDA cores, in fp32, the
// first step of the backward: dhv = (g_rgb·W_rgb) ⊙ 1[hv > 0], or dz_{D-1}
// = (g·W_out) ⊙ 1[h_{D-1} > 0], a sum of K <= 8 products in order, the
// mask from hv (h_{D-1}) in s.h where the tile reran the forward (kRerun),
// else from its H segment, which B1 wrote; to its dZ segment (fp32; the
// row's padding columns 0) and, rounded under kBf16, in place to s.h (from
// H: with zeros up to the next multiple of 8 columns, the K rows the first
// GEMM reads). Ends with a barrier.
template <bool kBf16, bool kRerun>
__device__ inline void narrow_bwd(const Desc& d, const BwdDesc& bd, const float* __restrict__ wb,
                                  const Smem& s, const float* hbuf, float* zbuf,
                                  long long n_pad, long long p0) {
  const int HS = (int)d.hdr[H_HS], D = (int)d.hdr[H_D];
  const bool views = d.hdr[H_VIEWDIRS] != 0;
  const long long* Nh = d.narrow[views ? N_RGB : N_OUTPUT];
  const float* __restrict__ w = wb + Nh[NW_W];
  const int K = (int)Nh[NW_K], N = (int)Nh[NW_N];
  const long long(&zs)[2] = bd.zseg[views ? ZS_DHV : D - 1];
  float* z = seg_rows(zbuf, zs, n_pad, p0);
  const int ld = (int)zs[1];
  const long long(&hs)[2] = bd.hseg[views ? HS_HV : 1 + (D - 1)];
  const float* h = hbuf + hs[0] * n_pad + p0 * hs[1];
  const int ldh = (int)hs[1];
  const int cols = kRerun ? ld : (ld + SLICE_K - 1) / SLICE_K * SLICE_K;
  for (int i = threadIdx.x; i < TP * cols; i += NTHREADS) {
    const int p = i / cols, c = i - p * cols;
    float v = 0.f;
    if (c < K) {
      const float* gp = s.raw + p * G_LD;
      v = gp[0] * __ldg(w + c);
      for (int o = 1; o < N; ++o) v = fmaf(gp[o], __ldg(w + o * K + c), v);
      const float a = kRerun ? s.h[p * HS + c] : __ldcg(h + (size_t)p * ldh + c);
      if (!(a > 0.f)) v = 0.f;
    }
    if (kRerun || c < ld) __stcg(z + (size_t)p * ld + c, v);
    s.h[p * HS + c] = kBf16 ? round_bf16(v) : v;
  }
  __syncthreads();
}

// An encoder that forms nothing, for the backward GEMMs of the fp32 point
// tile (nerf_bwd_kernel): they read their A operand from s.h alone. Behind
// a_frag's encoder branch (a run-time source) it left ptxas room to keep
// that tile at 120-168 B of stack where PointEnc's encoding made it spill
// 232-272 B, 6.35 against 10.23 ms at 196,608 lego points without dx;
// the IPE tile keeps its own encoder there, which ptxas allocated better
// (15.26 against 16.53 ms at 524,288 Gaussians, H100; PERF.md, Findings).
struct NoEnc {
  static constexpr int ROW = 0;
  __device__ __forceinline__ float value(const Desc&, const float*, int, int) const {
    return 0.f;
  }
};

// B2's tile kernel: one persistent block an SM walks the 128-point tiles.
// Per tile: the encoder's rows (where dx needs them), the cotangent tile
// (to dZ); the narrow heads' transposed products; the backward GEMMs with
// their epilogues (dx sums, dfeature, dz, each mask from H); dx (without
// kDx: none, and the backward pack holds no GEMM into the embedding). The
// layer inputs are in H, which B1's training launch wrote. The bf16 tile
// (kBf16) reruns the forward first instead: the embedding to H, the
// forward GEMMs, each layer's output to H and s.h.
template <bool kBf16, class Enc = PointEnc, bool kDx = Enc::kDx>
__device__ inline void bwd_tiles(const Desc* __restrict__ gdesc,
                                 const BwdDesc* __restrict__ gbd,
                                 const float* __restrict__ wb, const float* __restrict__ wbt,
                                 const float* __restrict__ enc, const float* __restrict__ pts,
                                 const float* __restrict__ vd, const float* __restrict__ g,
                                 int C, float* __restrict__ dx, float* hbuf, float* zbuf,
                                 long long total, long long n_pad, int S, int R) {
  constexpr bool kRerun = kBf16;
  __shared__ Desc d;
  __shared__ BwdDesc bd;
  __shared__ unsigned long long bars[2 * MAX_SLOTS];
  extern __shared__ float4 dyn[];
  load_desc(d, gdesc);
  {
    const long long* src = reinterpret_cast<const long long*>(gbd);
    long long* dst = reinterpret_cast<long long*>(&bd);
    for (int i = threadIdx.x; i < (int)(sizeof(BwdDesc) / 8); i += NTHREADS)
      dst[i] = __ldg(src + i);
  }
  __syncthreads();
  const int D = (int)d.hdr[H_D], P = (int)d.hdr[H_P], V = (int)d.hdr[H_V];
  const int HS = (int)d.hdr[H_HS], NB = (int)bd.hdr[BH_NB];
  const int NF = kRerun ? (int)d.hdr[H_NG] : 0;
  const bool views = d.hdr[H_VIEWDIRS] != 0;
  Smem s;
  s.h = reinterpret_cast<float*>(dyn);
  s.raw = s.h + TP * HS;
  s.rows = s.raw + TP * G_LD;
  float* dxs = s.rows + TP * Enc::ROW;   // [2][TP][DX_LD]
  s.ring = dxs + 2 * TP * DX_LD;
  const Enc e{pts, vd, enc, S};
  const Sweep sw{&d, &bd, wb, wbt, NF};
  const long long n_tiles = (total + TP - 1) / TP;
  const long long mine = n_tiles > blockIdx.x
                             ? (n_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
  Ring ring = start_sweep<kBf16>(sw, s.ring, bars, R, (int)bd.hdr[BH_SLOT], mine);
  for (int i = threadIdx.x; i < 2 * TP * DX_LD; i += NTHREADS) dxs[i] = 0.f;
  const int wg = threadIdx.x >> 7;
  float acc[2][NACC];

  for (long long t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const long long p0 = t * TP;
    if (kRerun || kDx) tile_rows(d, e, p0, total, s);
    // the cotangent tile, rounded under kBf16, to s.raw and dZ
    float* zg = seg_rows(zbuf, bd.zseg[ZS_GR], n_pad, p0);
    for (int i = threadIdx.x; i < TP * G_LD; i += NTHREADS) {
      const int p = i / G_LD, c = i % G_LD;
      const long long gp = p0 + p;
      float v = 0.f;
      if (gp < total) {
        if (views) {
          if (c < 4) v = __ldg(g + gp * C + c);
          else if (c == 4) v = __ldg(g + gp * C + 3);
        } else if (c < C) {
          v = __ldg(g + gp * C + c);
        }
      }
      if (kBf16) v = round_bf16(v);
      s.raw[i] = v;
      __stcg(zg + i, v);
    }
    __syncthreads();   // the rows and the cotangent tile are set
    if constexpr (kRerun) {
      // the embedding to H (rounded; rows past total 0)
      emb_to_h<true>(d, e, s, seg_rows(hbuf, bd.hseg[HS_EMB], n_pad, p0),
                     (int)bd.hseg[HS_EMB][1], p0, total);
    }

    if constexpr (!kRerun) narrow_bwd<kBf16, false>(d, bd, wb, s, hbuf, zbuf, n_pad, p0);
    for (int gi = 0; gi < NF + NB; ++gi) {
      if constexpr (kRerun) {
        if (gi < NF) {
          // h_gi, the feature or hv, to H and s.h
          const long long* G = d.gemm[gi];
          const int nh = (int)G[G_NP] >> 1, n0 = wg * nh;
          sweep_gemm<kBf16>(acc, G, (int)G[G_SRC0], (int)G[G_SRC1], d, e, s, ring, sw);
          const int seg = gi < D ? 1 + gi : (gi == D ? HS_FEATURE : HS_HV);
          bias_act<kBf16>(acc, wb + G[G_B], G[G_RELU] != 0, nh, n0);
          to_segment(acc, nh, n0, seg_rows(hbuf, bd.hseg[seg], n_pad, p0),
                     (int)bd.hseg[seg][1]);
          to_tile<false>(acc, nh, n0, s.h, HS);
          if (gi == NF - 1) narrow_bwd<kBf16, true>(d, bd, wb, s, hbuf, zbuf, n_pad, p0);
          continue;
        }
      }
      const long long* G = bd.gemm[gi - NF];
      const int nh = (int)G[G_NP] >> 1, n0 = wg * nh;
      if constexpr (kRerun || !std::is_same_v<Enc, PointEnc>)
        sweep_gemm<kBf16>(acc, G, SRC_H, -1, d, e, s, ring, sw);
      else
        sweep_gemm<kBf16>(acc, G, SRC_H, -1, d, NoEnc{}, s, ring, sw);
      const int kind = (int)G[BG_KIND], arg = (int)G[BG_ARG];
      if (kind == BK_DEMB) {
        if constexpr (kDx)
          demb_to_dx(acc, d, enc, s.rows, nh, n0, arg ? P : 0, arg ? V : P, 3 * arg, dxs);
      } else if (kind == BK_DFEATURE) {
        to_segment(acc, nh, n0, seg_rows(zbuf, bd.zseg[ZS_DFEATURE], n_pad, p0),
                   (int)bd.zseg[ZS_DFEATURE][1]);
        to_tile<kBf16>(acc, nh, n0, s.h, HS);
      } else {
        // dz_arg: the mask from h_arg, to dZ (fp32) and s.h (dz_c)
        const long long* Na = d.narrow[N_ALPHA];
        relu_mask(acc, nh, n0, seg_rows(hbuf, bd.hseg[1 + arg], n_pad, p0),
                  (int)bd.hseg[1 + arg][1], kind == BK_DZ_ALPHA ? wb + Na[NW_W] : nullptr,
                  (int)Na[NW_K], s.raw);
        to_segment(acc, nh, n0, seg_rows(zbuf, bd.zseg[arg], n_pad, p0), (int)bd.zseg[arg][1]);
        to_tile<kBf16>(acc, nh, n0, s.h, HS);
      }
    }
    __syncthreads();   // every warpgroup's dx sums are in
    if constexpr (kDx) {
      for (int i = threadIdx.x; i < TP * DX_LD; i += NTHREADS) {
        const long long gp = p0 + i / DX_LD;
        const float v = dxs[i] + dxs[TP * DX_LD + i];
        dxs[i] = dxs[TP * DX_LD + i] = 0.f;
        if (gp < total) dx[gp * DX_LD + i % DX_LD] = v;
      }
    }
  }
}

}  // namespace tc

// kDx: dx [total][6] is written; without it (no input needs a gradient)
// the backward pack holds no GEMM into the embedding and dx is not read
template <bool kDx>
__global__ void __launch_bounds__(NTHREADS, 1)
nerf_bwd_kernel(const tc::Desc* __restrict__ gdesc, const BwdDesc* __restrict__ gbd,
                const float* __restrict__ wb, const float* __restrict__ wbt,
                const float* __restrict__ enc, const float* __restrict__ pts,
                const float* __restrict__ vd, const float* __restrict__ g, int C,
                float* __restrict__ dx, float* hbuf, float* zbuf, long long total,
                long long n_pad, int S, int R) {
  tc::bwd_tiles<false, tc::PointEnc, kDx>(gdesc, gbd, wb, wbt, enc, pts, vd, g, C, dx, hbuf,
                                          zbuf, total, n_pad, S, R);
}

__global__ void __launch_bounds__(NTHREADS, 1)
nerf_bwd_bf16_kernel(const tc::Desc* __restrict__ gdesc, const BwdDesc* __restrict__ gbd,
                     const float* __restrict__ wb, const float* __restrict__ wbt,
                     const float* __restrict__ enc, const float* __restrict__ pts,
                     const float* __restrict__ vd, const float* __restrict__ g, int C,
                     float* __restrict__ dx, float* hbuf, float* zbuf, long long total,
                     long long n_pad, int S, int R) {
  tc::bwd_tiles<true>(gdesc, gbd, wb, wbt, enc, pts, vd, g, C, dx, hbuf, zbuf, total, n_pad,
                      S, R);
}

// mip-NeRF: gauss [total][6] (mean, variances) in place of the points; dx
// is not written
__global__ void __launch_bounds__(NTHREADS, 1)
nerf_bwd_ipe_kernel(const tc::Desc* __restrict__ gdesc, const BwdDesc* __restrict__ gbd,
                    const float* __restrict__ wb, const float* __restrict__ wbt,
                    const float* __restrict__ enc, const float* __restrict__ gauss,
                    const float* __restrict__ vd, const float* __restrict__ g, int C,
                    float* __restrict__ dx, float* hbuf, float* zbuf, long long total,
                    long long n_pad, int S, int R) {
  tc::bwd_tiles<false, tc::IpeEnc>(gdesc, gbd, wb, wbt, enc, gauss, vd, g, C, dx, hbuf, zbuf,
                                   total, n_pad, S, R);
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

using BwdKernel = void (*)(const nstt::tc::Desc*, const nstt::BwdDesc*, const float*,
                           const float*, const float*, const float*, const float*,
                           const float*, int, float*, float*, float*, long long, long long,
                           int, int);
using DwKernel = void (*)(const nstt::BwdDesc*, const long long*, const long long*,
                          const float*, const float*, float*, long long, long long,
                          long long);

static int mlp_backward(BwdKernel bwd_kernel, DwKernel dw_kernel, const void* desc_dev,
                        const void* bdesc_dev, int HS, int SLOT, const float* wb,
                        const float* wbt, const float* enc, const float* pts,
                        const float* vd, const float* g, int C, float* dx, float* hbuf,
                        float* zbuf, int n_dw_tiles, const long long* jobs,
                        const long long* tiles, float* part, float* grads,
                        long long wsize, long long total, long long n_pad, int S,
                        int splits, void* stream, int row = nstt::tc::PointEnc::ROW) {
  using namespace nstt;
  cudaStream_t st = (cudaStream_t)stream;
  // the tile kernel: the deepest ring (at most MAX_SLOTS) that fits beside
  // its static shared memory, one persistent block an SM
  int dev, optin, sms;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaFuncAttributes fa;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, (const void*)bwd_kernel);
  if (e != cudaSuccess) return (int)e;
  const long long avail = (long long)optin - (long long)fa.sharedSizeBytes;
  const long long r =
      (avail - 4LL * (long long)bwd_smem_floats(HS, SLOT, 0, row)) / (4LL * SLOT);
  if (r < 2) return (int)cudaErrorInvalidConfiguration;
  const int R = (int)(r < tc::MAX_SLOTS ? r : tc::MAX_SLOTS);
  const size_t bytes = 4 * bwd_smem_floats(HS, SLOT, R, row);
  e = cudaFuncSetAttribute((const void*)bwd_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const long long n_tiles = (total + tc::TP - 1) / tc::TP;
  const unsigned grid = (unsigned)(n_tiles < sms ? n_tiles : sms);
  bwd_kernel<<<grid, NTHREADS, bytes, st>>>(
      (const tc::Desc*)desc_dev, (const BwdDesc*)bdesc_dev, wb, wbt, enc, pts, vd, g, C, dx,
      hbuf, zbuf, total, n_pad, S, R);
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

// desc_dev: pack_network_tc's Desc, bdesc_dev: pack_backward_tc's BwdDesc;
// HS, SLOT: the activation tile's row stride and the floats of a ring slot
// (the widest slice of either pack); wb, wbt: the forward and backward
// packs; hbuf, zbuf: H and dZ for n_pad points (act_layout, n_pad a
// multiple of the 128-point tile), H as B1's training launch wrote it (the
// bf16 entry writes H itself); jobs [n_jobs][J_WORDS] and tiles
// [n_dw_tiles][T_WORDS] of nerf_dw_kernel, run over `splits` point ranges
// into part [splits][wsize]; grads [wsize] their fixed-order sum.
extern "C" int nstt_mlp_backward(const void* desc_dev, const void* bdesc_dev,
                                 int HS, int SLOT, const float* wb,
                                 const float* wbt, const float* enc,
                                 const float* pts, const float* vd,
                                 const float* g, int C, float* dx, float* hbuf,
                                 float* zbuf, int n_dw_tiles, const long long* jobs,
                                 const long long* tiles, float* part, float* grads,
                                 long long wsize, long long total, long long n_pad,
                                 int S, int splits, void* stream) {
  return mlp_backward(nstt::nerf_bwd_kernel<true>, nstt::nerf_dw_kernel, desc_dev, bdesc_dev,
                      HS, SLOT, wb, wbt, enc, pts, vd, g, C, dx, hbuf, zbuf, n_dw_tiles, jobs,
                      tiles, part, grads, wsize, total, n_pad, S, splits, stream);
}

// B2 with no input gradient (a training step whose points and directions
// need none): over the backward pack without the GEMMs into the embedding
// (pack_backward_tc with dx False); dx is not written. The other arguments
// as for nstt_mlp_backward.
extern "C" int nstt_mlp_backward_nodx(const void* desc_dev, const void* bdesc_dev,
                                      int HS, int SLOT, const float* wb,
                                      const float* wbt, const float* enc,
                                      const float* pts, const float* vd,
                                      const float* g, int C, float* dx, float* hbuf,
                                      float* zbuf, int n_dw_tiles, const long long* jobs,
                                      const long long* tiles, float* part, float* grads,
                                      long long wsize, long long total, long long n_pad,
                                      int S, int splits, void* stream) {
  return mlp_backward(nstt::nerf_bwd_kernel<false>, nstt::nerf_dw_kernel, desc_dev, bdesc_dev,
                      HS, SLOT, wb, wbt, enc, pts, vd, g, C, dx, hbuf, zbuf, n_dw_tiles, jobs,
                      tiles, part, grads, wsize, total, n_pad, S, splits, stream);
}

// B2 in bf16: the same arguments over the bf16 packs
extern "C" int nstt_mlp_backward_bf16(const void* desc_dev, const void* bdesc_dev,
                                      int HS, int SLOT, const float* wb,
                                      const float* wbt, const float* enc,
                                      const float* pts, const float* vd,
                                      const float* g, int C, float* dx, float* hbuf,
                                      float* zbuf, int n_dw_tiles, const long long* jobs,
                                      const long long* tiles, float* part, float* grads,
                                      long long wsize, long long total, long long n_pad,
                                      int S, int splits, void* stream) {
  return mlp_backward(nstt::nerf_bwd_bf16_kernel, nstt::nerf_dw_bf16_kernel, desc_dev,
                      bdesc_dev, HS, SLOT, wb, wbt, enc, pts, vd, g, C, dx, hbuf, zbuf,
                      n_dw_tiles, jobs, tiles, part, grads, wsize, total, n_pad, S, splits,
                      stream);
}

// B2 under mip-NeRF: gauss [total][6] in place of the points (not read:
// no dx), over the IPE packs (no GEMMs into the embedding) and H from B1's
// IPE training launch; dx is not written. The other arguments as for
// nstt_mlp_backward.
extern "C" int nstt_mlp_backward_ipe(const void* desc_dev, const void* bdesc_dev,
                                     int HS, int SLOT, const float* wb,
                                     const float* wbt, const float* enc,
                                     const float* gauss, const float* vd,
                                     const float* g, int C, float* dx, float* hbuf,
                                     float* zbuf, int n_dw_tiles, const long long* jobs,
                                     const long long* tiles, float* part, float* grads,
                                     long long wsize, long long total, long long n_pad,
                                     int S, int splits, void* stream) {
  return mlp_backward(nstt::nerf_bwd_ipe_kernel, nstt::nerf_dw_kernel, desc_dev, bdesc_dev,
                      HS, SLOT, wb, wbt, enc, gauss, vd, g, C, dx, hbuf, zbuf, n_dw_tiles,
                      jobs, tiles, part, grads, wsize, total, n_pad, S, splits, stream,
                      nstt::tc::IpeEnc::ROW);
}
