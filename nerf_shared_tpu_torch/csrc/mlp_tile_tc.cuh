// The NeRF MLP on the tensor cores at fp32 accuracy, on one tile of 128
// sample points: the network of the ray-major kernels B3 (fused_mlp.cu
// nerf_rays_tc_kernel) and B4 (fused_render.cu nerf_render_tc_kernel) and
// of the point-major kernel B1 (fused_mlp.cu nerf_points_tc_kernel). B2
// keeps the CUDA-core tile of mlp_tile.cuh.
//
// Split fp32 (3xTF32). Every trunk and head GEMM runs on Hopper's
// warpgroup MMA, wgmma.mma_async.m64nNk8 with tf32 operands and fp32
// accumulators. Each operand x is split into big = tf32_rn(x) and small =
// tf32_rn(x - big), and the product is accumulated as small·big' +
// big·small' + big·big'. The dropped small·small' term is ~2^-22 of the
// product, fp32 rounding class (plain TF32 keeps ~2^-11). Activations are
// split in registers (wgmma's A operand comes from registers). Weights are
// split once on the host into a big and a small plane, since wgmma reads
// its B operand from shared memory: a split there by each warpgroup, which
// would halve the bytes read from L2, stalled the weight ring in every
// build tried (PERF.md, Findings), and a split in registers, as mma.sync
// allows, left that design at 186 ms against this one's 132 ms for a
// 32768-ray block of 192 samples (H100, same measure). The tensor cores
// add each product to their fp32 accumulator without rounding to nearest
// (the dropped bits bias a running sum toward zero: sigma's error 6.9e-8
// rms, mean -3.4e-8 at the lego width against 5.4e-9 for cuBLAS fp32,
// benchmarks/mlp_accuracy.py on an H100). B3 and B4 keep the running sum
// there (mma_slice); B1, whose forward places the training step's fine
// samples, sums each slice on the tensor cores from zero and adds it in
// fp32 on the CUDA cores (mma_slice_rn): 3.4e-9 rms, unbiased. The encoder (sin / cos of A + z·B or of f·x), the
// bias adds, the ReLUs and the narrow heads (alpha,
// rgb, output_ch <= 8: a warp per point and output, lanes splitting K, fp32
// on the CUDA cores) are the fp32 arithmetic of mlp_tile.cuh.
//
// Block: 256 threads, two warpgroups. Warpgroup w computes output columns
// [w Np / 2, (w + 1) Np / 2) of all 128 points, as two m64 row blocks:
// 128 fp32 accumulators a thread at the lego width. The activations h
// stay in shared memory for the whole network; the encoded inputs are not
// stored but formed where a GEMM reads them (layer 0, the skip layer, the
// views layer), from a few floats a point kept for the tile, which leaves
// the shared memory to the weight ring. What those floats are and how a
// column is formed from them is the encoder, a template parameter of the
// tile: RayEnc (B3, B4: the point's ray and depth, A + z·B) or PointEnc
// (B1: the point and its ray's direction, f·x).
//
// Weights stream through a ring of R >= 2 slots, each one 8-row slice of a
// GEMM's weights (both planes), filled by the tensor memory accelerator
// (one bulk copy a slice, issued by thread 0) and handed over by
// mbarriers: a slot's "full" barrier completes when its bytes land, its
// "empty" barrier when all 8 warps are done with it. No block-wide barrier
// stands between two slices; only the epilogue of a GEMM (which overwrites
// h) waits for all warps. The ring runs over the network's whole weight
// sequence and on into the next tile's, so no layer boundary drains it. A
// 128-point tile reads the lego network's 4.8 MB of split weights once for
// 128 points.
//
// Layout (built by ops/cuda/fused_mlp.py pack_network_tc): each GEMM is a
// [Kp][Np] matrix (K padded to 8, N to a power of two >= 32, with zeros;
// padded bias entries zero), its rows in the order of its input segments
// (the skip layer [pts_emb, h], the views layer [h, dirs_emb]), stored
// slice by slice: rows 8s .. 8s + 7 as the big plane, then the small one,
// each in wgmma's K-major layout without swizzle: core matrices of 8
// columns x 4 rows (128 contiguous bytes, a column's 4 k-values
// together), the two k-halves of a column group 128 bytes apart (the
// descriptor's leading offset) and column groups 256 bytes apart (its
// stride offset). Each narrow head is a [N][K] matrix. The row stride HS
// of h (4 mod 8 floats) keeps the A-fragment loads free of bank conflicts.
#pragma once

#include <cuda_runtime.h>

#include <cstdio>

namespace nstt {
namespace tc {

constexpr int NTHREADS = 256;   // two warpgroups
constexpr int NWARPS = NTHREADS / 32;
constexpr int TP = 128;         // points a tile
constexpr int MAX_GEMMS = 34;   // 32 trunk layers + feature + views
constexpr int MAX_EMB = 256;
constexpr int RAW_LD = 8;       // raw outputs (and composite scratch) a point
constexpr int SLICE_K = 8;      // weight rows a ring slot holds (one MMA k)
constexpr int MAX_SLOTS = 8;
constexpr int NACC = 64;        // accumulators a thread per m64 block (N <= 128)

// hdr[] indices
enum { H_D, H_W, H_P, H_V, H_OUT, H_VIEWDIRS, H_HS, H_SLOT, H_NG };
// per-GEMM fields: weight and bias offsets, padded width, slices and source
// of its two input segments (source -1: none), ReLU
enum { G_W, G_B, G_NP, G_NS0, G_SRC0, G_NS1, G_SRC1, G_RELU };
enum { SRC_PTS, SRC_H, SRC_DIRS };
// narrow heads: weight and bias offsets, K, N
enum { N_ALPHA, N_RGB, N_OUTPUT };
enum { NW_W, NW_B, NW_K, NW_N };

struct Desc {
  long long hdr[16];
  long long gemm[MAX_GEMMS][8];
  long long narrow[3][4];
  signed char kind[MAX_EMB];    // per compact embedding column: 0 identity, 1 sin, 2 cos
};

struct Smem {
  float* h;          // [TP][HS]   activations
  float* raw;        // [TP][RAW_LD]
  float* rows;       // [TP x ROW] the encoder's record of each point
  float* ring;       // [R][SLOT]  weight slices
};

// SLOT: floats of the largest slice, 16 * max Np (two planes of 8 x Np);
// ROW: the encoder's floats a point
__host__ __device__ inline size_t smem_floats(int HS, int SLOT, int R, int ROW) {
  return (size_t)TP * (HS + RAW_LD + ROW) + (size_t)R * SLOT;
}

__device__ inline Smem carve(float* base, int HS, int ROW) {
  Smem s;
  s.h = base;
  s.raw = s.h + TP * HS;
  s.rows = s.raw + TP * RAW_LD;
  s.ring = s.rows + TP * ROW;
  return s;
}

__device__ inline void load_desc(Desc& d, const Desc* __restrict__ g) {
  const long long* src = reinterpret_cast<const long long*>(g);
  long long* dst = reinterpret_cast<long long*>(&d);
  for (int i = threadIdx.x; i < (int)(sizeof(Desc) / 8); i += NTHREADS)
    dst[i] = __ldg(src + i);
}

// ---- PTX ------------------------------------------------------------------

__device__ __forceinline__ unsigned to_tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small (+ a remainder of ~2^-22 |x|), both tf32
__device__ __forceinline__ void split(float x, unsigned& big, unsigned& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// d[0 .. N/2) = a (64 x 8, registers) * b (8 x N, shared memory) + d
// (scale_d 1) or + 0 (scale_d 0): one wgmma.mma_async of the warpgroup;
// completes at wgmma_wait. The tensor cores add the products to d without
// rounding to nearest: a running sum of many of them drifts (PERF.md,
// Findings), which mma_slice_rn avoids.
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  __device__ __forceinline__ static void run(float* d, const unsigned (&a)[4],
                                             unsigned long long b, int scale_d = 1) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<32> {
  __device__ __forceinline__ static void run(float* d, const unsigned (&a)[4],
                                             unsigned long long b, int scale_d = 1) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void run(float* d, const unsigned (&a)[4],
                                             unsigned long long b, int scale_d = 1) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  __device__ __forceinline__ static void run(float* d, const unsigned (&a)[4],
                                             unsigned long long b, int scale_d = 1) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

// the B operand descriptor: K-major, no swizzle, 128 bytes between the two
// k-halves of a column group (leading offset), 256 between column groups
// (stride offset), both in 16-byte units
__device__ __forceinline__ unsigned long long b_desc(const float* p) {
  return (unsigned long long)((smem_addr(p) & 0x3FFFF) >> 4) | (8ull << 16) | (16ull << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// wait until at most `pending` committed groups are still running
template <int pending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(pending) : "memory");
}

__device__ __forceinline__ void wgmma_commit_wait() {
  wgmma_commit();
  wgmma_wait<0>();
}

// keep the compiler from moving accumulator accesses across the MMAs
__device__ __forceinline__ void fence_acc(float (&acc)[2][NACC]) {
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int i = 0; i < NACC; ++i) asm volatile("" : "+f"(acc[m][i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void fence_part(float (&p)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(p[i]) :: "memory");
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(smem_addr(bar)),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(smem_addr(bar))
               : "memory");
}

// wait until the phase of parity `parity` of `bar` has completed; a phase
// that never completes (a fault in the ring) traps after ~2^24 tries, so
// the launch fails instead of hanging the card. tag (the producer's slice,
// or -1 - the consumer's) is printed with it.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity,
                                          int tag) {
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
    if (tries == (1 << 24)) {
      printf("mlp_tile_tc: mbarrier wait %d timed out (block %d, thread %d)\n", tag,
             (int)blockIdx.x, (int)threadIdx.x);
      __trap();
    }
  }
}

// one bulk copy global -> shared of `bytes` (a multiple of 16), completing
// on `bar`, which expects them
__device__ __forceinline__ void bulk_load(float* dst, const float* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

// ---- the weight ring --------------------------------------------------------

// Slots and their barriers live in shared memory; the cursors in each
// thread's registers. The consumer side (every warp) walks slices q = 0,
// 1, ...: slot q % R, its use (q / R) & 1 the parity to wait for. The
// producer (thread 0) walks the network's slices (gemm pg, slice ps) tile
// after tile (pk of the block's ntiles), R - 1 slices ahead.
struct Ring {
  float* slots;
  unsigned long long* full;
  unsigned long long* empty;
  int R, SLOT;
  int cslot, cphase, cq;        // consumer (cq: slices consumed)
  int pslot, pphase, pg, ps;    // producer
  long long pissued, pk, ntiles;
};

// thread 0: put the producer's next slice into its slot, first waiting
// until every warp has released the slice that slot held
__device__ inline void produce(Ring& r, const Desc& d, const float* __restrict__ wb) {
  if (r.pk >= r.ntiles) return;
  if (r.pissued >= r.R) mbar_wait(r.empty + r.pslot, r.pphase ^ 1, (int)r.pissued);
  const long long* G = d.gemm[r.pg];
  const unsigned floats = 16u * (unsigned)G[G_NP];
  bulk_load(r.slots + r.pslot * r.SLOT, wb + G[G_W] + (long long)r.ps * floats,
            floats * 4u, r.full + r.pslot);
  ++r.pissued;
  if (++r.pslot == r.R) {
    r.pslot = 0;
    r.pphase ^= 1;
  }
  if (++r.ps == (int)(G[G_NS0] + G[G_NS1])) {
    r.ps = 0;
    if (++r.pg == (int)d.hdr[H_NG]) {
      r.pg = 0;
      ++r.pk;
    }
  }
}

// Called by every thread; barriers are initialised before the block's first
// __syncthreads after this returns.
__device__ inline Ring start_ring(const Desc& d, const float* __restrict__ wb, float* slots,
                                  unsigned long long* bars, int R, long long ntiles) {
  Ring r;
  r.slots = slots;
  r.full = bars;
  r.empty = bars + MAX_SLOTS;
  r.R = R;
  r.SLOT = (int)d.hdr[H_SLOT];
  r.cslot = r.cphase = r.cq = r.pslot = r.pphase = r.pg = r.ps = 0;
  r.pissued = r.pk = 0;
  r.ntiles = ntiles;
  if (threadIdx.x == 0) {
    for (int i = 0; i < R; ++i) {
      mbar_init(r.full + i, 1);
      mbar_init(r.empty + i, NWARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int i = 0; i < R - 1; ++i) produce(r, d, wb);
  }
  return r;
}

// the consumer's next slice, once it has landed; thread 0 first refills
// the ring R - 1 slices ahead. The warp leaves converged (wgmma needs it).
__device__ __forceinline__ const float* acquire(Ring& r, const Desc& d,
                                               const float* __restrict__ wb) {
  if (threadIdx.x == 0) produce(r, d, wb);
  mbar_wait(r.full + r.cslot, r.cphase, -1 - r.cq);
  __syncwarp();
  return r.slots + r.cslot * r.SLOT;
}

// the warp is done with the consumer's slice
__device__ __forceinline__ void release(Ring& r) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(r.empty + r.cslot);
  ++r.cq;
  if (++r.cslot == r.R) {
    r.cslot = 0;
    r.cphase ^= 1;
  }
}

// ---- the encoders ------------------------------------------------------------

// Each encoder keeps a record of ROW floats for every point of the tile
// (row(), called for tile row p and flat point gp, rows at or past pend
// are empty) and forms the encoded input of compact embedding column cc
// from it (value(): the pre-sine argument, then identity, sin or cos by
// the descriptor's kind; finite on an empty row).

// Ray-major (B3, B4): the point of flat index gp = r * S + s is o + z·d on
// ray r, given as per-ray coefficients A = [o, dir]·F, B = [d, 0]·F
// [rays][EMB] and depths z [rays * S]. The record is the ray's row of A /
// B (r * EMB, an int64; -1 when empty) and the depth; the argument A + z·B
// is rounded exactly as f·(o + z·d) is for power-of-two f (no FMA
// contraction).
struct RayEnc {
  static constexpr int ROW = 3;
  const float* A;
  const float* B;
  const float* z;
  int S;

  __device__ __forceinline__ void row(const Desc& d, float* rows, int p, long long gp,
                                      long long pend) const {
    reinterpret_cast<long long*>(rows)[p] =
        gp < pend ? gp / S * (d.hdr[H_P] + d.hdr[H_V]) : -1;
    rows[2 * TP + p] = gp < pend ? __ldg(z + gp) : 0.f;
  }

  __device__ __forceinline__ float value(const Desc& d, const float* rows, int p,
                                         int cc) const {
    const long long ray = reinterpret_cast<const long long*>(rows)[p];
    if (ray < 0) return 0.f;
    const float arg = __fadd_rn(__ldg(A + ray + cc), __fmul_rn(rows[2 * TP + p], __ldg(B + ray + cc)));
    const int k = d.kind[cc];
    return k == 0 ? arg : (k == 1 ? sinf(arg) : cosf(arg));
  }
};

// Point-major (B1): points pts [total][3] and one view direction vd
// [total / S][3] for each ray of S points (null without a viewdir head).
// The record is the point and its ray's direction (zeros when empty), 7
// floats apart, so that a warp's reads of 8 rows x 3 inputs fall in
// distinct banks. Column cc reads input enc[MAX_EMB + cc] (0-2 the point,
// 3-5 the direction) and its argument is f·x with f = enc[cc], rounded
// once, as the plain embed's x * f is; identity columns give x itself.
struct PointEnc {
  static constexpr int ROW = 7;
  const float* pts;
  const float* vd;
  const float* enc;
  int S;

  __device__ __forceinline__ void row(const Desc&, float* rows, int p, long long gp,
                                      long long pend) const {
    float* x = rows + p * ROW;
    const bool in = gp < pend;
    for (int i = 0; i < 3; ++i) x[i] = in ? __ldg(pts + gp * 3 + i) : 0.f;
    for (int i = 0; i < 3; ++i) x[3 + i] = in && vd ? __ldg(vd + gp / S * 3 + i) : 0.f;
  }

  __device__ __forceinline__ float value(const Desc& d, const float* rows, int p,
                                         int cc) const {
    const float x = rows[p * ROW + (int)__ldg(enc + MAX_EMB + cc)];
    const int k = d.kind[cc];
    if (k == 0) return x;
    const float arg = __fmul_rn(__ldg(enc + cc), x);
    return k == 1 ? sinf(arg) : cosf(arg);
  }
};

// ---- the tile ---------------------------------------------------------------

// Encoded input of the point in tile row p at embedding column c of a
// segment (pts: compact columns [0, P); dirs: [P, P + V)), 0 on padding.
template <class Enc>
__device__ __forceinline__ float emb_at(const Desc& d, const Enc& e, const Smem& s, int p,
                                        int c, int base, int width) {
  return c < width ? e.value(d, s.rows, p, base + c) : 0.f;
}

// The warp's A fragments of one k-slice for m64 block m (rows 64 m + 16
// (warp % 4) + g (+ 8), columns k0 + t (+ 4)), split.
template <class Enc>
__device__ __forceinline__ void a_frag(const Desc& d, const Enc& e, const Smem& s, int src,
                                       int k0, int HS, int m, unsigned (&ab)[4],
                                       unsigned (&as)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r = 64 * m + 16 * ((threadIdx.x >> 5) & 3) + g;
  float v[4];
  if (src == SRC_H) {
    const float* a = s.h + r * HS + k0 + t;
    v[0] = a[0]; v[1] = a[8 * HS]; v[2] = a[4]; v[3] = a[8 * HS + 4];
  } else {
    const int P = (int)d.hdr[H_P], V = (int)d.hdr[H_V];
    const int base = src == SRC_PTS ? 0 : P, width = src == SRC_PTS ? P : V;
    v[0] = emb_at(d, e, s, r, k0 + t, base, width);
    v[1] = emb_at(d, e, s, r + 8, k0 + t, base, width);
    v[2] = emb_at(d, e, s, r, k0 + t + 4, base, width);
    v[3] = emb_at(d, e, s, r + 8, k0 + t + 4, base, width);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) split(v[i], ab[i], as[i]);
}

// the same for both m64 blocks
template <class Enc>
__device__ __forceinline__ void a_frags(const Desc& d, const Enc& e, const Smem& s, int src,
                                        int k0, int HS, unsigned (&ab)[2][4],
                                        unsigned (&as)[2][4]) {
#pragma unroll
  for (int m = 0; m < 2; ++m) a_frag(d, e, s, src, k0, HS, m, ab[m], as[m]);
}

// acc[m] += slice products for both m64 blocks: the warpgroup's N columns
// of the big plane at bb and the small plane at bs
template <int N>
__device__ __forceinline__ void mma_slice(float (&acc)[2][NACC], const unsigned (&ab)[2][4],
                                          const unsigned (&as)[2][4], unsigned long long bb,
                                          unsigned long long bs) {
  fence_acc(acc);
  wgmma_fence();
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    Wgmma<N>::run(acc[m], as[m], bb);
    Wgmma<N>::run(acc[m], ab[m], bs);
    Wgmma<N>::run(acc[m], ab[m], bb);
  }
  wgmma_commit_wait();
  fence_acc(acc);
}

// The same products as mma_slice, for B1, summed on the tensor cores per
// slice and m64 block from zero (the two small products first, then
// big·big) and added to acc on the CUDA cores, rounded to nearest. The
// tensor cores add without rounding to nearest, so a running sum over the
// whole K drifts toward zero; a slice's sum is ~1/6 of a column's total at
// K = 256, so what they drop there is that much smaller, and acc's own sum
// over the slices is unbiased. frag(m, ab, as) forms block m's A
// fragments; each of the G groups of N columns (tile_network: one group,
// the warpgroup's columns) waits for its MMAs and takes N / 2 registers a
// thread beside acc. The kernel sits at the 255-register cap, and ptxas's
// spills swing with the shape of this code: this form spills 96 bytes
// (chip_smoke.py phase 1) and runs B1 in 6.2 ms at 196,608 lego points on
// an H100; the same arithmetic without the G loop spilled more and ran
// far slower (PERF.md, Findings).
template <int N, int G, class Frag>
__device__ __forceinline__ void mma_slice_rn(float (&acc)[2][NACC], const Frag& frag,
                                             const float* big, const float* small) {
  float part[N / 2];
  unsigned ab[4], as[4];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    frag(m, ab, as);
#pragma unroll
    for (int h = 0; h < G; ++h) {
      const unsigned long long bb = b_desc(big + h * N * 8), bs = b_desc(small + h * N * 8);
      fence_part(part);
      wgmma_fence();
      Wgmma<N>::run(part, as, bb, 0);
      Wgmma<N>::run(part, ab, bs);
      Wgmma<N>::run(part, ab, bb);
      wgmma_commit_wait();
      fence_part(part);
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[m][h * (N / 2) + i] += part[i];
    }
  }
}

// h[row][col] = act(acc + bias[col]) over the thread's accumulators: the
// warpgroup's nh columns from n0
__device__ __forceinline__ void epilogue(const float (&acc)[2][NACC],
                                         const float* __restrict__ bias, bool relu,
                                         int nh, int n0, float* h, int HS) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * ((threadIdx.x >> 5) & 3) + g;
#pragma unroll
  for (int j = 0; j < NACC / 4; ++j) {
    if (8 * j < nh) {
      const int col = n0 + 8 * j + 2 * t;
      const float b0 = __ldg(bias + col), b1 = __ldg(bias + col + 1);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int r = 64 * m + r0;
        float v0 = acc[m][4 * j] + b0, v1 = acc[m][4 * j + 1] + b1;
        float v2 = acc[m][4 * j + 2] + b0, v3 = acc[m][4 * j + 3] + b1;
        if (relu) {
          v0 = fmaxf(v0, 0.f); v1 = fmaxf(v1, 0.f);
          v2 = fmaxf(v2, 0.f); v3 = fmaxf(v3, 0.f);
        }
        *reinterpret_cast<float2*>(h + r * HS + col) = make_float2(v0, v1);
        *reinterpret_cast<float2*>(h + (r + 8) * HS + col) = make_float2(v2, v3);
      }
    }
  }
}

// A narrow head (N <= RAW_LD) in fp32 on the CUDA cores: one warp per
// (point, output), the lanes split K and reduce with shuffles. Weights
// [N][K]. Writes raw[p][col_off + o].
__device__ __forceinline__ void narrow(const long long* Nh, const float* __restrict__ wb,
                                       const float* src, int ss, float* raw, int col_off) {
  const float* __restrict__ w = wb + Nh[NW_W];
  const float* __restrict__ bias = wb + Nh[NW_B];
  const int K = (int)Nh[NW_K], N = (int)Nh[NW_N], lane = threadIdx.x & 31;
  for (int pair = threadIdx.x >> 5; pair < TP * N; pair += NWARPS) {
    const int p = pair / N, o = pair - p * N;
    float s = 0.f;
    for (int k = lane; k < K; k += 32)
      s = fmaf(src[p * ss + k], __ldg(w + (size_t)o * K + k), s);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) raw[p * RAW_LD + col_off + o] = s + __ldg(bias + o);
  }
}

// Each tile row's record: the encoder's for point p0 + p; rows at or past
// pend are empty.
template <class Enc>
__device__ inline void tile_rows(const Desc& d, const Enc& e, long long p0, long long pend,
                                 const Smem& s) {
  for (int p = threadIdx.x; p < TP; p += NTHREADS) e.row(d, s.rows, p, p0 + p, pend);
}

// The whole network on the tile whose rows tile_rows set -> s.raw (cols
// 0..2 rgb logits, col 3 sigma; or output_ch columns without viewdirs).
// Starts and ends with a barrier.
template <class Enc, bool kSliceSums = false>
__device__ inline void tile_network(const Desc& d, const float* __restrict__ wb, const Enc& e,
                                    const Smem& s, Ring& r) {
  const int D = (int)d.hdr[H_D], NG = (int)d.hdr[H_NG], HS = (int)d.hdr[H_HS];
  const bool viewdirs = d.hdr[H_VIEWDIRS] != 0;
  const int wg = threadIdx.x >> 7;
  float acc[2][NACC];

  __syncthreads();   // the tile's rows are set
  for (int gi = 0; gi < NG; ++gi) {
    const long long* G = d.gemm[gi];
    const int np = (int)G[G_NP], nh = np >> 1, n0 = wg * nh;
    const int ns0 = (int)G[G_NS0], ns = ns0 + (int)G[G_NS1];
    const int src0 = (int)G[G_SRC0], src1 = (int)G[G_SRC1];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int i = 0; i < NACC; ++i) acc[m][i] = 0.f;
    for (int i = 0; i < ns; ++i) {
      const float* slice = acquire(r, d, wb);
      const bool first = i < ns0;
      const int src = first ? src0 : src1, k0 = (first ? i : i - ns0) * SLICE_K;
      // the warpgroup's columns: n0 / 8 column groups of 256 bytes in
      const float* big = slice + n0 * 8;
      const float* small = slice + 8 * np + n0 * 8;
      if (kSliceSums) {
        const auto frag = [&](int m, unsigned (&fb)[4], unsigned (&fs)[4]) {
          a_frag(d, e, s, src, k0, HS, m, fb, fs);
        };
        switch (nh) {
          case 128: mma_slice_rn<128, 1>(acc, frag, big, small); break;
          case 64: mma_slice_rn<64, 1>(acc, frag, big, small); break;
          case 32: mma_slice_rn<32, 1>(acc, frag, big, small); break;
          default: mma_slice_rn<16, 1>(acc, frag, big, small); break;
        }
      } else {
        unsigned ab[2][4], as[2][4];
        a_frags(d, e, s, src, k0, HS, ab, as);
        const unsigned long long bb = b_desc(big), bs = b_desc(small);
        switch (nh) {
          case 128: mma_slice<128>(acc, ab, as, bb, bs); break;
          case 64: mma_slice<64>(acc, ab, as, bb, bs); break;
          case 32: mma_slice<32>(acc, ab, as, bb, bs); break;
          default: mma_slice<16>(acc, ab, as, bb, bs); break;
        }
      }
      release(r);
    }
    __syncthreads();   // every warp is done reading h before it is overwritten
    epilogue(acc, wb + G[G_B], G[G_RELU] != 0, nh, n0, s.h, HS);
    __syncthreads();
    if (gi == D - 1) {
      if (viewdirs)
        narrow(d.narrow[N_ALPHA], wb, s.h, HS, s.raw, 3);
      else
        narrow(d.narrow[N_OUTPUT], wb, s.h, HS, s.raw, 0);
    }
  }
  if (viewdirs) narrow(d.narrow[N_RGB], wb, s.h, HS, s.raw, 0);
  __syncthreads();
}

// The ring depth that fits the block's shared memory (its encoder keeping
// ROW floats a point) and the bytes it needs; 0 on success.
inline int plan(const void* kernel, int HS, int SLOT, int ROW, int* R, size_t* bytes,
                int* sms) {
  int dev, optin;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  cudaFuncAttributes fa;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kernel);
  if (e != cudaSuccess) return (int)e;
  const long long avail = (long long)optin - (long long)fa.sharedSizeBytes;
  const long long r = (avail - 4LL * smem_floats(HS, SLOT, 0, ROW)) / (4LL * SLOT);
  if (r < 2) return (int)cudaErrorInvalidConfiguration;
  *R = (int)(r < MAX_SLOTS ? r : MAX_SLOTS);
  *bytes = 4 * smem_floats(HS, SLOT, *R, ROW);
  return 0;
}

}  // namespace tc
}  // namespace nstt
