// The NeRF MLP in bf16 on one tile of 128 sample points, designed for
// Hopper: the network of the bf16 kernels B1 (fused_mlp.cu
// nerf_points_bf16_kernel), B3 (nerf_rays_bf16_kernel) and B4
// (fused_render.cu nerf_render_bf16_kernel), under --precision bf16.
//
// Arithmetic: that of the JAX bf16 kernels
// (nerf_shared_tpu/ops/pallas/fused_mlp.py _mlp_out_value). Every GEMM runs
// on wgmma.mma_async.m64nNk16.f32.bf16.bf16 with bf16 operands and fp32
// accumulators; the k16 products of a GEMM chain into one accumulator in
// the order of its 16-row weight slices; the epilogue adds the fp32 bias,
// applies the ReLU and rounds h, the feature and hv to bf16 (to nearest,
// ties to even); the encoder's outputs are formed in fp32 by the encoders
// of mlp_tile_tc.cuh and rounded to bf16; the narrow heads (alpha, rgb,
// output_ch <= 8) run in fp32 on the CUDA cores on the bf16 values, a warp
// per (point, output) with the lanes splitting K, in the summation order of
// mlp_tile_tc.cuh's narrow().
//
// What bounds it on an H100: operations, ~1.19 MFLOP a point at the lego
// width against a few bytes of input and 16 of output; FLOPs over the 989
// TFLOP/s bf16 rate. What the design does about it:
//
// - Warp specialisation. A block is three warpgroups: one producer thread
//   (in the third, which gives its registers up with setmaxnreg) keeps the
//   weight ring's bulk copies in flight; the two consumer warpgroups (which
//   take the registers) run the MMAs.
// - One 64-point pipeline per consumer warpgroup. Warpgroup w owns rows
//   [64 w, 64 w + 64) of the tile and every padded column of each GEMM:
//   one m64nNk16 a 16-row slice, N = Np <= 256, 128 fp32 accumulators a
//   thread. It waits only on its own warps (a 128-thread named barrier)
//   between layers, so the two warpgroups may drift apart by up to the
//   ring's depth. (On an H100 they mostly run in step, both on the CUDA
//   cores and then both on the tensor cores: PERF.md, Findings. Forcing turns
//   on the tensor cores, by named barriers or mbarriers, made ptxas
//   serialise every wgmma, C7520.)
// - A from shared memory. The activations h and the encoded inputs live in
//   bf16 in shared memory in wgmma's K-major core-matrix layout without
//   swizzle (operand_offset below; the weight slices' layout of
//   ops/cuda/fused_mlp.py slice_index_bf16, rows for columns), and wgmma
//   reads them by descriptor: no A fragment is built in registers. The
//   epilogue writes its bf16 outputs straight into that layout.
// - The encoder once per tile: [pts_emb, dirs_emb] of each point is formed
//   once into a bf16 block that layer 0, the skip layer and the views
//   layer read by descriptor.
// - Stages of up to 64 weight rows. A GEMM's 16-row slices lie one after
//   another in the pack, so up to STAGE_SLICES of them go in one bulk copy
//   under one full / empty mbarrier pair (a GEMM's last stage may be
//   shorter). A warpgroup issues a stage's products back to back and keeps
//   one stage in flight (wgmma.wait_group 1): it frees a slot once the
//   MMAs that read it have retired. A slot is free when all eight consumer
//   warps have released it. The ring runs on from layer to layer and from
//   tile to tile.
//
// The weight pack is pack_network_tc(..., torch.bfloat16)'s, unchanged
// (B2 bf16 reads the same buffer): each GEMM a [Kp][Np] bf16 matrix as
// consecutive 16-row slices of 32 Np bytes, biases fp32, the narrow heads
// [N][K] rounded to bf16 values in fp32.
#pragma once

#include "mlp_tile_tc.cuh"

namespace nstt {
namespace bf16 {

using tc::Desc;
using tc::RAW_LD;
using tc::TP;

constexpr int NCONS = 256;              // two consumer warpgroups
constexpr int NTHREADS = NCONS + 128;   // and the producer's warpgroup
constexpr int NCWARPS = NCONS / 32;     // consumer warps: a slot's releases
constexpr int WG_ROWS = 64;             // tile rows a consumer warpgroup owns
constexpr int STAGE_SLICES = 4;         // 16-row slices a stage: 64 weight rows
constexpr int MAX_STAGES = 8;
constexpr int NACC = 128;               // accumulators a thread (N <= 256)
constexpr int CORE = 128;               // bytes of a core matrix: 8 rows x 16 bytes
constexpr int KCHUNK = WG_ROWS * 16;    // bytes between two 8-column chunks of a block
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;

// Byte offset of (row p < 64, column k) in a warpgroup's operand block:
// 8-column chunks KCHUNK bytes apart, 8-row core matrices CORE bytes apart
// within a chunk, a row's 8 values in 16 bytes. wgmma's K-major layout
// without swizzle, its leading offset KCHUNK and its stride offset CORE.
__host__ __device__ constexpr int operand_offset(int p, int k) {
  return (k >> 3) * KCHUNK + (p >> 3) * CORE + (p & 7) * 16 + (k & 7) * 2;
}

// the descriptor of an operand block's 64 x 16 sub-block at p (16-byte
// aligned shared memory)
__device__ __forceinline__ unsigned long long a_desc(const void* p) {
  return (unsigned long long)((tc::smem_addr(p) & 0x3FFFF) >> 4) |
         ((unsigned long long)(KCHUNK >> 4) << 16) | ((unsigned long long)(CORE >> 4) << 32);
}

__host__ __device__ constexpr int round16(int n) { return (n + 15) / 16 * 16; }

// columns of the encoded-input block: the points' P padded to 16, then
// (with a viewdir head) the directions' V padded to 16
__host__ __device__ constexpr int emb_cols(int P, int V, bool viewdirs) {
  return round16(P) + (viewdirs ? round16(V) : 0);
}

// ---- PTX --------------------------------------------------------------------

// d[0 .. N/2) += a (64 x 16 bf16, shared memory) * b (16 x N bf16, shared
// memory), both K-major: one wgmma.mma_async of the warpgroup
template <int N>
struct WgmmaSS;

template <>
struct WgmmaSS<32> {
  __device__ __forceinline__ static void run(float* d, unsigned long long a,
                                             unsigned long long b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaSS<64> {
  __device__ __forceinline__ static void run(float* d, unsigned long long a,
                                             unsigned long long b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaSS<128> {
  __device__ __forceinline__ static void run(float* d, unsigned long long a,
                                             unsigned long long b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaSS<256> {
  __device__ __forceinline__ static void run(float* d, unsigned long long a,
                                             unsigned long long b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(1));
  }
};

// keep the compiler from moving accesses to the first N / 2 accumulators
// across the MMAs
template <int N>
__device__ __forceinline__ void fence_acc(float (&acc)[NACC]) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) asm volatile("" : "+f"(acc[i]) :: "memory");
}

// wait until the phase of parity `parity` of `bar` has completed; a phase
// that never completes (a fault in the ring) traps after ~2^26 tries. No
// printf: an extern call in the kernel makes ptxas serialise its wgmma.
__device__ __forceinline__ void wait_parity(unsigned long long* bar, unsigned parity) {
  const unsigned addr = tc::smem_addr(bar);
  for (int tries = 0;; ++tries) {
    unsigned done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n" : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (tries == (1 << 26)) __trap();
  }
}

// the 128 threads of consumer warpgroup wg (named barrier 1 + wg), or the
// 256 of both (named barrier 3)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;" :: "r"(1 + wg) : "memory");
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 3, 256;" ::: "memory");
}

// this thread's generic-proxy shared-memory writes, visible to wgmma's
// reads (the async proxy) after the next barrier
__device__ __forceinline__ void fence_to_mma() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// ---- the weight ring ----------------------------------------------------------

// Slots of up to STAGE_SLICES slices of the widest GEMM, and their
// barriers, in shared memory; each side keeps its own cursor: the slot of
// its next stage and that slot's use parity. Both sides walk the same
// sequence: for each tile, each GEMM, its stages.
struct Ring {
  float* slots;
  unsigned long long* full;    // completes when a stage's bytes land
  unsigned long long* empty;   // completes when all NCWARPS warps release it
  int R, STAGE;                // slots, floats a slot
  int slot, phase;
};

__device__ __forceinline__ void advance(Ring& r) {
  if (++r.slot == r.R) {
    r.slot = 0;
    r.phase ^= 1;
  }
}

// The producer (one thread): every stage of the network for each of the
// block's ntiles tiles, each into its slot once the consumers released
// the stage that slot held before.
__device__ inline void produce_all(const Desc& d, const float* __restrict__ wb, Ring r,
                                   long long ntiles) {
  const int NG = (int)d.hdr[tc::H_NG];
  long long issued = 0;
  for (long long t = 0; t < ntiles; ++t) {
    for (int g = 0; g < NG; ++g) {
      const long long* G = d.gemm[g];
      const int ns = (int)(G[tc::G_NS0] + G[tc::G_NS1]);
      const unsigned slice = 8u * (unsigned)G[tc::G_NP];   // floats of a 16-row slice
      for (int s0 = 0; s0 < ns; s0 += STAGE_SLICES) {
        const int n = min(STAGE_SLICES, ns - s0);
        if (issued >= r.R) wait_parity(r.empty + r.slot, r.phase ^ 1);
        tc::bulk_load(r.slots + r.slot * r.STAGE, wb + G[tc::G_W] + (long long)s0 * slice,
                      (unsigned)n * slice * 4u, r.full + r.slot);
        ++issued;
        advance(r);
      }
    }
  }
}

// this warp is done with the stage in `slot`
__device__ __forceinline__ void release(const Ring& r, int slot) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) tc::mbar_arrive(r.empty + slot);
}

// ---- shared memory --------------------------------------------------------------

// The block's dynamic shared memory: the ring, then each consumer
// warpgroup's activations (64 x HW bf16) and encoded inputs (64 x E bf16)
// as operand blocks, the raw outputs and the encoder's rows (fp32).
struct Smem {
  float* ring;
  char* h;       // [2][64 x HW] bf16 operand blocks
  char* emb;     // [2][64 x E] bf16 operand blocks
  float* raw;    // [TP][RAW_LD]
  float* rows;   // [TP x ROW]
  int HW, E;
};

__host__ __device__ inline size_t smem_bytes(int R, int SLOT, int HW, int E, int ROW) {
  return (size_t)R * STAGE_SLICES * SLOT * 4 + (size_t)TP * (HW + E) * 2 +
         (size_t)TP * (RAW_LD + ROW) * 4;
}

__device__ inline Smem carve(float* base, int R, int SLOT, int HW, int E) {
  Smem s;
  s.ring = base;
  s.h = reinterpret_cast<char*>(base + (size_t)R * STAGE_SLICES * SLOT);
  s.emb = s.h + (size_t)TP * HW * 2;
  s.raw = reinterpret_cast<float*>(s.emb + (size_t)TP * E * 2);
  s.rows = s.raw + TP * RAW_LD;
  s.HW = HW;
  s.E = E;
  return s;
}

// ---- a consumer warpgroup's pass over its 64 rows of a tile -----------------------

// One GEMM of N = Np columns over the warpgroup's rows: acc = A W, the
// stages taken from the ring in order, each stage's k16 products issued
// back to back into acc, one stage left in flight while the next is
// waited for and issued; each slot released once its MMAs retired. A
// segment's operand block: SRC_H the activations, SRC_PTS / SRC_DIRS the
// encoded inputs' points / directions columns. Slice i's A sub-block is
// at descriptor a0 + 128 i (its first segment, i < ns0) or a1 + 128 (i -
// ns0): a k16 step is 2 KCHUNK bytes, 128 in the descriptor's 16-byte
// units; slice j of a stage at b + 2 N j (a 16-row slice is 32 N bytes).
template <int N>
__device__ __forceinline__ void gemm(float (&acc)[NACC], const long long* G, Ring& r,
                                     const char* h, const char* pts, const char* dirs) {
  const int ns0 = (int)G[tc::G_NS0], ns = ns0 + (int)G[tc::G_NS1];
  const int src0 = (int)G[tc::G_SRC0], src1 = (int)G[tc::G_SRC1];
  const unsigned long long a0 =
      a_desc(src0 == tc::SRC_H ? h : (src0 == tc::SRC_PTS ? pts : dirs));
  const unsigned long long a1 =
      a_desc(src1 == tc::SRC_H ? h : (src1 == tc::SRC_PTS ? pts : dirs));
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  fence_acc<N>(acc);
  int prev = -1;
  for (int s0 = 0; s0 < ns; s0 += STAGE_SLICES) {
    const int n = min(STAGE_SLICES, ns - s0);
    wait_parity(r.full + r.slot, r.phase);
    __syncwarp();   // wgmma wants the warp converged
    const unsigned long long b = tc::b_desc(r.slots + r.slot * r.STAGE);
    tc::wgmma_fence();
#pragma unroll
    for (int j = 0; j < STAGE_SLICES; ++j) {
      if (j < n) {
        const int i = s0 + j;
        const unsigned long long a = i < ns0 ? a0 + 128ull * i : a1 + 128ull * (i - ns0);
        WgmmaSS<N>::run(acc, a, b + 2ull * N * j);
      }
    }
    tc::wgmma_commit();
    tc::wgmma_wait<1>();   // the previous stage's MMAs have retired
    if (prev >= 0) release(r, prev);
    prev = r.slot;
    advance(r);
  }
  tc::wgmma_wait<0>();
  fence_acc<N>(acc);
  release(r, prev);
}

// h = act(acc + bias) rounded to bf16, into the warpgroup's operand block:
// the thread's accumulators of rows 16 (warp % 4) + g (+ 8), columns 8 j +
// 2 t (+ 1); the bias pairs of eight column groups loaded before their
// stores, so that their latencies overlap.
template <int N>
__device__ __forceinline__ void epilogue(const float (&acc)[NACC], const float* __restrict__ bias,
                                         bool relu, char* h) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r = 16 * ((threadIdx.x >> 5) & 3) + g;
  constexpr int JC = N / 8 < 8 ? N / 8 : 8;
#pragma unroll
  for (int j0 = 0; j0 < N / 8; j0 += JC) {
    float2 b[JC];
#pragma unroll
    for (int j = 0; j < JC; ++j)
      b[j] = __ldg(reinterpret_cast<const float2*>(bias + 8 * (j0 + j) + 2 * t));
#pragma unroll
    for (int jj = 0; jj < JC; ++jj) {
      const int j = j0 + jj, col = 8 * j + 2 * t;
      float v0 = acc[4 * j] + b[jj].x, v1 = acc[4 * j + 1] + b[jj].y;
      float v2 = acc[4 * j + 2] + b[jj].x, v3 = acc[4 * j + 3] + b[jj].y;
      if (relu) {
        v0 = fmaxf(v0, 0.f); v1 = fmaxf(v1, 0.f);
        v2 = fmaxf(v2, 0.f); v3 = fmaxf(v3, 0.f);
      }
      *reinterpret_cast<unsigned*>(h + operand_offset(r, col)) = tc::pack_bf16x2(v0, v1);
      *reinterpret_cast<unsigned*>(h + operand_offset(r + 8, col)) = tc::pack_bf16x2(v2, v3);
    }
  }
}

// one level of the lanes' butterfly over 32 chains held by one thread:
// chain l + OFF into chain l (the sum the two lanes hold after their
// shuffle; fp32 addition commutes, so it is the same value)
template <int OFF>
__device__ __forceinline__ void tree_sum(float (&s)[32]) {
#pragma unroll
  for (int l = 0; l < OFF; ++l) s[l] += s[l + OFF];
}

// A narrow head (N <= RAW_LD, K <= 256) over the warpgroup's 64 rows,
// fp32 on the CUDA cores, each (point, output) the value tc::narrow forms:
// 32 fmaf chains over k = l, l + 32, ... (l < 32), combined as the lanes'
// butterfly combines them (xor 16, 8, 4, 2, 1), plus the bias. Here one
// thread forms a pair's 32 chains and combines them in that tree, so the
// value is the same; a warp's lanes are 32 points of one output, reading
// their rows of h in 16-byte runs (no bank conflict) and the same weights.
// Writes raw[row0 + p][col_off + o].
__device__ __forceinline__ void head(const long long* Nh, const float* __restrict__ wb,
                                     const char* h, float* raw, int row0, int col_off) {
  const float* __restrict__ w = wb + Nh[tc::NW_W];
  const float* __restrict__ bias = wb + Nh[tc::NW_B];
  const int K = (int)Nh[tc::NW_K], N = (int)Nh[tc::NW_N];
  for (int pair = threadIdx.x & 127; pair < WG_ROWS * N; pair += 128) {
    const int o = pair / WG_ROWS, p = pair % WG_ROWS;
    const float* __restrict__ wo = w + (size_t)o * K;
    float s[32];
#pragma unroll
    for (int l = 0; l < 32; ++l) s[l] = 0.f;
    for (int k0 = 0; k0 < K; k0 += 32) {   // a round: column k0 + l feeds chain l
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (k0 + 8 * c < K) {
          const uint4 v = *reinterpret_cast<const uint4*>(h + operand_offset(p, k0 + 8 * c));
          const unsigned u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const int l = 8 * c + q;
            const float x = __uint_as_float(q & 1 ? u[q >> 1] & 0xFFFF0000u : u[q >> 1] << 16);
            if (k0 + l < K) s[l] = fmaf(x, __ldg(wo + k0 + l), s[l]);
          }
        }
      }
    }
    tree_sum<16>(s);
    tree_sum<8>(s);
    tree_sum<4>(s);
    tree_sum<2>(s);
    tree_sum<1>(s);
    raw[(row0 + p) * RAW_LD + col_off + o] = s[0] + __ldg(bias + o);
  }
}

// The encoder once per tile: the records of the warpgroup's rows of the
// tile at p0 (rows at or past pend empty), then their encoded inputs
// [pts_emb, dirs_emb], rounded to bf16, into its operand block. Thread
// (point pl, half) forms every other 8-column chunk of its point and
// stores it as one core-matrix row (16 bytes): a warp's lanes are 32
// points at the same columns, so sin / cos do not diverge and a quarter
// warp's stores fill one core matrix.
template <class Enc>
__device__ __forceinline__ void encode(const Desc& d, const Enc& e, const Smem& s, int wg,
                                       long long p0, long long pend) {
  const int tid = threadIdx.x & 127;
  if (tid < WG_ROWS) e.row(d, s.rows, WG_ROWS * wg + tid, p0 + WG_ROWS * wg + tid, pend);
  wg_sync(wg);
  const int P = (int)d.hdr[tc::H_P], V = (int)d.hdr[tc::H_V], P16 = round16(P);
  char* eb = s.emb + (size_t)wg * WG_ROWS * s.E * 2;
  const int pl = tid & (WG_ROWS - 1), p = WG_ROWS * wg + pl;
  for (int kc = tid >> 6; kc < (s.E >> 3); kc += 2) {
    int cc[8];
    float a[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {   // every argument's loads first
      const int k = 8 * kc + c;
      cc[c] = k < P16 ? (k < P ? k : -1) : (k - P16 < V ? P + k - P16 : -1);
      a[c] = cc[c] < 0 ? 0.f : e.arg(d, s.rows, p, cc[c]);
    }
    unsigned pk[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float v0 = cc[2 * c] < 0 ? 0.f : e.finish(d, s.rows, p, cc[2 * c], a[2 * c]);
      const float v1 =
          cc[2 * c + 1] < 0 ? 0.f : e.finish(d, s.rows, p, cc[2 * c + 1], a[2 * c + 1]);
      pk[c] = tc::pack_bf16x2(v0, v1);
    }
    *reinterpret_cast<uint4*>(eb + operand_offset(pl, 8 * kc)) =
        make_uint4(pk[0], pk[1], pk[2], pk[3]);
  }
  fence_to_mma();
  wg_sync(wg);
}

// The network over warpgroup wg's rows of the tile at p0 -> s.raw rows
// [64 wg, 64 wg + 64) (cols 0..2 rgb logits, col 3 sigma; or output_ch
// columns without viewdirs). Ends with a barrier of the warpgroup.
template <class Enc>
__device__ inline void tile(const Desc& d, const float* __restrict__ wb, const Enc& e,
                            const Smem& s, Ring& r, int wg, long long p0, long long pend) {
  const int D = (int)d.hdr[tc::H_D], NG = (int)d.hdr[tc::H_NG];
  const bool viewdirs = d.hdr[tc::H_VIEWDIRS] != 0;
  char* h = s.h + (size_t)wg * WG_ROWS * s.HW * 2;
  const char* pts = s.emb + (size_t)wg * WG_ROWS * s.E * 2;
  const char* dirs = pts + (round16((int)d.hdr[tc::H_P]) >> 3) * KCHUNK;
  float acc[NACC];
  encode(d, e, s, wg, p0, pend);
  for (int gi = 0; gi < NG; ++gi) {
    const long long* G = d.gemm[gi];
    const int np = (int)G[tc::G_NP];
    const float* bias = wb + G[tc::G_B];
    const bool relu = G[tc::G_RELU] != 0;
    switch (np) {
      case 256: gemm<256>(acc, G, r, h, pts, dirs); break;
      case 128: gemm<128>(acc, G, r, h, pts, dirs); break;
      case 64: gemm<64>(acc, G, r, h, pts, dirs); break;
      default: gemm<32>(acc, G, r, h, pts, dirs); break;
    }
    wg_sync(wg);   // every warp's MMAs have read h before it is overwritten
    switch (np) {
      case 256: epilogue<256>(acc, bias, relu, h); break;
      case 128: epilogue<128>(acc, bias, relu, h); break;
      case 64: epilogue<64>(acc, bias, relu, h); break;
      default: epilogue<32>(acc, bias, relu, h); break;
    }
    fence_to_mma();
    wg_sync(wg);
    if (gi == D - 1)
      head(d.narrow[viewdirs ? tc::N_ALPHA : tc::N_OUTPUT], wb, h, s.raw, WG_ROWS * wg,
           viewdirs ? 3 : 0);
  }
  if (viewdirs) head(d.narrow[tc::N_RGB], wb, h, s.raw, WG_ROWS * wg, 0);
  wg_sync(wg);
}

// ---- the block ------------------------------------------------------------------

// Every thread: the descriptor into shared memory, the ring's barriers,
// the carve. Then the producer warpgroup gives up its registers, its
// first thread streams the weights of ntiles tiles, and it returns false;
// the consumers take the registers and get true. Traps if the host's
// encoded-input width E is not the descriptor's.
__device__ inline bool start(Desc& d, const Desc* __restrict__ gdesc,
                             const float* __restrict__ wb, unsigned long long* bars,
                             float* dyn, int R, int SLOT, int E, long long ntiles, Smem& s,
                             Ring& r) {
  {
    const long long* src = reinterpret_cast<const long long*>(gdesc);
    long long* dst = reinterpret_cast<long long*>(&d);
    for (int i = threadIdx.x; i < (int)(sizeof(Desc) / 8); i += NTHREADS) dst[i] = __ldg(src + i);
  }
  r.slots = dyn;
  r.full = bars;
  r.empty = bars + MAX_STAGES;
  r.R = R;
  r.STAGE = STAGE_SLICES * SLOT;
  r.slot = r.phase = 0;
  if (threadIdx.x == 0) {
    for (int i = 0; i < R; ++i) {
      tc::mbar_init(r.full + i, 1);
      tc::mbar_init(r.empty + i, NCWARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (E != emb_cols((int)d.hdr[tc::H_P], (int)d.hdr[tc::H_V], d.hdr[tc::H_VIEWDIRS] != 0))
    __trap();
  s = carve(dyn, R, SLOT, SLOT / 8, E);
  if (threadIdx.x >= NCONS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" :: "n"(PRODUCER_REGS));
    if (threadIdx.x == NCONS) produce_all(d, wb, r, ntiles);
    return false;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" :: "n"(CONSUMER_REGS));
  return true;
}

// The ring depth that fits the block's shared memory and the bytes it
// needs (SLOT: floats of the widest GEMM's 16-row slice, 8 Np; E the
// encoded inputs' columns; ROW the encoder's floats a point); 0 on success.
inline int plan(const void* kernel, int SLOT, int E, int ROW, int* R, size_t* bytes, int* sms) {
  int dev, optin;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  cudaFuncAttributes fa;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kernel);
  if (e != cudaSuccess) return (int)e;
  const long long avail = (long long)optin - (long long)fa.sharedSizeBytes;
  const long long fixed = (long long)smem_bytes(0, SLOT, SLOT / 8, E, ROW);
  const long long r = (avail - fixed) / (4LL * STAGE_SLICES * SLOT);
  if (r < 2) return (int)cudaErrorInvalidConfiguration;
  *R = (int)(r < MAX_STAGES ? r : MAX_STAGES);
  *bytes = smem_bytes(*R, SLOT, SLOT / 8, E, ROW);
  return 0;
}

}  // namespace bf16
}  // namespace nstt
