// Row gather (kernel P1) and row scatter-add (kernel P2) of a [T, w] fp32
// feature table: the encode of the grid model families (hashgrid tables,
// triplane planes) and its backward.
//
// Replaces the TPU kernels of benchmarks/scatter_probe.py: pgather_kernel
// (P1, out[r, :] = table[idx[r], :]) and pscat_kernel (P2, the table
// gradient out = zeros[T, w].at[idx].add(upd)). The Pallas P2 body
// `o_ref[i_ref[:], :] += u_ref[:]` keeps only the last of equal indices
// inside one block; this P2 adds every row, which is what the probe's own
// reference and every hashgrid / triplane backward compute.
//
// What bounds them on an H100: bytes. Each moves R·w·4 B of rows and R·4 B
// of indices, and reads (P1: the rows its indices name) or writes (P2: all
// T) the table once, with no arithmetic to speak of. A random row costs at
// least one 32-byte sector whatever w is, and P2's adds are read-modify-
// writes in L2 on top of its bytes.
//
// What the design does about it:
// - Compile-time widths. w = 1, 2, 4 take a row a thread (one scalar,
//   float2 or float4 load and store); w = 8, 16, 32, 64 take w / 4 lanes a
//   row, a power of two, so the row and piece of a thread are a shift and a
//   mask; any other width, or a table not aligned for vectors, takes the
//   generic kernels (a thread a row in P1, a warp a row in P2). No 64-bit
//   division runs in any loop: blocks and warps stride over tiles of rows
//   whose count the host computes. Row offsets stay 64-bit (a vertex-layout
//   serving block gathers over 10^9 rows).
// - P1 keeps several independent row reads in flight a thread (8 rows at
//   w <= 4, 4 rows above) before its stores, reads the table through the
//   read-only path (__ldg), streams the indices in (__ldcs) and the output
//   out (__stcs), so neither evicts the table from the 50 MB L2.
// - P2 zeroes the output on the stream, then each warp takes 32 consecutive
//   rows, groups equal indices with __match_any_sync and sums each group on
//   chip before one vector atomic (float2 / float4 `red` in L2, sm_90) per
//   group and 16-byte piece: rows that fit a lane are summed by shuffles
//   into the group's first lane; wider rows are walked by w / 4 lanes a
//   group, member by member, with coalesced 16-byte loads. The grid paths'
//   indices repeat in runs (consecutive samples of a ray fall in one cell),
//   which the merge folds; with all-distinct indices it costs the match.
//   The vertex layout (w = 2) puts equal indices 128 rows apart, out of a
//   warp's sight: its P2 merges a 1024-row tile per block in a shared-memory
//   hash keyed by row, then sends each distinct row of the tile to L2 once.
// P1 clamps each index into [0, T) (jnp.take's mode="clip"), so it never
// reads outside the table; P2 clamps likewise. The callers build indices in
// range (clamped cells, masked hashes) and the plain versions assert that.
// P2's sums run in an order that varies from run to run (atomics), so its
// last bits do too; a deterministic P2 is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace nstt {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr long long MAX_BLOCKS = 132LL * 16;  // 16 blocks an SM, then tiles stride

__device__ __forceinline__ int clamp_row(int i, int T) {
  return i < 0 ? 0 : (i >= T ? T - 1 : i);
}

// a row of W <= 4 floats in one register
template <int W> struct Row;
template <> struct Row<1> { using V = float; };
template <> struct Row<2> { using V = float2; };
template <> struct Row<4> { using V = float4; };

__device__ __forceinline__ float add(float a, float b) { return a + b; }
__device__ __forceinline__ float2 add(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float shfl(float v, int src) {
  return __shfl_sync(FULL, v, src);
}
__device__ __forceinline__ float2 shfl(float2 v, int src) {
  return make_float2(__shfl_sync(FULL, v.x, src), __shfl_sync(FULL, v.y, src));
}
__device__ __forceinline__ float4 shfl(float4 v, int src) {
  return make_float4(__shfl_sync(FULL, v.x, src), __shfl_sync(FULL, v.y, src),
                     __shfl_sync(FULL, v.z, src), __shfl_sync(FULL, v.w, src));
}

// ---------------------------------------------------------------- P1 --------

// w = W <= 4: a thread a row, U rows in flight; a block takes THREADS·U rows
// a tile, a thread rows t, t + THREADS, ... (coalesced index loads and
// output stores)
template <int W, int U>
__global__ void __launch_bounds__(THREADS)
p1_gather_rows_narrow(const typename Row<W>::V* __restrict__ table,
                      const int* __restrict__ idx, typename Row<W>::V* __restrict__ out,
                      long long R, int T, long long n_tiles) {
  using V = typename Row<W>::V;
  constexpr int TILE = THREADS * U;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long r0 = tile * TILE + threadIdx.x;
    int row[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long r = r0 + u * THREADS;
      row[u] = r < R ? clamp_row(__ldcs(idx + r), T) : -1;
    }
    V v[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (row[u] >= 0) v[u] = __ldg(table + row[u]);
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (row[u] >= 0) __stcs(out + r0 + u * THREADS, v[u]);
  }
}

// w = W = 4·L, L in {2, 4, 8, 16}: L lanes a row, one float4 piece each;
// a block pass covers THREADS / L rows, U passes a tile
template <int W, int U>
__global__ void __launch_bounds__(THREADS)
p1_gather_rows_wide(const float4* __restrict__ table, const int* __restrict__ idx,
                    float4* __restrict__ out, long long R, int T, long long n_tiles) {
  constexpr int L = W / 4;
  static_assert(W % 4 == 0 && L >= 2 && L <= 32 && (L & (L - 1)) == 0,
                "L = W / 4 lanes a row must be a power of two");
  constexpr int ROWS = THREADS / L;
  constexpr int TILE = ROWS * U;
  const int piece = threadIdx.x % L;
  const int sub = threadIdx.x / L;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long r0 = tile * TILE + sub;
    int row[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long r = r0 + u * ROWS;
      row[u] = r < R ? clamp_row(__ldcs(idx + r), T) : -1;
    }
    float4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (row[u] >= 0) v[u] = __ldg(table + (long long)row[u] * L + piece);
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (row[u] >= 0) __stcs(out + (r0 + u * ROWS) * L + piece, v[u]);
  }
}

// any w, any alignment: a thread a row
__global__ void __launch_bounds__(THREADS)
p1_gather_rows_any(const float* __restrict__ table, const int* __restrict__ idx,
                   float* __restrict__ out, long long R, int T, int w) {
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long r = (long long)blockIdx.x * THREADS + threadIdx.x; r < R; r += stride) {
    const float* src = table + (long long)clamp_row(__ldcs(idx + r), T) * w;
    float* dst = out + r * w;
    for (int c = 0; c < w; ++c) __stcs(dst + c, __ldg(src + c));
  }
}

// ---------------------------------------------------------------- P2 --------
// A warp takes a tile of 32 consecutive rows, a row a lane; lanes whose
// rows name the same table row form a group (__match_any_sync), led by its
// lowest lane. Out-of-range lanes carry row -1 and lead nothing.

// w = W <= 4: a row a lane; each leader adds its peers' rows by shuffles,
// in lane order, then one atomic a group
template <int W>
__global__ void __launch_bounds__(THREADS)
p2_scatter_add_rows_narrow(const int* __restrict__ idx,
                           const typename Row<W>::V* __restrict__ upd,
                           typename Row<W>::V* __restrict__ out, long long R, int T,
                           long long n_tiles) {
  using V = typename Row<W>::V;
  const int lane = threadIdx.x & 31;
  const long long n_warps = (long long)gridDim.x * WARPS;
  for (long long t = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5); t < n_tiles;
       t += n_warps) {
    const long long r = t * 32 + lane;
    const bool ok = r < R;
    const int row = ok ? clamp_row(__ldcs(idx + r), T) : -1;
    const V v = ok ? __ldcs(upd + r) : V{};
    const unsigned peers = __match_any_sync(FULL, row);
    const bool lead = ok && __ffs(peers) - 1 == lane;
    unsigned rest = lead ? peers & (peers - 1) : 0u;  // the leader's peers
    V acc = v;
    while (__any_sync(FULL, rest != 0u)) {
      const int src = rest ? __ffs(rest) - 1 : lane;
      const V p = shfl(v, src);
      if (rest) {
        acc = add(acc, p);
        rest &= rest - 1;
      }
    }
    if (lead) atomicAdd(out + row, acc);
  }
}

// w = W = 4·L: L lanes a group, one float4 piece each; the warp's 32 / L
// slots take the tile's groups in turn, each slot walking its group's
// member rows with coalesced 16-byte loads, then one float4 atomic a piece
template <int W>
__global__ void __launch_bounds__(THREADS)
p2_scatter_add_rows_wide(const int* __restrict__ idx, const float4* __restrict__ upd,
                         float4* __restrict__ out, long long R, int T, long long n_tiles) {
  constexpr int L = W / 4;
  static_assert(W % 4 == 0 && L >= 2 && L <= 32 && (L & (L - 1)) == 0,
                "L = W / 4 lanes a row must be a power of two");
  constexpr int SLOTS = 32 / L;
  const int lane = threadIdx.x & 31;
  const int piece = lane % L;
  const int slot = lane / L;
  const long long n_warps = (long long)gridDim.x * WARPS;
  for (long long t = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5); t < n_tiles;
       t += n_warps) {
    const long long r0 = t * 32;
    const bool ok = r0 + lane < R;
    const int row = ok ? clamp_row(__ldcs(idx + r0 + lane), T) : -1;
    const unsigned peers = __match_any_sync(FULL, row);
    const unsigned leaders = __ballot_sync(FULL, ok && __ffs(peers) - 1 == lane);
    const int groups = __popc(leaders);
    for (int g0 = 0; g0 < groups; g0 += SLOTS) {
      const int g = g0 + slot;
      const bool mine = g < groups;
      const int src = mine ? (int)__fns(leaders, 0, g + 1) : lane;
      const unsigned members = __shfl_sync(FULL, peers, src);
      const int dst = __shfl_sync(FULL, row, src);
      if (mine) {
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
        for (unsigned m = members; m; m &= m - 1)
          acc = add(acc, __ldcs(upd + (r0 + __ffs(m) - 1) * L + piece));
        atomicAdd(out + (long long)dst * L + piece, acc);
      }
    }
  }
}

// w = 2 in the vertex layout's row order: a block merges a tile of
// TILE2_ROWS rows in a shared-memory hash of TILE2_SLOTS (row, float2)
// slots, open addressing, then sends one float2 atomic a distinct row
constexpr int TILE2_ROWS = 1024;
constexpr int TILE2_SLOTS = 2048;
constexpr int TILE2_BITS = 11;  // log2(TILE2_SLOTS)

__global__ void __launch_bounds__(THREADS)
p2_scatter_add_rows_tile2(const int* __restrict__ idx, const float2* __restrict__ upd,
                          float2* __restrict__ out, long long R, int T, long long n_tiles) {
  constexpr int U = TILE2_ROWS / THREADS;
  __shared__ int keys[TILE2_SLOTS];
  __shared__ float2 vals[TILE2_SLOTS];
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    for (int s = threadIdx.x; s < TILE2_SLOTS; s += THREADS) {
      keys[s] = -1;
      vals[s] = make_float2(0.f, 0.f);
    }
    const long long r0 = tile * TILE2_ROWS + threadIdx.x;
    int row[U];
    float2 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long r = r0 + u * THREADS;
      row[u] = r < R ? clamp_row(__ldcs(idx + r), T) : -1;
      v[u] = r < R ? __ldcs(upd + r) : make_float2(0.f, 0.f);
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (row[u] < 0) continue;
      unsigned h = ((unsigned)row[u] * 2654435761u) >> (32 - TILE2_BITS);
      for (;;) {
        const int k = atomicCAS(&keys[h], -1, row[u]);
        if (k == -1 || k == row[u]) break;
        h = (h + 1) & (TILE2_SLOTS - 1);
      }
      atomicAdd(&vals[h].x, v[u].x);
      atomicAdd(&vals[h].y, v[u].y);
    }
    __syncthreads();
    for (int s = threadIdx.x; s < TILE2_SLOTS; s += THREADS)
      if (keys[s] >= 0) atomicAdd(out + keys[s], vals[s]);
    __syncthreads();
  }
}

// any w, any alignment: the warp walks the tile's groups in turn, lanes
// over the columns, one scalar atomic a group and column
__global__ void __launch_bounds__(THREADS)
p2_scatter_add_rows_any(const int* __restrict__ idx, const float* __restrict__ upd,
                        float* __restrict__ out, long long R, int T, int w,
                        long long n_tiles) {
  const int lane = threadIdx.x & 31;
  const long long n_warps = (long long)gridDim.x * WARPS;
  for (long long t = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5); t < n_tiles;
       t += n_warps) {
    const long long r0 = t * 32;
    const bool ok = r0 + lane < R;
    const int row = ok ? clamp_row(__ldcs(idx + r0 + lane), T) : -1;
    const unsigned peers = __match_any_sync(FULL, row);
    const unsigned leaders = __ballot_sync(FULL, ok && __ffs(peers) - 1 == lane);
    for (unsigned todo = leaders; todo; todo &= todo - 1) {
      const int src = __ffs(todo) - 1;
      const unsigned members = __shfl_sync(FULL, peers, src);
      const long long dst = (long long)__shfl_sync(FULL, row, src) * w;
      for (int c = lane; c < w; c += 32) {
        float acc = 0.f;
        for (unsigned m = members; m; m &= m - 1)
          acc += __ldcs(upd + (r0 + __ffs(m) - 1) * w + c);
        atomicAdd(out + dst + c, acc);
      }
    }
  }
}

// ------------------------------------------------------------ launches ------

inline unsigned blocks_for(long long tiles) {
  return (unsigned)(tiles < MAX_BLOCKS ? (tiles > 0 ? tiles : 1) : MAX_BLOCKS);
}

inline long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

inline bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// the alignment the vector path of width w loads and stores at
inline uintptr_t vec_bytes(int w) { return w == 1 ? 4 : (w == 2 ? 8 : 16); }

template <int W, int U>
void p1_narrow(const float* table, const int* idx, float* out, long long R, int T,
               cudaStream_t s) {
  using V = typename Row<W>::V;
  const long long tiles = ceil_div(R, (long long)THREADS * U);
  p1_gather_rows_narrow<W, U><<<blocks_for(tiles), THREADS, 0, s>>>(
      reinterpret_cast<const V*>(table), idx, reinterpret_cast<V*>(out), R, T, tiles);
}

template <int W, int U>
void p1_wide(const float* table, const int* idx, float* out, long long R, int T,
             cudaStream_t s) {
  const long long tiles = ceil_div(R, (long long)(THREADS / (W / 4)) * U);
  p1_gather_rows_wide<W, U><<<blocks_for(tiles), THREADS, 0, s>>>(
      reinterpret_cast<const float4*>(table), idx, reinterpret_cast<float4*>(out), R, T,
      tiles);
}

template <int W>
void p2_narrow(const int* idx, const float* upd, float* out, long long R, int T,
               cudaStream_t s) {
  using V = typename Row<W>::V;
  const long long tiles = ceil_div(R, 32);
  p2_scatter_add_rows_narrow<W><<<blocks_for(ceil_div(tiles, WARPS)), THREADS, 0, s>>>(
      idx, reinterpret_cast<const V*>(upd), reinterpret_cast<V*>(out), R, T, tiles);
}

template <int W>
void p2_wide(const int* idx, const float* upd, float* out, long long R, int T,
             cudaStream_t s) {
  const long long tiles = ceil_div(R, 32);
  p2_scatter_add_rows_wide<W><<<blocks_for(ceil_div(tiles, WARPS)), THREADS, 0, s>>>(
      idx, reinterpret_cast<const float4*>(upd), reinterpret_cast<float4*>(out), R, T,
      tiles);
}

inline void p2_tile2(const int* idx, const float* upd, float* out, long long R, int T,
                     cudaStream_t s) {
  const long long tiles = ceil_div(R, TILE2_ROWS);
  p2_scatter_add_rows_tile2<<<blocks_for(tiles), THREADS, 0, s>>>(
      idx, reinterpret_cast<const float2*>(upd), reinterpret_cast<float2*>(out), R, T,
      tiles);
}

}  // namespace nstt

// out [R, w] = table [T, w] rows at idx [R]. Any R >= 0, T >= 1, w >= 1.
extern "C" int nstt_gather_rows(const float* table, const int* idx, float* out,
                                long long R, int T, int w, void* stream) {
  using namespace nstt;
  if (T < 1 || w < 1 || R < 0) return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec_ok = aligned(table, vec_bytes(w)) && aligned(out, vec_bytes(w));
  switch (vec_ok ? w : 0) {
    case 1: p1_narrow<1, 8>(table, idx, out, R, T, s); break;
    case 2: p1_narrow<2, 8>(table, idx, out, R, T, s); break;
    case 4: p1_narrow<4, 4>(table, idx, out, R, T, s); break;
    case 8: p1_wide<8, 4>(table, idx, out, R, T, s); break;
    case 16: p1_wide<16, 4>(table, idx, out, R, T, s); break;
    case 32: p1_wide<32, 4>(table, idx, out, R, T, s); break;
    case 64: p1_wide<64, 4>(table, idx, out, R, T, s); break;
    default:
      p1_gather_rows_any<<<blocks_for(ceil_div(R, THREADS)), THREADS, 0, s>>>(
          table, idx, out, R, T, w);
  }
  return (int)cudaGetLastError();
}

// out [T, w] = zeros, then out[idx[r], :] += upd[r, :] for every r.
extern "C" int nstt_scatter_add_rows(const int* idx, const float* upd, float* out,
                                     long long R, int T, int w, void* stream) {
  using namespace nstt;
  if (T < 1 || w < 1 || R < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(out, 0, (size_t)T * (size_t)w * sizeof(float), s);
  if (e != cudaSuccess) return (int)e;
  if (R == 0) return (int)cudaSuccess;
  const bool vec_ok = aligned(upd, vec_bytes(w)) && aligned(out, vec_bytes(w));
  switch (vec_ok ? w : 0) {
    case 1: p2_narrow<1>(idx, upd, out, R, T, s); break;
    case 2: p2_tile2(idx, upd, out, R, T, s); break;
    case 4: p2_narrow<4>(idx, upd, out, R, T, s); break;
    case 8: p2_wide<8>(idx, upd, out, R, T, s); break;
    case 16: p2_wide<16>(idx, upd, out, R, T, s); break;
    case 32: p2_wide<32>(idx, upd, out, R, T, s); break;
    case 64: p2_wide<64>(idx, upd, out, R, T, s); break;
    default: {
      const long long tiles = ceil_div(R, 32);
      p2_scatter_add_rows_any<<<blocks_for(ceil_div(tiles, WARPS)), THREADS, 0, s>>>(
          idx, upd, out, R, T, w, tiles);
    }
  }
  return (int)cudaGetLastError();
}
