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
// What bounds them on an H100: bytes. Each moves R·w·4 B of rows, R·4 B of
// indices and at most T·w·4 B of table, with no arithmetic to speak of.
//
// What the design does about it: one thread per 16-byte piece of a row
// when w % 4 == 0 (float4 loads and stores; w / 4 neighbouring threads
// share a row, so a warp reads whole rows as contiguous segments), one
// thread per element otherwise (w = 2 in the hashgrid vertex layout: 16
// rows a warp). A grid-stride loop covers any R >= 0. P1 clamps each index
// into [0, T) (jnp.take's mode="clip"), so it never reads outside the
// table; the callers build indices in range (clamped cells, masked hashes)
// and the plain version asserts that. P2 zeroes the output on the stream,
// then adds with fp32 atomics (`red` in SASS, the return value unused):
// the order of the sums, and so their last bits, varies from run to run.
// A deterministic P2 (sort + segment sum, or per-block partials) is later
// work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace nstt {

constexpr int GATHER_THREADS = 256;
constexpr long long MAX_BLOCKS = 132LL * 32;  // 32 blocks an SM, then stride

__device__ __forceinline__ long long clamp_row(int i, int T) {
  return (long long)(i < 0 ? 0 : (i >= T ? T - 1 : i));
}

__global__ void __launch_bounds__(GATHER_THREADS)
gather_rows_v4(const float4* __restrict__ table, const int* __restrict__ idx,
               float4* __restrict__ out, long long n, int T, int w4) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < n;
       t += stride) {
    const long long r = t / w4;
    const int c = (int)(t - r * w4);
    out[t] = __ldg(table + clamp_row(__ldg(idx + r), T) * w4 + c);
  }
}

__global__ void __launch_bounds__(GATHER_THREADS)
gather_rows_v1(const float* __restrict__ table, const int* __restrict__ idx,
               float* __restrict__ out, long long n, int T, int w) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < n;
       t += stride) {
    const long long r = t / w;
    const int c = (int)(t - r * w);
    out[t] = __ldg(table + clamp_row(__ldg(idx + r), T) * w + c);
  }
}

__global__ void __launch_bounds__(GATHER_THREADS)
scatter_add_rows_v4(const int* __restrict__ idx, const float4* __restrict__ upd,
                    float* __restrict__ out, long long n, int T, int w4) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < n;
       t += stride) {
    const long long r = t / w4;
    const int c = (int)(t - r * w4);
    const float4 u = __ldg(upd + t);
    float* o = out + (clamp_row(__ldg(idx + r), T) * w4 + c) * 4;
    atomicAdd(o, u.x);
    atomicAdd(o + 1, u.y);
    atomicAdd(o + 2, u.z);
    atomicAdd(o + 3, u.w);
  }
}

__global__ void __launch_bounds__(GATHER_THREADS)
scatter_add_rows_v1(const int* __restrict__ idx, const float* __restrict__ upd,
                    float* __restrict__ out, long long n, int T, int w) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < n;
       t += stride) {
    const long long r = t / w;
    const int c = (int)(t - r * w);
    atomicAdd(out + clamp_row(__ldg(idx + r), T) * w + c, __ldg(upd + t));
  }
}

inline unsigned grid_for(long long n) {
  long long b = (n + GATHER_THREADS - 1) / GATHER_THREADS;
  return (unsigned)(b < MAX_BLOCKS ? (b > 0 ? b : 1) : MAX_BLOCKS);
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace nstt

// out [R, w] = table [T, w] rows at idx [R]. Any R >= 0, T >= 1, w >= 1.
extern "C" int nstt_gather_rows(const float* table, const int* idx, float* out,
                                long long R, int T, int w, void* stream) {
  using namespace nstt;
  if (T < 1 || w < 1 || R < 0) return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (w % 4 == 0 && aligned16(table) && aligned16(out)) {
    const long long n = R * (w / 4);
    gather_rows_v4<<<grid_for(n), GATHER_THREADS, 0, s>>>(
        reinterpret_cast<const float4*>(table), idx,
        reinterpret_cast<float4*>(out), n, T, w / 4);
  } else {
    const long long n = R * w;
    gather_rows_v1<<<grid_for(n), GATHER_THREADS, 0, s>>>(table, idx, out, n, T, w);
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
  if (w % 4 == 0 && aligned16(upd) && aligned16(out)) {
    const long long n = R * (w / 4);
    scatter_add_rows_v4<<<grid_for(n), GATHER_THREADS, 0, s>>>(
        idx, reinterpret_cast<const float4*>(upd), out, n, T, w / 4);
  } else {
    const long long n = R * w;
    scatter_add_rows_v1<<<grid_for(n), GATHER_THREADS, 0, s>>>(idx, upd, out, n, T, w);
  }
  return (int)cudaGetLastError();
}
