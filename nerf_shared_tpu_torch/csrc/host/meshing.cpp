// Native marching-tetrahedra cell scan for mesh export.
//
// The isosurface extraction stage of nerf_shared_tpu_torch/ops/meshing.py
// (a copy of the JAX package's host cell scan): emits, per output
// triangle corner, the (min, max) global lattice indices of the crossed
// cube edge. Vertex dedup (np.unique over edge keys) and the crossing
// interpolation stay in numpy — they are single vectorized passes; the
// hot part is the 6-tets-per-cube scan over the (X-1)(Y-1)(Z-1) cubes,
// which is a Python-level loop nest no matter how the numpy path slices
// it. OpenMP-parallel over z-slabs in two passes (count, then fill at
// precomputed slab offsets) so the output arrays are allocated exactly
// once by the caller.
//
// Tables match ops/meshing.py exactly (same tet decomposition around the
// c0-c6 diagonal, all six positively oriented; same winding): the Python
// path is the reference, and tests/test_torch_meshing.py asserts bit-equal
// face sets between the two.
//
// Build: ops/native_meshing.py (g++ -O3 -march=native -fopenmp -fPIC
// -shared), at first use.

#include <cstdint>

namespace {

const int CUBE[8][3] = {
    {0, 0, 0}, {1, 0, 0}, {1, 1, 0}, {0, 1, 0},
    {0, 0, 1}, {1, 0, 1}, {1, 1, 1}, {0, 1, 1},
};
const int TETS[6][4] = {
    {0, 5, 1, 6}, {0, 1, 2, 6}, {0, 2, 3, 6},
    {0, 3, 7, 6}, {0, 7, 4, 6}, {0, 4, 5, 6},
};
// local tet edges by edge id 0..5
const int EDGES[6][2] = {{0, 1}, {0, 2}, {0, 3}, {1, 2}, {1, 3}, {2, 3}};
// case id = sum(inside[k] << k) -> flat triangle list (edge ids), -1 end
const int TRI[16][7] = {
    {-1, 0, 0, 0, 0, 0, 0},
    {0, 1, 2, -1, 0, 0, 0},
    {0, 4, 3, -1, 0, 0, 0},
    {1, 4, 3, 1, 2, 4, -1},
    {1, 3, 5, -1, 0, 0, 0},
    {0, 3, 5, 0, 5, 2, -1},
    {0, 4, 5, 0, 5, 1, -1},
    {2, 4, 5, -1, 0, 0, 0},
    {2, 5, 4, -1, 0, 0, 0},
    {0, 5, 4, 0, 1, 5, -1},
    {0, 5, 3, 0, 2, 5, -1},
    {1, 5, 3, -1, 0, 0, 0},
    {1, 3, 4, 1, 4, 2, -1},
    {0, 3, 4, -1, 0, 0, 0},
    {0, 2, 1, -1, 0, 0, 0},
    {-1, 0, 0, 0, 0, 0, 0},
};
const int TRI_COUNT[16] = {0, 1, 1, 2, 1, 2, 2, 1, 1, 2, 2, 1, 2, 1, 1, 0};

}  // namespace

extern "C" {

// Pass 1: triangles emitted per z-slab of cubes (counts has Z-1 entries).
void mt_count_slabs(const float* v, int X, int Y, int Z, float iso,
                    int64_t* counts) {
#pragma omp parallel for schedule(dynamic)
  for (int z = 0; z < Z - 1; ++z) {
    int64_t c = 0;
    for (int x = 0; x < X - 1; ++x) {
      const int64_t bx = static_cast<int64_t>(x) * Y * Z;
      for (int y = 0; y < Y - 1; ++y) {
        float val[8];
        for (int k = 0; k < 8; ++k) {
          val[k] = v[bx + CUBE[k][0] * (int64_t)Y * Z +
                     (int64_t)(y + CUBE[k][1]) * Z + (z + CUBE[k][2])];
        }
        for (int t = 0; t < 6; ++t) {
          int cs = 0;
          for (int k = 0; k < 4; ++k) {
            cs |= (val[TETS[t][k]] > iso) << k;
          }
          c += TRI_COUNT[cs];
        }
      }
    }
    counts[z] = c;
  }
}

// Pass 2: fill (min, max) lattice-index pairs per triangle corner.
// offsets[z] = triangles before slab z (exclusive prefix sum of counts);
// lo/hi each hold 3 * total_triangles entries on exit.
void mt_fill(const float* v, int X, int Y, int Z, float iso,
             const int64_t* offsets, int64_t* lo, int64_t* hi) {
#pragma omp parallel for schedule(dynamic)
  for (int z = 0; z < Z - 1; ++z) {
    int64_t w = offsets[z] * 3;
    for (int x = 0; x < X - 1; ++x) {
      for (int y = 0; y < Y - 1; ++y) {
        float val[8];
        int64_t gid[8];
        for (int k = 0; k < 8; ++k) {
          const int64_t g = (int64_t)(x + CUBE[k][0]) * Y * Z +
                            (int64_t)(y + CUBE[k][1]) * Z + (z + CUBE[k][2]);
          gid[k] = g;
          val[k] = v[g];
        }
        for (int t = 0; t < 6; ++t) {
          int cs = 0;
          for (int k = 0; k < 4; ++k) {
            cs |= (val[TETS[t][k]] > iso) << k;
          }
          const int* tri = TRI[cs];
          for (int i = 0; tri[i] >= 0; i += 3) {
            for (int j = 0; j < 3; ++j) {
              const int e = tri[i + j];
              const int64_t a = gid[TETS[t][EDGES[e][0]]];
              const int64_t b = gid[TETS[t][EDGES[e][1]]];
              lo[w] = a < b ? a : b;
              hi[w] = a < b ? b : a;
              ++w;
            }
          }
        }
      }
    }
  }
}

}  // extern "C"
