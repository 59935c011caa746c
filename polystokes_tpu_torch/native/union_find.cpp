// Host union-find connected components of REDUCED cells, the port's copy
// of the JAX package's native helper (ps_connected_components): region
// labels across faces with liquid weight > 0, the role of Houdini's
// SIM_VolumetricConnectedComponentBuilder in the reference classifier
// (exec/HDK_PolyStokesSolver_Classifier.cpp:218-239).  O(N alpha(N)) on
// the host, where the device's min-label propagation takes sweeps that
// grow with the domain's diameter.
//
// A plain C ABI for ctypes (no pybind11): built with g++ -O3 -shared
// -fPIC at first use (polystokes_tpu_torch/native/__init__.py).

#include <cstdint>
#include <vector>

namespace {

struct UnionFind {
  std::vector<int64_t> parent;
  explicit UnionFind(int64_t n) : parent(n) {
    for (int64_t i = 0; i < n; ++i) parent[i] = i;
  }
  int64_t find(int64_t a) {
    while (parent[a] != a) {
      parent[a] = parent[parent[a]];
      a = parent[a];
    }
    return a;
  }
  void unite(int64_t a, int64_t b) {
    a = find(a);
    b = find(b);
    if (a != b) parent[b] = a;
  }
};

constexpr int8_t kReduced = 4;  // classify.REDUCED

}  // namespace

extern "C" {

// labels: int8 [nx*ny*nz] (C order); face liquid weights of the three
// axes with shapes (nx+1,ny,nz), (nx,ny+1,nz), (nx,ny,nz+1); out: int32
// component per cell, numbered 0..count-1 in order of first appearance
// (-1 for cells that are not REDUCED).  Returns the number of components.
int64_t ps_connected_components(const int8_t* labels, const float* fwx, const float* fwy, const float* fwz,
                                int64_t nx, int64_t ny, int64_t nz, int32_t* out) {
  const int64_t n = nx * ny * nz;
  UnionFind uf(n);
  auto cid = [&](int64_t i, int64_t j, int64_t k) { return (i * ny + j) * nz + k; };
  // x-face (i,j,k) of (nx+1,ny,nz) lies between cells i-1 and i
  auto fx = [&](int64_t i, int64_t j, int64_t k) { return (i * ny + j) * nz + k; };
  auto fy = [&](int64_t i, int64_t j, int64_t k) { return (i * (ny + 1) + j) * nz + k; };
  auto fz = [&](int64_t i, int64_t j, int64_t k) { return (i * ny + j) * (nz + 1) + k; };

  for (int64_t i = 0; i < nx; ++i)
    for (int64_t j = 0; j < ny; ++j)
      for (int64_t k = 0; k < nz; ++k) {
        const int64_t c = cid(i, j, k);
        if (labels[c] != kReduced) continue;
        if (i + 1 < nx && labels[cid(i + 1, j, k)] == kReduced && fwx[fx(i + 1, j, k)] > 0.f)
          uf.unite(c, cid(i + 1, j, k));
        if (j + 1 < ny && labels[cid(i, j + 1, k)] == kReduced && fwy[fy(i, j + 1, k)] > 0.f)
          uf.unite(c, cid(i, j + 1, k));
        if (k + 1 < nz && labels[cid(i, j, k + 1)] == kReduced && fwz[fz(i, j, k + 1)] > 0.f)
          uf.unite(c, cid(i, j, k + 1));
      }

  // compact root ids to 0..count-1
  std::vector<int32_t> remap(n, -1);
  int32_t count = 0;
  for (int64_t c = 0; c < n; ++c) {
    if (labels[c] != kReduced) {
      out[c] = -1;
      continue;
    }
    const int64_t r = uf.find(c);
    if (remap[r] < 0) remap[r] = count++;
    out[c] = remap[r];
  }
  return count;
}

}  // extern "C"
