// Even-odd (crossing-number) polygon fill for Hopper (sm_90a).
//
// Replaces the TPU kernel yolo_contour_regression_tpu/ops/pallas_raster.py:
// fill_polygons_pallas (kernel body _raster_kernel). Contract, shared with
// the plain PyTorch version ops/raster.py:fill_polygons_plain:
//   points (N, V, 2) f32, already collapsed (each invalid vertex moved onto
//   the previous valid one, done in PyTorch by the wrapper, as the JAX
//   package does outside its kernel), valid (N, V) bool -> out (N, H, W)
//   bool. Pixels are sampled at integer coordinates (px, py). A pixel is
//   inside when an odd number of edges (p0, p1) satisfy
//     cond  = (y0 > py) != (y1 > py)
//     denom = (y1 == y0) ? 1 : y1 - y0
//     xi    = x0 + (py - y0) / denom * (x1 - x0)
//     cross = cond && px < xi
//   A polygon with no valid vertex gives an empty mask.
//
// What bounds it: the function needs little arithmetic. Whether an edge
// spans a row and where it crosses it are one value per (row, edge), and
// each (pixel, spanning edge) adds a compare and a parity flip: at N=300,
// V=36, 480x640 that is well under the time of writing the 92 MB of masks,
// so the bound is memory (the bytes of the masks). This first version does
// far more than that: every pixel tests all V edges and recomputes xi, so
// it is limited by its own fp32 issue, far above the bound.
//
// What the design does about it (a plain first version): one block per
// (polygon, tile of kTileH rows); the V vertices are read from device
// memory once per block into shared memory, where every thread of a warp
// reads the same edge (a broadcast, no bank conflicts); one thread per
// pixel, consecutive threads on consecutive bytes of a row, so the stores
// coalesce; the crossing arithmetic runs only where cond holds, and uses
// the _rn intrinsics (and the file is built with -fmad=false) so that no
// FMA contraction changes xi: the result is bit-equal to the plain version.
// The next step is one xi per (row, edge), shared by the row's pixels,
// instead of one per pixel; the mask stores should then set the pace.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileH = 8;

__global__ void __launch_bounds__(kThreads)
raster_kernel(const float* __restrict__ pts, const unsigned char* __restrict__ valid,
              unsigned char* __restrict__ out, int v, int h, int w) {
  extern __shared__ float smem[];
  float* xs = smem;
  float* ys = smem + v;

  const long long poly = blockIdx.x;
  const float* p = pts + poly * v * 2;
  const unsigned char* ok = valid + poly * v;
  int any = 0;
  for (int i = threadIdx.x; i < v; i += blockDim.x) {
    xs[i] = p[2 * i];
    ys[i] = p[2 * i + 1];
    any |= ok[i] != 0;
  }
  any = __syncthreads_or(any);

  const int row0 = blockIdx.y * kTileH;
  const int rows = min(kTileH, h - row0);
  unsigned char* o = out + (poly * h + row0) * (long long)w;
  const int npix = rows * w;
  for (int k = threadIdx.x; k < npix; k += blockDim.x) {
    unsigned char inside = 0;
    if (any) {
      const int r = k / w;
      const float py = (float)(row0 + r);
      const float px = (float)(k - r * w);
      for (int e = 0; e < v; ++e) {
        const int e1 = (e + 1 == v) ? 0 : e + 1;
        const float y0 = ys[e], y1 = ys[e1];
        if ((y0 > py) != (y1 > py)) {
          const float x0 = xs[e], x1 = xs[e1];
          const float denom = (y1 == y0) ? 1.0f : __fsub_rn(y1, y0);
          const float t = __fdiv_rn(__fsub_rn(py, y0), denom);
          const float xi = __fadd_rn(x0, __fmul_rn(t, __fsub_rn(x1, x0)));
          inside ^= (unsigned char)(px < xi);
        }
      }
    }
    o[k] = inside;
  }
}

}  // namespace

extern "C" {

// Rows per block, so the wrapper can check the grid's second dimension.
int raster_tile_rows() { return kTileH; }

// Launches on `stream` (a cudaStream_t) and returns cudaGetLastError(); it
// does not synchronise and allocates nothing. The caller checks shapes,
// types, devices and contiguity.
int raster_fill_polygons(const void* pts, const void* valid, void* out, int n, int v, int h,
                         int w, void* stream) {
  if (n == 0 || h == 0 || w == 0) return (int)cudaSuccess;
  const dim3 grid((unsigned)n, (unsigned)((h + kTileH - 1) / kTileH));
  const size_t smem = 2 * (size_t)v * sizeof(float);
  raster_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(pts), static_cast<const unsigned char*>(valid),
      static_cast<unsigned char*>(out), v, h, w);
  return (int)cudaGetLastError();
}

}  // extern "C"
