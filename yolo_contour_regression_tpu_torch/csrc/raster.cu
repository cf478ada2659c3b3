// Scanline polygon fill for Hopper (sm_90a), two entries on one design.
//
// raster_fill_polygons (even-odd) replaces the TPU kernel
// yolo_contour_regression_tpu/ops/pallas_raster.py:58 fill_polygons_pallas
// (kernel body _raster_kernel). Contract, shared with the plain PyTorch
// version ops/raster.py:fill_polygons_plain: points (N, V, 2) f32, valid
// (N, V) bool -> out (N, H, W) bool. Pixels are sampled at integer (px, py);
// each invalid vertex collapses onto the previous valid one, and a pixel is
// inside when an odd number of edges (p0, p1) satisfy
//   cond  = (y0 > py) != (y1 > py)
//   denom = (y1 == y0) ? 1 : y1 - y0
//   xi    = x0 + (py - y0) / denom * (x1 - x0)
//   cross = cond && px < xi
// A polygon with no valid vertex gives an empty mask.
//
// raster_fill_polygons_cv2 has no TPU counterpart: it replaces the JAX
// facade's host cv2.fillPoly (engine/results.py:contours_to_masks_host),
// with the plain version ops/raster.py:fill_polygons_cv2_plain. The same
// inputs; a polygon with at least 3 valid vertices is filled as
// cv2.fillPoly(round(valid_points * 8), shift=3, LINE_8) fills it, in
// OpenCV's int64 fixed point: the scanline spans of its edges, then every
// edge's 8-connected outline, clipped to the image (the rule is spelled out
// in the plain version's docstring).
//
// What bounds it: the masks. Whether an edge spans a row, and where, is one
// value per (row, edge); each pixel then only asks which span it lies in.
// At N=300, V=36, 480x640 that is far less than the time to write the
// N*H*W bytes of the masks (92 MB), so the bound is bytes: N*H*W over the
// card's memory rate.
//
// What the design does about it:
// - Collapse folded in. Each block compacts its polygon's valid vertices
//   into shared memory once, with a warp ballot and a prefix count; the
//   edges are the cyclic pairs of consecutive valid vertices. That is the
//   collapsed polygon without its zero-length edges (which never cross), so
//   the even-odd fill is bit-equal to the plain version, in one launch.
// - One crossing per (row, edge), not per (pixel, edge). A warp owns a row
//   and its lanes take the edges; the warp compacts the row's crossings
//   into shared memory (at most V) and ranks them (each lane counts the
//   crossings below its own: a row has few), which sorts them into spans.
//   The even-odd entry computes xi with the _rn intrinsics, and the file is
//   built with -fmad=false, so no contraction changes xi; the cv2 entry
//   works in int64 as OpenCV does.
// - Spans written as 16-byte stores. Each lane builds whole uint4 chunks of
//   the row from the spans, and stores zeros at once where no span reaches
//   the chunk; rows outside the polygon's y-range skip the edges and are
//   zero-filled at the same width. A row whose start is not 16-byte aligned
//   (W % 16 != 0) takes byte stores for its unaligned head and tail only.
// - The cv2 outlines: a second launch on the same stream, after the fill.
//   A warp takes an edge and each lane a 32nd of the line's pixels: the
//   state of OpenCV's 8-connected LineIterator at pixel k has a closed
//   form (the minor axis has stepped ceil((2 minor k - major) / (2 major))
//   times), so a lane starts its run with one division and then steps as
//   the iterator does. All writes are 1s, so overlapping ones are benign.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerWarp = 8;
constexpr int kOutlineWarps = 8;
constexpr int kTileH = kWarps * kRowsPerWarp;  // rows per block
constexpr unsigned kFull = 0xffffffffu;

// cv2.fillPoly's fixed point (XY_SHIFT) and the facade's subpixel bits
constexpr int kXYShift = 16;
constexpr long long kXYOne = 1ll << kXYShift;
constexpr int kSubShift = 3;

struct Edge {  // one cv2 fill edge: rows [y0, y1), x at y0, per-row step dx
  long long x, dx;
  int y0, y1;
};

__device__ __forceinline__ unsigned lanes_below() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

struct PolyInfo {  // what compact_valid leaves in shared memory
  int count;         // valid vertices
  float ymin, ymax;  // their least and greatest y
};

// Warp 0 moves the valid vertices of one polygon, in order, to xs/ys;
// every thread of the block gets their count and y-range.
__device__ PolyInfo compact_valid(const float2* __restrict__ p,
                                  const unsigned char* __restrict__ ok, int v, float* xs,
                                  float* ys, PolyInfo* info) {
  if (threadIdx.x < 32) {
    int base = 0;
    float lo = INFINITY, hi = -INFINITY;
    for (int c = 0; c < v; c += 32) {
      const int i = c + threadIdx.x;
      const bool on = i < v && ok[i];
      const unsigned mask = __ballot_sync(kFull, on);
      if (on) {
        const float2 q = p[i];
        const int pos = base + __popc(mask & lanes_below());
        xs[pos] = q.x;
        ys[pos] = q.y;
        lo = fminf(lo, q.y);
        hi = fmaxf(hi, q.y);
      }
      base += __popc(mask);
    }
    for (int o = 16; o; o >>= 1) {
      lo = fminf(lo, __shfl_xor_sync(kFull, lo, o));
      hi = fmaxf(hi, __shfl_xor_sync(kFull, hi, o));
    }
    if (threadIdx.x == 0) *info = PolyInfo{base, lo, hi};
  }
  __syncthreads();
  return *info;
}

// Append each lane's value (where `on`) to buf[k...], in lane order.
template <typename T>
__device__ __forceinline__ void append(bool on, T value, T* buf, int& k) {
  const unsigned mask = __ballot_sync(kFull, on);
  if (on) buf[k + __popc(mask & lanes_below())] = value;
  k += __popc(mask);
}

// Rank sort of buf[0..k) into spans: the value of rank r goes to
// spans[r] through to_bound(value, r). Ties rank by position.
template <typename T, typename F>
__device__ __forceinline__ void rank_into(const T* buf, int k, int* spans, F to_bound) {
  const int lane = threadIdx.x & 31;
  __syncwarp();
  for (int i = lane; i < k; i += 32) {
    const T xi = buf[i];
    int r = 0;
    for (int j = 0; j < k; ++j) {
      const T xj = buf[j];
      r += (xj < xi) || (xj == xi && j < i);
    }
    spans[r] = to_bound(xi, r);
  }
  __syncwarp();
}

// 4 mask bits -> 4 bytes of 0/1
__device__ __forceinline__ unsigned spread4(unsigned b) {
  return (b & 1u) | ((b & 2u) << 7) | ((b & 4u) << 14) | ((b & 8u) << 21);
}

// Write one row of w bytes: byte px is 1 when some span m has
// spans[2m] <= px < spans[2m+1] (k bounds, k even, nondecreasing, already
// in [0, w]); k = 0 writes zeros.
__device__ void store_row(unsigned char* row, int w, const int* spans, int k) {
  const int lane = threadIdx.x & 31;
  const int first = k ? spans[0] : w, last = k ? spans[k - 1] : 0;
  const int head = min((int)((16 - ((uintptr_t)row & 15)) & 15), w);
  const int chunks = (w - head) >> 4;
  const int tail0 = head + (chunks << 4);
  // unaligned head (lanes 0-15) and tail (lanes 16-31), one byte each
  const int px = lane < 16 ? lane : tail0 + lane - 16;
  if ((lane < 16 && px < head) || (lane >= 16 && px < w)) {
    unsigned char in = 0;
    for (int m = 0; m < k; m += 2) in |= (spans[m] <= px) & (px < spans[m + 1]);
    row[px] = in;
  }
  uint4* body = reinterpret_cast<uint4*>(row + head);
  for (int c = lane; c < chunks; c += 32) {
    const int x0 = head + (c << 4);
    unsigned bits = 0;
    if (x0 + 16 <= first || x0 >= last) {  // no span reaches this chunk
      body[c] = make_uint4(0, 0, 0, 0);
      continue;
    }
    for (int m = 0; m < k; m += 2) {
      const int lo = max(spans[m] - x0, 0), hi = min(spans[m + 1] - x0, 16);
      if (lo < hi) bits |= (1u << hi) - (1u << lo);
    }
    body[c] = make_uint4(spread4(bits), spread4(bits >> 4), spread4(bits >> 8),
                         spread4(bits >> 12));
  }
}

// Shared memory of a fill block: the compacted vertices (2 V floats), then
// per warp V crossings and V span bounds; the cv2 entry's crossings are
// int64 and it keeps its V edges too.
constexpr size_t fill_smem(int v, bool cv2) {
  return 2 * (size_t)v * sizeof(float) +
         kWarps * (size_t)v * ((cv2 ? sizeof(long long) : sizeof(float)) + sizeof(int)) +
         (cv2 ? (size_t)v * sizeof(Edge) : 0);
}

__global__ void __launch_bounds__(kThreads)
fill_even_odd_kernel(const float2* __restrict__ pts, const unsigned char* __restrict__ valid,
                     unsigned char* __restrict__ out, int v, int h, int w) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);
  float* ys = xs + v;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* cross = ys + v + warp * v;
  int* spans = reinterpret_cast<int*>(ys + v + kWarps * v) + warp * v;
  __shared__ PolyInfo info;

  const long long poly = blockIdx.x;
  const PolyInfo pi = compact_valid(pts + poly * v, valid + poly * v, v, xs, ys, &info);
  const int cnt = pi.count;
  const float fw = (float)w;
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int y = blockIdx.y * kTileH + r * kWarps + warp;
    if (y >= h) break;
    const float py = (float)y;
    unsigned char* row = out + (poly * h + y) * (long long)w;
    // below ymin every vertex is above the row, from ymax on none is: no
    // edge crosses it
    if (!(pi.ymin <= py && py < pi.ymax)) {
      store_row(row, w, spans, 0);
      continue;
    }
    int k = 0;
    for (int c = 0; c < cnt; c += 32) {
      const int e = c + lane;
      bool on = false;
      float xi = 0.0f;
      if (e < cnt) {
        const int e1 = (e + 1 == cnt) ? 0 : e + 1;
        const float y0 = ys[e], y1 = ys[e1];
        if ((y0 > py) != (y1 > py)) {
          const float x0 = xs[e], x1 = xs[e1];
          const float denom = (y1 == y0) ? 1.0f : __fsub_rn(y1, y0);
          const float t = __fdiv_rn(__fsub_rn(py, y0), denom);
          xi = __fadd_rn(x0, __fmul_rn(t, __fsub_rn(x1, x0)));
          on = true;
        }
      }
      append(on, xi, cross, k);
    }
    // px < xi for integer px <=> px < ceil(xi): pixels [ceil(s0), ceil(s1)),
    // [ceil(s2), ceil(s3)), ... of the sorted crossings (k is even)
    rank_into(cross, k, spans, [fw](float x, int) {
      return (int)fminf(fmaxf(ceilf(x), 0.0f), fw);
    });
    store_row(row, w, spans, k);
  }
}

// OpenCV's clipLine (int64): cut the segment to [0, w-1] x [0, h-1]; the
// intercepts are truncated from double. False when it lies wholly outside.
__device__ bool clip_line(int w, int h, long long& x1, long long& y1, long long& x2,
                          long long& y2) {
  const long long right = w - 1, bottom = h - 1;
  int c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8;
  int c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8;
  if ((c1 & c2) == 0 && (c1 | c2) != 0) {
    long long a;
    if (c1 & 12) {
      a = c1 < 8 ? 0 : bottom;
      x1 += (long long)((double)(a - y1) * (double)(x2 - x1) / (double)(y2 - y1));
      y1 = a;
      c1 = (x1 < 0) + (x1 > right) * 2;
    }
    if (c2 & 12) {
      a = c2 < 8 ? 0 : bottom;
      x2 += (long long)((double)(a - y2) * (double)(x2 - x1) / (double)(y2 - y1));
      y2 = a;
      c2 = (x2 < 0) + (x2 > right) * 2;
    }
    if ((c1 & c2) == 0 && (c1 | c2) != 0) {
      if (c1) {
        a = c1 == 1 ? 0 : right;
        y1 += (long long)((double)(a - x1) * (double)(y2 - y1) / (double)(x2 - x1));
        x1 = a;
        c1 = 0;
      }
      if (c2) {
        a = c2 == 1 ? 0 : right;
        y2 += (long long)((double)(a - x2) * (double)(y2 - y1) / (double)(x2 - x1));
        x2 = a;
        c2 = 0;
      }
    }
  }
  return (c1 | c2) == 0;
}

// Edge i of a compacted polygon in OpenCV's fixed point: from vertex i-1
// (cyclic) to vertex i. X = x8 << 13, Y = (y8 + 4) >> 3 with x8, y8 the
// vertex times 8 rounded half to even; the outline runs between
// ((X + XY_ONE/2) >> 16, Y) of its two ends.
struct FixedEdge {
  long long X0, Y0, X1, Y1, t0x, t1x;
};

__device__ FixedEdge fixed_edge(const float* xs, const float* ys, int cnt, int i) {
  const int p = i == 0 ? cnt - 1 : i - 1;
  FixedEdge f;
  f.X0 = (long long)__float2int_rn(xs[p] * 8.0f) * (kXYOne >> kSubShift);
  f.X1 = (long long)__float2int_rn(xs[i] * 8.0f) * (kXYOne >> kSubShift);
  f.Y0 = ((long long)__float2int_rn(ys[p] * 8.0f) + (1 << (kSubShift - 1))) >> kSubShift;
  f.Y1 = ((long long)__float2int_rn(ys[i] * 8.0f) + (1 << (kSubShift - 1))) >> kSubShift;
  f.t0x = (f.X0 + kXYOne / 2) >> kXYShift;
  f.t1x = (f.X1 + kXYOne / 2) >> kXYShift;
  return f;
}

__device__ __forceinline__ bool outside(long long x, long long y, int w, int h) {
  return x < 0 || x >= w || y < 0 || y >= h;
}

// OpenCV's CollectPolyEdges for one edge. An edge whose outline leaves the
// image takes its x from the clipped outline's integer endpoints, and its
// y from them too unless they coincide; horizontal edges fill no row.
__device__ Edge poly_edge(const FixedEdge& f, int w, int h) {
  Edge e;
  if (f.Y0 == f.Y1) {
    e.x = e.dx = 0;
    e.y0 = e.y1 = 0;
    return e;
  }
  long long cx0 = f.X0, cy0 = f.Y0, cx1 = f.X1, cy1 = f.Y1;
  if (outside(f.t0x, f.Y0, w, h) || outside(f.t1x, f.Y1, w, h)) {
    long long ux0 = f.t0x, uy0 = f.Y0, ux1 = f.t1x, uy1 = f.Y1;
    clip_line(w, h, ux0, uy0, ux1, uy1);
    cx0 = ux0 * kXYOne;
    cx1 = ux1 * kXYOne;
    if (uy0 != uy1) {
      cy0 = uy0;
      cy1 = uy1;
    }
  }
  e.dx = (cx1 - cx0) / (cy1 - cy0);  // truncates, as C does
  if (f.Y0 < f.Y1) {
    e.y0 = (int)f.Y0;
    e.y1 = (int)f.Y1;
    e.x = cx0 + (f.Y0 - cy0) * e.dx;
  } else {
    e.y0 = (int)f.Y1;
    e.y1 = (int)f.Y0;
    e.x = cx1 + (f.Y1 - cy1) * e.dx;
  }
  return e;
}

__global__ void __launch_bounds__(kThreads)
fill_cv2_kernel(const float2* __restrict__ pts, const unsigned char* __restrict__ valid,
                unsigned char* __restrict__ out, int v, int h, int w) {
  extern __shared__ __align__(16) unsigned char smem[];
  long long* cross_all = reinterpret_cast<long long*>(smem);
  Edge* edges = reinterpret_cast<Edge*>(cross_all + kWarps * v);
  float* xs = reinterpret_cast<float*>(edges + v);
  float* ys = xs + v;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  long long* cross = cross_all + warp * v;
  int* spans = reinterpret_cast<int*>(ys + v) + warp * v;
  __shared__ PolyInfo info;
  __shared__ int rows_lo, rows_hi;  // the rows any edge spans: [rows_lo, rows_hi)

  if (threadIdx.x == 0) {
    rows_lo = INT_MAX;
    rows_hi = INT_MIN;
  }
  const long long poly = blockIdx.x;
  int cnt = compact_valid(pts + poly * v, valid + poly * v, v, xs, ys, &info).count;
  if (cnt < 3) cnt = 0;  // fewer than 3 valid vertices: an empty mask
  for (int i = threadIdx.x; i < cnt; i += kThreads) {
    const Edge e = poly_edge(fixed_edge(xs, ys, cnt, i), w, h);
    edges[i] = e;
    if (e.y0 < e.y1) {
      atomicMin(&rows_lo, e.y0);
      atomicMax(&rows_hi, e.y1);
    }
  }
  __syncthreads();

  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int y = blockIdx.y * kTileH + r * kWarps + warp;
    if (y >= h) break;
    unsigned char* row = out + (poly * h + y) * (long long)w;
    if (y < rows_lo || y >= rows_hi) {
      store_row(row, w, spans, 0);
      continue;
    }
    int k = 0;
    for (int c = 0; c < cnt; c += 32) {
      const int i = c + lane;
      bool on = false;
      long long x = 0;
      if (i < cnt) {
        const Edge e = edges[i];
        on = e.y0 <= y && y < e.y1;
        x = e.x + (long long)(y - e.y0) * e.dx;
      }
      append(on, x, cross, k);
    }
    // sorted xs paired: columns (a + 0xFFFF) >> 16 through b >> 16, clipped;
    // kept as [lo, hi + 1) within [0, w]
    rank_into(cross, k, spans, [w](long long x, int r) {
      const long long b = (r & 1) ? (x >> kXYShift) + 1 : (x + kXYOne - 1) >> kXYShift;
      return (int)min(max(b, 0ll), (long long)w);
    });
    store_row(row, w, spans, k);
  }
}

// Every edge's outline: OpenCV's 8-connected LineIterator between the
// rounded endpoints, clipped to the image and run left to right; a warp per
// edge, a run of pixels per lane.
__global__ void __launch_bounds__(32 * kOutlineWarps)
outline_cv2_kernel(const float2* __restrict__ pts, const unsigned char* __restrict__ valid,
                   unsigned char* __restrict__ out, int v, int h, int w) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);
  float* ys = xs + v;
  __shared__ PolyInfo info;
  const long long poly = blockIdx.x;
  const int cnt = compact_valid(pts + poly * v, valid + poly * v, v, xs, ys, &info).count;
  if (cnt < 3) return;
  unsigned char* o = out + poly * h * (long long)w;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = warp; i < cnt; i += kOutlineWarps) {
    const FixedEdge f = fixed_edge(xs, ys, cnt, i);
    long long x1 = f.t0x, y1 = f.Y0, x2 = f.t1x, y2 = f.Y1;
    if ((outside(x1, y1, w, h) || outside(x2, y2, w, h)) && !clip_line(w, h, x1, y1, x2, y2))
      continue;
    if (x2 < x1) {  // left to right
      long long t = x1; x1 = x2; x2 = t;
      t = y1; y1 = y2; y2 = t;
    }
    const long long dx = x2 - x1, sy = y2 < y1 ? -1 : 1, dy = (y2 - y1) * sy;
    const bool vert = dy > dx;
    const long long major = vert ? dy : dx, minor = vert ? dx : dy;
    const long long run = (major + 32) / 32, k1 = min(major + 1, (lane + 1) * run);
    long long k = lane * run;
    long long m = major ? (2 * minor * k + major - 1) / (2 * major) : 0;
    long long err = major - 2 * minor - 2 * minor * k + 2 * major * m;
    for (; k < k1; ++k) {
      const long long x = vert ? x1 + m : x1 + k, y = vert ? y1 + sy * k : y1 + sy * m;
      o[y * w + x] = 1;
      const bool diag = err < 0;
      err += diag ? 2 * (major - minor) : -2 * minor;
      m += diag;
    }
  }
}

cudaError_t launch_fill(bool cv2, const void* pts, const void* valid, void* out, int n, int v,
                        int h, int w, cudaStream_t stream) {
  const dim3 grid((unsigned)n, (unsigned)((h + kTileH - 1) / kTileH));
  const size_t smem = fill_smem(v, cv2);
  const void* kernel = cv2 ? (const void*)fill_cv2_kernel : (const void*)fill_even_odd_kernel;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const float2* p = static_cast<const float2*>(pts);
  const unsigned char* ok = static_cast<const unsigned char*>(valid);
  unsigned char* o = static_cast<unsigned char*>(out);
  if (cv2)
    fill_cv2_kernel<<<grid, kThreads, smem, stream>>>(p, ok, o, v, h, w);
  else
    fill_even_odd_kernel<<<grid, kThreads, smem, stream>>>(p, ok, o, v, h, w);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows per block, so the wrapper can check the grid's second dimension.
int raster_tile_rows() { return kTileH; }

// Each entry launches on `stream` (a cudaStream_t) and returns
// cudaGetLastError(); it does not synchronise and allocates nothing. The
// caller checks shapes, types, devices and contiguity (ops/raster.py).
int raster_fill_polygons(const void* pts, const void* valid, void* out, int n, int v, int h,
                         int w, void* stream) {
  if (n == 0 || h == 0 || w == 0) return (int)cudaSuccess;
  return (int)launch_fill(false, pts, valid, out, n, v, h, w, (cudaStream_t)stream);
}

// The fill, then the outlines on the same stream.
int raster_fill_polygons_cv2(const void* pts, const void* valid, void* out, int n, int v, int h,
                             int w, void* stream) {
  if (n == 0 || h == 0 || w == 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err = launch_fill(true, pts, valid, out, n, v, h, w, s);
  if (err != cudaSuccess) return (int)err;
  outline_cv2_kernel<<<(unsigned)n, 32 * kOutlineWarps, 2 * (size_t)v * sizeof(float), s>>>(
      static_cast<const float2*>(pts), static_cast<const unsigned char*>(valid),
      static_cast<unsigned char*>(out), v, h, w);
  return (int)cudaGetLastError();
}

}  // extern "C"
