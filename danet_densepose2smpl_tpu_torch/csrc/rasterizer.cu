// Z-buffered flat-texture triangle rasterizer for the GT IUV images, for
// Hopper (sm_90a). Built by kernels/build.py with nvcc into a shared library
// with a plain C interface; the wrapper is kernels/rasterizer.py.
//
// Replaces, with one pair of kernels, four functions of the JAX package:
//   kernels/rasterizer_pallas.py::rasterize_flat_pallas            (K2, TPU)
//   kernels/rasterizer_pallas.py::rasterize_flat_pallas_banded     (K3, TPU;
//                                       the entry rasterize_flat_banded)
//   kernels/rasterizer_pallas.py::rasterize_flat_pallas_bandrange  (K4, TPU,
//                                                      with its cull_mask)
//   kernels/rasterizer.py::rasterize_flat / rasterize_flat_culled  (K5, XLA)
// and computes K5's formulas (rasterizer.py:96-124) in their order, so the
// plain PyTorch version is matched bit for bit: the file is built with
// -fmad=false and IEEE division, so nvcc contracts nothing, and the two
// multiply-adds that XLA fuses in the JAX function are explicit fmaf calls
// in fp32 (the edge function as fma(ex, dy, -(ey * dx)), the depth as
// fma(b2, z2, fma(b0, z0, b1 * z1))); fp64 leaves them unfused, as the
// plain version must.
//
// What bounds it on the H100. The TPU kernels hold one image's whole face
// table in VMEM and test every pixel against every face with matmuls. Here
// that would be B * S^2 * F = 128 * 3136 * 13776 = 5.5e9 edge-function
// triples per training batch, all on CUDA cores: instruction issue, not
// memory, is the bound (the face table is 0.9 MB per image and the output
// 38 KB). The design cuts the work instead of feeding it faster:
//   1. face_setup, one thread per (image, face): gathers the three corners,
//      scales them to out-map units, computes the edge vectors and signed
//      area once, and writes a 16-value record plus a float4 bounding box
//      (widened by a pixel; an empty box for an invalid or skipped face).
//   2. raster, one block per (16x16-pixel tile, image), one pixel a thread,
//      (zbest, rank) in registers. Faces stream through shared memory
//      in chunks of 256 in ascending face id; each thread tests one face's
//      box against the tile, and a warp ballot plus a block prefix sum
//      compacts the survivors in order. Only those reach the per-pixel edge
//      functions: at 56x56 a tile sees about a tenth of the mesh.
//   3. The update keeps the least (z, rank): rank is the face id, plus F for
//      faces whose code has bit 1 set, so an equal z keeps the lower id
//      (rasterize_flat's first-index argmin within a chunk plus strict-less
//      across chunks), and a marked face loses every tie to an unmarked one
//      (the order of rasterize_flat_culled's compacted prefix, where the
//      dead filler faces follow the live ones). One texture fetch at the end.
// Nothing carries between blocks; a block re-reads the face records of its
// image from L2. Tensor-core edge functions are later work.
//
// The banded entry (K3's design, for the 224x224 LSP render). Its bound is
// instruction issue too: a B=16 batch reads ~1.6 MB of inputs and writes
// 6.4 MB, microseconds at 3.35 TB/s. At S=224 an image has 196 tiles, and
// streaming every face's box through every tile is 196 * 13,776 = 2.7M box
// tests per image, in 54 rounds of loads, ballots and barriers per tile,
// for the few faces that meet the tile. K3 sorts the faces by the y of their centre so that
// each chunk of faces lies in a narrow band of rows, and skips the (band,
// chunk) pairs that do not touch. Here the wrapper sorts (a stable argsort,
// as K3 sorts in XLA before its pallas_call) and hands the order in:
//   1. face_setup writes face order[b, i] into slot i, and each of its
//      256-thread blocks, one per 256-face chunk, reduces the chunk's boxes
//      into one extent (empty boxes of invalid faces do not widen it; a
//      chunk with no valid face keeps the empty extent);
//   2. raster<T, true> reads the chunk's extent before anything else and
//      skips the chunk, in every thread at once, when it misses the tile;
//      the chunks it keeps run as above, ranked by the original face id, so
//      the visiting order cannot change the least (z, id) and the output
//      is rasterize_flat's bit for bit. K3's one-hot texture matmul and its
//      sequential (band, chunk) grid were for the TPU and are not carried.
// Measured on the H100 (PERF.md, chip_smoke.py phase 8), the skipped rounds
// were not where the time went: a 224x224 tile that meets a few hundred to
// ~2,000 faces tests each at all 256 of its pixels, one block in series, and
// the banded raster takes the time of the unbanded one. Spreading a heavy
// tile's faces over more threads is the next step.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;
constexpr int kThreads = kTile * kTile;   // one pixel a thread
constexpr int kChunk = kThreads;          // faces staged per round, one a thread
constexpr int kWarps = kThreads / 32;
constexpr float kEmpty = 1e30f;           // the empty box is (kEmpty, -kEmpty, kEmpty, -kEmpty)

// Corner k's edge function is w_k = ex[k] * (py - ay[k]) - ey[k] * (px - ax[k])
// with a = v[(k+1)%3], e = v[(k+2)%3] - a: w0 = edge(v1, v2), w1 = edge(v2, v0),
// w2 = edge(v0, v1), as in rasterizer.py.
template <typename T>
struct FaceRecord {
  T ax[3], ay[3], ex[3], ey[3], z[3], area;
};
static_assert(sizeof(FaceRecord<float>) == 16 * sizeof(float), "record layout");
static_assert(sizeof(FaceRecord<double>) == 16 * sizeof(double), "record layout");

template <typename T>
__device__ __forceinline__ T absval(T x) { return x < T(0) ? -x : x; }

// a * b + c: one rounding in fp32, two in fp64 (see the note at the top)
__device__ __forceinline__ float madd(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double madd(double a, double b, double c) {
  return __dadd_rn(__dmul_rn(a, b), c);
}

// One block per (chunk of kChunk slots, image), one slot a thread. Slot i of
// image b holds face order[b, i], or face i when order is null. With a
// non-null `extent` the block also writes the union of its boxes.
template <typename T>
__global__ void __launch_bounds__(kChunk)
face_setup(const T* __restrict__ verts, const int* __restrict__ faces, const int* __restrict__ order,
           const uint8_t* __restrict__ skip, int V, int F, T scale, FaceRecord<T>* __restrict__ rec,
           float4* __restrict__ box, float4* __restrict__ extent) {
  const int b = blockIdx.y;
  const int slot = blockIdx.x * kChunk + threadIdx.x;
  const long long i = (long long)b * F + slot;
  float4 bx = make_float4(kEmpty, -kEmpty, kEmpty, -kEmpty);   // (xmin, xmax, ymin, ymax)
  if (slot < F) {
    const int f = order != nullptr ? order[i] : slot;
    const T* vb = verts + (long long)b * V * 3;
    T x[3], y[3], z[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int vi = faces[f * 3 + k];
      x[k] = vb[vi * 3 + 0] * scale;
      y[k] = vb[vi * 3 + 1] * scale;
      z[k] = vb[vi * 3 + 2];
    }
    const T area = (x[1] - x[0]) * (y[2] - y[0]) - (y[1] - y[0]) * (x[2] - x[0]);
    const bool valid = absval(area) > T(1e-12) && z[0] > T(0) && z[1] > T(0) && z[2] > T(0) &&
                       !(skip != nullptr && (skip[(long long)b * F + f] & 1));
    FaceRecord<T> r;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int a = (k + 1) % 3, c = (k + 2) % 3;
      r.ax[k] = x[a];
      r.ay[k] = y[a];
      r.ex[k] = x[c] - x[a];
      r.ey[k] = y[c] - y[a];
      r.z[k] = z[k];
    }
    r.area = area;
    rec[i] = r;
    if (valid) {
      bx.x = (float)fmin(fmin((double)x[0], (double)x[1]), (double)x[2]) - 1.0f;
      bx.y = (float)fmax(fmax((double)x[0], (double)x[1]), (double)x[2]) + 1.0f;
      bx.z = (float)fmin(fmin((double)y[0], (double)y[1]), (double)y[2]) - 1.0f;
      bx.w = (float)fmax(fmax((double)y[0], (double)y[1]), (double)y[2]) + 1.0f;
    }
    box[i] = bx;
  }
  if (extent != nullptr) {   // the same branch in every thread of the grid
    __shared__ float4 wbox[kWarps];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      bx.x = fminf(bx.x, __shfl_xor_sync(0xffffffffu, bx.x, o));
      bx.y = fmaxf(bx.y, __shfl_xor_sync(0xffffffffu, bx.y, o));
      bx.z = fminf(bx.z, __shfl_xor_sync(0xffffffffu, bx.z, o));
      bx.w = fmaxf(bx.w, __shfl_xor_sync(0xffffffffu, bx.w, o));
    }
    if (threadIdx.x % 32 == 0) wbox[threadIdx.x / 32] = bx;
    __syncthreads();
    if (threadIdx.x == 0) {
      float4 u = wbox[0];
      for (int w = 1; w < kWarps; ++w) {
        u.x = fminf(u.x, wbox[w].x);
        u.y = fmaxf(u.y, wbox[w].y);
        u.z = fminf(u.z, wbox[w].z);
        u.w = fmaxf(u.w, wbox[w].w);
      }
      extent[(long long)b * gridDim.x + blockIdx.x] = u;
    }
  }
}

// kBanded: slots hold faces in `order`, and chunks whose `extent` misses the
// tile are skipped; otherwise slot f is face f, ranked by its `skip` code.
template <typename T, bool kBanded>
__global__ void __launch_bounds__(kThreads)
raster(const FaceRecord<T>* __restrict__ rec, const float4* __restrict__ box,
       const uint8_t* __restrict__ skip, const int* __restrict__ order,
       const float4* __restrict__ extent, const T* __restrict__ tex, int F, int S, int C,
       T* __restrict__ out) {
  __shared__ FaceRecord<T> srec[kChunk];
  __shared__ int sid[kChunk];
  __shared__ int wcount[kWarps];

  const int b = blockIdx.y;
  const int tiles_x = (S + kTile - 1) / kTile;
  const int tx0 = (blockIdx.x % tiles_x) * kTile, ty0 = (blockIdx.x / tiles_x) * kTile;
  const int col = tx0 + threadIdx.x % kTile, row = ty0 + threadIdx.x / kTile;
  const T px = T(col) + T(0.5), py = T(row) + T(0.5);
  // pixel centres of the tile lie in [t0 + 0.5, t0 + kTile - 0.5]; the face
  // boxes carry a one-pixel margin, so the test is conservative
  const float xlo = (float)tx0, xhi = (float)(tx0 + kTile);
  const float ylo = (float)ty0, yhi = (float)(ty0 + kTile);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long fbase = (long long)b * F;

  T zbest = T(1e9);
  int best = -1;   // rank of the nearest face so far
  const long long cbase = (long long)b * ((F + kChunk - 1) / kChunk);
  for (int base = 0, chunk = 0; base < F; base += kChunk, ++chunk) {
    if (kBanded) {   // one value for the whole block: every thread skips alike
      const float4 e = extent[cbase + chunk];
      if (!(e.y >= xlo && e.x <= xhi && e.w >= ylo && e.z <= yhi)) continue;
    }
    const int f = base + threadIdx.x;
    bool hit = false;
    if (f < F) {
      const float4 bx = box[fbase + f];
      hit = bx.y >= xlo && bx.x <= xhi && bx.w >= ylo && bx.z <= yhi;
    }
    const unsigned m = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) wcount[warp] = __popc(m);
    __syncthreads();
    int off = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = wcount[w];
      off += w < warp ? c : 0;
      total += c;
    }
    if (hit) {
      const int pos = off + __popc(m & ((1u << lane) - 1u));
      srec[pos] = rec[fbase + f];
      sid[pos] = kBanded ? order[fbase + f] : (skip != nullptr && (skip[fbase + f] & 2)) ? f + F : f;
    }
    __syncthreads();
    for (int i = 0; i < total; ++i) {
      const FaceRecord<T>& r = srec[i];
      const T w0 = madd(r.ex[0], py - r.ay[0], -(r.ey[0] * (px - r.ax[0])));
      const T w1 = madd(r.ex[1], py - r.ay[1], -(r.ey[1] * (px - r.ax[1])));
      const T w2 = madd(r.ex[2], py - r.ay[2], -(r.ey[2] * (px - r.ax[2])));
      const T sgn = r.area > T(0) ? T(1) : (r.area < T(0) ? T(-1) : T(0));
      if (!(w0 * sgn >= T(0) && w1 * sgn >= T(0) && w2 * sgn >= T(0))) continue;
      const T b0 = w0 / r.area, b1 = w1 / r.area, b2 = w2 / r.area;
      const T zpix = madd(b2, r.z[2], madd(b0, r.z[0], b1 * r.z[1]));
      const int rank = sid[i];
      if (zpix > T(1e-6) && (zpix < zbest || (zpix == zbest && best >= 0 && rank < best))) {
        zbest = zpix;
        best = rank;
      }
    }
    __syncthreads();
  }
  if (best >= F) best -= F;
  if (row < S && col < S) {
    T* o = out + (((long long)b * S + row) * S + col) * C;
    for (int c = 0; c < C; ++c) o[c] = best >= 0 ? tex[(long long)best * C + c] : T(0);
  }
}

template <typename T>
int launch(const void* verts, const int* faces, const void* tex, const uint8_t* skip, const int* order,
           int B, int V, int F, int S, int C, double scale, void* rec, void* box, void* extent, void* out,
           cudaStream_t stream) {
  const dim3 setup_grid((F + kChunk - 1) / kChunk, B);
  face_setup<T><<<setup_grid, kChunk, 0, stream>>>(
      static_cast<const T*>(verts), faces, order, skip, V, F, (T)scale,
      static_cast<FaceRecord<T>*>(rec), static_cast<float4*>(box), static_cast<float4*>(extent));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int tiles = ((S + kTile - 1) / kTile) * ((S + kTile - 1) / kTile);
  const auto* r = static_cast<const FaceRecord<T>*>(rec);
  const auto* bx = static_cast<const float4*>(box);
  if (order != nullptr) {
    raster<T, true><<<dim3(tiles, B), kThreads, 0, stream>>>(
        r, bx, nullptr, order, static_cast<const float4*>(extent), static_cast<const T*>(tex), F, S, C,
        static_cast<T*>(out));
  } else {
    raster<T, false><<<dim3(tiles, B), kThreads, 0, stream>>>(
        r, bx, skip, nullptr, nullptr, static_cast<const T*>(tex), F, S, C, static_cast<T*>(out));
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = float64. verts (B, V, 3); faces (F, 3) int32;
// tex (F, C); skip (B, F) uint8 codes or null (bit 0: the face takes no part;
// bit 1: it loses exact-z ties to every face without bit 1; 2F < 2^31);
// scale = S / orig_size; rec and box
// are scratch of B*F*16*sizeof(T) and B*F*16 bytes; out (B, S, S, C).
// Launches on `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int rasterize_flat(int dtype, const void* verts, const void* faces, const void* tex,
                              const void* skip, int B, int V, int F, int S, int C, double scale,
                              void* rec, void* box, void* out, void* stream) {
  const int* f = static_cast<const int*>(faces);
  const uint8_t* m = static_cast<const uint8_t*>(skip);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || F <= 0 || S <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return launch<float>(verts, f, tex, m, nullptr, B, V, F, S, C, scale, rec, box, nullptr, out, st);
    case 1: return launch<double>(verts, f, tex, m, nullptr, B, V, F, S, C, scale, rec, box, nullptr, out, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The banded raster (K3): as rasterize_flat without skip codes, plus
// order (B, F) int32, a permutation of 0..F-1 per image (the wrapper's
// y-centre sort), and extent, scratch of B*ceil(F/256)*16 bytes.
extern "C" int rasterize_flat_banded(int dtype, const void* verts, const void* faces, const void* tex,
                                     const void* order, int B, int V, int F, int S, int C, double scale,
                                     void* rec, void* box, void* extent, void* out, void* stream) {
  const int* f = static_cast<const int*>(faces);
  const int* o = static_cast<const int*>(order);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || F <= 0 || S <= 0 || C <= 0 || o == nullptr) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return launch<float>(verts, f, tex, nullptr, o, B, V, F, S, C, scale, rec, box, extent, out, st);
    case 1: return launch<double>(verts, f, tex, nullptr, o, B, V, F, S, C, scale, rec, box, extent, out, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
