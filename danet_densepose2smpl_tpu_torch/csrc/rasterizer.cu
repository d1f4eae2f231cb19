// Z-buffered flat-texture triangle rasterizer for the GT IUV images, for
// Hopper (sm_90a). Built by kernels/build.py with nvcc into a shared library
// with a plain C interface; the wrapper is kernels/rasterizer.py.
//
// Replaces, with one set of kernels, four functions of the JAX package:
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
// (the edge function as fma(ex, dy, -(ey * dx)), the depth as
// fma(b2, z2, fma(b0, z0, b1 * z1))).
//
// What bounds it on the H100. The TPU kernels test every pixel against every
// face with matmuls. The work that is needed is smaller: a (pixel centre,
// face) pair can only pass the inside test when the centre lies in the
// face's bounding box, and those pairs are what chip_smoke.py::raster_bound
// counts (26 fp32 operations each). At 224 px a body-sized soup has ~4e7 of
// them per image, a closed mesh ~1e5; the bytes (vertices in, the image
// out) take microseconds. So the bound is instruction issue on those pairs,
// and the design makes them the unit of work, spread evenly over the SMs
// whatever the faces' sizes (in fp32, the kernel's one dtype):
//   1. face_setup, one thread per (image, face slot): gathers the corners,
//      scales them to out-map units, and writes the face's pixel-centre span
//      (the columns and rows j with j + 0.5 inside its box, widened by a
//      pixel and clamped to the image; empty for an invalid or skipped
//      face), its rank and its pair count.
//   2. scan_counts, over each image's counts and then over the image
//      totals, gives every slot its int64 offset and the number of pairs,
//      on the card: the wrapper never reads a size back.
//   3. raster_pairs, a persistent grid of a few blocks per SM: each block
//      takes `budget` consecutive pairs at a time (grid stride, the total
//      read on the card), finds the slots of its first and last pair with a
//      32-way search of one warp, and stages their offsets in shared
//      memory. Each warp walks a contiguous share, its lanes on neighbouring
//      pairs, so they mostly shade neighbouring pixels of one face and agree
//      on the inside test. Pair q of a face is pixel (x0 + q mod w, y0 + q
//      div w); a lane rebuilds the face's edge vectors, depths and signed
//      area from the vertices once per face, steps its pixel 32 pairs at a
//      time, evaluates the inside test and the depth, and for 1e-6 < z < 1e9
//      sends key = (bits of z) << 32 | rank to a 64-bit atomicMin (a
//      fire-and-forget RED). Positive finite floats order as their bits, so
//      the least key is the least (z, rank). Reading the pixel's key first,
//      to skip atomics that cannot win, measured slower: the read waits on
//      L2, the RED does not.
//   4. resolve, one thread per pixel: the background for the empty key, else
//      the texture of the face the rank names.
// rank is the face id, plus F for faces whose code has bit 1 set, so an
// equal z keeps the lower id (rasterize_flat's first-index argmin within a
// chunk plus strict-less across chunks), and a marked face loses every tie
// to an unmarked one (the order of rasterize_flat_culled's compacted prefix,
// where the dead filler faces follow the live ones). The order in which the
// faces are walked changes no output, so K3's entry walks them in id order
// too (with K3's y-order it measured no faster). The span keeps the box's
// one-pixel margin, so it holds every pixel the fp32 inside test can
// accept; the kernel therefore
// enumerates somewhat more pairs than raster_bound's exact boxes
// (chip_smoke.py prints both). Per pair the kernel issues ~70 instructions
// (three IEEE divisions are ~30 of them), not the bound's 26 operations, so
// on large faces it is bound by instruction issue at a few times the bound.
//
// fp64 (the tests and the f64 training step) has no kernel: on the card each
// entry runs its plain PyTorch version, as on the CPU. A 64-bit key cannot
// hold an fp64 depth and a rank, and no served or timed path rasterizes in
// fp64.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSetupThreads = 256;
constexpr int kScanThreads = 1024;
constexpr int kPairThreads = 256;
constexpr int kMinBudget = 4096;              // the fewest consecutive pairs a block takes at a time
constexpr int kRoundsPerBlock = 16;           // the pairs are cut into about this many budgets per block
constexpr int kWindow = 2048;                 // face offsets staged in shared memory at a time
constexpr float kEmpty = 1e30f;               // the empty box is (kEmpty, -kEmpty, kEmpty, -kEmpty)
constexpr unsigned long long kEmptyKey = ~0ull;

// Corner k's edge function is w_k = ex[k] * (py - ay[k]) - ey[k] * (px - ax[k])
// with a = v[(k+1)%3], e = v[(k+2)%3] - a: w0 = edge(v1, v2), w1 = edge(v2, v0),
// w2 = edge(v0, v1), as in rasterizer.py.
struct FaceRecord {
  float ax[3], ay[3], ex[3], ey[3], z[3], area;
};

// The least depth of the face at pixel centre (px, py), or 0 when the centre
// is outside the face (0 fails the caller's z > 1e-6 test).
__device__ __forceinline__ float face_depth(const FaceRecord& r, float px, float py) {
  const float w0 = __fmaf_rn(r.ex[0], py - r.ay[0], -(r.ey[0] * (px - r.ax[0])));
  const float w1 = __fmaf_rn(r.ex[1], py - r.ay[1], -(r.ey[1] * (px - r.ax[1])));
  const float w2 = __fmaf_rn(r.ex[2], py - r.ay[2], -(r.ey[2] * (px - r.ax[2])));
  const float sgn = r.area > 0.0f ? 1.0f : (r.area < 0.0f ? -1.0f : 0.0f);
  if (!(w0 * sgn >= 0.0f && w1 * sgn >= 0.0f && w2 * sgn >= 0.0f)) return 0.0f;
  const float b0 = w0 / r.area, b1 = w1 / r.area, b2 = w2 / r.area;
  return __fmaf_rn(b2, r.z[2], __fmaf_rn(b0, r.z[0], b1 * r.z[1]));
}

// Face f's corners in image b, in out-map units (x, y) and depth (z).
__device__ __forceinline__ void gather_face(const float* __restrict__ verts, const int* __restrict__ faces, int V,
                                            int b, int f, float scale, float* x, float* y, float* z) {
  const float* vb = verts + (long long)b * V * 3;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int vi = faces[f * 3 + k];
    x[k] = vb[vi * 3 + 0] * scale;
    y[k] = vb[vi * 3 + 1] * scale;
    z[k] = vb[vi * 3 + 2];
  }
}

__device__ __forceinline__ FaceRecord make_record(const float* x, const float* y, const float* z) {
  FaceRecord r;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int a = (k + 1) % 3, c = (k + 2) % 3;
    r.ax[k] = x[a];
    r.ay[k] = y[a];
    r.ex[k] = x[c] - x[a];
    r.ey[k] = y[c] - y[a];
    r.z[k] = z[k];
  }
  r.area = (x[1] - x[0]) * (y[2] - y[0]) - (y[1] - y[0]) * (x[2] - x[0]);
  return r;
}

// One block per (kSetupThreads faces, image), one face a thread: the face's
// span, rank and pair count (raster_pairs rebuilds a record from the
// vertices, which costs less than writing 64 bytes a face and reading them
// back).
__global__ void __launch_bounds__(kSetupThreads)
face_setup(const float* __restrict__ verts, const int* __restrict__ faces, const uint8_t* __restrict__ skip, int V,
           int F, int S, float scale, int4* __restrict__ span, long long* __restrict__ count) {
  const int b = blockIdx.y;
  const int f = blockIdx.x * kSetupThreads + threadIdx.x;
  if (f >= F) return;
  const long long i = (long long)b * F + f;
  float x[3], y[3], z[3];
  gather_face(verts, faces, V, b, f, scale, x, y, z);
  const float area = make_record(x, y, z).area;
  const int code = skip != nullptr ? skip[i] : 0;
  const bool valid = fabsf(area) > 1e-12f && z[0] > 0.0f && z[1] > 0.0f && z[2] > 0.0f && !(code & 1);
  float4 bx = make_float4(kEmpty, -kEmpty, kEmpty, -kEmpty);   // (xmin, xmax, ymin, ymax)
  if (valid) {
    bx.x = fminf(fminf(x[0], x[1]), x[2]) - 1.0f;
    bx.y = fmaxf(fmaxf(x[0], x[1]), x[2]) + 1.0f;
    bx.z = fminf(fminf(y[0], y[1]), y[2]) - 1.0f;
    bx.w = fmaxf(fmaxf(y[0], y[1]), y[2]) + 1.0f;
  }
  // centres j + 0.5 in [lo, hi]: j from ceil(lo - 0.5) to floor(hi - 0.5),
  // clamped to [0, S) (kernels/rasterizer.py::pixel_spans mirrors this)
  const float fs = (float)S;
  const int x0 = (int)fminf(fmaxf(ceilf(bx.x - 0.5f), 0.0f), fs);
  const int x1 = (int)fminf(fmaxf(floorf(bx.y - 0.5f) + 1.0f, 0.0f), fs);
  const int y0 = (int)fminf(fmaxf(ceilf(bx.z - 0.5f), 0.0f), fs);
  const int y1 = (int)fminf(fmaxf(floorf(bx.w - 0.5f) + 1.0f, 0.0f), fs);
  const int w = max(x1 - x0, 0), h = max(y1 - y0, 0);
  const int dr = w > 0 ? 32 / w : 0, dc = w > 0 ? 32 % w : 0;
  const int rank = (code & 2) ? f + F : f;
  // (x0 | y0 << 16, w | (32 / w) << 16 | (32 % w) << 24, rank, the z-buffer
  // index of pixel (y0, x0)); S < 2^15 and (B+1)*S*S < 2^31
  span[i] = make_int4(x0 | y0 << 16, w | dr << 16 | dc << 24, rank, (b * S + y0) * S + x0);
  count[i] = (long long)w * h;
}

// One block per row of `off` (F values each): the row becomes its exclusive
// prefix sum, in place, in rounds of kScanThreads, and its sum goes to
// totals[row]. Run over the (B, F) pair counts, then over the B image
// totals (with totals + B): the offset of slot k is then
// totals[k / F] + off[k], and totals[B] the number of pairs.
__global__ void __launch_bounds__(kScanThreads)
scan_counts(long long* __restrict__ off, int F, long long* __restrict__ totals) {
  __shared__ long long wsum[kScanThreads / 32];
  long long* o = off + (long long)blockIdx.x * F;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  long long carry = 0;
  for (int base = 0; base < F; base += kScanThreads) {
    const int i = base + threadIdx.x;
    const long long v = i < F ? o[i] : 0;
    long long x = v;   // inclusive scan within the warp
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const long long y = __shfl_up_sync(0xffffffffu, x, d);
      if (lane >= d) x += y;
    }
    if (lane == 31) wsum[warp] = x;
    __syncthreads();
    long long before = carry, round = 0;
#pragma unroll 4
    for (int w = 0; w < kScanThreads / 32; ++w) {
      const long long s = wsum[w];
      before += w < warp ? s : 0;
      round += s;
    }
    if (i < F) o[i] = before + x - v;
    __syncthreads();   // wsum is rewritten by the next round
    carry += round;
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = carry;
}

// The pairs p, p + 32, ... below `end` of one lane (the lanes of a warp
// take neighbouring pairs, so they shade neighbouring pixels of one face and
// mostly agree on the inside test). The slots k + j of the window have their
// offsets staged in soff[0..n] (soff[n] lies past `end`). A lane loads a
// face's record and span, and divides its pair index by the span's width,
// once per face; within the face it steps its pixel by 32 pairs (pixel
// centres stay exact: integers plus 0.5 below 2^23).
__device__ __forceinline__ void walk_pairs(const float* __restrict__ verts, const int* __restrict__ faces, int V,
                                           float scale, const int4* __restrict__ span, const long long* soff, int k,
                                           int n, long long p, long long end, int F, int S,
                                           unsigned long long* __restrict__ zbuf) {
  if (p >= end) return;
  int j = 0, hi = n - 1;   // the last staged slot whose offset is <= p
  while (j < hi) {
    const int mid = (j + hi + 1) / 2;
    if (soff[mid] <= p) j = mid; else hi = mid - 1;
  }
  while (true) {
    const int slot = k + j;
    const int4 sp = __ldg(span + slot);   // see face_setup for the packing
    float x[3], y[3], z[3];
    gather_face(verts, faces, V, slot / F, sp.z >= F ? sp.z - F : sp.z, scale, x, y, z);
    const FaceRecord r = make_record(x, y, z);
    const int x0 = sp.x & 0xffff, y0 = sp.x >> 16, w = sp.y & 0xffff;
    const int dr = (sp.y >> 16) & 0xff, dc = sp.y >> 24;   // the step of 32 pairs: dr rows, dc columns
    const int q = (int)(p - soff[j]);
    int dy = __float2int_rz(__fdividef((float)q, (float)w));   // q / w, off by at most one
    if (dy * w > q) --dy; else if ((dy + 1) * w <= q) ++dy;
    const int dx = q - dy * w, x_end = x0 + w, step = dr * S + dc;
    int col = x0 + dx, pix = sp.w + dy * S + dx;
    float px = float(col) + 0.5f, py = float(y0 + dy) + 0.5f;
    const int n_mine = (int)((min(soff[j + 1], end) - p + 31) / 32);   // this lane's pairs of the face
    p += 32LL * n_mine;
    for (int i = 0; i < n_mine; ++i) {
      const float zpix = face_depth(r, px, py);
      if (zpix > 1e-6f && zpix < 1e9f)
        atomicMin(zbuf + pix, ((unsigned long long)__float_as_uint(zpix) << 32) | (unsigned)sp.z);
      col += dc;
      px += float(dc);
      py += float(dr);
      pix += step;
      if (col >= x_end) {
        col -= w;
        px -= float(w);
        py += 1.0f;
        pix += S - w;
      }
    }
    if (p >= end) return;
    do ++j; while (soff[j + 1] <= p);   // the face of pair p
  }
}

// One step of a 32-way search of a warp for the last slot whose offset is
// <= p, kept in [lo, hi): off[lo] <= p, and off[hi] > p where hi < n_slots.
__device__ __forceinline__ long long slot_offset(const long long* __restrict__ off,
                                                 const long long* __restrict__ totals, int F, int k) {
  return totals[k / F] + off[k];
}

__device__ __forceinline__ void search_step(const long long* __restrict__ off, const long long* __restrict__ totals,
                                            int F, long long p, int lane, int& lo, int& hi) {
  if (hi - lo <= 1) return;   // warp-uniform
  const int stride = (hi - lo + 31) / 32;
  const int idx = lo + lane * stride;
  const unsigned le = __ballot_sync(0xffffffffu, idx < hi && slot_offset(off, totals, F, idx) <= p);
  lo += (31 - __clz(le)) * stride;   // lane 0 probes lo itself
  hi = min(hi, lo + stride);
}

// The persistent grid over all pairs (slot offsets as scan_counts leaves
// them). A block takes `budget` consecutive
// pairs at a time: warp 0 finds the slots of its first and last pair, the
// block stages their offsets in shared memory (in windows of kWindow
// slots), and each warp walks a contiguous share of the pairs.
__global__ void __launch_bounds__(kPairThreads)
raster_pairs(const float* __restrict__ verts, const int* __restrict__ faces, int V, float scale,
             const int4* __restrict__ span, const long long* __restrict__ off, const long long* __restrict__ totals,
             int B, int F, int S, unsigned long long* __restrict__ zbuf) {
  __shared__ long long soff[kWindow + 1];
  __shared__ int sfirst, slast;
  const int n_slots = B * F;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long total = totals[B];
  // about kRoundsPerBlock budgets a block: more keep the blocks equally busy,
  // fewer wait less on the searches
  const long long budget = max((long long)kMinBudget, (total + (long long)gridDim.x * kRoundsPerBlock - 1) /
                                                          ((long long)gridDim.x * kRoundsPerBlock));
  for (long long p0 = blockIdx.x * budget; p0 < total; p0 += gridDim.x * budget) {
    const long long p1 = min(p0 + budget, total);
    if (warp == 0) {
      int lo0 = 0, hi0 = n_slots, lo1 = 0, hi1 = n_slots;
      while (hi0 - lo0 > 1 || hi1 - lo1 > 1) {   // both searches in step
        search_step(off, totals, F, p0, lane, lo0, hi0);
        search_step(off, totals, F, p1 - 1, lane, lo1, hi1);
      }
      if (lane == 0) {
        sfirst = lo0;
        slast = lo1;
      }
    }
    __syncthreads();
    const int last = slast;
    int k = sfirst;
    long long q0 = p0;
    while (q0 < p1) {   // a face with no pairs costs a staged offset
      const int n = min(kWindow, last + 1 - k);
      for (int i = threadIdx.x; i <= n; i += kPairThreads)
        soff[i] = k + i < n_slots ? slot_offset(off, totals, F, k + i) : total;
      __syncthreads();
      const long long q1 = min(p1, soff[n]);
      const long long share = (q1 - q0 + kPairThreads / 32 - 1) / (kPairThreads / 32);
      const long long start = q0 + warp * share;
      walk_pairs(verts, faces, V, scale, span, soff, k, n, start + lane, min(start + share, q1), F, S, zbuf);
      __syncthreads();   // soff, sfirst and slast are rewritten next
      q0 = q1;
      k += n;
    }
  }
}

// One thread per pixel: the texture of the face its key names, or 0.
__global__ void __launch_bounds__(256)
resolve(const unsigned long long* __restrict__ zbuf, const float* __restrict__ tex, int n_pix, int F, int C,
        float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_pix) return;
  const unsigned long long key = zbuf[i];
  float* o = out + (long long)i * C;
  if (key == kEmptyKey) {
    for (int c = 0; c < C; ++c) o[c] = 0.0f;
    return;
  }
  int rank = (int)(unsigned)key;
  if (rank >= F) rank -= F;
  for (int c = 0; c < C; ++c) o[c] = tex[(long long)rank * C + c];
}

#define RETURN_IF_FAILED()                          \
  do {                                              \
    const cudaError_t e = cudaGetLastError();       \
    if (e != cudaSuccess) return (int)e;            \
  } while (0)

int launch_pairs(const float* verts, const int* faces, const float* tex, const uint8_t* skip, int B, int V, int F,
                 int S, int C, float scale, int4* span, long long* off, long long* totals, unsigned long long* zbuf,
                 float* out, cudaStream_t st) {
  const int n_pix = B * S * S;
  cudaError_t e = cudaMemsetAsync(zbuf, 0xff, (size_t)n_pix * sizeof(unsigned long long), st);   // kEmptyKey
  if (e != cudaSuccess) return (int)e;
  const dim3 per_face((F + kSetupThreads - 1) / kSetupThreads, B);
  face_setup<<<per_face, kSetupThreads, 0, st>>>(verts, faces, skip, V, F, S, scale, span, off);
  RETURN_IF_FAILED();
  scan_counts<<<B, kScanThreads, 0, st>>>(off, F, totals);
  RETURN_IF_FAILED();
  scan_counts<<<1, kScanThreads, 0, st>>>(totals, B, totals + B);
  RETURN_IF_FAILED();
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, raster_pairs, kPairThreads, 0)) != cudaSuccess)
    return (int)e;
  raster_pairs<<<sms * max(per_sm, 1), kPairThreads, 0, st>>>(verts, faces, V, scale, span, off, totals, B, F, S,
                                                                 zbuf);
  RETURN_IF_FAILED();
  resolve<<<(n_pix + 255) / 256, 256, 0, st>>>(zbuf, tex, n_pix, F, C, out);
  RETURN_IF_FAILED();
  return 0;
}

}  // namespace

// verts (B, V, 3) float32; faces (F, 3) int32; tex (F, C) float32; skip
// (B, F) uint8 codes or null (bit 0: the face takes no part; bit 1: it loses
// exact-z ties to every face without bit 1); scale = S / orig_size; 2F, B*F
// and (B+1)*S*S < 2^31, S < 2^15. Scratch: span B*F int4, off B*F int64,
// totals B+1 int64 (totals[B] = the pairs enumerated) and zbuf B*S*S uint64.
// out (B, S, S, C) float32. Launches on `stream`, allocates nothing, never
// synchronizes; returns the first CUDA error, or 0.
extern "C" int rasterize_flat(const void* verts, const void* faces, const void* tex, const void* skip, int B, int V,
                              int F, int S, int C, double scale, void* span, void* off, void* totals, void* zbuf,
                              void* out, void* stream) {
  if (B <= 0 || F <= 0 || S <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  return launch_pairs(static_cast<const float*>(verts), static_cast<const int*>(faces),
                      static_cast<const float*>(tex), static_cast<const uint8_t*>(skip), B, V, F, S, C,
                      (float)scale, static_cast<int4*>(span), static_cast<long long*>(off),
                      static_cast<long long*>(totals), static_cast<unsigned long long*>(zbuf),
                      static_cast<float*>(out), static_cast<cudaStream_t>(stream));
}
