// Fused STN part crop + grouped 3x3 partial-IUV head, for Hopper (sm_90a).
//
// Replaces the TPU kernel `danet_densepose2smpl_tpu/kernels/part_crop_head.py
// ::fused_part_predict` (Pallas `_kernel`). For each image b and part k:
//
//   tmp  = round(wy[b,k] @ feats[b])        (S, H) @ (H, W*C), fp32 accumulate
//   crop = round(wx[b,k] @ tmp)             per row: (S, W) @ (W, C)
//   out  = round(conv3x3(zero_pad(crop), weight[k]) + bias[k])
//
// with round() = cast to the input dtype, exactly where the TPU kernel rounds;
// the conv accumulates in fp32 (f64 for f64 inputs) and adds the bias there.
// The (B, 24, S, S, C) crop tensor never reaches device memory.
//
// Two kernels; the dtype alone picks one.
//
// bf16 (serving and eval): `part_crop_head_bf16_kernel`, the conv on the
// tensor cores. At the path's shape (B=64, 56x56x48 features, 24 parts,
// S=56, 21 outputs) the conv is 8.7e10 FLOP, 0.09 ms at the card's bf16
// peak. Once it runs there, the floor is memory traffic: 202 MB of output
// (0.06 ms at 3.35 TB/s) and, for the crop, ~1.2 GB of feature rows read
// from L2 (every part of an image interpolates from the same rows, which
// stay in the 50 MB L2). Measured per phase (`kernels/probe_part_crop_head
// .py`), the crop build's row steps take ~49% of the blocks' time and the
// y lists ~16%, both latency-bound on the CUDA cores; the MMAs ~27%. The
// design, part by part:
//   - One block per (image, part) walks its output rows in tiles of `rows`
//     rows. The crop rows live in shared memory in a ring of rows + 2 rows
//     (the conv's one-row halo each side), so each crop row is built once
//     per (image, part), not once per tile.
//   - Crop build: the non-zero interpolation weights of each row and column
//     are compacted into in-order lists (a warp ballot per 32 entries), so
//     the 2-tap bilinear case costs two taps and any dense matrix stays
//     right; a column's one or two taps are also packed into 8 bytes, read
//     with one load. A crop row a step: the one or two feature rows the
//     next row needs come into shared memory by 16-byte cp.async
//     (double-buffered) while this row is y-interpolated and the previous
//     one x-interpolated, with one barrier a step. Only the feature columns
//     the x lists read (about scale * W of them) are copied and
//     y-interpolated. Both interpolations run on 16-byte vectors of 8
//     channels with fp32 sums. A row of more than two taps (a dense matrix,
//     never the path's) reads its taps from global memory.
//   - The crop is kept channel-minor, [rows + 2][S + 2][Cpad + 8], C padded
//     with zeros to the MMA depth (16). The pixel stride of (Cpad + 8) * 2
//     bytes is an odd number of 16-byte units (112 bytes at C=48), so the
//     eight row addresses of an `ldmatrix` fall on distinct banks. A tap
//     (dy, dx) of the 3x3 conv is then only an address shift: im2col costs
//     nothing.
//   - The conv is an implicit GEMM per (image, part): M = tile pixels, N =
//     O padded to 24, K = 9 * Cpad in (dy, dx, c) order. `mma.sync
//     m16n8k16` (bf16 in, fp32 accumulate): A (16 pixels x 16 channels of
//     one tap) by `ldmatrix.x4` from the crop, B from the part's packed
//     weight tile [24][9 * Cpad + 8] in shared memory (the wrapper packs it,
//     cp.async brings it; the row stride is again an odd number of 16-byte
//     units). A warp runs two A fragments against the same three n8 B
//     fragments: six independent MMAs a step. A 16-pixel fragment may span
//     two image rows: every lane computes its own pixel's address, and the
//     ragged last fragment clamps its address and masks its store.
//     `mma.sync` rather than `wgmma`: a part's GEMM is narrow (N = 24) and
//     its 64-row wgmma tiles would straddle rows the same way, while the
//     MMAs are not what bounds the kernel.
//   - Epilogue: bias in fp32, round to bf16, stage the tile's rows x S x O
//     outputs in shared memory (over the crop-build buffers), then write
//     them as one contiguous span of the (B, K, S, S, O) output with 16-byte
//     stores.
//   - Shared memory sets the tile: at the path's shape 4 rows fit two blocks
//     on an SM (~105 KB each), so one block's copies and interpolation
//     overlap the other's MMAs.
//
// fp32 and f64: `part_crop_head_kernel`, scalar CUDA-core FMAs (their bars,
// 1e-4 with TF32 off and 1e-10, rule out TF32 and bf16 tensor cores). One
// block per (image, part, tile of output rows) builds the crop rows of its
// tile plus a one-row halo in shared memory (from zero-skipping lists of
// the interpolation weights) and runs the conv from there.
//
// Shared memory of a scalar block, for R = rows + 2 crop rows:
//   crop     [R][C][S+2]       input dtype, zero columns at both ends
//   then a region used twice:
//     phase 1: tmp [R][C][WP]   (WP = W rounded up to odd: no bank conflicts)
//              y lists: count[R], idx[R][H], val[R][H]
//              x lists: count[S], idx[S][W], val[S][W]
//     phase 2: weight [3][3][C][O] input dtype, bias [O] accumulator dtype

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kOutChunk = 8;  // output channels accumulated per thread

template <typename T> struct Acc { using type = float; };
template <> struct Acc<double> { using type = double; };

__device__ __forceinline__ float to_acc(float x) { return x; }
__device__ __forceinline__ double to_acc(double x) { return x; }

template <typename T> __device__ __forceinline__ T from_acc(typename Acc<T>::type x);
template <> __device__ __forceinline__ float from_acc<float>(float x) { return x; }
template <> __device__ __forceinline__ double from_acc<double>(double x) { return x; }

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

struct Layout {
  size_t crop, tmp, ycnt, yidx, yval, xcnt, xidx, xval, weight, bias, total;
};

// Byte offsets of every shared-memory array for a tile of `rows` output rows.
__host__ __device__ inline Layout make_layout(int rows, int H, int W, int C, int S, int O,
                                              size_t elem, size_t acc) {
  Layout L;
  const size_t R = rows + 2;
  const size_t WP = W | 1;
  L.crop = 0;
  size_t a = align16(R * C * (S + 2) * elem);
  L.tmp = a;
  size_t p = align16(a + R * C * WP * elem);
  L.ycnt = p; p = align16(p + R * sizeof(int));
  L.yidx = p; p = align16(p + R * H * sizeof(int16_t));
  L.yval = p; p = align16(p + R * H * elem);
  L.xcnt = p; p = align16(p + S * sizeof(int));
  L.xidx = p; p = align16(p + size_t(S) * W * sizeof(int16_t));
  L.xval = p; p = align16(p + size_t(S) * W * elem);
  size_t q = a;
  L.weight = q; q = align16(q + size_t(9) * C * O * elem);
  L.bias = q; q = align16(q + O * acc);
  L.total = p > q ? p : q;
  return L;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
part_crop_head_kernel(const T* __restrict__ feats,   // (B, H, W, C)
                      const T* __restrict__ wy,      // (B, K, S, H)
                      const T* __restrict__ wx,      // (B, K, S, W)
                      const T* __restrict__ weight,  // (K, 3, 3, C, O)
                      const T* __restrict__ bias,    // (K * O)
                      T* __restrict__ out,           // (B, K, S, S, O)
                      int H, int W, int C, int S, int K, int O, int rows) {
  using A = typename Acc<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = make_layout(rows, H, W, C, S, O, sizeof(T), sizeof(A));
  T* crop = reinterpret_cast<T*>(smem + L.crop);
  T* tmp = reinterpret_cast<T*>(smem + L.tmp);
  int* ycnt = reinterpret_cast<int*>(smem + L.ycnt);
  int16_t* yidx = reinterpret_cast<int16_t*>(smem + L.yidx);
  T* yval = reinterpret_cast<T*>(smem + L.yval);
  int* xcnt = reinterpret_cast<int*>(smem + L.xcnt);
  int16_t* xidx = reinterpret_cast<int16_t*>(smem + L.xidx);
  T* xval = reinterpret_cast<T*>(smem + L.xval);
  T* wsm = reinterpret_cast<T*>(smem + L.weight);
  A* bsm = reinterpret_cast<A*>(smem + L.bias);

  const int tid = threadIdx.x;
  const int y0 = blockIdx.x * rows;        // first output row of the tile
  const int k = blockIdx.y;
  const int b = blockIdx.z;
  const int R = rows + 2;                  // crop row r <-> image row y0 - 1 + r
  const int SP = S + 2;
  const int WP = W | 1;
  const T zero = from_acc<T>(A(0));

  // Phase 0: zero the crop (padding and rows outside [0, S)) and compact the
  // non-zero interpolation weights of this tile's rows and of all columns.
  for (int i = tid; i < R * C * SP; i += blockDim.x) crop[i] = zero;
  const T* wy_bk = wy + (size_t(b) * K + k) * S * H;
  const T* wx_bk = wx + (size_t(b) * K + k) * S * W;
  for (int t = tid; t < R + S; t += blockDim.x) {
    if (t < R) {
      const int gy = y0 - 1 + t;
      int n = 0;
      if (gy >= 0 && gy < S) {
        for (int h = 0; h < H; ++h) {
          const T v = wy_bk[size_t(gy) * H + h];
          if (to_acc(v) != A(0)) { yidx[t * H + n] = int16_t(h); yval[t * H + n] = v; ++n; }
        }
      }
      ycnt[t] = n;
    } else {
      const int x = t - R;
      int n = 0;
      for (int w = 0; w < W; ++w) {
        const T v = wx_bk[size_t(x) * W + w];
        if (to_acc(v) != A(0)) { xidx[x * W + n] = int16_t(w); xval[x * W + n] = v; ++n; }
      }
      xcnt[x] = n;
    }
  }
  __syncthreads();

  // Phase 1: y-interpolation of the needed rows, tmp[r][c][w], rounded.
  const T* f_b = feats + size_t(b) * H * W * C;
  for (int r = 0; r < R; ++r) {
    const int n = ycnt[r];
    for (int i = tid; i < W * C; i += blockDim.x) {
      A acc = A(0);
      for (int j = 0; j < n; ++j)
        acc += to_acc(yval[r * H + j]) * to_acc(f_b[size_t(yidx[r * H + j]) * W * C + i]);
      const int w = i / C, c = i - w * C;
      tmp[(r * C + c) * WP + w] = from_acc<T>(acc);
    }
  }
  __syncthreads();

  // Phase 2: x-interpolation, crop[r][c][x + 1], rounded. Rows outside the
  // image stay zero (the conv's zero padding).
  for (int i = tid; i < R * C * S; i += blockDim.x) {
    const int x = i % S;
    const int rc = i / S;
    const int r = rc / C;
    const int gy = y0 - 1 + r;
    if (gy < 0 || gy >= S) continue;
    const int n = xcnt[x];
    const T* trow = tmp + size_t(rc) * WP;
    A acc = A(0);
    for (int j = 0; j < n; ++j) acc += to_acc(xval[x * W + j]) * to_acc(trow[xidx[x * W + j]]);
    crop[size_t(rc) * SP + x + 1] = from_acc<T>(acc);
  }
  __syncthreads();

  // Phase 3: this part's conv weights and bias replace tmp and the lists.
  const T* w_k = weight + size_t(k) * 9 * C * O;
  for (int i = tid; i < 9 * C * O; i += blockDim.x) wsm[i] = w_k[i];
  for (int o = tid; o < O; o += blockDim.x) bsm[o] = to_acc(bias[size_t(k) * O + o]);
  __syncthreads();

  // Phase 4: 3x3 conv, one (pixel, chunk of kOutChunk outputs) per item;
  // neighbouring threads take neighbouring x (contiguous crop reads) and
  // read the same weights (broadcast).
  const int rv = min(rows, S - y0);
  const int n_chunks = (O + kOutChunk - 1) / kOutChunk;
  const int n_pix = rv * S;
  T* out_bk = out + (size_t(b) * K + k) * S * S * O;
  for (int it = tid; it < n_pix * n_chunks; it += blockDim.x) {
    const int chunk = it / n_pix;
    const int p = it - chunk * n_pix;
    const int ty = p / S, x = p - ty * S;
    const int o0 = chunk * kOutChunk;
    A acc[kOutChunk];
#pragma unroll
    for (int j = 0; j < kOutChunk; ++j) acc[j] = (o0 + j < O) ? bsm[o0 + j] : A(0);
    for (int dy = 0; dy < 3; ++dy) {
      for (int dx = 0; dx < 3; ++dx) {
        const T* crow = crop + size_t(ty + dy) * C * SP + x + dx;
        const T* wtap = wsm + size_t(dy * 3 + dx) * C * O + o0;
        for (int c = 0; c < C; ++c) {
          const A v = to_acc(crow[size_t(c) * SP]);
          const T* wrow = wtap + size_t(c) * O;
#pragma unroll
          for (int j = 0; j < kOutChunk; ++j)
            if (o0 + j < O) acc[j] += v * to_acc(wrow[j]);
        }
      }
    }
    T* dst = out_bk + (size_t(y0 + ty) * S + x) * O + o0;
#pragma unroll
    for (int j = 0; j < kOutChunk; ++j)
      if (o0 + j < O) dst[j] = from_acc<T>(acc[j]);
  }
}

// Largest tile height in (8, 4, 2, 1) that lets two blocks share an SM, else
// the largest that fits one block; 0 if none fits. `total(rows)` is the
// block's shared memory for a tile height.
template <typename F>
int pick_rows(F total, size_t* bytes) {
  const size_t two_per_sm = 113 * 1024, one_per_sm = 227 * 1024;
  const size_t budgets[2] = {two_per_sm, one_per_sm};
  for (size_t budget : budgets) {
    for (int rows = 8; rows >= 1; rows /= 2) {
      const size_t t = total(rows);
      if (t <= budget) { *bytes = t; return rows; }
    }
  }
  return 0;
}

template <typename T>
int launch(const void* feats, const void* wy, const void* wx, const void* weight,
           const void* bias, void* out, int B, int H, int W, int C, int S, int K, int O,
           cudaStream_t stream) {
  using A = typename Acc<T>::type;
  if (H > 32767 || W > 32767) return int(cudaErrorInvalidValue);
  size_t bytes = 0;
  const int rows = pick_rows(
      [&](int r) { return make_layout(r, H, W, C, S, O, sizeof(T), sizeof(A)).total; }, &bytes);
  if (rows == 0) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(part_crop_head_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(bytes));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((S + rows - 1) / rows, K, B);
  part_crop_head_kernel<T><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(feats), static_cast<const T*>(wy), static_cast<const T*>(wx),
      static_cast<const T*>(weight), static_cast<const T*>(bias), static_cast<T*>(out),
      H, W, C, S, K, O, rows);
  return int(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16: the conv on the tensor cores.

using bf16 = __nv_bfloat16;

constexpr int kWarps = kThreads / 32;
constexpr int kN = 24;  // output channels per GEMM pass: three n8 MMA tiles

// Sizes derived from C and O, the same on host and device.
struct Dims {
  int cpad;  // C rounded up to 16, the MMA depth
  int c8;    // C rounded up to 8: a staged feature row's pixel stride
  int cps;   // crop pixel stride in elements, cpad + 8: an odd number of 16-byte units
  int kdim;  // GEMM depth, 9 * cpad, in (dy, dx, c) order
  int kp;    // weight row stride in elements, kdim + 8: an odd number of 16-byte units
  int npad;  // O rounded up to kN
};

__host__ __device__ inline Dims make_dims(int C, int O) {
  Dims d;
  d.cpad = (C + 15) / 16 * 16;
  d.c8 = (C + 7) / 8 * 8;
  d.cps = d.cpad + 8;
  d.kdim = 9 * d.cpad;
  d.kp = d.kdim + 8;
  d.npad = (O + kN - 1) / kN * kN;
  return d;
}

struct TcLayout {
  size_t ring, wts, bias, xcnt, xidx, xval, xpk, ycnt, yidx, yval, items, stage, tmp, out, total;
};

// Byte offsets of the bf16 kernel's shared arrays for tiles of `rows` rows.
__host__ __device__ inline TcLayout make_tc_layout(int rows, int H, int W, int C, int S, int O) {
  const Dims d = make_dims(C, O);
  const size_t R = rows + 2;
  TcLayout L;
  size_t p = 0;
  L.ring = p; p = align16(p + R * (S + 2) * d.cps * sizeof(bf16));
  L.wts = p; p = align16(p + size_t(d.npad) * d.kp * sizeof(bf16));
  L.bias = p; p = align16(p + d.npad * sizeof(float));
  L.xcnt = p; p = align16(p + S * sizeof(int));
  L.xidx = p; p = align16(p + size_t(S) * W * sizeof(int16_t));
  L.xval = p; p = align16(p + size_t(S) * W * sizeof(bf16));
  L.xpk = p; p = align16(p + S * sizeof(uint2));
  L.ycnt = p; p = align16(p + (R + 3) * sizeof(int));      // + item count, column span
  L.yidx = p; p = align16(p + R * H * sizeof(int16_t));
  L.yval = p; p = align16(p + R * H * sizeof(bf16));
  L.items = p; p = align16(p + R * sizeof(int));
  // the crop build's buffers; the output stage reuses their bytes
  const size_t u = p;
  L.stage = p; p = align16(p + size_t(4) * W * d.c8 * sizeof(bf16));  // 2 steps x 2 feature rows
  L.tmp = p; p = align16(p + size_t(2) * W * d.cpad * sizeof(bf16));  // 2 steps
  L.out = u;
  const size_t q = align16(u + (size_t(rows) * S * O + 8) * sizeof(bf16));
  L.total = p > q ? p : q;
  return L;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2(uint32_t addr, uint32_t& r0, uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

// d += a (16x16, row-major) * b (16x8, column-major), bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void unpack8(uint4 v, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float* f) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return v;
}

__device__ __forceinline__ int thread_index() {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;\n" : "=r"(t));
  return t;
}

__device__ __forceinline__ uint4 ld16(const bf16* p) { return *reinterpret_cast<const uint4*>(p); }
__device__ __forceinline__ void st16(bf16* p, uint4 v) { *reinterpret_cast<uint4*>(p) = v; }

// One warp compacts the non-zero entries of row[0, n) into idx/val, in
// order; returns their count (to every lane).
__device__ __forceinline__ int compact_row(const bf16* __restrict__ row, int n, int16_t* idx,
                                           bf16* val, int lane) {
  int count = 0;
  for (int base = 0; base < n; base += 32) {
    const int h = base + lane;
    const bf16 v = h < n ? row[h] : __float2bfloat16_rn(0.f);
    const bool nz = __bfloat162float(v) != 0.f;
    const unsigned m = __ballot_sync(0xffffffffu, nz);
    if (nz) {
      const int pos = count + __popc(m & ((1u << lane) - 1u));
      idx[pos] = int16_t(h);
      val[pos] = v;
    }
    count += __popc(m);
  }
  return count;
}

__global__ void __launch_bounds__(kThreads, 2)
part_crop_head_bf16_kernel(const bf16* __restrict__ feats,   // (B, H, W, C)
                           const bf16* __restrict__ wy,      // (B, K, S, H)
                           const bf16* __restrict__ wx,      // (B, K, S, W)
                           const bf16* __restrict__ wpack,   // (K, npad, 9 * cpad)
                           const bf16* __restrict__ bias,    // (K * O)
                           bf16* __restrict__ out,           // (B, K, S, S, O)
                           int H, int W, int C, int S, int K, int O, int rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Dims d = make_dims(C, O);
  const TcLayout L = make_tc_layout(rows, H, W, C, S, O);
  bf16* ring = reinterpret_cast<bf16*>(smem + L.ring);   // [R][S + 2][cps]
  bf16* wts = reinterpret_cast<bf16*>(smem + L.wts);     // [npad][kp]
  float* bsm = reinterpret_cast<float*>(smem + L.bias);
  int* xcnt = reinterpret_cast<int*>(smem + L.xcnt);
  int16_t* xidx = reinterpret_cast<int16_t*>(smem + L.xidx);
  bf16* xval = reinterpret_cast<bf16*>(smem + L.xval);
  uint2* xpk = reinterpret_cast<uint2*>(smem + L.xpk);   // a column's taps when <= 2, packed
  int* ycnt = reinterpret_cast<int*>(smem + L.ycnt);     // [R] counts, item count, xlo, xhi
  int16_t* yidx = reinterpret_cast<int16_t*>(smem + L.yidx);
  bf16* yval = reinterpret_cast<bf16*>(smem + L.yval);
  int* items = reinterpret_cast<int*>(smem + L.items);   // the rows that have taps
  // feature columns xlo..xhi, the only ones the x lists read, are staged
  // and y-interpolated: column w at w - xlo
  bf16* stage = reinterpret_cast<bf16*>(smem + L.stage);  // [2][2][W][c8]
  bf16* tmp = reinterpret_cast<bf16*>(smem + L.tmp);      // [2][W][cpad]
  bf16* ostage = reinterpret_cast<bf16*>(smem + L.out);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k = blockIdx.x, b = blockIdx.y;   // the parts of an image run side by side
  const int R = rows + 2, SP = S + 2;
  const int G = d.cpad / 8, G8 = d.c8 / 8;    // 8-channel groups: crop, staged row
  const bf16* wy_bk = wy + (size_t(b) * K + k) * S * H;
  const bf16* wx_bk = wx + (size_t(b) * K + k) * S * W;
  const bf16* f_b = feats + size_t(b) * H * W * C;
  const size_t row_elems = size_t(W) * C;
  // a feature row is whole 16-byte chunks when C % 8 == 0; else it is
  // copied element by element into the padded staging layout
  const bool vec_rows = C % 8 == 0 && (reinterpret_cast<uintptr_t>(feats) & 15) == 0;

  // Set-up: the part's packed weight tile (asynchronous), its bias in fp32,
  // the x lists, and the ring's zero padding columns.
  {
    const bf16* w_k = wpack + size_t(k) * d.npad * d.kdim;
    const int chunks = d.kdim / 8;
    for (int i = tid; i < d.npad * chunks; i += kThreads) {
      const int n = i / chunks, q = i - n * chunks;
      cp_async16(wts + size_t(n) * d.kp + q * 8, w_k + size_t(n) * d.kdim + q * 8);
    }
    cp_async_commit();
  }
  for (int n = tid; n < d.npad; n += kThreads)
    bsm[n] = n < O ? __bfloat162float(bias[size_t(k) * O + n]) : 0.f;
  for (int x = warp; x < S; x += kWarps) {
    const int n = compact_row(wx_bk + size_t(x) * W, W, xidx + size_t(x) * W, xval + size_t(x) * W, lane);
    __syncwarp();
    if (lane == 0) {
      xcnt[x] = n;
      uint2 pk = make_uint2(0xffffu, 0u);   // more than two taps: read the list
      if (n <= 2) {
        const unsigned i0 = n > 0 ? xidx[x * W] : 0, i1 = n > 1 ? xidx[x * W + 1] : i0;
        const unsigned v0 = n > 0 ? __bfloat16_as_ushort(xval[x * W]) : 0u;
        const unsigned v1 = n > 1 ? __bfloat16_as_ushort(xval[x * W + 1]) : 0u;
        pk = make_uint2(i0 | i1 << 16, v0 | v1 << 16);   // no taps: both weights 0
      }
      xpk[x] = pk;
    }
  }
  const uint4 zero16 = make_uint4(0u, 0u, 0u, 0u);
  for (int i = tid; i < R * 2 * G; i += kThreads) {
    const int g = i % G, rc = i / G, col = (rc & 1) ? S + 1 : 0;
    st16(ring + (size_t(rc >> 1) * SP + col) * d.cps + g * 8, zero16);
  }

  // Copies the feature rows of work item i (a row of one or two taps) into
  // staging buffer i & 1; a row of more taps reads global memory instead.
  auto issue = [&](int i) {
    const int r = items[i], n = ycnt[r], xlo = ycnt[R + 1];
    const int span = (ycnt[R + 2] - xlo + 1) * C;   // elements of columns xlo..xhi
    bf16* dst = stage + size_t(i & 1) * 2 * W * d.c8;
    for (int tap = 0; tap < n && n <= 2; ++tap) {
      const bf16* src = f_b + size_t(yidx[r * H + tap]) * row_elems + size_t(xlo) * C;
      bf16* to = dst + size_t(tap) * W * d.c8;
      if (vec_rows) {
        for (int q = tid; q < span / 8; q += kThreads) cp_async16(to + q * 8, src + q * 8);
      } else {
        for (int e = tid; e < span; e += kThreads) {
          const int w = e / C;
          to[w * d.c8 + e - w * C] = src[e];
        }
      }
    }
    cp_async_commit();
  };

  const int n_tiles = (S + rows - 1) / rows;
  bf16* out_bk = out + (size_t(b) * K + k) * S * S * O;
  const uint32_t ring_s = smem_u32(ring), wts_s = smem_u32(wts);
  for (int t = 0; t < n_tiles; ++t) {
    const int y0 = t * rows, rv = min(rows, S - y0);
    // crop rows g_lo .. y0 + rv are built now; the first tile also builds
    // the halo row above, later tiles find rows y0 - 1 and y0 in the ring
    const int g_lo = t == 0 ? -1 : y0 + 1;
    const int nb = y0 + rv - g_lo + 1;

    for (int r = warp; r < nb; r += kWarps) {
      const int gy = g_lo + r;
      const int n = (gy >= 0 && gy < S)
                        ? compact_row(wy_bk + size_t(gy) * H, H, yidx + r * H, yval + r * H, lane)
                        : 0;
      if (lane == 0) ycnt[r] = n;
    }
    __syncthreads();
    if (tid == 0) {   // the work items: rows with taps, in order
      int m = 0;
      for (int r = 0; r < nb; ++r)
        if (ycnt[r] != 0) items[m++] = r;
      ycnt[R] = m;
      if (t == 0) {   // the feature columns the x lists read: xlo..xhi
        int lo = W, hi = -1;
        for (int x = 0; x < S; ++x) {
          const int n = xcnt[x];
          if (n != 0) {
            lo = min(lo, int(xidx[x * W]));
            hi = max(hi, int(xidx[x * W + n - 1]));
          }
        }
        ycnt[R + 1] = lo;
        ycnt[R + 2] = hi;
      }
    }
    for (int i = tid; i < nb * SP * G; i += kThreads) {   // rows without taps are zero
      const int r = i / (SP * G);
      if (ycnt[r] != 0) continue;
      const int rem = i - r * SP * G;
      st16(ring + (size_t((g_lo + r + 1) % R) * SP + rem / G) * d.cps + (rem % G) * 8, zero16);
    }
    __syncthreads();

    // Crop build, a row a step: step i copies row i + 1's feature rows
    // (asynchronous), y-interpolates row i and x-interpolates row i - 1.
    const int n_items = ycnt[R];
    if (n_items > 0) issue(0);
    for (int i = 0; i <= n_items; ++i) {
      cp_async_wait<0>();
      __syncthreads();
      if (i + 1 < n_items) issue(i + 1);
      // each thread takes one channel group of every P-th pixel: no division
      // in the loops (computed here, from a thread index the compiler does
      // not hoist, so that it holds no register through the MMAs)
      const int tv = thread_index(), P = kThreads / G;
      const int gq = tv % G, pq = tv < P * G ? tv / G : S + W;
      const int xlo = ycnt[R + 1], xhi = ycnt[R + 2];
      if (i < n_items) {   // y-interpolation: tmp[i & 1][w][c] = round(sum of the row's taps)
        const int r = items[i], n = ycnt[r];
        bf16* tw = tmp + size_t(i & 1) * W * d.cpad;
        const float w0 = __bfloat162float(yval[r * H]);
        const float w1 = n > 1 ? __bfloat162float(yval[r * H + 1]) : 0.f;
        const bf16* s0 = stage + size_t(i & 1) * 2 * W * d.c8;
        const bf16* s1 = s0 + size_t(W) * d.c8;
        const int g = gq;
        for (int w = xlo + pq; w <= xhi; w += P) {
          const int ws = w - xlo;
          float acc[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[e] = 0.f;
          if (n <= 2) {
            if (g < G8) {
              float f[8];
              unpack8(ld16(s0 + ws * d.c8 + g * 8), f);
#pragma unroll
              for (int e = 0; e < 8; ++e) acc[e] = fmaf(w0, f[e], acc[e]);
              if (n > 1) {
                unpack8(ld16(s1 + ws * d.c8 + g * 8), f);
#pragma unroll
                for (int e = 0; e < 8; ++e) acc[e] = fmaf(w1, f[e], acc[e]);
              }
            }
          } else {   // a dense row: every tap from global memory, in order
            for (int j = 0; j < n; ++j) {
              const float wv = __bfloat162float(yval[r * H + j]);
              const bf16* src = f_b + size_t(yidx[r * H + j]) * row_elems + size_t(w) * C + g * 8;
#pragma unroll
              for (int e = 0; e < 8; ++e)
                if (g * 8 + e < C) acc[e] = fmaf(wv, __bfloat162float(src[e]), acc[e]);
            }
          }
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[e] = g * 8 + e < C ? acc[e] : 0.f;   // zero channel padding
          st16(tw + ws * d.cpad + g * 8, pack8(acc));
        }
      }
      if (i > 0) {   // x-interpolation of row i - 1 into its ring slot, rounded
        const bf16* tr = tmp + size_t((i - 1) & 1) * W * d.cpad;
        bf16* crow = ring + size_t((g_lo + items[i - 1] + 1) % R) * SP * d.cps;
        const int g = gq;
        for (int x = pq; x < S; x += P) {
          const uint2 pk = xpk[x];
          float acc[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[e] = 0.f;
          if ((pk.x & 0xffffu) != 0xffffu) {   // two taps, one (the second weighs 0) or none
            if (pk.y != 0u) {
              const float w0 = __bfloat162float(__ushort_as_bfloat16(pk.y & 0xffffu));
              const float w1 = __bfloat162float(__ushort_as_bfloat16(pk.y >> 16));
              float f0[8], f1[8];
              unpack8(ld16(tr + (int(pk.x & 0xffffu) - xlo) * d.cpad + g * 8), f0);
              unpack8(ld16(tr + (int(pk.x >> 16) - xlo) * d.cpad + g * 8), f1);
#pragma unroll
              for (int e = 0; e < 8; ++e) acc[e] = fmaf(w1, f1[e], fmaf(w0, f0[e], 0.f));
            }
          } else {
            for (int jj = 0; jj < xcnt[x]; ++jj) {
              const float wv = __bfloat162float(xval[x * W + jj]);
              float f[8];
              unpack8(ld16(tr + (xidx[x * W + jj] - xlo) * d.cpad + g * 8), f);
#pragma unroll
              for (int e = 0; e < 8; ++e) acc[e] = fmaf(wv, f[e], acc[e]);
            }
          }
          st16(crow + (x + 1) * d.cps + g * 8, pack8(acc));
        }
      }
    }
    cp_async_wait<0>();   // the weight tile, when no row had a tap
    __syncthreads();

    // The conv as an implicit GEMM on the tensor cores.
    const int n_pix = rv * S;
    const size_t span0 = size_t(y0) * S * O;   // the tile's first output in out_bk
    const int mis = int((reinterpret_cast<uintptr_t>(out_bk + span0) & 15) >> 1);
    for (int m0 = warp * 32; m0 < n_pix; m0 += kWarps * 32) {   // two 16-pixel tiles a warp
      uint32_t arow[2][3];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int p = min(m0 + mt * 16 + (lane & 15), n_pix - 1);
        const int ty = p / S, x = p - ty * S;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
          arow[mt][dy] =
              ring_s + uint32_t(((((y0 + ty + dy) % R) * SP + x) * d.cps + (lane >> 4) * 8) * 2);
      }
      for (int nc = 0; nc < d.npad; nc += kN) {
        float acc[2][3][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 3; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
        const uint32_t koff = ((lane >> 3) & 1) * 8;
        const uint32_t b01 = wts_s + uint32_t(((nc + (lane & 7) + ((lane >> 4) << 3)) * d.kp + koff) * 2);
        const uint32_t b2 = wts_s + uint32_t(((nc + 16 + (lane & 7)) * d.kp + koff) * 2);
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const uint32_t a_shift = uint32_t((tap % 3) * d.cps * 2);
          const uint32_t b_tap = uint32_t(tap * d.cpad * 2);
          for (int cs = 0; cs < d.cpad; cs += 16) {
            uint32_t a[2][4], bq[4], bp[2];
            ldsm_x4(arow[0][tap / 3] + a_shift + cs * 2, a[0][0], a[0][1], a[0][2], a[0][3]);
            ldsm_x4(arow[1][tap / 3] + a_shift + cs * 2, a[1][0], a[1][1], a[1][2], a[1][3]);
            ldsm_x4(b01 + b_tap + cs * 2, bq[0], bq[1], bq[2], bq[3]);
            ldsm_x2(b2 + b_tap + cs * 2, bp[0], bp[1]);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              mma_bf16(acc[mt][0], a[mt], bq[0], bq[1]);
              mma_bf16(acc[mt][1], a[mt], bq[2], bq[3]);
              mma_bf16(acc[mt][2], a[mt], bp[0], bp[1]);
            }
          }
        }
        // bias in fp32, round, into the output stage
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 3; ++nt)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const int pr = m0 + mt * 16 + (lane >> 2) + hf * 8;
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int n = nc + nt * 8 + (lane & 3) * 2 + e;
                if (pr < n_pix && n < O)
                  ostage[mis + pr * O + n] = __float2bfloat16_rn(acc[mt][nt][hf * 2 + e] + bsm[n]);
              }
            }
      }
    }
    __syncthreads();

    // The tile's rows are one contiguous span of the output: 16-byte stores
    // (the stage is offset by the span's misalignment, so both sides align).
    const int total = n_pix * O;
    bf16* dst = out_bk + span0;
    const int head = min(total, (8 - mis) & 7);
    for (int e = tid; e < head; e += kThreads) dst[e] = ostage[mis + e];
    const int n_vec = (total - head) / 8;
    uint4* dv = reinterpret_cast<uint4*>(dst + head);
    const uint4* sv = reinterpret_cast<const uint4*>(ostage + mis + head);
    for (int q = tid; q < n_vec; q += kThreads) dv[q] = sv[q];
    for (int e = head + n_vec * 8 + tid; e < total; e += kThreads) dst[e] = ostage[mis + e];
    __syncthreads();
  }
}

int launch_bf16(const void* feats, const void* wy, const void* wx, const void* wpack,
                const void* bias, void* out, int B, int H, int W, int C, int S, int K, int O,
                cudaStream_t stream) {
  // int16 lists; every thread of the interpolations needs a channel group
  if (H > 32767 || W > 32767 || make_dims(C, O).cpad / 8 > kThreads) return int(cudaErrorInvalidValue);
  size_t bytes = 0;
  const int rows = pick_rows([&](int r) { return make_tc_layout(r, H, W, C, S, O).total; }, &bytes);
  if (rows == 0) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(part_crop_head_bf16_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return int(err);
  err = cudaFuncSetAttribute(part_crop_head_bf16_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             int(cudaSharedmemCarveoutMaxShared));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(K, B);
  part_crop_head_bf16_kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(feats), static_cast<const bf16*>(wy), static_cast<const bf16*>(wx),
      static_cast<const bf16*>(wpack), static_cast<const bf16*>(bias), static_cast<bf16*>(out),
      H, W, C, S, K, O, rows);
  return int(cudaGetLastError());
}

}  // namespace

// fp32 (dtype 0) and f64 (dtype 2): the scalar kernel; weight is (K, 3, 3,
// C, O). Returns a cudaError_t.
extern "C" int part_crop_head(int dtype, const void* feats, const void* wy, const void* wx,
                              const void* weight, const void* bias, void* out, int B, int H,
                              int W, int C, int S, int K, int O, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(feats, wy, wx, weight, bias, out, B, H, W, C, S, K, O, st);
    case 2: return launch<double>(feats, wy, wx, weight, bias, out, B, H, W, C, S, K, O, st);
    default: return int(cudaErrorInvalidValue);
  }
}

// bf16: the tensor-core kernel; wpack is `pack_head_weights`' (K, npad,
// 9 * cpad) tile. Returns a cudaError_t.
extern "C" int part_crop_head_bf16(const void* feats, const void* wy, const void* wx,
                                   const void* wpack, const void* bias, void* out, int B, int H,
                                   int W, int C, int S, int K, int O, void* stream) {
  return launch_bf16(feats, wy, wx, wpack, bias, out, B, H, W, C, S, K, O,
                     static_cast<cudaStream_t>(stream));
}
