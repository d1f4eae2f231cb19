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
// bf16 (serving and eval): `part_crop_head_bf16_kernel<CH>`, for every C (the
// HRNet's 48, the padded HRNet's 64, the ResNet backbone's 256). At B=64,
// 56x56xC features, 24 parts, S=56, O=21 outputs, the conv is 2*B*24*S*S*O*9*C
// FLOP (4.7e11 at C=256: 0.48 ms at the card's bf16 peak; 8.7e10 at C=48)
// and the bytes are ~0.2 GB of output (0.06 ms at 3.35 TB/s), so the bound
// is the operations. What the kernel spends its time on is measured per
// phase by `kernels/probe_part_crop_head.py` (PERF.md §6). The design:
//   - One block (8 warps) per (image, part) walks its output rows in tiles
//     of `rows` rows (8 at S = 56: 448 pixels, 28 MMA tiles of 16 pixels, up
//     to 4 a warp) and takes the channels in chunks of CH = 16 or 32 (a
//     template argument); `kernels/part_crop_head.py::bf16_plan` picks both
//     by a rule measured on the card. The tile's GEMM sums stay in registers
//     across all of C: no sums go through shared memory between chunks.
//   - Per (tile, chunk), three phases and two barriers. (1) y-interpolation
//     of the tile's rows + 2 halo rows, from the feature rows in global
//     memory (L1/L2, 16-byte loads, two crop rows a job with their loads in
//     flight together) into `tmp`, rounded to bf16; only the feature columns
//     the x taps read are interpolated. (2) x-interpolation into the crop,
//     rounded, on the tensor cores: for each group of 16 crop columns whose
//     taps span at most 32 feature columns (every group of a bilinear box
//     with scale < ~2), its A tile A[x][j] = wx[x][wlo + j], built once per
//     block, times the 16 or 32 `tmp` columns from wlo (`ldmatrix.trans`),
//     stored by `stmatrix`; other groups (dense matrices) sum their taps on
//     the CUDA cores. `tmp`'s 16-byte chunks are swizzled so that those
//     loads hit distinct banks. (3) The conv as an implicit GEMM: M = tile
//     pixels, N = O padded to 24, K = 9 * CH in (dy, dx, c) order,
//     `mma.sync m16n8k16` (bf16 in, fp32 accumulate): A by `ldmatrix.x4`
//     from the crop, kept channel-minor [rows + 2][S + 2][CH + 8] (a pixel
//     stride of an odd number of 16-byte units: conflict-free rows; a tap is
//     only an address shift), B from the chunk's packed weight tile
//     [24][9 * CH + 8] (the wrapper packs it chunk by chunk, `cp.async`
//     brings it while (2) runs, and a one-chunk C keeps it for all tiles).
//   - Epilogue per tile: bias in fp32, round, stage the tile's outputs over
//     the crop's bytes, and write them as one contiguous span of the
//     (B, K, S, S, O) output with 16-byte stores.
//   - Shared memory (~105 KB at CH = 32, 8 rows) and 126 registers let two
//     blocks share an SM; one block's interpolation overlaps the other's
//     MMAs. Each chunk rebuilds its tile's halo rows (1.25x the crop work
//     at 8-row tiles): the price of register sums across chunks.
//   - `mma.sync` rather than `wgmma`: at C=256 the conv's MMA phase is
//     bound by the shared-memory reads of its A fragments (each crop value
//     is read once per tap, N = 24 is narrow), which `wgmma` reads alike;
//     the probe puts the MMAs at ~40% of block time, the interpolations at
//     ~53%.
//
// fp32 and f64: `part_crop_head_kernel`, scalar CUDA-core FMAs (their bars,
// 1e-4 with TF32 off and 1e-10, rule out TF32 and bf16 tensor cores). One
// block per (image, part, tile of output rows) builds the crop rows of its
// tile plus a one-row halo in shared memory (from zero-skipping lists of
// the interpolation weights) and runs the conv from there. Where all of C
// does not fit, the channels pass in chunks of CC = 32, each rebuilding the
// crop, its sums carried in shared memory.
//
// Shared memory of a scalar block, for R = rows + 2 crop rows and a chunk
// of CC channels (CC = C when it fits):
//   crop     [R][CC][S+2]      input dtype, zero columns at both ends
//   then a region used twice:
//     phase 1: tmp [R][CC][WP]  (WP = W rounded up to odd: no bank conflicts)
//              y lists: count[R], idx[R][H], val[R][H]
//              x lists: count[S], idx[S][W], val[S][W]
//     phase 2: weight [3][3][CC][O] input dtype, bias [O] accumulator dtype
//   in chunks, then: acc [rows][S][O] accumulator dtype

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
  size_t crop, tmp, ycnt, yidx, yval, xcnt, xidx, xval, weight, bias, acc, total;
};

// Byte offsets of every shared-memory array for a tile of `rows` output rows
// and a chunk of CC channels; `chunked` adds the accumulators that carry the
// conv's sums from one chunk to the next.
__host__ __device__ inline Layout make_layout(int rows, int H, int W, int CC, int S, int O,
                                              size_t elem, size_t acc, bool chunked) {
  Layout L;
  const size_t R = rows + 2;
  const size_t WP = W | 1;
  L.crop = 0;
  size_t a = align16(R * CC * (S + 2) * elem);
  L.tmp = a;
  size_t p = align16(a + R * CC * WP * elem);
  L.ycnt = p; p = align16(p + R * sizeof(int));
  L.yidx = p; p = align16(p + R * H * sizeof(int16_t));
  L.yval = p; p = align16(p + R * H * elem);
  L.xcnt = p; p = align16(p + S * sizeof(int));
  L.xidx = p; p = align16(p + size_t(S) * W * sizeof(int16_t));
  L.xval = p; p = align16(p + size_t(S) * W * elem);
  size_t q = a;
  L.weight = q; q = align16(q + size_t(9) * CC * O * elem);
  L.bias = q; q = align16(q + O * acc);
  L.acc = p > q ? p : q;
  L.total = L.acc + (chunked ? align16(size_t(rows) * S * O * acc) : 0);
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
                      int H, int W, int C, int S, int K, int O, int rows, int CC) {
  using A = typename Acc<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_chunks = (C + CC - 1) / CC;
  const Layout L = make_layout(rows, H, W, CC, S, O, sizeof(T), sizeof(A), n_chunks > 1);
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
  A* asm_ = reinterpret_cast<A*>(smem + L.acc);   // [rows][S][O], between chunks

  const int tid = threadIdx.x;
  const int y0 = blockIdx.x * rows;        // first output row of the tile
  const int k = blockIdx.y;
  const int b = blockIdx.z;
  const int R = rows + 2;                  // crop row r <-> image row y0 - 1 + r
  const int SP = S + 2;
  const int WP = W | 1;
  const T zero = from_acc<T>(A(0));
  const T* wy_bk = wy + (size_t(b) * K + k) * S * H;
  const T* wx_bk = wx + (size_t(b) * K + k) * S * W;
  const T* f_b = feats + size_t(b) * H * W * C;

  // The channels pass in chunks of CC (one chunk when all of C fits); the
  // conv's sums carry over in `asm_`. A chunk's phases 0-2 rebuild its crop
  // (the weight tile of phase 3 overwrites the lists).
  for (int cc = 0; cc < n_chunks; ++cc) {
    const int cbase = cc * CC;
    const int cn = min(CC, C - cbase);   // channels of this chunk
    // Phase 0: zero the crop (padding and rows outside [0, S)) and compact
    // the non-zero interpolation weights of this tile's rows and of all
    // columns.
    for (int i = tid; i < R * CC * SP; i += blockDim.x) crop[i] = zero;
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
    for (int r = 0; r < R; ++r) {
      const int n = ycnt[r];
      for (int i = tid; i < W * cn; i += blockDim.x) {
        const int w = i / cn, c = i - w * cn;
        const T* src = f_b + size_t(w) * C + cbase + c;
        A acc = A(0);
        for (int j = 0; j < n; ++j) acc += to_acc(yval[r * H + j]) * to_acc(src[size_t(yidx[r * H + j]) * W * C]);
        tmp[(r * CC + c) * WP + w] = from_acc<T>(acc);
      }
    }
    __syncthreads();

    // Phase 2: x-interpolation, crop[r][c][x + 1], rounded. Rows outside the
    // image stay zero (the conv's zero padding), as do a last chunk's
    // channels past C.
    for (int i = tid; i < R * CC * S; i += blockDim.x) {
      const int x = i % S;
      const int rc = i / S;
      const int r = rc / CC;
      const int gy = y0 - 1 + r;
      if (gy < 0 || gy >= S || rc - r * CC >= cn) continue;
      const int n = xcnt[x];
      const T* trow = tmp + size_t(rc) * WP;
      A acc = A(0);
      for (int j = 0; j < n; ++j) acc += to_acc(xval[x * W + j]) * to_acc(trow[xidx[x * W + j]]);
      crop[size_t(rc) * SP + x + 1] = from_acc<T>(acc);
    }
    __syncthreads();

    // Phase 3: this part's conv weights of the chunk (zero past C) and the
    // bias replace tmp and the lists.
    const T* w_k = weight + size_t(k) * 9 * C * O;
    for (int i = tid; i < 9 * CC * O; i += blockDim.x) {
      const int o = i % O, tc = i / O, tap = tc / CC, c = tc - tap * CC;
      wsm[i] = c < cn ? w_k[(size_t(tap) * C + cbase + c) * O + o] : zero;
    }
    for (int o = tid; o < O; o += blockDim.x) bsm[o] = to_acc(bias[size_t(k) * O + o]);
    __syncthreads();

    // Phase 4: 3x3 conv, one (pixel, chunk of kOutChunk outputs) per item;
    // neighbouring threads take neighbouring x (contiguous crop reads) and
    // read the same weights (broadcast). The first chunk starts from the
    // bias, the last writes the output.
    const int rv = min(rows, S - y0);
    const int n_oc = (O + kOutChunk - 1) / kOutChunk;
    const int n_pix = rv * S;
    T* out_bk = out + (size_t(b) * K + k) * S * S * O;
    for (int it = tid; it < n_pix * n_oc; it += blockDim.x) {
      const int chunk = it / n_pix;
      const int p = it - chunk * n_pix;
      const int ty = p / S, x = p - ty * S;
      const int o0 = chunk * kOutChunk;
      A acc[kOutChunk];
#pragma unroll
      for (int j = 0; j < kOutChunk; ++j)
        acc[j] = (o0 + j < O) ? (cc == 0 ? bsm[o0 + j] : asm_[p * O + o0 + j]) : A(0);
      for (int dy = 0; dy < 3; ++dy) {
        for (int dx = 0; dx < 3; ++dx) {
          const T* crow = crop + size_t(ty + dy) * CC * SP + x + dx;
          const T* wtap = wsm + size_t(dy * 3 + dx) * CC * O + o0;
          for (int c = 0; c < cn; ++c) {
            const A v = to_acc(crow[size_t(c) * SP]);
            const T* wrow = wtap + size_t(c) * O;
#pragma unroll
            for (int j = 0; j < kOutChunk; ++j)
              if (o0 + j < O) acc[j] += v * to_acc(wrow[j]);
          }
        }
      }
      if (cc + 1 < n_chunks) {
#pragma unroll
        for (int j = 0; j < kOutChunk; ++j)
          if (o0 + j < O) asm_[p * O + o0 + j] = acc[j];
      } else {
        T* dst = out_bk + (size_t(y0 + ty) * S + x) * O + o0;
#pragma unroll
        for (int j = 0; j < kOutChunk; ++j)
          if (o0 + j < O) dst[j] = from_acc<T>(acc[j]);
      }
    }
    if (cc + 1 < n_chunks) __syncthreads();
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

// Channels a chunk of the scalar kernel takes when all of C does not fit.
constexpr int kScalarChunk = 32;

template <typename T>
int launch(const void* feats, const void* wy, const void* wx, const void* weight,
           const void* bias, void* out, int B, int H, int W, int C, int S, int K, int O,
           cudaStream_t stream) {
  using A = typename Acc<T>::type;
  if (H > 32767 || W > 32767) return int(cudaErrorInvalidValue);
  size_t bytes = 0;
  int rows = 0, CC = C;   // all of C at once where it fits, else chunks
  const int candidates[2] = {C, kScalarChunk};
  for (const int cc : candidates) {
    if (cc > C) break;
    rows = pick_rows(
        [&](int r) { return make_layout(r, H, W, cc, S, O, sizeof(T), sizeof(A), cc < C).total; }, &bytes);
    CC = cc;
    if (rows != 0) break;
  }
  if (rows == 0) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(part_crop_head_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(bytes));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((S + rows - 1) / rows, K, B);
  part_crop_head_kernel<T><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(feats), static_cast<const T*>(wy), static_cast<const T*>(wx),
      static_cast<const T*>(weight), static_cast<const T*>(bias), static_cast<T*>(out),
      H, W, C, S, K, O, rows, CC);
  return int(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16: the conv on the tensor cores.

using bf16 = __nv_bfloat16;

constexpr int kN = 24;  // output channels per GEMM pass: three n8 MMA tiles

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

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                              uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

__device__ __forceinline__ void stsm_x4(uint32_t addr, uint32_t r0, uint32_t r1, uint32_t r2, uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(r0),
               "r"(r1), "r"(r2), "r"(r3)
               : "memory");
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
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

__device__ __forceinline__ uint4 ld16(const bf16* p) { return *reinterpret_cast<const uint4*>(p); }
__device__ __forceinline__ void st16(bf16* p, uint4 v) { *reinterpret_cast<uint4*>(p) = v; }

// ---------------------------------------------------------------------------
// bf16: `part_crop_head_bf16_kernel`.

// Eight warps of up to four 16-pixel MMA tiles each hold a tile of up to 512
// pixels (8 rows of S = 56: 28 tiles).
constexpr int kTcWarps = 8, kTcThreads = kTcWarps * 32, kTcMT = 4;
constexpr int kXk = 32;        // the x-interpolation MMA's depth: a group's taps span at most 32 columns
constexpr int kXa = kXk + 8;   // its A tiles' row stride: an odd number of 16-byte units

struct Bf16Layout {
  size_t crop, tmp, wts, bias, xa, xwin, xcnt, ycnt, ypk, span, total;
};

// Byte offsets of the bf16 kernel's shared arrays for tiles of `rows` rows
// and channel chunks of `chunk` (a multiple of 16). The output stage of a
// tile reuses the crop's bytes. `part_crop_head_bf16_bytes` exports the
// total, from which `kernels/part_crop_head.py::bf16_rows` picks the rows.
__host__ __device__ inline Bf16Layout make_bf16_layout(int rows, int W, int S, int O, int chunk) {
  const size_t R = rows + 2, cps = chunk + 8, kp = 9 * size_t(chunk) + 8;
  const size_t npad = (O + kN - 1) / kN * kN;
  const size_t crop = R * (S + 2) * cps, stage = size_t(rows) * S * (O < kN ? O : kN) + 8;
  Bf16Layout L;
  size_t p = 0;
  L.crop = p; p = align16(p + (crop > stage ? crop : stage) * sizeof(bf16));
  L.tmp = p; p = align16(p + (R * W + kXk) * chunk * sizeof(bf16));
  L.wts = p; p = align16(p + npad * kp * sizeof(bf16));
  L.bias = p; p = align16(p + npad * sizeof(float));
  const size_t n_xg = (S + 15) / 16;
  L.xa = p; p = align16(p + n_xg * 16 * kXa * sizeof(bf16));
  L.xwin = p; p = align16(p + 2 * n_xg * sizeof(int));
  L.xcnt = p; p = align16(p + S * sizeof(int));
  L.ycnt = p; p = align16(p + S * sizeof(int));
  L.ypk = p; p = align16(p + S * sizeof(uint2));
  L.span = p; p = align16(p + 2 * sizeof(int));
  L.total = p;
  return L;
}

// One thread scans row[0, n) for its non-zero entries: returns their count;
// `pk` gets the first two as (idx0 | idx1 << 16, val0 | val1 << 16) (one
// tap: the second repeats its index with weight 0), `lo` / `hi` the first
// and last index (n, -1 if none).
__device__ __forceinline__ int scan_taps(const bf16* __restrict__ row, int n, uint2& pk, int& lo, int& hi) {
  int count = 0;
  unsigned idx = 0u, val = 0u;
  lo = n;
  hi = -1;
#pragma unroll 8
  for (int h = 0; h < n; ++h) {
    const unsigned v = __bfloat16_as_ushort(row[h]);
    if ((v & 0x7fffu) != 0u) {   // +0 and -0 weigh nothing
      if (count < 2) {
        idx |= unsigned(h) << (16 * count);
        val |= v << (16 * count);
      }
      lo = min(lo, h);
      hi = h;
      ++count;
    }
  }
  if (count == 1) idx |= idx << 16;
  pk = make_uint2(idx, val);
  return count;
}

__device__ __forceinline__ float lo_bf16(unsigned v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi_bf16(unsigned v) { return __uint_as_float(v & 0xffff0000u); }

// Eight channels c0.. of feature pixel `src` (zero past C), as 16 bytes.
__device__ __forceinline__ uint4 feat8(const bf16* __restrict__ src, int c0, int C, bool vec) {
  if (vec) return c0 < C ? __ldg(reinterpret_cast<const uint4*>(src)) : make_uint4(0u, 0u, 0u, 0u);
  uint4 v;
  unsigned short* e = reinterpret_cast<unsigned short*>(&v);
#pragma unroll
  for (int j = 0; j < 8; ++j) e[j] = c0 + j < C ? __bfloat16_as_ushort(src[j]) : 0;
  return v;
}

// All of C, in chunks of CH channels (16 or 32), for one (image, part) a
// block: see the design notes at the top of this file.
template <int CH>
__global__ void __launch_bounds__(kTcThreads, 2)
part_crop_head_bf16_kernel(const bf16* __restrict__ feats,   // (B, H, W, C)
                           const bf16* __restrict__ wy,      // (B, K, S, H)
                           const bf16* __restrict__ wx,      // (B, K, S, W)
                           const bf16* __restrict__ wpack,   // (K, chunks, npad, 9 * CH)
                           const bf16* __restrict__ bias,    // (K * O)
                           bf16* __restrict__ out,           // (B, K, S, S, O)
                           int H, int W, int C, int S, int K, int O, int rows) {
  constexpr int G = CH / 8, cps = CH + 8, kp = 9 * CH + 8;   // 8-channel groups; crop and weight row strides
  // tmp's 16-byte chunks are swizzled: chunk g of tmp column q sits at g ^
  // swz(q), so that eight consecutive columns, `ldmatrix`'s rows, fall on
  // distinct banks
  constexpr int kSw = 8 / G;
  const auto swz = [](int q) { return (q / kSw) & (G - 1); };
  extern __shared__ __align__(16) unsigned char smem[];
  const Bf16Layout L = make_bf16_layout(rows, W, S, O, CH);
  bf16* crop = reinterpret_cast<bf16*>(smem + L.crop);     // [R][S + 2][cps]; the output stage after a tile
  bf16* tmp = reinterpret_cast<bf16*>(smem + L.tmp);       // [R * npx + kXk][CH]: columns xlo..xhi of each row
  bf16* wts = reinterpret_cast<bf16*>(smem + L.wts);       // [npad][kp]: the chunk's packed weights
  float* bsm = reinterpret_cast<float*>(smem + L.bias);
  bf16* xa = reinterpret_cast<bf16*>(smem + L.xa);         // [group][16][kXa]: the x weights as MMA A tiles
  int* xwin = reinterpret_cast<int*>(smem + L.xwin);       // [group]: first tap column, then last; the window
  int* xcnt = reinterpret_cast<int*>(smem + L.xcnt);
  int* ycnt = reinterpret_cast<int*>(smem + L.ycnt);
  uint2* ypk = reinterpret_cast<uint2*>(smem + L.ypk);
  int* span = reinterpret_cast<int*>(smem + L.span);       // xlo, xhi

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int k = blockIdx.x, b = blockIdx.y;   // the parts of an image run side by side
  const int R = rows + 2, SP = S + 2;
  const int npad = (O + kN - 1) / kN * kN;
  const int n_chunks = (C + CH - 1) / CH;
  const bf16* wy_bk = wy + (size_t(b) * K + k) * S * H;
  const bf16* wx_bk = wx + (size_t(b) * K + k) * S * W;
  const bf16* f_b = feats + size_t(b) * H * W * C;
  const bool vec = C % 8 == 0 && (reinterpret_cast<uintptr_t>(feats) & 15) == 0;
  bf16* out_bk = out + (size_t(b) * K + k) * S * S * O;

  // Set-up: the taps of every crop row and column (a thread a row), the
  // columns the x taps read (xlo..xhi) and each group of 16 crop columns
  // reads, the bias in fp32; tmp zeroed (the MMAs read past its written
  // columns, and multiply what they find there by 0).
  const int n_xg = (S + 15) / 16;
  if (tid == 0) {
    span[0] = W;
    span[1] = -1;
  }
  for (int i = tid; i < n_xg; i += kTcThreads) {
    xwin[i] = W;
    xwin[n_xg + i] = -1;
  }
  for (int n = tid; n < npad; n += kTcThreads) bsm[n] = n < O ? __bfloat162float(bias[size_t(k) * O + n]) : 0.f;
  for (int i = tid; i < (R * W + kXk) * G; i += kTcThreads) st16(tmp + size_t(i) * 8, make_uint4(0u, 0u, 0u, 0u));
  __syncthreads();
  for (int i = tid; i < 2 * S; i += kTcThreads) {
    uint2 pk;
    int lo, hi;
    if (i >= S) {
      const int n = scan_taps(wx_bk + size_t(i - S) * W, W, pk, lo, hi);
      xcnt[i - S] = n;
      if (n > 0) {
        atomicMin(&span[0], lo);
        atomicMax(&span[1], hi);
        atomicMin(&xwin[(i - S) / 16], lo);
        atomicMax(&xwin[n_xg + (i - S) / 16], hi);
      }
    } else {
      ycnt[i] = scan_taps(wy_bk + size_t(i) * H, H, pk, lo, hi);
      ypk[i] = pk;
    }
  }
  __syncthreads();
  const int xlo = span[0], npx = max(span[1] - xlo + 1, 0);
  // a group whose taps fit kXk columns from its first, wlo, gets its A tile
  // A[x][j] = wx[x][wlo + j] (the main loop's first barrier publishes it);
  // the others, and groups without taps, take the CUDA cores
  for (int i = tid; i < n_xg * 16 * kXk; i += kTcThreads) {
    const int x = i / kXk, xg = x / 16, j = i % kXk;
    const int wlo = xwin[xg], whi = xwin[n_xg + xg];
    const bool mma = whi >= wlo && whi - wlo < kXk;
    xa[size_t(x) * kXa + j] = mma && x < S && wlo + j < W ? wx_bk[size_t(x) * W + wlo + j] : __float2bfloat16_rn(0.f);
  }
  const uint32_t crop_s = smem_u32(crop), wts_s = smem_u32(wts), tmp_s = smem_u32(tmp), xa_s = smem_u32(xa);
  const int n_tiles = (S + rows - 1) / rows;
  bool weights_ready = false;

  for (int t = 0; t < n_tiles; ++t) {
    const int y0 = t * rows, rv = min(rows, S - y0), n_pix = rv * S;
    const int n_m16 = (n_pix + 15) / 16;
    const int my_tiles = n_m16 > warp ? (n_m16 - warp + kTcWarps - 1) / kTcWarps : 0;   // warp's 16-pixel tiles
    for (int nc = 0; nc < npad; nc += kN) {   // output channels kN at a time (one pass when O <= kN)
      float acc[kTcMT][3][4];
#pragma unroll
      for (int j = 0; j < kTcMT; ++j)
#pragma unroll
        for (int nt = 0; nt < 3; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][nt][e] = 0.f;

      for (int cc = 0; cc < n_chunks; ++cc) {
        const int cbase = cc * CH;
        // y-interpolation: tmp[r][w][c] = round(sum of crop row r's taps of
        // feature column xlo + w). A job is one (column, channel group) of
        // two crop rows, whose loads are in flight together; rows without
        // taps are left out.
        {
          const int ny = npx * G;
#pragma unroll 1
          for (int q = tid; q < ny * ((R + 1) / 2); q += kTcThreads) {
            const int rp = q / ny, w = (q - rp * ny) / G, g = q % G, r = 2 * rp;
            const int c0 = cbase + g * 8;
            const bf16* col = f_b + size_t(xlo + w) * C + c0;
            uint4 f[2][2];
            float w0[2], w1[2];
            int n[2];
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const int gy = y0 - 1 + r + u;
              n[u] = r + u < R && gy >= 0 && gy < S ? ycnt[gy] : 0;
              w0[u] = w1[u] = 0.f;
              f[u][0] = f[u][1] = make_uint4(0u, 0u, 0u, 0u);
              if (n[u] > 0 && n[u] <= 2) {
                const uint2 pk = ypk[gy];
                w0[u] = lo_bf16(pk.y);
                w1[u] = hi_bf16(pk.y);
                f[u][0] = feat8(col + size_t(pk.x & 0xffffu) * W * C, c0, C, vec);
                f[u][1] = feat8(col + size_t(pk.x >> 16) * W * C, c0, C, vec);
              }
            }
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              if (n[u] == 0) continue;
              float a[8], v[8];
              if (n[u] <= 2) {
                unpack8(f[u][0], v);
#pragma unroll
                for (int e = 0; e < 8; ++e) a[e] = fmaf(w0[u], v[e], 0.f);
                unpack8(f[u][1], v);
#pragma unroll
                for (int e = 0; e < 8; ++e) a[e] = fmaf(w1[u], v[e], a[e]);
              } else {   // a dense row: every non-zero tap, in order
#pragma unroll
                for (int e = 0; e < 8; ++e) a[e] = 0.f;
                const int gy = y0 - 1 + r + u;
                for (int h = 0; h < H; ++h) {
                  const float wv = __bfloat162float(wy_bk[size_t(gy) * H + h]);
                  if (wv == 0.f) continue;
                  unpack8(feat8(col + size_t(h) * W * C, c0, C, vec), v);
#pragma unroll
                  for (int e = 0; e < 8; ++e) a[e] = fmaf(wv, v[e], a[e]);
                }
              }
              const int qt = (r + u) * npx + w;
              st16(tmp + size_t(qt) * CH + (g ^ swz(qt)) * 8, pack8(a));
            }
          }
        }
        __syncthreads();   // tmp is whole; every warp is done with the last MMAs
        if (!weights_ready) {   // this chunk's packed weight tile, asynchronously
          const bf16* w_k = wpack + (size_t(k) * n_chunks + cc) * npad * (9 * CH);
          constexpr int vecs = 9 * CH / 8;
          for (int i = tid; i < npad * vecs; i += kTcThreads) {
            const int n = i / vecs, qv = i - n * vecs;
            cp_async16(wts + size_t(n) * kp + qv * 8, w_k + size_t(n) * (9 * CH) + qv * 8);
          }
          cp_async_commit();
          weights_ready = n_chunks == 1;   // one chunk: its tile stays for every tile
        }
        // x-interpolation into the crop, rounded, on the tensor cores: a unit
        // is one crop row and one group of 16 crop columns, the group's A
        // tile (16 x kXk) times kXk columns of the row's tmp from the group's
        // first tap column (`ldmatrix.trans`), stored by `stmatrix`. Groups
        // without an A tile take the CUDA cores; rows outside the image and
        // rows without taps are zero, as are crop columns 0 and S + 1.
        for (int i = tid; i < R * 2 * G; i += kTcThreads) {
          const int g = i % G, rc = i / G;
          st16(crop + (size_t(rc >> 1) * SP + ((rc & 1) ? S + 1 : 0)) * cps + g * 8, make_uint4(0u, 0u, 0u, 0u));
        }
#pragma unroll 1
        for (int u = warp; u < R * n_xg; u += kTcWarps) {
          const int r = u / n_xg, xg = u - r * n_xg, x0 = xg * 16, gy = y0 - 1 + r;
          const bool live = gy >= 0 && gy < S && ycnt[gy] > 0;
          const int wlo = xwin[xg], whi = xwin[n_xg + xg];
          if (live && whi >= wlo && whi - wlo < kXk) {
            const int nks = whi - wlo < 16 ? 1 : 2;   // 16-deep steps that hold the group's taps
            uint32_t a[2][4];
            const uint32_t xa_lane = xa_s + uint32_t(((x0 + (lane & 15)) * kXa + (lane >> 4) * 8) * 2);
            ldsm_x4(xa_lane, a[0][0], a[0][1], a[0][2], a[0][3]);
            if (nks > 1) ldsm_x4(xa_lane + 32, a[1][0], a[1][1], a[1][2], a[1][3]);
            // lane l gives row l & 15 of the B tiles (tmp column) and of the
            // stored tiles (crop column; past S, the crop's unread channel
            // padding of column 0)
            const int qk = r * npx + wlo - xlo + (lane & 15);
            const bool in = x0 + (lane & 15) < S;
            const uint32_t dst = crop_s + uint32_t(((r * SP + x0 + (lane & 15) + 1) * cps + (lane >> 4) * 8) * 2);
            const uint32_t trash = crop_s + uint32_t((r * SP * cps + CH) * 2);
#pragma unroll
            for (int np = 0; np < CH / 16; ++np) {
              float d[2][4];
#pragma unroll
              for (int e = 0; e < 4; ++e) d[0][e] = d[1][e] = 0.f;
#pragma unroll
              for (int ks = 0; ks < 2; ++ks) {
                if (ks >= nks) break;
                const int q = qk + ks * 16, g = np * 2 + (lane >> 4);
                uint32_t bt[4];
                ldsm_x4_trans(tmp_s + uint32_t((q * CH + (g ^ swz(q)) * 8) * 2), bt[0], bt[1], bt[2], bt[3]);
                mma_bf16(d[0], a[ks], bt[0], bt[1]);
                mma_bf16(d[1], a[ks], bt[2], bt[3]);
              }
              stsm_x4(in ? dst + np * 32 : trash, pack2(d[0][0], d[0][1]), pack2(d[0][2], d[0][3]), pack2(d[1][0], d[1][1]),
                      pack2(d[1][2], d[1][3]));
            }
          } else {   // a lane a (column, channel group): every non-zero tap, in order, or zero
            for (int it = lane; it < 16 * G; it += 32) {
              const int x = x0 + it / G, g = it % G;
              if (x >= S) continue;
              float acc8[8];
#pragma unroll
              for (int e = 0; e < 8; ++e) acc8[e] = 0.f;
              for (int w = live && xcnt[x] > 0 ? 0 : npx; w < npx; ++w) {
                const float wv = __bfloat162float(wx_bk[size_t(x) * W + xlo + w]);
                if (wv == 0.f) continue;
                const int q = r * npx + w;
                float f0[8];
                unpack8(ld16(tmp + size_t(q) * CH + (g ^ swz(q)) * 8), f0);
#pragma unroll
                for (int e = 0; e < 8; ++e) acc8[e] = fmaf(wv, f0[e], acc8[e]);
              }
              st16(crop + (size_t(r) * SP + x + 1) * cps + g * 8, pack8(acc8));
            }
          }
        }
        cp_async_wait<0>();
        __syncthreads();   // the crop and the weight tile are whole

        // The chunk's share of the GEMM depth: 9 taps x CH channels. Lane l
        // gives ldmatrix the address of pixel row l & 15 of each of its tiles.
        uint32_t arow[kTcMT];
#pragma unroll
        for (int j = 0; j < kTcMT; ++j) {
          const int p = min((warp + j * kTcWarps) * 16 + (lane & 15), n_pix - 1);
          const int ty = p / S, x = p - ty * S;
          arow[j] = crop_s + uint32_t(((ty * SP + x) * cps + (lane >> 4) * 8) * 2);
        }
        const uint32_t koff = ((lane >> 3) & 1) * 8;
        const uint32_t b01 = wts_s + uint32_t(((nc + (lane & 7) + ((lane >> 4) << 3)) * kp + koff) * 2);
        const uint32_t b2 = wts_s + uint32_t(((nc + 16 + (lane & 7)) * kp + koff) * 2);
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const uint32_t a_tap = uint32_t(((tap / 3) * SP + tap % 3) * cps * 2);
#pragma unroll
          for (int cs = 0; cs < CH; cs += 16) {
            uint32_t bq[4], bp[2];
            ldsm_x4(b01 + (tap * CH + cs) * 2, bq[0], bq[1], bq[2], bq[3]);
            ldsm_x2(b2 + (tap * CH + cs) * 2, bp[0], bp[1]);
#pragma unroll
            for (int j = 0; j < kTcMT; ++j) {
              if (j < my_tiles) {
                uint32_t a[4];
                ldsm_x4(arow[j] + a_tap + cs * 2, a[0], a[1], a[2], a[3]);
                mma_bf16(acc[j][0], a, bq[0], bq[1]);
                mma_bf16(acc[j][1], a, bq[2], bq[3]);
                mma_bf16(acc[j][2], a, bp[0], bp[1]);
              }
            }
          }
        }
      }
      __syncthreads();   // every warp is done reading the crop: the output stage takes its bytes

      // bias in fp32, round, into the stage [pixel][on]: outputs nc..nc + on
      const int on = min(kN, O - nc);
      const bool whole = on == O;   // the tile's outputs are one contiguous span
      const size_t span0 = size_t(y0) * S * O;
      const int mis = whole ? int((reinterpret_cast<uintptr_t>(out_bk + span0) & 15) >> 1) : 0;
      bf16* ostage = crop;
#pragma unroll
      for (int j = 0; j < kTcMT; ++j) {
        if (j >= my_tiles) continue;
#pragma unroll
        for (int nt = 0; nt < 3; ++nt)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int pr = (warp + j * kTcWarps) * 16 + (lane >> 2) + hf * 8;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int n = nt * 8 + (lane & 3) * 2 + e;
              if (pr < n_pix && n < on)
                ostage[mis + pr * on + n] = __float2bfloat16_rn(acc[j][nt][hf * 2 + e] + bsm[nc + n]);
            }
          }
      }
      __syncthreads();
      if (whole) {   // 16-byte stores (the stage is offset by the span's misalignment)
        const int total = n_pix * O;
        bf16* dst = out_bk + span0;
        const int head = min(total, (8 - mis) & 7);
        for (int e = tid; e < head; e += kTcThreads) dst[e] = ostage[mis + e];
        const int n_vec = (total - head) / 8;
        uint4* dv = reinterpret_cast<uint4*>(dst + head);
        const uint4* sv = reinterpret_cast<const uint4*>(ostage + mis + head);
        for (int qv = tid; qv < n_vec; qv += kTcThreads) dv[qv] = sv[qv];
        for (int e = head + n_vec * 8 + tid; e < total; e += kTcThreads) dst[e] = ostage[mis + e];
      } else {
        for (int e = tid; e < n_pix * on; e += kTcThreads) {
          const int pr = e / on;
          out_bk[span0 + size_t(pr) * O + nc + (e - pr * on)] = ostage[e];
        }
      }
      // the next pass or tile rebuilds the crop only after its first barrier
    }
  }
}

int launch_bf16(const void* feats, const void* wy, const void* wx, const void* wpack,
                     const void* bias, void* out, int B, int H, int W, int C, int S, int K, int O,
                     int rows, int chunk, cudaStream_t stream) {
  // int16 tap indices; a tile's pixels within the warps' MMA tiles; a chunk
  // of 16 or 32 channels
  if (H > 32767 || W > 32767 || rows < 1 || rows * S > kTcWarps * kTcMT * 16 || (chunk != 16 && chunk != 32))
    return int(cudaErrorInvalidValue);
  const size_t bytes = make_bf16_layout(rows, W, S, O, chunk).total;
  if (bytes > 227 * 1024) return int(cudaErrorInvalidValue);
  const auto kernel = chunk == 16 ? part_crop_head_bf16_kernel<16> : part_crop_head_bf16_kernel<32>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return int(err);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             int(cudaSharedmemCarveoutMaxShared));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(K, B);
  kernel<<<grid, kTcThreads, bytes, stream>>>(
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

// The bf16 kernel's shared memory in bytes for tiles of `rows` rows and a
// channel chunk of `chunk` (`kernels/part_crop_head.py::bf16_rows` reads it).
extern "C" long long part_crop_head_bf16_bytes(int rows, int W, int S, int O, int chunk) {
  return (long long)make_bf16_layout(rows, W, S, O, chunk).total;
}

// bf16: the tensor-core kernel in tiles of `rows` rows and channel chunks of
// `chunk` (16 or 32; `kernels/part_crop_head.py::bf16_plan`); wpack is
// `pack_head_weights`' (K, chunks, npad, 9 * chunk) tile. Returns a
// cudaError_t.
extern "C" int part_crop_head_bf16(const void* feats, const void* wy, const void* wx,
                                   const void* wpack, const void* bias, void* out, int B, int H,
                                   int W, int C, int S, int K, int O, int rows, int chunk,
                                   void* stream) {
  return launch_bf16(feats, wy, wx, wpack, bias, out, B, H, W, C, S, K, O, rows, chunk,
                     static_cast<cudaStream_t>(stream));
}
