// Eval BatchNorm, an optional residual add and an optional ReLU in one
// elementwise pass, for Hopper (sm_90a):
//
//   y = act((x - mean) * (rsqrt(var + eps) * weight) + bias [+ r])
//
// in fp32, rounded once to x's dtype (bf16 or fp32), with the module's own
// statistics and parameters (`kernels/bn_act.py::bn_act_plain` is the same
// arithmetic in PyTorch). The statistics and parameters come in x's dtype,
// or in bf16 under fp32 activations (the GCN's BatchNorm1d in bf16
// serving): then the scale is formed as flax's dtype flow forms it
// (`nn/layers.py::_eval_bn_promoted`), rsqrt(var + eps) * weight with each
// step rounded to bf16, and the rest in fp32.
//
// Replaces no TPU kernel: XLA fused a conv's BatchNorm, residual add and
// ReLU on the TPU by itself. The eager port ran them as three PyTorch
// kernels, five passes over a BasicBlock's output, so the kernel was added
// where the port spent that time (HRNet-W48's ~290 BatchNorms in serving).
//
// Bound: bytes. A pass reads x (and r) and writes y once: 4 bytes an element
// in bf16 (6 with r), 8 in fp32 (12), ~0.5 FLOP a byte, far under the
// card's ~295 FLOP a byte. B=256 bf16 56x56x48 is 154 MB, 46 us at
// 3.35 TB/s. The design:
//   - The tensor is flat: element e belongs to channel (e / inner) % C,
//     with inner = 1 for channels-last (N*H*W, C) and H*W for contiguous
//     NCHW (and a BatchNorm1d's (N, C, L)), so one kernel takes both.
//   - 16-byte vector loads and stores (8 bf16 or 4 fp32 values a lane),
//     neighbouring lanes on neighbouring vectors; each lane has two vectors
//     (and their residuals) in flight before it computes, for the bytes in
//     flight HBM needs. A grid of at most `BLOCKS_PER_SM` blocks an SM walks
//     the tensor in strides; a scalar tail takes the last total % VEC
//     elements. Unaligned pointers take the scalar instance (VEC = 1).
//   - Each block reads the C channels' mean, var, weight and bias once into
//     shared memory as fp32 mean, scale = rsqrt(var + eps) * weight and
//     bias (12 bytes a channel, C up to 4096 in the 48 KB a block has
//     without an opt-in): no other launch prepares a scale, nothing is
//     cached between calls.
//   - A lane's channels are tracked, not divided for: its first element's
//     (channel, offset in the run of `inner`) comes from one division, and
//     each step (a value, a vector of the block, a grid stride) adds a
//     precomputed (channel, offset) step with one carry. Channels-last with
//     C a multiple of VEC (every served call but the IUV heads' C=12 in
//     bf16 and the GCN's BatchNorm1d) takes ROW: a vector is VEC
//     consecutive channels of one row, their parameters read as float4s.
//     Every other layout takes ANY, each value stepping on to its own
//     channel. Over the served calls of a W48 bf16 B=256 request on an H100
//     (PERF.md) ANY alone took 19.2 ms against ROW's 16.3; a third instance
//     for NCHW (a vector inside one channel) saved nothing.
//   - It launches on the caller's stream, allocates nothing and never
//     synchronises; the C entry returns the launch's cudaError_t.
//
// The nearest-upsampling instance (`up_shift` k > 0; HRNet's fuse rows, 28
// terms a W48 request):
//
//   y[n, h, w, c] = act(r[n, h, w, c] + bn(x)[n, h >> k, w >> k, c])
//
// with x (N, H >> k, W >> k, C) and r, y (N, H, W, C), all channels-last.
// It replaces a BatchNorm pass at the low resolution, the upsampled copy,
// the add and the row's ReLU (three full-resolution passes and a fourth per
// row). Bound: bytes, r read and y written once, x read once at 1/up^2 of
// them: 4.5 bytes an output element in bf16 at up = 2 (9 in fp32), less
// at 4 and 8. B=256 bf16 28x28x48 -> 56x56x48 is 173 MB, 52 us at
// 3.35 TB/s. The design:
//   - Only channels-last with C a multiple of VEC (every served fuse term:
//     C 48, 96, 192) takes 16-byte vectors, VEC consecutive channels of one
//     pixel; unaligned pointers take the scalar instance (VEC = 1).
//   - Each block owns one contiguous run of the output's vectors, an equal
//     share of the tensor, so the up rows that read one source row are
//     mostly the same block's and find it in L1 or L2.
//   - A lane's position is (row, w, channel vector), row = n * H + h; its
//     first comes from one division each, and each step of THREADS vectors
//     adds a precomputed step with two carries: no division per vector.
//     The source row is row >> k (H is a multiple of 2^k, so
//     n * (H >> k) + (h >> k) = (n * H + h) >> k), the source pixel w >> k.
//   - Two vectors of r and of x in flight a lane, as the plain instance
//     keeps them. Positions in 32 bits and at most 64 registers
//     (`__launch_bounds__`), so UP_BLOCKS_PER_SM = 4 blocks an SM are
//     resident and the grid is one wave of equal shares. On an H100 (B=256
//     bf16, the served (C, up)) that reads 71-75% of HBM bandwidth; 64-bit
//     positions at 76 registers (3 blocks an SM, a grid of three waves)
//     read 62-66%, 32 registers (8 blocks) spilled and read 16-18%, and
//     four vectors a lane spilled at 64 (35%).
//   - The C channels' parameters in shared memory, as above; with k = 0 the
//     entry runs the plain instances, whose code this instance leaves alone.

#include <climits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 2;          // vectors a lane has in flight
constexpr int BLOCKS_PER_SM = 8;   // 2048 threads an SM
constexpr int UP_BLOCKS_PER_SM = 4;   // the upsampling instance's, at up to 64 registers
constexpr int MAX_CHANNELS = 48 * 1024 / (3 * sizeof(float));

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
__device__ __forceinline__ float round_bf16(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

// statistic or parameter c, stored in fp32 or bf16, as fp32
__device__ __forceinline__ float stat(const void* p, int c, bool bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[c]) : static_cast<const float*>(p)[c];
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

// An element's channel c and its offset r in its run of `inner` elements;
// as a step of s elements, (s / inner % C, s % inner).
struct Pos {
  int c;
  long long r;
};

__device__ __forceinline__ void advance(Pos& p, const Pos& s, int C, long long inner) {
  p.r += s.r;
  p.c += s.c;
  if (p.r >= inner) {
    p.r -= inner;
    p.c += 1;
  }
  if (p.c >= C) p.c -= C;
}

struct Steps {
  Pos lane;   // one element
  Pos tile;   // THREADS vectors: the next vector of the same lane in a tile
  Pos grid;   // gridDim.x * THREADS * UNROLL vectors
};

__device__ __forceinline__ Pos position(long long e, int C, long long inner) {
  long long q = e / inner;
  return Pos{int(q % C), e - q * inner};
}

template <typename T, bool RES, bool RELU>
__device__ __forceinline__ T apply(T xv, const T* res_v, float mean, float scale, float bias) {
  float t = (to_f(xv) - mean) * scale + bias;
  if (RES) t += to_f(*res_v);
  if (RELU) t = t < 0.f ? 0.f : t;   // NaN stays NaN, as F.relu keeps it
  return from_f<T>(t);
}

// The C channels' fp32 mean, scale = rsqrt(var + eps) * weight and bias into
// shared memory (`params`, 3 * C floats), then a barrier.
template <typename T>
__device__ __forceinline__ void load_params(float* params, const void* mean, const void* var, const void* weight,
                                            const void* bias, bool stats_bf16, float eps, int C) {
  // bf16 statistics under fp32 x: each step of the scale in bf16 (flax)
  const bool flax = stats_bf16 && sizeof(T) == sizeof(float);
  for (int c = threadIdx.x; c < C; c += THREADS) {
    const float v = stat(var, c, stats_bf16), w = stat(weight, c, stats_bf16);
    params[c] = stat(mean, c, stats_bf16);
    params[C + c] = flax ? round_bf16(round_bf16(rsqrtf(round_bf16(v + eps))) * w) : rsqrtf(v + eps) * w;
    params[2 * C + c] = stat(bias, c, stats_bf16);
  }
  __syncthreads();
}

// How a vector's values map to channels: ANY (and every scalar instance),
// each value's channel tracked on its own; ROW (channels-last with
// C % VEC == 0), VEC consecutive channels of one row, whose parameters come
// as float4s.
enum Mode { ANY = 0, ROW = 1 };

template <typename T, int VEC, int MODE, bool RES, bool RELU>
__global__ void __launch_bounds__(THREADS)
bn_act_kernel(const T* __restrict__ x, const T* __restrict__ res, T* __restrict__ y,
              const void* __restrict__ mean, const void* __restrict__ var, const void* __restrict__ weight,
              const void* __restrict__ bias, bool stats_bf16, float eps, long long total, int C,
              long long inner, Steps steps) {
  extern __shared__ __align__(16) float params[];
  float* s_mean = params;
  float* s_scale = params + C;
  float* s_bias = params + 2 * C;
  load_params<T>(params, mean, var, weight, bias, stats_bf16, eps, C);

  using V = Vec<T, VEC>;
  const V* xv = reinterpret_cast<const V*>(x);
  const V* rv = reinterpret_cast<const V*>(res);
  V* yv = reinterpret_cast<V*>(y);
  const long long nvec = total / VEC;
  const long long stride = (long long)gridDim.x * THREADS * UNROLL;
  long long v = (long long)blockIdx.x * THREADS * UNROLL + threadIdx.x;
  Pos p = position(v * VEC, C, inner);
  for (; v < nvec; v += stride) {
    V a[UNROLL], b[UNROLL];
    Pos at[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      at[u] = p;
      if (u > 0) {
        at[u] = at[u - 1];
        advance(at[u], steps.tile, C, inner);
      }
      const long long i = v + (long long)u * THREADS;
      if (i < nvec) {
        a[u] = xv[i];
        if (RES) b[u] = rv[i];
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long i = v + (long long)u * THREADS;
      if (i < nvec) {
        V out;
        if constexpr (MODE == ROW) {
          float4 m4[VEC / 4], sc4[VEC / 4], bi4[VEC / 4];
#pragma unroll
          for (int j = 0; j < VEC / 4; ++j) {
            m4[j] = reinterpret_cast<const float4*>(s_mean + at[u].c)[j];
            sc4[j] = reinterpret_cast<const float4*>(s_scale + at[u].c)[j];
            bi4[j] = reinterpret_cast<const float4*>(s_bias + at[u].c)[j];
          }
          const float* m = reinterpret_cast<const float*>(m4);
          const float* sc = reinterpret_cast<const float*>(sc4);
          const float* bi = reinterpret_cast<const float*>(bi4);
#pragma unroll
          for (int k = 0; k < VEC; ++k)
            out.v[k] = apply<T, RES, RELU>(a[u].v[k], RES ? &b[u].v[k] : nullptr, m[k], sc[k], bi[k]);
        } else {
          Pos q = at[u];
#pragma unroll
          for (int k = 0; k < VEC; ++k) {
            out.v[k] = apply<T, RES, RELU>(a[u].v[k], RES ? &b[u].v[k] : nullptr, s_mean[q.c], s_scale[q.c],
                                           s_bias[q.c]);
            advance(q, steps.lane, C, inner);
          }
        }
        yv[i] = out;
      }
    }
    advance(p, steps.grid, C, inner);
  }
  // the scalar tail: the last total % VEC elements
  const long long tail = nvec * VEC;
  if (blockIdx.x == 0 && tail + threadIdx.x < total) {
    const long long e = tail + threadIdx.x;
    const Pos q = position(e, C, inner);
    y[e] = apply<T, RES, RELU>(x[e], RES ? &res[e] : nullptr, s_mean[q.c], s_scale[q.c], s_bias[q.c]);
  }
}

// A position of the upsampling instance: output row n * H + h, pixel w in
// it, channel vector c (of C / VEC); as a step, so many of each.
struct Pix {
  int row;
  int w;
  int c;
};

__device__ __forceinline__ void advance(Pix& p, const Pix& s, int W, int cvecs) {
  p.c += s.c;
  if (p.c >= cvecs) {
    p.c -= cvecs;
    p.w += 1;
  }
  p.w += s.w;   // < 2 * W: s.w < W
  if (p.w >= W) {
    p.w -= W;
    p.row += 1;
  }
  p.row += s.row;
}

// The nearest-upsampling instance (see the top of the file): y and res are
// (rows, W, C) channels-last, x (rows >> k, W >> k, C); nvec = y's vectors;
// `step` is THREADS vectors as a Pix.
template <typename T, int VEC, bool RELU>
__global__ void __launch_bounds__(THREADS, UP_BLOCKS_PER_SM)
bn_act_up_kernel(const T* __restrict__ x, const T* __restrict__ res, T* __restrict__ y,
                 const void* __restrict__ mean, const void* __restrict__ var, const void* __restrict__ weight,
                 const void* __restrict__ bias, bool stats_bf16, float eps, long long nvec, int C, int W, int k,
                 Pix step) {
  extern __shared__ __align__(16) float params[];
  const float* s_mean = params;
  const float* s_scale = params + C;
  const float* s_bias = params + 2 * C;
  load_params<T>(params, mean, var, weight, bias, stats_bf16, eps, C);

  using V = Vec<T, VEC>;
  const V* xv = reinterpret_cast<const V*>(x);
  const V* rv = reinterpret_cast<const V*>(res);
  V* yv = reinterpret_cast<V*>(y);
  const int cvecs = C / VEC;
  const int row_vecs = W * cvecs;
  const int src_row_vecs = (W >> k) * cvecs;
  // this block's run of vectors, and the lane's first position in it
  const long long end = nvec * (blockIdx.x + 1) / gridDim.x;
  long long v = nvec * blockIdx.x / gridDim.x + threadIdx.x;
  Pix p;
  p.row = int(v / row_vecs);
  const int in_row = int(v - (long long)p.row * row_vecs);
  p.w = in_row / cvecs;
  p.c = in_row - p.w * cvecs;
  for (; v < end; v += (long long)THREADS * UNROLL) {
    V a[UNROLL], b[UNROLL];
    Pix at[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      at[u] = p;
      if (u > 0) {
        at[u] = at[u - 1];
        advance(at[u], step, W, cvecs);
      }
      const long long i = v + (long long)u * THREADS;
      if (i < end) {
        b[u] = rv[i];
        a[u] = xv[(long long)(at[u].row >> k) * src_row_vecs + ((at[u].w >> k) * cvecs + at[u].c)];
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long i = v + (long long)u * THREADS;
      if (i < end) {
        const int c0 = at[u].c * VEC;
        V out;
        if constexpr (VEC % 4 == 0) {   // the parameters as float4s (C % VEC == 0 keeps them aligned)
#pragma unroll
          for (int j = 0; j < VEC; j += 4) {
            const float4 m = *reinterpret_cast<const float4*>(s_mean + c0 + j);
            const float4 sc = *reinterpret_cast<const float4*>(s_scale + c0 + j);
            const float4 bi = *reinterpret_cast<const float4*>(s_bias + c0 + j);
            out.v[j] = apply<T, true, RELU>(a[u].v[j], &b[u].v[j], m.x, sc.x, bi.x);
            out.v[j + 1] = apply<T, true, RELU>(a[u].v[j + 1], &b[u].v[j + 1], m.y, sc.y, bi.y);
            out.v[j + 2] = apply<T, true, RELU>(a[u].v[j + 2], &b[u].v[j + 2], m.z, sc.z, bi.z);
            out.v[j + 3] = apply<T, true, RELU>(a[u].v[j + 3], &b[u].v[j + 3], m.w, sc.w, bi.w);
          }
        } else {
#pragma unroll
          for (int j = 0; j < VEC; ++j)
            out.v[j] = apply<T, true, RELU>(a[u].v[j], &b[u].v[j], s_mean[c0 + j], s_scale[c0 + j], s_bias[c0 + j]);
        }
        yv[i] = out;
      }
    }
    p = at[UNROLL - 1];
    advance(p, step, W, cvecs);
  }
}

Pos step_of(long long s, int C, long long inner) {
  return Pos{int((s / inner) % C), s % inner};
}

int sm_count() {
  static int count[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return 132;
  if (count[dev] == 0) cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev);
  return count[dev] > 0 ? count[dev] : 132;
}

template <typename T, int VEC, int MODE, bool RES, bool RELU>
int launch(const void* x, const void* res, void* y, const void* mean, const void* var, const void* weight,
           const void* bias, bool stats_bf16, float eps, long long total, int C, long long inner,
           cudaStream_t stream) {
  const int smem = 3 * C * int(sizeof(float));
  const long long per_block = (long long)THREADS * UNROLL;
  const long long needed = (total / VEC + per_block - 1) / per_block;
  long long blocks = (long long)sm_count() * BLOCKS_PER_SM;
  blocks = needed < blocks ? needed : blocks;
  blocks = blocks > 0 ? blocks : 1;   // the tail alone
  Steps steps{step_of(1, C, inner), step_of((long long)THREADS * VEC, C, inner),
              step_of(blocks * per_block * VEC, C, inner)};
  bn_act_kernel<T, VEC, MODE, RES, RELU><<<int(blocks), THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(res), static_cast<T*>(y), mean, var, weight, bias, stats_bf16,
      eps, total, C, inner, steps);
  return int(cudaGetLastError());
}

template <typename T, int VEC, int MODE>
int launch_flags(const void* x, const void* res, void* y, const void* mean, const void* var, const void* weight,
                 const void* bias, bool stats_bf16, float eps, long long total, int C, long long inner, int relu,
                 cudaStream_t stream) {
  auto go = res != nullptr ? (relu ? launch<T, VEC, MODE, true, true> : launch<T, VEC, MODE, true, false>)
                           : (relu ? launch<T, VEC, MODE, false, true> : launch<T, VEC, MODE, false, false>);
  return go(x, res, y, mean, var, weight, bias, stats_bf16, eps, total, C, inner, stream);
}

// the 16-byte instance in the mode the layout allows, else the scalar one
template <typename T>
int launch_layout(int vectors, const void* x, const void* res, void* y, const void* mean, const void* var,
                  const void* weight, const void* bias, bool stats_bf16, float eps, long long total, int C,
                  long long inner, int relu, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  if (!vectors)
    return launch_flags<T, 1, ANY>(x, res, y, mean, var, weight, bias, stats_bf16, eps, total, C, inner, relu,
                                   stream);
  if (inner == 1 && C % VEC == 0)
    return launch_flags<T, VEC, ROW>(x, res, y, mean, var, weight, bias, stats_bf16, eps, total, C, inner, relu,
                                     stream);
  return launch_flags<T, VEC, ANY>(x, res, y, mean, var, weight, bias, stats_bf16, eps, total, C, inner, relu,
                                   stream);
}

template <typename T, int VEC, bool RELU>
int launch_up(const void* x, const void* res, void* y, const void* mean, const void* var, const void* weight,
              const void* bias, bool stats_bf16, float eps, long long total, int C, int W, int k,
              cudaStream_t stream) {
  const int smem = 3 * C * int(sizeof(float));
  const int cvecs = C / VEC, row_vecs = W * cvecs;
  const long long nvec = total / VEC;
  const long long per_block = (long long)THREADS * UNROLL;
  long long blocks = (long long)sm_count() * UP_BLOCKS_PER_SM;   // one wave
  const long long needed = (nvec + per_block - 1) / per_block;
  blocks = needed < blocks ? needed : blocks;
  const int in_row = THREADS % row_vecs;
  const Pix step{THREADS / row_vecs, in_row / cvecs, in_row % cvecs};
  bn_act_up_kernel<T, VEC, RELU><<<int(blocks), THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(res), static_cast<T*>(y), mean, var, weight, bias, stats_bf16,
      eps, nvec, C, W, k, step);
  return int(cudaGetLastError());
}

// the 16-byte instance where every pointer allows it and C is a multiple of
// VEC, else the scalar one
template <typename T>
int launch_up_layout(int vectors, const void* x, const void* res, void* y, const void* mean, const void* var,
                     const void* weight, const void* bias, bool stats_bf16, float eps, long long total, int C, int W,
                     int k, int relu, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const bool vec = vectors && C % VEC == 0;
  auto go = vec ? (relu ? launch_up<T, VEC, true> : launch_up<T, VEC, false>)
                : (relu ? launch_up<T, 1, true> : launch_up<T, 1, false>);
  return go(x, res, y, mean, var, weight, bias, stats_bf16, eps, total, C, W, k, stream);
}

}  // namespace

// dtype: x's, 0 = fp32, 1 = bf16; stats_dtype: mean's, var's, weight's and
// bias's (C each), x's or bf16 under fp32 x; vectors: 1 for 16-byte loads
// (every pointer 16-byte aligned), 0 for scalar ones. up_shift 0: x, res
// (NULL for none) and y hold `total` elements of channel (e / inner) % C,
// C at most 4096. up_shift k > 0, the upsampling instance: y and res hold
// `total` elements channels-last (inner 1) in rows of `width` pixels of C,
// x the same with rows and pixels 2^k times fewer; res is required, width
// and the number of rows are multiples of 2^k. Returns a cudaError_t.
extern "C" int bn_act(int dtype, int stats_dtype, int vectors, const void* x, const void* res, void* y,
                      const void* mean, const void* var, const void* weight, const void* bias, float eps,
                      long long total, int C, long long inner, int relu, int up_shift, long long width,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C <= 0 || C > MAX_CHANNELS || inner <= 0 || total < 0) return int(cudaErrorInvalidValue);
  if (!(stats_dtype == dtype || (dtype == 0 && stats_dtype == 1))) return int(cudaErrorInvalidValue);
  if (up_shift < 0 || up_shift > 30) return int(cudaErrorInvalidValue);
  if (up_shift > 0) {
    const long long up = 1LL << up_shift;
    // rows and a row's elements in int: the kernel's positions are 32-bit
    if (res == nullptr || inner != 1 || width <= 0 || width % up != 0 || width * C > INT_MAX ||
        total % (width * C) != 0 || (total / (width * C)) % up != 0 || total / (width * C) > INT_MAX)
      return int(cudaErrorInvalidValue);
  }
  if (total == 0) return int(cudaSuccess);
  const bool stats_bf16 = stats_dtype == 1;
  if (up_shift > 0) {
    switch (dtype) {
      case 0:
        return launch_up_layout<float>(vectors, x, res, y, mean, var, weight, bias, stats_bf16, eps, total, C,
                                       int(width), up_shift, relu, st);
      case 1:
        return launch_up_layout<__nv_bfloat16>(vectors, x, res, y, mean, var, weight, bias, stats_bf16, eps, total,
                                               C, int(width), up_shift, relu, st);
      default: return int(cudaErrorInvalidValue);
    }
  }
  switch (dtype) {
    case 0:
      return launch_layout<float>(vectors, x, res, y, mean, var, weight, bias, stats_bf16, eps, total, C, inner,
                                  relu, st);
    case 1:
      return launch_layout<__nv_bfloat16>(vectors, x, res, y, mean, var, weight, bias, stats_bf16, eps, total, C,
                                          inner, relu, st);
    default: return int(cudaErrorInvalidValue);
  }
}
