// Fused BatchNorm with an optional (+ residual, ReLU) epilogue, forward and
// backward, for Hopper (sm_90a).
//
// Replaces no TPU kernel: on the TPU, XLA fuses the JAX package's
// BatchNorm (mfas_tpu/core/layers.py) into its neighbours. On the card the
// same function ran as an eager chain of about a dozen full-tensor
// PyTorch kernels forward and as many backward (an f32 copy of x, two
// strided sums, four affine passes, the ReLU and the residual add, and
// their autograd), about 150 bytes moved per BatchNorm element in a bf16
// training step: most of the device time of the found-network training
// cells. This file is the wrapper's kernels, ops/batchnorm.py.
//
// Bound: bytes. Nothing here reuses a byte enough to reach the card's
// ridge point, so the design moves each byte as few times as it can:
//   forward, train: mfas_bn_stats reads x once and writes per-block f32
//     partial sums of x and x^2 per channel; mfas_bn_finalize (one warp a
//     channel) sums them in a fixed order, computes mean, the one-pass
//     variance clamp(E[x^2] - E[x]^2, 0), 1/sqrt(var + eps), the running
//     statistics and num_batches_tracked; mfas_bn_apply reads x (and the
//     residual) once and writes y once. A tensor under ~40 MB is read the
//     second time from the 50 MB L2, since apply runs right after stats.
//   forward, eval: mfas_bn_finalize from the running statistics, then
//     mfas_bn_apply.
//   backward: mfas_bn_grad_stats reads dy, x (and y for the ReLU mask) and
//     writes partial sums of g = dy*mask and g*xhat per channel;
//     mfas_bn_grad_finalize gives dbias, dweight and three per-channel
//     coefficients; mfas_bn_grad_input writes
//     dx = inv*w*(g - mean(g) - xhat*mean(g*xhat)) and, with a residual,
//     its gradient dy*mask. Where the forward's clamp took effect, the
//     variance term is left out, as autograd of the plain version does.
// About 18 bytes an element over forward and backward in bf16 (36 in f32).
//
// Layout: x is (outer, C, inner) in memory, C the channel axis; any
// layout without gaps or overlaps has one (ops/batchnorm.py::layout).
// Contiguous N,C,... gives (N, C, S); channels-last (N*S, C, 1), which is
// what the found NTU net runs (its frames arrive channels-last and cuDNN
// keeps the layout); (N, T, C, H, W) in memory (N*T, C, H*W); BatchNorm1d
// (B, C, 1). A thread loads 16 bytes at a time (a "unit" of
// kVec elements): with inner > 1 ("planar") along a channel's row, where
// inner is a multiple of kVec; with inner == 1 ("packed") across kVec
// neighbouring channels of a row, where C is; else one element (and every
// pointer must be 16-byte aligned). In the planar statistics passes a
// block reads one channel's rows; in the packed ones a block reads a tile
// of up to 32 units of channels side by side over many rows, and sums its
// rows in shared memory. Grid-stride loops keep the channel index by
// carries, not by a division per unit. The grids (how many blocks split a
// channel or a tile) follow from the shape alone, in the wrapper, so a run
// is deterministic: no atomics, and the per-block sums are added in one
// fixed order. A CUDA graph replay is bitwise the eager call.
//
// Numerics are the plain version's (ops/batchnorm.py::batch_norm_plain):
// statistics summed in f32 (f64 for f64 input); the forward rounds to the
// activation dtype where the plain version does (mean, variance, the
// inverse deviation, weight and bias each cast to it, then (x - m) * inv,
// * w, + b, + residual, each rounded), with __f*_rn so that no multiply and
// add contract into an FMA. The backward computes in f32 registers (f64 for
// f64) from the saved x, y and per-channel mean and inverse deviation, and
// rounds once.
//
// Each host entry point launches on the given stream and returns
// cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kChannelsPerBlock = 4;  // the finalize kernels: a warp each

enum DType { kF32 = 0, kBF16 = 1, kF64 = 2 };

// forward finalize modes
enum { kSum = 1, kStats = 2, kEval = 4, kUpdate = 8 };
// backward finalize modes
enum { kGradSum = 1, kGradCoef = 2, kGradTrain = 4 };

// The forward's per-channel record, coef (6, C), holds one row of C for
// each of: the mean, inverse deviation, weight and bias as the forward used
// them, the clamp flag, and the element count (global, under a group). The
// backward's coefficients of dx = a*g + b + c*xhat are gcoef (3, C).

template <typename T>
struct Traits;
template <>
struct Traits<float> {
  using Acc = float;
  static constexpr int kVec = 4;
};
template <>
struct Traits<__nv_bfloat16> {
  using Acc = float;
  static constexpr int kVec = 8;
};
template <>
struct Traits<double> {
  using Acc = double;
  static constexpr int kVec = 2;
};

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T e[V];
};

__device__ __forceinline__ float to_acc(float v) { return v; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ double to_acc(double v) { return v; }

template <typename T>
__device__ __forceinline__ T from_acc(typename Traits<T>::Acc v);
template <>
__device__ __forceinline__ float from_acc<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_acc<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ double from_acc<double>(double v) {
  return v;
}

// a value rounded to T, where the plain version rounds to the activation
// dtype
template <typename T>
__device__ __forceinline__ typename Traits<T>::Acc rnd(
    typename Traits<T>::Acc v) {
  return to_acc(from_acc<T>(v));
}

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) {
  return __ddiv_rn(a, b);
}
__device__ __forceinline__ float inv_sqrt(float a) { return rsqrtf(a); }
__device__ __forceinline__ double inv_sqrt(double a) { return rsqrt(a); }

// a value of a tensor of runtime dtype, as A, and back
template <typename A>
__device__ __forceinline__ A load_any(const void* p, int dtype, int64_t i) {
  if (dtype == kBF16) {
    return static_cast<A>(
        __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]));
  }
  if (dtype == kF64) return static_cast<A>(static_cast<const double*>(p)[i]);
  return static_cast<A>(static_cast<const float*>(p)[i]);
}

template <typename A>
__device__ __forceinline__ void store_any(void* p, int dtype, int64_t i, A v) {
  if (dtype == kBF16) {
    static_cast<__nv_bfloat16*>(p)[i] =
        __float2bfloat16_rn(static_cast<float>(v));
  } else if (dtype == kF64) {
    static_cast<double*>(p)[i] = static_cast<double>(v);
  } else {
    static_cast<float*>(p)[i] = static_cast<float>(v);
  }
}

// v cast to the activation dtype and back (a no-op unless it is bf16)
template <typename A>
__device__ __forceinline__ A round_act(A v, int act) {
  return act == kBF16 ? static_cast<A>(__bfloat162float(
                            __float2bfloat16_rn(static_cast<float>(v))))
                      : v;
}

// the two sums of a block, in a fixed order; thread 0 returns them
template <typename A>
__device__ __forceinline__ void block_sum2(A& s, A& t) {
  __shared__ A sh[2][kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    t += __shfl_xor_sync(0xffffffffu, t, o);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    sh[0][warp] = s;
    sh[1][warp] = t;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    s = 0;
    t = 0;
    for (int w = 0; w < kThreads / 32; ++w) {
      s += sh[0][w];
      t += sh[1][w];
    }
  }
}

// A warp's sums of a channel's J partials (rows c and C + c of part, J
// each), in one fixed order; lane 0 holds the result.
template <typename A>
__device__ __forceinline__ void warp_partials(const A* __restrict__ part,
                                              int64_t C, int J, int64_t c,
                                              A& s, A& t) {
  double a = 0, b = 0;
  for (int j = threadIdx.x & 31; j < J; j += 32) {
    a += static_cast<double>(part[c * J + j]);
    b += static_cast<double>(part[(C + c) * J + j]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  s = static_cast<A>(a);
  t = static_cast<A>(b);
}

// The per-element terms of the two statistics passes. Forward: x and x^2.
// Backward: g = dy * (y > 0 under ReLU) and g * xhat, xhat from the
// channel's mean and inverse deviation as the forward used them.
template <bool kGrad, typename A>
__device__ __forceinline__ void terms(A xv, A dyv, A yv, A mean, A inv, A& s,
                                      A& t) {
  if constexpr (kGrad) {
    const A g = yv <= A(0) ? A(0) : dyv;
    s += g;
    t += g * ((xv - mean) * inv);
  } else {
    s += xv;
    t += xv * xv;
  }
}

template <typename T, int V>
__device__ __forceinline__ Pack<T, V> load_pack(const T* p, int64_t off) {
  return *reinterpret_cast<const Pack<T, V>*>(p + off);
}

template <typename T, int V>
__device__ __forceinline__ void store_pack(T* p, int64_t off,
                                           const Pack<T, V>& v) {
  *reinterpret_cast<Pack<T, V>*>(p + off) = v;
}

// Value r of a per-channel record (rows of C, coef or gcoef) for each
// element of a unit: its one channel c (planar), or V consecutive channels
// from c * V on (packed).
template <typename A, int V, bool kPacked>
__device__ __forceinline__ void channel_row(const A* rec, int64_t C, int r,
                                            int64_t c, A (&out)[V]) {
  if constexpr (kPacked) {
    const Pack<A, V> p = load_pack<A, V>(rec, r * C + c * V);
#pragma unroll
    for (int e = 0; e < V; ++e) out[e] = p.e[e];
  } else {
    const A v = rec[r * C + c];
#pragma unroll
    for (int e = 0; e < V; ++e) out[e] = v;
  }
}

// Planar statistics: block (j, c) of a grid (J, C) sums channel c's units
// [j*per, (j+1)*per). A unit is V elements of one row; a row holds iu
// units; unit k of the channel is unit k % iu of row k / iu, at element
// (row * C + c) * inner. part: (2, C, J).
template <typename T, int V, bool kGrad>
__device__ __forceinline__ void planar_stats(
    const T* __restrict__ x, const T* __restrict__ dy, const T* __restrict__ y,
    const typename Traits<T>::Acc* coef, typename Traits<T>::Acc* part,
    int64_t C, int64_t inner, uint32_t units, uint32_t iu) {
  using A = typename Traits<T>::Acc;
  const int c = blockIdx.y, j = blockIdx.x, J = gridDim.x;
  const uint32_t per = (units + J - 1) / J;
  const uint32_t k0 = j * per;
  const uint32_t k1 = k0 + per < units ? k0 + per : units;
  A mean = 0, inv = 0;
  if constexpr (kGrad) {
    mean = coef[c];
    inv = coef[C + c];
  }
  A s = 0, t = 0;
  uint32_t k = k0 + threadIdx.x;
  uint32_t o = k / iu, i = k - o * iu;
  const uint32_t dq = kThreads / iu, dr = kThreads - dq * iu;
  for (; k < k1; k += kThreads) {
    const int64_t off = (static_cast<int64_t>(o) * C + c) * inner +
                        static_cast<int64_t>(i) * V;
    const Pack<T, V> xp = load_pack<T, V>(x, off);
    Pack<T, V> dp, yp;
    if constexpr (kGrad) {
      dp = load_pack<T, V>(dy, off);
      if (y != nullptr) yp = load_pack<T, V>(y, off);
    }
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const A dyv = kGrad ? to_acc(dp.e[e]) : A(0);
      const A yv = kGrad && y != nullptr ? to_acc(yp.e[e]) : A(1);
      terms<kGrad>(to_acc(xp.e[e]), dyv, yv, mean, inv, s, t);
    }
    i += dr;
    o += dq;
    if (i >= iu) {
      i -= iu;
      ++o;
    }
  }
  block_sum2(s, t);
  if (threadIdx.x == 0) {
    part[static_cast<int64_t>(c) * J + j] = s;
    part[(C + c) * J + j] = t;
  }
}

// Packed statistics (inner == 1: each row holds the C channels in a row):
// a thread reads V consecutive channels of a row (a unit), TX = min(C / V,
// 32) threads side by side cover a tile of TX * V channels, and TY =
// kThreads / TX rows are read at once. Block (j, tile) of a grid
// (J, ceil(C / V / TX)) sums rows [j*per, (j+1)*per). part: (2, C, J).
template <typename T, int V, bool kGrad>
__device__ __forceinline__ void packed_stats(
    const T* __restrict__ x, const T* __restrict__ dy, const T* __restrict__ y,
    const typename Traits<T>::Acc* coef, typename Traits<T>::Acc* part,
    int64_t C, int64_t outer) {
  using A = typename Traits<T>::Acc;
  __shared__ A sh[2][kThreads * V];
  const int64_t CV = C / V;
  const int TX = CV < 32 ? static_cast<int>(CV) : 32, TY = kThreads / TX;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int J = gridDim.x, j = blockIdx.x;
  const int64_t cv = static_cast<int64_t>(blockIdx.y) * TX + tx;
  const bool active = ty < TY && cv < CV;
  const int64_t per = (outer + J - 1) / J;
  const int64_t o0 = j * per;
  const int64_t o1 = o0 + per < outer ? o0 + per : outer;
  A s[V], t[V], mean[V], inv[V];
#pragma unroll
  for (int e = 0; e < V; ++e) {
    s[e] = 0;
    t[e] = 0;
    mean[e] = 0;
    inv[e] = 0;
  }
  if (active) {
    if constexpr (kGrad) {
      channel_row<A, V, true>(coef, C, 0, cv, mean);
      channel_row<A, V, true>(coef, C, 1, cv, inv);
    }
#pragma unroll 4
    for (int64_t o = o0 + ty; o < o1; o += TY) {
      const int64_t off = o * C + cv * V;
      const Pack<T, V> xp = load_pack<T, V>(x, off);
      Pack<T, V> dp, yp;
      if constexpr (kGrad) {
        dp = load_pack<T, V>(dy, off);
        if (y != nullptr) yp = load_pack<T, V>(y, off);
      }
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const A dyv = kGrad ? to_acc(dp.e[e]) : A(0);
        const A yv = kGrad && y != nullptr ? to_acc(yp.e[e]) : A(1);
        terms<kGrad>(to_acc(xp.e[e]), dyv, yv, mean[e], inv[e], s[e], t[e]);
      }
    }
  }
  const int slot = (ty * TX + tx) * V;
  if (active) {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      sh[0][slot + e] = s[e];
      sh[1][slot + e] = t[e];
    }
  }
  __syncthreads();
  if (ty == 0 && cv < CV) {
    for (int r = 1; r < TY; ++r) {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        s[e] += sh[0][r * TX * V + tx * V + e];
        t[e] += sh[1][r * TX * V + tx * V + e];
      }
    }
#pragma unroll
    for (int e = 0; e < V; ++e) {
      part[(cv * V + e) * J + j] = s[e];
      part[(C + cv * V + e) * J + j] = t[e];
    }
  }
}

template <typename T, int V, bool kPacked>
__global__ void __launch_bounds__(kThreads)
    mfas_bn_stats(const T* x, typename Traits<T>::Acc* part, int64_t C,
                  int64_t outer, int64_t inner, uint32_t units, uint32_t iu) {
  if constexpr (kPacked) {
    packed_stats<T, V, false>(x, nullptr, nullptr, nullptr, part, C, outer);
  } else {
    planar_stats<T, V, false>(x, nullptr, nullptr, nullptr, part, C, inner,
                              units, iu);
  }
}

template <typename T, int V, bool kPacked>
__global__ void __launch_bounds__(kThreads)
    mfas_bn_grad_stats(const T* dy, const T* x, const T* y,
                       const typename Traits<T>::Acc* coef,
                       typename Traits<T>::Acc* part, int64_t C, int64_t outer,
                       int64_t inner, uint32_t units, uint32_t iu) {
  if constexpr (kPacked) {
    packed_stats<T, V, true>(x, dy, y, coef, part, C, outer);
  } else {
    planar_stats<T, V, true>(x, dy, y, coef, part, C, inner, units, iu);
  }
}

// One warp a channel (kChannelsPerBlock to a block). kSum: the partials
// (2, C, J) summed in a fixed order into sums (3, C) = [sum x, sum x^2,
// count]. kStats: mean, variance and the record from sums (kUpdate: and the
// running statistics); kEval: the record from the running statistics into
// coef (6, C).
template <typename A>
__global__ void mfas_bn_finalize(const A* __restrict__ part, int J,
                                 A* __restrict__ sums, A* __restrict__ coef,
                                 int64_t C, A count, int mode, int act,
                                 const void* weight, const void* bias,
                                 int param_dtype, void* rmean, void* rvar,
                                 int run_dtype, int64_t* nbt, double eps,
                                 double momentum) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kChannelsPerBlock +
                    (threadIdx.x >> 5);
  if (c >= C) return;
  A s = 0, s2 = 0, n = count;
  if (mode & kSum) warp_partials(part, C, J, c, s, s2);
  if ((threadIdx.x & 31) != 0) return;
  if ((mode & kSum) && !(mode & kStats)) {
    sums[c] = s;
    sums[C + c] = s2;
    sums[2 * C + c] = n;
    return;
  }
  if ((mode & kStats) && !(mode & kSum)) {
    s = sums[c];
    s2 = sums[C + c];
    n = sums[2 * C + c];
  }
  A mean, var, clamped = 0;
  if (mode & kStats) {
    mean = div_rn(s, n);
    var = sub_rn(div_rn(s2, n), mul_rn(mean, mean));
    if (var < A(0)) {
      var = A(0);
      clamped = 1;
    }
    if (mode & kUpdate) {
      const A m = static_cast<A>(momentum);
      const A keep = static_cast<A>(1.0 - momentum);
      const A rm = load_any<A>(rmean, run_dtype, c);
      const A rv = load_any<A>(rvar, run_dtype, c);
      const A nm1 = sub_rn(n, A(1));
      const A unbias = div_rn(n, nm1 < A(1) ? A(1) : nm1);
      store_any<A>(rmean, run_dtype, c,
                   add_rn(mul_rn(rm, keep), mul_rn(mean, m)));
      store_any<A>(rvar, run_dtype, c,
                   add_rn(mul_rn(rv, keep), mul_rn(mul_rn(var, unbias), m)));
      if (c == 0) *nbt += 1;
    }
  } else {
    mean = load_any<A>(rmean, run_dtype, c);
    var = load_any<A>(rvar, run_dtype, c);
  }
  mean = round_act(mean, act);
  var = round_act(var, act);
  const A inv = round_act(
      inv_sqrt(round_act(add_rn(var, static_cast<A>(eps)), act)), act);
  coef[c] = mean;
  coef[C + c] = inv;
  coef[2 * C + c] = round_act(load_any<A>(weight, param_dtype, c), act);
  coef[3 * C + c] = round_act(load_any<A>(bias, param_dtype, c), act);
  coef[4 * C + c] = clamped;
  coef[5 * C + c] = n;
}

// One warp a channel (kChannelsPerBlock to a block). kGradSum: the
// partials summed in a fixed order into gsums (2, C) = [sum g, sum
// g*xhat], which are dbias and dweight (written where their pointers are
// given). kGradCoef: dx's coefficients from gsums, gcoef (3, C) = (a, b, c)
// with dx = a*g + b + c*xhat; kGradTrain adds the batch statistics' terms
// (eval mode: dx = inv*w*g).
template <typename A>
__global__ void mfas_bn_grad_finalize(const A* __restrict__ part, int J,
                                      A* __restrict__ gsums,
                                      const A* __restrict__ coef,
                                      A* __restrict__ gcoef, void* dweight,
                                      void* dbias, int param_dtype, int64_t C,
                                      int mode) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kChannelsPerBlock +
                    (threadIdx.x >> 5);
  if (c >= C) return;
  A sg = 0, sgx = 0;
  if (mode & kGradSum) warp_partials(part, C, J, c, sg, sgx);
  if ((threadIdx.x & 31) != 0) return;
  if (mode & kGradSum) {
    gsums[c] = sg;
    gsums[C + c] = sgx;
    if (dbias != nullptr) store_any<A>(dbias, param_dtype, c, sg);
    if (dweight != nullptr) store_any<A>(dweight, param_dtype, c, sgx);
  } else {
    sg = gsums[c];
    sgx = gsums[C + c];
  }
  if (!(mode & kGradCoef)) return;
  const A k = coef[C + c] * coef[2 * C + c];
  A b = 0, cc = 0;
  if (mode & kGradTrain) {
    const A n = coef[5 * C + c];
    b = -k * (sg / n);
    cc = coef[4 * C + c] != A(0) ? A(0) : -k * (sgx / n);
  }
  gcoef[c] = k;
  gcoef[C + c] = b;
  gcoef[2 * C + c] = cc;
}

// Grid-stride walk over the units of the whole tensor in memory order. A
// unit is V elements: of one row (planar, inner % V == 0; cw = C), V
// consecutive channels of a row (packed; iu = 1, cw = C / V), or one
// element (V == 1). Unit u's channel (planar) or channel group (packed) is
// (u / iu) % cw, kept by carries as u advances.
struct Walk {
  uint32_t u, i, c, step, dr, dqc;
  __device__ __forceinline__ Walk(uint32_t iu, uint32_t cw) {
    u = blockIdx.x * blockDim.x + threadIdx.x;
    step = gridDim.x * blockDim.x;
    const uint32_t row = u / iu;
    i = u - row * iu;
    c = row % cw;
    const uint32_t dq = step / iu;
    dr = step - dq * iu;
    dqc = dq % cw;
  }
  __device__ __forceinline__ void next(uint32_t iu, uint32_t cw) {
    u += step;
    i += dr;
    c += dqc;
    if (i >= iu) {
      i -= iu;
      ++c;
    }
    if (c >= cw) c -= cw;
  }
};

// y = relu?((((x - m) * inv) * w + b) + residual?), each step rounded to T
template <typename T, int V, bool kPacked>
__global__ void __launch_bounds__(kThreads)
    mfas_bn_apply(const T* __restrict__ x, const T* __restrict__ res,
                  T* __restrict__ y, const typename Traits<T>::Acc* coef,
                  uint32_t units, uint32_t iu, uint32_t cw, int64_t C,
                  int relu) {
  using A = typename Traits<T>::Acc;
  for (Walk w(iu, cw); w.u < units; w.next(iu, cw)) {
    A m[V], inv[V], wt[V], b[V];
    channel_row<A, V, kPacked>(coef, C, 0, w.c, m);
    channel_row<A, V, kPacked>(coef, C, 1, w.c, inv);
    channel_row<A, V, kPacked>(coef, C, 2, w.c, wt);
    channel_row<A, V, kPacked>(coef, C, 3, w.c, b);
    const int64_t off = static_cast<int64_t>(w.u) * V;
    const Pack<T, V> xp = load_pack<T, V>(x, off);
    Pack<T, V> rp, out;
    if (res != nullptr) rp = load_pack<T, V>(res, off);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      A z = rnd<T>(sub_rn(to_acc(xp.e[e]), m[e]));
      z = rnd<T>(mul_rn(z, inv[e]));
      z = rnd<T>(mul_rn(z, wt[e]));
      z = rnd<T>(add_rn(z, b[e]));
      if (res != nullptr) z = rnd<T>(add_rn(z, to_acc(rp.e[e])));
      if (relu && z <= A(0)) z = A(0);
      out.e[e] = from_acc<T>(z);
    }
    store_pack<T, V>(y, off, out);
  }
}

// g = dy * (y > 0 under ReLU); dres = g; dx = a*g + b + c*xhat
template <typename T, int V, bool kPacked>
__global__ void __launch_bounds__(kThreads)
    mfas_bn_grad_input(const T* __restrict__ dy, const T* __restrict__ x,
                       const T* __restrict__ y, T* __restrict__ dx,
                       T* __restrict__ dres,
                       const typename Traits<T>::Acc* coef,
                       const typename Traits<T>::Acc* gcoef, uint32_t units,
                       uint32_t iu, uint32_t cw, int64_t C) {
  using A = typename Traits<T>::Acc;
  for (Walk w(iu, cw); w.u < units; w.next(iu, cw)) {
    const int64_t off = static_cast<int64_t>(w.u) * V;
    const Pack<T, V> dp = load_pack<T, V>(dy, off);
    Pack<T, V> yp, xp, gout, xout;
    if (y != nullptr) yp = load_pack<T, V>(y, off);
    if (dx != nullptr) xp = load_pack<T, V>(x, off);
    A g[V];
#pragma unroll
    for (int e = 0; e < V; ++e) {
      g[e] = y != nullptr && to_acc(yp.e[e]) <= A(0) ? A(0) : to_acc(dp.e[e]);
      gout.e[e] = from_acc<T>(g[e]);
    }
    if (dres != nullptr) store_pack<T, V>(dres, off, gout);
    if (dx == nullptr) continue;
    A m[V], inv[V], ka[V], kb[V], kc[V];
    channel_row<A, V, kPacked>(coef, C, 0, w.c, m);
    channel_row<A, V, kPacked>(coef, C, 1, w.c, inv);
    channel_row<A, V, kPacked>(gcoef, C, 0, w.c, ka);
    channel_row<A, V, kPacked>(gcoef, C, 1, w.c, kb);
    channel_row<A, V, kPacked>(gcoef, C, 2, w.c, kc);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const A xh = (to_acc(xp.e[e]) - m[e]) * inv[e];
      xout.e[e] = from_acc<T>(ka[e] * g[e] + kb[e] + kc[e] * xh);
    }
    store_pack<T, V>(dx, off, xout);
  }
}

inline int ew_blocks(uint32_t units) {
  // several waves of 8 blocks on each of 132 SMs, each thread walking
  // many units; fewer for a small tensor
  const uint32_t most = 132 * 8 * 4;
  const uint32_t need = (units + kThreads - 1) / kThreads;
  return static_cast<int>(need < most ? need : most);
}

inline int channel_blocks(int64_t C) {
  return static_cast<int>((C + kChannelsPerBlock - 1) / kChannelsPerBlock);
}

}  // namespace

// One library per activation dtype T (-DMFAS_BN_T=float, __nv_bfloat16 or
// double; the wrapper builds the one a run needs): x, y, the residual and
// every gradient of an activation are T; the accumulator A (part, sums,
// coef, gsums, gcoef) is double for double and float otherwise. The
// parameters' and running statistics' dtypes are passed as codes (0 float32,
// 1 bfloat16, 2 float64). vec: planar rows in 16-byte units (the wrapper
// checked inner % kVec == 0 and the pointers' alignment).

#ifndef MFAS_BN_T
#define MFAS_BN_T float
#endif

namespace {
using T = MFAS_BN_T;
using A = Traits<T>::Acc;
constexpr int V = Traits<T>::kVec;
constexpr int kAct = std::is_same<T, __nv_bfloat16>::value ? kBF16
                     : std::is_same<T, double>::value     ? kF64
                                                          : kF32;

// units of a row (16-byte units where vec, else elements)
inline uint32_t row_units(int64_t inner, int vec) {
  return static_cast<uint32_t>(vec ? inner / V : inner);
}

// The statistics passes' grid and block geometry: planar (J, C); packed
// (J, tiles of TX = min(C / V, 32) units of V channels).
inline dim3 stats_grid(int64_t C, int64_t inner, int J, int vec) {
  if (inner != 1) return dim3(J, static_cast<unsigned>(C));
  const int64_t cv = vec ? C / V : C;
  const int64_t tx = cv < 32 ? cv : 32;
  return dim3(J, static_cast<unsigned>((cv + tx - 1) / tx));
}

template <bool kGrad>
int launch_stats(const void* dy, const void* x, const void* y,
                 const void* coef, void* part, int64_t outer, int64_t C,
                 int64_t inner, int J, int vec, void* stream) {
  const dim3 grid = stats_grid(C, inner, J, vec);
  const uint32_t iu = row_units(inner, vec);
  const uint32_t units = static_cast<uint32_t>(outer) * iu;
  const T *d = static_cast<const T*>(dy), *xx = static_cast<const T*>(x),
          *yy = static_cast<const T*>(y);
  const A* cf = static_cast<const A*>(coef);
  A* p = static_cast<A*>(part);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool packed = inner == 1;
#define MFAS_BN_STATS(VV, PK)                                                \
  if constexpr (kGrad) {                                                     \
    mfas_bn_grad_stats<T, VV, PK><<<grid, kThreads, 0, st>>>(                \
        d, xx, yy, cf, p, C, outer, inner, units, iu);                       \
  } else {                                                                   \
    mfas_bn_stats<T, VV, PK><<<grid, kThreads, 0, st>>>(xx, p, C, outer,     \
                                                        inner, units, iu);   \
  }
  if (vec && packed) {
    MFAS_BN_STATS(V, true)
  } else if (vec) {
    MFAS_BN_STATS(V, false)
  } else if (packed) {
    MFAS_BN_STATS(1, true)
  } else {
    MFAS_BN_STATS(1, false)
  }
#undef MFAS_BN_STATS
  return static_cast<int>(cudaGetLastError());
}

// the elementwise walk's (units, units a row, channel groups)
struct Units {
  uint32_t units, iu, cw;
};

inline Units walk_units(int64_t numel, int64_t C, int64_t inner, int vec) {
  const int64_t w = vec ? V : 1;
  const bool packed = inner == 1;
  return {static_cast<uint32_t>(numel / w),
          packed ? 1u : static_cast<uint32_t>(inner / w),
          static_cast<uint32_t>(packed ? C / w : C)};
}
}  // namespace

// part (2, C, J) <- per-block sums of x and x^2
extern "C" int mfas_bn_launch_stats(const void* x, void* part, int64_t outer,
                                    int64_t C, int64_t inner, int J, int vec,
                                    void* stream) {
  return launch_stats<false>(nullptr, x, nullptr, nullptr, part, outer, C,
                             inner, J, vec, stream);
}

// part (2, C, J) <- per-block sums of g and g*xhat (y: null without ReLU)
extern "C" int mfas_bn_launch_grad_stats(const void* dy, const void* x,
                                         const void* y, const void* coef,
                                         void* part, int64_t outer, int64_t C,
                                         int64_t inner, int J, int vec,
                                         void* stream) {
  return launch_stats<true>(dy, x, y, coef, part, outer, C, inner, J, vec,
                            stream);
}

// coef (6, C) (and sums, running statistics) from part or sums; see
// mfas_bn_finalize for the modes
extern "C" int mfas_bn_launch_finalize(const void* part, int J, void* sums,
                                       void* coef, int64_t C, double count,
                                       int mode, const void* weight,
                                       const void* bias, int param_dtype,
                                       void* rmean, void* rvar, int run_dtype,
                                       void* nbt, double eps, double momentum,
                                       void* stream) {
  mfas_bn_finalize<A><<<channel_blocks(C), kChannelsPerBlock * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const A*>(part), J, static_cast<A*>(sums),
      static_cast<A*>(coef), C, static_cast<A>(count), mode, kAct, weight,
      bias, param_dtype, rmean, rvar, run_dtype, static_cast<int64_t*>(nbt),
      eps, momentum);
  return static_cast<int>(cudaGetLastError());
}

// y <- the normalized x, with the epilogue (res: null for none)
extern "C" int mfas_bn_launch_apply(const void* x, const void* res, void* y,
                                    const void* coef, int64_t numel, int64_t C,
                                    int64_t inner, int vec, int relu,
                                    void* stream) {
  const Units n = walk_units(numel, C, inner, vec);
  const T* xx = static_cast<const T*>(x);
  const T* r = static_cast<const T*>(res);
  T* yy = static_cast<T*>(y);
  const A* cf = static_cast<const A*>(coef);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = ew_blocks(n.units);
#define MFAS_BN_APPLY(VV, PK)                                                \
  mfas_bn_apply<T, VV, PK><<<blocks, kThreads, 0, st>>>(xx, r, yy, cf,       \
                                                        n.units, n.iu, n.cw, \
                                                        C, relu)
  if (vec && inner == 1) {
    MFAS_BN_APPLY(V, true);
  } else if (vec) {
    MFAS_BN_APPLY(V, false);
  } else {
    MFAS_BN_APPLY(1, false);
  }
#undef MFAS_BN_APPLY
  return static_cast<int>(cudaGetLastError());
}

// gsums, dweight, dbias (null where not wanted) and gcoef (3, C); see
// mfas_bn_grad_finalize for the modes
extern "C" int mfas_bn_launch_grad_finalize(const void* part, int J,
                                            void* gsums, const void* coef,
                                            void* gcoef, void* dweight,
                                            void* dbias, int param_dtype,
                                            int64_t C, int mode,
                                            void* stream) {
  mfas_bn_grad_finalize<A><<<channel_blocks(C), kChannelsPerBlock * 32, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const A*>(part), J, static_cast<A*>(gsums),
      static_cast<const A*>(coef), static_cast<A*>(gcoef), dweight, dbias,
      param_dtype, C, mode);
  return static_cast<int>(cudaGetLastError());
}

// dx (null: not wanted) and dres (null: no residual gradient)
extern "C" int mfas_bn_launch_grad_input(const void* dy, const void* x,
                                         const void* y, void* dx, void* dres,
                                         const void* coef, const void* gcoef,
                                         int64_t numel, int64_t C,
                                         int64_t inner, int vec,
                                         void* stream) {
  const Units n = walk_units(numel, C, inner, vec);
  const T *d = static_cast<const T*>(dy), *xx = static_cast<const T*>(x),
          *yy = static_cast<const T*>(y);
  T *ox = static_cast<T*>(dx), *orr = static_cast<T*>(dres);
  const A *cf = static_cast<const A*>(coef), *gc = static_cast<const A*>(gcoef);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = ew_blocks(n.units);
#define MFAS_BN_GRAD_INPUT(VV, PK)                                        \
  mfas_bn_grad_input<T, VV, PK><<<blocks, kThreads, 0, st>>>(             \
      d, xx, yy, ox, orr, cf, gc, n.units, n.iu, n.cw, C)
  if (vec && inner == 1) {
    MFAS_BN_GRAD_INPUT(V, true);
  } else if (vec) {
    MFAS_BN_GRAD_INPUT(V, false);
  } else {
    MFAS_BN_GRAD_INPUT(1, false);
  }
#undef MFAS_BN_GRAD_INPUT
  return static_cast<int>(cudaGetLastError());
}
