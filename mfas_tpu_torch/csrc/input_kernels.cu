// uint8 clip -> normalized float32 / bfloat16 frames, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of mfas_tpu/ops/input_kernels.py:
//   K1  _u8_normalize_flat        -> pl.pallas_call(_u8_norm_kernel)
//   K2  _u8_gather_normalize_flat -> pl.pallas_call(_u8_gather_norm_kernel)
//
// Both compute the same thing per output frame m: read source frame
// src_frame[m] (L = H*W*3 bytes) and write f32(x)*scale[c] + bias[c] with
// c = byte_index % 3. K1's source is b*T + frame_indices[t'] (or m itself
// when no frame pick is given: src_frame == nullptr); K2's is
// sample_idx[b]*F + frame_idx[b,t]. The Python wrapper builds src_frame as a
// small int64 device tensor, so one kernel body serves both. This takes the
// place of the Pallas BlockSpec index map and scalar prefetch: each block
// reads its own frame index.
//
// Bound: bytes. Per element 1 byte is read and 4 (f32) or 2 (bf16) bytes
// written, no reuse. At the found-NTU slice's shape (20x8x256x256x3, about
// 31.5 M elements, about 157 MB moved in f32) the floor at the H100 SXM's
// 3.35 TB/s is about 47 us. Design against that bound: each thread loads 16
// bytes (one uint4; a warp reads 512 contiguous bytes) and writes 16 outputs
// as four float4 (f32) or two 16-byte stores (bf16), in a grid of (chunks of
// one frame) x (output frames), so each chunk lies inside one frame and no
// thread divides by the frame size. In f32 a thread does not store its own
// 16 outputs (64 contiguous bytes, so a warp's store instruction would touch
// 32 half-filled sectors): the warp exchanges the loaded words with
// __shfl_sync so that each of its four float4 store instructions writes 512
// contiguous bytes. Measured on an H100 SXM at 700 W (PERF.md), that took
// the f32 kernel from about 120 us to about 60 us; the bf16 stores (32
// contiguous bytes per thread) already ran near the bound. Frames whose
// byte count is not a multiple of 16, or pointers that are not 16-byte
// aligned, take a scalar path for the whole launch.
//
// Arithmetic: __fadd_rn(__fmul_rn(x, s), b) keeps the compiler from fusing
// the affine into an FMA, so the result is bitwise equal to the plain
// PyTorch version (x.float() * scale + bias).to(out_dtype), which rounds
// after the multiply and after the add. bf16 is rounded once, from the f32
// result, with __float2bfloat16_rn (round to nearest even, as torch does).
//
// Offsets are int64: a full-resolution resident store is far past 2^31
// bytes. A frame index outside [0, n_src_frames) traps (the CUDA analogue of
// torch's device-side index assert); the next synchronize reports it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 16;  // uint8 elements each thread loads (one uint4)

struct Affine {
  float s0, s1, s2, b0, b1, b2;
};

// per-channel constants rotated so that slot j serves channel (c0 + j) % 3:
// element k of a run starting on channel c0 uses slot k % 3
struct Rotated {
  float s[3];
  float b[3];
};

__device__ __forceinline__ Rotated rotate(const Affine& a, int c0) {
  Rotated r;
  r.s[0] = c0 == 0 ? a.s0 : (c0 == 1 ? a.s1 : a.s2);
  r.s[1] = c0 == 0 ? a.s1 : (c0 == 1 ? a.s2 : a.s0);
  r.s[2] = c0 == 0 ? a.s2 : (c0 == 1 ? a.s0 : a.s1);
  r.b[0] = c0 == 0 ? a.b0 : (c0 == 1 ? a.b1 : a.b2);
  r.b[1] = c0 == 0 ? a.b1 : (c0 == 1 ? a.b2 : a.b0);
  r.b[2] = c0 == 0 ? a.b2 : (c0 == 1 ? a.b0 : a.b1);
  return r;
}

__device__ __forceinline__ float affine(uint32_t v, float s, float b) {
  return __fadd_rn(__fmul_rn(static_cast<float>(v), s), b);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const uint32_t a = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
  const uint32_t b = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
  return a | (b << 16);
}

// f32: the warp's 32 uint4 loads hold 512 consecutive elements. In store
// step q, lane i writes elements 4(32q + i) .. 4(32q + i) + 3 of them, which
// are word i % 4 of lane 8q + i/4's load. wop points at the warp's first
// output, n_left = elements of the frame from there on, wb3 = the channel of
// the warp's first element. Every lane of the warp must call this.
__device__ __forceinline__ void store_f32_warp(float* wop, int64_t n_left,
                                               const uint32_t (&w)[4],
                                               int lane, int wb3,
                                               const Affine& a) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t mine = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t t = __shfl_sync(0xffffffffu, w[j], 8 * q + (lane >> 2));
      if ((lane & 3) == j) mine = t;
    }
    const int p = 4 * (32 * q + lane);
    if (p < n_left) {
      const Rotated r = rotate(a, (wb3 + p) % 3);
      *reinterpret_cast<float4*>(wop + p) =
          make_float4(affine(mine & 0xffu, r.s[0], r.b[0]),
                      affine((mine >> 8) & 0xffu, r.s[1], r.b[1]),
                      affine((mine >> 16) & 0xffu, r.s[2], r.b[2]),
                      affine(mine >> 24, r.s[0], r.b[0]));
    }
  }
}

// bf16: a thread writes its own 16 outputs as two 16-byte stores
__device__ __forceinline__ void store_bf16_thread(__nv_bfloat16* dst,
                                                  const uint32_t (&w)[4],
                                                  const Rotated& r) {
  float y[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    y[k] = affine((w[k / 4] >> (8 * (k % 4))) & 0xffu, r.s[k % 3], r.b[k % 3]);
  }
  uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const float* z = y + 8 * q;
    d[q] = make_uint4(pack_bf16x2(z[0], z[1]), pack_bf16x2(z[2], z[3]),
                      pack_bf16x2(z[4], z[5]), pack_bf16x2(z[6], z[7]));
  }
}

__device__ __forceinline__ void store1(float* dst, float y) { *dst = y; }

__device__ __forceinline__ void store1(__nv_bfloat16* dst, float y) {
  *dst = __float2bfloat16_rn(y);
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads)
    u8_norm_frames(const uint8_t* __restrict__ src,
                   const int64_t* __restrict__ src_frame,
                   OutT* __restrict__ out, int64_t n_frames, int64_t frame_len,
                   int64_t n_src_frames, Affine a, bool vec) {
  constexpr bool kF32 = std::is_same<OutT, float>::value;
  const int lane = threadIdx.x & 31;
  const int64_t e =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * kVec;
  const int64_t wbase = e - lane * kVec;  // the warp's first element
  const bool active = e < frame_len;
  // the f32 vector path keeps every lane of a warp that has work, for its
  // shuffles; inactive lanes load the frame's first 16 bytes and store nothing
  if (vec && kF32 ? wbase >= frame_len : !active) return;
  const Rotated r = rotate(a, static_cast<int>(e % 3));
  const int wb3 = static_cast<int>(wbase % 3);

  for (int64_t m = blockIdx.y; m < n_frames; m += gridDim.y) {
    const int64_t f = src_frame != nullptr ? src_frame[m] : m;
    if (f < 0 || f >= n_src_frames) __trap();
    const uint8_t* sp = src + f * frame_len;
    OutT* op = out + m * frame_len;
    if (vec) {
      const uint4 v =
          __ldg(reinterpret_cast<const uint4*>(sp + (active ? e : 0)));
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
      if constexpr (kF32) {
        store_f32_warp(op + wbase, frame_len - wbase, w, lane, wb3, a);
      } else {
        store_bf16_thread(op + e, w, r);
      }
    } else {
      const int64_t n = frame_len - e < kVec ? frame_len - e : kVec;
      for (int k = 0; k < n; ++k) {
        store1(op + e + k, affine(sp[e + k], r.s[k % 3], r.b[k % 3]));
      }
    }
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// out[m] = normalize(src[src_frame[m]]) for m in [0, n_frames).
//   src:        uint8, n_src_frames frames of frame_len bytes each
//   src_frame:  int64 device array of n_frames entries, or null for m itself
//   out:        float32 (out_bf16 == 0) or bfloat16, n_frames * frame_len
//   stream:     the cudaStream_t to launch on
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int mfas_u8_normalize_frames(const void* src, const void* src_frame,
                                        void* out, int64_t n_frames,
                                        int64_t frame_len, int64_t n_src_frames,
                                        float s0, float s1, float s2, float b0,
                                        float b1, float b2, int out_bf16,
                                        void* stream) {
  if (n_frames <= 0 || frame_len <= 0) return 0;
  const bool vec = frame_len % kVec == 0 && aligned16(src) && aligned16(out);
  const int64_t threads_per_frame = (frame_len + kVec - 1) / kVec;
  const int64_t blocks_x = (threads_per_frame + kThreads - 1) / kThreads;
  const int64_t blocks_y = n_frames < 65535 ? n_frames : 65535;
  const dim3 grid(static_cast<unsigned>(blocks_x),
                  static_cast<unsigned>(blocks_y));
  const Affine a{s0, s1, s2, b0, b1, b2};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* s = static_cast<const uint8_t*>(src);
  const int64_t* idx = static_cast<const int64_t*>(src_frame);
  if (out_bf16) {
    u8_norm_frames<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        s, idx, static_cast<__nv_bfloat16*>(out), n_frames, frame_len,
        n_src_frames, a, vec);
  } else {
    u8_norm_frames<float><<<grid, kThreads, 0, st>>>(
        s, idx, static_cast<float*>(out), n_frames, frame_len, n_src_frames,
        a, vec);
  }
  return static_cast<int>(cudaGetLastError());
}
