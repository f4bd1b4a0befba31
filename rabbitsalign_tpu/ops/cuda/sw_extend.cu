// CUDA extend kernel for Hopper, called from JAX through the XLA FFI
// (ops/extend_cuda.py registers it as "rsa_sw_extend").
//
// One warp per query/target pair, four pairs per block. Each lane keeps
// R query rows of H/E/F in registers for the whole anti-diagonal sweep
// (sw_extend.cuh), so the DP state never leaves the SM; the sweep stops at
// the pair's own last diagonal, qlen + tlen - 2. Direction bytes go to a
// per-pair scratch plane (the second FFI result), which the same warp
// walks back after a __syncwarp to produce the packed run-length cigar.
#include <cuda_runtime.h>

#include <string>

#include "sw_extend.cuh"
#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xFFFFFFFFu;

template <int R>
__global__ void __launch_bounds__(kWarpsPerBlock * rsa::kWarp)
    sw_extend_kernel(const uint8_t* __restrict__ q_all,
                     const uint8_t* __restrict__ t_all,
                     const int32_t* __restrict__ qlen_all,
                     const int32_t* __restrict__ tlen_all, int B, int Q, int T,
                     rsa::Scoring sc, uint8_t* out, uint8_t* dirs_all) {
  const int lane = threadIdx.x % rsa::kWarp;
  const int b = blockIdx.x * kWarpsPerBlock + threadIdx.x / rsa::kWarp;
  if (b >= B) return;  // whole warps only: b is uniform across a warp
  const uint8_t* tg = t_all + (size_t)b * T;
  const int qlen = qlen_all[b];
  const int tlen = tlen_all[b];
  const size_t plane = (size_t)(Q + T - 1) * (rsa::kWarp * R);
  uint8_t* dirs = dirs_all + (size_t)b * plane;

  rsa::LaneState<R> s;
  rsa::lane_init<R>(s, q_all + (size_t)b * Q, Q, lane);
  const int nd = (qlen > 0 && tlen > 0) ? qlen + tlen - 1 : 0;
  int32_t up_h2 = 0;
  uint8_t t_next = tlen > 0 ? tg[0] : 4;
  for (int d = 0; d < nd; ++d) {
    const uint8_t t_cur = t_next;
    t_next = d + 1 < tlen ? tg[d + 1] : 4;
    int32_t up_h1 = __shfl_up_sync(kFull, s.H1[R - 1], 1);
    int32_t up_e1 = __shfl_up_sync(kFull, s.E1[R - 1], 1);
    uint8_t up_t = (uint8_t)__shfl_up_sync(kFull, (int)s.tc[R - 1], 1);
    if (lane == 0) {
      up_h1 = 0;
      up_e1 = rsa::kNeg;
      up_t = t_cur;
    }
    rsa::lane_step<R>(s, lane, d, up_h1, up_e1, up_h2, up_t, qlen, tlen, sc,
                      dirs + (size_t)d * (rsa::kWarp * R));
    up_h2 = up_h1;
  }

  int32_t h, t, q;
  rsa::lane_best<R>(s, lane, h, t, q);
#pragma unroll
  for (int off = rsa::kWarp / 2; off > 0; off /= 2) {
    const int32_t h2 = __shfl_xor_sync(kFull, h, off);
    const int32_t t2 = __shfl_xor_sync(kFull, t, off);
    const int32_t q2 = __shfl_xor_sync(kFull, q, off);
    if (rsa::better(h2, t2, q2, h, t, q)) {
      h = h2;
      t = t2;
      q = q2;
    }
  }
  // zero this pair's run slots (kRleM == kWarp: one row pair per lane),
  // then publish them and the direction plane to lane 0
  out[(size_t)lane * B + b] = 0;
  out[(size_t)(rsa::kRleM + lane) * B + b] = 0;
  __syncwarp();
  if (lane == 0) rsa::walk_and_pack<R>(dirs, h, t, q, out, B, b);
}

struct Launch {
  cudaStream_t stream;
  const uint8_t* q;
  const uint8_t* t;
  const int32_t* qlen;
  const int32_t* tlen;
  int B, Q, T;
  rsa::Scoring sc;
  uint8_t* out;
  uint8_t* dirs;

  template <int R>
  void operator()() {
    const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
    sw_extend_kernel<R><<<blocks, kWarpsPerBlock * rsa::kWarp, 0, stream>>>(
        q, t, qlen, tlen, B, Q, T, sc, out, dirs);
  }
};

static_assert(rsa::kRleM == rsa::kWarp, "run-slot zeroing is one row per lane");

ffi::Error SwExtendImpl(cudaStream_t stream, ffi::Buffer<ffi::U8> q,
                        ffi::Buffer<ffi::U8> t, ffi::Buffer<ffi::S32> qlen,
                        ffi::Buffer<ffi::S32> tlen, int32_t match,
                        int32_t mismatch, int32_t gap_open, int32_t gap_extend,
                        ffi::ResultBuffer<ffi::U8> out,
                        ffi::ResultBuffer<ffi::U8> dirs) {
  const auto qd = q.dimensions();
  const auto td = t.dimensions();
  if (qd.size() != 2 || td.size() != 2 || qd[0] != td[0])
    return ffi::Error::InvalidArgument("q must be (B, Q) and t (B, T)");
  const int B = (int)qd[0], Q = (int)qd[1], T = (int)td[1];
  const int R = rsa::rows_per_lane(Q);
  if (R == 0 || Q + T - 1 < 1)
    return ffi::Error::InvalidArgument("query bucket longer than 512");
  if (qlen.element_count() != (size_t)B || tlen.element_count() != (size_t)B)
    return ffi::Error::InvalidArgument("qlen/tlen must be (B,)");
  if (out->element_count() != (size_t)rsa::kOutRows * B)
    return ffi::Error::InvalidArgument("out must be (2*RLE_M+14, B)");
  if (dirs->element_count() < (size_t)B * (Q + T - 1) * rsa::kWarp * R)
    return ffi::Error::InvalidArgument("direction scratch too small");
  if (B == 0) return ffi::Error::Success();
  Launch launch{stream, q.typed_data(), t.typed_data(), qlen.typed_data(),
                tlen.typed_data(), B, Q, T,
                {match, mismatch, gap_open, gap_extend}, out->typed_data(),
                dirs->typed_data()};
  rsa::dispatch_rows(R, launch);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess)
    return ffi::Error::Internal(std::string("sw_extend launch: ") +
                                cudaGetErrorString(err));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(RsaSwExtend, SwExtendImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()  // q (B, Q)
                                  .Arg<ffi::Buffer<ffi::U8>>()  // t (B, T)
                                  .Arg<ffi::Buffer<ffi::S32>>()  // qlen (B,)
                                  .Arg<ffi::Buffer<ffi::S32>>()  // tlen (B,)
                                  .Attr<int32_t>("match")
                                  .Attr<int32_t>("mismatch")
                                  .Attr<int32_t>("gap_open")
                                  .Attr<int32_t>("gap_extend")
                                  .Ret<ffi::Buffer<ffi::U8>>()  // packed out
                                  .Ret<ffi::Buffer<ffi::U8>>());  // dirs
