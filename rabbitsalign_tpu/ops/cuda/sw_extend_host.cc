// Host emulation of the CUDA extend kernel (sw_extend.cu): the same
// per-lane arithmetic from sw_extend.cuh, with the warp's shuffles and
// its final reduction played out over 32 lanes in a loop. It lets tests on
// a machine without a GPU check the kernel's arithmetic against the XLA
// twin byte for byte; the CUDA-only parts (shuffles, launch geometry) are
// checked on the card.
#include <stdint.h>
#include <string.h>

#include <vector>

#include "sw_extend.cuh"

namespace {

struct Pair {
  const uint8_t* q;
  const uint8_t* t;
  int Q, T, qlen, tlen, B, b;
  rsa::Scoring sc;
  uint8_t* out;

  template <int R>
  void operator()() {
    using rsa::kWarp;
    const int QP = kWarp * R;
    const int nd = (qlen > 0 && tlen > 0) ? qlen + tlen - 1 : 0;
    std::vector<uint8_t> dirs((size_t)(Q + T) * QP, 0);
    rsa::LaneState<R> lanes[kWarp];
    for (int l = 0; l < kWarp; ++l) rsa::lane_init<R>(lanes[l], q, Q, l);
    int32_t up_h2[kWarp] = {0};
    for (int d = 0; d < nd; ++d) {
      int32_t up_h1[kWarp], up_e1[kWarp];
      uint8_t up_t[kWarp];
      for (int l = 0; l < kWarp; ++l) {
        // __shfl_up_sync(.., 1): lane l reads lane l-1's old values
        up_h1[l] = l ? lanes[l - 1].H1[R - 1] : 0;
        up_e1[l] = l ? lanes[l - 1].E1[R - 1] : rsa::kNeg;
        up_t[l] = l ? lanes[l - 1].tc[R - 1] : (d < tlen ? t[d] : 4);
      }
      for (int l = 0; l < kWarp; ++l) {
        rsa::lane_step<R>(lanes[l], l, d, up_h1[l], up_e1[l], up_h2[l],
                          up_t[l], qlen, tlen, sc,
                          dirs.data() + (size_t)d * QP);
        up_h2[l] = up_h1[l];
      }
    }
    int32_t h, bt, bq;
    rsa::lane_best<R>(lanes[0], 0, h, bt, bq);
    for (int l = 1; l < kWarp; ++l) {
      int32_t h2, t2, q2;
      rsa::lane_best<R>(lanes[l], l, h2, t2, q2);
      if (rsa::better(h2, t2, q2, h, bt, bq)) {
        h = h2;
        bt = t2;
        bq = q2;
      }
    }
    for (int row = 0; row < 2 * rsa::kRleM; ++row) out[(size_t)row * B + b] = 0;
    rsa::walk_and_pack<R>(dirs.data(), h, bt, bq, out, B, b);
  }
};

}  // namespace

// q (B, Q) and t (B, T) nt4 codes, qlen/tlen (B,), out (2*RLE_M+14, B).
// Returns 0, or -1 when Q exceeds the longest instantiated query.
extern "C" int rsa_sw_extend_host(const uint8_t* q, const uint8_t* t,
                                  const int32_t* qlen, const int32_t* tlen,
                                  int B, int Q, int T, int match, int mismatch,
                                  int gap_open, int gap_extend, uint8_t* out) {
  const int R = rsa::rows_per_lane(Q);
  if (R == 0) return -1;
  for (int b = 0; b < B; ++b) {
    Pair p{q + (size_t)b * Q, t + (size_t)b * T, Q, T, qlen[b], tlen[b], B, b,
           {match, mismatch, gap_open, gap_extend}, out};
    rsa::dispatch_rows(R, p);
  }
  return 0;
}
