// Fused Smith-Waterman extension: the per-lane arithmetic shared by the
// CUDA kernel (sw_extend.cu) and its host emulation (sw_extend_host.cc).
//
// One warp aligns one query/target pair. The anti-diagonal recurrence of
// ops/sw_jax.py runs with the query split over the 32 lanes: lane L holds
// rows q = L*R .. L*R+R-1 in registers, so the q -> q-1 dependency inside
// a diagonal is a register read (r > 0) or one lane shuffle (r == 0). The
// 5-bit direction of every cell goes to a per-pair plane in global memory,
// then lane 0 walks it back from the best cell and run-length encodes the
// cigar into the packed (2*RLE_M + 14, B) layout of
// ops/extend_device._pack_rle_output. All of it is integer arithmetic and
// byte-identical to the XLA twin (ops/extend_portable.py).
#pragma once

#include <stddef.h>
#include <stdint.h>

#if defined(__CUDACC__)
#define RSA_HD __host__ __device__ __forceinline__
#else
#define RSA_HD inline
#endif

namespace rsa {

constexpr int kWarp = 32;
constexpr int kRleM = 32;  // = extend_device.RLE_M = engine.cpp's M
constexpr int kOutRows = 2 * kRleM + 14;
constexpr int32_t kNeg = -(1 << 28);  // = sw_jax.NEG
constexpr int kMaxRows = 16;  // queries up to 32 * 16 = 512
constexpr int kOpEq = 1, kOpX = 2, kOpI = 3, kOpD = 4;

struct Scoring {
  int32_t match, mismatch, gap_open, gap_extend;
};

RSA_HD int32_t imax(int32_t a, int32_t b) { return a > b ? a : b; }

// Rows per lane for a query bucket of Q rows: the smallest instantiated R
// with 32 * R >= Q, or 0 when Q is too long.
inline int rows_per_lane(int Q) {
  const int rs[] = {1, 2, 4, 5, 8, 12, 16};
  for (int r : rs)
    if (kWarp * r >= Q) return r;
  return 0;
}

// Direction byte of cell (diagonal d, query row q) in a pair's plane: lane
// L = q / R writes row r = q % R of every diagonal, so one store of a
// warp covers 32 adjacent bytes.
template <int R>
RSA_HD size_t dir_index(int d, int q) {
  return (size_t)d * (kWarp * R) + (size_t)(q % R) * kWarp + (size_t)(q / R);
}

template <int R>
struct LaneState {
  int32_t H1[R], H2[R], E1[R], F1[R];  // H on diagonals d-1, d-2; E, F on d-1
  int32_t best_h[R], best_t[R];        // first attainment of the row's max
  uint8_t qc[R], tc[R];                // query codes; target code at t = d - q
};

template <int R>
RSA_HD void lane_init(LaneState<R>& s, const uint8_t* q, int Q, int lane) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = lane * R + r;
    s.H1[r] = 0;
    s.H2[r] = 0;
    s.E1[r] = kNeg;
    s.F1[r] = kNeg;
    s.best_h[r] = 0;
    s.best_t[r] = -1;
    s.qc[r] = row < Q ? q[row] : 4;
    s.tc[r] = 4;
  }
}

// One anti-diagonal d for one lane. up_* are lane L-1's row R-1 values
// (H and E on diagonal d-1, H on d-2, target code on d-1); lane 0 gets
// (0, NEG, 0, target[d]). Rows run from R-1 down so every state array
// updates in place.
template <int R>
RSA_HD void lane_step(LaneState<R>& s, int lane, int d, int32_t up_h1,
                      int32_t up_e1, int32_t up_h2, uint8_t up_t, int qlen,
                      int tlen, const Scoring& sc, uint8_t* dir_row) {
#pragma unroll
  for (int r = R - 1; r >= 0; --r) {
    const int q = lane * R + r;
    const int t = d - q;
    const int32_t hm1 = r ? s.H1[r - 1] : up_h1;  // H(t, q-1)
    const int32_t em1 = r ? s.E1[r - 1] : up_e1;  // E(t, q-1)
    const int32_t hm2 = r ? s.H2[r - 1] : up_h2;  // H(t-1, q-1)
    const uint8_t tc = r ? s.tc[r - 1] : up_t;
    const uint8_t qc = s.qc[r];

    const int32_t e_open = hm1 - sc.gap_open;
    const int32_t e_ext = em1 - sc.gap_extend;
    int32_t E = imax(e_open, e_ext);
    const bool e_is_ext = e_open <= e_ext;
    const int32_t f_open = s.H1[r] - sc.gap_open;
    const int32_t f_ext = s.F1[r] - sc.gap_extend;
    int32_t F = imax(f_open, f_ext);
    const bool f_is_ext = f_open <= f_ext;

    const int32_t dsub =
        hm2 + ((qc == tc && qc < 4) ? sc.match : -sc.mismatch);
    const int32_t e1 = imax(E, 0);
    const int32_t f1 = imax(F, 0);
    const int32_t gap1 = imax(e1, f1);
    int32_t H = imax(imax(dsub, gap1), 0);

    const bool valid = t >= 0 && t < tlen && q < qlen;
    uint8_t dir = 0;
    if (valid) {
      const int h_src = H == 0 ? 0 : dsub >= gap1 ? 1 : e1 > f1 ? 2 : 3;
      dir = (uint8_t)(h_src | (e_is_ext << 2) | (f_is_ext << 3) |
                      ((qc == tc) << 4));
      if (H > s.best_h[r]) {
        s.best_h[r] = H;
        s.best_t[r] = t;
      }
    } else {
      H = 0;
      E = kNeg;
      F = kNeg;
    }
    s.H2[r] = s.H1[r];
    s.H1[r] = H;
    s.E1[r] = E;
    s.F1[r] = F;
    s.tc[r] = tc;
    dir_row[r * kWarp + lane] = dir;
  }
}

// SSW's end tie-break, as sw_jax orders it: max score, then min t, then
// min q.
RSA_HD bool better(int32_t h, int32_t t, int32_t q, int32_t bh, int32_t bt,
                   int32_t bq) {
  return h > bh || (h == bh && (t < bt || (t == bt && q < bq)));
}

template <int R>
RSA_HD void lane_best(const LaneState<R>& s, int lane, int32_t& h, int32_t& t,
                      int32_t& q) {
  h = s.best_h[0];
  t = s.best_t[0];
  q = lane * R;
#pragma unroll
  for (int r = 1; r < R; ++r) {
    if (better(s.best_h[r], s.best_t[r], lane * R + r, h, t, q)) {
      h = s.best_h[r];
      t = s.best_t[r];
      q = lane * R + r;
    }
  }
}

// Store v as a little-endian u16 row pair of the packed output.
RSA_HD void put_u16(uint8_t* out, int row, int B, int b, int32_t v) {
  out[(size_t)row * B + b] = (uint8_t)(v & 0xFF);
  out[(size_t)(row + 1) * B + b] = (uint8_t)((v >> 8) & 0xFF);
}

// Traceback from (t_end, q_end) with in-walk run-length encoding: the
// sequential form of extend_portable.traceback_rle. Run slots, counted
// from kRleM-1 down, must be zero on entry; the rest of column b of the
// packed output is written here.
template <int R>
RSA_HD void walk_and_pack(const uint8_t* dirs, int32_t score, int32_t t_end,
                          int32_t q_end, uint8_t* out, int B, int b) {
  enum { kH, kE, kF };
  int32_t t_begin = 0, q_begin = 0, edits = 0, n_runs = 0;
  if (score > 0) {
    int t = t_end, q = q_end, layer = kH;
    int cur_op = 0, cur_len = 0;
    for (;;) {
      const int dir = dirs[dir_index<R>(t + q, q)];
      const int h_src = dir & 3;
      const bool e_ext = (dir >> 2) & 1;
      const bool f_ext = (dir >> 3) & 1;
      const bool is_match = (dir >> 4) & 1;
      const bool in_h = layer == kH;
      const bool stop = in_h && h_src == 0;
      const bool do_m = in_h && h_src == 1;
      const bool do_i = (in_h && h_src == 2) || layer == kE;
      const bool do_d = (in_h && h_src == 3) || layer == kF;
      const int op = do_m ? (is_match ? kOpEq : kOpX)
                          : do_i ? kOpI : do_d ? kOpD : 0;
      if (op && op != cur_op) {
        if (cur_op) {
          if (n_runs < kRleM) {
            const int slot = kRleM - 1 - n_runs;
            out[(size_t)slot * B + b] = (uint8_t)(cur_len & 0xFF);
            out[(size_t)(kRleM + slot) * B + b] =
                (uint8_t)((cur_op << 5) | ((cur_len >> 8) & 0x1F));
          }
          ++n_runs;
        }
        cur_op = op;
        cur_len = 1;
      } else if (op) {
        ++cur_len;
      }
      edits += (do_m && !is_match) || do_i || do_d;
      const int nt = t - (do_m || do_d);
      const int nq = q - (do_m || do_i);
      const int next_layer = do_m ? kH : do_i ? (e_ext ? kE : kH)
                                              : (f_ext ? kF : kH);
      if (stop || nt < 0 || nq < 0) {
        if (cur_op) {
          if (n_runs < kRleM) {
            const int slot = kRleM - 1 - n_runs;
            out[(size_t)slot * B + b] = (uint8_t)(cur_len & 0xFF);
            out[(size_t)(kRleM + slot) * B + b] =
                (uint8_t)((cur_op << 5) | ((cur_len >> 8) & 0x1F));
          }
          ++n_runs;
        }
        t_begin = stop ? t + 1 : nt + 1;
        q_begin = stop ? q + 1 : nq + 1;
        break;
      }
      t = nt;
      q = nq;
      layer = next_layer;
    }
  }
  put_u16(out, 2 * kRleM + 0, B, b, score);
  put_u16(out, 2 * kRleM + 2, B, b, t_end);
  put_u16(out, 2 * kRleM + 4, B, b, q_end);
  put_u16(out, 2 * kRleM + 6, B, b, t_begin);
  put_u16(out, 2 * kRleM + 8, B, b, q_begin);
  put_u16(out, 2 * kRleM + 10, B, b, edits);
  put_u16(out, 2 * kRleM + 12, B, b, n_runs > kRleM ? 0xFFFF : n_runs);
}

// Calls f(std::integral_constant-like tag) with the instantiated R.
template <typename F>
inline bool dispatch_rows(int R, F&& f) {
  switch (R) {
    case 1: f.template operator()<1>(); return true;
    case 2: f.template operator()<2>(); return true;
    case 4: f.template operator()<4>(); return true;
    case 5: f.template operator()<5>(); return true;
    case 8: f.template operator()<8>(); return true;
    case 12: f.template operator()<12>(); return true;
    case 16: f.template operator()<16>(); return true;
  }
  return false;
}

}  // namespace rsa
