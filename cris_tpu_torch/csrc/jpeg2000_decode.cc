// JPEG 2000 decoding for the data library, as OpenJPEG 2.5.3 decodes a JP2
// file or a raw J2K codestream and OpenCV 5.0's grfmt_jpeg2000_openjpeg.cpp
// turns the result into 8-bit BGR or gray for cv2.imdecode, so that the
// pixels equal OpenCV's bit for bit:
//   - the JP2 box walk of opj_jp2_read_header_procedure (jP, ftyp, jp2h
//     with ihdr, colr, pclr, cmap, cdef; the codestream box jp2c), the
//     colour checks of opj_jp2_check_color, then the palette and channel
//     definitions applied as opj_jp2_apply_pclr / opj_jp2_apply_cdef do;
//   - the codestream: SIZ (1-4 components of 8-16 bits, tile offsets),
//     COD / COC (all five progression orders, 0-32 decomposition levels,
//     code-block sizes, precincts, SOP / EPH), QCD / QCC (none, scalar
//     derived, scalar expounded), SOT / SOD tile-parts, TLM / PLM / PLT /
//     COM / CRG / CPF checked as OpenJPEG checks them, unknown markers
//     skipped as opj_j2k_read_unk skips them; OpenJPEG's strict checks (a tile-part or code-block
//     segment past the data refuses, as cv2 returns None);
//   - tier 2 as opj_t2_read_packet_header reads it (tag trees, inclusion,
//     zero bit-planes, passes, Lblock, segments of the code-block styles)
//     in OpenJPEG's progression iterators (pi.c), and tier 1 as t1.c
//     decodes a code-block: the MQ decoder with its artificial 0xFFFF end
//     marker, the significance, refinement and cleanup passes with their
//     contexts, the raw passes of selective bypass, context reset,
//     termination on every pass, vertically causal contexts and
//     segmentation symbols;
//   - dequantisation as t1 does it (coefficient / 2 on the 5/3 path; times
//     half the step size in float on the 9/7 path, the step size computed
//     as tcd.c computes it for the decoder), the inverse DWT as dwt.c runs
//     it (rows, then columns, per level; integer 5/3 lifting; float 9/7
//     lifting with OpenJPEG's constants, K on the low-pass samples and
//     its historical 2/K on the high-pass ones), the RCT or ICT
//     (opj_mct_decode / opj_mct_decode_real), then lrintf, the DC shift
//     and the clamp;
//   - OpenCV's conversion: every component shifted right by the largest
//     precision less 8, its low byte taken; sRGB or unspecified colour
//     as RGB(A) to BGR (gray by cvtColor's 15-bit weights), greyscale
//     replicated, sYCC by cvtColor(YUV2BGR)'s fixed-point weights.
// Refused, each by name: what OpenCV refuses (signed components, under 8
// bits, subsampled components, an image offset, CMYK and e-sYCC), and what
// OpenJPEG decodes but this decoder does not take: HTJ2K (Part 15), RGN,
// POC, PPM / PPT, Part 2's wavelets, component transforms and markers
// (MCT, MCC, MCO, CBD).
// Float arithmetic as OpenJPEG's (SSE, no fused multiply-add: the library
// is built with -ffp-contract=off); no mutable global state.

#include "image_codec.h"

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <map>
#include <string>
#include <vector>

namespace {

using cris::Fault;
using cris::check_size;
using cris::fail;

[[noreturn]] void refuse(const std::string& what) { throw Fault("JPEG 2000: " + what); }

inline uint32_t be16(const uint8_t* p) { return (uint32_t)p[0] << 8 | p[1]; }
inline uint32_t be32(const uint8_t* p) {
  return (uint32_t)p[0] << 24 | (uint32_t)p[1] << 16 | (uint32_t)p[2] << 8 | p[3];
}
inline int64_t ceildiv(int64_t a, int64_t b) { return (a + b - 1) / b; }
inline int64_t ceildivpow2(int64_t a, int b) { return (a + ((int64_t)1 << b) - 1) >> b; }
inline int64_t floordivpow2(int64_t a, int b) { return a >> b; }

// ------------------------------------------------------------ MQ decoder

struct MQState {
  uint16_t qe;
  uint8_t nmps, nlps, sw;
};
const MQState kMQ[47] = {
    {0x5601, 1, 1, 1},   {0x3401, 2, 6, 0},   {0x1801, 3, 9, 0},   {0x0AC1, 4, 12, 0},
    {0x0521, 5, 29, 0},  {0x0221, 38, 33, 0}, {0x5601, 7, 6, 1},   {0x5401, 8, 14, 0},
    {0x4801, 9, 14, 0},  {0x3801, 10, 14, 0}, {0x3001, 11, 17, 0}, {0x2401, 12, 18, 0},
    {0x1C01, 13, 20, 0}, {0x1601, 29, 21, 0}, {0x5601, 15, 14, 1}, {0x5401, 16, 14, 0},
    {0x5101, 17, 15, 0}, {0x4801, 18, 16, 0}, {0x3801, 19, 17, 0}, {0x3401, 20, 18, 0},
    {0x3001, 21, 19, 0}, {0x2801, 22, 19, 0}, {0x2401, 23, 20, 0}, {0x2201, 24, 21, 0},
    {0x1C01, 25, 22, 0}, {0x1801, 26, 23, 0}, {0x1601, 27, 24, 0}, {0x1401, 28, 25, 0},
    {0x1201, 29, 26, 0}, {0x1101, 30, 27, 0}, {0x0AC1, 31, 28, 0}, {0x09C1, 32, 29, 0},
    {0x08A1, 33, 30, 0}, {0x0521, 34, 31, 0}, {0x0441, 35, 32, 0}, {0x02A1, 36, 33, 0},
    {0x0221, 37, 34, 0}, {0x0141, 38, 35, 0}, {0x0111, 39, 36, 0}, {0x0085, 40, 37, 0},
    {0x0049, 41, 38, 0}, {0x0025, 42, 39, 0}, {0x0015, 43, 40, 0}, {0x0009, 44, 41, 0},
    {0x0005, 45, 42, 0}, {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0}};

enum { CTX_ZC = 0, CTX_SC = 9, CTX_MAG = 14, CTX_AGG = 17, CTX_UNI = 18, NUM_CTX = 19 };

// mqc.c's decoder over one segment, whose bytes are followed by 0xFF 0xFF
// (opj_mqc_init_dec_common's artificial marker), and its raw (bypass) mode.
struct MQ {
  const uint8_t* bp = nullptr;
  uint32_t a = 0, c = 0;
  int ct = 0;
  uint8_t state[NUM_CTX] = {};  // index into kMQ
  uint8_t mps[NUM_CTX] = {};

  void reset_states() {
    std::memset(state, 0, sizeof state);
    std::memset(mps, 0, sizeof mps);
    state[CTX_UNI] = 46;
    state[CTX_AGG] = 3;
    state[CTX_ZC] = 4;
  }
  void bytein() {
    if (bp[0] == 0xFF) {
      if (bp[1] > 0x8F) {
        c += 0xFF00;
        ct = 8;
      } else {
        ++bp;
        c += (uint32_t)bp[0] << 9;
        ct = 7;
      }
    } else {
      ++bp;
      c += (uint32_t)bp[0] << 8;
      ct = 8;
    }
  }
  void init(const uint8_t* p, size_t len) {
    bp = p;
    c = len == 0 ? 0xFFu << 16 : (uint32_t)p[0] << 16;
    bytein();
    c <<= 7;
    ct -= 7;
    a = 0x8000;
  }
  void raw_init(const uint8_t* p) {
    bp = p;
    c = 0;
    ct = 0;
  }
  void renorm() {
    do {
      if (ct == 0) bytein();
      a <<= 1;
      c <<= 1;
      --ct;
    } while (a < 0x8000);
  }
  int decode(int cx) {
    const MQState& s = kMQ[state[cx]];
    int d;
    a -= s.qe;
    if ((c >> 16) < s.qe) {  // LPS exchange
      if (a < s.qe) {
        a = s.qe;
        d = mps[cx];
        state[cx] = s.nmps;
      } else {
        a = s.qe;
        d = !mps[cx];
        if (s.sw) mps[cx] = (uint8_t)!mps[cx];
        state[cx] = s.nlps;
      }
      renorm();
    } else {
      c -= (uint32_t)s.qe << 16;
      if ((a & 0x8000) == 0) {  // MPS exchange
        if (a < s.qe) {
          d = !mps[cx];
          if (s.sw) mps[cx] = (uint8_t)!mps[cx];
          state[cx] = s.nlps;
        } else {
          d = mps[cx];
          state[cx] = s.nmps;
        }
        renorm();
      } else {
        d = mps[cx];
      }
    }
    return d;
  }
  int raw() {
    if (ct == 0) {
      if (c == 0xFF) {
        if (bp[0] > 0x8F) {
          c = 0xFF;
          ct = 8;
        } else {
          c = bp[0];
          ++bp;
          ct = 7;
        }
      } else {
        c = bp[0];
        ++bp;
        ct = 8;
      }
    }
    --ct;
    return (int)((c >> ct) & 1);
  }
};

// ------------------------------------------------------------- tier 1

enum : uint32_t {
  NB_NW = 1, NB_N = 2, NB_NE = 4, NB_W = 8, NB_E = 16, NB_SW = 32, NB_S = 64, NB_SE = 128,
  NEG_N = 1 << 8, NEG_S = 1 << 9, NEG_W = 1 << 10, NEG_E = 1 << 11,
  F_SIG = 1 << 12, F_PI = 1 << 13, F_MU = 1 << 14,
};

struct Luts {
  uint8_t zc[3][256];  // LL and LH; HL (h and v swapped); HH
  uint8_t sc[256], spb[256];
  Luts() {
    for (int f = 0; f < 256; ++f) {
      const int h = !!(f & NB_W) + !!(f & NB_E), v = !!(f & NB_N) + !!(f & NB_S);
      const int d = !!(f & NB_NW) + !!(f & NB_NE) + !!(f & NB_SW) + !!(f & NB_SE);
      auto hv_table = [&](int hh, int vv) {
        if (hh == 2) return 8;
        if (hh == 1) return vv ? 7 : d ? 6 : 5;
        if (vv) return vv == 2 ? 4 : 3;
        return d >= 2 ? 2 : d;
      };
      zc[0][f] = (uint8_t)(CTX_ZC + hv_table(h, v));
      zc[1][f] = (uint8_t)(CTX_ZC + hv_table(v, h));
      const int hs = h + v;
      const int n = d >= 3 ? 8 : d == 2 ? (hs ? 7 : 6) : d == 1 ? (hs >= 2 ? 5 : hs ? 4 : 3)
                                                                  : (hs >= 2 ? 2 : hs);
      zc[2][f] = (uint8_t)(CTX_ZC + n);
      // f here packs the sign-context neighbours: bit 0 / 1 N significant /
      // negative, 2 / 3 S, 4 / 5 W, 6 / 7 E
      auto contrib = [&](int sig, int neg) { return (f >> sig & 1) ? ((f >> neg & 1) ? -1 : 1) : 0; };
      const int pos_h = (contrib(4, 5) > 0) + (contrib(6, 7) > 0);
      const int neg_h = (contrib(4, 5) < 0) + (contrib(6, 7) < 0);
      const int pos_v = (contrib(0, 1) > 0) + (contrib(2, 3) > 0);
      const int neg_v = (contrib(0, 1) < 0) + (contrib(2, 3) < 0);
      int hc = std::min(pos_h, 1) - std::min(neg_h, 1);
      int vc = std::min(pos_v, 1) - std::min(neg_v, 1);
      spb[f] = (uint8_t)((hc || vc) && !(hc > 0 || (!hc && vc > 0)));
      if (hc < 0) {
        hc = -hc;
        vc = -vc;
      }
      sc[f] = (uint8_t)(CTX_SC + (!hc ? (vc ? 1 : 0) : (vc == -1 ? 2 : vc == 0 ? 3 : 4)));
    }
  }
};

struct Segment {
  uint32_t len = 0, numpasses = 0, maxpasses = 0, newlen = 0, numnewpasses = 0;
};

struct CodeBlock {
  int x0, y0, x1, y1;
  std::vector<uint8_t> data;
  std::vector<Segment> segs;
  uint32_t numsegs = 0, numlenbits = 0, numbps = 0, numnewpasses = 0;
};

// One code-block's coefficients (t1.c's opj_t1_decode_cblk), row-major,
// twice the magnitude with the half bit, as OpenJPEG keeps them.
class T1 {
 public:
  T1(const Luts& l, int w, int h, int orient, int cblksty)
      : luts_(l), w_(w), h_(h), stride_(w + 2), zc_(l.zc[orient == 1 ? 1 : orient == 3 ? 2 : 0]),
        vsc_(cblksty & 8), data_((size_t)w * h, 0), flags_((size_t)(w + 2) * (h + 2), 0) {}

  std::vector<int32_t>& decode(const CodeBlock& cb, int cblksty) {
    int32_t bpno_plus_one = (int32_t)cb.numbps;
    if (bpno_plus_one >= 31) refuse("a code-block of 31 or more bit-planes (OpenJPEG refuses it)");
    if (cb.data.empty() && cb.numsegs == 0) return data_;
    // the segments' bytes, each followed by OpenJPEG's 0xFF 0xFF
    int passtype = 2;
    mq_.reset_states();
    size_t at = 0;
    std::vector<uint8_t> seg;
    for (uint32_t s = 0; s < cb.numsegs; ++s) {
      const Segment& sg = cb.segs[s];
      seg.assign(cb.data.begin() + (long)at, cb.data.begin() + (long)(at + sg.len));
      seg.push_back(0xFF);
      seg.push_back(0xFF);
      at += sg.len;
      const bool raw = bpno_plus_one <= (int32_t)cb.numbps - 4 && passtype < 2 && (cblksty & 1);
      if (raw) {
        mq_.raw_init(seg.data());
      } else {
        mq_.init(seg.data(), sg.len);
      }
      for (uint32_t p = 0; p < sg.numpasses && bpno_plus_one >= 1; ++p) {
        if (passtype == 0) {
          sigpass(bpno_plus_one, raw);
        } else if (passtype == 1) {
          refpass(bpno_plus_one, raw);
        } else {
          clnpass(bpno_plus_one, cblksty);
        }
        if ((cblksty & 2) && !raw) mq_.reset_states();
        if (++passtype == 3) {
          passtype = 0;
          --bpno_plus_one;
        }
      }
    }
    return data_;
  }

 private:
  uint32_t& flag(int x, int y) { return flags_[(size_t)(y + 1) * stride_ + x + 1]; }

  // the sign-context byte of Luts::sc from a sample's flags
  static uint32_t sc_index(uint32_t f) {
    return (!!(f & NB_N)) | (!!(f & NEG_N)) << 1 | (!!(f & NB_S)) << 2 | (!!(f & NEG_S)) << 3 |
           (!!(f & NB_W)) << 4 | (!!(f & NEG_W)) << 5 | (!!(f & NB_E)) << 6 |
           (!!(f & NEG_E)) << 7;
  }

  // A sample turns significant: its neighbours' flags learn it. Under
  // vertically causal contexts a stripe's last row does not see the row
  // below it.
  void set_significant(int x, int y, bool neg) {
    uint32_t* f = &flag(x, y);
    *f |= F_SIG;
    const int s = stride_;
    if (!(vsc_ && (y & 3) == 0 && y > 0)) {
      f[-s - 1] |= NB_SE;
      f[-s] |= NB_S | (neg ? (uint32_t)NEG_S : 0u);
      f[-s + 1] |= NB_SW;
    }
    f[-1] |= NB_E | (neg ? (uint32_t)NEG_E : 0u);
    f[1] |= NB_W | (neg ? (uint32_t)NEG_W : 0u);
    f[s - 1] |= NB_NE;
    f[s] |= NB_N | (neg ? (uint32_t)NEG_N : 0u);
    f[s + 1] |= NB_NW;
  }

  void decode_sign(int x, int y, int32_t oneplushalf) {
    const uint32_t lu = sc_index(flag(x, y));
    const int v = mq_.decode(luts_.sc[lu]) ^ luts_.spb[lu];
    data_[(size_t)y * w_ + x] = v ? -oneplushalf : oneplushalf;
    set_significant(x, y, v);
  }

  void sigpass(int32_t bpno, bool raw) {
    const int32_t one = 1 << bpno, oneplushalf = one | (one >> 1);
    for (int k = 0; k < h_; k += 4) {
      for (int x = 0; x < w_; ++x) {
        for (int y = k; y < k + 4 && y < h_; ++y) {
          uint32_t& f = flag(x, y);
          if ((f & (F_SIG | F_PI)) || !(f & 0xFF)) continue;
          if (raw) {
            if (mq_.raw()) {
              const int v = mq_.raw();
              data_[(size_t)y * w_ + x] = v ? -oneplushalf : oneplushalf;
              set_significant(x, y, v);
            }
          } else if (mq_.decode(zc_[f & 0xFF])) {
            decode_sign(x, y, oneplushalf);
          }
          f |= F_PI;
        }
      }
    }
  }

  void refpass(int32_t bpno, bool raw) {
    const int32_t poshalf = (1 << bpno) >> 1;
    for (int k = 0; k < h_; k += 4) {
      for (int x = 0; x < w_; ++x) {
        for (int y = k; y < k + 4 && y < h_; ++y) {
          uint32_t& f = flag(x, y);
          if ((f & (F_SIG | F_PI)) != F_SIG) continue;
          const int v = raw ? mq_.raw()
                            : mq_.decode((f & F_MU) ? CTX_MAG + 2 : (f & 0xFF) ? CTX_MAG + 1 : CTX_MAG);
          int32_t& d = data_[(size_t)y * w_ + x];
          d += (v ^ (d < 0)) ? poshalf : -poshalf;
          f |= F_MU;
        }
      }
    }
  }

  void clnpass(int32_t bpno, int cblksty) {
    const int32_t one = 1 << bpno, oneplushalf = one | (one >> 1);
    for (int k = 0; k < h_; k += 4) {
      for (int x = 0; x < w_; ++x) {
        int y = k;
        if (k + 4 <= h_) {
          bool quiet = true;
          for (int j = 0; j < 4 && quiet; ++j) {
            if (flag(x, k + j) & (F_SIG | F_PI | 0xFF)) quiet = false;
          }
          if (quiet) {  // run-length mode
            if (!mq_.decode(CTX_AGG)) {
              continue;
            }
            int r = mq_.decode(CTX_UNI) << 1;
            r |= mq_.decode(CTX_UNI);
            decode_sign(x, k + r, oneplushalf);
            y = k + r + 1;
          }
        }
        for (; y < k + 4 && y < h_; ++y) {
          const uint32_t f = flag(x, y);
          if (f & (F_SIG | F_PI)) continue;
          if (mq_.decode(zc_[f & 0xFF])) decode_sign(x, y, oneplushalf);
        }
        for (int j = k; j < k + 4 && j < h_; ++j) flag(x, j) &= ~F_PI;
      }
    }
    if (cblksty & 32) {  // segmentation symbol: four UNIFORM decisions
      for (int i = 0; i < 4; ++i) mq_.decode(CTX_UNI);
    }
  }

  const Luts& luts_;
  int w_, h_, stride_;
  const uint8_t* zc_;
  bool vsc_;
  MQ mq_;
  std::vector<int32_t> data_;
  std::vector<uint32_t> flags_;
};

// --------------------------------------------------------------- tier 2

// bio.c's packet-header bit reader: after a 0xFF byte the next holds 7
// bits; past the end zero bits are read and no byte is counted.
struct Bio {
  const uint8_t *start, *bp, *end;
  uint32_t buf = 0;
  int ct = 0;
  Bio(const uint8_t* p, size_t n) : start(p), bp(p), end(p + n) {}
  void bytein() {
    buf = (buf << 8) & 0xFFFF;
    ct = buf == 0xFF00 ? 7 : 8;
    if (bp >= end) return;
    buf |= *bp++;
  }
  uint32_t bit() {
    if (ct == 0) bytein();
    --ct;
    return (buf >> ct) & 1;
  }
  uint32_t read(int n) {
    uint32_t v = 0;
    for (int i = n - 1; i >= 0; --i) v |= bit() << i;
    return v;
  }
  void inalign() {
    if ((buf & 0xFF) == 0xFF) bytein();
    ct = 0;
  }
  size_t numbytes() const { return (size_t)(bp - start); }
};

// tgt.c's tag tree: leaves w x h, parents on halved grids; value 999 and
// low 0 at the start.
struct TagTree {
  struct Node {
    int parent, value, low;
  };
  std::vector<Node> nodes;
  void init(int w, int h) {
    nodes.clear();
    if (w <= 0 || h <= 0) return;
    std::vector<int> lw{w}, lh{h};
    while ((long long)lw.back() * lh.back() > 1) {
      lw.push_back((lw.back() + 1) / 2);
      lh.push_back((lh.back() + 1) / 2);
    }
    size_t total = 0;
    std::vector<size_t> base;
    for (size_t l = 0; l < lw.size(); ++l) {
      base.push_back(total);
      total += (size_t)lw[l] * lh[l];
    }
    nodes.assign(total, Node{-1, 999, 0});
    for (size_t l = 0; l + 1 < lw.size(); ++l) {
      for (int y = 0; y < lh[l]; ++y) {
        for (int x = 0; x < lw[l]; ++x) {
          nodes[base[l] + (size_t)y * lw[l] + x].parent =
              (int)(base[l + 1] + (size_t)(y / 2) * lw[l + 1] + x / 2);
        }
      }
    }
  }
  int decode(Bio& bio, int leaf, int threshold) {
    int stk[64], n = 0;
    int node = leaf;
    while (nodes[node].parent >= 0) {
      stk[n++] = node;
      node = nodes[node].parent;
    }
    int low = 0;
    for (;;) {
      Node& nd = nodes[node];
      if (low > nd.low) {
        nd.low = low;
      } else {
        low = nd.low;
      }
      while (low < threshold && low < nd.value) {
        if (bio.bit()) {
          nd.value = low;
        } else {
          ++low;
        }
      }
      nd.low = low;
      if (n == 0) break;
      node = stk[--n];
    }
    return nodes[node].value < threshold ? 1 : 0;
  }
};

struct Precinct {
  int cw = 0, ch = 0;
  std::vector<CodeBlock> cblks;
  TagTree incl, imsb;
};

struct Band {
  int bandno;  // 0 LL, 1 HL, 2 LH, 3 HH
  int64_t x0, y0, x1, y1;
  int numbps;
  float stepsize;
  std::vector<Precinct> precincts;
  bool empty() const { return x1 <= x0 || y1 <= y0; }
};

struct Resolution {
  int64_t x0, y0, x1, y1;
  int pdx, pdy, pw, ph;
  std::vector<Band> bands;
};

struct StepSize {
  int expn = 0, mant = 0;
};

struct Tccp {  // per tile-component coding parameters
  int csty = 0, numres = 1, cblkw = 6, cblkh = 6, cblksty = 0, qmfbid = 0;
  int prcw[33], prch[33];
  int qntsty = 0, numgbits = 0;
  StepSize steps[97];
  Tccp() {
    for (int i = 0; i < 33; ++i) prcw[i] = prch[i] = 15;
  }
};

struct Tcp {  // per tile
  int csty = 0, prg = 0, numlayers = 1, mct = 0;
  std::vector<Tccp> tccps;
  std::vector<uint8_t> data;
  int current_part = -1, nb_parts = 0;
  bool decoded = false;
};

struct Comp {
  int dx = 1, dy = 1, prec = 8;
  bool sgnd = false;
  int64_t dc_shift = 0;
};

struct TileComp {
  int64_t x0, y0, x1, y1;
  std::vector<Resolution> res;
  std::vector<int32_t> idata;
  std::vector<float> fdata;
  int resno_decoded = -1;
  int64_t w() const { return x1 - x0; }
  int64_t h() const { return y1 - y0; }
};

// ------------------------------------------------------------------- DWT

// dwt.c's 5/3 inverse on one line of n samples, low-pass ones first; cas
// is the parity of the first sample's coordinate.
void idwt53_1d(int32_t* a, int sn, int dn, int cas, std::vector<int32_t>& tmp) {
  const int n = sn + dn;
  if (n == 1) {
    if (cas) a[0] /= 2;
    return;
  }
  tmp.resize((size_t)n);
  for (int i = 0; i < sn; ++i) tmp[(size_t)(2 * i + cas)] = a[i];
  for (int i = 0; i < dn; ++i) tmp[(size_t)(2 * i + 1 - cas)] = a[sn + i];
  auto at = [&](int i) { return tmp[(size_t)(i < 0 ? -i : i >= n ? 2 * (n - 1) - i : i)]; };
  // low-pass positions are those of parity cas
  for (int i = cas; i < n; i += 2) tmp[(size_t)i] -= (at(i - 1) + at(i + 1) + 2) >> 2;
  for (int i = 1 - cas; i < n; i += 2) tmp[(size_t)i] += (at(i - 1) + at(i + 1)) >> 1;
  std::copy(tmp.begin(), tmp.begin() + n, a);
}

// The 9/7 inverse as opj_v8dwt_decode computes it.
void idwt97_1d(float* a, int sn, int dn, int cas, std::vector<float>& tmp) {
  const int n = sn + dn;
  if (cas == 0 ? !(dn > 0 || sn > 1) : !(sn > 0 || dn > 1)) return;
  tmp.resize((size_t)n);
  for (int i = 0; i < sn; ++i) tmp[(size_t)(2 * i + cas)] = a[i];
  for (int i = 0; i < dn; ++i) tmp[(size_t)(2 * i + 1 - cas)] = a[sn + i];
  const float K = 1.230174105f, two_invK = 1.625732422f;
  const float delta = 0.443506852f, gamma = 0.882911075f, beta = -0.052980118f,
              alpha = -1.586134342f;
  for (int i = cas; i < n; i += 2) tmp[(size_t)i] = tmp[(size_t)i] * K;
  for (int i = 1 - cas; i < n; i += 2) tmp[(size_t)i] = tmp[(size_t)i] * two_invK;
  auto at = [&](int i) { return tmp[(size_t)(i < 0 ? -i : i >= n ? 2 * (n - 1) - i : i)]; };
  auto step = [&](int parity, float c) {
    for (int i = parity; i < n; i += 2) tmp[(size_t)i] = tmp[(size_t)i] + (at(i - 1) + at(i + 1)) * c;
  };
  step(cas, -delta);
  step(1 - cas, -gamma);
  step(cas, -beta);
  step(1 - cas, -alpha);
  std::copy(tmp.begin(), tmp.begin() + n, a);
}

template <typename T, typename F>
void idwt_2d(TileComp& tc, std::vector<T>& d, F one_d) {
  const int64_t W = tc.w();
  std::vector<T> line, tmp;
  for (size_t r = 1; r < tc.res.size(); ++r) {
    const Resolution& lo = tc.res[r - 1];
    const Resolution& hi = tc.res[r];
    const int rw = (int)(hi.x1 - hi.x0), rh = (int)(hi.y1 - hi.y0);
    const int sw = (int)(lo.x1 - lo.x0), shh = (int)(lo.y1 - lo.y0);
    const int cas_x = (int)(hi.x0 & 1), cas_y = (int)(hi.y0 & 1);
    for (int y = 0; y < rh; ++y) one_d(&d[(size_t)y * W], sw, rw - sw, cas_x, tmp);
    line.resize((size_t)rh);
    for (int x = 0; x < rw; ++x) {
      for (int y = 0; y < rh; ++y) line[(size_t)y] = d[(size_t)y * W + x];
      one_d(line.data(), shh, rh - shh, cas_y, tmp);
      for (int y = 0; y < rh; ++y) d[(size_t)y * W + x] = line[(size_t)y];
    }
  }
}

// ------------------------------------------------------------ codestream

enum : uint32_t {
  M_SOC = 0xFF4F, M_CAP = 0xFF50, M_SIZ = 0xFF51, M_COD = 0xFF52, M_COC = 0xFF53,
  M_TLM = 0xFF55, M_PLM = 0xFF57, M_PLT = 0xFF58, M_QCD = 0xFF5C, M_QCC = 0xFF5D,
  M_RGN = 0xFF5E, M_POC = 0xFF5F, M_PPM = 0xFF60, M_PPT = 0xFF61, M_CRG = 0xFF63,
  M_COM = 0xFF64, M_CPF = 0xFF59, M_SOT = 0xFF90, M_SOP = 0xFF91, M_EPH = 0xFF92,
  M_SOD = 0xFF93, M_EOC = 0xFFD9, M_MCT = 0xFF74, M_MCC = 0xFF75, M_MCO = 0xFF77, M_CBD = 0xFF78,
};
enum : int { S_MHSIZ = 2, S_MH = 4, S_TPHSOT = 8, S_TPH = 16 };

// opj_j2k_get_marker_handler's table: the markers OpenJPEG knows (SOP
// among them, allowed in no header; SOD, EPH and EOC are not in it) and
// the states each may come in.
bool known_marker(uint32_t m) {
  switch (m) {
    case M_SOT: case M_COD: case M_COC: case M_RGN: case M_QCD: case M_QCC: case M_POC:
    case M_SIZ: case M_TLM: case M_PLM: case M_PLT: case M_PPM: case M_PPT: case M_SOP:
    case M_CRG: case M_COM: case M_CAP: case M_CPF: case M_MCT: case M_MCC: case M_MCO:
    case M_CBD:
      return true;
    default:
      return false;
  }
}
int marker_states(uint32_t m) {
  switch (m) {
    case M_SOT: return S_MH | S_TPHSOT;
    case M_COD: case M_COC: case M_RGN: case M_QCD: case M_QCC: case M_POC: case M_COM:
    case M_MCT: case M_MCC: case M_MCO:
      return S_MH | S_TPH;
    case M_PLT: case M_PPT: return S_TPH;
    case M_SIZ: return S_MHSIZ;
    case M_TLM: case M_PLM: case M_PPM: case M_CRG: case M_CAP: case M_CPF: case M_CBD:
      return S_MH;
    case M_SOP: return 0;
    default: return S_MH | S_TPH;  // unknown: OpenJPEG's UNK entry (no handler)
  }
}

// opj_j2k_read_plt's check: the last packet length of a run of 7-bit
// groups is complete.
bool packet_lengths_end(const uint8_t* s, size_t n) {
  uint32_t len = 0;
  for (size_t i = 0; i < n; ++i) {
    len |= s[i] & 0x7F;
    len = (s[i] & 0x80) ? len << 7 : 0;
  }
  return len == 0;
}

struct Codestream {
  const uint8_t* at;  // the stream: the codestream up to the end of the file
  const uint8_t* end;
  int64_t x0 = 0, y0 = 0, x1 = 0, y1 = 0, tx0 = 0, ty0 = 0, tdx = 0, tdy = 0;
  int tw = 0, th = 0;
  std::vector<Comp> comps;
  Tcp def;  // the main header's
  std::map<uint32_t, Tcp> tcps;  // the tiles a SOT has named, from def
  int state = 0;
  bool any_tile = false, tp_correction_checked = false;
  int tp_correction = 0;
  const Luts* luts = nullptr;

  uint32_t read16() {
    if (end - at < 2) refuse("the codestream ends early (OpenJPEG: stream too short)");
    const uint32_t v = be16(at);
    at += 2;
    return v;
  }

  void read_siz(const uint8_t* s, size_t n) {
    if (n < 36 || (n - 36) % 3) refuse("bad SIZ marker size");
    x1 = be32(s + 2);
    y1 = be32(s + 6);
    x0 = be32(s + 10);
    y0 = be32(s + 14);
    tdx = be32(s + 18);
    tdy = be32(s + 22);
    tx0 = be32(s + 26);
    ty0 = be32(s + 30);
    const uint32_t nc = be16(s + 34);
    if (nc == 0 || nc > 16384 || n != 36 + 3 * (size_t)nc) refuse("bad SIZ marker size");
    if (x0 >= x1 || y0 >= y1) refuse("SIZ: negative or zero image size");
    if (tdx == 0 || tdy == 0) refuse("SIZ: invalid tile size");
    if (tx0 > x0 || ty0 > y0 || tx0 + tdx <= x0 || ty0 + tdy <= y0) refuse("SIZ: illegal tile offset");
    comps.resize(nc);
    for (uint32_t i = 0; i < nc; ++i) {
      const uint8_t* c = s + 36 + 3 * i;
      comps[i].prec = (c[0] & 0x7F) + 1;
      comps[i].sgnd = c[0] >> 7;
      comps[i].dx = c[1];
      comps[i].dy = c[2];
      if (comps[i].prec > 31) refuse("SIZ: a component of more than 31 bits (OpenJPEG refuses it)");
      if (comps[i].dx < 1 || comps[i].dy < 1) refuse("SIZ: a zero subsampling factor");
      comps[i].dc_shift = comps[i].sgnd ? 0 : (int64_t)1 << (comps[i].prec - 1);
    }
    const int64_t ntw = ceildiv(x1 - tx0, tdx), nth = ceildiv(y1 - ty0, tdy);
    if (ntw <= 0 || nth <= 0 || ntw > 65535 / nth) refuse("SIZ: invalid number of tiles");
    tw = (int)ntw;
    th = (int)nth;
    opencv_checks();
    def.tccps.assign(nc, Tccp());
    state = S_MH;
  }

  // OpenCV's readHeader and readData checks on what SIZ gives. cv2 makes
  // them once OpenJPEG has read the main header; here they come before
  // anything is sized by the header, so that a small file cannot make the
  // decoder allocate for 16384 components or a 2^30-pixel image it will
  // refuse. Either way the file is refused.
  void opencv_checks() const {
    if (comps.size() > 4) refuse("more than 4 components (cv2 refuses it too)");
    int max_prec = 0;
    for (const Comp& c : comps) {
      if (c.sgnd) refuse("signed components are not supported (cv2 refuses them too)");
      max_prec = std::max(max_prec, c.prec);
    }
    if (max_prec < 8) refuse("components under 8 bits are not supported (cv2 refuses them too)");
    for (const Comp& c : comps) {
      if (c.dx != 1 || c.dy != 1) refuse("subsampled components are not supported (cv2 refuses them too)");
    }
    if (x0 != 0 || y0 != 0) refuse("an image offset is not supported (cv2 refuses it too)");
    check_size("JPEG 2000", x1, y1);
  }

  // opj_j2k_read_SPCod_SPCoc
  size_t read_spcod(const uint8_t* s, size_t n, Tccp& t) {
    if (n < 5) refuse("bad COD / COC marker size");
    t.numres = s[0] + 1;
    if (t.numres > 33) refuse("more than 32 decomposition levels");
    t.cblkw = s[1] + 2;
    t.cblkh = s[2] + 2;
    if (t.cblkw > 10 || t.cblkh > 10 || t.cblkw + t.cblkh > 12) refuse("invalid code-block size");
    t.cblksty = s[3];
    if (t.cblksty & 0xC0) {
      refuse("HTJ2K (Part 15 high-throughput code-blocks) is not supported");
    }
    t.qmfbid = s[4];
    if (t.qmfbid > 1) refuse("Part 2 extensions (an arbitrary wavelet) are not supported");
    size_t used = 5;
    if (t.csty & 1) {
      if (n < 5 + (size_t)t.numres) refuse("bad COD / COC marker size");
      for (int r = 0; r < t.numres; ++r) {
        const uint8_t b = s[5 + r];
        if (r != 0 && ((b & 0xF) == 0 || (b >> 4) == 0)) refuse("invalid precinct size");
        t.prcw[r] = b & 0xF;
        t.prch[r] = b >> 4;
      }
      used += (size_t)t.numres;
    } else {
      for (int r = 0; r < t.numres; ++r) t.prcw[r] = t.prch[r] = 15;
    }
    return used;
  }

  void read_cod(const uint8_t* s, size_t n, Tcp& tcp) {
    if (n < 5) refuse("bad COD marker size");
    tcp.csty = s[0];
    if (tcp.csty & ~7) refuse("unknown Scod value in COD (OpenJPEG refuses it)");
    tcp.prg = s[1];
    if (tcp.prg > 4) refuse("unknown progression order");
    tcp.numlayers = (int)be16(s + 2);
    if (tcp.numlayers == 0) refuse("COD: zero layers");
    tcp.mct = s[4];
    if (tcp.mct > 1) refuse("Part 2 extensions (a custom multiple component transform) are not supported");
    Tccp t0 = tcp.tccps[0];
    t0.csty = tcp.csty & 1;
    if (read_spcod(s + 5, n - 5, t0) != n - 5) refuse("bad COD marker size");
    for (Tccp& t : tcp.tccps) {
      const Tccp keep = t;
      t = t0;
      t.qntsty = keep.qntsty;
      t.numgbits = keep.numgbits;
      std::copy(keep.steps, keep.steps + 97, t.steps);
    }
  }

  void read_coc(const uint8_t* s, size_t n, Tcp& tcp) {
    const size_t cb = comps.size() <= 256 ? 1 : 2;
    if (n < cb + 1) refuse("bad COC marker size");
    const uint32_t c = cb == 1 ? s[0] : be16(s);
    if (c >= comps.size()) refuse("COC: bad component number");
    Tccp& t = tcp.tccps[c];
    t.csty = s[cb] & 1;
    if (read_spcod(s + cb + 1, n - cb - 1, t) != n - cb - 1) refuse("bad COC marker size");
  }

  // opj_j2k_read_SQcd_SQcc
  void read_sqcd(const uint8_t* s, size_t n, Tccp& t) {
    if (n < 1) refuse("bad QCD / QCC marker size");
    t.qntsty = s[0] & 0x1F;
    t.numgbits = s[0] >> 5;
    size_t bands;
    if (t.qntsty == 1) {
      bands = 1;
    } else {
      bands = t.qntsty == 0 ? n - 1 : (n - 1) / 2;
    }
    const size_t need = t.qntsty == 0 ? bands : 2 * bands;
    if (n - 1 != need) refuse("bad QCD / QCC marker size");
    const size_t used = std::min(bands, (size_t)97);
    for (size_t b = 0; b < used; ++b) {
      if (t.qntsty == 0) {
        t.steps[b].expn = s[1 + b] >> 3;
        t.steps[b].mant = 0;
      } else {
        const uint32_t v = be16(s + 1 + 2 * b);
        t.steps[b].expn = (int)(v >> 11);
        t.steps[b].mant = (int)(v & 0x7FF);
      }
    }
    if (t.qntsty == 1) {
      for (int b = 1; b < 97; ++b) {
        t.steps[b].expn = std::max(t.steps[0].expn - (b - 1) / 3, 0);
        t.steps[b].mant = t.steps[0].mant;
      }
    }
  }

  void read_qcd(const uint8_t* s, size_t n, Tcp& tcp) {
    read_sqcd(s, n, tcp.tccps[0]);
    for (size_t c = 1; c < tcp.tccps.size(); ++c) {
      tcp.tccps[c].qntsty = tcp.tccps[0].qntsty;
      tcp.tccps[c].numgbits = tcp.tccps[0].numgbits;
      std::copy(tcp.tccps[0].steps, tcp.tccps[0].steps + 97, tcp.tccps[c].steps);
    }
  }

  void read_qcc(const uint8_t* s, size_t n, Tcp& tcp) {
    const size_t cb = comps.size() <= 256 ? 1 : 2;
    if (n < cb) refuse("bad QCC marker size");
    const uint32_t c = cb == 1 ? s[0] : be16(s);
    if (c >= comps.size()) refuse("QCC: bad component number");
    read_sqcd(s + cb, n - cb, tcp.tccps[c]);
  }

  // A marker segment of the main header or of a tile-part header.
  void handle(uint32_t m, const uint8_t* s, size_t n, Tcp& tcp) {
    switch (m) {
      case M_SIZ: read_siz(s, n); break;
      case M_COD: read_cod(s, n, tcp); break;
      case M_COC: read_coc(s, n, tcp); break;
      case M_QCD: read_qcd(s, n, tcp); break;
      case M_QCC: read_qcc(s, n, tcp); break;
      case M_RGN: refuse("RGN (region of interest max-shift) is not supported (OpenCV reads it)");
      case M_POC: refuse("POC (progression order change) is not supported (OpenCV reads it)");
      case M_PPM: case M_PPT:
        refuse("PPM / PPT (packed packet headers) are not supported");
      case M_CAP: refuse("HTJ2K (Part 15, the CAP marker) is not supported (OpenCV reads it)");
      case M_MCT: case M_MCC: case M_MCO: case M_CBD:
        refuse("Part 2 extensions (MCT, MCC, MCO and CBD markers) are not supported (OpenCV reads it)");
      case M_PLT:
        if (n < 1 || !packet_lengths_end(s + 1, n - 1)) refuse("bad PLT marker (OpenJPEG refuses it)");
        break;
      case M_PLM:  // its lengths are not checked (cv2 reads a PLM cut mid-length)
        if (n < 1) refuse("bad PLM marker (OpenJPEG refuses it)");
        break;
      case M_TLM:  // a bad Stlm or size is only warned of (cv2 reads the file)
        if (n < 2) refuse("bad TLM marker (OpenJPEG refuses it)");
        break;
      case M_CRG:
        if (n != comps.size() * 4) refuse("bad CRG marker (OpenJPEG refuses it)");
        break;
      default: break;  // COM, CPF: skipped
    }
  }

  // opj_j2k_read_unk: two bytes at a time up to a marker OpenJPEG knows.
  uint32_t skip_unknown() {
    for (;;) {
      const uint32_t m = read16();
      if (m < 0xFF00 || !known_marker(m)) continue;
      if (!(state & marker_states(m))) refuse("a marker out of its place after an unknown marker");
      return m;
    }
  }

  void read_main_header() {
    if (read16() != M_SOC) refuse("no SOC marker");
    state = S_MHSIZ;
    bool has_siz = false, has_cod = false, has_qcd = false;
    uint32_t m = read16();
    while (m != M_SOT) {
      if (m < 0xFF00) refuse("a marker was expected in the main header");
      if (!known_marker(m)) {
        m = skip_unknown();
        if (m == M_SOT) break;
      }
      if (m == M_SIZ) has_siz = true;
      if (m == M_COD) has_cod = true;
      if (m == M_QCD) has_qcd = true;
      if (!(state & marker_states(m))) refuse("a marker out of its place in the main header");
      const uint32_t len = read16();
      if (len < 2) refuse("invalid marker size");
      if ((size_t)(end - at) < len - 2) refuse("the codestream ends early (OpenJPEG: stream too short)");
      handle(m, at, len - 2, def);
      at += len - 2;
      m = read16();
    }
    if (!has_siz) refuse("no SIZ marker in the main header");
    if (!has_cod) refuse("no COD marker in the main header");
    if (!has_qcd) refuse("no QCD marker in the main header");
    state = S_TPHSOT;
  }

  // opj_j2k_need_nb_tile_parts_correction, at the first tile that can
  // decode: the SOT headers ahead, skipped by their Psot, up to the next
  // tile-part of this tile, whose TPsot equal to its TNsot says that the
  // writer counted tile-parts from 0.
  bool needs_tile_part_correction(uint32_t tileno) const {
    const uint8_t* q = at;
    for (;;) {
      if (end - q < 2 || be16(q) != M_SOT) return false;
      q += 2;
      if (end - q < 2) refuse("the codestream ends early (OpenJPEG: stream too short)");
      if (be16(q) != 10) refuse("inconsistent SOT marker size");
      q += 2;
      if (end - q < 8) refuse("the codestream ends early (OpenJPEG: stream too short)");
      const uint32_t t = be16(q), psot = be32(q + 2), part = q[6], parts = q[7];
      q += 8;
      if (t == tileno) return part == parts;
      if (psot < 14) return false;
      if ((uint64_t)(end - q) < psot - 12) return false;
      q += psot - 12;
    }
  }

  // The tile-parts as opj_j2k_read_tile_header, read_sot and read_sod read
  // them: each SOT, its header's markers, SOD, its data into the tile's
  // buffer. A tile decodes when its last tile-part is in (and then the
  // next marker must follow: EOC, SOT, or the end of the data); the rest
  // decode at EOC. Data that ends between markers ends the codestream (the
  // tiles not yet read stay 0); data that ends inside a marker segment or
  // a tile-part refuses, as OpenJPEG's strict mode does.
  void read_tiles(std::vector<std::vector<int32_t>>& image) {
    const int ntiles = tw * th;
    uint32_t m = M_SOT;  // the main header's last marker, consumed
    uint32_t sot_length = 0, tileno = 0;
    int decoded_tiles = 0;
    bool last_part = false, can_decode = false;
    while (m != M_EOC) {
      bool stop = false;
      while (m != M_SOD) {
        if (at == end) {  // J2K_STATE_NEOC
          stop = true;
          break;
        }
        const uint32_t len = read16();
        if (len < 2) refuse("inconsistent marker size");
        if (m == 0x8080 && at == end) {  // OpenJPEG lets a stream end in 0x8080 and a length
          stop = true;
          break;
        }
        if ((state & S_TPH) && sot_length != 0) {
          if (sot_length < len + 2) refuse("SOT: Psot is less than the tile-part header");
          sot_length -= len + 2;
        }
        if (!(state & marker_states(m)) || !known_marker(m)) {
          refuse("a marker out of its place in a tile-part header");
        }
        if ((size_t)(end - at) < len - 2) refuse("the codestream ends early (OpenJPEG: stream too short)");
        if (m == M_SOT) {
          if (len != 10) refuse("bad SOT marker size");
          tileno = be16(at);
          const uint32_t psot = be32(at + 2), tpsot = at[6], tnsot = at[7];
          if ((int)tileno >= ntiles) refuse("SOT: invalid tile number");
          Tcp& tcp = tcps.emplace(tileno, def).first->second;
          if (tcp.current_part + 1 != (int)tpsot) refuse("SOT: invalid tile-part index");
          ++tcp.current_part;
          if (psot != 0 && psot < 14 && psot != 12) refuse("SOT: bad Psot");
          last_part = psot == 0;
          if (tcp.nb_parts != 0 && (int)tpsot >= tcp.nb_parts) refuse("SOT: bad TPsot");
          if (tnsot != 0) {
            const int parts = (int)tnsot + tp_correction;
            if (tcp.nb_parts != 0 && (int)tpsot >= tcp.nb_parts) refuse("SOT: bad TPsot");
            if ((int)tpsot >= parts) refuse("SOT: bad TPsot");
            tcp.nb_parts = parts;
          }
          can_decode = tcp.nb_parts != 0 && tcp.nb_parts == (int)tpsot + 1;
          sot_length = last_part ? 0 : psot - 12;
          state = S_TPH;
        } else {
          handle(m, at, len - 2, tcps[tileno]);
        }
        at += len - 2;
        m = read16();
      }
      if (stop) {
        // a SOT that made its tile whole came before the end: OpenJPEG
        // decodes that tile, and fails where it has no data
        if (can_decode) {
          if (tcps[tileno].data.empty()) refuse("a tile with no data (OpenJPEG refuses it)");
          decode_tile((int)tileno, image);
        }
        break;
      }
      // SOD
      Tcp& tcp = tcps[tileno];
      if (last_part) {
        if (end - at < 2) refuse("a tile-part runs past the end of the data (cv2 returns None for a cut file)");
        sot_length = (uint32_t)(end - at - 2);
      } else if (sot_length >= 2) {
        sot_length -= 2;
      }
      if (sot_length > (size_t)(end - at)) {
        refuse("a tile-part runs past the end of the data (cv2 returns None for a cut file)");
      }
      tcp.data.insert(tcp.data.end(), at, at + sot_length);
      at += sot_length;
      state = S_TPHSOT;
      // (cv2 shows the look-ahead only for a tile's later tile-parts: a
      // tile of one tile-part decodes at once)
      if (can_decode && !tp_correction_checked && tcp.current_part > 0) {
        tp_correction_checked = true;
        if (needs_tile_part_correction(tileno)) {
          can_decode = false;
          tp_correction = 1;
          for (auto& t : tcps) {
            if (t.second.nb_parts != 0) ++t.second.nb_parts;
          }
        }
      }
      if (can_decode) {
        if (tcp.data.empty()) refuse("a tile with no data (OpenJPEG refuses it)");
        decode_tile((int)tileno, image);
        can_decode = false;
        m = read16();
        if (m != M_EOC && m != M_SOT) {
          if (at == end) break;
          refuse("a SOT marker was expected after tile-part data");
        }
        if (++decoded_tiles == ntiles) break;  // the rest is not read
      } else if (end - at < 2) {
        // OpenJPEG's allowance for files whose last tile row has TPsot 0
        // and TNsot 0 and no EOC: taken as ended
        bool spot6 = false;
        for (const auto& t : tcps) spot6 |= t.second.current_part == 0 && t.second.nb_parts == 0;
        if ((int)tileno + 1 != ntiles || !spot6) {
          refuse("the codestream ends early (OpenJPEG: stream too short)");
        }
        break;
      } else {
        m = read16();
      }
    }
    // tiles whose last tile-part did not come: decode what arrived
    for (auto& t : tcps) {
      if (!t.second.data.empty() && !t.second.decoded) decode_tile((int)t.first, image);
    }
    if (!any_tile) refuse("no tile was decoded");
  }

  void decode_tile(int tileno, std::vector<std::vector<int32_t>>& image);
};

// ------------------------------------------------------------ tile decode

struct PiComp {
  int dx, dy, numres;
  std::vector<Resolution>* res;
};

// pi.c's iterators over one tile: every packet (layer, resolution,
// component, precinct) once, in the tile's progression order.
template <typename F>
void for_each_packet(int prg, int numlayers, std::vector<PiComp>& pc, int64_t tx0, int64_t ty0,
                     int64_t tx1, int64_t ty1, F packet) {
  const int nc = (int)pc.size();
  int maxres = 0;
  for (auto& c : pc) maxres = std::max(maxres, c.numres);
  if (prg == 0 || prg == 1) {  // LRCP, RLCP
    for (int a = 0; a < (prg == 0 ? numlayers : maxres); ++a) {
      for (int b = 0; b < (prg == 0 ? maxres : numlayers); ++b) {
        const int l = prg == 0 ? a : b, r = prg == 0 ? b : a;
        for (int c = 0; c < nc; ++c) {
          if (r >= pc[c].numres) continue;
          const Resolution& res = (*pc[c].res)[r];
          for (int p = 0; p < res.pw * res.ph; ++p) packet(l, r, c, p);
        }
      }
    }
    return;
  }
  // position-driven orders: the (x, y) grid steps and the precinct test.
  // pi.c's include array marks each packet it gives; the layers are the
  // innermost loop, so a (resolution, component, precinct) marked once
  // has had all its layers.
  int maxprec = 0;
  for (auto& c : pc) {
    for (auto& r : *c.res) maxprec = std::max(maxprec, r.pw * r.ph);
  }
  std::vector<uint8_t> seen((size_t)maxprec * nc * maxres, 0);
  auto steps = [&](int c0, int c1, uint64_t& dx, uint64_t& dy) {
    dx = dy = 0;
    for (int c = c0; c < c1; ++c) {
      for (int r = 0; r < pc[c].numres; ++r) {
        const Resolution& res = (*pc[c].res)[r];
        const int sx = res.pdx + pc[c].numres - 1 - r, sy = res.pdy + pc[c].numres - 1 - r;
        if (sx < 32 && (uint64_t)pc[c].dx <= 0xFFFFFFFFull / (1ull << sx)) {
          const uint64_t v = (uint64_t)pc[c].dx << sx;
          dx = !dx ? v : std::min(dx, v);
        }
        if (sy < 32 && (uint64_t)pc[c].dy <= 0xFFFFFFFFull / (1ull << sy)) {
          const uint64_t v = (uint64_t)pc[c].dy << sy;
          dy = !dy ? v : std::min(dy, v);
        }
      }
    }
  };
  auto at_position = [&](int64_t x, int64_t y, int r, int c) {
    const PiComp& comp = pc[c];
    if (r >= comp.numres) return;
    const Resolution& res = (*comp.res)[r];
    const int levelno = comp.numres - 1 - r;
    const uint64_t cdx = (uint64_t)comp.dx << levelno, cdy = (uint64_t)comp.dy << levelno;
    const int64_t trx0 = ceildiv(tx0, (int64_t)cdx), try0 = ceildiv(ty0, (int64_t)cdy);
    const int64_t trx1 = ceildiv(tx1, (int64_t)cdx), try1 = ceildiv(ty1, (int64_t)cdy);
    const int rpx = res.pdx + levelno, rpy = res.pdy + levelno;
    if (rpx >= 63 || rpy >= 63) return;
    if (!((uint64_t)y % ((uint64_t)comp.dy << rpy) == 0 ||
          (y == ty0 && ((uint64_t)try0 << levelno) % (1ull << rpy)))) {
      return;
    }
    if (!((uint64_t)x % ((uint64_t)comp.dx << rpx) == 0 ||
          (x == tx0 && ((uint64_t)trx0 << levelno) % (1ull << rpx)))) {
      return;
    }
    if (res.pw == 0 || res.ph == 0) return;
    if (trx0 == trx1 || try0 == try1) return;
    const int64_t prci = floordivpow2(ceildiv(x, (int64_t)cdx), res.pdx) - floordivpow2(trx0, res.pdx);
    const int64_t prcj = floordivpow2(ceildiv(y, (int64_t)cdy), res.pdy) - floordivpow2(try0, res.pdy);
    const int64_t precno = prci + prcj * res.pw;
    if (precno < 0 || precno >= (int64_t)res.pw * res.ph) return;
    uint8_t& mark = seen[((size_t)r * nc + c) * maxprec + (size_t)precno];
    if (mark) return;
    mark = 1;
    for (int l = 0; l < numlayers; ++l) packet(l, r, c, (int)precno);
  };
  auto grid = [&](uint64_t dx, uint64_t dy, auto body) {
    if (dx == 0 || dy == 0) return;
    for (int64_t y = ty0; y < ty1; y += (int64_t)(dy - (uint64_t)y % dy)) {
      for (int64_t x = tx0; x < tx1; x += (int64_t)(dx - (uint64_t)x % dx)) body(x, y);
    }
  };
  uint64_t dx, dy;
  if (prg == 2) {  // RPCL
    steps(0, nc, dx, dy);
    for (int r = 0; r < maxres; ++r) {
      grid(dx, dy, [&](int64_t x, int64_t y) {
        for (int c = 0; c < nc; ++c) at_position(x, y, r, c);
      });
    }
  } else if (prg == 3) {  // PCRL
    steps(0, nc, dx, dy);
    grid(dx, dy, [&](int64_t x, int64_t y) {
      for (int c = 0; c < nc; ++c) {
        for (int r = 0; r < std::min(maxres, pc[c].numres); ++r) at_position(x, y, r, c);
      }
    });
  } else {  // CPRL
    for (int c = 0; c < nc; ++c) {
      steps(c, c + 1, dx, dy);
      grid(dx, dy, [&](int64_t x, int64_t y) {
        for (int r = 0; r < std::min(maxres, pc[c].numres); ++r) at_position(x, y, r, c);
      });
    }
  }
}

// opj_t2_init_seg
void init_seg(CodeBlock& cb, uint32_t index, int cblksty, bool first) {
  if (cb.segs.size() < index + 1) cb.segs.resize(index + 1);
  Segment& s = cb.segs[index];
  s = Segment();
  if (cblksty & 4) {
    s.maxpasses = 1;
  } else if (cblksty & 1) {
    s.maxpasses = first ? 10 : (cb.segs[index - 1].maxpasses == 1 || cb.segs[index - 1].maxpasses == 10) ? 2 : 1;
  } else {
    s.maxpasses = 109;
  }
}

inline int floorlog2(uint32_t v) {
  int l = 0;
  while (v >>= 1) ++l;
  return l;
}

// One packet: its header (opj_t2_read_packet_header), then its body
// (opj_t2_read_packet_data); returns the bytes it took.
size_t read_packet(const uint8_t* src, size_t max_len, Resolution& res, int precno, int layno,
                   int csty, int cblksty) {
  const uint8_t* cur = src;
  size_t remaining = max_len;
  if (csty & 2) {  // SOP
    if (max_len >= 6 && cur[0] == 0xFF && cur[1] == 0x91) cur += 6;
  }
  Bio bio(cur, remaining);
  const uint8_t* hdr = cur;
  auto eph = [&]() {  // an EPH marker OpenJPEG 2.5.3 expects and does not find refuses
    if (!(csty & 4)) return;
    if (remaining - (size_t)(hdr - cur) < 2 || hdr[0] != 0xFF || hdr[1] != 0x92) {
      refuse("an EPH marker is missing (cv2 returns None)");
    }
    hdr += 2;
  };
  if (!bio.read(1)) {
    bio.inalign();
    hdr += bio.numbytes();
    eph();
    return (size_t)(hdr - src);
  }
  for (Band& band : res.bands) {
    if (band.empty()) continue;
    Precinct& prc = band.precincts[(size_t)precno];
    const int n = prc.cw * prc.ch;
    for (int cbno = 0; cbno < n; ++cbno) {
      CodeBlock& cb = prc.cblks[(size_t)cbno];
      uint32_t included;
      if (!cb.numsegs) {
        included = (uint32_t)prc.incl.decode(bio, cbno, layno + 1);
      } else {
        included = bio.read(1);
      }
      if (!included) {
        cb.numnewpasses = 0;
        continue;
      }
      if (!cb.numsegs) {
        int i = 0;
        while (!prc.imsb.decode(bio, cbno, i)) ++i;
        cb.numbps = (uint32_t)(band.numbps + 1 - i);
        cb.numlenbits = 3;
      }
      // number of passes (opj_t2_getnumpasses), then Lblock's increment
      uint32_t np;
      if (!bio.read(1)) {
        np = 1;
      } else if (!bio.read(1)) {
        np = 2;
      } else {
        uint32_t v = bio.read(2);
        if (v != 3) {
          np = 3 + v;
        } else if ((v = bio.read(5)) != 31) {
          np = 6 + v;
        } else {
          np = 37 + bio.read(7);
        }
      }
      cb.numnewpasses = np;
      uint32_t inc = 0;
      while (bio.read(1)) ++inc;
      cb.numlenbits += inc;
      uint32_t segno = 0;
      if (!cb.numsegs) {
        init_seg(cb, 0, cblksty, true);
      } else {
        segno = cb.numsegs - 1;
        if (cb.segs[segno].numpasses == cb.segs[segno].maxpasses) {
          ++segno;
          init_seg(cb, segno, cblksty, false);
        }
      }
      int32_t left = (int32_t)np;
      do {
        Segment& s = cb.segs[segno];
        s.numnewpasses = (uint32_t)std::min<int64_t>((int64_t)s.maxpasses - s.numpasses, left);
        const uint32_t bits = cb.numlenbits + (uint32_t)floorlog2(s.numnewpasses);
        if (bits > 32) refuse("invalid code-block length bits in a packet header");
        s.newlen = bio.read((int)bits);
        left -= (int32_t)s.numnewpasses;
        if (left > 0) {
          ++segno;
          init_seg(cb, segno, cblksty, false);
        }
      } while (left > 0);
    }
  }
  bio.inalign();
  hdr += bio.numbytes();
  eph();
  // the body
  const size_t header = (size_t)(hdr - src);
  const uint8_t* body = hdr;
  const size_t body_max = max_len - std::min(max_len, header);
  const uint8_t* d = body;
  for (Band& band : res.bands) {
    if (band.empty()) continue;
    Precinct& prc = band.precincts[(size_t)precno];
    for (CodeBlock& cb : prc.cblks) {
      if (!cb.numnewpasses) continue;
      Segment* s;
      if (!cb.numsegs) {
        s = &cb.segs[0];
        ++cb.numsegs;
      } else {
        s = &cb.segs[cb.numsegs - 1];
        if (s->numpasses == s->maxpasses) {
          ++s;
          ++cb.numsegs;
        }
      }
      do {
        if ((size_t)(d - body) + s->newlen > body_max) {
          refuse("a code-block segment runs past the tile data (cv2 returns None for a cut file)");
        }
        cb.data.insert(cb.data.end(), d, d + s->newlen);
        d += s->newlen;
        s->len += s->newlen;
        s->numpasses += s->numnewpasses;
        cb.numnewpasses -= s->numnewpasses;
        if (cb.numnewpasses > 0) {
          ++s;
          ++cb.numsegs;
        }
      } while (cb.numnewpasses > 0);
    }
  }
  return header + (size_t)(d - body);
}

void Codestream::decode_tile(int tileno, std::vector<std::vector<int32_t>>& image) {
  Tcp& tcp = tcps.at((uint32_t)tileno);
  tcp.decoded = true;
  if (image.empty()) {  // the image's planes, once a tile has data to decode
    image.assign(comps.size(), std::vector<int32_t>((size_t)((x1 - x0) * (y1 - y0)), 0));
  }
  const int p = tileno % tw, q = tileno / tw;
  const int64_t tx0_ = std::max(this->tx0 + p * tdx, x0), ty0_ = std::max(this->ty0 + q * tdy, y0);
  const int64_t tx1_ = std::min(this->tx0 + (p + 1) * tdx, x1), ty1_ = std::min(this->ty0 + (q + 1) * tdy, y1);
  const int nc = (int)comps.size();
  std::vector<TileComp> tcs((size_t)nc);
  std::vector<PiComp> pcs((size_t)nc);
  for (int c = 0; c < nc; ++c) {
    const Comp& comp = comps[(size_t)c];
    const Tccp& tccp = tcp.tccps[(size_t)c];
    TileComp& tc = tcs[(size_t)c];
    tc.x0 = ceildiv(tx0_, comp.dx);
    tc.y0 = ceildiv(ty0_, comp.dy);
    tc.x1 = ceildiv(tx1_, comp.dx);
    tc.y1 = ceildiv(ty1_, comp.dy);
    const int numres = tccp.numres;
    tc.res.resize((size_t)numres);
    for (int r = 0; r < numres; ++r) {
      Resolution& res = tc.res[(size_t)r];
      const int levelno = numres - 1 - r;
      res.x0 = ceildivpow2(tc.x0, levelno);
      res.y0 = ceildivpow2(tc.y0, levelno);
      res.x1 = ceildivpow2(tc.x1, levelno);
      res.y1 = ceildivpow2(tc.y1, levelno);
      res.pdx = tccp.prcw[r];
      res.pdy = tccp.prch[r];
      const int64_t prx0 = floordivpow2(res.x0, res.pdx) << res.pdx;
      const int64_t pry0 = floordivpow2(res.y0, res.pdy) << res.pdy;
      const int64_t prx1 = ceildivpow2(res.x1, res.pdx) << res.pdx;
      const int64_t pry1 = ceildivpow2(res.y1, res.pdy) << res.pdy;
      res.pw = res.x0 == res.x1 ? 0 : (int)((prx1 - prx0) >> res.pdx);
      res.ph = res.y0 == res.y1 ? 0 : (int)((pry1 - pry0) >> res.pdy);
      if ((int64_t)res.pw * res.ph > (1 << 24)) refuse("too many precincts");
      int64_t cbgx0, cbgy0;
      int cbgwe, cbghe;
      if (r == 0) {
        cbgx0 = prx0;
        cbgy0 = pry0;
        cbgwe = res.pdx;
        cbghe = res.pdy;
      } else {
        cbgx0 = ceildivpow2(prx0, 1);
        cbgy0 = ceildivpow2(pry0, 1);
        cbgwe = res.pdx - 1;
        cbghe = res.pdy - 1;
      }
      const int cbwe = std::min(tccp.cblkw, cbgwe), cbhe = std::min(tccp.cblkh, cbghe);
      const int nbands = r == 0 ? 1 : 3;
      res.bands.resize((size_t)nbands);
      for (int b = 0; b < nbands; ++b) {
        Band& band = res.bands[(size_t)b];
        band.bandno = r == 0 ? 0 : b + 1;
        if (r == 0) {
          band.x0 = res.x0;
          band.y0 = res.y0;
          band.x1 = res.x1;
          band.y1 = res.y1;
        } else {
          const int x0b = band.bandno & 1, y0b = band.bandno >> 1;
          band.x0 = ceildivpow2(tc.x0 - ((int64_t)x0b << levelno), levelno + 1);
          band.y0 = ceildivpow2(tc.y0 - ((int64_t)y0b << levelno), levelno + 1);
          band.x1 = ceildivpow2(tc.x1 - ((int64_t)x0b << levelno), levelno + 1);
          band.y1 = ceildivpow2(tc.y1 - ((int64_t)y0b << levelno), levelno + 1);
        }
        const StepSize& ss = tccp.steps[r == 0 ? 0 : 3 * (r - 1) + b + 1];
        // tcd.c: for the decoder's 9/7 the band gain is 0 (2/K in dwt.c)
        const int log2_gain = tccp.qmfbid == 0 ? 0 : band.bandno == 0 ? 0 : band.bandno == 3 ? 2 : 1;
        const int rb = comp.prec + log2_gain;
        band.stepsize = (float)((1.0 + ss.mant / 2048.0) * std::pow(2.0, rb - ss.expn));
        band.numbps = ss.expn + tccp.numgbits - 1;
        band.precincts.resize((size_t)res.pw * res.ph);
        for (int pn = 0; pn < res.pw * res.ph; ++pn) {
          Precinct& prc = band.precincts[(size_t)pn];
          const int64_t sx = cbgx0 + (int64_t)(pn % res.pw) * ((int64_t)1 << cbgwe);
          const int64_t sy = cbgy0 + (int64_t)(pn / res.pw) * ((int64_t)1 << cbghe);
          const int64_t px0 = std::max(sx, band.x0), py0 = std::max(sy, band.y0);
          const int64_t px1 = std::min(sx + ((int64_t)1 << cbgwe), band.x1);
          const int64_t py1 = std::min(sy + ((int64_t)1 << cbghe), band.y1);
          const int64_t cx0 = floordivpow2(px0, cbwe) << cbwe, cy0 = floordivpow2(py0, cbhe) << cbhe;
          const int64_t cx1 = ceildivpow2(px1, cbwe) << cbwe, cy1 = ceildivpow2(py1, cbhe) << cbhe;
          prc.cw = (int)std::max<int64_t>((cx1 - cx0) >> cbwe, 0);
          prc.ch = (int)std::max<int64_t>((cy1 - cy0) >> cbhe, 0);
          if (band.empty()) prc.cw = prc.ch = 0;
          prc.cblks.resize((size_t)prc.cw * prc.ch);
          for (int k = 0; k < prc.cw * prc.ch; ++k) {
            CodeBlock& cb = prc.cblks[(size_t)k];
            const int64_t bx = cx0 + (int64_t)(k % prc.cw) * ((int64_t)1 << cbwe);
            const int64_t by = cy0 + (int64_t)(k / prc.cw) * ((int64_t)1 << cbhe);
            cb.x0 = (int)std::max(bx, px0);
            cb.y0 = (int)std::max(by, py0);
            cb.x1 = (int)std::min(bx + ((int64_t)1 << cbwe), px1);
            cb.y1 = (int)std::min(by + ((int64_t)1 << cbhe), py1);
          }
          prc.incl.init(prc.cw, prc.ch);
          prc.imsb.init(prc.cw, prc.ch);
        }
      }
    }
    pcs[(size_t)c] = PiComp{comp.dx, comp.dy, numres, &tc.res};
  }
  // tier 2 over the tile's data
  const uint8_t* src = tcp.data.data();
  size_t left = tcp.data.size();
  for_each_packet(tcp.prg, tcp.numlayers, pcs, tx0_, ty0_, tx1_, ty1_,
                  [&](int l, int r, int c, int pn) {
                    const Tccp& tccp = tcp.tccps[(size_t)c];
                    const size_t n = read_packet(src, left, tcs[(size_t)c].res[(size_t)r], pn, l,
                                                 tcp.csty, tccp.cblksty);
                    src += n;
                    left -= n;
                    tcs[(size_t)c].resno_decoded = std::max(tcs[(size_t)c].resno_decoded, r);
                  });
  // tier 1, dequantisation, the inverse DWT
  for (int c = 0; c < nc; ++c) {
    TileComp& tc = tcs[(size_t)c];
    const Tccp& tccp = tcp.tccps[(size_t)c];
    if (tc.resno_decoded != (int)tc.res.size() - 1) {
      refuse("a component whose last resolution has no packet is not supported");
    }
    const int64_t W = tc.w(), H = tc.h();
    if (tccp.qmfbid == 1) {
      tc.idata.assign((size_t)(W * H), 0);
    } else {
      tc.fdata.assign((size_t)(W * H), 0.0f);
    }
    for (size_t r = 0; r < tc.res.size(); ++r) {
      Resolution& res = tc.res[r];
      for (Band& band : res.bands) {
        if (band.empty()) continue;
        for (Precinct& prc : band.precincts) {
          for (CodeBlock& cb : prc.cblks) {
            const int cw = cb.x1 - cb.x0, ch = cb.y1 - cb.y0;
            if (cw <= 0 || ch <= 0) continue;
            T1 t1(*luts, cw, ch, band.bandno, tccp.cblksty);
            const std::vector<int32_t>& v = t1.decode(cb, tccp.cblksty);
            int64_t x = cb.x0 - band.x0, y = cb.y0 - band.y0;
            if (band.bandno & 1) x += tc.res[r - 1].x1 - tc.res[r - 1].x0;
            if (band.bandno & 2) y += tc.res[r - 1].y1 - tc.res[r - 1].y0;
            if (tccp.qmfbid == 1) {
              for (int j = 0; j < ch; ++j) {
                for (int i = 0; i < cw; ++i) {
                  tc.idata[(size_t)((y + j) * W + x + i)] = v[(size_t)j * cw + i] / 2;
                }
              }
            } else {
              const float half = 0.5f * band.stepsize;
              for (int j = 0; j < ch; ++j) {
                for (int i = 0; i < cw; ++i) {
                  tc.fdata[(size_t)((y + j) * W + x + i)] = (float)v[(size_t)j * cw + i] * half;
                }
              }
            }
          }
        }
      }
    }
    if (tccp.qmfbid == 1) {
      idwt_2d(tc, tc.idata, idwt53_1d);
    } else {
      idwt_2d(tc, tc.fdata, idwt97_1d);
    }
  }
  // the multiple component transform
  if (tcp.mct == 1 && nc >= 3) {
    for (int c = 1; c < 3; ++c) {
      if (tcs[(size_t)c].res.size() != tcs[0].res.size() ||
          tcs[(size_t)c].w() * tcs[(size_t)c].h() != tcs[0].w() * tcs[0].h()) {
        refuse("a component transform over components of different sizes (OpenJPEG refuses it)");
      }
    }
    const size_t n = (size_t)(tcs[0].w() * tcs[0].h());
    if (tcp.tccps[0].qmfbid == 1) {
      if (tcs[1].idata.size() != n || tcs[2].idata.size() != n) {
        refuse("a reversible component transform over irreversible components");
      }
      int32_t *c0 = tcs[0].idata.data(), *c1 = tcs[1].idata.data(), *c2 = tcs[2].idata.data();
      for (size_t i = 0; i < n; ++i) {
        const int32_t y = c0[i], u = c1[i], v = c2[i];
        const int32_t g = y - ((u + v) >> 2);
        c0[i] = v + g;
        c1[i] = g;
        c2[i] = u + g;
      }
    } else {
      if (tcs[1].fdata.size() != n || tcs[2].fdata.size() != n) {
        refuse("an irreversible component transform over reversible components");
      }
      float *c0 = tcs[0].fdata.data(), *c1 = tcs[1].fdata.data(), *c2 = tcs[2].fdata.data();
      for (size_t i = 0; i < n; ++i) {
        const float y = c0[i], u = c1[i], v = c2[i];
        c0[i] = y + v * 1.402f;
        c1[i] = y - u * 0.34413f - v * 0.71414f;
        c2[i] = y + u * 1.772f;
      }
    }
  }
  // the DC level shift and the clamp, into the image
  for (int c = 0; c < nc; ++c) {
    const Comp& comp = comps[(size_t)c];
    TileComp& tc = tcs[(size_t)c];
    const int32_t lo = comp.sgnd ? -(1 << (comp.prec - 1)) : 0;
    const int32_t hi = comp.sgnd ? (1 << (comp.prec - 1)) - 1 : (int32_t)((1u << comp.prec) - 1);
    const int64_t shift = comp.dc_shift;
    const int64_t ix0 = ceildiv(x0, comp.dx), iy0 = ceildiv(y0, comp.dy);
    const int64_t iw = ceildiv(x1, comp.dx) - ix0;
    std::vector<int32_t>& dst = image[(size_t)c];
    const int64_t W = tc.w();
    for (int64_t y = 0; y < tc.h(); ++y) {
      int32_t* row = &dst[(size_t)((tc.y0 + y - iy0) * iw + (tc.x0 - ix0))];
      if (tcp.tccps[(size_t)c].qmfbid == 1) {
        const int32_t* s = &tc.idata[(size_t)(y * W)];
        for (int64_t x = 0; x < W; ++x) {
          row[x] = (int32_t)std::min<int64_t>(std::max<int64_t>((int64_t)s[x] + shift, lo), hi);
        }
      } else {
        const float* s = &tc.fdata[(size_t)(y * W)];
        for (int64_t x = 0; x < W; ++x) {
          const float v = s[x];
          if (v > (float)INT32_MAX) {
            row[x] = hi;
          } else if (v < (float)INT32_MIN) {
            row[x] = lo;
          } else {
            const int64_t iv = (int64_t)std::lrintf(v) + shift;
            row[x] = (int32_t)std::min<int64_t>(std::max<int64_t>(iv, lo), hi);
          }
        }
      }
    }
  }
  tcp.data.clear();
  tcp.data.shrink_to_fit();
  any_tile = true;
}

// ------------------------------------------------------------------ JP2

struct Jp2Color {
  uint32_t ihdr_w = 0, ihdr_h = 0;
  uint32_t enumcs = 0;
  bool has_colr = false;
  // pclr
  bool has_pclr = false;
  int nr_entries = 0, nr_channels = 0;
  std::vector<int> channel_size, channel_sign;
  std::vector<uint32_t> entries;
  bool has_cmap = false;
  struct Cmap {
    int cmp, mtyp, pcol;
  };
  std::vector<Cmap> cmap;
  // cdef
  bool has_cdef = false;
  struct Cdef {
    int cn, typ, asoc;
  };
  std::vector<Cdef> cdef;
};

// One box of those jp2h holds (opj_jp2_img_find_handler's): ihdr, colr,
// pclr, cmap, cdef; others are skipped.
void jp2h_box(uint32_t type, const uint8_t* b, size_t bn, Jp2Color& col, bool& has_ihdr) {
  switch (type) {
    case 0x69686472:  // ihdr
      if (bn != 14) refuse("JP2: bad ihdr box");
      if (be16(b + 8) == 0 || be16(b + 8) > 16384) refuse("JP2: bad number of components in ihdr");
      if (!has_ihdr) {
        col.ihdr_h = be32(b);
        col.ihdr_w = be32(b + 4);
      }
      has_ihdr = true;
      break;
    case 0x636F6C72:  // colr
      if (bn < 3) refuse("JP2: bad colr box");
      if (col.has_colr) break;  // only the first counts
      if (b[0] == 1) {
        if (bn < 7) refuse("JP2: bad colr box");
        col.enumcs = be32(b + 3);
        col.has_colr = true;
      } else if (b[0] == 2) {
        col.enumcs = 0;  // an ICC profile: colour space unknown
        col.has_colr = true;
      }
      break;
    case 0x70636C72: {  // pclr
      if (col.has_pclr) refuse("JP2: a second pclr box");
      if (bn < 3) refuse("JP2: bad pclr box");
      col.nr_entries = (int)be16(b);
      if (col.nr_entries == 0 || col.nr_entries > 1024) refuse("JP2: bad pclr entries");
      col.nr_channels = b[2];
      if (col.nr_channels == 0) refuse("JP2: a pclr box with no columns");
      if (bn < 3 + (size_t)col.nr_channels) refuse("JP2: bad pclr box");
      size_t at = 3;
      for (int i = 0; i < col.nr_channels; ++i) {
        col.channel_size.push_back((b[at] & 0x7F) + 1);
        col.channel_sign.push_back(b[at] >> 7);
        ++at;
      }
      for (int j = 0; j < col.nr_entries; ++j) {
        for (int i = 0; i < col.nr_channels; ++i) {
          const size_t nb = std::min<size_t>((size_t)(col.channel_size[(size_t)i] + 7) >> 3, 4);
          if (bn < at + nb) refuse("JP2: bad pclr box");
          uint32_t v = 0;
          for (size_t k = 0; k < nb; ++k) v = v << 8 | b[at + k];
          col.entries.push_back(v);
          at += nb;
        }
      }
      col.has_pclr = true;
      break;
    }
    case 0x636D6170:  // cmap
      if (!col.has_pclr) refuse("JP2: a cmap box before pclr");
      if (col.has_cmap) refuse("JP2: a second cmap box");
      if (bn < (size_t)col.nr_channels * 4) refuse("JP2: bad cmap box");
      for (int i = 0; i < col.nr_channels; ++i) {
        col.cmap.push_back({(int)be16(b + 4 * i), b[4 * i + 2], b[4 * i + 3]});
      }
      col.has_cmap = true;
      break;
    case 0x63646566: {  // cdef
      if (col.has_cdef) refuse("JP2: a second cdef box");
      if (bn < 2) refuse("JP2: bad cdef box");
      const int nn = (int)be16(b);
      if (nn == 0) refuse("JP2: a cdef box with no channels");
      if (bn < 2 + (size_t)nn * 6) refuse("JP2: bad cdef box");
      for (int i = 0; i < nn; ++i) {
        const uint8_t* e = b + 2 + 6 * i;
        col.cdef.push_back({(int)be16(e), (int)be16(e + 2), (int)be16(e + 4)});
      }
      col.has_cdef = true;
      break;
    }
    default: break;
  }
}

void read_jp2h(const uint8_t* p, size_t n, Jp2Color& col, bool& has_ihdr) {
  while (n > 0) {
    if (n < 8) refuse("JP2: a truncated box in jp2h");
    uint64_t len = be32(p);
    const uint32_t type = be32(p + 4);
    size_t hdr = 8;
    if (len == 1) {
      if (n < 16) refuse("JP2: a truncated box in jp2h");
      len = (uint64_t)be32(p + 8) << 32 | be32(p + 12);
      hdr = 16;
    }
    if (len == 0) refuse("JP2: a box of undefined size in jp2h");
    if (len < hdr || len > n) refuse("JP2: bad box length in jp2h");
      jp2h_box(type, p + hdr, (size_t)len - hdr, col, has_ihdr);
    p += len;
    n -= (size_t)len;
  }
}

// opj_jp2_read_header_procedure: the boxes up to jp2c; returns the
// codestream's offset.
size_t read_jp2_boxes(const uint8_t* data, size_t size, Jp2Color& col) {
  size_t at = 0;
  int seen = 0;  // 1 signature, 2 file type, 4 header
  bool has_ihdr = false;
  for (;;) {
    if (size - at < 8) refuse("JP2: no codestream box");
    uint64_t len = be32(data + at);
    const uint32_t type = be32(data + at + 4);
    size_t hdr = 8;
    if (len == 1) {
      if (size - at < 16) refuse("JP2: no codestream box");
      len = (uint64_t)be32(data + at + 8) << 32 | be32(data + at + 12);
      hdr = 16;
    }
    if (type == 0x6A703263) {  // jp2c
      if (!(seen & 4)) refuse("JP2: a codestream before the jp2h box");
      return at + hdr;
    }
    if (len == 0) refuse("JP2: a box of undefined size");
    if (len < hdr) refuse("JP2: bad box length");
    const size_t bn = (size_t)std::min<uint64_t>(len - hdr, (uint64_t)-1);
    const uint8_t* b = data + at + hdr;
    const bool known = type == 0x6A502020 || type == 0x66747970 || type == 0x6A703268;
    if (known || type == 0x69686472 || type == 0x636F6C72 || type == 0x70636C72 ||
        type == 0x636D6170 || type == 0x63646566) {
      if (!known) {  // a jp2h box outside jp2h: read once jp2h is in, else skipped
        if (!(seen & 4)) {
          if (bn > size - at - hdr) refuse("JP2: a box runs past the end of the data");
          at += hdr + bn;
          continue;
        }
      }
      if (bn > size - at - hdr) refuse("JP2: a box runs past the end of the data");
      switch (type) {
        case 0x6A502020:  // jP
          if (seen != 0) refuse("JP2: the signature box must come first");
          if (bn != 4 || be32(b) != 0x0D0A870A) refuse("JP2: bad signature box");
          seen |= 1;
          break;
        case 0x66747970:  // ftyp
          if (seen != 1) refuse("JP2: the file type box must come second");
          if (bn < 8 || (bn - 8) % 4) refuse("JP2: bad file type box");
          seen |= 2;
          break;
        case 0x6A703268:  // jp2h
          if (!(seen & 2)) refuse("JP2: the header box before the file type box");
          if (seen & 4) break;  // a second jp2h is ignored
          read_jp2h(b, bn, col, has_ihdr);
          if (!has_ihdr) refuse("JP2: no ihdr box in jp2h");
          seen |= 4;
          break;
        default:  // a jp2h sub-box after jp2h
          jp2h_box(type, b, bn, col, has_ihdr);
          break;
      }
    } else {
      if (!(seen & 1)) refuse("JP2: the first box must be the signature box");
      if (!(seen & 2)) refuse("JP2: the second box must be the file type box");
      if (bn > size - at - hdr) refuse("JP2: a box runs past the end of the data");
    }
    at += hdr + bn;
  }
}

// opj_jp2_check_color, then opj_jp2_apply_pclr and opj_jp2_apply_cdef on
// the decoded components.
void apply_jp2_color(Jp2Color& col, std::vector<std::vector<int32_t>>& comps) {
  const int numcomps = (int)comps.size();
  if (col.has_cdef) {
    int nr = numcomps;
    if (col.has_pclr && col.has_cmap) nr = col.nr_channels;
    for (auto& d : col.cdef) {
      if (d.cn >= nr) refuse("JP2: cdef names a channel that does not exist");
      if (d.asoc == 65535) continue;
      if (d.asoc > 0 && d.asoc - 1 >= nr) refuse("JP2: cdef names a channel that does not exist");
    }
    for (int c = nr - 1; c >= 0; --c) {
      bool found = false;
      for (auto& d : col.cdef) found |= d.cn == c;
      if (!found) refuse("JP2: incomplete channel definitions in cdef");
    }
  }
  if (col.has_pclr && col.has_cmap) {
    const int nr = col.nr_channels;
    bool sane = true;
    for (auto& m : col.cmap) {
      if (m.cmp >= numcomps) sane = false;
    }
    std::vector<bool> used((size_t)nr, false);
    for (int i = 0; i < nr; ++i) {
      const auto& m = col.cmap[(size_t)i];
      if (m.mtyp != 0 && m.mtyp != 1) {
        sane = false;
      } else if (m.pcol >= nr) {
        sane = false;
      } else if (used[(size_t)m.pcol] && m.mtyp == 1) {
        sane = false;
      } else if (m.mtyp == 0 && m.pcol != 0) {
        sane = false;
      } else if (m.mtyp == 1 && m.pcol != i) {
        sane = false;
      } else {
        used[(size_t)m.pcol] = true;
      }
    }
    for (int i = 0; i < nr; ++i) {
      if (!used[(size_t)i] && col.cmap[(size_t)i].mtyp != 0) sane = false;
    }
    if (sane && numcomps == 1) {
      bool all = true;
      for (int i = 0; i < nr; ++i) all = all && used[(size_t)i];
      if (!all) {
        for (int i = 0; i < nr; ++i) col.cmap[(size_t)i] = {col.cmap[(size_t)i].cmp, 1, i};
      }
    }
    if (!sane) refuse("JP2: the cmap box does not fit the palette and the components");
  }
  if (col.has_pclr && col.has_cmap) {
    const int nr = col.nr_channels;
    std::vector<std::vector<int32_t>> out((size_t)nr);
    const int top = col.nr_entries - 1;
    for (int i = 0; i < nr; ++i) {
      const auto& m = col.cmap[(size_t)i];
      const std::vector<int32_t>& src = comps[(size_t)m.cmp];
      std::vector<int32_t>& dst = out[(size_t)(m.mtyp == 0 ? i : m.pcol)];
      dst.resize(src.size());
      if (m.mtyp == 0) {
        dst = src;
      } else {
        for (size_t j = 0; j < src.size(); ++j) {
          const int k = std::min(std::max(src[j], 0), top);
          dst[j] = (int32_t)col.entries[(size_t)k * nr + m.pcol];
        }
      }
    }
    comps.swap(out);
  }
  if (col.has_cdef) {
    auto& info = col.cdef;
    const int n = (int)info.size();
    for (int i = 0; i < n; ++i) {
      const int asoc = info[(size_t)i].asoc, cn = info[(size_t)i].cn;
      if (cn >= (int)comps.size()) continue;
      if (asoc == 0 || asoc == 65535) continue;
      const int acn = asoc - 1;
      if (acn >= (int)comps.size()) continue;
      if (cn != acn && info[(size_t)i].typ == 0) {
        std::swap(comps[(size_t)cn], comps[(size_t)acn]);
        for (int j = i + 1; j < n; ++j) {
          if (info[(size_t)j].cn == cn) {
            info[(size_t)j].cn = acn;
          } else if (info[(size_t)j].cn == acn) {
            info[(size_t)j].cn = cn;
          }
        }
      }
    }
  }
}

}  // namespace

namespace cris {

Image decode_jp2(const uint8_t* data, size_t size, bool gray) {
  static const Luts luts;
  Jp2Color col;
  const bool jp2 = size >= 12 && std::memcmp(data, "\0\0\0\x0CjP  \r\n\x87\n", 12) == 0;
  size_t cs_at = 0;
  int colour = 0;  // 0 sRGB / unspecified, 1 greyscale, 2 sYCC
  if (jp2) {
    cs_at = read_jp2_boxes(data, size, col);
    switch (col.enumcs) {
      case 17: colour = 1; break;
      case 18: colour = 2; break;
      case 12: refuse("CMYK colour is not supported (cv2 refuses it too)");
      case 24: refuse("e-sYCC colour is not supported (cv2 refuses it too)");
      default: colour = 0;
    }
  }
  Codestream cs;
  cs.at = data + cs_at;
  cs.end = data + size;
  cs.luts = &luts;
  cs.read_main_header();
  if (jp2 && col.ihdr_w > 0 && col.ihdr_h > 0 &&
      (col.ihdr_w != cs.x1 - cs.x0 || col.ihdr_h != cs.y1 - cs.y0)) {
    refuse("the ihdr box's size differs from the codestream's (OpenJPEG refuses it)");
  }
  // (OpenCV's checks on the header were made as SIZ was read)
  int max_prec = 0;
  for (const Comp& c : cs.comps) max_prec = std::max(max_prec, c.prec);
  const int64_t w = cs.x1, h = cs.y1;
  std::vector<std::vector<int32_t>> comps;
  cs.read_tiles(comps);
  if (jp2) apply_jp2_color(col, comps);
  const int in = (int)comps.size();
  for (auto& c : comps) {
    if (c.size() != (size_t)(w * h)) refuse("a palette channel of another size");
  }
  const int shift = std::max(max_prec - 8, 0);
  // OpenCV's copy: (uchar)(v >> shift), the low byte (only a palette's
  // wider entries can exceed 8 bits after the shift)
  auto px = [&](int c, size_t i) -> int { return (uint8_t)(comps[(size_t)c][i] >> shift); };
  Image img;
  img.height = (int)h;
  img.width = (int)w;
  const size_t n = (size_t)(w * h);
  if (gray) {
    img.channels = 1;
    img.pixels.resize(n);
    if (colour == 0 && in >= 3) {
      if (in > 4) refuse("more than 4 channels (cv2 refuses it too)");
      for (size_t i = 0; i < n; ++i) img.pixels[i] = gray15(px(2, i), px(1, i), px(0, i));
    } else {
      for (size_t i = 0; i < n; ++i) img.pixels[i] = (uint8_t)px(0, i);
    }
    return img;
  }
  img.channels = 3;
  img.pixels.resize(n * 3);
  uint8_t* o = img.pixels.data();
  if (colour == 1) {
    for (size_t i = 0; i < n; ++i, o += 3) o[0] = o[1] = o[2] = (uint8_t)px(0, i);
  } else if (colour == 2) {
    if (in < 3) refuse("sYCC with fewer than 3 channels (cv2 refuses it too)");
    // cvtColor(COLOR_YUV2BGR): 14-bit weights, rounded shifts
    for (size_t i = 0; i < n; ++i, o += 3) {
      const int y = px(0, i), u = px(1, i) - 128, v = px(2, i) - 128;
      const int b = y + ((u * 33292 + (1 << 13)) >> 14);
      const int g = y + ((u * -6472 + v * -9519 + (1 << 13)) >> 14);
      const int r = y + ((v * 18678 + (1 << 13)) >> 14);
      o[0] = (uint8_t)std::min(std::max(b, 0), 255);
      o[1] = (uint8_t)std::min(std::max(g, 0), 255);
      o[2] = (uint8_t)std::min(std::max(r, 0), 255);
    }
  } else {
    if (in != 3 && in != 4) {
      refuse("RGB conversion of " + std::to_string(in) + " channels (cv2 refuses it too)");
    }
    for (size_t i = 0; i < n; ++i, o += 3) {
      o[0] = (uint8_t)px(2, i);
      o[1] = (uint8_t)px(1, i);
      o[2] = (uint8_t)px(0, i);
    }
  }
  return img;
}

}  // namespace cris
