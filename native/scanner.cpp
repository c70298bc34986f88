// Native Mobiclip frame scanner + planner.
//
// C++ twin of the host-side entropy scan (models/oracle_video.py parse path)
// and plan assembly (models/plan.py): parses one frame packet into the flat
// FramePlan arrays the JAX engine consumes — MC leaves, inter residual
// blocks, dependency-leveled intra ops, and the first-write sequence maps.
// Bit-for-bit identical plans to the Python planner (tests/test_native.py);
// ~20x faster, which keeps a batched device fed from a handful of host cores.
//
// Semantics are the reference decoder's (file:line cites are to
// /root/reference/LibMobiclip/Codec/Mobiclip/MobiclipDecoder.cs); table data
// arrives as a packed blob from mobiclipdecoder_tpu/tables (see
// utils/native.py for the layout).

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <vector>

namespace {

struct Tables {
  std::vector<int32_t> coef_a[2], coef_b[2];
  std::vector<int32_t> scan8, scan4;
  std::vector<int32_t> qscale8, qscale4, qp_div6, qp_mod6;
  std::vector<int32_t> cbp_intra, cbp_inter, cbp_split8, cbp_sub4;
  // per block-size (16 kinds) per profile (0 = moflex, 1 = mods)
  int32_t pb_peek[16][2];
  std::vector<int32_t> pb_mode[16][2], pb_bits[16][2];
};

static const int kChunk = 256;  // op-chunk rows (ops/vmem_engine.py CHUNK)

// block-size order shared with utils/native.py
static const int kSizes[16][2] = {
    {16, 16}, {8, 16}, {4, 16}, {2, 16}, {16, 8}, {16, 4}, {16, 2}, {8, 8},
    {8, 4},   {8, 2},  {4, 8},  {4, 4},  {4, 2},  {2, 8},  {2, 4},  {2, 2}};

int size_index(int w, int h) {
  for (int i = 0; i < 16; i++)
    if (kSizes[i][0] == w && kSizes[i][1] == h) return i;
  return -1;
}

struct PlanSink {
  // caller-provided output buffers
  int32_t *mc;        int mc_cap,    mc_n = 0;     // (cap, 7)
  int32_t *resid;     int resid_cap, resid_n = 0;  // (cap, 4)
  int32_t *resid_coef;                             // (cap, 64)
  int32_t *intra;     int intra_cap, intra_n = 0;  // (cap, 11)
  int32_t *intra_coef;                             // (cap, 64)
  int32_t *seq_y;     // (H/4, S/4)
  int32_t *seq_uv;    // (H/8, S/4)
  std::vector<int32_t> lvl_y, lvl_uv;
  int n_levels = 0;
  int seq = 0;  // running op sequence
  // unified decode-order op stream (executor engine, models/plan.py
  // pack_unified): rows of {w0 bitfields, row|col<<16, dx|dy / grad, coef
  // idx}; coefficient rows in ucoef (64 each) with sizes in usize.
  int32_t *uops = nullptr;  int uops_cap = 0,  uops_n = 0;   // (cap, 4)
  int32_t *ucoef = nullptr; int32_t *usize = nullptr;
  int ucoef_cap = 0, ucoef_n = 0;
  bool unified_only = false;  // skip FramePlan arrays + level bookkeeping
  bool overflow = false;      // output-capacity overflow (retryable split)
  bool bad = false;           // malformed bitstream (reference throws)

  // GOP packed-chunk emission (scanner_scan_gop): ops go straight into the
  // fused-GOP upload layout of ops/vmem_engine.py — 3-word packed rows
  // (_pack_ops3) in (nct, kChunk, 3) chunks with [count, frame, first,
  // last] header rows, chunk-local coefficient row indices, coefficients
  // as ascending sparse (flat idx, int16 value) pairs plus a size==4
  // bitmask.  This skips the Python-side _pack_gop_chunks /
  // _pack_gop_blob_sparse entirely (the round-2 host Amdahl wall).
  int32_t *g_ops3 = nullptr; int g_nct_cap = 0, g_nct = 0;
  int g_row = 0, g_crow = 0, g_first = 0, g_frame = 0;
  int32_t *g_idx = nullptr; int16_t *g_val = nullptr;
  int g_nnz_cap = 0, g_nnz = 0;
  uint32_t *g_szbits = nullptr;
  bool g_val_overflow = false;      // some |coef| > int16 (val entry clipped)

  // quad-merge peephole (mirrors models/plan.py pack_unified emit_resid):
  // consecutive 4x4 residuals of one 8x8 fold into a single size-8-region
  // row whose coefficient row holds the sub-blocks at quadrant slots 16*b.
  int q_pid = -1, q_y8 = -1, q_x8 = -1, q_b = -1;
  bool q_in_fz = false;  // open quad row lives in fz_rows[fz_n-1]

  // MC+residual fusion (mirrors models/plan.py pack_unified try_fuse):
  // an unsplit 16x16 inter MB's MC op absorbs its <=6 residual rows
  // (w0 bits 3..8 = cbp mask, w3 = first row).  The MC's emission is
  // DEFERRED until its residual section ends so the GOP packer can place
  // the op and all its rows in one chunk atomically — the offline
  // executable spec is _frame_chunk_spans in ops/vmem_engine.py.
  bool fz_active = false;
  int32_t fz_w0 = 0, fz_w2 = 0, fz_rr = 0, fz_cc = 0;
  int fz_y = 0, fz_x = 0, fz_last = -1, fz_n = 0;
  int32_t fz_rows[6][64];
  int fz_sizes[6];

  // residual-batch peephole (mirrors plan.py pack_unified pend): 8x8-region
  // residual rows that could NOT ride an MC op (split-MB residuals, intra
  // pass-through) accumulate per MB into ONE masked-16x16 op (luma,
  // size_log 4, mask in w0 bits 5..8) / ONE U+V pair op (chroma, size_log
  // 5, mask bits 5..6); a single region flushes as the plain 8x8 form.
  bool pd_active = false;
  bool q_in_pd = false;  // open quad row lives in pd_rows[pd_n-1]
  int pd_pid = 0, pd_my = 0, pd_mx = 0, pd_mask = 0, pd_last = -1, pd_n = 0;
  int32_t pd_rows[4][64];
  int pd_sizes[4];

  // intra-batch peepholes (mirror plan.py pack_unified emit_intra):
  // consecutive directional luma intra ops of one parent 8x8/16x16 fold
  // into a quad-batch op (size_log 5/6: mode nibbles @5..20, 0xF absent,
  // has bits @21..24); a chroma U+V intra pair folds into one pair op
  // (size_log 7: mode@5..9, has_u@10, has_v@11).  Plane modes (2/12),
  // pass-throughs and any other op break a batch.
  bool ib_active = false;
  int ib_size = 8, ib_by = 0, ib_bx = 0, ib_lastq = -1, ib_n = 0;
  int ib_q[4], ib_mode[4], ib_has[4];
  int32_t ib_rows[4][64];
  int ib_sizes[4];
  int ib_nrows = 0;
  bool iv_active = false;  // held U-half candidate of a chroma pair
  int iv_y = 0, iv_x = 0, iv_mode = 0, iv_has = 0;
  int32_t iv_rows[2][64];
  int iv_sizes[2];

  // split-MB leaf deferral (mirrors plan.py pack_unified leaves): a
  // split MB's leaf MC ops buffer until its luma residual section
  // resolves so residual quads can ATTACH to the covering leaf (same
  // mask/rows encoding as the 16x16 MC fusion).  Attached rows copy
  // into lv_rows (the pd buffer is reused by the chroma pend).
  int lv_n = 0, lv_rowtotal = 0;
  int lv_mb_y = -1, lv_mb_x = -1;
  int32_t lv_w0[64], lv_rr[64], lv_cc[64], lv_w2v[64];
  int lv_y[64], lv_x[64], lv_w[64], lv_h[64];
  int lv_rowstart[64], lv_nrows[64];
  int32_t lv_rows[4][64];
  int lv_sizes[4];
};

struct Scanner {
  Tables t;
  int width, height, stride, version;  // version: 1 = ModsDS, 2 = Moflex3DS
  uint32_t quantizer = 0;
  uint32_t yuv_format = 0;
  uint32_t internal[392];  // packed dequant entries + table select + MV cache
  uint8_t imode[40];

  // bitstream state
  const uint8_t *data; int len; int offset;
  uint32_t r3; int nb;

  PlanSink *sink = nullptr;

  // decoder-persistent state snapshot (per-frame rollback when a GOP scan
  // hits an output-capacity limit mid-frame; the caller re-scans the frame
  // into fresh buffers, so cross-frame state must rewind exactly)
  struct State {
    uint32_t quantizer, yuv_format;
    uint32_t internal[392];
    uint8_t imode[40];
  };
  void save(State &st) const {
    st.quantizer = quantizer;
    st.yuv_format = yuv_format;
    memcpy(st.internal, internal, sizeof(internal));
    memcpy(st.imode, imode, sizeof(imode));
  }
  void restore(const State &st) {
    quantizer = st.quantizer;
    yuv_format = st.yuv_format;
    memcpy(internal, st.internal, sizeof(internal));
    memcpy(imode, st.imode, sizeof(imode));
  }
  State ckpt;  // caller-visible checkpoint (scanner_checkpoint/rollback)
  bool has_ckpt = false;

  // ---------------------------------------------------------------- bits
  void fill() {  // FillBits (:2988)
    if (offset >= len) return;
    // odd tail: C# ReadU16LE throws reading data[offset+1] — mirror the
    // oracle's IndexError by flagging the stream malformed
    if (offset + 1 >= len) {
      offset = len;
      if (sink) sink->bad = true;
      return;
    }
    uint32_t w = data[offset] | (data[offset + 1] << 8);
    offset += 2;
    nb += 16;
    r3 |= w << ((16 - nb) & 31);
  }
  void adv(int n) { r3 <<= n; nb -= n; if (nb < 0) fill(); }
  uint32_t bit() { uint32_t b = r3 >> 31; adv(1); return b; }
  static int clz(uint32_t v) {
    int n = 32; while (v) { v >>= 1; n--; } return n;
  }
  uint32_t varint_u() {  // ReadVarIntUnsigned (:2970)
    int n = clz(r3);
    uint32_t v = r3 << (n & 31);
    v <<= 1;
    int sh = 32 - n;
    uint32_t val = (sh == 32) ? 0 : (v >> sh);
    val += (uint32_t(1) << (n & 31)) - 1;
    r3 = v << (n & 31);
    nb -= 2 * n + 1;
    if (nb < 0) fill();
    return val;
  }
  int32_t varint_s() {  // ReadVarIntSigned (:2998)
    // wrapping 32-bit int arithmetic exactly as the C# (a degenerate
    // 31-zero prefix overflows `r6 += 1 << r10` there; see the oracle)
    int n = clz(r3);
    uint32_t v = r3 << (n & 31);
    v <<= 1;
    int sh = 32 - n;
    uint32_t base = (sh == 32) ? 0 : (v >> sh);
    int32_t val = int32_t(base + (uint32_t(1) << (n & 31)));
    if (val & 1) val = int32_t(uint32_t(1) - uint32_t(val));
    val >>= 1;
    r3 = v << (n & 31);
    nb -= 2 * n + 1;
    if (nb < 0) fill();
    return val;
  }

  // ----------------------------------------------------------- quantizer
  void setup_quant(uint32_t q) {  // SetupQuantizationTables (:3884)
    if (version == 2) { if (q < 0xC) q = 0xC; if (q > 0x34) q = 0x34; }
    quantizer = q;
    if (q >= 54) { sink->bad = true; q = 53; }
    int sh4 = t.qp_div6[q] + 8;
    int mod = t.qp_mod6[q];
    for (int i = 0; i < 16; i++)
      internal[74 + i] = uint32_t(t.scan4[i]) |
                         (uint32_t(t.qscale4[mod * 16 + i]) << sh4);
    int sh8 = sh4 - 2;
    for (int i = 0; i < 64; i++)
      internal[10 + i] = uint32_t(t.scan8[i]) |
                         (uint32_t(t.qscale8[mod * 64 + i]) << sh8);
    static const int borders[8] = {1, 2, 3, 4, 8, 0x10, 0x18, 0x20};
    for (int b : borders) imode[b] = 9;
  }

  // -------------------------------------------------------- plan helpers
  void mark(int32_t *map, int cols, int y, int x, int h, int w) {
    for (int r = y / 4; r < (y + h + 3) / 4; r++)
      for (int c = x / 4; c < (x + w + 3) / 4; c++)
        if (map[r * cols + c] < 0) map[r * cols + c] = sink->seq;
  }
  void set_level(std::vector<int32_t> &map, int cols, int y, int x, int h,
                 int w, int level) {
    for (int r = y / 4; r < (y + h + 3) / 4; r++)
      for (int c = x / 4; c < (x + w + 3) / 4; c++)
        map[r * cols + c] = level;
  }

  // --------------------------------------------- unified-stream emission
  // Mirrors models/plan.py pack_unified exactly (margins MR=MCOL=8).
  static int size_log(int size) {
    return size == 2 ? 1 : size == 4 ? 2 : size == 8 ? 3 : 4;
  }
  void u_row(int32_t w0, int32_t w1, int32_t w2, int32_t w3) {
    if (sink->g_ops3) {
      (void)w3;  // row-less ops: emit_op_rows with n=0 (one close path)
      emit_op_rows(w0, w1 & 0xFFFF, w1 >> 16, w2, nullptr, nullptr, 0);
      return;
    }
    if (sink->uops_n >= sink->uops_cap) { sink->overflow = true; return; }
    int32_t *r = sink->uops + 4 * (sink->uops_n++);
    r[0] = w0; r[1] = w1; r[2] = w2; r[3] = w3;
  }

  // ---------------------------------------- GOP packed-chunk emission
  // 3-word packed row layout (= ops/vmem_engine.py _pack_ops3 with the
  // chunk-local w3 < 256): A = w0; B = rr | cc<<12 | w3<<24; C = w2.
  // Bounds hold structurally here: w0 uses bits 0..25 (type/ref/w/h or
  // mode bits), rr = 8+y(+H) < 4096 and cc = 8+x < 4096 for every stride
  // policy (<=1024+margins), and header rows are [count<2^26, frame<4096,
  // first, last<256].
  void g_open_chunk(int first) {
    PlanSink *k = sink;
    if (k->g_nct >= k->g_nct_cap) { k->overflow = true; return; }
    memset(k->g_ops3 + size_t(k->g_nct) * kChunk * 3, 0, kChunk * 3 * 4);
    memset(k->g_szbits + size_t(k->g_nct) * (kChunk / 32), 0,
           (kChunk / 32) * 4);
    k->g_first = first;
    k->g_row = 1;
    k->g_crow = 0;
    k->g_nct++;
  }
  void g_close_chunk(int last) {
    PlanSink *k = sink;
    int32_t *c = k->g_ops3 + size_t(k->g_nct - 1) * kChunk * 3;
    c[0] = k->g_row - 1;                 // A: w0 = count (w3 = last < 256)
    c[1] = int32_t(uint32_t(k->g_frame) | (uint32_t(last) << 24));  // B: rr = frame, cc = 0
    c[2] = k->g_first;                   // C: w2 = first flag
  }
  // shared emission of one op row + its n deferred coefficient rows
  // (atomic per chunk: 1 op row + n coef rows never split; offline spec =
  // _frame_chunk_spans) — used by both the MC fusion and residual-batch
  // peepholes
  void emit_op_rows(int32_t w0, int32_t rr, int32_t cc, int32_t w2,
                    int32_t rows[][64], const int *sz, int n) {
    PlanSink *k = sink;
    if (k->g_ops3) {
      if (k->g_row == kChunk || k->g_crow + n > kChunk) {
        g_close_chunk(0);
        g_open_chunk(0);
        if (k->overflow) return;
      }
      int32_t w3 = n ? k->g_crow : 0;
      for (int r = 0; r < n; r++) {
        int row = (k->g_nct - 1) * kChunk + k->g_crow;
        int32_t base = row * 64;
        for (int p = 0; p < 64; p++) {
          int32_t v = rows[r][p];
          if (!v) continue;
          if (k->g_nnz >= k->g_nnz_cap) { k->overflow = true; return; }
          if (v < -32768 || v > 32767) k->g_val_overflow = true;
          k->g_idx[k->g_nnz] = base + p;
          k->g_val[k->g_nnz] = int16_t(v);
          k->g_nnz++;
        }
        if (sz[r] == 4)
          k->g_szbits[row >> 5] |= uint32_t(1) << (row & 31);
        k->g_crow++;
      }
      int32_t *r = k->g_ops3
          + (size_t(k->g_nct - 1) * kChunk + size_t(k->g_row)) * 3;
      r[0] = w0;
      r[1] = int32_t(uint32_t(rr) | (uint32_t(cc) << 12)
                     | (uint32_t(w3) << 24));
      r[2] = w2;
      k->g_row++;
    } else {
      int32_t w3 = 0;
      for (int r = 0; r < n; r++) {
        if (k->ucoef_n >= k->ucoef_cap) { k->overflow = true; return; }
        int idx = k->ucoef_n++;
        if (r == 0) w3 = idx;
        memcpy(k->ucoef + 64 * idx, rows[r], 64 * 4);
        k->usize[idx] = sz[r];
      }
      if (k->uops_n >= k->uops_cap) { k->overflow = true; return; }
      int32_t *r = k->uops + 4 * (k->uops_n++);
      r[0] = w0; r[1] = rr | (cc << 16); r[2] = w2; r[3] = w3;
    }
  }
  void fz_flush() {
    PlanSink *k = sink;
    if (!k->fz_active) return;
    k->fz_active = false;
    k->q_in_fz = false;
    emit_op_rows(k->fz_w0, k->fz_rr, k->fz_cc, k->fz_w2, k->fz_rows,
                 k->fz_sizes, k->fz_n);
  }
  void lv_flush() {
    PlanSink *k = sink;
    for (int i = 0; i < k->lv_n; i++) {
      emit_op_rows(k->lv_w0[i], k->lv_rr[i], k->lv_cc[i], k->lv_w2v[i],
                   k->lv_rows + k->lv_rowstart[i],
                   k->lv_sizes + k->lv_rowstart[i], k->lv_nrows[i]);
    }
    k->lv_n = 0;
    k->lv_rowtotal = 0;
    k->lv_mb_y = -1;
    k->lv_mb_x = -1;
  }
  bool lv_try_attach() {
    // validation first (no mutation): every luma pend quad must land in
    // a covering leaf, visiting leaves in non-decreasing order with
    // ascending leaf-relative bits — each leaf's absorbed rows are then
    // a contiguous ascending run, as the kernel's fold walk requires
    PlanSink *k = sink;
    if (!k->lv_n) return false;
    if (k->pd_my != k->lv_mb_y || k->pd_mx != k->lv_mb_x) return false;
    int hits[4], bits[4], m = 0;
    int li_last = -1, bit_last = -1;
    for (int b = 0; b < 4; b++) {
      if (!((k->pd_mask >> b) & 1)) continue;
      int ry = k->pd_my + 8 * (b >> 1);
      int rx = k->pd_mx + 8 * (b & 1);
      int hit = -1;
      for (int li = 0; li < k->lv_n; li++) {
        if (k->lv_y[li] <= ry && ry + 8 <= k->lv_y[li] + k->lv_h[li]
            && k->lv_x[li] <= rx
            && rx + 8 <= k->lv_x[li] + k->lv_w[li]) {
          hit = li;
          break;
        }
      }
      if (hit < 0) return false;
      int bit = ((ry - k->lv_y[hit]) >> 3) * 2
          + ((rx - k->lv_x[hit]) >> 3);
      if (hit < li_last) return false;
      if (hit == li_last && bit <= bit_last) return false;
      hits[m] = hit;
      bits[m] = bit;
      m++;
      li_last = hit;
      bit_last = bit;
    }
    for (int i = 0; i < m; i++) {
      int hit = hits[i];
      if (k->lv_nrows[hit] == 0) k->lv_rowstart[hit] = k->lv_rowtotal;
      memcpy(k->lv_rows[k->lv_rowtotal], k->pd_rows[i], 64 * 4);
      k->lv_sizes[k->lv_rowtotal] = k->pd_sizes[i];
      k->lv_rowtotal++;
      k->lv_w0[hit] |= 1 << (3 + bits[i]);
      k->lv_nrows[hit]++;
    }
    return true;
  }
  void pd_flush() {
    PlanSink *k = sink;
    if (!k->pd_active) return;
    k->pd_active = false;
    k->q_in_pd = false;
    if (k->pd_pid == 0 && lv_try_attach()) {
      lv_flush();
      return;
    }
    lv_flush();
    int hofs = k->pd_pid ? height : 0;
    if (k->pd_n == 1) {
      // single region: the plain 8x8 form is cheaper in-kernel
      int b = 0;
      while (!((k->pd_mask >> b) & 1)) b++;
      int ry, rx;
      if (k->pd_pid == 0) {
        ry = k->pd_my + 8 * (b >> 1);
        rx = k->pd_mx + 8 * (b & 1);
      } else {
        ry = k->pd_my;
        rx = k->pd_mx + (b ? stride / 2 : 0);
      }
      emit_op_rows(2 | (3 << 2), 8 + ry + hofs, 8 + rx, 0, k->pd_rows,
                   k->pd_sizes, 1);
      return;
    }
    int sl = k->pd_pid == 0 ? 4 : 5;
    emit_op_rows(2 | (sl << 2) | (k->pd_mask << 5), 8 + k->pd_my + hofs,
                 8 + k->pd_mx, 0, k->pd_rows, k->pd_sizes, k->pd_n);
  }
  void pd_add(int pid, int ry, int rx, const int32_t *dense, int size,
              int qoff) {
    PlanSink *k = sink;
    int my, mx, bit;
    if (pid == 0) {
      my = ry & ~15;
      mx = rx & ~15;
      bit = ((ry - my) >> 3) * 2 + ((rx - mx) >> 3);
    } else {
      my = ry;
      if (rx >= stride / 2) { mx = rx - stride / 2; bit = 1; }
      else { mx = rx; bit = 0; }
    }
    // bit > pd_last bounds pd_n to 4 (luma) / 2 (chroma) structurally;
    // deferred rows are consecutive at flush by construction, matching
    // the Python side's k == first + n check
    if (!(k->pd_active && k->pd_pid == pid && k->pd_my == my
          && k->pd_mx == mx && bit > k->pd_last)) {
      pd_flush();
      k->pd_active = true;
      k->pd_pid = pid;
      k->pd_my = my;
      k->pd_mx = mx;
      k->pd_mask = 0;
      k->pd_last = -1;
      k->pd_n = 0;
    }
    int r = k->pd_n++;
    memset(k->pd_rows[r], 0, 64 * 4);
    memcpy(k->pd_rows[r] + qoff, dense, size * size * 4);
    k->pd_sizes[r] = size;
    k->pd_mask |= 1 << bit;
    k->pd_last = bit;
  }

  bool fz_try(int pid, int ry, int rx, const int32_t *dense, int size,
              int qoff) {
    PlanSink *k = sink;
    if (!k->fz_active) return false;
    int bit;
    if (pid == 0) {
      if ((ry != k->fz_y && ry != k->fz_y + 8)
          || (rx != k->fz_x && rx != k->fz_x + 8)) {
        fz_flush();
        return false;
      }
      bit = ((ry - k->fz_y) >> 3) * 2 + ((rx - k->fz_x) >> 3);
    } else {
      if (ry != (k->fz_y >> 1)) { fz_flush(); return false; }
      if (rx == (k->fz_x >> 1)) bit = 4;
      else if (rx == (k->fz_x >> 1) + stride / 2) bit = 5;
      else { fz_flush(); return false; }
    }
    if (bit <= k->fz_last || k->fz_n >= 6) { fz_flush(); return false; }
    int r = k->fz_n++;
    memset(k->fz_rows[r], 0, 64 * 4);
    memcpy(k->fz_rows[r] + qoff, dense, size * size * 4);
    k->fz_sizes[r] = size;
    k->fz_w0 |= 1 << (3 + bit);
    k->fz_last = bit;
    return true;
  }

  void u_mc(int y, int x, int w, int h, int ref, int dx, int dy) {
    fz_flush();
    pd_flush();
    ib_flush();
    iv_flush();
    sink->q_pid = -1;
    int32_t w0 = 1 | (ref << 13) | (w << 16) | (h << 21);
    int32_t w2 = int32_t((uint32_t(dx) & 0xFFFF) | (uint32_t(dy) << 16));
    PlanSink *k = sink;
    if (w == 16 && h == 16) {
      lv_flush();
      k->fz_active = true;
      k->fz_w0 = w0;
      k->fz_rr = 8 + y;
      k->fz_cc = 8 + x;
      k->fz_w2 = w2;
      k->fz_y = y;
      k->fz_x = x;
      k->fz_last = -1;
      k->fz_n = 0;
      return;
    }
    // split leaf: defer for residual attachment (plan.py leaves mirror)
    int my = y & ~15, mx = x & ~15;
    if (my != k->lv_mb_y || mx != k->lv_mb_x) {
      lv_flush();
      k->lv_mb_y = my;
      k->lv_mb_x = mx;
    }
    int i = k->lv_n++;
    k->lv_w0[i] = w0;
    k->lv_rr[i] = 8 + y;
    k->lv_cc[i] = 8 + x;
    k->lv_w2v[i] = w2;
    k->lv_y[i] = y;
    k->lv_x[i] = x;
    k->lv_w[i] = w;
    k->lv_h[i] = h;
    k->lv_rowstart[i] = 0;
    k->lv_nrows[i] = 0;
  }

  void u_resid(int pid, int y, int x, int size, const int32_t *dense) {
    PlanSink *s2 = sink;
    // a residual (incl. 9/19 pass-through) between intra ops breaks the
    // intra batches; the quad-merge continuation below can never target
    // a batch row (intra arrival resets q_pid), so flushing first is safe
    ib_flush();
    iv_flush();
    if (size == 4) {
      int b = ((y >> 2) & 1) * 2 + ((x >> 2) & 1);
      if (s2->q_pid == pid && s2->q_y8 == (y >> 3)
          && s2->q_x8 == (x >> 3) && b > s2->q_b) {
        s2->q_b = b;  // fold into the open quad row (fz or pend deferred)
        if (s2->q_in_fz) {
          memcpy(s2->fz_rows[s2->fz_n - 1] + 16 * b, dense, 16 * 4);
        } else {
          memcpy(s2->pd_rows[s2->pd_n - 1] + 16 * b, dense, 16 * 4);
        }
        return;
      }
      s2->q_pid = pid; s2->q_y8 = y >> 3; s2->q_x8 = x >> 3; s2->q_b = b;
      if (fz_try(pid, y & ~7, x & ~7, dense, 4, 16 * b)) {
        s2->q_in_fz = true;
        return;
      }
      s2->q_in_fz = false;
      pd_add(pid, y & ~7, x & ~7, dense, 4, 16 * b);
      s2->q_in_pd = true;
      return;
    }
    s2->q_pid = -1;
    // size is 8 here (record_resid emits 4 or 8; 4 returned above)
    if (fz_try(pid, y, x, dense, 8, 0)) return;
    pd_add(pid, y, x, dense, 8, 0);
  }
  void plain_intra(int pid, int y, int x, int size, int mode, int grad,
                   int has, int32_t rows[][64], const int *sz) {
    int S = stride;
    int half = (pid == 1 && x >= S / 2) ? S / 2 : 0;
    int avl = (x - half) != 0;
    int avt = y != 0;
    emit_op_rows(3 | (size_log(size) << 2) | (mode << 5) | (has << 10)
                     | (avt << 11) | (avl << 12),
                 8 + y + (pid ? height : 0), 8 + x, grad,
                 rows, sz, has ? 1 : 0);
  }
  void ib_flush() {
    PlanSink *k = sink;
    if (!k->ib_active) return;
    k->ib_active = false;
    int size = k->ib_size;
    if (k->ib_n == 1) {
      int q = k->ib_q[0];
      int y = k->ib_by + size * (q >> 1), x = k->ib_bx + size * (q & 1);
      plain_intra(0, y, x, size, k->ib_mode[0], 0, k->ib_has[0],
                  k->ib_rows, k->ib_sizes);
      return;
    }
    int off = size == 4 ? 10 : 0;
    int32_t w0 = 3 | ((size == 4 ? 5 : 6) << 2);
    int hasbits = 0;
    for (int q = 0; q < 4; q++) w0 |= 0xF << (5 + 4 * q);
    for (int i = 0; i < k->ib_n; i++) {
      int q = k->ib_q[i];
      w0 &= ~(0xF << (5 + 4 * q));
      w0 |= (k->ib_mode[i] - off) << (5 + 4 * q);
      if (k->ib_has[i]) hasbits |= 1 << q;
    }
    w0 |= hasbits << 21;
    int32_t w2 = (k->ib_by != 0 ? 1 : 0) | (k->ib_bx != 0 ? 2 : 0);
    emit_op_rows(w0, 8 + k->ib_by, 8 + k->ib_bx, w2, k->ib_rows,
                 k->ib_sizes, k->ib_nrows);
  }
  void iv_flush() {
    PlanSink *k = sink;
    if (!k->iv_active) return;
    k->iv_active = false;
    plain_intra(1, k->iv_y, k->iv_x, 8, k->iv_mode, 0, k->iv_has,
                k->iv_rows, k->iv_sizes);
  }
  void u_intra(int pid, int y, int x, int size, int mode, int grad,
               int has, const int32_t *dense) {
    fz_flush();
    if (mode == 9 || mode == 19) {
      if (has) u_resid(pid, y, x, size, dense);
      return;
    }
    pd_flush();
    lv_flush();
    sink->q_pid = -1;
    PlanSink *k = sink;
    if (pid == 0 && (size == 4 || size == 8) && mode != 2 && mode != 12) {
      int by = y & ~(2 * size - 1), bx = x & ~(2 * size - 1);
      int q = ((y - by) / size) * 2 + ((x - bx) / size);
      if (!(k->ib_active && k->ib_size == size && k->ib_by == by
            && k->ib_bx == bx && q > k->ib_lastq)) {
        ib_flush();
        iv_flush();
        k->ib_active = true;
        k->ib_size = size;
        k->ib_by = by;
        k->ib_bx = bx;
        k->ib_lastq = -1;
        k->ib_n = 0;
        k->ib_nrows = 0;
      }
      int i = k->ib_n++;
      k->ib_q[i] = q;
      k->ib_mode[i] = mode;
      k->ib_has[i] = has;
      k->ib_lastq = q;
      if (has) {
        int r = k->ib_nrows++;
        memset(k->ib_rows[r], 0, 64 * 4);
        memcpy(k->ib_rows[r], dense, size * size * 4);
        k->ib_sizes[r] = size;
      }
      return;
    }
    if (pid == 1 && size == 8 && mode != 2) {
      if (k->iv_active && y == k->iv_y && x == k->iv_x + stride / 2
          && mode == k->iv_mode) {
        // complete U+V pair -> one op
        k->iv_active = false;
        int n = 0;
        if (k->iv_has) n = 1;
        if (has) {
          memset(k->iv_rows[n], 0, 64 * 4);
          memcpy(k->iv_rows[n], dense, size * size * 4);
          k->iv_sizes[n] = size;
          n++;
        }
        emit_op_rows(3 | (7 << 2) | (mode << 5) | (k->iv_has << 10)
                         | (has << 11),
                     8 + height + y, 8 + k->iv_x, 0, k->iv_rows,
                     k->iv_sizes, n);
        return;
      }
      iv_flush();
      ib_flush();
      if (x < stride / 2) {
        k->iv_active = true;
        k->iv_y = y;
        k->iv_x = x;
        k->iv_mode = mode;
        k->iv_has = has;
        if (has) {
          memset(k->iv_rows[0], 0, 64 * 4);
          memcpy(k->iv_rows[0], dense, size * size * 4);
          k->iv_sizes[0] = size;
        }
        return;
      }
      // V-half single (no held U): plain emission below
    }
    ib_flush();
    iv_flush();
    int32_t one_row[1][64];
    int one_sz[1];
    if (has) {
      memset(one_row[0], 0, 64 * 4);
      memcpy(one_row[0], dense, size * size * 4);
      one_sz[0] = size;
    }
    plain_intra(pid, y, x, size, mode, grad, has, one_row, one_sz);
  }

  void record_mc(int w, int h, int ref, int dx, int dy, int off) {
    int S = stride;
    int y = off / S, x = off % S;
    if (sink->uops || sink->g_ops3) {
      u_mc(y, x, w, h, ref, dx, dy);
      if (sink->unified_only) { sink->seq++; return; }
    }
    if (sink->mc_n < sink->mc_cap) {
      int32_t *r = sink->mc + sink->mc_n * 7;
      r[0] = y; r[1] = x; r[2] = w; r[3] = h; r[4] = ref; r[5] = dx; r[6] = dy;
      sink->mc_n++;
    } else sink->overflow = true;
    int cols = S / 4;
    mark(sink->seq_y, cols, y, x, h, w);
    int cy = y / 2, cxu = x / 2;
    int cw = w / 2 ? w / 2 : 1, ch = h / 2 ? h / 2 : 1;
    mark(sink->seq_uv, cols, cy, cxu, ch, cw);
    mark(sink->seq_uv, cols, cy, cxu + S / 2, ch, cw);
    sink->seq++;
  }

  void record_resid(int pid, int off, int size, const int32_t *dense) {
    int S = stride;
    int y = off / S, x = off % S;
    if (sink->uops || sink->g_ops3) {
      u_resid(pid, y, x, size, dense);
      if (sink->unified_only) { sink->seq++; return; }
    }
    if (sink->resid_n < sink->resid_cap) {
      int32_t *r = sink->resid + sink->resid_n * 4;
      r[0] = pid; r[1] = y; r[2] = x; r[3] = size;
      int32_t *c = sink->resid_coef + sink->resid_n * 64;
      memset(c, 0, 64 * 4);
      memcpy(c, dense, size * size * 4);
      sink->resid_n++;
    } else sink->overflow = true;
    int cols = S / 4;
    mark(pid ? sink->seq_uv : sink->seq_y, cols, y, x, size, size);
    sink->seq++;
  }

  void record_intra(int pid, int off, int size, int mode, int grad,
                    int has_coef, const int32_t *dense) {
    int S = stride, cols = S / 4;
    int y = off / S, x = off % S;
    if (sink->uops || sink->g_ops3) {
      u_intra(pid, y, x, size, mode, grad, has_coef, dense);
      if (sink->unified_only) { sink->seq++; return; }
    }
    int32_t *smap = pid ? sink->seq_uv : sink->seq_y;
    std::vector<int32_t> &lmap = pid ? sink->lvl_uv : sink->lvl_y;
    int ph = pid ? height / 2 : height;
    int half = (pid == 1 && x >= S / 2) ? S / 2 : 0;
    int avail_l = (x - half) != 0;
    int avail_t = y != 0;
    // dependency level over the conservative tap-cell superset
    int level = 1;
    auto consider = [&](int r, int c) {
      if (r < 0 || c < 0 || r * cols + c >= int(lmap.size())) return;
      int32_t s = smap[r * cols + c];
      if (s >= 0 && s < sink->seq) {
        int lv = lmap[r * cols + c] + 1;
        if (lv > level) level = lv;
      }
    };
    if (y > 0) {
      int x0 = x - 4 > 0 ? x - 4 : 0;
      int x1 = x + 2 * size < S ? x + 2 * size : S;
      for (int c = x0 / 4; c < (x1 + 3) / 4; c++) consider((y - 1) / 4, c);
    }
    if (x > 0) {
      int y1 = y + size < ph ? y + size : ph;
      for (int r = y / 4; r < (y1 + 3) / 4; r++) consider(r, (x - 1) / 4);
    }
    if (mode == 9 || mode == 19) {
      for (int r = y / 4; r < (y + size + 3) / 4; r++)
        for (int c = x / 4; c < (x + size + 3) / 4; c++) consider(r, c);
    }
    if (sink->intra_n < sink->intra_cap) {
      int32_t *r = sink->intra + sink->intra_n * 11;
      r[0] = pid; r[1] = y; r[2] = x; r[3] = size; r[4] = mode; r[5] = grad;
      r[6] = has_coef; r[7] = avail_t; r[8] = avail_l; r[9] = level;
      r[10] = sink->seq;
      int32_t *c = sink->intra_coef + sink->intra_n * 64;
      memset(c, 0, 64 * 4);
      if (has_coef) memcpy(c, dense, size * size * 4);
      sink->intra_n++;
    } else sink->overflow = true;
    mark(smap, cols, y, x, size, size);
    set_level(lmap, cols, y, x, size, size, level);
    if (level > sink->n_levels) sink->n_levels = level;
    sink->seq++;
  }

  // ----------------------------------------------------------- residuals
  // returns last scan cursor; fills dense[n*n]
  int read_dct(int n, int32_t *dense) {  // ReadDCTMatrix (:3330)
    // The reference decodes INTO Internal[90+pos] (:3424-3429) with pos up
    // to 255 — out-of-block positions land in the IDCT workspace, the
    // table-select byte [218] and the MV cache, and a large skip can walk
    // r12 into [90..] and read back freshly written coefficient words.
    // Mirror that exactly (the Python oracle does): coefficients live in
    // internal[90..], dense[] is extracted afterwards.
    memset(dense, 0, n * n * 4);  // stays zero on the bad-stream early-out
    for (int i = 0; i < n * n; i++) internal[90 + i] = 0;
    // table select is == 1 exactly (MobiclipDecoder.cs:3332-3333): the
    // cell can be corrupted to arbitrary values by out-of-range
    // coefficient writes, and only the literal value 1 selects table 1
    const int tsel = (internal[218] == 1) ? 1 : 0;
    const std::vector<int32_t> &ta = t.coef_a[tsel];
    const std::vector<int32_t> &tb = t.coef_b[tsel];
    int r12 = (n == 8) ? 10 : 74;
    while (true) {
      int end = 0, skip = 0;
      int32_t value = 0;
      if ((r3 >> 25) == 3) {
        r3 <<= 7;
        uint32_t c1 = r3 >> 31;
        r3 <<= 1;
        if (!c1) {
          nb -= 8; if (nb < 0) fill();
          int e = ta[r3 >> 20];
          int nbits = e & 0xF;
          value = ((e >> 4) & 0x1F) + tb[(e >> 9)];
          end = (e >> 15) & 1;
          skip = (e >> 10) & 0x3F;
          r3 <<= (nbits - 1);
          if (r3 >> 31) value = -value;
          r3 <<= 1;
          nb -= nbits; if (nb < 0) fill();
        } else {
          uint32_t c2 = r3 >> 31;
          r3 <<= 1;
          if (!c2) {
            nb -= 9; if (nb < 0) fill();
            int e = ta[r3 >> 20];
            int nbits = e & 0xF;
            value = (e >> 4) & 0x1F;
            int run = (e >> 10) & 0x3F;
            end = (e >> 15) & 1;
            skip = run + tb[0x80 + value + (end << 6)];
            r3 <<= (nbits - 1);
            if (r3 >> 31) value = -value;
            r3 <<= 1;
            nb -= nbits; if (nb < 0) fill();
          } else {
            nb -= 9; if (nb < 0) fill();
            end = r3 >> 31;
            r3 <<= 1;
            skip = r3 >> 26;
            r3 <<= 6;
            nb -= 7; if (nb < 0) fill();
            value = int32_t(r3) >> 20;
            r3 <<= 12;
            nb -= 12; if (nb < 0) fill();
          }
        }
      } else {
        int e = ta[r3 >> 20];
        int nbits = e & 0xF;
        value = (e >> 4) & 0x1F;
        end = (e >> 15) & 1;
        skip = (e >> 10) & 0x3F;
        r3 <<= (nbits - 1);
        if (r3 >> 31) value = -value;
        r3 <<= 1;
        nb -= nbits; if (nb < 0) fill();
      }
      r12 += skip;
      if (r12 < 0 || r12 >= 392) { sink->bad = true; return r12; }
      uint32_t packed = internal[r12++];
      int pos = packed & 0xFF;
      int32_t scale = int32_t(packed >> 8);
      internal[90 + pos] = uint32_t(int64_t(scale) * value);
      if (end) break;
    }
    for (int i = 0; i < n * n; i++) dense[i] = int32_t(internal[90 + i]);
    return r12;
  }

  // ------------------------------------------------------------ intra MBs
  int predicted_mode(int r5, uint32_t peek4, int *consumed) {
    int pred = imode[r5 - 8];
    int left = imode[r5 - 1];
    if (pred > left) pred = left;
    if (pred == 9) pred = 3;
    int v = int(peek4);
    if (v >= pred) v++;
    if (v < 9) { *consumed = 4; return v; }
    *consumed = 1;
    return pred;
  }

  int gradient_for(int mode) {
    if (mode == 2 || mode == 12) return varint_s();
    return 0;
  }
  bool has_gradient(int mode) { return mode == 2 || mode == 12; }

  void intra8_predicted_mode(int r5, int pid, int off) {  // loc_116220
    int consumed;
    int mode = predicted_mode(r5, r3 >> 28, &consumed);
    imode[r5] = imode[r5 + 1] = imode[r5 + 8] = imode[r5 + 9] = mode;
    adv(consumed);
    int g = gradient_for(mode);
    record_intra(pid, off, 8, mode, g, 0, nullptr);
  }

  void intra_sub8(int r5, int pid, int off) {  // loc_116368 (:2776)
    int S = stride;
    int32_t dense[64];
    if (r3 >> 31) {
      r3 <<= 1; nb -= 1;  // no refill check, per reference
      int consumed;
      int mode = predicted_mode(r5, r3 >> 28, &consumed);
      adv(consumed);
      imode[r5] = imode[r5 + 1] = imode[r5 + 8] = imode[r5 + 9] = mode;
      int g = gradient_for(mode);
      read_dct(8, dense);
      record_intra(pid, off, 8, mode, g, 1, dense);
    } else {
      uint32_t ci = varint_u();
      if (ci >= t.cbp_split8.size()) { sink->bad = true; return; }
      int cbp = t.cbp_split8[ci];
      static const int dr5s[4] = {0, 1, 8, 9};
      const int doffs[4] = {0, 4, S * 4, S * 4 + 4};
      for (int b = 0; b < 4; b++) {
        int consumed;
        int mode = predicted_mode(r5 + dr5s[b], r3 >> 28, &consumed);
        imode[r5 + dr5s[b]] = mode;
        adv(consumed);
        mode += 0xA;
        int g = gradient_for(mode);
        int has = (cbp >> b) & 1;
        if (has) read_dct(4, dense);
        record_intra(pid, off + doffs[b], 4, mode, g, has,
                     has ? dense : nullptr);
      }
    }
  }

  void intra8_with_residual(int pid, int off, int mode) {  // sub_116508
    int S = stride;
    int32_t dense[64];
    if (r3 >> 31) {
      r3 <<= 1; nb -= 1;
      int g = gradient_for(mode);
      read_dct(8, dense);
      record_intra(pid, off, 8, mode, g, 1, dense);
    } else {
      int mode4 = mode + 0xA;
      uint32_t ci = varint_u();
      if (ci >= t.cbp_split8.size()) { sink->bad = true; return; }
      int cbp = t.cbp_split8[ci];
      const int doffs[4] = {0, 4, S * 4, S * 4 + 4};
      for (int b = 0; b < 4; b++) {
        int g = gradient_for(mode4);
        int has = (cbp >> b) & 1;
        if (has) read_dct(4, dense);
        record_intra(pid, off + doffs[b], 4, mode4, g, has,
                     has ? dense : nullptr);
      }
    }
  }

  void intra_chroma(int cbp, int off) {  // loc_116290 (:1864)
    int S = stride;
    uint32_t mode = r3 >> 29;
    adv(3);
    if (mode == 2) {
      mode = 9;
      record_intra(1, off / 2, 8, 2, varint_s(), 0, nullptr);
      record_intra(1, off / 2 + S / 2, 8, 2, varint_s(), 0, nullptr);
    }
    const int coffs[2] = {off / 2, off / 2 + S / 2};
    for (int i = 0; i < 2; i++) {
      if ((cbp >> (4 + i)) & 1) intra8_with_residual(1, coffs[i], mode);
      else record_intra(1, coffs[i], 8, mode, 0, 0, nullptr);
    }
  }

  void dec_intra_full_mb(int off) {  // DecIntraFullBlockPMode (:1759)
    int S = stride;
    uint32_t ci = varint_u();
    if (ci >= t.cbp_intra.size()) { sink->bad = true; return; }
    int cbp = t.cbp_intra[ci];
    uint32_t mode = r3 >> 29;
    adv(3);
    if (mode == 2) {
      mode = 9;
      record_intra(0, off, 16, 2, varint_s(), 0, nullptr);
    }
    const int doffs[4] = {0, 8, S * 8, S * 8 + 8};
    for (int b = 0; b < 4; b++) {
      if ((cbp >> b) & 1) intra8_with_residual(0, off + doffs[b], mode);
      else record_intra(0, off + doffs[b], 8, mode, 0, 0, nullptr);
    }
    intra_chroma(cbp, off);
  }

  void dec_intra_sub_mb(int off) {  // DecIntraSubBlockPMode (:1789)
    int S = stride;
    uint32_t ci = varint_u();
    if (ci >= t.cbp_intra.size()) { sink->bad = true; return; }
    int cbp = t.cbp_intra[ci];
    static const int r5s[4] = {9, 0xB, 0x19, 0x1B};
    const int doffs[4] = {0, 8, S * 8, S * 8 + 8};
    for (int b = 0; b < 4; b++) {
      if ((cbp >> b) & 1) intra_sub8(r5s[b], 0, off + doffs[b]);
      else intra8_predicted_mode(r5s[b], 0, off + doffs[b]);
    }
    intra_chroma(cbp, off);
  }

  // ------------------------------------------------------------- P blocks
  void residual8(int pid, int off) {  // loc_11652C (:2909)
    int S = stride;
    int32_t dense[64];
    if (r3 >> 31) {
      r3 <<= 1; nb -= 1;
      int last = read_dct(8, dense);
      (void)last;
      record_resid(pid, off, 8, dense);
    } else {
      uint32_t ci = varint_u();
      if (ci >= t.cbp_sub4.size()) { sink->bad = true; return; }
      int cbp = t.cbp_sub4[ci];
      const int doffs[4] = {0, 4, S * 4, S * 4 + 4};
      for (int b = 0; b < 4; b++)
        if ((cbp >> b) & 1) {
          read_dct(4, dense);
          record_resid(pid, off + doffs[b], 4, dense);
        }
    }
  }

  void residual_mb(int off) {  // loc_1161A0 (:1818)
    int S = stride;
    uint32_t ci = varint_u();
    if (ci >= t.cbp_inter.size()) { sink->bad = true; return; }
    int cbp = t.cbp_inter[ci];
    const int doffs[4] = {0, 8, S * 8, S * 8 + 8};
    for (int b = 0; b < 4; b++)
      if ((cbp >> b) & 1) residual8(0, off + doffs[b]);
    if ((cbp >> 4) & 1) residual8(1, off / 2);
    if ((cbp >> 5) & 1) residual8(1, off / 2 + S / 2);
  }

  void mc_leaf(int w, int h, int io, int ref, int dx, int dy, int off) {
    internal[io] = uint32_t(dx);
    internal[io + 1] = uint32_t(dy);
    record_mc(w, h, ref, dx, dy, off);
  }

  void read_pblock(int w, int h, int io, int off);

  void switch_pblock(int w, int h, int mode, int io, int off) {
    int S = stride;
    if (mode == 0) {
      mc_leaf(w, h, io, 1, int32_t(internal[219]), int32_t(internal[220]),
              off);
    } else if (mode >= 1 && mode <= 5) {
      int dx = varint_s() + int32_t(internal[219]);
      int dy = varint_s() + int32_t(internal[220]);
      mc_leaf(w, h, io, mode, dx, dy, off);
    } else if (mode == 6 && w == 16 && h == 16) {
      dec_intra_full_mb(off);
    } else if (mode == 7 && w == 16 && h == 16) {
      dec_intra_sub_mb(off);
    } else if (mode == 8 || mode == 9) {
      // split geometry (_PB_SPLIT in models/oracle_video.py)
      static const struct { int w, h, m, sw, sh, dmul, dpix; } kSplit[] = {
          {16, 16, 8, 16, 8, 8, 0},  {16, 16, 9, 8, 16, 0, 8},
          {8, 16, 8, 8, 8, 8, 0},    {8, 16, 9, 4, 16, 0, 4},
          {4, 16, 8, 4, 8, 8, 0},    {4, 16, 9, 2, 16, 0, 2},
          {2, 16, 8, 2, 8, 8, 0},
          {16, 8, 8, 16, 4, 4, 0},   {16, 8, 9, 8, 8, 0, 8},
          {16, 4, 8, 16, 2, 2, 0},   {16, 4, 9, 8, 4, 0, 8},
          {16, 2, 9, 8, 2, 0, 8},
          {8, 8, 8, 8, 4, 4, 0},     {8, 8, 9, 4, 8, 0, 4},
          {8, 4, 8, 8, 2, 2, 0},     {8, 4, 9, 4, 4, 0, 4},
          {8, 2, 9, 4, 2, 0, 4},
          {4, 8, 8, 4, 4, 4, 0},     {4, 8, 9, 2, 8, 0, 2},
          {4, 4, 8, 4, 2, 2, 0},     {4, 4, 9, 2, 4, 0, 2},
          {4, 2, 9, 2, 2, 0, 2},
          {2, 8, 8, 2, 4, 4, 0},     {2, 4, 8, 2, 2, 2, 0}};
      bool ok = false;
      for (const auto &e : kSplit)
        if (e.w == w && e.h == h && e.m == mode) {
          read_pblock(e.sw, e.sh, io, off);
          read_pblock(e.sw, e.sh, io, off + e.dmul * S + e.dpix);
          ok = true;
          break;
        }
      if (!ok) { sink->bad = true; return; }
    } else {
      sink->bad = true;  // illegal mode (reference throws)
      return;
    }
    if (w == 16 && h == 16 && mode != 6 && mode != 7) residual_mb(off);
  }

  // --------------------------------------------------------------- frame
  int scan(const uint8_t *pkt, int pkt_len) {
    data = pkt; len = pkt_len; offset = 0;
    if (len < 2) return -1;
    r3 = uint32_t(data[0] | (data[1] << 8)) << 16;
    offset = 2;
    nb = 0;
    uint32_t iframe = r3 >> 31;
    r3 <<= 1;
    int S = stride;
    if (!iframe) {
      nb -= 1; if (nb < 0) fill();
      if (version == 2) {
        int32_t dq = varint_s();
        if (quantizer == 0) setup_quant(0);
        else if (dq != 0) setup_quant(uint32_t(int64_t(quantizer) + dq));
      } else {
        int32_t dq = varint_s();
        if (dq != 0) setup_quant(uint32_t(int64_t(quantizer) + dq));
      }
      internal[218] = 0;
      int io = 221;
      for (int w = width + 0x20; w > 0; w -= 16) {
        internal[io] = internal[io + 1] = 0;
        io += 2;
        if (io > 390) break;
      }
      int off = 0;
      for (int my = 0; my < height; my += 16) {
        io = 221;
        for (int mx = 0; mx < width; mx += 16) {
          int32_t v[6];
          for (int k = 0; k < 6; k++) v[k] = int32_t(internal[io + k]);
          io += 2;
          auto med3 = [](int32_t a, int32_t b, int32_t c) {
            if (a > b) { int32_t t2 = a; a = b; b = t2; }
            if (b > c) { int32_t t2 = b; b = c; c = t2; }
            if (a > b) { int32_t t2 = a; a = b; b = t2; }
            return b;
          };
          internal[219] = uint32_t(med3(v[0], v[2], v[4]));
          internal[220] = uint32_t(med3(v[1], v[3], v[5]));
          internal[io] = internal[io + 1] = 0;
          read_pblock(16, 16, io, off);
          off += 16;
        }
        off += S * 16 - width;
      }
    } else {
      yuv_format = r3 >> 31;
      r3 <<= 1;
      internal[218] = r3 >> 31;
      r3 <<= 1;
      nb -= 3; if (nb < 0) fill();
      uint32_t q = r3 >> 26;
      adv(6);
      if (quantizer != q) setup_quant(q);
      int off = 0;
      for (int my = 0; my < height; my += 16) {
        for (int mx = 0; mx < width; mx += 16) {
          uint32_t sub = bit();
          if (sub) dec_intra_sub_mb(off);
          else dec_intra_full_mb(off);
          off += 16;
        }
        off += S * 16 - width;
      }
    }
    if (sink->uops || sink->g_ops3) {
      fz_flush();
      pd_flush();
      ib_flush();
      iv_flush();
      lv_flush();
    }
    return offset;
  }
};

void Scanner::read_pblock(int w, int h, int io, int off) {
  int si = size_index(w, h);
  int prof = (version == 2) ? 0 : 1;
  int peek = t.pb_peek[si][prof];
  uint32_t idx = r3 >> (32 - peek);
  int mode = t.pb_mode[si][prof][idx];
  adv(t.pb_bits[si][prof][mode]);
  switch_pblock(w, h, mode, io, off);
}

std::vector<int32_t> read_arr(const uint8_t *&p) {
  int32_t n;
  memcpy(&n, p, 4);
  p += 4;
  std::vector<int32_t> out(n);
  memcpy(out.data(), p, n * 4);
  p += n * 4;
  return out;
}

}  // namespace

extern "C" {

void *scanner_create(int width, int height, int version,
                     const uint8_t *blob, int blob_len) {
  (void)blob_len;
  Scanner *s = new Scanner();
  s->width = width;
  s->height = height;
  s->version = version;
  s->stride = width <= 256 ? 256 : (width <= 512 ? 512 : 1024);
  memset(s->internal, 0, sizeof(s->internal));
  memset(s->imode, 0, sizeof(s->imode));
  const uint8_t *p = blob;
  Tables &t = s->t;
  t.coef_a[0] = read_arr(p); t.coef_b[0] = read_arr(p);
  t.coef_a[1] = read_arr(p); t.coef_b[1] = read_arr(p);
  t.scan8 = read_arr(p); t.scan4 = read_arr(p);
  t.qscale8 = read_arr(p); t.qscale4 = read_arr(p);
  t.qp_div6 = read_arr(p); t.qp_mod6 = read_arr(p);
  t.cbp_intra = read_arr(p); t.cbp_inter = read_arr(p);
  t.cbp_split8 = read_arr(p); t.cbp_sub4 = read_arr(p);
  for (int i = 0; i < 16; i++)
    for (int prof = 0; prof < 2; prof++) {
      std::vector<int32_t> pk = read_arr(p);
      t.pb_peek[i][prof] = pk[0];
      t.pb_mode[i][prof] = read_arr(p);
      t.pb_bits[i][prof] = read_arr(p);
    }
  return s;
}

void scanner_destroy(void *ctx) { delete static_cast<Scanner *>(ctx); }

// Returns the consumed byte offset (>= 0) or -1 on error; out_meta gets
// {mc_n, resid_n, intra_n, n_levels, overflow}.
int scanner_scan(void *ctx, const uint8_t *pkt, int pkt_len,
                 int32_t *mc, int mc_cap,
                 int32_t *resid, int32_t *resid_coef, int resid_cap,
                 int32_t *intra, int32_t *intra_coef, int intra_cap,
                 int32_t *seq_y, int32_t *seq_uv, int32_t *out_meta) {
  Scanner *s = static_cast<Scanner *>(ctx);
  PlanSink sink;
  sink.mc = mc; sink.mc_cap = mc_cap;
  sink.resid = resid; sink.resid_coef = resid_coef; sink.resid_cap = resid_cap;
  sink.intra = intra; sink.intra_coef = intra_coef; sink.intra_cap = intra_cap;
  sink.seq_y = seq_y; sink.seq_uv = seq_uv;
  int cells_y = (s->height / 4) * (s->stride / 4);
  int cells_uv = (s->height / 8) * (s->stride / 4);
  for (int i = 0; i < cells_y; i++) seq_y[i] = -1;
  for (int i = 0; i < cells_uv; i++) seq_uv[i] = -1;
  sink.lvl_y.assign(cells_y, 0);
  sink.lvl_uv.assign(cells_uv, 0);
  s->sink = &sink;
  int consumed = s->scan(pkt, pkt_len);
  out_meta[0] = sink.mc_n;
  out_meta[1] = sink.resid_n;
  out_meta[2] = sink.intra_n;
  out_meta[3] = sink.n_levels;
  out_meta[4] = (sink.overflow || sink.bad) ? 1 : 0;
  s->sink = nullptr;
  return consumed;
}

// Unified decode-order op stream for the executor engine (models/plan.py
// pack_unified layout).  out_meta gets {uops_n, ucoef_n, overflow}.
// Returns the consumed byte offset or -1 on error.
int scanner_scan_unified(void *ctx, const uint8_t *pkt, int pkt_len,
                         int32_t *uops, int uops_cap,
                         int32_t *ucoef, int32_t *usize, int ucoef_cap,
                         int32_t *out_meta) {
  Scanner *s = static_cast<Scanner *>(ctx);
  PlanSink sink;
  sink.unified_only = true;
  sink.uops = uops; sink.uops_cap = uops_cap;
  sink.ucoef = ucoef; sink.usize = usize; sink.ucoef_cap = ucoef_cap;
  s->sink = &sink;
  int consumed = s->scan(pkt, pkt_len);
  out_meta[0] = sink.uops_n;
  out_meta[1] = sink.ucoef_n;
  out_meta[2] = (sink.overflow || sink.bad) ? 1 : 0;
  s->sink = nullptr;
  return consumed;
}

// Whole-GOP packed scan for ONE stream: scans n_frames consecutive packets
// (concatenated in ``data`` at ``pkt_off`` byte offsets, n_frames+1 entries)
// and emits the fused-GOP sparse upload format of ops/vmem_engine.py
// directly — see PlanSink's GOP fields.  Per-frame outputs let the Python
// side split oversized GOPs at frame boundaries WITHOUT rescanning:
//   frame_nct[f]  chunks emitted for frame f
//   frame_nnz[f]  sparse coefficient entries emitted for frame f
//   consumed[f]   bitstream end offset of frame f (MODS audio start)
// out_meta = {nct, nnz, done_frames, err, val_overflow}.  ``err``=1 means
// frame ``done_frames`` was malformed (its partial output is discarded,
// decoder state is NOT rewound — callers resync at a keyframe, like the
// reference player's catch{}).  done_frames < n_frames with err=0 means an
// output capacity was hit; that frame's state was rewound, so the caller
// re-invokes with the remaining packets.
int scanner_scan_gop(void *ctx, const uint8_t *data, const int32_t *pkt_off,
                     int n_frames,
                     int32_t *ops3, int nct_cap,
                     int32_t *sidx, int16_t *sval, int nnz_cap,
                     uint32_t *szbits, int32_t *consumed,
                     int32_t *frame_nct, int32_t *frame_nnz,
                     int32_t *out_meta) {
  Scanner *s = static_cast<Scanner *>(ctx);
  PlanSink sink;
  sink.unified_only = true;
  sink.g_ops3 = ops3; sink.g_nct_cap = nct_cap;
  sink.g_idx = sidx; sink.g_val = sval; sink.g_nnz_cap = nnz_cap;
  sink.g_szbits = szbits;
  s->sink = &sink;
  int done = 0, err = 0;
  Scanner::State snap;
  for (int f = 0; f < n_frames; f++) {
    s->save(snap);
    int nct0 = sink.g_nct, nnz0 = sink.g_nnz;
    sink.g_frame = f;
    sink.overflow = false;
    sink.bad = false;
    sink.q_pid = -1;   // quad peephole never crosses a frame edge
    sink.fz_active = false;  // nor do the deferred-emission peepholes
    sink.pd_active = false;  // (a failed frame may leave them mid-build)
    sink.ib_active = false;
    sink.iv_active = false;
    sink.lv_n = 0;
    sink.lv_rowtotal = 0;
    sink.lv_mb_y = -1;
    sink.lv_mb_x = -1;
    s->g_open_chunk(1);
    if (sink.overflow) {       // chunk capacity already full at frame start
      sink.g_nct = nct0;
      break;
    }
    int c = s->scan(data + pkt_off[f], pkt_off[f + 1] - pkt_off[f]);
    if (c < 0 || sink.bad) {   // malformed: keep prior frames, no rewind
      sink.g_nct = nct0;
      sink.g_nnz = nnz0;
      err = 1;
      break;
    }
    if (sink.overflow) {       // capacity: rewind this frame entirely
      s->restore(snap);
      sink.g_nct = nct0;
      sink.g_nnz = nnz0;
      break;
    }
    s->g_close_chunk(1);
    consumed[f] = c;
    frame_nct[f] = sink.g_nct - nct0;
    frame_nnz[f] = sink.g_nnz - nnz0;
    done = f + 1;
  }
  out_meta[0] = sink.g_nct;
  out_meta[1] = sink.g_nnz;
  out_meta[2] = done;
  out_meta[3] = err;
  out_meta[4] = sink.g_val_overflow ? 1 : 0;
  s->sink = nullptr;
  return done;
}

// expose/restore decoder-persistent state for GOP seek parity
void scanner_get_state(void *ctx, uint32_t *quantizer) {
  *quantizer = static_cast<Scanner *>(ctx)->quantizer;
}

// Caller-visible checkpoint of the cross-frame decoder state (quantizer,
// dequant tables, MV/intra caches).  Lets the Python driver undo a whole
// scanner_scan_gop call (e.g. to fall back to a different scan path) and
// re-scan the same packets with identical semantics.
void scanner_checkpoint(void *ctx) {
  Scanner *s = static_cast<Scanner *>(ctx);
  s->save(s->ckpt);
  s->has_ckpt = true;
}

void scanner_rollback(void *ctx) {
  Scanner *s = static_cast<Scanner *>(ctx);
  if (s->has_ckpt)  // rollback before any checkpoint is a no-op, not UB
    s->restore(s->ckpt);
}

// Debug/fuzz aid: copy the 392-word internal state (dequant tables,
// table select, MV cache) out of the context.
void scanner_debug_internal(void *ctx, int32_t *out392) {
  Scanner *s = static_cast<Scanner *>(ctx);
  for (int i = 0; i < 392; i++) out392[i] = int32_t(s->internal[i]);
}

}  // extern "C"
