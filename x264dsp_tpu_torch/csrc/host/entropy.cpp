// Native host entropy stage — C++ implementation of the bit-serial layer
// (the role common/bitstream.c + encoder/cavlc.c play in the reference,
// rebuilt against this framework's device syntax tensors).
//
// Exposed via a C ABI consumed with ctypes (x264dsp_tpu/entropy/native.py).
// The Python writers in entropy/cavlc.py + encoder/core.py are the
// behavioral twins; tests require byte-identical output.
//
// VLC code tables (H.264 Tables 9-5/9-7/9-8) are injected once from
// Python (set_cavlc_tables) so there is a single source of truth.

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <cmath>

namespace {

struct BitWriter {
    uint8_t *buf;
    size_t cap;
    size_t len = 0;
    uint64_t cur = 0;
    int nbits = 0;

    void write(int n, uint32_t value) {
        if (n == 0) return;
        cur = (cur << n) | (value & ((1ull << n) - 1));
        nbits += n;
        while (nbits >= 8) {
            nbits -= 8;
            if (len < cap) buf[len++] = (cur >> nbits) & 0xFF;
        }
        cur &= (1ull << nbits) - 1;
    }
    void write_ue(uint32_t v) {
        uint32_t x = v + 1;
        int size = 32 - __builtin_clz(x);
        write(2 * size - 1, x);
    }
    void write_se(int32_t v) { write_ue(v > 0 ? 2 * v - 1 : -2 * v); }
    void rbsp_trailing() {
        write(1, 1);
        if (nbits) write(8 - nbits, 0);
    }
};

// CAVLC tables, injected from Python: (bits, size) pairs
static uint16_t g_coeff_token[5][17][4][2]; // [class][total(0=empty)][t1]
static uint16_t g_total_zeros[15][16][2];
static uint16_t g_total_zeros_dc[3][4][2];
static const uint8_t RUN_BEFORE[7][15][2] = {
    {{1,1},{0,1}},
    {{1,1},{1,2},{0,2}},
    {{3,2},{2,2},{1,2},{0,2}},
    {{3,2},{2,2},{1,2},{1,3},{0,3}},
    {{3,2},{2,2},{3,3},{2,3},{1,3},{0,3}},
    {{3,2},{0,3},{1,3},{3,3},{2,3},{5,3},{4,3}},
    {{7,3},{6,3},{5,3},{4,3},{3,3},{2,3},{1,3},
     {1,4},{1,5},{1,6},{1,7},{1,8},{1,9},{1,10},{1,11}},
};
static const int CT_INDEX[17] = {0,0,1,1,2,2,2,2,3,3,3,3,3,3,3,3,3};
static const uint8_t CBP_GOLOMB_INTRA[48] = {
    3,29,30,17,31,18,37,8,32,38,19,9,20,10,11,2,
    16,33,34,21,35,22,39,4,36,40,23,5,24,6,7,1,
    41,42,43,25,44,26,46,12,45,47,27,13,28,14,15,0};
static const uint8_t CBP_GOLOMB_INTER[48] = {
    0,2,3,7,4,8,17,13,5,18,9,14,10,15,16,11,
    1,32,33,36,34,37,44,40,35,45,38,41,39,42,43,19,
    6,24,25,20,26,21,46,28,27,47,22,29,23,30,31,12};
// block idx → 4x4 block coords, coding order
static const int BIX[16] = {0,1,0,1,2,3,2,3,0,1,0,1,2,3,2,3};
static const int BIY[16] = {0,0,1,1,0,0,1,1,2,2,3,3,2,2,3,3};
static const int8_t FIX4[13] = {-1,0,1,2,3,4,5,6,7,8,2,2,2};
static const int8_t FIX16[7] = {0,1,2,3,2,2,2};
static const int8_t FIXC[7] = {0,1,2,3,0,0,0};

static int update_suffix(int suffix_len, int abs_level) {
    if (suffix_len == 0) suffix_len = 1;
    if (abs_level > (3 << (suffix_len - 1)) && suffix_len < 6) suffix_len++;
    return suffix_len;
}

static bool write_coeff_level(BitWriter &bw, int level, int suffix_len) {
    int abs_level = level < 0 ? -level : level;
    int code = 2 * abs_level - 2 + (level < 0 ? 1 : 0);
    bool overflow = false;
    if (suffix_len == 0) {
        if (code < 14) {
            bw.write(code + 1, 1);
        } else if (code < 30) {
            bw.write(15, 1);
            bw.write(4, code - 14);
        } else {
            int lc = code - 30;
            if (lc >= (1 << 12)) { overflow = true; lc &= (1 << 12) - 1; }
            bw.write(16, 1);
            bw.write(12, lc);
        }
    } else {
        if ((code >> suffix_len) < 15) {
            bw.write((code >> suffix_len) + 1 + suffix_len,
                     (1u << suffix_len) + (code & ((1 << suffix_len) - 1)));
        } else {
            int lc = code - (15 << suffix_len);
            if (lc >= (1 << 12)) { overflow = true; lc &= (1 << 12) - 1; }
            bw.write(16, 1);
            bw.write(12, lc);
        }
    }
    return overflow;
}

// returns total_coeff
static int write_block_residual(BitWriter &bw, const int16_t *levels, int n,
                                int nC, bool chroma_dc) {
    int nz[16], nnz = 0;
    for (int i = 0; i < n; i++)
        if (levels[i]) nz[nnz++] = i;
    int table = chroma_dc ? 4 : CT_INDEX[nC > 16 ? 16 : nC];
    if (nnz == 0) {
        const uint16_t *t = g_coeff_token[table][0][0];
        bw.write(t[1], t[0]);
        return 0;
    }
    int last = nz[nnz - 1];
    int total = nnz;
    int total_zeros = last + 1 - total;

    int lev[16], runs[16];
    for (int k = 0; k < total; k++) lev[k] = levels[nz[total - 1 - k]];
    for (int k = 0; k + 1 < total; k++)
        runs[k] = nz[total - 1 - k] - nz[total - 2 - k] - 1;

    int trailing = 0;
    while (trailing < (total < 3 ? total : 3) &&
           (lev[trailing] == 1 || lev[trailing] == -1))
        trailing++;
    uint32_t sign_bits = 0;
    for (int k = 0; k < trailing; k++)
        sign_bits = (sign_bits << 1) | (lev[k] < 0 ? 1 : 0);

    const uint16_t *tok = g_coeff_token[table][total][trailing];
    bw.write(tok[1], tok[0]);
    bw.write(trailing, sign_bits);

    int suffix_len = (total > 10 && trailing < 3) ? 1 : 0;
    for (int k = trailing; k < total; k++) {
        int val = lev[k];
        if (k == trailing && trailing < 3) val -= val > 0 ? 1 : -1;
        write_coeff_level(bw, val, suffix_len);
        suffix_len = update_suffix(suffix_len, lev[k] < 0 ? -lev[k] : lev[k]);
    }

    if (chroma_dc) {
        if (total < 4) {
            const uint16_t *t = g_total_zeros_dc[total - 1][total_zeros];
            bw.write(t[1], t[0]);
        }
    } else if (total < n) {
        const uint16_t *t = g_total_zeros[total - 1][total_zeros];
        bw.write(t[1], t[0]);
    }
    int zeros_left = total_zeros;
    for (int k = 0; k + 1 < total && zeros_left > 0; k++) {
        int zl = zeros_left < 7 ? zeros_left : 7;
        const uint8_t *t = RUN_BEFORE[zl - 1][runs[k]];
        bw.write(t[1], t[0]);
        zeros_left -= runs[k];
    }
    return total;
}

struct SynI {
    // per-MB syntax arrays, all int32, row-major (mb_h, mb_w, ...)
    const int16_t *mb_type, *i16_mode, *i4_modes, *chroma_mode;
    const int16_t *cbp_luma, *cbp_chroma, *nz_luma_dc;
    const int16_t *luma_levels;       // (mb, 16, 16)
    const int16_t *luma_dc_levels;    // (mb, 16)
    const int16_t *chroma_dc_levels;  // (mb, 2, 4)
    const int16_t *chroma_ac_levels;  // (mb, 2, 4, 16)
    const int16_t *mv;                // (mb, 2) — P only
};

struct Ctx {
    int mb_w, mb_h;
    int *luma_cnt;    // (4h, 4w)
    int *chroma_cnt;  // (2, 2h, 2w)
    const SynI *s;
};

static int nc_ctx(const int *cnt, int w4, int by, int bx) {
    int na = bx > 0 ? cnt[by * w4 + bx - 1] : -1;
    int nb = by > 0 ? cnt[(by - 1) * w4 + bx] : -1;
    if (na >= 0 && nb >= 0) return (na + nb + 1) >> 1;
    if (na >= 0) return na;
    if (nb >= 0) return nb;
    return 0;
}

static int host_mpm(const Ctx &c, int by, int bx) {
    auto eff = [&](int yy, int xx) -> int {
        if (xx < 0 || yy < 0) return -1;
        int mby = yy / 4, mbx = xx / 4;
        if (c.s->mb_type[mby * c.mb_w + mbx] != 1) return 2;
        int ly = yy % 4, lx = xx % 4;
        int idx = -1;
        for (int i = 0; i < 16; i++)
            if (BIX[i] == lx && BIY[i] == ly) { idx = i; break; }
        return FIX4[c.s->i4_modes[(mby * c.mb_w + mbx) * 16 + idx] + 1];
    };
    int m = eff(by, bx - 1);
    int t = eff(by - 1, bx);
    int r = m < t ? m : t;
    return r < 0 ? 2 : r;
}

static void write_chroma_residual(BitWriter &bw, Ctx &c, int mb, int mbx,
                                  int mby, int cbp_chroma) {
    int w2 = c.mb_w * 2;
    if (cbp_chroma) {
        for (int ch = 0; ch < 2; ch++)
            write_block_residual(bw, c.s->chroma_dc_levels + (mb * 2 + ch) * 4,
                                 4, 0, true);
        if (cbp_chroma == 2) {
            for (int ch = 0; ch < 2; ch++)
                for (int i = 0; i < 4; i++) {
                    int bx = mbx * 2 + (i & 1);
                    int by = mby * 2 + (i >> 1);
                    int *cnt = c.chroma_cnt + ch * 2 * c.mb_h * w2;
                    int nC = nc_ctx(cnt, w2, by, bx);
                    int tot = write_block_residual(
                        bw, c.s->chroma_ac_levels
                            + ((mb * 2 + ch) * 4 + i) * 16 + 1, 15, nC, false);
                    cnt[by * w2 + bx] = tot;
                }
            return;
        }
    }
    for (int ch = 0; ch < 2; ch++) {
        int *cnt = c.chroma_cnt + ch * 2 * c.mb_h * w2;
        for (int dy = 0; dy < 2; dy++)
            for (int dx = 0; dx < 2; dx++)
                cnt[(mby * 2 + dy) * w2 + mbx * 2 + dx] = 0;
    }
}

static void write_mb_i(BitWriter &bw, Ctx &c, int mbx, int mby, int qp,
                       int &last_qp, int i_offset) {
    int mb = mby * c.mb_w + mbx;
    int w4 = c.mb_w * 4;
    const SynI *s = c.s;
    bool is_i4 = s->mb_type[mb] == 1;
    int cbp_luma = s->cbp_luma[mb];
    int cbp_chroma = s->cbp_chroma[mb];
    int nz_dc = s->nz_luma_dc[mb];

    if (!is_i4) {
        bw.write_ue(i_offset + 1 + FIX16[s->i16_mode[mb]] + cbp_chroma * 4
                    + (cbp_luma ? 12 : 0));
    } else {
        bw.write_ue(i_offset + 0);
        for (int i = 0; i < 16; i++) {
            int bx = mbx * 4 + BIX[i];
            int by = mby * 4 + BIY[i];
            int pred = host_mpm(c, by, bx);
            int mode = FIX4[s->i4_modes[mb * 16 + i] + 1];
            if (pred == mode) bw.write(1, 1);
            else bw.write(4, mode - (mode > pred ? 1 : 0));
        }
    }
    bw.write_ue(FIXC[s->chroma_mode[mb]]);
    if (is_i4)
        bw.write_ue(CBP_GOLOMB_INTRA[(cbp_chroma << 4) | cbp_luma]);

    if (!is_i4) {
        // empty-I16 dqp suppression (cavlc.c:156-181): chroma DC nz is
        // subsumed by cbp_chroma > 0
        bool any = cbp_luma || cbp_chroma || nz_dc;
        int dqp = any ? qp - last_qp : 0;
        if (any) last_qp = qp;
        bw.write_se(dqp);
        int nC = nc_ctx(c.luma_cnt, w4, mby * 4, mbx * 4);
        write_block_residual(bw, s->luma_dc_levels + mb * 16, 16, nC, false);
        if (cbp_luma) {
            for (int i = 0; i < 16; i++) {
                int bx = mbx * 4 + BIX[i];
                int by = mby * 4 + BIY[i];
                int nc = nc_ctx(c.luma_cnt, w4, by, bx);
                int tot = write_block_residual(
                    bw, s->luma_levels + (mb * 16 + i) * 16 + 1, 15, nc,
                    false);
                c.luma_cnt[by * w4 + bx] = tot;
            }
        } else {
            for (int i = 0; i < 16; i++)
                c.luma_cnt[(mby * 4 + BIY[i]) * w4 + mbx * 4 + BIX[i]] = 0;
        }
    } else {
        if (cbp_luma | cbp_chroma) {
            bw.write_se(qp - last_qp);
            last_qp = qp;
        }
        for (int i = 0; i < 16; i++) {
            int bx = mbx * 4 + BIX[i];
            int by = mby * 4 + BIY[i];
            if (cbp_luma & (1 << (i >> 2))) {
                int nc = nc_ctx(c.luma_cnt, w4, by, bx);
                int tot = write_block_residual(
                    bw, s->luma_levels + (mb * 16 + i) * 16, 16, nc, false);
                c.luma_cnt[by * w4 + bx] = tot;
            } else {
                c.luma_cnt[by * w4 + bx] = 0;
            }
        }
    }
    write_chroma_residual(bw, c, mb, mbx, mby, cbp_chroma);
}

// ---------------------------------------------------------------------
// Block-granularity MV prediction (common/mvpred.c:22-160 twin on a
// frame 4x4 grid; mirror of entropy/mvpred_host.py). Single-ref P,
// no intra-in-P: "ref matches" == "block decoded".
// ---------------------------------------------------------------------

// partition geometry: (rel_bx, rel_by, w4, h4) per index
static const int PART_GEOM[4][4][4] = {
    {{0, 0, 4, 4}, {0, 0, 0, 0}, {0, 0, 0, 0}, {0, 0, 0, 0}},
    {{0, 0, 4, 2}, {0, 2, 4, 2}, {0, 0, 0, 0}, {0, 0, 0, 0}},
    {{0, 0, 2, 4}, {2, 0, 2, 4}, {0, 0, 0, 0}, {0, 0, 0, 0}},
    {{0, 0, 2, 2}, {2, 0, 2, 2}, {0, 2, 2, 2}, {2, 2, 2, 2}},
};
static const int PART_N[4] = {1, 2, 2, 4};

static int part_rank(int part, int rx, int ry) {
    for (int i = 0; i < PART_N[part]; i++) {
        const int *g = PART_GEOM[part][i];
        if (rx >= g[0] && rx < g[0] + g[2] && ry >= g[1] && ry < g[1] + g[3])
            return i;
    }
    return 0;
}

struct MvGrid4 {
    int mb_w, mb_h;
    int32_t *mv;   // (4*mb_h, 4*mb_w, 2)
    int32_t *ref;  // (4*mb_h, 4*mb_w), nullable (all ref 0)

    bool decoded(int x, int y, int mbx, int mby, int part, int rank) const {
        if (x < 0 || y < 0 || x >= mb_w * 4 || y >= mb_h * 4) return false;
        int bx = x >> 2, by = y >> 2;
        if (by != mby) return by < mby;
        if (bx != mbx) return bx < mbx;
        return part_rank(part, x & 3, y & 3) < rank;
    }

    // returns exists; fills mv and ref-match for cur_ref
    bool nb(int x, int y, int mbx, int mby, int part, int rank, int cur_ref,
            int64_t m[2], bool *match) const {
        if (!decoded(x, y, mbx, mby, part, rank)) {
            m[0] = m[1] = 0;
            *match = false;
            return false;
        }
        m[0] = mv[(y * mb_w * 4 + x) * 2];
        m[1] = mv[(y * mb_w * 4 + x) * 2 + 1];
        *match = (ref ? ref[y * mb_w * 4 + x] : 0) == cur_ref;
        return true;
    }

    void set_mb(int mbx, int mby, int part, const int64_t mvs[][2],
                int r = 0) {
        for (int i = 0; i < PART_N[part]; i++) {
            const int *g = PART_GEOM[part][i];
            for (int dy = 0; dy < g[3]; dy++)
                for (int dx = 0; dx < g[2]; dx++) {
                    int x = mbx * 4 + g[0] + dx, y = mby * 4 + g[1] + dy;
                    mv[(y * mb_w * 4 + x) * 2] = (int32_t)mvs[i][0];
                    mv[(y * mb_w * 4 + x) * 2 + 1] = (int32_t)mvs[i][1];
                    if (ref) ref[y * mb_w * 4 + x] = r;
                }
        }
    }

    void predict(int mbx, int mby, int part, int idx, int cur_ref,
                 int64_t out[2]) const {
        const int *g = PART_GEOM[part][idx];
        int bx0 = mbx * 4 + g[0], by0 = mby * 4 + g[1], w4 = g[2];
        int64_t a[2], b[2], c[2];
        bool m_a, m_b, m_c;
        bool ex_a = nb(bx0 - 1, by0, mbx, mby, part, idx, cur_ref, a, &m_a);
        bool ex_b = nb(bx0, by0 - 1, mbx, mby, part, idx, cur_ref, b, &m_b);
        bool ex_c = nb(bx0 + w4, by0 - 1, mbx, mby, part, idx, cur_ref,
                       c, &m_c);
        if (!ex_c)
            ex_c = nb(bx0 - 1, by0 - 1, mbx, mby, part, idx, cur_ref,
                      c, &m_c);
        // spec shortcuts (mvpred.c:41-77)
        if (part == 1) {
            if (idx == 0 && m_b) { out[0] = b[0]; out[1] = b[1]; return; }
            if (idx == 1 && m_a) { out[0] = a[0]; out[1] = a[1]; return; }
        } else if (part == 2) {
            if (idx == 0 && m_a) { out[0] = a[0]; out[1] = a[1]; return; }
            if (idx == 1 && m_c) { out[0] = c[0]; out[1] = c[1]; return; }
        }
        int count = m_a + m_b + m_c;
        if (count == 1) {
            const int64_t *m = m_a ? a : m_b ? b : c;
            out[0] = m[0]; out[1] = m[1];
            return;
        }
        if (count == 0 && !ex_b && !ex_c && ex_a) {
            out[0] = a[0]; out[1] = a[1];
            return;
        }
        for (int k = 0; k < 2; k++) {
            int64_t x = a[k], y = b[k], z = c[k];
            int64_t mn = x < y ? x : y; mn = mn < z ? mn : z;
            int64_t mx = x > y ? x : y; mx = mx > z ? mx : z;
            out[k] = x + y + z - mn - mx;
        }
    }

    void pskip(int mbx, int mby, int64_t out[2]) const {
        int bx0 = mbx * 4, by0 = mby * 4;
        int64_t a[2], b[2];
        bool m0_a, m0_b;
        bool ex_a = nb(bx0 - 1, by0, mbx, mby, 0, 0, 0, a, &m0_a);
        bool ex_b = nb(bx0, by0 - 1, mbx, mby, 0, 0, 0, b, &m0_b);
        if (!ex_a || !ex_b || (m0_a && a[0] == 0 && a[1] == 0)
            || (m0_b && b[0] == 0 && b[1] == 0)) {
            out[0] = out[1] = 0;
            return;
        }
        predict(mbx, mby, 0, 0, 0, out);
    }
};

// load the partition MVs of one MB from the mv8 tensor (mb, 2, 2, 2)
static void load_part_mvs(const int16_t *mv8, const int16_t *mv, int mb,
                          int part, int64_t mvs[4][2]) {
    if (!mv8) {
        mvs[0][0] = mv[mb * 2];
        mvs[0][1] = mv[mb * 2 + 1];
        return;
    }
    const int16_t *q = mv8 + mb * 8;  // [qy][qx][2]
    auto Q = [&](int qy, int qx, int64_t m[2]) {
        m[0] = q[(qy * 2 + qx) * 2];
        m[1] = q[(qy * 2 + qx) * 2 + 1];
    };
    switch (part) {
        case 0: Q(0, 0, mvs[0]); break;
        case 1: Q(0, 0, mvs[0]); Q(1, 0, mvs[1]); break;
        case 2: Q(0, 0, mvs[0]); Q(0, 1, mvs[1]); break;
        default:
            Q(0, 0, mvs[0]); Q(0, 1, mvs[1]);
            Q(1, 0, mvs[2]); Q(1, 1, mvs[3]);
    }
}

static void median_mvp(const int16_t *mv, const uint8_t *avail, int mb_w,
                       int mbx, int mby, int64_t out[2]) {
    auto get = [&](int yy, int xx, int64_t m[2]) -> bool {
        if (yy < 0 || xx < 0 || xx >= mb_w) { m[0] = m[1] = 0; return false; }
        m[0] = mv[(yy * mb_w + xx) * 2];
        m[1] = mv[(yy * mb_w + xx) * 2 + 1];
        return avail[yy * mb_w + xx];
    };
    int64_t a[2], b[2], cc[2], d[2];
    bool ok_a = get(mby, mbx - 1, a);
    bool ok_b = get(mby - 1, mbx, b);
    bool ok_c = get(mby - 1, mbx + 1, cc);
    if (!ok_c) { ok_c = get(mby - 1, mbx - 1, d); cc[0] = d[0]; cc[1] = d[1]; }
    int count = ok_a + ok_b + ok_c;
    if (count == 1) {
        const int64_t *m = ok_a ? a : ok_b ? b : cc;
        out[0] = m[0]; out[1] = m[1];
        return;
    }
    if (count == 0 && ok_a && !ok_b && !ok_c) {  // mvpred.c:114-115
        out[0] = a[0]; out[1] = a[1];
        return;
    }
    for (int k = 0; k < 2; k++) {
        int64_t x = a[k], y = b[k], z = cc[k];
        int64_t mn = x < y ? x : y; mn = mn < z ? mn : z;
        int64_t mx = x > y ? x : y; mx = mx > z ? mx : z;
        out[k] = x + y + z - mn - mx;
    }
}

static void pskip_mv(const int16_t *mv, const uint8_t *avail, int mb_w,
                     int mbx, int mby, int64_t out[2]) {
    bool ok_a = mbx > 0 && avail[mby * mb_w + mbx - 1];
    bool ok_b = mby > 0 && avail[(mby - 1) * mb_w + mbx];
    bool a_zero = ok_a && mv[(mby * mb_w + mbx - 1) * 2] == 0 &&
                  mv[(mby * mb_w + mbx - 1) * 2 + 1] == 0;
    bool b_zero = ok_b && mv[((mby - 1) * mb_w + mbx) * 2] == 0 &&
                  mv[((mby - 1) * mb_w + mbx) * 2 + 1] == 0;
    if (!ok_a || !ok_b || a_zero || b_zero) { out[0] = out[1] = 0; return; }
    median_mvp(mv, avail, mb_w, mbx, mby, out);
}

// ---------------------------------------------------------------------
// CABAC engine — twin of common/cabac.c:517-631 and the Python
// entropy/cabac.py (byte-identical output is test-enforced). Probability
// tables are injected from Python (x264tpu_set_cabac_tables) so the
// generated spec constants have one source of truth.
// ---------------------------------------------------------------------

static uint8_t g_cabac_ctx[2][52][276];
static uint8_t g_range_lps[64][4];
static uint8_t g_renorm[64];
static uint8_t g_transition[128][2];

struct Cabac {
    uint8_t state[276];
    uint64_t low = 0;
    int range = 0x01FE;
    int queue = -9;      // first bit shifted away, never written
    int outstanding = 0;
    uint8_t *buf;
    size_t len = 0;
    int frame_idx;

    Cabac(bool is_i, int qp, int fidx, uint8_t *b) : buf(b), frame_idx(fidx) {
        if (qp < 0) qp = 0;
        if (qp > 51) qp = 51;
        memcpy(state, g_cabac_ctx[is_i ? 0 : 1][qp], 276);
    }
    void putbyte() {
        if (queue >= 0) {
            uint32_t out = (uint32_t)(low >> (queue + 10));
            low &= ((uint64_t)0x400 << queue) - 1;
            queue -= 8;
            if ((out & 0xFF) == 0xFF) {
                outstanding++;
            } else {
                uint32_t carry = out >> 8;
                if (carry) buf[len - 1] = (buf[len - 1] + carry) & 0xFF;
                while (outstanding > 0) {
                    buf[len++] = (carry - 1) & 0xFF;
                    outstanding--;
                }
                buf[len++] = out & 0xFF;
            }
        }
    }
    void renorm() {
        int shift = g_renorm[range >> 3];
        range <<= shift;
        low <<= shift;
        queue += shift;
        putbyte();
    }
    void decision(int ctx, int b) {
        int s = state[ctx];
        int lps = g_range_lps[s >> 1][(range >> 6) - 4];
        range -= lps;
        if (b != (s & 1)) {
            low += range;
            range = lps;
        }
        state[ctx] = g_transition[s][b];
        renorm();
    }
    void bypass(int b) {  // b is 0 or -1 (all-ones), cabac.c:576-582
        low <<= 1;
        low += (uint32_t)(b & range);
        queue += 1;
        putbyte();
    }
    void ue_bypass(int exp_bits, int val) {
        int k = exp_bits;
        while (val >= (1 << k)) {
            bypass(-1);
            val -= 1 << k;
            k++;
        }
        bypass(0);
        while (k > 0) {
            k--;
            bypass(-((val >> k) & 1));
        }
    }
    void terminal() {
        range -= 2;
        renorm();
    }
    void flush() {
        low += range - 2;
        low |= 1;
        low <<= 9;
        queue += 9;
        putbyte();
        putbyte();
        low <<= -queue;
        low |= (uint64_t)(((0x35A4E4F5u >> (frame_idx & 31)) & 1)) << 10;
        queue = 0;
        putbyte();
        while (outstanding > 0) {
            buf[len++] = 0xFF;
            outstanding--;
        }
    }
};

// residual tables (encoder/cabac.c:458-487); cat: 0 luma-DC, 1 luma-AC,
// 2 luma-4x4, 3 chroma-DC, 4 chroma-AC
static const int SIG_OFF[5] = {105, 120, 134, 149, 152};
static const int LAST_OFF[5] = {166, 181, 195, 210, 213};
static const int LEVEL_OFF[5] = {227, 237, 247, 257, 266};
static const int COUNT_M1[5] = {15, 14, 15, 3, 14};
static const int CBF_BASE_T[5] = {85, 89, 93, 97, 101};
static const int LEVEL1_CTX[8] = {1, 2, 3, 4, 0, 0, 0, 0};
static const int LEVELGT1_CTX[8] = {5, 5, 5, 5, 6, 7, 8, 9};
static const int LEVEL_TRANS[2][8] = {{1, 2, 3, 3, 4, 5, 6, 7},
                                      {4, 4, 4, 4, 5, 6, 7, 7}};

static void cabac_block_residual(Cabac &cb, int cat, const int16_t *levels,
                                 int n) {
    int last = -1;
    for (int i = 0; i < n; i++)
        if (levels[i]) last = i;
    int count_m1 = COUNT_M1[cat];
    int coeffs[16], nco = 0;
    int i = 0;
    for (;;) {
        if (levels[i]) {
            coeffs[nco++] = levels[i];
            cb.decision(SIG_OFF[cat] + i, 1);
            if (i == last) {
                cb.decision(LAST_OFF[cat] + i, 1);
                break;
            }
            cb.decision(LAST_OFF[cat] + i, 0);
        } else {
            cb.decision(SIG_OFF[cat] + i, 0);
        }
        i++;
        if (i == count_m1) {
            coeffs[nco++] = levels[i];
            break;
        }
    }
    int node_ctx = 0;
    for (int k = nco - 1; k >= 0; k--) {
        int coeff = coeffs[k];
        int abs_coeff = coeff < 0 ? -coeff : coeff;
        int ctx = LEVEL1_CTX[node_ctx] + LEVEL_OFF[cat];
        if (abs_coeff > 1) {
            cb.decision(ctx, 1);
            ctx = LEVELGT1_CTX[node_ctx] + LEVEL_OFF[cat];
            int reps = (abs_coeff < 15 ? abs_coeff : 15) - 2;
            for (int r = 0; r < reps; r++) cb.decision(ctx, 1);
            if (abs_coeff < 15) cb.decision(ctx, 0);
            else cb.ue_bypass(0, abs_coeff - 15);
            node_ctx = LEVEL_TRANS[1][node_ctx];
        } else {
            cb.decision(ctx, 0);
            node_ctx = LEVEL_TRANS[0][node_ctx];
        }
        cb.bypass(coeff < 0 ? -1 : 0);
    }
}

// Consume a device-binarized residual op stream (entropy/cabac_device.py):
// ops are int16, 0..551 = decision(ctx = op >> 1, bin = op & 1),
// 1024/1025 = bypass bit. The device front-half computes the exact bin
// sequence of cabac_block_residual above, so this loop is byte-identical
// by construction and leaves the host with only the arithmetic coder.
static inline void cabac_consume_ops(Cabac &cb, const int16_t *ops,
                                     int32_t o0, int32_t o1) {
    for (int32_t j = o0; j < o1; j++) {
        int v = ops[j];
        if (v < 1024) cb.decision(v >> 1, v & 1);
        else cb.bypass((v & 1) ? -1 : 0);
    }
}

static int cabac_mvd_cpn(Cabac &cb, int axis, int mvd, int ctx) {
    int ctxbase = axis ? 47 : 40;
    static const int ctxes[8] = {3, 4, 5, 6, 6, 6, 6, 6};
    if (mvd == 0) {
        cb.decision(ctxbase + ctx, 0);
        return 0;
    }
    int i_abs = mvd < 0 ? -mvd : mvd;
    cb.decision(ctxbase + ctx, 1);
    if (i_abs < 9) {
        for (int i = 1; i < i_abs; i++)
            cb.decision(ctxbase + ctxes[i - 1], 1);
        cb.decision(ctxbase + ctxes[i_abs - 1], 0);
    } else {
        for (int i = 1; i < 9; i++)
            cb.decision(ctxbase + ctxes[i - 1], 1);
        cb.ue_bypass(3, i_abs - 9);
    }
    cb.bypass(mvd < 0 ? -1 : 0);
    return i_abs < 66 ? i_abs : 66;
}

} // namespace

extern "C" {

void x264tpu_set_cabac_tables(const uint8_t *contexts,   // (2,52,276)
                              const uint8_t *range_lps,  // (64,4)
                              const uint8_t *renorm,     // (64,)
                              const uint8_t *transition) // (128,2)
{
    memcpy(g_cabac_ctx, contexts, sizeof(g_cabac_ctx));
    memcpy(g_range_lps, range_lps, sizeof(g_range_lps));
    memcpy(g_renorm, renorm, sizeof(g_renorm));
    memcpy(g_transition, transition, sizeof(g_transition));
}

// CABAC slice body (I or P) — twin of EncoderCore._write_slice_cabac
// (encoder/core.py) / encoder/cabac.c:38-632. header must be byte-aligned
// (cabac_alignment_one_bit already written). Returns payload length.
// mb_count_out: {I_16x16, I_4x4, P_L0, P_SKIP}.
int64_t x264tpu_write_slice_cabac(
    uint8_t *out, int64_t cap, const uint8_t *header, int64_t header_bytes,
    int is_p, int mb_w, int mb_h, int qp, int frame_idx,
    const int16_t *mb_type, const int16_t *i16_mode, const int16_t *i4_modes,
    const int16_t *chroma_mode, const int16_t *cbp_luma,
    const int16_t *cbp_chroma, const int16_t *nz_luma_dc,
    const int16_t *chroma_nz_dc, const int16_t *luma_nnz,
    const int16_t *chroma_nnz_ac, const int16_t *luma_levels,
    const int16_t *luma_dc_levels, const int16_t *chroma_dc_levels,
    const int16_t *chroma_ac_levels, const int16_t *mv,
    int32_t *mb_count_out,
    const int16_t *qp_mb /* nullable: per-MB QP (AQ / row-VBV) */,
    const int16_t *partition /* nullable: 0..3 per MB */,
    const int16_t *mv8 /* nullable: (mb, 2, 2, 2) quadrant MVs */,
    const int16_t *refidx /* nullable: per-MB ref idx */,
    int n_ref /* active L0 refs (1 when refidx null) */,
    int64_t *row_bits_out /* nullable: cumulative bit pos per MB row */,
    const int16_t *res_ops /* nullable: device residual op stream */,
    const int32_t *res_off /* nullable: (mb_w*mb_h*27+1) block offsets */) {
    (void)cap;
    memcpy(out, header, header_bytes);
    Cabac cb(!is_p, qp, frame_idx, out + header_bytes);
    // device front-half: residual bins come pre-binarized per block slot
    // (slot layout in entropy/cabac_device.py)
    auto residual = [&](int blkid, int cat, const int16_t *levels, int n) {
        if (res_ops && res_off)
            cabac_consume_ops(cb, res_ops, res_off[blkid],
                              res_off[blkid + 1]);
        else
            cabac_block_residual(cb, cat, levels, n);
    };
    int last_qp = qp;   // running decoded QP (x264 h->mb.i_last_qp)
    int last_dqp = 0;   // slice start (encoder.c:1482)
    int prev_ext = 0;   // extended cbp of the previous MB in raster order
    int w4 = mb_w * 4, w2 = mb_w * 2;
    int *nnz = (int *)calloc((size_t)mb_w * mb_h * 16, sizeof(int));
    int *cnnz = (int *)calloc((size_t)mb_w * mb_h * 8, sizeof(int));
    int *cbp_ext = (int *)malloc((size_t)mb_w * mb_h * sizeof(int));
    int *mbt = (int *)malloc((size_t)mb_w * mb_h * sizeof(int));
    int *cmodes = (int *)calloc((size_t)mb_w * mb_h, sizeof(int));
    // per-4x4-block capped |mvd| cache (h->mb.cache.mvd twin)
    int *mvdc = (int *)calloc((size_t)mb_w * mb_h * 32, sizeof(int));
    int32_t *mv4g = (int32_t *)calloc((size_t)mb_w * mb_h * 32,
                                      sizeof(int32_t));
    int32_t *ref4g = (int32_t *)calloc((size_t)mb_w * mb_h * 16,
                                       sizeof(int32_t));
    MvGrid4 grid{mb_w, mb_h, mv4g, ref4g};
    for (int i = 0; i < mb_w * mb_h; i++) { cbp_ext[i] = -1; mbt[i] = -1; }
    int counts[7] = {0, 0, 0, 0, 0, 0, 0};

    // i4_modes indexed via the CAVLC Ctx-compatible view for host_mpm
    SynI si{mb_type, nullptr, i4_modes, nullptr, nullptr, nullptr,
            nullptr, nullptr, nullptr, nullptr, nullptr, nullptr};
    Ctx mpm_ctx{mb_w, mb_h, nullptr, nullptr, &si};

    auto cbf_ctx_dc = [&](int cat, int mby, int mbx, int bit, int b_intra) {
        int la = mbx > 0 ? cbp_ext[mby * mb_w + mbx - 1] : -1;
        int ta = mby > 0 ? cbp_ext[(mby - 1) * mb_w + mbx] : -1;
        int nza = la != -1 ? ((la >> bit) & 1) : b_intra;
        int nzb = ta != -1 ? ((ta >> bit) & 1) : b_intra;
        return CBF_BASE_T[cat] + (nzb << 1) + nza;
    };
    auto cbf_ctx_ac = [&](int cat, const int *grid, int gw, int by, int bx,
                          int b_intra) {
        int nza = bx > 0 ? grid[by * gw + bx - 1] : b_intra;
        int nzb = by > 0 ? grid[(by - 1) * gw + bx] : b_intra;
        return CBF_BASE_T[cat] + ((nzb ? 1 : 0) << 1) + (nza ? 1 : 0);
    };

    for (int mby = 0; mby < mb_h; mby++) {
        for (int mbx = 0; mbx < mb_w; mbx++) {
            int mb = mby * mb_w + mbx;
            if (mb != 0) cb.terminal();
            int cl = cbp_luma[mb];
            int cch = cbp_chroma[mb];

            int part = (is_p && partition) ? partition[mb] : 0;
            int mb_ref = (is_p && refidx) ? refidx[mb] : 0;
            int64_t mvs[4][2];
            if (is_p) load_part_mvs(mv8, mv, mb, part, mvs);

            if (is_p) {
                int64_t psk[2];
                grid.pskip(mbx, mby, psk);
                bool is_skip = part == 0 && mb_ref == 0 && cl == 0 &&
                               cch == 0 &&
                               mvs[0][0] == psk[0] && mvs[0][1] == psk[1];
                int nsk = 0;
                if (mbx > 0 && mbt[mb - 1] != 3) nsk++;
                if (mby > 0 && mbt[mb - mb_w] != 3) nsk++;
                cb.decision(11 + nsk, is_skip ? 1 : 0);
                if (is_skip) {
                    grid.set_mb(mbx, mby, 0, mvs, 0);
                    mbt[mb] = 3;
                    cbp_ext[mb] = 0;
                    for (int i = 0; i < 16; i++)
                        nnz[(mby * 4 + BIY[i]) * w4 + mbx * 4 + BIX[i]] = 0;
                    for (int ch = 0; ch < 2; ch++)
                        for (int d = 0; d < 4; d++)
                            cnnz[(ch * 2 * mb_h + mby * 2 + (d >> 1)) * w2 +
                                 mbx * 2 + (d & 1)] = 0;
                    for (int d = 0; d < 32; d++) mvdc[mb * 32 + d] = 0;
                    counts[3]++;
                    last_dqp = 0;    // cache_save: qp reverts to last_qp
                    prev_ext = 0;
                    continue;
                }
            }

            int b_intra;
            bool is_i16 = false;
            if (is_p) {
                // mb_type bins (x264_cabac_mb_header_p, cabac.c:345-415)
                if (part == 0) {
                    cb.decision(14, 0); cb.decision(15, 0); cb.decision(16, 0);
                } else if (part == 1) {
                    cb.decision(14, 0); cb.decision(15, 1); cb.decision(17, 1);
                } else if (part == 2) {
                    cb.decision(14, 0); cb.decision(15, 1); cb.decision(17, 0);
                } else {
                    cb.decision(14, 0); cb.decision(15, 0); cb.decision(16, 1);
                    for (int i = 0; i < 4; i++)
                        cb.decision(21, 1);  // sub_mb_type D_L0_8x8
                }
                // ref idx (x264_cabac_ref_p, cabac.c:211-230) BEFORE
                // storing this MB's refs (neighbour ctx uses old state)
                if (n_ref > 1) {
                    for (int pi = 0; pi < PART_N[part]; pi++) {
                        const int *g = PART_GEOM[part][pi];
                        int bx0 = mbx * 4 + g[0], by0 = mby * 4 + g[1];
                        auto ref_at = [&](int x, int y) -> int {
                            if (x < 0 || y < 0) return 0;
                            // within current MB, earlier partitions have
                            // this MB's ref; unreached blocks still hold 0
                            return ref4g[y * mb_w * 4 + x];
                        };
                        // note: earlier partitions of this MB must be
                        // visible; store incrementally below
                        int ctx = 0;
                        if (ref_at(bx0 - 1, by0) > 0) ctx++;
                        if (ref_at(bx0, by0 - 1) > 0) ctx += 2;
                        for (int r = mb_ref; r > 0; r--) {
                            cb.decision(54 + ctx, 1);
                            ctx = (ctx >> 2) + 4;
                        }
                        cb.decision(54 + ctx, 0);
                        // set this partition's ref for later partitions
                        for (int dy = 0; dy < g[3]; dy++)
                            for (int dx = 0; dx < g[2]; dx++)
                                ref4g[(by0 + dy) * mb_w * 4 + bx0 + dx] =
                                    mb_ref;
                    }
                }
                grid.set_mb(mbx, mby, part, mvs, mb_ref);
                for (int pi = 0; pi < PART_N[part]; pi++) {
                    int64_t mvp[2];
                    grid.predict(mbx, mby, part, pi, mb_ref, mvp);
                    const int *g = PART_GEOM[part][pi];
                    int bx0 = mbx * 4 + g[0], by0 = mby * 4 + g[1];
                    // mvd cache layout: mvdc[(mb*16 + ry*4 + rx)*2 + k],
                    // frame-indexed below for cross-MB neighbours
                    auto mvd_at = [&](int x, int y, int k) -> int {
                        if (x < 0 || y < 0) return 0;
                        int m = (y >> 2) * mb_w + (x >> 2);
                        return mvdc[(m * 16 + (y & 3) * 4 + (x & 3)) * 2 + k];
                    };
                    int amvd0 = mvd_at(bx0 - 1, by0, 0)
                              + mvd_at(bx0, by0 - 1, 0);
                    int amvd1 = mvd_at(bx0 - 1, by0, 1)
                              + mvd_at(bx0, by0 - 1, 1);
                    int c0 = (amvd0 > 2 ? 1 : 0) + (amvd0 > 32 ? 1 : 0);
                    int c1 = (amvd1 > 2 ? 1 : 0) + (amvd1 > 32 ? 1 : 0);
                    int a0 = cabac_mvd_cpn(cb, 0,
                                           (int)(mvs[pi][0] - mvp[0]), c0);
                    int a1 = cabac_mvd_cpn(cb, 1,
                                           (int)(mvs[pi][1] - mvp[1]), c1);
                    for (int dy = 0; dy < g[3]; dy++)
                        for (int dx = 0; dx < g[2]; dx++) {
                            int m = mb;
                            int ri = ((g[1] + dy) * 4 + g[0] + dx);
                            mvdc[(m * 16 + ri) * 2] = a0;
                            mvdc[(m * 16 + ri) * 2 + 1] = a1;
                        }
                }
                mbt[mb] = 2;
                b_intra = 0;
                counts[part == 0 ? 2 : 3 + part]++;
            } else {
                bool is_i4 = mb_type[mb] == 1;
                b_intra = 1;
                int ctx = 0;
                if (mbx > 0 && mbt[mb - 1] != 1) ctx++;
                if (mby > 0 && mbt[mb - mb_w] != 1) ctx++;
                // mb_type intra (cabac.c:38-64)
                if (is_i4) {
                    cb.decision(3 + ctx, 0);
                } else {
                    int mode_fix = FIX16[i16_mode[mb]];
                    cb.decision(3 + ctx, 1);
                    cb.terminal();
                    cb.decision(6, cl ? 1 : 0);
                    if (cch == 0) {
                        cb.decision(7, 0);
                    } else {
                        cb.decision(7, 1);
                        cb.decision(8, cch >> 1);
                    }
                    cb.decision(9, mode_fix >> 1);
                    cb.decision(10, mode_fix & 1);
                }
                if (is_i4) {
                    for (int i = 0; i < 16; i++) {
                        int bx = mbx * 4 + BIX[i];
                        int by = mby * 4 + BIY[i];
                        int pred = host_mpm(mpm_ctx, by, bx);
                        int mode = FIX4[i4_modes[mb * 16 + i] + 1];
                        if (pred == mode) {
                            cb.decision(68, 1);
                        } else {
                            cb.decision(68, 0);
                            if (mode > pred) mode--;
                            cb.decision(69, mode & 1);
                            cb.decision(69, (mode >> 1) & 1);
                            cb.decision(69, mode >> 2);
                        }
                    }
                }
                // chroma pred mode (cabac.c:84-103)
                int cm = FIXC[chroma_mode[mb]];
                ctx = 0;
                if (mbx > 0 && cmodes[mb - 1] != 0) ctx++;
                if (mby > 0 && cmodes[mb - mb_w] != 0) ctx++;
                cb.decision(64 + ctx, cm > 0 ? 1 : 0);
                if (cm > 0) {
                    cb.decision(64 + 3, cm > 1 ? 1 : 0);
                    if (cm > 1) cb.decision(64 + 3, cm > 2 ? 1 : 0);
                }
                cmodes[mb] = cm;
                mbt[mb] = is_i4 ? 1 : 0;
                counts[is_i4 ? 1 : 0]++;
                is_i16 = !is_i4;
            }

            int nz_dc = is_i16 ? nz_luma_dc[mb] : 0;
            int cnz0 = chroma_nz_dc ? chroma_nz_dc[mb * 2] : 0;
            int cnz1 = chroma_nz_dc ? chroma_nz_dc[mb * 2 + 1] : 0;
            int this_ext = (cch << 4) | cl | (nz_dc << 8) | (cnz0 << 9) |
                           (cnz1 << 10);

            if (!is_i16) {
                // cbp (cabac.c:111-164)
                int cleft = mbx > 0 ? cbp_ext[mb - 1] : -1;
                int ctop = mby > 0 ? cbp_ext[mb - mb_w] : -1;
                cb.decision(76 - ((cleft >> 1) & 1) - ((ctop >> 1) & 2),
                            (cl >> 0) & 1);
                cb.decision(76 - ((cl >> 0) & 1) - ((ctop >> 2) & 2),
                            (cl >> 1) & 1);
                cb.decision(76 - ((cleft >> 3) & 1) - ((cl << 1) & 2),
                            (cl >> 2) & 1);
                cb.decision(76 - ((cl >> 2) & 1) - ((cl >> 0) & 2),
                            (cl >> 3) & 1);
                int ctx = 0;
                if ((cleft & 0x30) && cleft != -1) ctx += 1;
                if ((ctop & 0x30) && ctop != -1) ctx += 2;
                if (cch == 0) {
                    cb.decision(77 + ctx, 0);
                } else {
                    cb.decision(77 + ctx, 1);
                    ctx = 4;
                    if ((cleft & 0x30) == 0x20) ctx += 1;
                    if ((ctop & 0x30) == 0x20) ctx += 2;
                    cb.decision(77 + ctx, cch >> 1);
                }
            }
            cbp_ext[mb] = this_ext;

            if (cl || cch || is_i16) {
                // x264_cabac_qp_delta (encoder/cabac.c:165-201)
                int mqp = qp_mb ? qp_mb[mb] : qp;
                // empty-I16 suppression: revert to last_qp
                if (is_i16 && !this_ext) mqp = last_qp;
                int dqp = mqp - last_qp;
                int ctx = (last_dqp != 0 && prev_ext != 0) ? 1 : 0;
                if (dqp != 0) {
                    int val = dqp > 0 ? 2 * dqp - 1 : -2 * dqp;
                    if (val >= 51 && val != 52)
                        val = 103 - val;  // modulo QP_MAX_SPEC+1
                    while (val--) {
                        cb.decision(60 + ctx, 1);
                        ctx = 2 + (ctx >> 1);
                    }
                }
                cb.decision(60 + ctx, 0);
                last_dqp = mqp - last_qp;
                last_qp = mqp;
                if (is_i16) {
                    int ctx = cbf_ctx_dc(0, mby, mbx, 8, b_intra);
                    cb.decision(ctx, nz_dc ? 1 : 0);
                    if (nz_dc)
                        residual(mb * 27, 0, luma_dc_levels + mb * 16, 16);
                    if (cl) {
                        for (int i = 0; i < 16; i++) {
                            int bx = mbx * 4 + BIX[i];
                            int by = mby * 4 + BIY[i];
                            int nzf = luma_nnz[mb * 16 + i];
                            int c2 = cbf_ctx_ac(1, nnz, w4, by, bx, b_intra);
                            cb.decision(c2, nzf ? 1 : 0);
                            if (nzf)
                                residual(mb * 27 + 1 + i, 1,
                                         luma_levels + (mb * 16 + i) * 16
                                         + 1, 15);
                            nnz[by * w4 + bx] = nzf;
                        }
                    }
                } else {
                    for (int i = 0; i < 16; i++) {
                        if (!(cl & (1 << (i >> 2)))) continue;
                        int bx = mbx * 4 + BIX[i];
                        int by = mby * 4 + BIY[i];
                        int nzf = luma_nnz[mb * 16 + i];
                        int c2 = cbf_ctx_ac(2, nnz, w4, by, bx, b_intra);
                        cb.decision(c2, nzf ? 1 : 0);
                        if (nzf)
                            residual(mb * 27 + 1 + i, 2,
                                     luma_levels + (mb * 16 + i) * 16, 16);
                        nnz[by * w4 + bx] = nzf;
                    }
                }
                if (cch) {
                    for (int ch = 0; ch < 2; ch++) {
                        int ctx = cbf_ctx_dc(3, mby, mbx, 9 + ch, b_intra);
                        int nzf = ch == 0 ? cnz0 : cnz1;
                        cb.decision(ctx, nzf ? 1 : 0);
                        if (nzf)
                            residual(mb * 27 + 17 + ch, 3,
                                     chroma_dc_levels + (mb * 2 + ch) * 4,
                                     4);
                    }
                    if (cch == 2) {
                        for (int ch = 0; ch < 2; ch++)
                            for (int i = 0; i < 4; i++) {
                                int bx = mbx * 2 + (i & 1);
                                int by = mby * 2 + (i >> 1);
                                const int *grid = cnnz + ch * 2 * mb_h * w2;
                                int nzf = chroma_nnz_ac[(mb * 2 + ch) * 4 + i];
                                int c2 = cbf_ctx_ac(4, grid, w2, by, bx,
                                                    b_intra);
                                cb.decision(c2, nzf ? 1 : 0);
                                if (nzf)
                                    residual(mb * 27 + 19 + ch * 4 + i, 4,
                                             chroma_ac_levels +
                                                 ((mb * 2 + ch) * 4 + i) * 16
                                                 + 1,
                                             15);
                                cnnz[(ch * 2 * mb_h + by) * w2 + bx] = nzf;
                            }
                    }
                }
            }

            if (!(cl || cch || is_i16))
                last_dqp = 0;  // uncoded: cache_save reverts qp
            prev_ext = this_ext;

            // zero nnz state for uncoded blocks
            if (!(cl || is_i16)) {
                for (int i = 0; i < 16; i++)
                    nnz[(mby * 4 + BIY[i]) * w4 + mbx * 4 + BIX[i]] = 0;
            } else if (!is_i16) {
                for (int i = 0; i < 16; i++)
                    if (!(cl & (1 << (i >> 2))))
                        nnz[(mby * 4 + BIY[i]) * w4 + mbx * 4 + BIX[i]] = 0;
            }
            if (cch != 2)
                for (int ch = 0; ch < 2; ch++)
                    for (int d = 0; d < 4; d++)
                        cnnz[(ch * 2 * mb_h + mby * 2 + (d >> 1)) * w2 +
                             mbx * 2 + (d & 1)] = 0;
        }
        // x264_cabac_pos twin: bytes out + outstanding + queued bits
        if (row_bits_out)
            row_bits_out[mby] = (int64_t)(cb.len + cb.outstanding) * 8
                                + cb.queue + 10;
    }

    cb.flush();
    if (mb_count_out)
        for (int i = 0; i < 7; i++) mb_count_out[i] = counts[i];
    free(nnz); free(cnnz); free(cbp_ext); free(mbt); free(cmodes);
    free(mvdc); free(mv4g); free(ref4g);
    return header_bytes + (int64_t)cb.len;
}

void x264tpu_set_cavlc_tables(const uint16_t *coeff0,      // (6,2)
                              const uint16_t *coeff_token, // (6,16,4,2)
                              const uint16_t *total_zeros, // (15,16,2)
                              const uint16_t *tz_dc) {     // (3,4,2)
    for (int t = 0; t < 5; t++) {
        int src = t < 4 ? t : 4;
        g_coeff_token[t][0][0][0] = coeff0[src * 2];
        g_coeff_token[t][0][0][1] = coeff0[src * 2 + 1];
        for (int total = 1; total <= 16; total++)
            for (int t1 = 0; t1 < 4; t1++) {
                const uint16_t *p =
                    coeff_token + ((src * 16 + total - 1) * 4 + t1) * 2;
                g_coeff_token[t][total][t1][0] = p[0];
                g_coeff_token[t][total][t1][1] = p[1];
            }
    }
    memcpy(g_total_zeros, total_zeros, sizeof(g_total_zeros));
    memcpy(g_total_zeros_dc, tz_dc, sizeof(g_total_zeros_dc));
}

// Returns payload length. out must be large enough (est 1MB+, caller's job).
int64_t x264tpu_write_slice_i(
    uint8_t *out, int64_t cap, const uint8_t *header, int64_t header_bytes,
    int header_bits_used, int mb_w, int mb_h, int qp,
    const int16_t *mb_type, const int16_t *i16_mode, const int16_t *i4_modes,
    const int16_t *chroma_mode, const int16_t *cbp_luma,
    const int16_t *cbp_chroma, const int16_t *nz_luma_dc,
    const int16_t *luma_levels, const int16_t *luma_dc_levels,
    const int16_t *chroma_dc_levels, const int16_t *chroma_ac_levels,
    const int16_t *qp_mb /* nullable: per-MB QP (AQ / row-VBV) */,
    int64_t *row_bits_out /* nullable: cumulative bit pos per MB row */) {
    BitWriter bw{out, (size_t)cap};
    // preload the already-written header bits
    for (int64_t i = 0; i < header_bytes; i++) bw.write(8, header[i]);
    if (header_bits_used) bw.write(header_bits_used,
                                   header[header_bytes] >> (8 - header_bits_used));

    SynI s{mb_type, i16_mode, i4_modes, chroma_mode, cbp_luma, cbp_chroma,
           nz_luma_dc, luma_levels, luma_dc_levels, chroma_dc_levels,
           chroma_ac_levels, nullptr};
    int *lc = (int *)calloc((size_t)mb_w * mb_h * 16, sizeof(int));
    int *cc = (int *)calloc((size_t)mb_w * mb_h * 8, sizeof(int));
    Ctx c{mb_w, mb_h, lc, cc, &s};
    int last_qp = qp;
    for (int mby = 0; mby < mb_h; mby++) {
        for (int mbx = 0; mbx < mb_w; mbx++) {
            int mqp = qp_mb ? qp_mb[mby * mb_w + mbx] : qp;
            write_mb_i(bw, c, mbx, mby, mqp, last_qp, 0);
        }
        if (row_bits_out)
            row_bits_out[mby] = (int64_t)bw.len * 8 + bw.nbits;
    }
    bw.rbsp_trailing();
    free(lc); free(cc);
    return (int64_t)bw.len;
}

int64_t x264tpu_write_slice_p(
    uint8_t *out, int64_t cap, const uint8_t *header, int64_t header_bytes,
    int header_bits_used, int mb_w, int mb_h, int qp,
    const int16_t *mv, const int16_t *cbp_luma, const int16_t *cbp_chroma,
    const int16_t *luma_levels, const int16_t *chroma_dc_levels,
    const int16_t *chroma_ac_levels, int32_t *skip_count_out,
    const int16_t *qp_mb /* nullable: per-MB QP (AQ / row-VBV) */,
    const int16_t *partition /* nullable: 0..3 per MB */,
    const int16_t *mv8 /* nullable: (mb, 2, 2, 2) quadrant MVs */,
    const int16_t *refidx /* nullable: per-MB ref idx */,
    int n_ref /* active L0 refs (1 when refidx null) */,
    int64_t *row_bits_out /* nullable: cumulative bit pos per MB row */) {
    BitWriter bw{out, (size_t)cap};
    for (int64_t i = 0; i < header_bytes; i++) bw.write(8, header[i]);
    if (header_bits_used) bw.write(header_bits_used,
                                   header[header_bytes] >> (8 - header_bits_used));

    SynI s{nullptr, nullptr, nullptr, nullptr, cbp_luma, cbp_chroma,
           nullptr, luma_levels, nullptr, chroma_dc_levels,
           chroma_ac_levels, mv};
    int *lc = (int *)calloc((size_t)mb_w * mb_h * 16, sizeof(int));
    int *cc = (int *)calloc((size_t)mb_w * mb_h * 8, sizeof(int));
    int32_t *mv4 = (int32_t *)calloc((size_t)mb_w * mb_h * 32,
                                     sizeof(int32_t));
    int32_t *ref4 = (int32_t *)calloc((size_t)mb_w * mb_h * 16,
                                      sizeof(int32_t));
    MvGrid4 grid{mb_w, mb_h, mv4, ref4};
    Ctx c{mb_w, mb_h, lc, cc, &s};
    int w4 = mb_w * 4;
    int last_qp = qp;
    int skip_run = 0;
    int n_skip = 0;
    for (int mby = 0; mby < mb_h; mby++) {
        for (int mbx = 0; mbx < mb_w; mbx++) {
            int mb = mby * mb_w + mbx;
            int cl = cbp_luma[mb], cch = cbp_chroma[mb];
            int part = partition ? partition[mb] : 0;
            int mb_ref = refidx ? refidx[mb] : 0;
            int64_t mvs[4][2];
            load_part_mvs(mv8, mv, mb, part, mvs);
            int64_t psk[2];
            grid.pskip(mbx, mby, psk);
            bool is_skip = part == 0 && mb_ref == 0 && cl == 0 && cch == 0 &&
                           mvs[0][0] == psk[0] && mvs[0][1] == psk[1];
            if (is_skip) {
                skip_run++;
                n_skip++;
                grid.set_mb(mbx, mby, 0, mvs, 0);
                for (int i = 0; i < 16; i++)
                    lc[(mby * 4 + BIY[i]) * w4 + mbx * 4 + BIX[i]] = 0;
                write_chroma_residual(bw, c, mb, mbx, mby, 0);
                continue;
            }
            bw.write_ue(skip_run);
            skip_run = 0;
            // mb_type (cavlc.c:235-305): P_8x8ref0 (ue 4) when all
            // sub refs are 0 and refs are active
            bool sub_ref0 = part == 3 && n_ref > 1 && mb_ref == 0;
            bw.write_ue(part == 3 && sub_ref0 ? 4 : part);
            if (part == 3)
                bw.write(4, 0xF);  // 4x sub_mb_type = L0_8x8 (ue(0))
            grid.set_mb(mbx, mby, part, mvs, mb_ref);
            if (n_ref > 1 && !(part == 3 && sub_ref0)) {
                // te(n_ref-1) coded ref idx per partition
                for (int pi = 0; pi < PART_N[part]; pi++) {
                    if (n_ref == 2) bw.write(1, 1 ^ mb_ref);
                    else bw.write_ue(mb_ref);
                }
            }
            for (int pi = 0; pi < PART_N[part]; pi++) {
                int64_t mvp[2];
                grid.predict(mbx, mby, part, pi, mb_ref, mvp);
                bw.write_se((int32_t)(mvs[pi][0] - mvp[0]));
                bw.write_se((int32_t)(mvs[pi][1] - mvp[1]));
            }
            bw.write_ue(CBP_GOLOMB_INTER[(cch << 4) | cl]);
            if (cl | cch) {
                int mqp = qp_mb ? qp_mb[mb] : qp;
                bw.write_se(mqp - last_qp);
                last_qp = mqp;
            }
            for (int i = 0; i < 16; i++) {
                int bx = mbx * 4 + BIX[i];
                int by = mby * 4 + BIY[i];
                if (cl & (1 << (i >> 2))) {
                    int nc = nc_ctx(lc, w4, by, bx);
                    int tot = write_block_residual(
                        bw, luma_levels + (mb * 16 + i) * 16, 16, nc, false);
                    lc[by * w4 + bx] = tot;
                } else lc[by * w4 + bx] = 0;
            }
            write_chroma_residual(bw, c, mb, mbx, mby, cch);
        }
        // pending skip_run bits land in the row that ends the run,
        // matching the reference's bs-position row accounting
        if (row_bits_out)
            row_bits_out[mby] = (int64_t)bw.len * 8 + bw.nbits;
    }
    if (skip_run > 0) bw.write_ue(skip_run);
    bw.rbsp_trailing();
    if (skip_count_out) *skip_count_out = n_skip;
    free(lc); free(cc); free(mv4); free(ref4);
    return (int64_t)bw.len;
}

// emulation-prevention escape: returns escaped length
int64_t x264tpu_nal_escape(uint8_t *dst, const uint8_t *src, int64_t n) {
    int64_t o = 0;
    int zeros = 0;
    for (int64_t i = 0; i < n; i++) {
        uint8_t b = src[i];
        if (zeros >= 2 && b <= 3) {
            dst[o++] = 3;
            zeros = 0;
        }
        dst[o++] = b;
        zeros = b == 0 ? zeros + 1 : 0;
    }
    return o;
}

} // extern "C"
