// Native route solver for the v3 panel planner (panel_plan.py).
//
// Ports _route_panels_seq's greedy 3-stage route assignment — the
// placement rounds, the tail repair, the relax tiers, and the fill
// phase — to tight sequential loops.  The Python caller keeps the
// final plan-array (idx1/sel/idx3) construction, which is already
// vectorized numpy.
//
// Semantics: the proposal formulas (per-round hashed intermediate
// lanes, stripe-row rotation, hashed final lanes) are IDENTICAL to the
// numpy solver; acceptance differs only in that the sequential loop
// sees same-round placements as live state (a strict superset of the
// numpy round's conflict-filtered acceptance), so it converges at
// least as fast and produces equally valid routes.
//
// Reference behavior planned here: the per-tile serial scatter of
// spmv_stationary (vertex_program.hpp:1162-1185), re-shaped at plan
// time into conflict-free static crossbars.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int LANES = 128;
constexpr int PROWS = 64;
constexpr int STRIPE = 8;

struct Solver {
    const int64_t *src_r, *src_c, *dst_stripe, *dst_lane, *panel_of;
    int64_t N, npanels, src_rows, fill_from, max_row;
    bool relax_lane, one_layer, free_lane;

    std::vector<int16_t> src_at;      // (npanels, src_rows, LANES) c+1
    std::vector<int32_t> land;        // (2, npanels, PROWS, LANES) rc
    std::vector<uint8_t> final_used;  // (npanels, PROWS, LANES)
    std::vector<int64_t> final_who;   // (npanels, PROWS, LANES)
    std::vector<int32_t> rc, c1;
    std::vector<uint8_t> is_fill;
    // write-round versions: during round k an entry written in round k
    // still counts as FREE for proposal selection (the numpy solver
    // proposes against round-start state), while acceptance checks the
    // LIVE value with the share rules — this reproduces the vectorized
    // solver's round semantics exactly.
    std::vector<int16_t> sa_ver, land_ver, fu_ver;
    int16_t round_ = -1;

    inline int16_t SA_old(int64_t p, int64_t r, int64_t m) {
        int64_t i = (p * src_rows + r) * LANES + m;
        return sa_ver[i] == round_ ? (int16_t)0 : src_at[i];
    }
    inline int32_t LD_old(int ly, int64_t p, int64_t row, int64_t m) {
        int64_t i = ((ly * npanels + p) * PROWS + row) * LANES + m;
        return land_ver[i] == round_ ? 0 : land[i];
    }
    inline uint8_t FU_old(int64_t p, int64_t row, int64_t l) {
        int64_t i = (p * PROWS + row) * LANES + l;
        return fu_ver[i] == round_ ? (uint8_t)0 : final_used[i];
    }

    int32_t *m_of, *row_of, *lane_of, *pick;
    int64_t relaxed = 0;

    inline int16_t& SA(int64_t p, int64_t r, int64_t m) {
        return src_at[(p * src_rows + r) * LANES + m];
    }
    inline int32_t& LD(int ly, int64_t p, int64_t row, int64_t m) {
        return land[((ly * npanels + p) * PROWS + row) * LANES + m];
    }
    inline uint8_t& FU(int64_t p, int64_t row, int64_t l) {
        return final_used[(p * PROWS + row) * LANES + l];
    }
    inline int64_t& FW(int64_t p, int64_t row, int64_t l) {
        return final_who[(p * PROWS + row) * LANES + l];
    }

    void init() {
        src_at.assign(npanels * src_rows * LANES, 0);
        land.assign(2 * npanels * PROWS * LANES, 0);
        final_used.assign(npanels * PROWS * LANES, 0);
        final_who.assign(npanels * PROWS * LANES, -1);
        sa_ver.assign(npanels * src_rows * LANES, -1);
        land_ver.assign(2 * npanels * PROWS * LANES, -1);
        fu_ver.assign(npanels * PROWS * LANES, -1);
        rc.resize(N); c1.resize(N); is_fill.resize(N);
        for (int64_t e = 0; e < N; e++) {
            is_fill[e] = (fill_from >= 0 && src_r[e] >= fill_from);
            c1[e] = (int32_t)(src_c[e] + 1);
            rc[e] = is_fill[e] ? -1
                   : (int32_t)(src_r[e] * LANES + src_c[e] + 1);
            m_of[e] = -1; row_of[e] = -1; lane_of[e] = -1; pick[e] = 0;
        }
    }

    void place(int64_t e, int m, int row, int lane, int ly) {
        int64_t p = panel_of[e];
        m_of[e] = m; row_of[e] = row; lane_of[e] = lane; pick[e] = ly;
        SA(p, src_r[e], m) = (int16_t)c1[e];
        sa_ver[(p * src_rows + src_r[e]) * LANES + m] = round_;
        LD(ly, p, row, m) = rc[e];
        land_ver[((ly * npanels + p) * PROWS + row) * LANES + m] = round_;
        FU(p, row, lane) = 1;
        fu_ver[(p * PROWS + row) * LANES + lane] = round_;
        FW(p, row, lane) = e;
    }

    // viable intermediate lanes for e: src_at free or same (r, c)
    template <class F> bool for_viable_m(int64_t e, F&& f) {
        int64_t p = panel_of[e];
        const int16_t* row = &src_at[(p * src_rows + src_r[e]) * LANES];
        for (int m = 0; m < LANES; m++)
            if (row[m] == 0 || row[m] == (int16_t)c1[e])
                if (f(m)) return true;
        return false;
    }

    // ---------------- free-lane mode ----------------
    int solve_free() {
        // group ids per (panel, src_r, src_c): open-addressing hash
        std::vector<int64_t> gid(N, -1);
        int64_t cap = 1;
        while (cap < 2 * N + 16) cap <<= 1;
        std::vector<int64_t> hkey(cap, -1), hval(cap, 0);
        int64_t G = 0;
        for (int64_t e = 0; e < N; e++) {
            if (is_fill[e]) continue;
            int64_t key = (panel_of[e] * src_rows + src_r[e]) * LANES
                          + src_c[e];
            uint64_t h = (uint64_t)key * 0x9e3779b97f4a7c15ull;
            int64_t i = (int64_t)(h & (uint64_t)(cap - 1));
            while (hkey[i] != -1 && hkey[i] != key)
                i = (i + 1) & (cap - 1);
            if (hkey[i] == -1) { hkey[i] = key; hval[i] = G++; }
            gid[e] = hval[i];
        }
        std::vector<int32_t> gm(G, -1);

        std::vector<int64_t> pend, next;
        for (int64_t e = 0; e < N; e++)
            if (!is_fill[e]) pend.push_back(e);
        for (int k = 0; k < 4 * LANES && !pend.empty(); k++) {
            round_++;
            // gm updates within a round must not alter later proposals
            // (numpy updates gm only after the round's vectorized take)
            std::vector<std::pair<int64_t, int32_t>> gm_upd;
            next.clear();
            for (int64_t e : pend) {
                int64_t p = panel_of[e];
                int64_t g = gid[e];
                int fresh = (int)((src_c[e] * 37 + 53 * (k / 2)
                                   + g * 17) % LANES);
                int m = (k % 2 == 0 && gm[g] >= 0) ? gm[g] : fresh;
                // proposal against ROUND-START state
                int16_t sa = SA_old(p, src_r[e], m);
                bool ok_src = (sa == 0 || sa == (int16_t)c1[e]);
                int roff = (int)((e + k) % STRIPE);
                int row_fin = -1, lay = 0;
                if (ok_src) {
                    for (int t = 0; t < STRIPE; t++) {
                        int row = (int)(dst_stripe[e] * STRIPE
                                        + (t + roff) % STRIPE);
                        int32_t la = LD_old(0, p, row, m);
                        int32_t lb = LD_old(1, p, row, m);
                        bool oa = (la == 0 || la == rc[e]);
                        bool ob = (lb == 0 || lb == rc[e]);
                        if (oa || ob) {
                            row_fin = row; lay = oa ? 0 : 1; break;
                        }
                    }
                }
                if (row_fin >= 0) {
                    int lane_try = (int)((m + 29 * (e % 31) + k) % LANES);
                    // acceptance against LIVE state (the share rules):
                    // same-round writes must agree or the slot defers
                    int16_t sl = SA(p, src_r[e], m);
                    int32_t ll = LD(lay, p, row_fin, m);
                    if (!FU_old(p, row_fin, lane_try)
                        && (sl == 0 || sl == (int16_t)c1[e])
                        && (ll == 0 || ll == rc[e])
                        && !FU(p, row_fin, lane_try)) {
                        place(e, m, row_fin, lane_try, lay);
                        gm_upd.emplace_back(g, m);
                        continue;
                    }
                }
                next.push_back(e);
            }
            for (auto& u : gm_upd) gm[u.first] = u.second;
            pend.swap(next);
        }
        // tail repair
        for (int64_t e : pend) {
            int64_t p = panel_of[e];
            bool done = for_viable_m(e, [&](int m) {
                int row, lane, ly;
                if (spot_free(e, m, row, lane, ly)) {
                    place(e, m, row, lane, ly);
                    return true;
                }
                return false;
            });
            if (done) continue;
            // relocate one blocker
            done = for_viable_m(e, [&](int m) {
                for (int t = 0; t < STRIPE; t++) {
                    int row = (int)(dst_stripe[e] * STRIPE + t);
                    int32_t l0 = LD(0, p, row, m);
                    int32_t l1 = LD(1, p, row, m);
                    int ly_e = (l0 == 0 || l0 == rc[e]) ? 0
                             : ((l1 == 0 || l1 == rc[e]) ? 1 : -1);
                    if (ly_e < 0) continue;
                    for (int lane = 0; lane < LANES; lane++) {
                        int64_t b = FW(p, row, lane);
                        if (b < 0 || is_fill[b]) continue;
                        bool moved = for_viable_m(b, [&](int m2) {
                            int r2, l2, y2;
                            if (spot_free(b, m2, r2, l2, y2)) {
                                FU(p, row, lane) = 0;
                                FW(p, row, lane) = -1;
                                place(b, m2, r2, l2, y2);
                                place(e, m, row, lane, ly_e);
                                return true;
                            }
                            return false;
                        });
                        if (moved) return true;
                    }
                }
                return false;
            });
            if (!done) return -1;
        }
        return 0;
    }

    // (row, lane, layer) for e at intermediate m — free-lane spot
    bool spot_free(int64_t e, int m, int& row_o, int& lane_o, int& ly_o) {
        int64_t p = panel_of[e];
        for (int ly = 0; ly < 2; ly++) {
            for (int t = 0; t < STRIPE; t++) {
                int row = (int)(dst_stripe[e] * STRIPE + t);
                int32_t la = LD(ly, p, row, m);
                if (la == 0 || la == rc[e]) {
                    const uint8_t* fu = &final_used[(p * PROWS + row)
                                                    * LANES];
                    for (int l = 0; l < LANES; l++) {
                        if (!fu[l]) {
                            row_o = row; lane_o = l; ly_o = ly;
                            return true;
                        }
                    }
                }
            }
        }
        return false;
    }

    // ---------------- fixed-lane mode ----------------
    int nlayers() const { return one_layer ? 1 : 2; }

    bool spot_fixed(int64_t e, int m, int& row_o, int& ly_o) {
        int64_t p = panel_of[e];
        for (int ly = 0; ly < nlayers(); ly++) {
            for (int t = 0; t < STRIPE; t++) {
                int row = (int)(dst_stripe[e] * STRIPE + t);
                if (max_row >= 0 && row >= max_row) continue;
                int32_t la = LD(ly, p, row, m);
                if ((la == 0 || la == rc[e])
                    && !FU(p, row, dst_lane[e])) {
                    row_o = row; ly_o = ly;
                    return true;
                }
            }
        }
        return false;
    }

    int solve_fixed() {
        std::vector<int64_t> pend, next;
        for (int64_t e = 0; e < N; e++)
            if (!is_fill[e]) pend.push_back(e);
        for (int k = 0; k < 2 * LANES && !pend.empty(); k++) {
            round_++;
            next.clear();
            for (int64_t e : pend) {
                int64_t p = panel_of[e];
                int m = (int)((src_c[e] + STRIPE * k + k) % LANES);
                // proposal against ROUND-START state
                int16_t sa = SA_old(p, src_r[e], m);
                bool ok_src = (sa == 0 || sa == (int16_t)c1[e]);
                int roff = (int)((e + k) % STRIPE);
                int row_fin = -1, lay = 0;
                if (ok_src) {
                    for (int t = 0; t < STRIPE; t++) {
                        int row = (int)(dst_stripe[e] * STRIPE
                                        + (t + roff) % STRIPE);
                        if (max_row >= 0 && row >= max_row) continue;
                        if (FU_old(p, row, dst_lane[e])) continue;
                        int32_t la = LD_old(0, p, row, m);
                        bool oa = (la == 0 || la == rc[e]);
                        bool ob = false;
                        if (!one_layer) {
                            int32_t lb = LD_old(1, p, row, m);
                            ob = (lb == 0 || lb == rc[e]);
                        }
                        if (oa || ob) {
                            row_fin = row; lay = oa ? 0 : 1; break;
                        }
                    }
                }
                if (row_fin >= 0) {
                    // acceptance against LIVE state (share rules)
                    int16_t sl = SA(p, src_r[e], m);
                    int32_t ll = LD(lay, p, row_fin, m);
                    if ((sl == 0 || sl == (int16_t)c1[e])
                        && (ll == 0 || ll == rc[e])
                        && !FU(p, row_fin, dst_lane[e])) {
                        place(e, m, row_fin, dst_lane[e], lay);
                        continue;
                    }
                }
                next.push_back(e);
            }
            pend.swap(next);
        }
        // tail repair + relax tiers
        for (int64_t e : pend) {
            int64_t p = panel_of[e];
            bool done = for_viable_m(e, [&](int m) {
                int row, ly;
                if (spot_fixed(e, m, row, ly)) {
                    place(e, m, row, dst_lane[e], ly);
                    return true;
                }
                return false;
            });
            if (done) continue;
            // relocate the same-lane blocker
            done = for_viable_m(e, [&](int m) {
                for (int t = 0; t < STRIPE; t++) {
                    int row = (int)(dst_stripe[e] * STRIPE + t);
                    if (max_row >= 0 && row >= max_row) continue;
                    int32_t l0 = LD(0, p, row, m);
                    int ly_e = (l0 == 0 || l0 == rc[e]) ? 0 : -1;
                    if (ly_e < 0 && !one_layer) {
                        int32_t l1 = LD(1, p, row, m);
                        if (l1 == 0 || l1 == rc[e]) ly_e = 1;
                    }
                    if (ly_e < 0) continue;
                    int64_t b = FW(p, row, dst_lane[e]);
                    if (b < 0 || is_fill[b]) continue;
                    bool moved = for_viable_m(b, [&](int m2) {
                        int r2, y2;
                        if (spot_fixed(b, m2, r2, y2)) {
                            FU(p, row, dst_lane[e]) = 0;
                            FW(p, row, dst_lane[e]) = -1;
                            place(b, m2, r2, dst_lane[b], y2);
                            place(e, m, row, dst_lane[e], ly_e);
                            return true;
                        }
                        return false;
                    });
                    if (moved) return true;
                }
                return false;
            });
            if (done) continue;
            if (relax_lane) {
                // last tier: any free final cell of the stripe
                done = for_viable_m(e, [&](int m) {
                    for (int ly = 0; ly < nlayers(); ly++) {
                        for (int t = 0; t < STRIPE; t++) {
                            int row = (int)(dst_stripe[e] * STRIPE + t);
                            if (max_row >= 0 && row >= max_row) continue;
                            int32_t la = LD(ly, p, row, m);
                            if (la != 0 && la != rc[e]) continue;
                            const uint8_t* fu =
                                &final_used[(p * PROWS + row) * LANES];
                            for (int l = 0; l < LANES; l++) {
                                if (!fu[l]) {
                                    place(e, m, row, l, ly);
                                    relaxed++;
                                    return true;
                                }
                            }
                        }
                    }
                    return false;
                });
                if (done) continue;
                // ultimate tier: any row of the panel
                int nrows_all = (max_row >= 0) ? (int)max_row : PROWS;
                done = for_viable_m(e, [&](int m) {
                    for (int ly = 0; ly < nlayers(); ly++) {
                        for (int row = 0; row < nrows_all; row++) {
                            int32_t la = LD(ly, p, row, m);
                            if (la != 0 && la != rc[e]) continue;
                            const uint8_t* fu =
                                &final_used[(p * PROWS + row) * LANES];
                            for (int l = 0; l < LANES; l++) {
                                if (!fu[l]) {
                                    place(e, m, row, l, ly);
                                    relaxed++;
                                    return true;
                                }
                            }
                        }
                    }
                    return false;
                });
                if (done) continue;
            }
            return -1;
        }
        return 0;
    }

    // ---------------- fill phase ----------------
    int fill_free() {
        // pair fills with leftover final cells per (panel, stripe), in
        // stable order (caller constructs fills to match capacity)
        std::vector<std::vector<int64_t>> bucket(npanels * STRIPE);
        for (int64_t e = 0; e < N; e++)
            if (is_fill[e])
                bucket[panel_of[e] * STRIPE + dst_stripe[e]].push_back(e);
        for (int64_t p = 0; p < npanels; p++) {
            for (int s = 0; s < STRIPE; s++) {
                auto& fl = bucket[p * STRIPE + s];
                if (fl.empty()) continue;
                size_t fi = 0;
                for (int t = 0; t < STRIPE && fi < fl.size(); t++) {
                    int row = s * STRIPE + t;
                    for (int l = 0; l < LANES && fi < fl.size(); l++) {
                        if (FU(p, row, l)) continue;
                        int64_t e = fl[fi++];
                        row_of[e] = row; lane_of[e] = l; pick[e] = 0;
                        // probe an m whose landing at row is free/shared
                        bool got = false;
                        for (int k = 0; k < LANES; k++) {
                            int m = (l + k * 11) % LANES;
                            int32_t la = LD(0, p, row, m);
                            if (la == 0 || la == -1) {
                                m_of[e] = m;
                                LD(0, p, row, m) = -1;
                                got = true;
                                break;
                            }
                        }
                        if (!got) return -2;
                        FU(p, row, l) = 1;
                    }
                }
                if (fi < fl.size()) return -2;
            }
        }
        return 0;
    }

    int fill_fixed() {
        std::vector<int64_t> pend, next;
        for (int64_t e = 0; e < N; e++)
            if (is_fill[e]) pend.push_back(e);
        for (int k = 0; k < 4 * LANES && !pend.empty(); k++) {
            round_++;
            next.clear();
            for (int64_t e : pend) {
                int64_t p = panel_of[e];
                int m = (int)((dst_lane[e] + k * 9) % LANES);
                int roff = (int)((e + k) % STRIPE);
                int row_fin = -1, lay = 0;
                for (int t = 0; t < STRIPE; t++) {
                    int row = (int)(dst_stripe[e] * STRIPE
                                    + (t + roff) % STRIPE);
                    if (FU_old(p, row, dst_lane[e])) continue;
                    int32_t la = LD_old(0, p, row, m);
                    int32_t lb = LD_old(1, p, row, m);
                    bool oa = (la == 0 || la == -1);
                    bool ob = (lb == 0 || lb == -1);
                    if (oa || ob) { row_fin = row; lay = oa ? 0 : 1; break; }
                }
                if (row_fin >= 0) {
                    int32_t ll = LD(lay, p, row_fin, m);
                    if ((ll == 0 || ll == -1)
                        && !FU(p, row_fin, dst_lane[e])) {
                        m_of[e] = m; row_of[e] = row_fin;
                        lane_of[e] = dst_lane[e]; pick[e] = lay;
                        LD(lay, p, row_fin, m) = -1;
                        land_ver[((lay * npanels + p) * PROWS + row_fin)
                                 * LANES + m] = round_;
                        FU(p, row_fin, dst_lane[e]) = 1;
                        fu_ver[(p * PROWS + row_fin) * LANES
                               + dst_lane[e]] = round_;
                        continue;
                    }
                }
                next.push_back(e);
            }
            pend.swap(next);
        }
        return pend.empty() ? 0 : -2;
    }
};

}  // namespace

extern "C" long long gt_route_solve(
    const int64_t* src_r, const int64_t* src_c, const int64_t* dst_stripe,
    const int64_t* dst_lane, const int64_t* panel_of,
    long long N, long long npanels, long long src_rows,
    long long fill_from, long long max_row,
    int relax_lane, int one_layer,
    int32_t* m_of, int32_t* row_of, int32_t* lane_of, int32_t* pick_out,
    long long* relaxed_out) {
    Solver s;
    s.src_r = src_r; s.src_c = src_c; s.dst_stripe = dst_stripe;
    s.dst_lane = dst_lane; s.panel_of = panel_of;
    s.N = N; s.npanels = npanels; s.src_rows = src_rows;
    s.fill_from = fill_from; s.max_row = max_row;
    s.relax_lane = relax_lane != 0; s.one_layer = one_layer != 0;
    s.free_lane = (dst_lane == nullptr);
    s.m_of = m_of; s.row_of = row_of; s.lane_of = lane_of;
    s.pick = pick_out;
    s.init();
    int rcode = s.free_lane ? s.solve_free() : s.solve_fixed();
    if (rcode != 0) return rcode;
    rcode = s.free_lane ? s.fill_free() : s.fill_fixed();
    if (rcode != 0) return rcode;
    *relaxed_out = s.relaxed;
    return 0;
}
