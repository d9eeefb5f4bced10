// vello_tpu native host runtime: the scene-encoding hot loop.
//
// Role of the reference's Rust host encoder (vello_encoding/src/path.rs
// PathEncoder state machine): converts verb/point arrays into the packed
// tag/data streams. Exact mirror of the Python PathEncoder in
// vello_tpu/encoding/encoding.py (byte-identical output, tested).
//
// Build: g++ -O2 -shared -fPIC -o libvello_native.so vello_native.cpp

#include <cstdint>
#include <cstring>
#include <cmath>

namespace {

constexpr uint8_t TAG_LINE = 1;
constexpr uint8_t TAG_QUAD = 2;
constexpr uint8_t TAG_CUBIC = 3;
constexpr uint8_t TAG_END_BIT = 0x4;

constexpr uint8_t MOVE_TO = 0;
constexpr uint8_t LINE_TO = 1;
constexpr uint8_t QUAD_TO = 2;
constexpr uint8_t CURVE_TO = 3;
constexpr uint8_t CLOSE = 4;

struct Enc {
    uint8_t* tags;
    float* data;
    int n_tags = 0;
    int n_data = 0;  // floats
    double first_x = 0, first_y = 0;
    double cur_x = 0, cur_y = 0;
    bool start_in_data = false;
    int nsub_segs = 0;
    int n_segments = 0;
    int last_tag_idx = -1;

    void push_pt(double x, double y) {
        data[n_data++] = (float)x;
        data[n_data++] = (float)y;
    }

    void emit(uint8_t kind, const double* pts, int npts) {
        if (kind == TAG_LINE && pts[0] == cur_x && pts[1] == cur_y) return;
        if (!start_in_data) {
            push_pt(cur_x, cur_y);
            first_x = cur_x;
            first_y = cur_y;
            start_in_data = true;
        }
        tags[n_tags++] = kind;
        last_tag_idx = n_tags - 1;
        for (int i = 0; i < npts; i++) push_pt(pts[2 * i], pts[2 * i + 1]);
        cur_x = pts[2 * (npts - 1)];
        cur_y = pts[2 * (npts - 1) + 1];
        nsub_segs++;
        n_segments++;
    }

    void end_subpath(bool close_line) {
        if (nsub_segs == 0) {
            if (start_in_data) {
                n_data -= 2;  // lone moveto
                start_in_data = false;
            }
            return;
        }
        if (close_line && (cur_x != first_x || cur_y != first_y)) {
            double p[2] = {first_x, first_y};
            emit(TAG_LINE, p, 1);
        }
        tags[last_tag_idx] |= TAG_END_BIT;
        nsub_segs = 0;
        start_in_data = false;
    }
};

}  // namespace

extern "C" {

// Returns n_segments. out_tags must hold >= n_verbs + 2 entries; out_data
// >= 2 * (n_points + n_verbs + 2) floats. Sizes written to out_counts[0..1]
// = (n_tags, n_data_floats).
int vn_encode_path(const uint8_t* verbs, int n_verbs, const float* pts,
                   int close_subpaths, uint8_t* out_tags, float* out_data,
                   int* out_counts) {
    Enc e{out_tags, out_data};
    int pi = 0;
    for (int v = 0; v < n_verbs; v++) {
        switch (verbs[v]) {
            case MOVE_TO: {
                e.end_subpath(true);
                e.first_x = pts[pi];
                e.first_y = pts[pi + 1];
                e.cur_x = e.first_x;
                e.cur_y = e.first_y;
                e.push_pt(e.first_x, e.first_y);
                e.start_in_data = true;
                e.nsub_segs = 0;
                pi += 2;
                break;
            }
            case LINE_TO: {
                double p[2] = {pts[pi], pts[pi + 1]};
                if (e.start_in_data || e.nsub_segs || e.n_tags || true) {
                    // cur_pt None only before any moveto; mirror Python guard
                }
                e.emit(TAG_LINE, p, 1);
                pi += 2;
                break;
            }
            case QUAD_TO: {
                double p[4] = {pts[pi], pts[pi + 1], pts[pi + 2],
                               pts[pi + 3]};
                e.emit(TAG_QUAD, p, 2);
                pi += 4;
                break;
            }
            case CURVE_TO: {
                double p[6] = {pts[pi], pts[pi + 1], pts[pi + 2],
                               pts[pi + 3], pts[pi + 4], pts[pi + 5]};
                e.emit(TAG_CUBIC, p, 3);
                pi += 6;
                break;
            }
            case CLOSE: {
                if (e.nsub_segs > 0) {
                    e.end_subpath(true);
                }
                e.cur_x = e.first_x;
                e.cur_y = e.first_y;
                break;
            }
        }
    }
    e.end_subpath(close_subpaths != 0);
    if (e.nsub_segs > 0) {
        out_tags[e.last_tag_idx] |= TAG_END_BIT;
    }
    out_counts[0] = e.n_tags;
    out_counts[1] = e.n_data;
    return e.n_segments;
}

// Encode pre-flattened closed polygons (stroke expansion output): polys is
// a concatenated (sum_n, 2) float array; sizes gives each polygon's point
// count. Every polygon becomes moveto + linetos + close.
int vn_encode_polygons(const float* polys, const int* sizes, int n_polys,
                       uint8_t* out_tags, float* out_data, int* out_counts) {
    Enc e{out_tags, out_data};
    int pi = 0;
    for (int k = 0; k < n_polys; k++) {
        int n = sizes[k];
        if (n >= 2) {
            e.end_subpath(true);
            e.first_x = polys[pi];
            e.first_y = polys[pi + 1];
            e.cur_x = e.first_x;
            e.cur_y = e.first_y;
            e.push_pt(e.first_x, e.first_y);
            e.start_in_data = true;
            e.nsub_segs = 0;
            for (int j = 1; j < n; j++) {
                double p[2] = {polys[pi + 2 * j], polys[pi + 2 * j + 1]};
                e.emit(TAG_LINE, p, 1);
            }
            if (e.nsub_segs > 0) {
                e.end_subpath(true);
                e.cur_x = e.first_x;
                e.cur_y = e.first_y;
            }
        }
        pi += 2 * n;
    }
    e.end_subpath(true);
    out_counts[0] = e.n_tags;
    out_counts[1] = e.n_data;
    return e.n_segments;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Capacity estimator (BumpEstimator analog, estimate.rs role): the exact
// host flatten + touch/live-bound math of encoding/resolve.py::_estimate,
// as flat C++ loops. The numpy version's first call paid seconds of
// allocator first-touch cost on multi-hundred-MB f64 temporaries; this
// streams per line with O(P*ht) workspace.

extern "C" int vn_estimate(
    const float* pts,      // (S,4,2)
    const int* kind,       // (S,)
    const float* tmat,     // (S,6)
    const int* path_ix,    // (S,)
    const float* hw,       // (S,) stroke half-widths, NULL = all fills
    const int* join_flag,  // (S,) 1 = next segment continues the subpath
    int S, int n_paths,
    int wt1, int ht_tiles, // x-tile clamp [0,wt1]; y-tile clamp [0,ht]
    double tile_w, double tile_h,  // pixel tile dims (config.py TILE_W/H)
    double tol, int max_lines,
    long long* out,        // [est_lines, est_touches, est_path_tiles,
                           //  est_live]
    int* rect,             // (n_paths, 4) i32 out
    double* bbox,          // (n_paths, 4) workspace f64
    float* hmin, float* hmax)  // ((n_paths+1) * (ht+1)) workspaces
{
    const double TW = tile_w, TH = tile_h;
    const int ht1 = ht_tiles + 1;
    long long est_lines = 0;
    double est_touches = 0.0;
    for (int p = 0; p < n_paths; ++p) {
        bbox[4 * p + 0] = 1e30; bbox[4 * p + 1] = 1e30;
        bbox[4 * p + 2] = -1e30; bbox[4 * p + 3] = -1e30;
    }
    const long long nk = (long long)(n_paths + 1) * ht1;
    for (long long i = 0; i < nk; ++i) { hmin[i] = 1e9f; hmax[i] = -1e9f; }

    // transform + degree-elevate segment s to a cubic (cx[4], cy[4]);
    // returns false for non-segment rows
    auto cubic_of = [&](int s, double* cx, double* cy) -> bool {
        int k = kind[s];
        if (k < 1 || k > 3) return false;
        const float* q = pts + 8 * s;
        const float* t = tmat + 6 * s;
        double x[4], y[4];
        for (int j = 0; j < 4; ++j) {
            double px = q[2 * j], py = q[2 * j + 1];
            x[j] = px * t[0] + py * t[2] + t[4];
            y[j] = px * t[1] + py * t[3] + t[5];
        }
        if (k == 1) {
            cx[0] = x[0]; cy[0] = y[0]; cx[3] = x[1]; cy[3] = y[1];
            cx[1] = cx[0] + (cx[3] - cx[0]) / 3.0;
            cy[1] = cy[0] + (cy[3] - cy[0]) / 3.0;
            cx[2] = cx[0] + 2.0 / 3.0 * (cx[3] - cx[0]);
            cy[2] = cy[0] + 2.0 / 3.0 * (cy[3] - cy[0]);
        } else if (k == 2) {
            cx[0] = x[0]; cy[0] = y[0]; cx[3] = x[2]; cy[3] = y[2];
            cx[1] = cx[0] + 2.0 / 3.0 * (x[1] - cx[0]);
            cy[1] = cy[0] + 2.0 / 3.0 * (y[1] - cy[0]);
            cx[2] = cx[3] + 2.0 / 3.0 * (x[1] - cx[3]);
            cy[2] = cy[3] + 2.0 / 3.0 * (y[1] - cy[3]);
        } else {
            for (int j = 0; j < 4; ++j) { cx[j] = x[j]; cy[j] = y[j]; }
        }
        return true;
    };

    // unclamped-then-clipped Wang count on an (elevated) cubic
    auto wang_of = [&](const double* cx, const double* cy) -> int {
        double d1x = cx[0] - 2 * cx[1] + cx[2];
        double d1y = cy[0] - 2 * cy[1] + cy[2];
        double d2x = cx[1] - 2 * cx[2] + cx[3];
        double d2y = cy[1] - 2 * cy[2] + cy[3];
        double m = 6.0 * std::fmax(std::hypot(d1x, d1y),
                                   std::hypot(d2x, d2y));
        double nn = std::ceil(std::sqrt(std::fmax(m, 0.0) / (8.0 * tol)));
        int n = (int)nn;
        if (n < 1) n = 1;
        if (n > max_lines) n = max_lines;
        return n;
    };

    // stroke mini count: Wang + turning-angle bound
    // (host_flatten.stroke_mini_counts_np / ops/flatten.stroke_mini_counts)
    auto mini_of = [&](const double* cx, const double* cy,
                       double hwdev) -> int {
        int wang = wang_of(cx, cy);
        double vx[3], vy[3];
        for (int j = 0; j < 3; ++j) {
            vx[j] = cx[j + 1] - cx[j];
            vy[j] = cy[j + 1] - cy[j];
        }
        auto ang = [&](int a, int b) -> double {
            double lu = std::hypot(vx[a], vy[a]);
            double lv = std::hypot(vx[b], vy[b]);
            if (lu <= 1e-12 || lv <= 1e-12) return 0.0;
            double cr = std::fabs(vx[a] * vy[b] - vy[a] * vx[b]);
            double dt = vx[a] * vx[b] + vy[a] * vy[b];
            return std::atan2(cr, dt);
        };
        double dtheta = ang(0, 1) + ang(1, 2);
        double theta_max = std::sqrt(8.0 * tol / std::fmax(hwdev, tol));
        double m_turn = std::ceil(dtheta / theta_max);
        double m = std::fmax((double)wang, m_turn);
        if (m < 1) m = 1;
        if (m > max_lines) m = max_lines;
        return (int)m;
    };

    auto ev = [](const double* cx, const double* cy, double tt,
                 double* ox, double* oy) {
        double mt = 1.0 - tt;
        double a = mt * mt * mt, b = 3 * mt * mt * tt,
               c = 3 * mt * tt * tt, d = tt * tt * tt;
        *ox = a * cx[0] + b * cx[1] + c * cx[2] + d * cx[3];
        *oy = a * cy[0] + b * cy[1] + c * cy[2] + d * cy[3];
    };

    auto hwdev_of = [&](int s) -> double {
        if (!hw) return 0.0;
        const float* t = tmat + 6 * s;
        double det = (double)t[0] * t[3] - (double)t[1] * t[2];
        return (double)hw[s] * std::sqrt(std::fabs(det));
    };

    for (int s = 0; s < S; ++s) {
        double cx[4], cy[4];
        if (!cubic_of(s, cx, cy)) continue;
        const int p = path_ix[s];
        const bool pok = p >= 0 && p < n_paths;

        // shared per-line accumulation (touch spans + path bbox + the
        // per-(path, tile-row) x hull live bound)
        auto accum_line = [&](double px0, double py0,
                              double px1, double py1) {
            double sx0 = px0 / TW, sx1 = px1 / TW;
            double sy0 = py0 / TH, sy1 = py1 / TH;
            double sxmin = sx0 < sx1 ? sx0 : sx1;
            double sxmax = sx0 < sx1 ? sx1 : sx0;
            double symin = sy0 < sy1 ? sy0 : sy1;
            double symax = sy0 < sy1 ? sy1 : sy0;
            double spx = std::ceil(sxmax) - std::floor(sxmin);
            if (spx < 1) spx = 1;
            double spy = std::ceil(symax) - std::floor(symin);
            if (spy < 1) spy = 1;
            est_touches += spx - 1.0 + spy;
            if (!pok) return;
            double* bb = bbox + 4 * p;
            double lxmin = px0 < px1 ? px0 : px1;
            double lxmax = px0 < px1 ? px1 : px0;
            double lymin = py0 < py1 ? py0 : py1;
            double lymax = py0 < py1 ? py1 : py0;
            if (lxmin - 0.5 < bb[0]) bb[0] = lxmin - 0.5;
            if (lymin - 0.5 < bb[1]) bb[1] = lymin - 0.5;
            if (lxmax + 0.5 > bb[2]) bb[2] = lxmax + 0.5;
            if (lymax + 0.5 > bb[3]) bb[3] = lymax + 0.5;
            const double pad = 0.5;
            double ry0d = std::floor(symin - pad / TH);
            double ry1d = std::ceil(symax + pad / TH);
            long long ry0 = (long long)ry0d;
            long long ry1 = (long long)ry1d;
            if (ry0 < 0) ry0 = 0;
            if (ry0 > ht1 - 1) ry0 = ht1 - 1;
            if (ry1 < 1) ry1 = 1;
            if (ry1 > ht1) ry1 = ht1;
            double slo = symin, shi = symax, dy = sy1 - sy0;
            bool horiz = std::fabs(dy) <= 1e-12;
            double inv_dy = horiz ? 0.0 : 1.0 / dy;
            for (long long row = ry0; row < ry1; ++row) {
                double xa, xb;
                if (horiz) {
                    xa = sxmin; xb = sxmax;
                } else {
                    double ya = (double)row;
                    if (ya < slo) ya = slo; if (ya > shi) ya = shi;
                    double yb = (double)row + 1.0;
                    if (yb < slo) yb = slo; if (yb > shi) yb = shi;
                    double ta = (ya - sy0) * inv_dy;
                    double tb = (yb - sy0) * inv_dy;
                    if (ta < 0) ta = 0; if (ta > 1) ta = 1;
                    if (tb < 0) tb = 0; if (tb > 1) tb = 1;
                    xa = sx0 + ta * (sx1 - sx0);
                    xb = sx0 + tb * (sx1 - sx0);
                }
                double padx = pad / TW;
                double kx0 = std::floor((xa < xb ? xa : xb) - padx);
                double kx1 = std::ceil((xa < xb ? xb : xa) + padx);
                if (kx0 < 0) kx0 = 0; if (kx0 > wt1) kx0 = wt1;
                if (kx1 < 0) kx1 = 0; if (kx1 > wt1) kx1 = wt1;
                long long key = (long long)p * ht1 + row;
                if ((float)kx0 < hmin[key]) hmin[key] = (float)kx0;
                if ((float)kx1 > hmax[key]) hmax[key] = (float)kx1;
            }
        };

        double hwdev = hwdev_of(s);
        if (hwdev <= 0.0) {
            // fill: uniform-t polyline of the cubic
            int n = (kind[s] == 1) ? 1 : wang_of(cx, cy);
            est_lines += n;
            double px0 = cx[0], py0 = cy[0];
            for (int i = 1; i <= n; ++i) {
                double px1, py1;
                ev(cx, cy, (double)i / n, &px1, &py1);
                accum_line(px0, py0, px1, py1);
                px0 = px1; py0 = py1;
            }
            continue;
        }

        // device stroke expansion (ops/flatten.stroke_slot_line): 7 lines
        // per centerline mini — offset quad (4 edges) + bevel triangle (3)
        int m = mini_of(cx, cy, hwdev);
        est_lines += 7LL * m;
        // join normal: the NEXT segment's first-chord normal (numpy/device
        // use roll(-1); the wrap row only matters when join is set, which
        // the last segment of a subpath never has)
        double jnx = 0.0, jny = 0.0;
        bool joinf = join_flag && join_flag[s] > 0;
        if (joinf) {
            int sn = (s + 1 < S) ? s + 1 : 0;
            double nx4[4], ny4[4];
            if (cubic_of(sn, nx4, ny4)) {
                int mn = mini_of(nx4, ny4, hwdev_of(sn));
                if (mn < 1) mn = 1;
                double pnx, pny;
                ev(nx4, ny4, 1.0 / mn, &pnx, &pny);
                double chx = pnx - nx4[0], chy = pny - ny4[0];
                double l2j = chx * chx + chy * chy;
                if (l2j > 1e-24) {
                    double kj = hwdev / std::sqrt(l2j);
                    jnx = chy * kj;
                    jny = -chx * kj;
                } else {
                    joinf = false;
                }
            } else {
                joinf = false;
            }
        }
        double p0x = cx[0], p0y = cy[0];
        double p1x, p1y;
        ev(cx, cy, 1.0 / m, &p1x, &p1y);
        for (int i = 0; i < m; ++i) {
            double dx = p1x - p0x, dy = p1y - p0y;
            double l2 = dx * dx + dy * dy;
            bool dead = l2 <= 1e-24;
            double kk = hwdev / std::sqrt(std::fmax(l2, 1e-24));
            double nx = dy * kk, ny = -dx * kk;
            bool inner = i < m - 1;
            double n2x, n2y, p2x = 0, p2y = 0;
            if (inner) {
                ev(cx, cy, (double)(i + 2) / m, &p2x, &p2y);
                double d2x = p2x - p1x, d2y = p2y - p1y;
                double l2b = d2x * d2x + d2y * d2y;
                double kb = hwdev / std::sqrt(std::fmax(l2b, 1e-24));
                n2x = d2y * kb; n2y = -d2x * kb;
            } else {
                n2x = jnx; n2y = jny;
            }
            bool has_tri = (inner || joinf) && l2 > 1e-24;
            double sg = (dx * n2x + dy * n2y >= 0.0) ? 1.0 : -1.0;
            double c1x = p1x + sg * nx, c1y = p1y + sg * ny;
            double c2x = p1x + sg * n2x, c2y = p1y + sg * n2y;
            double t1x = sg > 0 ? c1x : c2x, t1y = sg > 0 ? c1y : c2y;
            double t2x = sg > 0 ? c2x : c1x, t2y = sg > 0 ? c2y : c1y;
            if (!has_tri) { t1x = t2x = p1x; t1y = t2y = p1y; }
            if (dead) {
                // degenerate mini: all 7 slots collapse at p1 (same
                // spans the numpy estimator counts)
                for (int e = 0; e < 7; ++e) accum_line(p1x, p1y, p1x, p1y);
            } else {
                accum_line(p0x + nx, p0y + ny, p1x + nx, p1y + ny);
                accum_line(p1x + nx, p1y + ny, p1x - nx, p1y - ny);
                accum_line(p1x - nx, p1y - ny, p0x - nx, p0y - ny);
                accum_line(p0x - nx, p0y - ny, p0x + nx, p0y + ny);
                accum_line(p1x, p1y, t1x, t1y);
                accum_line(t1x, t1y, t2x, t2y);
                accum_line(t2x, t2y, p1x, p1y);
            }
            p0x = p1x; p0y = p1y;
            if (inner) {
                if (i + 2 == m) { ev(cx, cy, 1.0, &p1x, &p1y); }
                else { p1x = p2x; p1y = p2y; }
            }
        }
    }
    long long est_path_tiles = n_paths;
    for (int p = 0; p < n_paths; ++p) {
        double* bb = bbox + 4 * p;
        bool empty = !(bb[0] <= bb[2]) || bb[0] > 1e29;
        double tx0 = 0, ty0 = 0, tx1 = 0, ty1 = 0;
        if (!empty) {
            tx0 = std::floor(bb[0] / TW); ty0 = std::floor(bb[1] / TH);
            tx1 = std::ceil(bb[2] / TW); ty1 = std::ceil(bb[3] / TH);
            if (tx0 < 0) tx0 = 0; if (tx0 > wt1) tx0 = wt1;
            if (tx1 < 0) tx1 = 0; if (tx1 > wt1) tx1 = wt1;
            if (ty0 < 0) ty0 = 0; if (ty0 > ht_tiles) ty0 = ht_tiles;
            if (ty1 < 0) ty1 = 0; if (ty1 > ht_tiles) ty1 = ht_tiles;
            if (ty1 < ty0) ty1 = ty0;
            if (tx1 < tx0) tx1 = tx0;
        }
        rect[4 * p + 0] = (int)tx0; rect[4 * p + 1] = (int)ty0;
        rect[4 * p + 2] = (int)tx1; rect[4 * p + 3] = (int)ty1;
        double ax = tx1 - tx0, ay = ty1 - ty0;
        if (ax < 0) ax = 0; if (ay < 0) ay = 0;
        est_path_tiles += (long long)(ax * ay);
    }
    double live = 0.0;
    for (long long i = 0; i < (long long)n_paths * ht1; ++i) {
        if (hmax[i] >= hmin[i]) live += (double)(hmax[i] - hmin[i]);
    }
    out[0] = est_lines;
    // Slack covers f32(device)-vs-f64(here) span divergence on lines whose
    // endpoints sit near tile boundaries (<<1%o of lines in practice) plus
    // edge-vertical expansion dummies; the old est_lines/8 blanket inflated
    // every touch-scale device stage by ~8%. Underestimates are safe: the
    // device overflow flag triggers a retry at the next tier.
    out[1] = (long long)est_touches + est_lines / 64 + 512;
    out[2] = est_path_tiles;
    out[3] = (long long)live;
    return 0;
}
