"""Synthetic inputs of the occlusion walk's starts (``occlusion_los``): the
edge cases that the plain version, the JAX package's ``occlusion_los`` and
the CUDA kernel must agree on, and an independent reverse walk per tile.

A case is built from one string of fragment kinds per tile, bottom to top:

- ``F`` opaque, every value 1.0 (a full cover);
- ``P`` opaque, partial coverage;
- ``T`` not opaque, every value 1.0;
- ``Q`` not opaque, partial coverage;
- ``S`` opaque, full but for one value of 0.999 past the row's first 32;
- ``s`` opaque, full but for one value of 0.999 among the first 32;
- ``L`` opaque, full but for one value at the f32 just below the threshold;
- ``E`` opaque, full with one value exactly at the threshold;
- ``U`` opaque, full with one value at the f32 just above the threshold;
- ``N`` opaque, full but for one NaN;
- ``I`` opaque, full with one value +inf.
"""

import numpy as np

# the f32 value torch compares an f32 tensor against for >= 1.0 - 1e-6
THR = np.float32(1.0 - 1e-6)
BELOW = np.nextafter(THR, np.float32(0.0))
ABOVE = np.nextafter(THR, np.float32(2.0))


def _row(kind, rng):
    full = np.ones(256, np.float32)
    if kind in "FT":
        return full, kind == "F"
    if kind in "PQ":
        row = rng.uniform(0.0, 1.0, 256).astype(np.float32)
        row[rng.uniform(size=256) < 0.5] = 1.0
        return row, kind == "P"
    pos = int(rng.integers(0, 32)) if kind == "s" else int(
        rng.integers(32, 256))
    full[pos] = {"S": 0.999, "s": 0.999, "L": BELOW, "E": THR, "U": ABOVE,
                 "N": np.nan, "I": np.inf}[kind]
    return full, True


def build(tiles, seed=0, tail=""):
    """(g_s (F,) i32 sorted, cov (F, 256) f32, opaque (F,) bool, n_loc,
    starts (n_loc + 1,) i32) of one kind string per tile, and ``tail``,
    rows past the last tile (g_s == n_loc: culled, or outside a stripe)."""
    rng = np.random.default_rng(seed)
    n_loc = len(tiles)
    g, rows, opq = [], [], []
    for t, kinds in enumerate(list(tiles) + [tail]):
        for k in kinds:
            row, o = _row(k, rng)
            g.append(t)
            rows.append(row)
            opq.append(o)
    g_s = np.asarray(g, np.int32)
    cov = (np.stack(rows) if rows else np.zeros((0, 256), np.float32))
    starts = np.searchsorted(g_s, np.arange(n_loc + 1),
                             side="left").astype(np.int32)
    return g_s, cov, np.asarray(opq, bool), n_loc, starts


def _random_tiles(rng, n, depth, kinds):
    return ["".join(rng.choice(list(kinds), int(rng.integers(0, depth))))
            for _ in range(n)]


def cases():
    """name -> build(...) of every synthetic edge case."""
    rng = np.random.default_rng(23)
    window = "PPFPFFPP" + "PPPPPPPP"          # several covers in a window
    return {
        "no_fragments": build(["", "", "", ""]),
        "one_tile": build(["PFPPQ"]),
        "empty_tiles": build(["", "PFP", "", "", "F", "", "QQ", ""]),
        "no_occluder": build(["PPPP", "QTQT", "PSsLN", "T" * 20]),
        "occluder_bottom": build(["F" + "P" * 20, "FQQQ", "F"]),
        "occluder_top": build(["P" * 20 + "F", "QQQF", "PF"]),
        "occluder_middle": build(["P" * 9 + "F" + "P" * 9,
                                  "PPPF" + "Q" * 13, "P" * 17 + "F" + "PP"]),
        "window_covers": build([window, "FFFFFFFF", "F" * 16, "P" + window,
                                "FF" + "P" * 7 + "FF"]),
        "one_value_short": build(["FSPP", "FsPP", "FSsS", "F" + "S" * 9]),
        "nan": build(["FN", "NF" + "N" * 7, "NNNN", "FQN"]),
        "threshold_neighbours": build(["FL", "FE", "FU", "FI", "LE",
                                       "EL", "UL", "L" * 10]),
        "stripe_tail": build(["PFP", "PPP", "FP"], tail="FFFFPF"),
        "deep_tile": build(["F" + "P" * 10400 + "FPPP" + "P" * 5,
                            "PF"], seed=1),
        "deep_tile_bottom": build(["P" * 10050, "F" + "P" * 10020],
                                  seed=2),
        "random": build(_random_tiles(rng, 300, 40, "FPPPPQQTSsLEUN"),
                        seed=3, tail="FFPF"),
    }


def walk(cov, opaque, starts):
    """Each tile's start by a reverse walk: from the tile's top fragment
    down to the first that is opaque with every value >= THR."""
    los = []
    for t in range(len(starts) - 1):
        lo, j = int(starts[t]), int(starts[t + 1]) - 1
        while j >= lo and not (opaque[j] and np.all(cov[j] >= THR)):
            j -= 1
        los.append(j if j >= lo else lo)
    return np.asarray(los, np.int32)
