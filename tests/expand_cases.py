"""Per-Gaussian columns that probe the expand kernel's block windows: one
Gaussian spanning many 256-slot blocks, every Gaussian at count 0 (one
dummy slot each and a long tail past the total), a total equal to the
capacity, and a total past it. Shared by the CPU tests of the plain
expansion against JAX's oracle and the card tests of the kernel, so it
imports neither JAX nor the JAX package."""
import numpy as np

from cull_rows import AMIN, conics

TILE_H, TILE_W = 8, 32
HEIGHT, WIDTH = 64 * TILE_H, 64 * TILE_W   # a 64 x 64 tile grid
CASES = ("one_spans_many_blocks", "all_count_zero", "total_is_cap",
         "total_past_cap")


def _rects(rng, n, max_side):
    """Random tile rectangles [n] (x0, y0, x1, y1) inside the grid."""
    w = rng.randint(1, max_side + 1, n)
    h = rng.randint(1, max_side + 1, n)
    x0 = rng.randint(0, 64 - w + 1)
    y0 = rng.randint(0, 64 - h + 1)
    return x0, y0, x0 + w, y0 + h


def expand_case(name: str, seed: int = 0):
    """(columns, cap): numpy columns of a Preprocessed as the expansion
    reads them (rmin_x, rmin_y, rmax_x, rmax_y, tiles_touched int32;
    depth, px, py, cxx, cxy, cyy, opacity f32) and the instance capacity.
    Means lie near their rectangles and the conics and opacities (1/255
    and its neighbours among them) make the tile cull keep some instances
    and drop others."""
    rng = np.random.RandomState(seed)
    if name == "one_spans_many_blocks":
        n, cap = 40, 1 << 13
        x0, y0, x1, y1 = _rects(rng, n, 4)
        x0[7], y0[7], x1[7], y1[7] = 2, 5, 62, 55      # 3000 tiles
    elif name == "all_count_zero":
        n, cap = 700, 1 << 10
        x0, y0, x1, y1 = _rects(rng, n, 3)
    elif name in ("total_is_cap", "total_past_cap"):
        n, cap = 500, None
        x0, y0, x1, y1 = _rects(rng, n, 5)
    else:
        raise ValueError(name)
    counts = ((x1 - x0) * (y1 - y0)).astype(np.int64)
    counts[rng.uniform(size=n) < 0.1] = 0           # culled Gaussians
    if name == "one_spans_many_blocks":
        counts[7] = 3000
    if name == "all_count_zero":
        counts[:] = 0
    if cap is None:   # the capacity is the slot total, or 37 short of it
        cap = int(np.maximum(counts, 1).sum()) - \
            (37 if name == "total_past_cap" else 0)
    cx = (x0 + rng.uniform(-0.5, 1.0, n) * (x1 - x0)) * TILE_W
    cy = (y0 + rng.uniform(-0.5, 1.0, n) * (y1 - y0)) * TILE_H
    con = conics(rng, n, lo=0.5, hi=3.5).astype(np.float32)
    op = rng.uniform(AMIN, 1.0, n).astype(np.float32)
    op[::9] = AMIN
    op[1::9] = np.nextafter(AMIN, np.float32(0))
    f32 = lambda a: np.asarray(a, np.float32)
    i32 = lambda a: np.asarray(a, np.int32)
    cols = dict(rmin_x=i32(x0), rmin_y=i32(y0), rmax_x=i32(x1),
                rmax_y=i32(y1), tiles_touched=i32(counts),
                depth=f32(rng.uniform(0.5, 9.0, n)), px=f32(cx), py=f32(cy),
                cxx=con[:, 0], cxy=con[:, 1], cyy=con[:, 2], opacity=op)
    return cols, cap


def preprocessed(cols, preprocessed_cls, flat_cls, asarray):
    """A Preprocessed (of the JAX package or the port: `preprocessed_cls`,
    `flat_cls`, `asarray` name its types) holding `cols`; the fields that
    the expansion does not read are filled consistently."""
    n = cols["depth"].shape[0]
    a = {k: asarray(v) for k, v in cols.items()}
    flat = flat_cls(px=a["px"], py=a["py"], cxx=a["cxx"], cxy=a["cxy"],
                    cyy=a["cyy"], rmin_x=a["rmin_x"], rmin_y=a["rmin_y"],
                    rmax_x=a["rmax_x"], rmax_y=a["rmax_y"])
    means = np.stack([cols["px"], cols["py"]], 1)
    conic = np.stack([cols["cxx"], cols["cxy"], cols["cyy"]], 1)
    rmin = np.stack([cols["rmin_x"], cols["rmin_y"]], 1)
    rmax = np.stack([cols["rmax_x"], cols["rmax_y"]], 1)
    return preprocessed_cls(
        valid=asarray(cols["tiles_touched"] > 0), means2d=asarray(means),
        conic=asarray(conic), depth=a["depth"],
        pos_view=asarray(np.zeros((n, 3), np.float32)),
        radius=asarray(np.where(cols["tiles_touched"] > 0, 3, 0)
                       .astype(np.int32)),
        rect_min=asarray(rmin), rect_max=asarray(rmax),
        tiles_touched=a["tiles_touched"], opacity=a["opacity"], flat=flat)
