"""Grid visualization: render exported solver grids as PNG slice maps, the
port's copy of ``polystokes_tpu.viz`` (numpy and matplotlib's Agg backend
only, no torch).  Where matplotlib is not installed, ``render_npz`` writes
the same files without it (``_render_plain``: the slices as plain RGB
tiles on the same palettes' anchors, no titles or colorbars).

The observability analog of the reference's printAllData point-cloud
dumps (exec/HDK_PolyStokesSolver.cpp:1031-1268): where the reference
renders every label/region/weight grid as viewable Houdini point clouds,
this renders the same grids (from the npz written by
``export.export_grids`` / ``export.export_solution``, of either package)
as orthogonal slice images — the natural debugging surface for a headless
run.

Usage (CLI)::

    python -m polystokes_tpu_torch.viz out/grids.npz               # all grids, mid-slices
    python -m polystokes_tpu_torch.viz out/grids.npz --axis 0 --index 40
    python -m polystokes_tpu_torch.viz out/solution.npz --out dir/

Label grids (``*_labels``) render with a fixed categorical palette
(matching classify.py's label enum), region grids with a cyclic palette
over region ids, and float grids (weights, solution fields, residuals)
with a signed/unsigned colormap picked from the data range.
"""
from __future__ import annotations

import argparse
import os
import struct
import zlib

import numpy as np

# classify.py label enum order: UNLABELED, LIQUID/ACTIVE, REDUCED, BOUNDARY,
# SOLID, AIR (values there are small ints; palette indexed by value)
_LABEL_COLORS = [
    (0.92, 0.92, 0.92),  # 0 unlabeled / outside
    (0.22, 0.49, 0.72),  # 1 active
    (0.89, 0.47, 0.20),  # 2 reduced / interior
    (0.30, 0.69, 0.29),  # 3 boundary
    (0.40, 0.40, 0.40),  # 4 solid
    (0.97, 0.93, 0.58),  # 5 air
    (0.60, 0.31, 0.64),  # 6+
    (0.85, 0.37, 0.56),
]


def _slice(arr: np.ndarray, axis: int, index: int | None):
    if index is None:
        index = arr.shape[axis] // 2
    index = int(np.clip(index, 0, arr.shape[axis] - 1))
    return np.take(arr, index, axis=axis), index


def render_grid(ax, name: str, sl: np.ndarray):
    """Render one 2-D slice onto a matplotlib axes with a style picked by
    the grid kind (labels / regions / float fields)."""
    from matplotlib.colors import ListedColormap

    if name.endswith("_labels"):
        n = len(_LABEL_COLORS)
        img = ax.imshow(
            sl.T, origin="lower", interpolation="nearest",
            cmap=ListedColormap(_LABEL_COLORS), vmin=-0.5, vmax=n - 0.5,
        )
    elif name.endswith("_region"):
        vis = np.where(sl >= 0, sl % 20, np.nan)
        img = ax.imshow(vis.T, origin="lower", interpolation="nearest", cmap="tab20", vmin=-0.5, vmax=19.5)
    else:
        s = sl.astype(np.float64)
        finite = s[np.isfinite(s)]
        lim = float(np.max(np.abs(finite))) if finite.size else 1.0
        lim = lim if lim > 0 else 1.0
        if finite.size and float(np.min(finite)) < 0:
            img = ax.imshow(s.T, origin="lower", interpolation="nearest", cmap="RdBu_r", vmin=-lim, vmax=lim)
        else:
            img = ax.imshow(s.T, origin="lower", interpolation="nearest", cmap="viridis", vmin=0, vmax=lim)
    ax.set_title(name, fontsize=8)
    ax.set_xticks([])
    ax.set_yticks([])
    return img


def render_npz(
    path: str,
    out_dir: str | None = None,
    axis: int = 2,
    index: int | None = None,
    names: list[str] | None = None,
    per_grid: bool = False,
) -> list[str]:
    """Render every (or the named) 3-D grids in an exported npz to PNG.

    Returns the list of files written.  By default one contact-sheet PNG
    per npz; ``per_grid`` writes one PNG per grid instead."""
    data = np.load(path)
    keys = [k for k in data.files if data[k].ndim == 3]
    if names:
        keys = [k for k in keys if any(n in k for n in names)]
    if not keys:
        raise ValueError(f"{path}: no 3-D grids to render (available: {data.files})")
    out_dir = out_dir or os.path.dirname(path) or "."
    os.makedirs(out_dir, exist_ok=True)
    stem = os.path.splitext(os.path.basename(path))[0]
    try:
        import matplotlib
    except ImportError:
        return _render_plain(data, keys, out_dir, stem, axis, index, per_grid)
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    written = []

    if per_grid:
        for k in keys:
            sl, idx = _slice(data[k], axis, index)
            fig, ax = plt.subplots(figsize=(5, 5), dpi=150)
            im = render_grid(ax, k, sl)
            fig.colorbar(im, ax=ax, shrink=0.8)
            fig.suptitle(f"{stem}:{k}  axis={axis} slice={idx}", fontsize=9)
            f = os.path.join(out_dir, f"{stem}_{k}_a{axis}.png")
            fig.savefig(f, bbox_inches="tight")
            plt.close(fig)
            written.append(f)
        return written

    ncol = min(4, len(keys))
    nrow = -(-len(keys) // ncol)
    fig, axes = plt.subplots(nrow, ncol, figsize=(3.2 * ncol, 3.4 * nrow), dpi=130, squeeze=False)
    idx_used = None
    for ax_i, k in enumerate(keys):
        sl, idx_used = _slice(data[k], axis, index)
        render_grid(axes[ax_i // ncol][ax_i % ncol], k, sl)
    for j in range(len(keys), nrow * ncol):
        axes[j // ncol][j % ncol].axis("off")
    fig.suptitle(f"{stem}  axis={axis} slice={idx_used}", fontsize=10)
    f = os.path.join(out_dir, f"{stem}_a{axis}.png")
    fig.savefig(f, bbox_inches="tight")
    plt.close(fig)
    return [f]


# anchors of the palettes for the plain renderer: matplotlib's tab20 and
# the ends and middle of RdBu_r and viridis, interpolated linearly
_TAB20 = [(0.12, 0.47, 0.71), (0.68, 0.78, 0.91), (1.00, 0.50, 0.05), (1.00, 0.73, 0.47), (0.17, 0.63, 0.17),
          (0.60, 0.87, 0.54), (0.84, 0.15, 0.16), (1.00, 0.60, 0.59), (0.58, 0.40, 0.74), (0.77, 0.69, 0.84),
          (0.55, 0.34, 0.29), (0.77, 0.61, 0.58), (0.89, 0.47, 0.76), (0.97, 0.71, 0.82), (0.50, 0.50, 0.50),
          (0.78, 0.78, 0.78), (0.74, 0.74, 0.13), (0.86, 0.86, 0.55), (0.09, 0.75, 0.81), (0.62, 0.85, 0.90)]
_RDBU_R = [(0.02, 0.19, 0.38), (0.97, 0.97, 0.97), (0.40, 0.00, 0.12)]
_VIRIDIS = [(0.27, 0.00, 0.33), (0.23, 0.32, 0.55), (0.13, 0.57, 0.55), (0.37, 0.79, 0.38), (0.99, 0.91, 0.14)]
_BLANK = (1.0, 1.0, 1.0)


def _ramp(t, anchors):
    """t in [0, 1] -> RGB along the anchors, linearly."""
    a = np.asarray(anchors)
    u = np.clip(t, 0.0, 1.0) * (len(a) - 1)
    i = np.minimum(u.astype(int), len(a) - 2)
    f = (u - i)[..., None]
    return a[i] * (1.0 - f) + a[i + 1] * f


def _colors(name: str, sl: np.ndarray) -> np.ndarray:
    """One slice -> [rows, cols, 3] RGB in [0, 1], styled as render_grid
    styles it (rows: the second axis, top row last, as origin="lower")."""
    if name.endswith("_labels"):
        rgb = np.asarray(_LABEL_COLORS)[np.clip(sl.astype(int), 0, len(_LABEL_COLORS) - 1)]
    elif name.endswith("_region"):
        ids = sl.astype(int)
        rgb = np.where((ids >= 0)[..., None], np.asarray(_TAB20)[ids % 20], _BLANK)
    else:
        s = sl.astype(np.float64)
        finite = s[np.isfinite(s)]
        lim = float(np.max(np.abs(finite))) if finite.size else 1.0
        lim = lim if lim > 0 else 1.0
        if finite.size and float(np.min(finite)) < 0:
            rgb = _ramp((s + lim) / (2 * lim), _RDBU_R)
        else:
            rgb = _ramp(s / lim, _VIRIDIS)
        rgb = np.where(np.isfinite(s)[..., None], rgb, _BLANK)
    return rgb.transpose(1, 0, 2)[::-1]


def _tile(rgb: np.ndarray, min_px: int = 128) -> np.ndarray:
    """Upscale by an integer factor to at least ``min_px`` on the longer side."""
    k = max(1, -(-min_px // max(rgb.shape[:2])))
    return np.repeat(np.repeat(rgb, k, axis=0), k, axis=1)


def _write_png(path: str, rgb: np.ndarray):
    """[rows, cols, 3] floats in [0, 1] -> an 8-bit RGB PNG (zlib only)."""
    img = np.ascontiguousarray(np.round(np.clip(rgb, 0.0, 1.0) * 255).astype(np.uint8))
    h, w = img.shape[:2]
    raw = b"".join(b"\x00" + img[r].tobytes() for r in range(h))

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def _render_plain(data, keys, out_dir, stem, axis, index, per_grid) -> list[str]:
    """render_npz without matplotlib: the same files, each slice a plain
    tile (contact sheets: 4 columns, a white gutter)."""
    tiles = {k: _tile(_colors(k, _slice(data[k], axis, index)[0])) for k in keys}
    if per_grid:
        written = []
        for k, t in tiles.items():
            f = os.path.join(out_dir, f"{stem}_{k}_a{axis}.png")
            _write_png(f, t)
            written.append(f)
        return written
    ncol = min(4, len(keys))
    nrow = -(-len(keys) // ncol)
    gap = 4
    th = max(t.shape[0] for t in tiles.values())
    tw = max(t.shape[1] for t in tiles.values())
    sheet = np.ones((nrow * (th + gap) + gap, ncol * (tw + gap) + gap, 3))
    for i, t in enumerate(tiles.values()):
        r, c = gap + (i // ncol) * (th + gap), gap + (i % ncol) * (tw + gap)
        sheet[r:r + t.shape[0], c:c + t.shape[1]] = t
    f = os.path.join(out_dir, f"{stem}_a{axis}.png")
    _write_png(f, sheet)
    return [f]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("npz", help="grids.npz / solution.npz / residuals npz from export.py")
    ap.add_argument("--out", default=None, help="output directory (default: beside the npz)")
    ap.add_argument("--axis", type=int, default=2, choices=[0, 1, 2])
    ap.add_argument("--index", type=int, default=None, help="slice index (default: middle)")
    ap.add_argument("--grids", nargs="*", default=None, help="substring filter on grid names")
    ap.add_argument("--per-grid", action="store_true", help="one PNG per grid with a colorbar")
    args = ap.parse_args(argv)
    for f in render_npz(args.npz, args.out, args.axis, args.index, args.grids, args.per_grid):
        print(f)


if __name__ == "__main__":
    main()
