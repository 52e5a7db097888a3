"""Device-resident frame pipeline — steady-state frames ship ~1 KB.

The packed path in `rasterizer.py` re-quantizes and re-bins the whole
scene every frame (~2.6 ms host) and re-uploads ~75 KB to the device.
This pipeline exploits what is actually true of an interactive GUI frame
stream: between consecutive frames almost nothing changes.

  * **Chrome** (per-layer static command prefix — everything except
    scroll windows and `El.volatile` commands) is content-addressed: a
    byte-hash of the used prefix keys a cache of device-resident,
    dequantized command tables, tile bins, and z-segment bounds. A pure
    scroll frame hits this cache and ships NOTHING for chrome.
  * **Scroll windows** stay device-resident in window-relative
    coordinates (as before), but their tile bins are now precomputed in
    WINDOW space as "pair bins": P[a] lists, in submission order, every
    command intersecting window rows [a, a+2) of TILE_H. A screen tile
    row covering window span [y, y+TILE_H) ⊂ [64a, 64(a+2)) gathers
    P[a] ON DEVICE from the scroll offset uniform — no per-frame host
    binning, merging, or sorting. Conservative slots (commands in the
    pair span but not this tile) composite with coverage 0, which is an
    exact no-op, so paint order and pixels are bit-identical to inline
    splicing.
  * **Z-order across chrome and windows** uses the prefix property of
    submission-ordered bins: chrome commands with index < a window's
    stream position form a per-tile PREFIX of the chrome bins, so each
    window split is just a per-tile (lo, hi) bound pair — computed once
    per chrome content, cached on device.
  * **Volatile commands** (scroll thumbs — the layer's dynamic tail,
    see El.volatile) and per-window (dx, dy, clip) uniforms are the only
    per-frame upload, fused into one small i16 array.

Everything renders through the same per-tile compositing as the
single-shot path (`render_blocks_planar`: the Pallas kernel on the GPU,
the XLA scan elsewhere), so pixel output is bit-identical across paths;
tests/test_frame_cache.py and tests/test_window_residency.py assert it.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from . import rasterizer as R
from .scene import Scene

TILE_H = R.TILE_H
TILE_W = R.TILE_W

_CLS_NAMES = (("shapes", "shape_clips"),
              ("glyphs", "glyph_colors", "glyph_clips"),
              ("images", "image_clips"))
_CLS_KCAP = (R.K_SHAPES, R.K_GLYPHS, R.K_IMAGES)

# part name -> class index (0 shapes, 1 glyphs, 2 images) in _PART_SPECS
_PART_CLS = {"shapes": 0, "shape_clips": 0, "glyphs": 1, "glyph_colors": 1,
             "glyph_clips": 1, "images": 2, "image_clips": 2}


def _quant_parts_blob(arrays: dict, used: dict, caps: dict) -> np.ndarray:
    """Quantize command parts to one i16 blob (same fixed-point spec as
    rasterizer._PART_SPECS, so pixels stay bit-identical to the packed
    path)."""
    parts = []
    for name, cols, scale in R._PART_SPECS:
        arr = arrays[name]
        s = R._part_scale(name, cols, scale)
        q = np.zeros((caps[name], cols), np.int16)
        nu = used[name]
        if nu:
            q[:nu] = np.clip(np.rint(arr[:nu] * s), -32767.0, 32767.0)
        parts.append(q.ravel())
    return np.concatenate(parts)


@functools.partial(jax.jit, static_argnames=("caps",))
def _dequant_parts(blob_i16, caps: tuple):
    """i16 blob → 7 f32 command tables (device, one-time per content).
    Jitted wrapper over the ONE traced body (_dequant_parts_traced)."""
    return _dequant_parts_traced(blob_i16, caps)


def _shift_parts(parts: tuple, dx, dy, clip):
    """Window-relative f32 tables → screen coords (traced, per frame).
    Same math as rasterizer._unpack_window minus the dequantization."""
    shapes, shape_clips, glyphs, glyph_colors, glyph_clips, images, \
        image_clips = parts
    c0, c1, c2, c3 = clip
    if shapes.shape[0]:
        seg = (shapes[:, 0] == 1.0)
        shapes = jnp.concatenate([
            shapes[:, 0:1],
            shapes[:, 1:2] + dx, shapes[:, 2:3] + dy,
            shapes[:, 3:4] + jnp.where(seg, dx, 0.0)[:, None],
            shapes[:, 4:5] + jnp.where(seg, dy, 0.0)[:, None],
            shapes[:, 5:]], axis=1)
        shape_clips = R._shift_clips_dev(shape_clips, dx, dy, c0, c1, c2, c3)
    if glyphs.shape[0]:
        glyphs = jnp.concatenate([glyphs[:, 0:1] + dx, glyphs[:, 1:2] + dy,
                                  glyphs[:, 2:]], axis=1)
        glyph_clips = R._shift_clips_dev(glyph_clips, dx, dy, c0, c1, c2, c3)
    if images.shape[0]:
        images = jnp.concatenate([images[:, 0:1] + dx, images[:, 1:2] + dy,
                                  images[:, 2:]], axis=1)
        image_clips = R._shift_clips_dev(image_clips, dx, dy, c0, c1, c2, c3)
    return (shapes, shape_clips, glyphs, glyph_colors, glyph_clips,
            images, image_clips)


# ---------------------------------------------------------------------------
# Window pair bins (window-space, dy-independent).
# ---------------------------------------------------------------------------

_WIN_PARTS_DEV: dict = {}   # (uid, caps) -> 7 device f32 tables
_WIN_PAIR_DEV: dict = {}    # (uid, ci, caps, dxq, clipq, tiles_x) -> entry


def _pair_bins(boxes: np.ndarray, dx: float, clip: tuple, tiles_x: int,
               kcap: int, hw_key) -> dict | None:
    """Precompute window-space pair bins: P[a] = window-local indices of
    every command whose effective box intersects window span
    [a·TILE_H, (a+2)·TILE_H), in submission order, scattered per screen
    tile column (dx is scroll-stable). Returns None when nothing lands
    on screen."""
    n = boxes.shape[0]
    if n == 0:
        return None
    x0 = np.maximum(boxes[:, 0] + dx, clip[0])
    x1 = np.minimum(boxes[:, 2] + dx, clip[2])
    y0, y1 = boxes[:, 1], boxes[:, 3]
    keep = (x1 >= x0) & (y1 >= y0)
    if not keep.any():
        return None
    idx = np.arange(n, dtype=np.int64)[keep]
    tx0 = np.clip((x0[keep] // TILE_W).astype(np.int64), 0, tiles_x - 1)
    tx1 = np.clip((x1[keep] // TILE_W).astype(np.int64), 0, tiles_x - 1)
    b0 = np.floor(y0[keep] / TILE_H).astype(np.int64)
    b1 = np.floor(y1[keep] / TILE_H).astype(np.int64)
    # Command occupies pair rows a ∈ [b0-1, b1].
    a0, a1 = b0 - 1, b1
    row0 = int(a0.min())
    a0 -= row0
    a1 -= row0
    WR = int(a1.max()) + 1
    sx = tx1 - tx0 + 1
    sy = a1 - a0 + 1
    reps = sx * sy
    total = int(reps.sum())
    cmds = np.repeat(idx, reps)
    offs = np.arange(total, dtype=np.int64) - np.repeat(
        np.cumsum(reps) - reps, reps)
    rsx = np.repeat(sx, reps)
    dyy, dxx = offs // rsx, offs % rsx
    cells = ((np.repeat(a0, reps) + dyy) * tiles_x
             + np.repeat(tx0, reps) + dxx)
    ncells = WR * tiles_x
    order = np.argsort(cells, kind="stable")  # keeps submission order
    cells, cmds = cells[order], cmds[order]
    counts = np.bincount(cells, minlength=ncells)
    starts = np.concatenate(([0], np.cumsum(counts[:-1])))
    rank = np.arange(len(cells)) - starts[cells]
    kP = R._k_trim(int(counts.max()), kcap)
    fit = rank < kP
    P = np.full((ncells, kP), -1, np.int32)
    P[cells[fit], rank[fit]] = cmds[fit].astype(np.int32)
    return {"P": P.reshape(WR, tiles_x, kP),
            "counts": np.minimum(counts, kP).astype(np.int32)
            .reshape(WR, tiles_x),
            "row0": row0, "WR": WR, "kP": kP}


_WR_HW: dict = {}


def _wr_bucket(wr: int, hw_key) -> int:
    """Pad the pair-bin row count to a stable bucket so it can live in the
    jit signature without retracing when the visible row set changes."""
    cap = 8
    while cap < wr:
        cap *= 2
    cap = max(cap, _WR_HW.get(hw_key, 0))
    _WR_HW[hw_key] = cap
    return cap


def _win_pair_entry(uid: int, ci: int, caps: tuple, boxes: np.ndarray,
                    dx: float, clip: tuple, tiles_x: int):
    key = (uid, ci, caps, round(dx * 8.0),
           tuple(round(c * 4.0) for c in clip), tiles_x)
    hit = _WIN_PAIR_DEV.get(key)
    if hit is not None:
        return hit
    pb = _pair_bins(boxes, dx, clip, tiles_x, _CLS_KCAP[ci],
                    ("pair", ci, caps))
    if pb is not None:
        # Pad rows to a bucketed capacity: WR and row0 are CONTENT-
        # dependent, so they ride the frame uniforms (traced), not meta.
        wr_cap = _wr_bucket(pb["WR"], (ci, caps, tiles_x))
        P = np.zeros((wr_cap,) + pb["P"].shape[1:], np.int32)
        P[:pb["WR"]] = pb["P"]
        counts = np.zeros((wr_cap, tiles_x), np.int32)
        counts[:pb["WR"]] = pb["counts"]
        pb = {"P": jnp.asarray(P), "counts": jnp.asarray(counts),
              "row0": pb["row0"], "WR": pb["WR"], "kP": pb["kP"],
              "wr_cap": wr_cap}
    while len(_WIN_PAIR_DEV) > 48:
        _WIN_PAIR_DEV.pop(next(iter(_WIN_PAIR_DEV)))
    _WIN_PAIR_DEV[key] = pb
    return pb


def _win_parts(uid: int, caps: tuple, blob: np.ndarray):
    key = (uid, caps)
    hit = _WIN_PARTS_DEV.get(key)
    if hit is None:
        while len(_WIN_PARTS_DEV) > 32:
            _WIN_PARTS_DEV.pop(next(iter(_WIN_PARTS_DEV)))
        hit = _dequant_parts(jnp.asarray(blob), caps)
        _WIN_PARTS_DEV[key] = hit
    return hit


# ---------------------------------------------------------------------------
# Chrome cache (content-addressed device residency).
# ---------------------------------------------------------------------------

_CHROME_CACHE: dict = {}


def _chrome_entry(lb, li: int, pos_lists: tuple, tiles_y: int,
                  tiles_x: int):
    """Device-resident chrome for one layer: dequantized tables, per-class
    tile bins, and per-window-split segment bounds. Keyed by the BYTES of
    the static command prefix — a pure scroll frame hits this outright."""
    ns = lb.n_shapes - lb.n_dyn_shapes
    ng = lb.n_glyphs - lb.n_dyn_glyphs
    ni = lb.n_images - lb.n_dyn_images
    caps = (lb.shapes.shape[0], lb.glyphs.shape[0], lb.images.shape[0])
    if ns == 0 and ng == 0 and ni == 0:
        key = ("empty", li, caps, pos_lists, tiles_y, tiles_x)
    else:
        key = (li, caps, pos_lists, tiles_y, tiles_x, ns, ng, ni,
               hash(lb.shapes[:ns].tobytes()),
               hash(lb.shape_clips[:ns].tobytes()),
               hash(lb.glyphs[:ng].tobytes()),
               hash(lb.glyph_colors[:ng].tobytes()),
               hash(lb.glyph_clips[:ng].tobytes()),
               hash(lb.images[:ni].tobytes()),
               hash(lb.image_clips[:ni].tobytes()))
    hit = _CHROME_CACHE.get(key)
    if hit is not None:
        return hit
    arrays = {"shapes": lb.shapes, "shape_clips": lb.shape_clips,
              "glyphs": lb.glyphs, "glyph_colors": lb.glyph_colors,
              "glyph_clips": lb.glyph_clips, "images": lb.images,
              "image_clips": lb.image_clips}
    used = {"shapes": ns, "shape_clips": ns, "glyphs": ng,
            "glyph_colors": ng, "glyph_clips": ng, "images": ni,
            "image_clips": ni}
    cap_of = {"shapes": caps[0], "shape_clips": caps[0],
              "glyphs": caps[1], "glyph_colors": caps[1],
              "glyph_clips": caps[1], "images": caps[2],
              "image_clips": caps[2]}
    blob = _quant_parts_blob(arrays, used, cap_of)
    parts = _dequant_parts(jnp.asarray(blob), caps)
    boxes = (R._intersect_boxes(R._shape_boxes(lb.shapes, ns),
                                lb.shape_clips[:ns]),
             R._intersect_boxes(R._quad_boxes(lb.glyphs, ng),
                                lb.glyph_clips[:ng]),
             R._intersect_boxes(R._quad_boxes(lb.images, ni),
                                lb.image_clips[:ni]))
    counts_n = (ns, ng, ni)
    bins_dev, segs_dev, ks, seg_totals = [], [], [], []
    for ci in range(3):
        nc = counts_n[ci]
        if nc == 0:
            bins_dev.append(None)
            segs_dev.append(None)
            ks.append(0)
            seg_totals.append(None)
            continue
        bins, _ = R._bin_indexed(boxes[ci], np.arange(nc, dtype=np.int64),
                                 tiles_y, tiles_x, _CLS_KCAP[ci])
        valid = bins >= 0
        total = valid.sum(axis=1).astype(np.int32)
        # Segment bounds: entries per tile are ascending (submission
        # order), so "index < pos" is a per-tile prefix.
        rows = [np.zeros_like(total)]
        for pos in pos_lists[ci]:
            rows.append((valid & (bins < pos)).sum(axis=1)
                        .astype(np.int32))
        rows.append(total)
        seg = np.stack(rows)  # (S+2, T)
        bins_dev.append(jnp.asarray(bins))
        segs_dev.append(jnp.asarray(seg))
        ks.append(bins.shape[1])
        # host-side per-segment totals so the compose path can skip empty
        # chrome segments without a device readback
        seg_totals.append(tuple(
            int((seg[si + 1] - seg[si]).sum())
            for si in range(seg.shape[0] - 1)))
    # Per-(class, segment) pixel bounding boxes (command boxes already
    # carry the AA pad): lets the compose path crop chrome group layers
    # to their ink instead of blending full-frame transparency.
    seg_boxes = []
    for ci in range(3):
        nc = counts_n[ci]
        if nc == 0:
            seg_boxes.append(None)
            continue
        bounds = [0] + [min(int(p), nc) for p in pos_lists[ci]] + [nc]
        per_seg = []
        for si in range(len(bounds) - 1):
            b = boxes[ci][bounds[si]:bounds[si + 1]]
            b = b[(b[:, 2] > b[:, 0]) & (b[:, 3] > b[:, 1])]
            per_seg.append(None if b.shape[0] == 0 else
                           (float(b[:, 0].min()), float(b[:, 1].min()),
                            float(b[:, 2].max()), float(b[:, 3].max())))
        seg_boxes.append(tuple(per_seg))
    entry = {"parts": parts, "bins": tuple(bins_dev),
             "segs": tuple(segs_dev), "ks": tuple(ks), "caps": caps,
             "counts": counts_n, "key": key,
             "seg_totals": tuple(seg_totals),
             "seg_boxes": tuple(seg_boxes)}
    while len(_CHROME_CACHE) > 24:
        _CHROME_CACHE.pop(next(iter(_CHROME_CACHE)))
    _CHROME_CACHE[key] = entry
    return entry


# ---------------------------------------------------------------------------
# Dynamic tail (per-frame, tiny).
# ---------------------------------------------------------------------------

_DYN_HW: dict = {}


def _dyn_bucket(n: int, hw_key) -> int:
    if n == 0 and not _DYN_HW.get(hw_key):
        return 0
    cap = 8
    while cap < n:
        cap *= 2
    cap = max(cap, _DYN_HW.get(hw_key, 0))
    _DYN_HW[hw_key] = cap
    return cap


def _dyn_layer(lb, li: int, tiles_y: int, tiles_x: int,
               subgrid: bool = False):
    """Quantized dynamic-tail parts + per-frame bins for one layer.
    Returns (blob_i16, bins_i16 flat, meta) — meta = (caps3, ks3, c0, c1)
    where [c0, c1) is the tile-COLUMN range the bins cover. With
    `subgrid` (compose path, single chip) that range shrinks to the
    columns the commands' boxes touch — a scrollbar thumb occupies a
    fixed column while it moves, so the range (and the jit meta keyed on
    it) stays stable across a scroll while the per-frame render/blend
    touches ~1 column instead of the frame. Without `subgrid` (classic
    path, mesh path) the range is the full grid — bins layout unchanged."""
    nds, ndg, ndi = lb.n_dyn_shapes, lb.n_dyn_glyphs, lb.n_dyn_images
    s0, g0, i0 = (lb.n_shapes - nds, lb.n_glyphs - ndg, lb.n_images - ndi)
    caps = (_dyn_bucket(nds, (li, 0)), _dyn_bucket(ndg, (li, 1)),
            _dyn_bucket(ndi, (li, 2)))
    if sum(caps) == 0:
        return (np.zeros(0, np.int16), np.zeros(0, np.int16),
                ((0, 0, 0), (0, 0, 0), 0, tiles_x))
    arrays = {"shapes": lb.shapes[s0:s0 + nds],
              "shape_clips": lb.shape_clips[s0:s0 + nds],
              "glyphs": lb.glyphs[g0:g0 + ndg],
              "glyph_colors": lb.glyph_colors[g0:g0 + ndg],
              "glyph_clips": lb.glyph_clips[g0:g0 + ndg],
              "images": lb.images[i0:i0 + ndi],
              "image_clips": lb.image_clips[i0:i0 + ndi]}
    used = {n: arrays[n].shape[0] for n in arrays}
    cap_of = {n: caps[_PART_CLS[n]] for n in arrays}
    blob = _quant_parts_blob(arrays, used, cap_of)
    boxes = (R._intersect_boxes(R._shape_boxes(arrays["shapes"], nds),
                                arrays["shape_clips"]),
             R._intersect_boxes(R._quad_boxes(arrays["glyphs"], ndg),
                                arrays["glyph_clips"]),
             R._intersect_boxes(R._quad_boxes(arrays["images"], ndi),
                                arrays["image_clips"]))
    c0, c1 = 0, tiles_x
    if subgrid:
        valid = np.concatenate([
            b[(b[:, 2] > b[:, 0]) & (b[:, 3] > b[:, 1])] for b in boxes])
        if valid.shape[0]:
            c0 = min(max(0, int(valid[:, 0].min()) // TILE_W), tiles_x - 1)
            c1 = min(max(c0 + 1, -(-int(valid[:, 2].max() + 1) // TILE_W)),
                     tiles_x)
        else:
            c0, c1 = 0, 1
    off = np.array([c0 * TILE_W, 0.0, c0 * TILE_W, 0.0], np.float32)
    bins_parts, ks = [], []
    for ci, nd in enumerate((nds, ndg, ndi)):
        if caps[ci] == 0:
            ks.append(0)
            continue
        if nd:
            bins, _ = R._bin_indexed(boxes[ci] - off,
                                     np.arange(nd, dtype=np.int64),
                                     tiles_y, c1 - c0, 32)
        else:
            bins = np.full((tiles_y * (c1 - c0), 1), -1, np.int32)
        k = _dyn_bucket(bins.shape[1], (li, ci, "k"))
        padded = np.full((tiles_y * (c1 - c0), k), -1, np.int16)
        padded[:, :bins.shape[1]] = bins
        bins_parts.append(padded.ravel())
        ks.append(k)
    return blob, (np.concatenate(bins_parts) if bins_parts
                  else np.zeros(0, np.int16)), (caps, tuple(ks), c0, c1)


# ---------------------------------------------------------------------------
# Frame assembly.
# ---------------------------------------------------------------------------

def pack_frame(scene: Scene):
    """→ (frame_blob i16, chrome_args, win_args, meta). Steady-state
    frames only rebuild frame_blob (uniforms + dynamic tail, ~1 KB)."""
    tiles_x = -(-scene.width // TILE_W)
    tiles_y = -(-scene.height // TILE_H)
    windows = list(getattr(scene, "windows", ()) or ())
    slot_count: dict[int, int] = {}
    win_args = []
    win_meta = []
    uni = np.zeros((len(windows), 8), np.int16)
    # Per-window per-class (row0, WR) — content-dependent, so they cross
    # as uniforms (traced data), keeping the jit signature scroll-stable.
    uni2 = np.zeros((len(windows), 8), np.int16)
    for gi, w in enumerate(windows):
        slot = slot_count.get(w.layer, 0)
        slot_count[w.layer] = slot + 1
        caps = R._window_caps(w, slot)
        art = R._window_artifacts(w, caps)
        parts = _win_parts(w.comp.uid, caps, art["blob"])
        uni[gi, 0] = np.clip(np.rint(w.dx * 8.0), -32767, 32767)
        uni[gi, 1] = np.clip(np.rint(w.dy * 8.0), -32767, 32767)
        uni[gi, 2:6] = np.clip(
            np.rint(np.asarray(w.clip, np.float64) * 4.0), -32767, 32767)
        cls_args, cls_meta = [], []
        for ci in range(3):
            pb = (_win_pair_entry(w.comp.uid, ci, caps, art["boxes"][ci],
                                  w.dx, w.clip, tiles_x)
                  if art["ns"][ci] else None)
            if pb is None:
                cls_args.append(None)
                cls_meta.append(None)
            else:
                cls_args.append((pb["P"], pb["counts"]))
                cls_meta.append((pb["kP"], pb["wr_cap"]))
                uni2[gi, 2 * ci] = pb["row0"]
                uni2[gi, 2 * ci + 1] = pb["WR"]
        win_args.append((parts, tuple(cls_args)))
        win_meta.append((w.layer, caps, tuple(cls_meta)))

    blob_parts = [uni.ravel(), uni2.ravel()]
    chrome_args = []
    layers_meta = []
    for li, lb in enumerate(scene.layers):
        lws = [gi for gi, w in enumerate(windows) if w.layer == li]
        pos_lists = tuple(tuple(windows[gi].pos[ci] for gi in lws)
                          for ci in range(3))
        ch = _chrome_entry(lb, li, pos_lists, tiles_y, tiles_x)
        dyn_blob, dyn_bins, dyn_meta = _dyn_layer(lb, li, tiles_y, tiles_x)
        blob_parts += [dyn_blob, dyn_bins]
        chrome_args.append((ch["parts"], ch["bins"], ch["segs"]))
        has = tuple(
            ch["counts"][ci] > 0 or dyn_meta[0][ci] > 0
            or any(win_meta[gi][2][ci] is not None for gi in lws)
            for ci in range(3))
        layers_meta.append((ch["caps"], ch["ks"], tuple(lws), dyn_meta,
                            has))
    frame_blob = np.concatenate(blob_parts) if blob_parts else \
        np.zeros(0, np.int16)
    meta = (tiles_y, tiles_x, len(windows), tuple(win_meta),
            tuple(layers_meta))
    return frame_blob, tuple(chrome_args), tuple(win_args), meta


@functools.partial(
    jax.jit, static_argnames=("meta", "background", "height", "width",
                              "use_pallas", "mesh"))
def _render_frame(frame_blob, chrome_args, win_args, font_tex, image_atlas,
                  background: tuple, height: int, width: int, meta: tuple,
                  use_pallas: bool = False, mesh=None):
    tiles_y, tiles_x, n_win, win_meta, layers_meta = meta
    T = tiles_y * tiles_x
    uni = (frame_blob[:n_win * 8].reshape(n_win, 8).astype(jnp.float32)
           if n_win else None)
    uni2 = (frame_blob[n_win * 8:n_win * 16].reshape(n_win, 8)
            .astype(jnp.int32) if n_win else None)
    fo = n_win * 16

    # Windows: shift tables to screen coords; gather pair bins by dy.
    win_blocks = []
    for wi in range(n_win):
        layer, caps, cls_meta = win_meta[wi]
        dx = uni[wi, 0] / 8.0
        dy = uni[wi, 1] / 8.0
        clip = (uni[wi, 2] / 4.0, uni[wi, 3] / 4.0,
                uni[wi, 4] / 4.0, uni[wi, 5] / 4.0)
        shifted = _shift_parts(win_args[wi][0], dx, dy, clip)
        cls_blocks = []
        for ci in range(3):
            cm = cls_meta[ci]
            if cm is None:
                cls_blocks.append(None)
                continue
            kP, wr_cap = cm
            row0 = uni2[wi, 2 * ci]
            WR = uni2[wi, 2 * ci + 1]
            P, counts = win_args[wi][1][ci]
            r = jnp.arange(tiles_y, dtype=jnp.float32) * TILE_H
            a = jnp.floor((r - dy) / TILE_H).astype(jnp.int32) - row0
            av = jnp.clip(a, 0, jnp.maximum(WR - 1, 0))
            bins = P[av].reshape(T, kP)
            cnt = jnp.where(((a >= 0) & (a < WR))[:, None], counts[av], 0
                            ).reshape(T).astype(jnp.int32)
            cls_blocks.append((bins, cnt))
        win_blocks.append((shifted, tuple(cls_blocks)))

    # Per-layer block lists.
    layers_blocks = []
    for li, (caps, ks, lws, dyn_meta, has) in enumerate(layers_meta):
        parts, bins3, segs3 = chrome_args[li]
        dyn_caps, dyn_ks = dyn_meta[0], dyn_meta[1]  # full grid here
        # dynamic tables + bins from the frame blob
        dyn_tables = None
        if sum(dyn_caps):
            nwords = sum(
                dyn_caps[_PART_CLS[name]] * cols
                for name, cols, _ in R._PART_SPECS)
            dyn_tables = _dequant_parts_traced(
                frame_blob[fo:fo + nwords], dyn_caps)
            fo += nwords
        dyn_bins = []
        for ci in range(3):
            k = dyn_ks[ci]
            if k == 0:
                dyn_bins.append(None)
                continue
            b = frame_blob[fo:fo + T * k].reshape(T, k).astype(jnp.int32)
            fo += T * k
            dyn_bins.append((b, jnp.sum(b >= 0, axis=1, dtype=jnp.int32)))
        cls_lists = []
        for ci in range(3):
            blocks = []
            tbl_idx = ((0, 1), (2, 3, 4), (5, 6))[ci]
            chrome_tables = tuple(parts[j] for j in tbl_idx)
            # chrome segment 0, win, segment 1, win, ..., last segment
            n_seg = len(lws) + 1
            for si in range(n_seg):
                if ks[ci]:
                    blocks.append((chrome_tables, bins3[ci],
                                   segs3[ci][si], segs3[ci][si + 1]))
                if si < len(lws):
                    gi = lws[si]
                    # window order within the layer == pos order
                    wsh, wcls = win_blocks[gi]
                    if wcls[ci] is not None:
                        wt = tuple(wsh[j] for j in tbl_idx)
                        bins, cnt = wcls[ci]
                        blocks.append((wt, bins, None, cnt))
            if dyn_bins[ci] is not None and dyn_tables is not None:
                dt = tuple(dyn_tables[j] for j in tbl_idx)
                b, cnt = dyn_bins[ci]
                blocks.append((dt, b, None, cnt))
            cls_lists.append(tuple(blocks))
        layers_blocks.append(tuple(cls_lists))

    if mesh is not None:
        tiles_planar = _render_tiles_blocks_sharded(
            tuple(layers_blocks), font_tex, image_atlas, background,
            tiles_y, tiles_x, use_pallas, mesh)
        # Assemble the FULL row-aligned padded grid (crop happens inside
        # assemble via [:height]): slicing the tile axis first would
        # break the clean n-way tile-row sharding the producer emits.
        _, ty_pad = _sharded_tile_rows(tiles_y, tiles_x, mesh)
        return assemble_planar(tiles_planar, ty_pad, tiles_x, height, width)
    tiles = render_blocks_planar(tuple(layers_blocks), font_tex, image_atlas,
                                 background, tiles_y, tiles_x, use_pallas)
    return assemble_planar(tiles, tiles_y, tiles_x, height, width)


def _dequant_parts_traced(blob_i16, caps: tuple):
    """Traced variant of _dequant_parts (same math)."""
    cap_of = {"shapes": caps[0], "shape_clips": caps[0],
              "glyphs": caps[1], "glyph_colors": caps[1],
              "glyph_clips": caps[1], "images": caps[2],
              "image_clips": caps[2]}
    parts = []
    fo = 0
    for name, cols, scale in R._PART_SPECS:
        cap = cap_of[name]
        raw = blob_i16[fo:fo + cap * cols].reshape(cap, cols)
        inv = jnp.asarray(1.0 / R._part_scale(name, cols, scale))
        parts.append(raw.astype(jnp.float32) * inv)
        fo += cap * cols
    return tuple(parts)


# ---------------------------------------------------------------------------
# Tile rendering: the Pallas kernel (render/pallas_raster.py) on the GPU,
# the XLA reference — same blocks, lax.scan with bound masking — elsewhere.
# ---------------------------------------------------------------------------

def render_blocks_planar(layers_blocks, font_tex, image_atlas, background,
                         tiles_y: int, tiles_x: int, use_pallas: bool,
                         n_tiles: int | None = None, tile0=None):
    """Blocks → planar f32 tiles (T, 4, TILE_H, TILE_W) (traced)."""
    if use_pallas:
        from . import pallas_raster as PR

        return PR.render_tiles_blocks(layers_blocks, font_tex, image_atlas,
                                      background, tiles_y, tiles_x,
                                      n_tiles=n_tiles, tile0=tile0)
    tiles = _render_tiles_blocks_xla(layers_blocks, font_tex, image_atlas,
                                     background, tiles_y, tiles_x,
                                     n_tiles=n_tiles,
                                     tile0=0 if tile0 is None else tile0)
    return tiles.transpose(0, 3, 1, 2)


def assemble_f32(tiles_f32, tiles_y: int, tiles_x: int, height: int,
                 width: int):
    """(T, 4, TH, TW) f32 planar tiles → (H, W, 4) f32 (device-side)."""
    img = tiles_f32.reshape(tiles_y, tiles_x, 4, TILE_H, TILE_W)
    img = img.transpose(0, 3, 1, 4, 2).reshape(tiles_y * TILE_H,
                                               tiles_x * TILE_W, 4)
    return img[:height, :width]


def assemble_planar(tiles_f32, tiles_y: int, tiles_x: int, height: int,
                    width: int):
    """(T, 4, TH, TW) f32 planar tiles → (H, W, 4) u8 presented frame."""
    img = assemble_f32(tiles_f32, tiles_y, tiles_x, height, width)
    return jnp.clip(img * 255.0 + 0.5, 0.0, 255.0).astype(jnp.uint8)


def _render_tiles_blocks_xla(layers_blocks, font_tex, image_atlas,
                             background, tiles_y: int, tiles_x: int,
                             n_tiles: int | None = None, tile0=0):
    """`n_tiles`/`tile0` support the shard_map path: each device renders
    a contiguous slice of `n_tiles` tiles starting at global id `tile0`
    (pixel origins global, bins locally indexed)."""
    T = n_tiles if n_tiles is not None else tiles_y * tiles_x
    tile_idx = tile0 + jnp.arange(T)
    org_x = (tile_idx % tiles_x).astype(jnp.float32) * TILE_W
    org_y = (tile_idx // tiles_x).astype(jnp.float32) * TILE_H
    yy = jax.lax.broadcasted_iota(jnp.float32, (TILE_H, TILE_W), 0)
    xx = jax.lax.broadcasted_iota(jnp.float32, (TILE_H, TILE_W), 1)

    # Flatten per-tile scan inputs: every block's bins/lo/hi rows. Z order
    # within a layer is shapes → images → glyphs (class index 1 is glyphs,
    # 2 is images), matching scene.py and the single-shot kernel.
    _Z = (0, 2, 1)
    per_tile = []
    for cls_lists in layers_blocks:
        for ci in _Z:
            for tables, bins, lo, hi in cls_lists[ci]:
                per_tile.append(bins)
                per_tile.append(jnp.zeros((T,), jnp.int32) if lo is None
                                else lo)
                per_tile.append(hi)

    def tile_fn(ox, oy, *flat):
        px = xx + ox + 0.5
        py = yy + oy + 0.5
        fb = jnp.zeros((TILE_H, TILE_W, 4), jnp.float32)
        if background is not None:
            fb = fb.at[..., :3].set(jnp.asarray(background[:3], jnp.float32))
            fb = fb.at[..., 3].set(1.0)
        fi = 0
        for cls_lists in layers_blocks:
            for ci in _Z:
                for tables, _bins, _lo, _hi in cls_lists[ci]:
                    bins_row, lo, hi = flat[fi], flat[fi + 1], flat[fi + 2]
                    fi += 3
                    # The SAME pass bodies as the single-shot
                    # rasterizer, with (lo, hi) z-segment bounds — one
                    # copy of the compositing math (R._bounded_scan).
                    if ci == 0:
                        fb = R._shapes_pass(fb, px, py, *tables,
                                            bins_row, lo=lo, hi=hi)
                    elif ci == 1:
                        g, gc, gcl = tables
                        fb = R._glyphs_pass(fb, px, py, g, gc, gcl,
                                            bins_row, font_tex,
                                            lo=lo, hi=hi)
                    else:
                        im, icl = tables
                        fb = R._images_pass(fb, px, py, im, icl,
                                            bins_row, image_atlas,
                                            lo=lo, hi=hi)
        return fb

    return jax.vmap(tile_fn)(org_x, org_y, *per_tile)


# ---------------------------------------------------------------------------
# Mesh-sharded tile rendering: the production frame paths under a device
# mesh. The tile axis of every block's bins/bounds shards across ALL mesh
# devices (contiguous slices); command tables and atlases replicate; each
# device runs the same per-tile rendering (render_blocks_planar) on its
# local slice with global pixel origins. The
# assembled frame is the all-gather of tile outputs, which XLA inserts
# from the out_spec — the multi-chip analog of compositing to one
# swapchain image.
# ---------------------------------------------------------------------------

def _pad_tile_leaf(x, t: int, t_pad: int, fill):
    if t_pad == t:
        return x
    widths = [(0, t_pad - t)] + [(0, 0)] * (x.ndim - 1)
    return jnp.pad(x, widths, constant_values=fill)


def _sharded_tile_rows(tiles_y: int, tiles_x: int, mesh) -> tuple:
    """(T_pad, ty_pad) for a tile-ROW-aligned n-way split: tiles_y pads
    to a multiple of the mesh size so each device owns whole tile rows.
    This is what keeps the downstream assemble reshapes
    ((T,4,TH,TW) → (ty,tx,4,TH,TW) → (H,W,4)) expressible in GSPMD: the
    shard boundary always coincides with the major (tile-row) dim, so the
    assembled image is cleanly row-sharded [n,1,1] instead of the
    unrepresentable tile-split sharding that forced the partitioner into
    involuntary full rematerialization (replicate + repartition of every
    cached layer image per compose)."""
    n = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
    ty_pad = -(-tiles_y // n) * n
    return ty_pad * tiles_x, ty_pad


def _render_tiles_blocks_sharded(layers_blocks, font_tex, image_atlas,
                                 background, tiles_y: int, tiles_x: int,
                                 use_pallas: bool, mesh):
    """Blocks render over `mesh` (all axes used jointly as the spatial
    axis). Returns planar (T_pad, 4, TH, TW) f32 tiles with T_pad
    tile-row-aligned (see _sharded_tile_rows), sharded on the tile axis;
    callers assemble the full padded grid and crop rows to `height`."""
    from jax.sharding import PartitionSpec as P

    axes = tuple(mesh.axis_names)
    n = int(np.prod([mesh.shape[a] for a in axes]))
    T = tiles_y * tiles_x
    T_pad, _ = _sharded_tile_rows(tiles_y, tiles_x, mesh)
    local_t = T_pad // n

    padded, specs = [], []
    for cls_lists in layers_blocks:
        p_cls, s_cls = [], []
        for blocks in cls_lists:
            p_blocks, s_blocks = [], []
            for tables, bins, lo, hi in blocks:
                p_blocks.append((
                    tables,
                    _pad_tile_leaf(bins, T, T_pad, -1),
                    None if lo is None else _pad_tile_leaf(lo, T, T_pad, 0),
                    _pad_tile_leaf(hi, T, T_pad, 0)))
                s_blocks.append((tuple(P() for _ in tables), P(axes),
                                 None if lo is None else P(axes), P(axes)))
            p_cls.append(tuple(p_blocks))
            s_cls.append(tuple(s_blocks))
        padded.append(tuple(p_cls))
        specs.append(tuple(s_cls))

    def body(lb, ftex, iatlas):
        shard_id = jnp.int32(0)
        for ax in axes:
            shard_id = shard_id * mesh.shape[ax] + jax.lax.axis_index(ax)
        return render_blocks_planar(lb, ftex, iatlas, background, tiles_y,
                                    tiles_x, use_pallas, n_tiles=local_t,
                                    tile0=shard_id * local_t)

    fn = jax.shard_map(body, mesh=mesh,
                       in_specs=(tuple(specs), P(), P()),
                       out_specs=P(axes), check_vma=False)
    return fn(tuple(padded), font_tex, image_atlas)


# ---------------------------------------------------------------------------
# Public API.
# ---------------------------------------------------------------------------

def frame_cache_enabled() -> bool:
    want = os.environ.get("WGIT_FRAME_CACHE")
    if want is not None:
        return want not in ("0", "false", "")
    return True


def render_frame_device(scene: Scene, font_tex, image_atlas=None):
    """Rasterize → device-resident (H, W, 4) uint8 frame (no readback).
    When a render mesh is installed (render/meshstate.py) the tile axis
    shards across it."""
    from .meshstate import get_render_mesh

    frame_blob, chrome_args, win_args, meta = pack_frame(scene)
    atlas = image_atlas if image_atlas is not None else scene.image_atlas
    return _render_frame(jnp.asarray(frame_blob), chrome_args, win_args,
                         jnp.asarray(font_tex), jnp.asarray(atlas),
                         tuple(float(c) for c in scene.background[:3]),
                         scene.height, scene.width, meta,
                         use_pallas=R._use_pallas(),
                         mesh=get_render_mesh())


def clear_caches() -> None:
    _CHROME_CACHE.clear()
    _WIN_PARTS_DEV.clear()
    _WIN_PAIR_DEV.clear()
