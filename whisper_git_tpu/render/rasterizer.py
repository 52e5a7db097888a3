"""The tile rasterizer — jitted SDF compositing (the Vulkan replacement).

Frame model (reference: docs/render_engine.md "Render Loop"): for each
layer, composite shapes (rounded-rect + capsule SDFs, analytic AA — our
replacement for 4×MSAA), then image quads (avatar atlas), then glyph quads
(SDF font atlas with screen-scale-aware smoothstep, the fwidth analog).

The framebuffer is split into (TH, TW) = 64×128 pixel tiles. Commands are
binned to tiles on the host; each tile folds over its command list with
`lax.scan`, so per-pixel work is elementwise math plus small atlas-cell
slices. vmap over tiles gives XLA the whole frame as one program;
`parallel.mesh` shards the same function's tile axis across devices. On
the GPU the same per-command math runs as a Pallas kernel whose loops are
bounded by each tile's real occupancy (render/pallas_raster.py); this
module's scan is its reference.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from .scene import LayerBuffers, Scene, _bucket

TILE_H = 64   # the binning tile: 64×128 balances bin occupancy against
TILE_W = 128  # per-command full-tile coverage math.
K_SHAPES = 256
K_GLYPHS = 512
K_IMAGES = 32
SDF_SPREAD = 8.0  # must match atlas.SPREAD


def _coarse_buckets() -> bool:
    """On an accelerator each new jit signature costs a compile (seconds)
    that dwarfs scanning padded command slots, so bucket ladders are
    coarse to keep the compile count of a session small. On CPU (tests),
    fine ladders keep the scan short."""
    import jax

    return jax.default_backend() != "cpu"


_K_HIGH_WATER: dict = {}


def _k_trim(occ: int, cap: int) -> int:
    # Power-of-two ladder keeps jit signatures stable while scrolling
    # (occupancy jitter stays inside one bucket); the floor of 16 on
    # accelerators bounds the compile count, and the per-cap high-water
    # mark stops K from oscillating across a bucket boundary (each
    # crossing would be one more compile).
    k = 16 if _coarse_buckets() else 8
    while k < occ:
        k *= 2
    k = min(k, cap)
    if _coarse_buckets():
        k = max(k, _K_HIGH_WATER.get(cap, 0))
        _K_HIGH_WATER[cap] = k
    return k


def _bin_commands(boxes: np.ndarray, n: int, tiles_y: int, tiles_x: int,
                  k: int) -> tuple[np.ndarray, int]:
    """boxes: (N, 4) x0,y0,x1,y1. Returns (T, k) int32 index lists padded
    with -1 (in submission order), plus overflow count.

    Fully vectorized: (tile, command) pairs are built with numpy for every
    span size, stably sorted by tile (preserving submission order within a
    tile), then scattered into the bins array by per-tile rank."""
    T = tiles_y * tiles_x
    if n == 0:
        return np.full((T, 8), -1, np.int32), 0
    return _bin_indexed(boxes[:n], np.arange(n, dtype=np.int64),
                        tiles_y, tiles_x, k)


def _shape_boxes(shapes: np.ndarray, n: int) -> np.ndarray:
    if n == 0:
        return np.zeros((0, 4), np.float32)
    s = shapes[:n]
    is_seg = s[:, 0] == 1.0
    pad = np.where(is_seg, s[:, 5] + 1.5, 1.5)
    x0 = np.where(is_seg, np.minimum(s[:, 1], s[:, 3]), s[:, 1]) - pad
    y0 = np.where(is_seg, np.minimum(s[:, 2], s[:, 4]), s[:, 2]) - pad
    x1 = np.where(is_seg, np.maximum(s[:, 1], s[:, 3]), s[:, 1] + s[:, 3]) + pad
    y1 = np.where(is_seg, np.maximum(s[:, 2], s[:, 4]), s[:, 2] + s[:, 4]) + pad
    return np.stack([x0, y0, x1, y1], axis=1)


def _quad_boxes(quads: np.ndarray, n: int) -> np.ndarray:
    if n == 0:
        return np.zeros((0, 4), np.float32)
    q = quads[:n]
    return np.stack([q[:, 0], q[:, 1], q[:, 0] + q[:, 2], q[:, 1] + q[:, 3]],
                    axis=1)


# ---------------------------------------------------------------------------
# Device-side compositing.
# ---------------------------------------------------------------------------

def _over(fb, rgb, a):
    """Premultiplied 'over' composite of (rgb, a) onto fb (TH, TW, 4)."""
    a = a[..., None]
    out_rgb = rgb * a + fb[..., :3] * (1.0 - a)
    out_a = a[..., 0] + fb[..., 3] * (1.0 - a[..., 0])
    return jnp.concatenate([out_rgb, out_a[..., None]], axis=-1)


def _clip_mask(px, py, clip):
    return ((px >= clip[0]) & (py >= clip[1])
            & (px <= clip[2]) & (py <= clip[3])).astype(jnp.float32)


def _bounded_scan(fb, bins, lo, hi, cmd):
    """Scan a tile's bin row, compositing via `cmd(fb, i, valid)`. With
    (lo, hi) bounds (the frame cache's z-segment windows) slots outside
    [lo, hi) are masked; without, only padding (-1) is. ONE scan driver
    for both the single-shot and the blocks paths, so the per-command
    math cannot drift (the pallas kernels share their steps the same
    way)."""
    if lo is None:
        def body(fb, idx):
            i = jnp.maximum(idx, 0)
            valid = (idx >= 0).astype(jnp.float32)
            return cmd(fb, i, valid), None

        fb, _ = jax.lax.scan(body, fb, bins)
    else:
        k_iota = jnp.arange(bins.shape[0], dtype=jnp.int32)

        def body(fb, xs):
            idx, k = xs
            i = jnp.maximum(idx, 0)
            valid = ((k >= lo) & (k < hi) & (idx >= 0)).astype(jnp.float32)
            return cmd(fb, i, valid), None

        fb, _ = jax.lax.scan(body, fb, (bins, k_iota))
    return fb


def _shapes_pass(fb, px, py, shapes, clips, bins, lo=None, hi=None):
    def cmd(fb, i, valid):
        c = shapes[i]
        clip = _clip_mask(px, py, clips[i]) * valid
        is_seg = c[0] == 1.0
        # Rounded rect SDF.
        hx, hy = c[3] * 0.5, c[4] * 0.5
        cx, cy = c[1] + hx, c[2] + hy
        r = jnp.minimum(c[5], jnp.minimum(hx, hy))
        qx = jnp.abs(px - cx) - (hx - r)
        qy = jnp.abs(py - cy) - (hy - r)
        d_rect = (jnp.sqrt(jnp.maximum(qx, 0.0) ** 2 + jnp.maximum(qy, 0.0) ** 2)
                  + jnp.minimum(jnp.maximum(qx, qy), 0.0) - r)
        # Capsule SDF.
        ax, ay, bx, by = c[1], c[2], c[3], c[4]
        abx, aby = bx - ax, by - ay
        denom = jnp.maximum(abx * abx + aby * aby, 1e-6)
        t = jnp.clip(((px - ax) * abx + (py - ay) * aby) / denom, 0.0, 1.0)
        d_seg = jnp.sqrt((px - (ax + t * abx)) ** 2
                         + (py - (ay + t * aby)) ** 2) - c[5]
        d = jnp.where(is_seg, d_seg, d_rect)
        fill = c[7:11]
        cov_fill = jnp.clip(0.5 - d, 0.0, 1.0) * clip
        fb = _over(fb, fill[:3][None, None, :], cov_fill * fill[3])
        # Border ring (rects only): -bw <= d <= 0.
        bw = c[6]
        has_border = jnp.logical_and(jnp.logical_not(is_seg), bw > 0.0)
        cov_b = (jnp.clip(0.5 - d, 0.0, 1.0)
                 * jnp.clip(d + bw + 0.5, 0.0, 1.0)
                 * clip * has_border.astype(jnp.float32))
        border = c[11:15]
        return _over(fb, border[:3][None, None, :], cov_b * border[3])

    return _bounded_scan(fb, bins, lo, hi, cmd)


CELL = 64  # atlas cell extent (matches atlas.CELL / scene image tile)


def _sample_weights(pix, origin, extent, atlas_extent):
    """Bilinear resampling weight matrix W (P, CELL) such that
    (W @ patch) evaluates the patch at fractional atlas coordinates —
    turning texture sampling into a dense matmul instead of a per-pixel
    gather.

    pix: (P,) screen coords; origin: quad origin; extent: quad size;
    atlas_extent: the sampled region size in atlas px."""
    s = (pix - origin) / jnp.maximum(extent, 1e-6) * atlas_extent - 0.5
    j = jax.lax.broadcasted_iota(jnp.float32, (1, CELL), 1)
    w = jnp.clip(1.0 - jnp.abs(s[:, None] - j), 0.0, 1.0)
    inside = ((s > -1.0) & (s < atlas_extent)).astype(jnp.float32)
    return w * inside[:, None]


def _glyphs_pass(fb, px, py, glyphs, colors, clips, bins, font_tex,
                 lo=None, hi=None):
    """SDF glyph compositing. Per glyph: dynamic_slice its atlas cell
    (contiguous → fast), then two small matmuls resample it onto the
    tile's pixel grid. No gathers anywhere."""
    py1 = py[:, 0]
    px1 = px[0, :]
    ftex = font_tex.astype(jnp.float32)

    def cmd(fb, i, valid):
        g = glyphs[i]
        clip = _clip_mask(px, py, clips[i]) * valid
        x, y, w, h, u, v, uw, uh = (g[j] for j in range(8))
        patch = jax.lax.dynamic_slice(
            ftex, (v.astype(jnp.int32), u.astype(jnp.int32)), (CELL, CELL))
        wy = _sample_weights(py1, y, h, uh)          # (TH, CELL)
        wx = _sample_weights(px1, x, w, uw)          # (TW, CELL)
        # bf16 weights (the SDF encoding spans 0..255 with a ±1-unit
        # tolerance, ≪ the 0.7 px AA transition). The f32 intermediate
        # enters the second product as hi + lo bf16 terms (~16 bits):
        # rounding it to one bf16 moved glyph edges by up to 6 u8 from an
        # all-f32 pass, against 4 u8 for this form (PERF.md). hi is cut by
        # masking bits, not by an f32→bf16→f32 round trip, which XLA's GPU
        # compiler may drop as excess precision. The Pallas kernel
        # computes the same split.
        enc0 = jnp.dot(wy.astype(jnp.bfloat16), patch.astype(jnp.bfloat16),
                       preferred_element_type=jnp.float32)
        hi = jax.lax.bitcast_convert_type(
            jax.lax.bitcast_convert_type(enc0, jnp.uint32)
            & jnp.uint32(0xFFFF0000), jnp.float32)
        wxb = wx.T.astype(jnp.bfloat16)
        enc = (jnp.dot(hi.astype(jnp.bfloat16), wxb,
                       preferred_element_type=jnp.float32)
               + jnp.dot((enc0 - hi).astype(jnp.bfloat16), wxb,
                         preferred_element_type=jnp.float32))
        sdf_atlas = (128.0 - enc) * (SDF_SPREAD / 128.0)   # atlas px
        screen_scale = w / jnp.maximum(uw, 1e-6)
        d = sdf_atlas * screen_scale
        # smoothstep AA with ~0.7px transition (the fwidth analog). Pixels
        # outside the quad got zero weights → enc 0 → d = +spread → cov 0.
        cov = jnp.clip(0.5 - d / 0.7, 0.0, 1.0) * clip
        col = colors[i]
        return _over(fb, col[:3][None, None, :], cov * col[3])

    return _bounded_scan(fb, bins, lo, hi, cmd)


def _images_pass(fb, px, py, images, clips, bins, image_atlas,
                 lo=None, hi=None):
    """Image-quad compositing via the same matmul-resampling trick,
    per RGBA channel."""
    py1 = py[:, 0]
    px1 = px[0, :]
    atlas = image_atlas.astype(jnp.float32)

    def cmd(fb, i, valid):
        g = images[i]
        clip = _clip_mask(px, py, clips[i]) * valid
        x, y, w, h, u, v, uw, uh = (g[j] for j in range(8))
        patch = jax.lax.dynamic_slice(
            atlas, (v.astype(jnp.int32), u.astype(jnp.int32), 0),
            (CELL, CELL, 4))
        wy = _sample_weights(py1, y, h, uh)
        wx = _sample_weights(px1, x, w, uw)
        # HIGHEST: on the GPU an f32 product defaults to TF32 (10-bit
        # mantissa, ~1e-3 relative per operand); images are rare, so the
        # full-precision product costs little and keeps the card's pixels
        # on the CPU render's (the goldens' ±2 u8 bound).
        rgba = jnp.einsum("pj,jkc,qk->pqc", wy, patch, wx,
                          preferred_element_type=jnp.float32,
                          precision=jax.lax.Precision.HIGHEST) / 255.0
        a = rgba[..., 3] * clip
        return _over(fb, rgba[..., :3], a)

    return _bounded_scan(fb, bins, lo, hi, cmd)


@functools.partial(
    jax.jit,
    static_argnames=("background", "tiles_y", "tiles_x", "layer_sig"))
def _render_tiles(layer_data, font_tex, image_atlas, background,
                  tiles_y: int, tiles_x: int, layer_sig: tuple):
    return _render_tiles_impl(layer_data, font_tex, image_atlas, background,
                              tiles_y, tiles_x, layer_sig)


def _render_tiles_impl(layer_data, font_tex, image_atlas, background,
                       tiles_y: int, tiles_x: int, layer_sig: tuple):
    """layer_data: tuple per layer of
    (shapes, shape_clips, glyphs, glyph_colors, glyph_clips, images,
     image_clips, shape_bins, glyph_bins, image_bins) — the bins are
    (T, K) and vmap over tiles; everything else is broadcast.
    Returns (T, TH, TW, 4) float32 tiles."""
    T = tiles_y * tiles_x
    tile_idx = jnp.arange(T)
    org_x = (tile_idx % tiles_x).astype(jnp.float32) * TILE_W
    org_y = (tile_idx // tiles_x).astype(jnp.float32) * TILE_H
    yy = jax.lax.broadcasted_iota(jnp.float32, (TILE_H, TILE_W), 0)
    xx = jax.lax.broadcasted_iota(jnp.float32, (TILE_H, TILE_W), 1)

    bins_flat = []
    for li in range(len(layer_sig)):
        bins_flat += [layer_data[li][7], layer_data[li][8], layer_data[li][9]]

    def tile_fn(ox, oy, *tile_bins):
        px = xx + ox + 0.5
        py = yy + oy + 0.5
        fb = jnp.zeros((TILE_H, TILE_W, 4), jnp.float32)
        fb = fb.at[..., :3].set(jnp.asarray(background[:3], jnp.float32))
        fb = fb.at[..., 3].set(1.0)
        for li, (has_s, has_g, has_i) in enumerate(layer_sig):
            (shapes, shape_clips, glyphs, glyph_colors, glyph_clips,
             images, image_clips) = layer_data[li][:7]
            s_bins, g_bins, i_bins = (tile_bins[3 * li], tile_bins[3 * li + 1],
                                      tile_bins[3 * li + 2])
            if has_s:
                fb = _shapes_pass(fb, px, py, shapes, shape_clips, s_bins)
            if has_i:
                fb = _images_pass(fb, px, py, images, image_clips, i_bins,
                                  image_atlas)
            if has_g:
                fb = _glyphs_pass(fb, px, py, glyphs, glyph_colors,
                                  glyph_clips, g_bins, font_tex)
        return fb

    return jax.vmap(tile_fn)(org_x, org_y, *bins_flat)


def assemble_image(tiles: np.ndarray, tiles_y: int, tiles_x: int,
                   height: int, width: int) -> np.ndarray:
    """(T, TH, TW, 4) float → (H, W, 4) uint8."""
    t = np.asarray(tiles).reshape(tiles_y, tiles_x, TILE_H, TILE_W, 4)
    img = t.transpose(0, 2, 1, 3, 4).reshape(tiles_y * TILE_H,
                                             tiles_x * TILE_W, 4)
    img = np.clip(img[:height, :width] * 255.0 + 0.5, 0, 255).astype(np.uint8)
    return img


@dataclass
class RenderStats:
    overflow: int = 0


# ---------------------------------------------------------------------------
# Packed frame path: the whole frame's command data crosses to the device
# as ONE array (an i16 half and an i32 half), unpacked on-device with
# static offsets — one host→device transfer per frame.
# ---------------------------------------------------------------------------

# (name, cols, quantization scale) of every command part per layer, in
# blob order. Commands cross to the device as int16 fixed-point — geometry
# at 1/8 px (range ±4095 px), clip rects at 1/4 px (range ±8191 px), colors
# at 1/8192 (range covers premultiplied 0..1) — halving frame bytes.
# De-quantization is one elementwise multiply on device.
_PART_SPECS = (("shapes", 16, None), ("shape_clips", 4, 4.0),
               ("glyphs", 8, 8.0), ("glyph_colors", 4, 8192.0),
               ("glyph_clips", 4, 4.0), ("images", 8, 8.0),
               ("image_clips", 4, 4.0))

# Shapes mix geometry and color columns: per-column scales.
_SHAPE_COL_SCALE = np.array(
    [8.0] * 7 + [8192.0] * 4 + [8192.0] * 4 + [8.0], np.float32)

# Glyph/image quads mix SCREEN coords (x,y,w,h — 1/8 px, range ±4095 px)
# with ATLAS coords (u,v,uw,uh — exact integers by construction, so scale
# 1 gives range ±32767 atlas px; the extended font atlas is >4096 px
# tall, which the uniform 1/8-px scale silently clamped).
_QUAD_COL_SCALE = np.array([8.0] * 4 + [1.0] * 4, np.float32)


def _part_scale(name: str, cols: int, scale) -> np.ndarray:
    if name == "shapes":
        return _SHAPE_COL_SCALE
    if name in ("glyphs", "images"):
        return _QUAD_COL_SCALE
    return np.full((cols,), scale, np.float32)


# --- scroll-window device residency ------------------------------------------
# A scroll window's merged command chunks (window-relative coordinates)
# are quantized once per content change and cached on the DEVICE; per
# frame only an 8-value uniform row (dx, dy, clip) and the merged tile
# bins are uploaded, and the window→screen shift runs on-device during
# unpack. Steady-state scrolling therefore ships a few tens of KB of
# chrome + bins instead of the whole frame's command data.

_WIN_HOST_CACHE: dict = {}  # comp.uid -> dict(caps, blob, boxes, ns)
_WIN_DEV_CACHE: dict = {}   # (comp.uid, caps) -> device array

_CLS_KCAP = {0: K_SHAPES, 1: K_GLYPHS, 2: K_IMAGES}


def _window_caps(w, slot: int) -> tuple:
    comp = w.comp
    return (_bucket(comp.shapes.shape[0], ("win", w.layer, slot, "s")),
            _bucket(comp.glyphs.shape[0], ("win", w.layer, slot, "g")),
            _bucket(comp.images.shape[0], ("win", w.layer, slot, "i")))


def _intersect_boxes(boxes: np.ndarray, clips: np.ndarray) -> np.ndarray:
    """Effective bounding boxes: geometry ∩ per-command clip (for bin-time
    culling of overscan rows that a clip fully hides)."""
    if boxes.shape[0] == 0:
        return boxes
    return np.stack([np.maximum(boxes[:, 0], clips[:, 0]),
                     np.maximum(boxes[:, 1], clips[:, 1]),
                     np.minimum(boxes[:, 2], clips[:, 2]),
                     np.minimum(boxes[:, 3], clips[:, 3])], axis=1)


def _window_artifacts(w, caps: tuple) -> dict:
    """Quantized i16 blob + per-class effective boxes for one window,
    cached by content identity (comp.uid)."""
    comp = w.comp
    hit = _WIN_HOST_CACHE.get(comp.uid)
    if hit is not None and hit["caps"] == caps:
        return hit
    cap_of = {"shapes": caps[0], "shape_clips": caps[0],
              "glyphs": caps[1], "glyph_colors": caps[1],
              "glyph_clips": caps[1], "images": caps[2],
              "image_clips": caps[2]}
    parts = []
    arrays = {"shapes": comp.shapes, "shape_clips": comp.shape_clips,
              "glyphs": comp.glyphs, "glyph_colors": comp.glyph_colors,
              "glyph_clips": comp.glyph_clips, "images": comp.images,
              "image_clips": comp.image_clips}
    for name, cols, scale in _PART_SPECS:
        arr = arrays[name]
        s = _part_scale(name, cols, scale)
        q = np.zeros((cap_of[name], cols), np.int16)
        nu = arr.shape[0]
        if nu:
            q[:nu] = np.clip(np.rint(arr[:nu] * s), -32767.0, 32767.0)
        parts.append(q.ravel())
    blob = np.concatenate(parts)
    entry = {
        "caps": caps, "blob": blob,
        "boxes": (
            _intersect_boxes(_shape_boxes(comp.shapes, comp.shapes.shape[0]),
                             comp.shape_clips),
            _intersect_boxes(_quad_boxes(comp.glyphs, comp.glyphs.shape[0]),
                             comp.glyph_clips),
            _intersect_boxes(_quad_boxes(comp.images, comp.images.shape[0]),
                             comp.image_clips)),
        "ns": (comp.shapes.shape[0], comp.glyphs.shape[0],
               comp.images.shape[0]),
    }
    if len(_WIN_HOST_CACHE) > 32:
        _WIN_HOST_CACHE.clear()
    _WIN_HOST_CACHE[comp.uid] = entry
    return entry


def _window_space_bins(entry: dict, ci: int, dx: float, clip: tuple,
                       tiles_x: int):
    """Precompute a window's tile bins in WINDOW-relative tile rows (screen
    columns — dx is stable across scroll). Cached per content + dx + clip.

    Returns {"row0", "all": (WR, tx, kA), "starts": (WR, tx, kS)} of
    window-local command indices, or None if the class is empty.
    `all[r]` holds every command intersecting window tile row r (submission
    order); `starts[r]` only those whose topmost tile row is r. A screen
    tile row covering window rows (a, a+1) then bins as all[a] + starts[a+1]
    — disjoint, conservative, and rank-ordered (rows emit in order)."""
    key = (ci, round(dx * 8.0), tuple(round(c * 4.0) for c in clip),
           tiles_x)
    cache = entry.setdefault("wbins", {})
    if key in cache:
        return cache[key]
    boxes = entry["boxes"][ci]
    n = boxes.shape[0]
    out = None
    if n:
        x0 = np.maximum(boxes[:, 0] + dx, clip[0])
        x1 = np.minimum(boxes[:, 2] + dx, clip[2])
        y0, y1 = boxes[:, 1], boxes[:, 3]
        keep = (x1 >= x0) & (y1 >= y0)
        if keep.any():
            idx = np.arange(n, dtype=np.int64)[keep]
            tx0 = np.clip((x0[keep] // TILE_W).astype(np.int64), 0,
                          tiles_x - 1)
            tx1 = np.clip((x1[keep] // TILE_W).astype(np.int64), 0,
                          tiles_x - 1)
            ty0 = np.floor(y0[keep] / TILE_H).astype(np.int64)
            ty1 = np.floor(y1[keep] / TILE_H).astype(np.int64)
            row0 = int(ty0.min())
            ty0 -= row0
            ty1 -= row0
            WR = int(ty1.max()) + 1
            sx = tx1 - tx0 + 1
            sy = ty1 - ty0 + 1
            reps = sx * sy
            total = int(reps.sum())
            cmds = np.repeat(idx, reps)
            offs = np.arange(total, dtype=np.int64) - np.repeat(
                np.cumsum(reps) - reps, reps)
            rsx = np.repeat(sx, reps)
            dyy, dxx = offs // rsx, offs % rsx
            rows = np.repeat(ty0, reps) + dyy
            cells = rows * tiles_x + np.repeat(tx0, reps) + dxx
            starts = dyy == 0

            def scatter(cells_s, cmds_s, ncells):
                order = np.argsort(cells_s, kind="stable")
                cells_s, cmds_s = cells_s[order], cmds_s[order]
                counts = np.bincount(cells_s, minlength=ncells)
                st = np.concatenate(([0], np.cumsum(counts[:-1])))
                rank = np.arange(len(cells_s)) - st[cells_s]
                kk = max(int(counts.max()), 1)
                binsx = np.full((ncells, kk), -1, np.int32)
                binsx[cells_s, rank] = cmds_s.astype(np.int32)
                return binsx

            ncells = WR * tiles_x
            out = {
                "row0": row0,
                "all": scatter(cells, cmds, ncells
                               ).reshape(WR, tiles_x, -1),
                "starts": scatter(cells[starts], cmds[starts], ncells
                                  ).reshape(WR, tiles_x, -1),
            }
    cache[key] = out
    return out


def _gather_window_rows(arr: np.ndarray, a: np.ndarray) -> np.ndarray:
    """arr (WR, tx, k); a (ty,) row indices (may be out of range → -1)."""
    WR = arr.shape[0]
    av = np.clip(a, 0, WR - 1)
    out = arr[av].copy()
    out[(a < 0) | (a >= WR)] = -1
    return out


def _merged_window_bins(wb: dict, dy: float, tiles_y: int, tiles_x: int,
                        base: int, boxes: np.ndarray) -> np.ndarray:
    """Per-frame window bins: gather the two window tile rows each screen
    tile row overlaps. Returns (T, kA+kS) concat-table indices.

    The union is conservative and not submission-ordered, so entries whose
    actual screen-space row span misses their tile row are masked out
    (keeping device occupancy exact), and a per-tile sort restores paint
    order (within one window submission order IS ascending local index).
    `boxes` are the window-relative effective boxes for the class."""
    r = np.arange(tiles_y, dtype=np.int64)
    a = np.floor((r * TILE_H - dy) / TILE_H).astype(np.int64) - wb["row0"]
    A = _gather_window_rows(wb["all"], a)
    B = _gather_window_rows(wb["starts"], a + 1)
    m = np.concatenate([A, B], axis=2).reshape(tiles_y * tiles_x, -1)
    # Exact row filter: screen tile rows each command truly spans.
    ty0c = np.floor((boxes[:, 1] + dy) / TILE_H).astype(np.int64)
    ty1c = np.floor((boxes[:, 3] + dy) / TILE_H).astype(np.int64)
    rows = np.repeat(r, tiles_x)[:, None]
    mv = m >= 0
    mi = np.where(mv, m, 0)
    valid = mv & (ty0c[mi] <= rows) & (ty1c[mi] >= rows)
    m = np.where(valid, m, np.int32(2 ** 31 - 1))
    m.sort(axis=1)
    kmax = int(valid.sum(axis=1).max()) if m.size else 0
    m = m[:, :max(kmax, 1)]
    return np.where(m < 2 ** 31 - 1, m + base, -1)


def _interleave_bins(chrome_bins: np.ndarray, win_blocks: list,
                     kcap: int) -> np.ndarray:
    """Merge chrome bins with window bin blocks in stream order.
    win_blocks: [(bins (T, kw), pos)] — pos is the chrome stream index the
    window was recorded at. Entries are reordered per tile so chrome
    commands with index < pos composite before the window, the rest
    after; padding (-1) sinks to the end."""
    poss = np.asarray([p for _, p in win_blocks], np.int64)
    parts = [chrome_bins] + [b for b, _ in win_blocks]
    merged = np.concatenate(parts, axis=1)
    kc = chrome_bins.shape[1]
    keys = np.empty(merged.shape, np.int64)
    ck = np.searchsorted(poss, chrome_bins, side="right") * 2
    keys[:, :kc] = ck
    off = kc
    for wi, (b, _) in enumerate(win_blocks):
        keys[:, off:off + b.shape[1]] = 2 * wi + 1
        off += b.shape[1]
    keys[merged < 0] = 1 << 40
    order = np.argsort(keys, axis=1, kind="stable")
    merged = np.take_along_axis(merged, order, axis=1)
    occ = int((merged >= 0).sum(axis=1).max()) if merged.size else 0
    k_used = _k_trim(occ, kcap)
    return merged[:, :k_used]


def _bin_indexed(b: np.ndarray, cmd_ids: np.ndarray, tiles_y: int,
                 tiles_x: int, k: int) -> tuple[np.ndarray, int]:
    """Core binning: boxes (already in submission order) + the command-
    table index each box refers to → (T, k_used) bins of indices."""
    T = tiles_y * tiles_x
    n = b.shape[0]
    if n == 0:
        return np.full((T, 8), -1, np.int32), 0
    tx0 = np.clip((b[:, 0] // TILE_W).astype(np.int64), 0, tiles_x - 1)
    ty0 = np.clip((b[:, 1] // TILE_H).astype(np.int64), 0, tiles_y - 1)
    tx1 = np.clip((b[:, 2] // TILE_W).astype(np.int64), 0, tiles_x - 1)
    ty1 = np.clip((b[:, 3] // TILE_H).astype(np.int64), 0, tiles_y - 1)
    keep = ~((b[:, 2] < 0) | (b[:, 3] < 0)
             | (b[:, 0] > tiles_x * TILE_W) | (b[:, 1] > tiles_y * TILE_H)
             | (b[:, 2] < b[:, 0]) | (b[:, 3] < b[:, 1]))
    if not keep.any():
        return np.full((T, 8), -1, np.int32), 0
    idx = cmd_ids[keep].astype(np.int64)
    sx = (tx1 - tx0 + 1)[keep]
    sy = (ty1 - ty0 + 1)[keep]
    # Ragged span expansion, fully vectorized: one (tile, command) pair
    # per covered tile (a full-frame rect covers all T; text covers 1-2).
    reps = sx * sy
    total = int(reps.sum())
    cmds_all = np.repeat(idx, reps)
    offs = np.arange(total, dtype=np.int64) - np.repeat(
        np.cumsum(reps) - reps, reps)
    rsx = np.repeat(sx, reps)
    dy, dx = offs // rsx, offs % rsx
    tiles_all = ((np.repeat(ty0[keep], reps) + dy) * tiles_x
                 + np.repeat(tx0[keep], reps) + dx)
    # Input is in submission order, so a stable sort by tile alone keeps
    # submission order within each tile.
    order = np.argsort(tiles_all, kind="stable")
    tiles_all = tiles_all[order]
    cmds_all = cmds_all[order]

    counts = np.bincount(tiles_all, minlength=T)
    starts = np.concatenate(([0], np.cumsum(counts[:-1])))
    rank = np.arange(len(tiles_all)) - starts[tiles_all]
    occ = int(counts.max())
    k_used = _k_trim(occ, k)
    fit = rank < k_used
    overflow = int((~fit).sum())
    bins = np.full((T, k_used), -1, np.int32)
    bins[tiles_all[fit], rank[fit]] = cmds_all[fit].astype(np.int32)
    return bins, overflow


def pack_scene(scene: Scene
               ) -> tuple[np.ndarray, tuple, int, int, list]:
    """→ (fused_blob_i32, meta, tiles_y, tiles_x, win_list). `meta` is the
    static unpack signature: (i16_words, n_windows, then per layer
    (ns_cap, ng_cap, ni_cap, ks, kg, ki, has_s, has_g, has_i, bins16,
    wins)) where wins = ((global_idx, (ws, wg, wi)), ...). `win_list` is
    [(uid, caps, blob_i16)] in scene.windows order — device-cacheable."""
    tiles_x = -(-scene.width // TILE_W)
    tiles_y = -(-scene.height // TILE_H)
    T = tiles_y * tiles_x
    windows = list(getattr(scene, "windows", ()) or ())
    slot_count: dict[int, int] = {}
    win_entries = []
    for w in windows:
        slot = slot_count.get(w.layer, 0)
        slot_count[w.layer] = slot + 1
        caps = _window_caps(w, slot)
        win_entries.append((w, caps, _window_artifacts(w, caps)))

    i16_parts: list[np.ndarray] = []
    i32_parts: list[np.ndarray] = []
    meta = []
    empty_bins = np.zeros((T, 0), np.int32)

    # Uniform head: 8 i16 per window — dx, dy @1/8 px; clip @1/4 px; pad.
    uni = np.zeros((len(windows), 8), np.int16)
    for gi, (w, caps, entry) in enumerate(win_entries):
        uni[gi, 0] = np.clip(np.rint(w.dx * 8.0), -32767, 32767)
        uni[gi, 1] = np.clip(np.rint(w.dy * 8.0), -32767, 32767)
        uni[gi, 2:6] = np.clip(
            np.rint(np.asarray(w.clip, np.float64) * 4.0), -32767, 32767)
    i16_parts.append(uni.ravel())

    for li, lb in enumerate(scene.layers):
        lws = [(gi, w, caps, entry) for gi, (w, caps, entry)
               in enumerate(win_entries) if w.layer == li]
        occ = (lb.n_shapes, lb.n_glyphs, lb.n_images)
        caps_c = (lb.shapes.shape[0], lb.glyphs.shape[0],
                  lb.images.shape[0])
        chrome_boxes = (_shape_boxes(lb.shapes, lb.n_shapes),
                        _quad_boxes(lb.glyphs, lb.n_glyphs),
                        _quad_boxes(lb.images, lb.n_images))
        chrome_clips = (lb.shape_clips, lb.glyph_clips, lb.image_clips)
        cls_bins = []
        max_idx = 0
        for ci in range(3):
            nc = occ[ci]
            base = caps_c[ci]
            win_blocks = []
            for gi, w, caps, entry in lws:
                if entry["ns"][ci]:
                    wb = _window_space_bins(entry, ci, w.dx, w.clip,
                                            tiles_x)
                    if wb is not None:
                        win_blocks.append((_merged_window_bins(
                            wb, w.dy, tiles_y, tiles_x, base,
                            entry["boxes"][ci]), w.pos[ci]))
                base += caps[ci]
            max_idx = max(max_idx, base)
            if nc:
                eb = _intersect_boxes(chrome_boxes[ci],
                                      chrome_clips[ci][:nc])
                chrome_bins = _bin_indexed(
                    eb, np.arange(nc, dtype=np.int64), tiles_y, tiles_x,
                    _CLS_KCAP[ci])[0]
            else:
                chrome_bins = (np.full((T, 0), -1, np.int32)
                               if win_blocks else None)
            if chrome_bins is None:
                cls_bins.append(empty_bins)
            elif win_blocks:
                cls_bins.append(_interleave_bins(chrome_bins, win_blocks,
                                                 _CLS_KCAP[ci]))
            else:
                cls_bins.append(chrome_bins)
        s_bins, g_bins, i_bins = cls_bins

        arrays = {"shapes": lb.shapes, "shape_clips": lb.shape_clips,
                  "glyphs": lb.glyphs, "glyph_colors": lb.glyph_colors,
                  "glyph_clips": lb.glyph_clips, "images": lb.images,
                  "image_clips": lb.image_clips}
        used = {"shapes": lb.n_shapes, "shape_clips": lb.n_shapes,
                "glyphs": lb.n_glyphs, "glyph_colors": lb.n_glyphs,
                "glyph_clips": lb.n_glyphs, "images": lb.n_images,
                "image_clips": lb.n_images}
        for name, cols, scale in _PART_SPECS:
            arr = arrays[name]
            s = _part_scale(name, cols, scale)
            # Quantize only the used prefix; padding rows stay zero.
            q = np.zeros(arr.shape, np.int16)
            nu = used[name]
            if nu:
                q[:nu] = np.clip(np.rint(arr[:nu] * s), -32767.0, 32767.0)
            i16_parts.append(q.ravel())
        # Bin indices are < the concat-table size, which never approaches
        # i16 range for a real scene — ship them in the i16 half too
        # (halving the index-table bytes). A >32k-command layer falls back
        # to the i32 section.
        bins16 = max_idx < 32767
        if bins16:
            i16_parts += [s_bins.astype(np.int16).ravel(),
                          g_bins.astype(np.int16).ravel(),
                          i_bins.astype(np.int16).ravel()]
        else:
            i32_parts += [s_bins.ravel(), g_bins.ravel(), i_bins.ravel()]
        wins_meta = tuple((gi, caps) for gi, w, caps, entry in lws)
        has = tuple(occ[ci] > 0
                    or any(e["ns"][ci] for _, w, _, e in lws)
                    for ci in range(3))
        meta.append((caps_c[0], caps_c[1], caps_c[2], s_bins.shape[1],
                     g_bins.shape[1], i_bins.shape[1], has[0], has[1],
                     has[2], bins16, wins_meta))
    blob_i16 = (np.concatenate(i16_parts) if i16_parts
                else np.zeros(0, np.int16))
    blob_i32 = (np.concatenate(i32_parts) if i32_parts
                else np.zeros(0, np.int32))
    # Merge into ONE array (one host→device transfer per frame): the i16
    # half rides bitcast inside i32 words.
    if blob_i16.size % 2:
        blob_i16 = np.concatenate([blob_i16, np.zeros(1, np.int16)])
    fused = np.concatenate([blob_i16.view(np.int32), blob_i32])
    meta = (blob_i16.size // 2, len(windows)) + tuple(meta)
    win_list = [(w.comp.uid, caps, entry["blob"])
                for w, caps, entry in win_entries]
    return fused, tuple(meta), tiles_y, tiles_x, win_list


def _shift_clips_dev(c, dx, dy, c0, c1, c2, c3):
    return jnp.stack([jnp.maximum(c[:, 0] + dx, c0),
                      jnp.maximum(c[:, 1] + dy, c1),
                      jnp.minimum(c[:, 2] + dx, c2),
                      jnp.minimum(c[:, 3] + dy, c3)], axis=1)


def _unpack_window(blob, caps: tuple, dx, dy, clip):
    """De-quantize one window blob and shift it window→screen on-device,
    clamping clips to the window's viewport rect."""
    cap_of = {"shapes": caps[0], "shape_clips": caps[0],
              "glyphs": caps[1], "glyph_colors": caps[1],
              "glyph_clips": caps[1], "images": caps[2],
              "image_clips": caps[2]}
    parts = []
    fo = 0
    for name, cols, scale in _PART_SPECS:
        cap = cap_of[name]
        raw = blob[fo:fo + cap * cols].reshape(cap, cols)
        inv = jnp.asarray(1.0 / _part_scale(name, cols, scale))
        parts.append(raw.astype(jnp.float32) * inv)
        fo += cap * cols
    shapes, shape_clips, glyphs, glyph_colors, glyph_clips, images, \
        image_clips = parts
    c0, c1, c2, c3 = clip[0], clip[1], clip[2], clip[3]
    if shapes.shape[0]:
        seg = (shapes[:, 0] == 1.0)
        shapes = jnp.concatenate([
            shapes[:, 0:1],
            shapes[:, 1:2] + dx, shapes[:, 2:3] + dy,
            shapes[:, 3:4] + jnp.where(seg, dx, 0.0)[:, None],
            shapes[:, 4:5] + jnp.where(seg, dy, 0.0)[:, None],
            shapes[:, 5:]], axis=1)
        shape_clips = _shift_clips_dev(shape_clips, dx, dy, c0, c1, c2, c3)
    if glyphs.shape[0]:
        glyphs = jnp.concatenate([glyphs[:, 0:1] + dx, glyphs[:, 1:2] + dy,
                                  glyphs[:, 2:]], axis=1)
        glyph_clips = _shift_clips_dev(glyph_clips, dx, dy, c0, c1, c2, c3)
    if images.shape[0]:
        images = jnp.concatenate([images[:, 0:1] + dx, images[:, 1:2] + dy,
                                  images[:, 2:]], axis=1)
        image_clips = _shift_clips_dev(image_clips, dx, dy, c0, c1, c2, c3)
    return (shapes, shape_clips, glyphs, glyph_colors, glyph_clips,
            images, image_clips)


def unpack_layers(fused, win_blobs: tuple, meta: tuple, T: int):
    """Device-side unpack + de-quantization (runs under jit). Window
    blobs are appended to their layer's command tables after the
    on-device shift; bins index the concatenated tables."""
    i16_words, n_win = meta[0], meta[1]
    blob_i16 = jax.lax.bitcast_convert_type(
        fused[:i16_words], jnp.int16).reshape(-1)
    blob_i32 = fused[i16_words:]
    fo = n_win * 8
    uni = (blob_i16[:fo].reshape(n_win, 8).astype(jnp.float32)
           if n_win else None)
    layer_data = []
    layer_sig = []
    io = 0
    for (ns, ng, ni, ks, kg, ki, has_s, has_g, has_i, bins16,
         wins) in meta[2:]:
        caps = {"shapes": ns, "shape_clips": ns, "glyphs": ng,
                "glyph_colors": ng, "glyph_clips": ng, "images": ni,
                "image_clips": ni}
        parts = []
        for name, cols, scale in _PART_SPECS:
            cap = caps[name]
            raw = blob_i16[fo:fo + cap * cols].reshape(cap, cols)
            inv = jnp.asarray(1.0 / _part_scale(name, cols, scale))
            parts.append(raw.astype(jnp.float32) * inv)
            fo += cap * cols
        bins = []
        for k in (ks, kg, ki):
            if bins16:
                bins.append(blob_i16[fo:fo + T * k].reshape(T, k)
                            .astype(jnp.int32))
                fo += T * k
            else:
                bins.append(blob_i32[io:io + T * k].reshape(T, k))
                io += T * k
        if wins:
            wparts = []
            for gi, wcaps in wins:
                u = uni[gi]
                wparts.append(_unpack_window(
                    win_blobs[gi], wcaps, u[0] / 8.0, u[1] / 8.0,
                    (u[2] / 4.0, u[3] / 4.0, u[4] / 4.0, u[5] / 4.0)))
            parts = [jnp.concatenate([parts[pi]] + [wp[pi]
                                                    for wp in wparts])
                     for pi in range(7)]
        layer_data.append(tuple(parts) + tuple(bins))
        layer_sig.append((has_s, has_g, has_i))
    return tuple(layer_data), tuple(layer_sig)


def _use_pallas() -> bool:
    """The Pallas raster kernel (render/pallas_raster.py) is the GPU path;
    the XLA scan serves every other backend (and is its reference)."""
    return jax.default_backend() == "gpu"


def _layer_blocks(layer_data, layer_sig) -> tuple:
    """Single-shot layer data → the blocks structure of the frame-cache
    path: per layer, per class, one block over the whole bin row (bins
    hold their valid entries as a prefix, so hi = the row's count)."""
    out = []
    for d, sig in zip(layer_data, layer_sig):
        tables = ((d[0], d[1]), (d[2], d[3], d[4]), (d[5], d[6]))
        out.append(tuple(
            ((tables[ci], d[7 + ci], None,
              jnp.sum(d[7 + ci] >= 0, axis=1, dtype=jnp.int32)),)
            if sig[ci] else () for ci in range(3)))
    return tuple(out)


@functools.partial(
    jax.jit, static_argnames=("tiles_y", "tiles_x", "meta", "background",
                              "height", "width", "use_pallas"))
def _render_packed(fused, win_blobs, font_tex, image_atlas,
                   background: tuple, tiles_y: int, tiles_x: int,
                   meta: tuple, height: int, width: int,
                   use_pallas: bool = False):
    """Full frame on-device: rasterize tiles, assemble, quantize to u8.
    The u8 conversion and assembly stay on-device (the presented
    framebuffer lives device-side, like the reference's swapchain image;
    readback is screenshot-only)."""
    layer_data, layer_sig = unpack_layers(fused, win_blobs, meta,
                                          tiles_y * tiles_x)
    return _finish_tiles(layer_data, layer_sig, font_tex, image_atlas,
                         background, tiles_y, tiles_x, height, width,
                         use_pallas)


def _finish_tiles(layer_data, layer_sig, font_tex, image_atlas,
                  background: tuple, tiles_y: int, tiles_x: int,
                  height: int, width: int, use_pallas: bool):
    """Rasterize tiles → assembled device u8 frame (traced helper shared
    by the packed and unquantized paths)."""
    if use_pallas:
        from . import frame as F

        tiles = F.render_blocks_planar(_layer_blocks(layer_data, layer_sig),
                                       font_tex, image_atlas, background,
                                       tiles_y, tiles_x, True)
        return F.assemble_planar(tiles, tiles_y, tiles_x, height, width)
    tiles = _render_tiles_impl(layer_data, font_tex, image_atlas, background,
                               tiles_y, tiles_x, layer_sig)
    img = tiles.reshape(tiles_y, tiles_x, TILE_H, TILE_W, 4)
    img = img.transpose(0, 2, 1, 3, 4).reshape(tiles_y * TILE_H,
                                               tiles_x * TILE_W, 4)
    img = img[:height, :width]
    return jnp.clip(img * 255.0 + 0.5, 0.0, 255.0).astype(jnp.uint8)


# i16 wire-format ceiling: screen geometry quantizes at 1/8 px into int16,
# so any coordinate beyond ±4095.875 px would silently clamp — the same
# silent-corruption class as the atlas-v overflow fixed by
# _QUAD_COL_SCALE. Scenes larger than this (5K/8K screenshots) render
# through the unquantized f32 path below; it skips the frame caches
# (irrelevant for one-shot captures) but uses the same rasterizer.
MAX_PACKED_PX = 4095


@functools.partial(
    jax.jit, static_argnames=("background", "tiles_y", "tiles_x",
                              "layer_sig", "height", "width", "use_pallas"))
def _render_unpacked(layer_data, font_tex, image_atlas, background: tuple,
                     tiles_y: int, tiles_x: int, layer_sig: tuple,
                     height: int, width: int, use_pallas: bool = False):
    return _finish_tiles(layer_data, layer_sig, font_tex, image_atlas,
                         background, tiles_y, tiles_x, height, width,
                         use_pallas)


def _render_scene_f32_device(scene: Scene, font_tex, image_atlas):
    """Oversized-scene path: commands are uploaded as plain f32 (no i16
    quantization), with scroll windows spliced inline on host at their
    exact z-positions (Scene.inline_windows)."""
    flat = scene.inline_windows()
    tiles_x = -(-flat.width // TILE_W)
    tiles_y = -(-flat.height // TILE_H)
    layer_data = []
    layer_sig = []
    for lb in flat.layers:
        s_bins, _ = _bin_commands(_shape_boxes(lb.shapes, lb.n_shapes),
                                  lb.n_shapes, tiles_y, tiles_x, K_SHAPES)
        g_bins, _ = _bin_commands(_quad_boxes(lb.glyphs, lb.n_glyphs),
                                  lb.n_glyphs, tiles_y, tiles_x, K_GLYPHS)
        i_bins, _ = _bin_commands(_quad_boxes(lb.images, lb.n_images),
                                  lb.n_images, tiles_y, tiles_x, K_IMAGES)
        layer_data.append((
            jnp.asarray(lb.shapes), jnp.asarray(lb.shape_clips),
            jnp.asarray(lb.glyphs), jnp.asarray(lb.glyph_colors),
            jnp.asarray(lb.glyph_clips),
            jnp.asarray(lb.images), jnp.asarray(lb.image_clips),
            jnp.asarray(s_bins), jnp.asarray(g_bins), jnp.asarray(i_bins)))
        layer_sig.append((lb.n_shapes > 0, lb.n_glyphs > 0,
                          lb.n_images > 0))
    return _render_unpacked(tuple(layer_data), jnp.asarray(font_tex),
                            jnp.asarray(image_atlas),
                            tuple(float(c) for c in flat.background[:3]),
                            tiles_y, tiles_x, tuple(layer_sig),
                            flat.height, flat.width,
                            use_pallas=_use_pallas())


def render_scene_device(scene: Scene, font_tex, image_atlas=None):
    """Rasterize → device-resident (H, W, 4) uint8 frame (no readback).

    Default path: the layer-image compose pipeline (render/compose.py —
    cached chrome images + scroll slabs + one fused blend; ≤1 u8 from the
    packed path, see its module docstring). WGIT_FRAME_COMPOSE=0 drops to
    the device-resident frame cache (render/frame.py — content-addressed
    chrome, window pair bins gathered on device), WGIT_FRAME_CACHE=0 to the
    single-shot packed path below (also used by the mesh-sharded demo);
    frame-cache and packed paths are bit-identical."""
    from . import compose as C
    from . import frame as F

    if max(scene.width, scene.height) > MAX_PACKED_PX:
        atlas = image_atlas if image_atlas is not None else scene.image_atlas
        return _render_scene_f32_device(scene, font_tex, atlas)
    if F.frame_cache_enabled():
        atlas = image_atlas if image_atlas is not None else scene.image_atlas
        if C.compose_enabled():
            img = C.render_frame_composed(scene, font_tex, atlas)
            if img is not None:
                return img
        return F.render_frame_device(scene, font_tex, image_atlas)
    fused, meta, tiles_y, tiles_x, win_list = pack_scene(scene)
    dev_wins = []
    for uid, caps, blob in win_list:
        key = (uid, caps)
        d = _WIN_DEV_CACHE.get(key)
        if d is None:
            while len(_WIN_DEV_CACHE) > 16:
                _WIN_DEV_CACHE.pop(next(iter(_WIN_DEV_CACHE)))
            d = jnp.asarray(blob)
            _WIN_DEV_CACHE[key] = d
        dev_wins.append(d)
    atlas = image_atlas if image_atlas is not None else scene.image_atlas
    return _render_packed(jnp.asarray(fused), tuple(dev_wins),
                          jnp.asarray(font_tex), jnp.asarray(atlas),
                          tuple(float(c) for c in scene.background[:3]),
                          tiles_y, tiles_x, meta,
                          scene.height, scene.width,
                          use_pallas=_use_pallas())


def render_scene(scene: Scene, font_tex, image_atlas=None) -> np.ndarray:
    """Rasterize a compiled Scene → host (H, W, 4) uint8 (screenshot path)."""
    return np.asarray(render_scene_device(scene, font_tex, image_atlas))
