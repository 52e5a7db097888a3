"""Layer-image compose pipeline — steady-state frames become a memory-bound
blend of cached device-resident layers.

The frame cache (render/frame.py) already makes the HOST cheap (~1 KB
upload), but the device still re-composites every command into every tile
each frame (~2.4 ms for a 1280×800 history view). This module exploits the
next invariant of an interactive GUI stream: between frames, the *rendered
pixels* of almost everything are unchanged too —

  * **Chrome runs** (the static command segments between scroll windows,
    in z order) are rendered ONCE per content hash into transparent
    premultiplied RGBA layer images that stay on device.
  * **Scroll windows** are rendered into a device-resident SLAB — a tall
    transparent image in window-content space covering the viewport plus
    ±`OVERSCAN` rows. A scroll frame is then a `dynamic_slice` crop; the
    slab re-renders only when scrolling escapes the overscan or content
    changes (keyed by the window's content uid).
  * **Volatile commands** (scrollbar thumbs — the per-layer dynamic tail)
    are the only per-frame rasterization: one small blocks-kernel pass
    over a transparent canvas.
  * The frame is assembled by ONE jit dispatch that blends the layers
    in z order: a hybrid XLA chain (big layers fused elementwise, small
    crops as static region updates). The blend is a memory-bound
    elementwise chain that XLA fuses, and a slab crop is a
    `dynamic_slice` (an address offset). Under a render MESH the blend
    is one fused full-frame elementwise pass row-sharded across devices.

Exactness: every layer preserves the kernel's per-command compositing
internally; two bounded error terms separate it from the packed path —
(a) layer boundaries re-associate the `over` operator (exact where
layers don't overlap, ≤1 ulp where they do), and (b) CACHED layers
(chrome groups, slabs) store f16 (premultiplied values in [0,1] round
within 2^-11 relative ≈ 0.12 u8 per layer; the blend's device-memory
reads — its entire steady-state cost — halve). Integer scroll offsets
translate
commands exactly in f32 (coordinates are ≤2^13 with 1/8 px
quantization), so slab crops reproduce direct rendering up to the f16
term; the compose path guarantees ≤1 u8 per channel vs the packed path
(tests/test_compose.py sweeps scroll offsets asserting it) and falls
back to the classic frame path whenever an assumption doesn't hold
(non-integer dy). Disable with WGIT_FRAME_COMPOSE=0.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from . import frame as F
from . import rasterizer as R

TILE_H = R.TILE_H
TILE_W = R.TILE_W

# Slab rows beyond the viewport on each side. The window's content uid
# already changes every ~128 px of scroll (layout._OVERSCAN materialization
# buckets), which rebuilds the slab anyway — so the slab only needs to
# cover one uid bucket's worth of scroll, not survive long scrolls.
OVERSCAN = 192

# Device-image caches. Python 3.7+ dicts iterate in insertion order, so
# re-inserting on hit makes `pop(next(iter(...)))` evict the LEAST recently
# used entry, not the steady-state hot set. The caps bound device memory
# regardless of session length: at 1280×800 (f16 premultiplied) groups
# ≤ 12 × ~8 MB + slabs ≤ 24 × ~12 MB ≈ 0.4 GB worst case. Deriving them
# from the device's memory is open work.
_GROUP_CACHE: dict = {}   # group key -> (layer image, oy, ox) per mode
_SLAB_CACHE: dict = {}    # slab key  -> dict(y0s, img)


def _lru_get(cache: dict, key):
    hit = cache.pop(key, None)
    if hit is not None:
        cache[key] = hit  # re-insert → most recently used
    return hit

_CLS_TBL = ((0, 1), (2, 3, 4), (5, 6))  # class -> indices into 7-part tuple


def compose_enabled() -> bool:
    want = os.environ.get("WGIT_FRAME_COMPOSE")
    if want is not None:
        return want not in ("0", "false", "")
    return True


def _render_blocks_image(layers_blocks, font_tex, image_atlas, tiles_y: int,
                         tiles_x: int, height: int, width: int,
                         out_spec: str = "rows", out_dtype: str = "f32"):
    """Render a block list over a TRANSPARENT canvas → (H, W, 4)
    premultiplied layer image (tile axis sharded when a render mesh is
    installed). `out_spec`
    (mesh only): "rows" = even row sharding over all mesh axes (what the
    compose blend consumes with zero per-frame comms); "replicated" =
    full copy per device (what the slab dynamic-slice crop needs — a
    data-dependent slice of a row-sharded dim would force a per-frame
    all-gather)."""
    from .meshstate import get_render_mesh

    return _render_blocks_image_jit(
        layers_blocks, jnp.asarray(font_tex), jnp.asarray(image_atlas),
        tiles_y=tiles_y, tiles_x=tiles_x, height=height, width=width,
        use_pallas=R._use_pallas(), mesh=get_render_mesh(),
        out_spec=out_spec, out_dtype=out_dtype)


@functools.partial(jax.jit, static_argnames=("tiles_y", "tiles_x", "height",
                                             "width", "use_pallas", "mesh",
                                             "out_spec", "out_dtype"))
def _render_blocks_image_jit(layers_blocks, font_tex, image_atlas,
                             tiles_y: int, tiles_x: int, height: int,
                             width: int, use_pallas: bool, mesh=None,
                             out_spec: str = "rows",
                             out_dtype: str = "f32"):
    # CACHED layers (chrome groups, slabs) store f16: premultiplied
    # values in [0,1] lose <2^-12 per channel (~0.06 u8 per layer) and
    # the steady-state blend's device-memory reads — its entire cost —
    # halve.
    # In-executable (dyn) layers stay f32: a cast there saves nothing
    # (fused) and only adds rounding.
    dt = jnp.float16 if out_dtype == "f16" else jnp.float32
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        tiles_planar = F._render_tiles_blocks_sharded(
            layers_blocks, font_tex, image_atlas, None, tiles_y, tiles_x,
            use_pallas, mesh)
        _, ty_pad = F._sharded_tile_rows(tiles_y, tiles_x, mesh)
        img = F.assemble_f32(tiles_planar, ty_pad, tiles_x, height, width)
        # Pin the output sharding explicitly: the tile-row-aligned
        # producer keeps the assemble reshapes GSPMD-clean, and this
        # constraint makes the final layout a deliberate collective
        # (boundary permute for "rows", all-gather for "replicated")
        # instead of whatever propagation infers downstream.
        spec = (P() if out_spec == "replicated"
                else P(tuple(mesh.axis_names)))
        # Cast BEFORE the constraint: a replicated slab's all-gather
        # then moves half the bytes too.
        return jax.lax.with_sharding_constraint(
            img.astype(dt), NamedSharding(mesh, spec))
    tiles = F.render_blocks_planar(layers_blocks, font_tex, image_atlas,
                                   None, tiles_y, tiles_x, use_pallas)
    return F.assemble_f32(tiles, tiles_y, tiles_x, height, width).astype(dt)


def _single_class_blocks(ci: int, block):
    """Wrap one class's block list in the layers_blocks structure."""
    cls = [(), (), ()]
    cls[ci] = (block,)
    return (tuple(cls),)


# ---------------------------------------------------------------------------
# Run flattening: the z-ordered sequence of compose layers.
# ---------------------------------------------------------------------------

def _flatten_runs(scene, chrome_entries, windows, lws_by_layer):
    """→ ordered run list; each run is
    ("chrome", li, ci, si) | ("win", gi, ci) | ("dyn", li, ci)."""
    runs = []
    for li, lb in enumerate(scene.layers):
        ch = chrome_entries[li]
        lws = lws_by_layer[li]
        dyn_counts = (lb.n_dyn_shapes, lb.n_dyn_images, lb.n_dyn_glyphs)
        for zi, ci in enumerate((0, 2, 1)):  # z order: shapes, images, glyphs
            n_seg = len(lws) + 1
            for si in range(n_seg):
                if ch["ks"][ci] and ch["seg_totals"][ci][si]:
                    runs.append(("chrome", li, ci, si))
                if si < len(lws):
                    gi = lws[si]
                    w = windows[gi]
                    counts = (w.comp.shapes.shape[0], w.comp.glyphs.shape[0],
                              w.comp.images.shape[0])
                    if counts[ci]:
                        runs.append(("win", gi, ci))
            if dyn_counts[zi]:
                runs.append(("dyn", li, ci))
    return runs


def _group_chrome(runs):
    """Merge consecutive chrome runs into render groups. Returns a list of
    ops: ("group", [chrome runs...]) | ("win", gi, ci) | ("dyn", li, ci)."""
    ops = []
    for run in runs:
        if run[0] == "chrome":
            if ops and ops[-1][0] == "group":
                ops[-1][1].append(run)
            else:
                ops.append(("group", [run]))
        else:
            ops.append(run)
    return ops


# ---------------------------------------------------------------------------
# Layer image construction.
# ---------------------------------------------------------------------------

def _group_key(members, chrome_entries, height, width):
    return (tuple((chrome_entries[li]["key"], ci, si)
                  for _, li, ci, si in members), height, width)


# Safety margin (px) around a group's ink bbox before cropping: command
# boxes already include the rasterizer's 1.5 px AA pad, this absorbs any
# residual feather.
_BBOX_PAD = 2.0


def _group_bbox(members, chrome_entries, height, width, mode: str):
    """Pixel-aligned ink bbox (y0, x0, y1, x1) of a chrome group, or the
    full frame when mode == "full" (mesh path: the row-sharded blend
    stays full-frame) / when no member reports a box.

    "xla" mode: a bbox covering ≥ half the frame rounds UP to the full
    frame — big layers blend through the fused elementwise chain (one
    XLA kernel with the background + neighbors; cheaper than a region
    slice/update of nearly the whole frame), so cropping only pays on
    genuinely small ink."""
    if mode == "full":
        return (0, 0, height, width)
    x0 = y0 = float("inf")
    x1 = y1 = float("-inf")
    for _, li, ci, si in members:
        sb = chrome_entries[li]["seg_boxes"][ci]
        b = sb[si] if sb is not None else None
        if b is None:
            continue
        x0, y0 = min(x0, b[0]), min(y0, b[1])
        x1, y1 = max(x1, b[2]), max(y1, b[3])
    if not (x1 > x0 and y1 > y0):
        return (0, 0, height, width)
    import math

    oy = max(0, int(math.floor(y0 - _BBOX_PAD)))
    ox = max(0, int(math.floor(x0 - _BBOX_PAD)))
    ey = min(height, int(math.ceil(y1 + _BBOX_PAD)))
    ex = min(width, int(math.ceil(x1 + _BBOX_PAD)))
    if mode == "xla" and (ey - oy) * (ex - ox) * 2 >= height * width:
        return (0, 0, height, width)
    return (oy, ox, ey, ex)


def _chrome_group_image(members, chrome_entries, font_tex, image_atlas,
                        tiles_y, tiles_x, height, width, mode: str):
    """Cached chrome group layer: ((h, w, 4) f16 image cropped to the ink
    bbox, oy, ox) pixel offsets ("full" mode: whole frame — blending
    cropped regions into a row-sharded output would fight GSPMD)."""
    key = (_group_key(members, chrome_entries, height, width), mode)
    hit = _lru_get(_GROUP_CACHE, key)
    if hit is not None:
        return hit
    # One blocks-kernel pass rendering every member segment in z order.
    # Each member gets its own pseudo-layer so the kernel preserves the
    # member order exactly (kernel class order within a layer is fixed).
    layers = []
    for _, li, ci, si in members:
        ch = chrome_entries[li]
        tables = tuple(ch["parts"][j] for j in _CLS_TBL[ci])
        block = (tables, ch["bins"][ci], ch["segs"][ci][si],
                 ch["segs"][ci][si + 1])
        layers.append(_single_class_blocks(ci, block)[0])
    oy, ox, y1, x1 = _group_bbox(members, chrome_entries, height, width,
                                 mode)
    img = _render_blocks_image(tuple(layers), font_tex, image_atlas,
                               tiles_y, tiles_x, height, width,
                               out_dtype="f16")
    if (oy, ox, y1, x1) != (0, 0, height, width):
        # One-time device slice per content change; the steady-state
        # blend then reads only the ink region every frame.
        img = img[oy:y1, ox:x1]
    entry = (img, oy, ox)
    while len(_GROUP_CACHE) > _img_cache_cap(12):
        _GROUP_CACHE.pop(next(iter(_GROUP_CACHE)))
    _GROUP_CACHE[key] = entry
    return entry


def _slab_height(height: int) -> int:
    return -(-(height + 2 * OVERSCAN) // TILE_H) * TILE_H


@functools.partial(jax.jit, static_argnames=("caps",))
def _shift_window_jit(parts, dx, dy, c0, c1, c2, c3, caps: tuple):
    del caps  # signature stability only
    return F._shift_parts(parts, dx, dy, (c0, c1, c2, c3))


def _window_slab(w, gi, ci, art, caps, font_tex, image_atlas, tiles_x,
                 height, width, mode: str):
    """Device-resident content-space slab for one window+class, valid while
    the scroll offset stays within ±OVERSCAN of the build offset. Returns
    (slab, y0s, key) with slab an (slab_h, W, 4) f16 image."""
    slab_h = _slab_height(height)
    dy = float(w.dy)
    key = (w.comp.uid, ci, caps, round(w.dx * 8.0),
           tuple(round(c * 4.0) for c in w.clip), tiles_x, height, mode)
    hit = _lru_get(_SLAB_CACHE, key)
    if hit is not None:
        start = -dy - hit["y0s"]
        if 0.0 <= start <= slab_h - height:
            return hit["img"], hit["y0s"], key
    y0s = -dy - OVERSCAN
    c0, c1, c2, c3 = (float(c) for c in w.clip)
    # Device: dequantized window parts shifted (dx, -y0s); x clip baked,
    # y clip left open (it rides the compose mask, which varies with dy).
    parts = F._win_parts(w.comp.uid, caps, art["blob"])
    shifted = _shift_window_jit(parts, float(w.dx), -y0s,
                                c0, -1e6, c2, 1e6, caps)
    # Host: bins over the slab grid from the window-space boxes.
    boxes = art["boxes"][ci]
    b = boxes + np.array([w.dx, -y0s, w.dx, -y0s], np.float32)
    b = np.stack([np.maximum(b[:, 0], c0), b[:, 1],
                  np.minimum(b[:, 2], c2), b[:, 3]], axis=1)
    tiles_y_slab = slab_h // TILE_H
    bins, _ = R._bin_indexed(b, np.arange(b.shape[0], dtype=np.int64),
                             tiles_y_slab, tiles_x, F._CLS_KCAP[ci])
    counts = (bins >= 0).sum(axis=1).astype(np.int32)
    tables = tuple(shifted[j] for j in _CLS_TBL[ci])
    block = (tables, jnp.asarray(bins), None, jnp.asarray(counts))
    img = _render_blocks_image(_single_class_blocks(ci, block),
                               font_tex, image_atlas, tiles_y_slab,
                               tiles_x, slab_h, width,
                               out_spec="replicated", out_dtype="f16")
    while len(_SLAB_CACHE) > _img_cache_cap(24):
        _SLAB_CACHE.pop(next(iter(_SLAB_CACHE)))
    _SLAB_CACHE[key] = {"img": img, "y0s": y0s}
    return img, y0s, key


# ---------------------------------------------------------------------------
# The fused per-frame step: ONE ~1 KB i16 upload (slab starts + quantized
# volatile tails + their bins) and ONE jit dispatch that renders the
# volatile layers and blends everything — per-frame link traffic stays flat
# no matter how much is cached.
# ---------------------------------------------------------------------------

_DYN_PACK_CACHE: dict = {}


def _dyn_layer_cached(lb, li: int, tiles_y: int, tiles_x: int,
                      subgrid: bool):
    """Content-keyed memo of the volatile tail's quantized blob + bins —
    thumb geometry recurs across a scroll cycle, so steady-state frames
    skip the numpy quantize/bin work entirely."""
    nds, ndg, ndi = lb.n_dyn_shapes, lb.n_dyn_glyphs, lb.n_dyn_images
    s0 = (lb.n_shapes - nds, lb.n_glyphs - ndg, lb.n_images - ndi)
    key = (li, tiles_y, tiles_x, subgrid, nds, ndg, ndi,
           hash(lb.shapes[s0[0]:s0[0] + nds].tobytes()),
           hash(lb.shape_clips[s0[0]:s0[0] + nds].tobytes()),
           hash(lb.glyphs[s0[1]:s0[1] + ndg].tobytes()),
           hash(lb.glyph_colors[s0[1]:s0[1] + ndg].tobytes()),
           hash(lb.glyph_clips[s0[1]:s0[1] + ndg].tobytes()),
           hash(lb.images[s0[2]:s0[2] + ndi].tobytes()),
           hash(lb.image_clips[s0[2]:s0[2] + ndi].tobytes()))
    hit = _DYN_PACK_CACHE.get(key)
    if hit is None:
        hit = F._dyn_layer(lb, li, tiles_y, tiles_x, subgrid=subgrid)
        while len(_DYN_PACK_CACHE) > 512:
            _DYN_PACK_CACHE.pop(next(iter(_DYN_PACK_CACHE)))
        _DYN_PACK_CACHE[key] = hit
    return hit


def _pack_frame_blob(scene, slab_starts, tiles_y: int, tiles_x: int):
    """→ (blob i16, dyn_meta) where dyn_meta[li] = (caps3, ks3, c0, c1).
    Single chip: the volatile tail's bins cover only its tile-column
    range; under a mesh the full grid (the sharded tile render needs
    the whole axis)."""
    from .meshstate import get_render_mesh

    subgrid = get_render_mesh() is None
    parts = [np.asarray(slab_starts, np.int16)]
    dyn_meta = []
    for li, lb in enumerate(scene.layers):
        dyn_blob, dyn_bins, meta = _dyn_layer_cached(lb, li, tiles_y,
                                                     tiles_x, subgrid)
        parts += [dyn_blob, dyn_bins]
        dyn_meta.append(meta)
    return (np.concatenate(parts) if parts else np.zeros(0, np.int16),
            tuple(dyn_meta))


@functools.partial(
    jax.jit, static_argnames=("meta", "background", "height", "width",
                              "tiles_y", "tiles_x", "use_pallas", "mesh"))
def _compose_frame(blob, images, slabs, font_tex, image_atlas,
                   background: tuple, height: int, width: int,
                   tiles_y: int, tiles_x: int, meta: tuple,
                   use_pallas: bool, mesh=None):
    """meta = (ops, dyn_meta, n_slabs); ops entries —
    ("img", i, oy, ox): composite images[i] at pixel offsets (oy, ox);
    ("slab", j, clip): crop slabs[j] at blob start j, mask to clip;
    ("dyn", li, ci): render that volatile tail from the blob and
    composite."""
    ops, dyn_meta, n_slabs = meta
    starts = blob[:n_slabs].astype(jnp.int32)
    fo = n_slabs

    # Volatile tails: dequantize tables + bins from the blob, render each
    # (layer, class) run to a transparent layer image (in-executable — no
    # extra dispatch). Single chip: the render grid is the tail's tile-
    # COLUMN range only (meta c0/c1 — stable across a scroll because a
    # thumb stays in its column); dyn_imgs values carry their x offset.
    dyn_imgs = {}
    for li, (dyn_caps, dyn_ks, c0, c1) in enumerate(dyn_meta):
        ts = c1 - c0
        Tsub = tiles_y * ts
        x0px = c0 * TILE_W
        sub_w = min(ts * TILE_W, width - x0px)
        dyn_tables = None
        if sum(dyn_caps):
            nwords = sum(dyn_caps[F._PART_CLS[name]] * cols
                         for name, cols, _ in R._PART_SPECS)
            dyn_tables = F._dequant_parts_traced(blob[fo:fo + nwords],
                                                 dyn_caps)
            if x0px:
                # Bins were built on the sub-grid; shift the commands to
                # match (pure translate — clip bounds wide open).
                dyn_tables = F._shift_parts(
                    dyn_tables, float(-x0px), 0.0,
                    (-1e6, -1e6, 1e6, 1e6))
            fo += nwords
        for ci in range(3):
            k = dyn_ks[ci]
            if k == 0:
                continue
            b = blob[fo:fo + Tsub * k].reshape(Tsub, k).astype(jnp.int32)
            fo += Tsub * k
            if dyn_tables is None or sub_w <= 0:
                continue
            tabs = tuple(dyn_tables[j] for j in _CLS_TBL[ci])
            cnt = jnp.sum(b >= 0, axis=1, dtype=jnp.int32)
            block = (tabs, b, None, cnt)
            dyn_imgs[(li, ci)] = (_render_blocks_image_jit(
                _single_class_blocks(ci, block), font_tex,
                image_atlas, tiles_y=tiles_y, tiles_x=ts,
                height=height, width=sub_w, use_pallas=use_pallas,
                mesh=mesh), x0px)

    out_rgb = jnp.broadcast_to(
        jnp.asarray(background[:3], jnp.float32), (height, width, 3))
    if mesh is not None:
        # Row-shard the memory-bound blend across the mesh (GSPMD: the
        # constraint propagates through the elementwise ops; slab crops
        # read replicated slabs, so each device slices its own rows).
        # Layers blend full-frame here — region slice/update against a
        # row-sharded output would fight GSPMD (the r03 remat lesson).
        from jax.sharding import NamedSharding, PartitionSpec as P

        rows = (jnp.arange(height, dtype=jnp.float32) + 0.5)[:, None]
        cols = (jnp.arange(width, dtype=jnp.float32) + 0.5)[None, :]
        out_rgb = jax.lax.with_sharding_constraint(
            out_rgb, NamedSharding(mesh, P(tuple(mesh.axis_names))))
        for op in ops:
            if op[0] == "img":
                img = images[op[1]].astype(jnp.float32)  # f16 cached
                rgb, a = img[..., :3], img[..., 3]
            elif op[0] == "slab":
                _, j, clip = op
                crop = jax.lax.dynamic_slice(
                    slabs, (j, starts[j], 0, 0), (1, height, width, 4)
                )[0].astype(jnp.float32)                 # f16 cached
                mask = ((rows >= clip[1]) & (rows <= clip[3])
                        & (cols >= clip[0]) & (cols <= clip[2])
                        ).astype(jnp.float32)
                rgb = crop[..., :3] * mask[..., None]
                a = crop[..., 3] * mask
            else:
                hit = dyn_imgs.get((op[1], op[2]))
                if hit is None:
                    continue
                img = hit[0]   # full-frame under mesh (c0=0, c1=tiles_x)
                rgb, a = img[..., :3], img[..., 3]
            out_rgb = rgb + out_rgb * (1.0 - a)[..., None]
    else:
        # Single chip, HYBRID schedule: big layers — full-frame chrome,
        # slab crops, wide volatile tails — blend through the plain
        # elementwise chain, which XLA fuses with the background/neighbors
        # into single kernels (one out traversal per fused segment); only
        # genuinely SMALL crops (badges, thumbs — bbox < half frame) blend
        # as a static slice → over → in-place region update, so their
        # cost is their ink, not a full-frame read. Region ops are rare,
        # so they barely interrupt fusion.
        rows = (jnp.arange(height, dtype=jnp.float32) + 0.5)[:, None]
        for op in ops:
            if op[0] == "img":
                _, i, oy, ox = op
                img = images[i].astype(jnp.float32)      # f16 cropped
                h, w = img.shape[0], img.shape[1]
                if h == 0 or w == 0:
                    continue
                rgb, a = img[..., :3], img[..., 3]
                if (h, w) == (height, width):
                    out_rgb = rgb + out_rgb * (1.0 - a)[..., None]
                    continue
                region = jax.lax.slice(out_rgb, (oy, ox, 0),
                                       (oy + h, ox + w, 3))
                region = rgb + region * (1.0 - a)[..., None]
                out_rgb = jax.lax.dynamic_update_slice(
                    out_rgb, region, (oy, ox, 0))
            elif op[0] == "slab":
                _, j, clip = op
                # Full-frame masked blend, fused with its elementwise
                # neighbors. The slab bakes its x clip at build; only
                # the y clip (scroll-dependent) masks here.
                crop = jax.lax.dynamic_slice(
                    slabs[j], (starts[j], 0, 0), (height, width, 4)
                ).astype(jnp.float32)                    # f16 cached
                mask = ((rows >= clip[1]) & (rows <= clip[3])
                        ).astype(jnp.float32)
                mask = jnp.broadcast_to(mask, (height, width))
                rgb = crop[..., :3] * mask[..., None]
                a = crop[..., 3] * mask
                out_rgb = rgb + out_rgb * (1.0 - a)[..., None]
            else:
                hit = dyn_imgs.get((op[1], op[2]))
                if hit is None:
                    continue
                img, x0 = hit
                w = img.shape[1]
                rgb, a = img[..., :3], img[..., 3]
                if w == width:
                    out_rgb = rgb + out_rgb * (1.0 - a)[..., None]
                    continue
                region = jax.lax.slice(out_rgb, (0, x0, 0),
                                       (height, x0 + w, 3))
                region = rgb + region * (1.0 - a)[..., None]
                out_rgb = jax.lax.dynamic_update_slice(
                    out_rgb, region, (0, x0, 0))
    out = jnp.concatenate(
        [out_rgb, jnp.ones((height, width, 1), jnp.float32)], axis=-1)
    return jnp.clip(out * 255.0 + 0.5, 0.0, 255.0).astype(jnp.uint8)


# Plan memo: everything about a frame that is NOT the scroll offset.
# A steady scroll frame re-validates the plan with hash lookups, computes
# the slab crop starts, and issues the single _compose_frame dispatch with
# pre-stacked device args — no flatten/group/slab rebuilding, no per-image
# dispatch overhead.
def _img_cache_cap(hbm_cap: int) -> int:
    """Image-cache capacity, scaled down on the CPU backend: these
    caches hold full-frame images that live in device memory on an
    accelerator but in process RSS on CPU — the accelerator caps plateau
    a CPU-backend session at ~3 GB (measured, 4-min mutation soak)."""
    import jax

    return hbm_cap if jax.default_backend() != "cpu" \
        else max(2, hbm_cap // 4)


_PLAN_CACHE: dict = {}
_BLOB_DEV_CACHE: dict = {}
_STACK_CACHE: dict = {}   # (kind, member keys, dims) -> stacked device array


def _memo_stack(kind: str, keys: tuple, arrays, empty_shape):
    """Layer-image collection memoized by the members' content keys. A
    plan rebuild happens every ~128 px of scroll (window uid moves with
    the layout materialization bucket) and on any chrome change;
    whichever side (chrome group images / slabs) is still a cache hit
    reuses the previous collection object — the bench and tests key on
    its identity.

    Single-chip: a plain TUPLE of the cache-resident device images —
    zero copies, and bbox-cropped chrome images keep their individual
    shapes. Under a render mesh: one jnp.stack pinned to the sharding
    `_compose_frame` consumes — "img" stacks row-sharded on dim 1 (the
    blend reads rows locally), "slab" stacks replicated (the
    data-dependent dynamic-slice crop must not gather) — so the blend's
    jit sees aligned input layouts instead of whatever stack propagation
    inferred (the r03 involuntary-rematerialization source)."""
    from .meshstate import get_render_mesh

    mesh = get_render_mesh()
    key = (kind, keys, empty_shape, mesh)
    hit = _lru_get(_STACK_CACHE, key)
    if hit is not None:
        return hit
    if mesh is None:
        out = tuple(arrays)
    else:
        out = (jnp.stack(arrays) if arrays
               else jnp.zeros(empty_shape, jnp.float16))
        from jax.sharding import NamedSharding, PartitionSpec as P

        spec = P() if kind == "slab" else P(None, tuple(mesh.axis_names))
        out = jax.device_put(out, NamedSharding(mesh, spec))
    while len(_STACK_CACHE) > _img_cache_cap(8):
        _STACK_CACHE.pop(next(iter(_STACK_CACHE)))
    _STACK_CACHE[key] = out
    return out


def _build_plan(scene, windows, chrome_entries, win_art, win_caps,
                lws_by_layer, font_tex, image_atlas, tiles_y, tiles_x,
                height, width):
    from .meshstate import get_render_mesh

    mode = "full" if get_render_mesh() is not None else "xla"
    runs = _flatten_runs(scene, chrome_entries, windows, lws_by_layer)
    ops = _group_chrome(runs)
    images, slabs, op_meta = [], [], []
    img_keys, slab_keys = [], []
    slab_src = []  # (gi, y0s) per slab, for per-frame start computation
    for op in ops:
        if op[0] == "group":
            img, oy, ox = _chrome_group_image(op[1], chrome_entries,
                                              font_tex, image_atlas,
                                              tiles_y, tiles_x,
                                              height, width, mode)
            op_meta.append(("img", len(images), oy, ox))
            images.append(img)
            img_keys.append((_group_key(op[1], chrome_entries, height,
                                        width), mode))
        elif op[0] == "win":
            _, gi, ci = op
            w = windows[gi]
            slab, y0s, skey = _window_slab(w, gi, ci, win_art[gi],
                                           win_caps[gi], font_tex,
                                           image_atlas, tiles_x,
                                           height, width, mode)
            clip = tuple(round(float(c) * 4.0) / 4.0 for c in w.clip)
            op_meta.append(("slab", len(slabs), clip))
            slabs.append(slab)
            slab_keys.append((skey, y0s))
            slab_src.append((gi, y0s))
        else:
            op_meta.append(op)  # ("dyn", li, ci) — rendered inside the jit
    slab_h = _slab_height(height)
    return {
        "ops": tuple(op_meta),
        # one stacked device array per kind → constant dispatch arg count
        "img_stack": _memo_stack("img", tuple(img_keys), images,
                                 (0, height, width, 4)),
        "slab_stack": _memo_stack("slab", tuple(slab_keys), slabs,
                                  (0, slab_h, width, 4)),
        "slab_src": tuple(slab_src),
        "slab_h": slab_h,
    }


def render_frame_composed(scene, font_tex, image_atlas):
    """Compose-path frame render → (H, W, 4) u8 device image, or None when
    an assumption doesn't hold (caller falls back to the classic path)."""
    prepared = prepare_compose_dispatch(scene, font_tex, image_atlas)
    if prepared is None:
        return None
    args, statics = prepared
    return _compose_frame(*args, **statics)


def prepare_compose_dispatch(scene, font_tex, image_atlas):
    """Everything `render_frame_composed` would pass to `_compose_frame`,
    as `(args, statics)` — or None when the compose path can't serve the
    scene. Split out so the bench's device-time probe (bench.py) can
    pack N steady-state frames' blobs and run them in ONE jitted scan:
    the device-time counterpart of the per-frame wall metrics."""
    from .meshstate import get_render_mesh

    windows = list(getattr(scene, "windows", ()) or ())
    for w in windows:
        if float(w.dy) != float(int(w.dy)):
            return None  # sub-pixel scroll: crop can't reproduce it
    tiles_x = -(-scene.width // TILE_W)
    tiles_y = -(-scene.height // TILE_H)
    height, width = scene.height, scene.width

    lws_by_layer = []
    chrome_entries = []
    win_art = {}
    slot_count: dict[int, int] = {}
    win_caps = {}
    for gi, w in enumerate(windows):
        slot = slot_count.get(w.layer, 0)
        slot_count[w.layer] = slot + 1
        caps = R._window_caps(w, slot)
        win_caps[gi] = caps
        win_art[gi] = R._window_artifacts(w, caps)
    for li, lb in enumerate(scene.layers):
        lws = [gi for gi, w in enumerate(windows) if w.layer == li]
        lws_by_layer.append(lws)
        pos_lists = tuple(tuple(windows[gi].pos[ci] for gi in lws)
                          for ci in range(3))
        chrome_entries.append(F._chrome_entry(lb, li, pos_lists, tiles_y,
                                              tiles_x))

    plan_key = (tuple(ch["key"] for ch in chrome_entries),
                tuple((w.comp.uid, win_caps[gi], w.layer,
                       round(float(w.dx) * 8.0),
                       tuple(round(float(c) * 4.0) for c in w.clip))
                      for gi, w in enumerate(windows)),
                # Volatile-tail PRESENCE per (layer, class): the ops list
                # only contains ("dyn", li, ci) entries for classes that
                # had dyn commands at build time, so a dyn class
                # appearing under identical chrome bytes (the exact
                # situation El.volatile exists for) must invalidate the
                # plan or it would never be composited.
                tuple((lb.n_dyn_shapes > 0, lb.n_dyn_images > 0,
                       lb.n_dyn_glyphs > 0) for lb in scene.layers),
                height, width,
                # Mesh identity: a plan's layer collections are bbox-
                # cropped f16 tuples (single chip) or full-frame sharded
                # stacks (mesh) — a plan built under one must never
                # serve the other (render_scene_sharded flips the mesh
                # per call without clearing caches).
                get_render_mesh())
    plan = _lru_get(_PLAN_CACHE, plan_key)
    if plan is not None:
        # slab validity: the crop must stay inside every cached slab
        for j, (gi, y0s) in enumerate(plan["slab_src"]):
            start = -float(windows[gi].dy) - y0s
            if not (0.0 <= start <= plan["slab_h"] - height):
                plan = None
                break
    if plan is None:
        plan = _build_plan(scene, windows, chrome_entries, win_art,
                           win_caps, lws_by_layer, font_tex, image_atlas,
                           tiles_y, tiles_x, height, width)
        # Plans hold strong refs to their stacked device arrays (a slab
        # stack is ~20 MB at 1280×800), so the cap bounds the device
        # memory high-water mark — but it must exceed the number of
        # scroll materialization buckets a continuous scroll cycles
        # through (~5 for a 400 px sweep at the 128 px bucket size), or
        # every cycle evicts the plan it is about to need; 6 plans
        # sharing stacks via _memo_stack is ≈300 MB worst case.
        # (CPU backend stays at the RSS-tuned cap of 2.)
        while len(_PLAN_CACHE) > _img_cache_cap(6):
            _PLAN_CACHE.pop(next(iter(_PLAN_CACHE)))
        _PLAN_CACHE[plan_key] = plan

    starts = [int(-float(windows[gi].dy) - y0s)
              for gi, y0s in plan["slab_src"]]
    blob, dyn_meta = _pack_frame_blob(scene, starts, tiles_y, tiles_x)
    # Scroll positions and thumb geometry recur: keep the uploaded blob
    # device-resident keyed by content, so a revisited frame state ships
    # ZERO bytes (a host→device transfer has a fixed latency that
    # dominates a ~1 KB upload).
    bkey = hash(blob.tobytes())
    blob_dev = _lru_get(_BLOB_DEV_CACHE, bkey)
    if blob_dev is None or blob_dev.shape != blob.shape:
        blob_dev = jnp.asarray(blob)
        # ~1 KB device arrays; 512 entries cover scroll-offset × pulse-
        # phase combinations so animated steady states still recur.
        while len(_BLOB_DEV_CACHE) > 512:
            _BLOB_DEV_CACHE.pop(next(iter(_BLOB_DEV_CACHE)))
        _BLOB_DEV_CACHE[bkey] = blob_dev
    meta = (plan["ops"], dyn_meta, len(starts))
    args = (blob_dev, plan["img_stack"], plan["slab_stack"], font_tex,
            image_atlas)
    statics = dict(background=tuple(float(c) for c in scene.background[:3]),
                   height=height, width=width, tiles_y=tiles_y,
                   tiles_x=tiles_x, meta=meta, use_pallas=R._use_pallas(),
                   mesh=get_render_mesh())
    return args, statics


@functools.partial(
    jax.jit, static_argnames=("background", "height", "width", "tiles_y",
                              "tiles_x", "meta", "use_pallas", "mesh"))
def _compose_scan_jit(blobs, images, slabs, font_tex, image_atlas,
                      background: tuple, height: int, width: int,
                      tiles_y: int, tiles_x: int, meta: tuple,
                      use_pallas: bool, mesh=None):
    def body(carry, blob):
        img = _compose_frame(blob, images, slabs, font_tex, image_atlas,
                             background=background, height=height,
                             width=width, tiles_y=tiles_y, tiles_x=tiles_x,
                             meta=meta, use_pallas=use_pallas, mesh=mesh)
        # Fold every frame into the carry so no iteration can be DCE'd.
        return carry ^ jnp.sum(img[..., 0].astype(jnp.uint32)), None

    out, _ = jax.lax.scan(body, jnp.uint32(0), blobs)
    return out


def compose_scan_probe(blobs, images, slabs, font_tex, image_atlas,
                       statics: dict):
    """Render blobs.shape[0] steady-state frames in ONE dispatch (a jitted
    lax.scan over the per-frame blobs; plan stacks shared) → u32 checksum.
    The bench's device-time metric: it amortizes one dispatch + one sync
    over N frames, and timing two N values removes even that constant."""
    return _compose_scan_jit(blobs, images, slabs, font_tex, image_atlas,
                             **statics)


def clear_caches() -> None:
    _GROUP_CACHE.clear()
    _SLAB_CACHE.clear()
    _DYN_PACK_CACHE.clear()
    _PLAN_CACHE.clear()
    _BLOB_DEV_CACHE.clear()
    _STACK_CACHE.clear()
