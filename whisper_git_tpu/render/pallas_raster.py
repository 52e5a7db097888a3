"""Rasterizer kernel for NVIDIA GPUs — Pallas on the Triton route.

The XLA reference (`frame._render_tiles_blocks_xla`) folds every tile over
its padded bin row with `lax.scan`: on the GPU that becomes a device
while-loop of K steps per pass in which every slot — padding included —
slices its atlas cell and round-trips the framebuffer. This kernel does
the same per-command math with the loop bounded by each tile's real
occupancy:

  * grid = (tile, sub-tile row): one program composites a SUB_H × TILE_W
    slice of one binning tile through every block of every layer, the
    framebuffer held in registers as four channel planes;
  * each block's loop runs `lo[t]..hi[t]` (the tile's own occupancy,
    loaded by the program itself), reading the command index from the
    bins table and the command's scalars straight from device memory;
  * glyph cells are sliced from the atlas in device memory (both font
    weights together are a few MB, which stays in L2) and resampled by
    two bf16 `pl.dot` products with f32 accumulation (`W_y @ cell @
    W_xᵀ` — the no-gather bilinear trick, docs/render-engine.md rule 1);
    image quads use the same products in IEEE f32.

The output is four (T, TILE_H, TILE_W) f32 channel planes, stacked to the
planar (T, 4, TILE_H, TILE_W) layout that `frame.assemble_f32` consumes.
`interpret=True` runs the kernel on the CPU (tests/test_pallas_raster.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from . import rasterizer as R

TILE_H = R.TILE_H
TILE_W = R.TILE_W
CELL = R.CELL
SDF_SPREAD = R.SDF_SPREAD

# One program's slice of a binning tile, and its warp count: the four
# f32 channel planes of a SUB_H × TILE_W slice are what each program keeps
# in registers (SUB_H · TILE_W · 4 / (32 · NUM_WARPS) = 64 per thread).
# Provisional: on the H100 the best four of (SUB_H, NUM_WARPS) ∈
# {16, 32, 64} × {2, 4, 8} time the packed 1280×800 frame within each
# other's sample spread (PERF.md).
SUB_H = 32
NUM_WARPS = 8

_Z_ORDER = (0, 2, 1)   # shapes → images → glyphs (scene.py contract)


def _sample_weights(s, j, atlas_extent):
    """Bilinear weights of sample positions `s` against cell texel
    centres `j` (broadcast against each other), zero outside the quad."""
    w = jnp.clip(1.0 - jnp.abs(s - j), 0.0, 1.0)
    inside = ((s > -1.0) & (s < atlas_extent)).astype(jnp.float32)
    return w * inside


def _kernel(*refs, plan, n_in, tiles_x, sub_h, background, font_pos,
            img_pos, tile0_pos):
    ins, outs = refs[:n_in], refs[n_in:]
    t = pl.program_id(0)
    s = pl.program_id(1)
    gt = t if tile0_pos is None else t + ins[tile0_pos][0]
    ox = ((gt % tiles_x) * TILE_W).astype(jnp.float32)
    oy = ((gt // tiles_x) * TILE_H + s * sub_h).astype(jnp.float32)
    px = jnp.arange(TILE_W, dtype=jnp.int32).astype(jnp.float32)[None, :] \
        + (ox + 0.5)                                        # (1, TW)
    py = jnp.arange(sub_h, dtype=jnp.int32).astype(jnp.float32)[:, None] \
        + (oy + 0.5)                                        # (SH, 1)
    cell_row = jnp.arange(CELL, dtype=jnp.int32).astype(
        jnp.float32)[None, :]                               # (1, CELL)
    cell_col = jnp.arange(CELL, dtype=jnp.int32).astype(
        jnp.float32)[:, None]                               # (CELL, 1)
    shape = (sub_h, TILE_W)

    if background is None:  # transparent canvas (compose layers)
        fb = tuple(jnp.zeros(shape, jnp.float32) for _ in range(4))
    else:
        fb = tuple(jnp.full(shape, v, jnp.float32)
                   for v in (background[0], background[1], background[2],
                             1.0))

    def clip_mask(clips, i):
        return ((px >= clips[i, 0]) & (py >= clips[i, 1])
                & (px <= clips[i, 2]) & (py <= clips[i, 3])
                ).astype(jnp.float32)

    def over(fb, r, g, b, a):
        inv = 1.0 - a
        return (r * a + fb[0] * inv, g * a + fb[1] * inv,
                b * a + fb[2] * inv, a + fb[3] * inv)

    def weights(x, y, w, h, uw, uh):
        wy = _sample_weights((py - y) / jnp.maximum(h, 1e-6) * uh - 0.5,
                             cell_row, uh)                  # (SH, CELL)
        wxT = _sample_weights((px - x) / jnp.maximum(w, 1e-6) * uw - 0.5,
                              cell_col, uw)                 # (CELL, TW)
        return wy, wxT

    def shape_step(fb, tables, i):
        shapes, sclips = tables
        c = [shapes[i, j] for j in range(16)]
        clip = clip_mask(sclips, i)
        is_seg = c[0] == 1.0
        hx, hy = c[3] * 0.5, c[4] * 0.5
        cx, cy = c[1] + hx, c[2] + hy
        r = jnp.minimum(c[5], jnp.minimum(hx, hy))
        qx = jnp.abs(px - cx) - (hx - r)
        qy = jnp.abs(py - cy) - (hy - r)
        d_rect = (jnp.sqrt(jnp.maximum(qx, 0.0) ** 2
                           + jnp.maximum(qy, 0.0) ** 2)
                  + jnp.minimum(jnp.maximum(qx, qy), 0.0) - r)
        ax, ay, bx, by = c[1], c[2], c[3], c[4]
        abx, aby = bx - ax, by - ay
        denom = jnp.maximum(abx * abx + aby * aby, 1e-6)
        tt = jnp.clip(((px - ax) * abx + (py - ay) * aby) / denom, 0.0, 1.0)
        d_seg = jnp.sqrt((px - (ax + tt * abx)) ** 2
                         + (py - (ay + tt * aby)) ** 2) - c[5]
        d = jnp.where(is_seg, d_seg, d_rect)
        cov = jnp.clip(0.5 - d, 0.0, 1.0) * clip
        fb = over(fb, c[7], c[8], c[9], cov * c[10])
        has_border = jnp.logical_and(jnp.logical_not(is_seg), c[6] > 0.0)
        cov_b = (jnp.clip(0.5 - d, 0.0, 1.0)
                 * jnp.clip(d + c[6] + 0.5, 0.0, 1.0)
                 * clip * has_border.astype(jnp.float32))
        return over(fb, c[11], c[12], c[13], cov_b * c[14])

    def glyph_step(fb, tables, i):
        glyphs, gcolors, gclips = tables
        x, y, w, h = glyphs[i, 0], glyphs[i, 1], glyphs[i, 2], glyphs[i, 3]
        u, v, uw, uh = glyphs[i, 4], glyphs[i, 5], glyphs[i, 6], glyphs[i, 7]
        clip = clip_mask(gclips, i)
        patch = ins[font_pos][pl.ds(v.astype(jnp.int32), CELL),
                              pl.ds(u.astype(jnp.int32), CELL)]
        wy, wxT = weights(x, y, w, h, uw, uh)
        # bf16 weights (the SDF encoding spans 0..255 with a ±1-unit
        # tolerance, ≪ the 0.7 px AA transition). The f32 intermediate
        # enters the second product as hi + lo bf16 terms (~16 bits), as
        # in the XLA pass (rasterizer._glyphs_pass).
        enc0 = pl.dot(wy.astype(jnp.bfloat16),
                      patch.astype(jnp.float32).astype(jnp.bfloat16))
        hi = enc0.astype(jnp.bfloat16)
        lo = (enc0 - hi.astype(jnp.float32)).astype(jnp.bfloat16)
        wxT = wxT.astype(jnp.bfloat16)
        enc = pl.dot(hi, wxT) + pl.dot(lo, wxT)
        d = (128.0 - enc) * (SDF_SPREAD / 128.0) \
            * (w / jnp.maximum(uw, 1e-6))
        cov = jnp.clip(0.5 - d / 0.7, 0.0, 1.0) * clip
        return over(fb, gcolors[i, 0], gcolors[i, 1], gcolors[i, 2],
                    cov * gcolors[i, 3])

    def image_step(fb, tables, i):
        images, iclips = tables
        x, y, w, h = images[i, 0], images[i, 1], images[i, 2], images[i, 3]
        u, v, uw, uh = images[i, 4], images[i, 5], images[i, 6], images[i, 7]
        clip = clip_mask(iclips, i)
        wy, wxT = weights(x, y, w, h, uw, uh)
        chans = []
        for ch in range(4):
            patch = ins[img_pos][pl.ds(v.astype(jnp.int32), CELL),
                                 pl.ds(u.astype(jnp.int32), CELL), ch]
            val = pl.dot(pl.dot(wy, patch.astype(jnp.float32),
                                allow_tf32=False), wxT, allow_tf32=False)
            chans.append(val * (1.0 / 255.0))
        return over(fb, chans[0], chans[1], chans[2], chans[3] * clip)

    steps = (shape_step, glyph_step, image_step)
    for layer in plan:
        for ci in _Z_ORDER:
            for tpos, bpos, lpos, hpos in layer[ci]:
                tables = tuple(ins[p] for p in tpos)
                bins = ins[bpos]
                lo = 0 if lpos is None else ins[lpos][t]
                hi = ins[hpos][t]

                def body(k, fb, tables=tables, bins=bins, step=steps[ci]):
                    return step(fb, tables, bins[t, k])

                fb = jax.lax.fori_loop(lo, hi, body, fb)

    for out, plane in zip(outs, fb):
        out[...] = plane


def render_tiles_blocks(layers_blocks, font_tex, image_atlas, background,
                        tiles_y: int, tiles_x: int, interpret: bool = False,
                        n_tiles: int | None = None, tile0=None):
    """layers_blocks: tuple per layer of 3 per-class block tuples
    (shapes, glyphs, images order); block = (tables, bins (T, k),
    lo (T,) | None, hi (T,)) with bins[t, lo[t]:hi[t]] the tile's command
    indices in paint order. font_tex: (H, W) u8 SDF atlas; image_atlas:
    (H, W, 4) u8. background None renders a transparent canvas. Returns
    planar f32 tiles (T, 4, TILE_H, TILE_W).

    Under `shard_map` each device renders its local contiguous tile
    slice: `n_tiles` is the slice length and `tile0` a traced global
    offset — pixel origins use the global tile id, bins stay local."""
    T = n_tiles if n_tiles is not None else tiles_y * tiles_x
    inputs: list = []
    pos: dict = {}

    def add(arr):
        key = id(arr)
        if key not in pos:
            pos[key] = len(inputs)
            inputs.append(arr)
        return pos[key]

    any_glyphs = any(layer[1] for layer in layers_blocks)
    any_images = any(layer[2] for layer in layers_blocks)
    font_pos = add(font_tex) if any_glyphs else None
    img_pos = add(image_atlas) if any_images else None
    tile0_pos = (None if tile0 is None
                 else add(jnp.asarray(tile0, jnp.int32).reshape(1)))
    plan = tuple(
        tuple(tuple((tuple(add(tb) for tb in tables), add(bins),
                     None if lo is None else add(lo), add(hi))
                    for tables, bins, lo, hi in layer[ci])
              for ci in range(3))
        for layer in layers_blocks)

    kernel = functools.partial(
        _kernel, plan=plan, n_in=len(inputs), tiles_x=tiles_x, sub_h=SUB_H,
        background=background, font_pos=font_pos, img_pos=img_pos,
        tile0_pos=tile0_pos)
    plane = pl.BlockSpec((None, SUB_H, TILE_W), lambda t, s: (t, s, 0))
    planes = pl.pallas_call(
        kernel,
        grid=(T, TILE_H // SUB_H),
        out_specs=[plane] * 4,
        out_shape=[jax.ShapeDtypeStruct((T, TILE_H, TILE_W), jnp.float32)]
        * 4,
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="wgit_raster_tiles",
    )(*inputs)
    return jnp.stack(planes, axis=1)
