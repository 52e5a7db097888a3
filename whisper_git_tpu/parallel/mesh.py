"""Mesh-sharded rendering: the frame pipeline over `jax.sharding.Mesh`.

Two parallel axes, following the scaling-book recipe (pick a mesh,
annotate shardings, let XLA insert collectives):

  dp — data parallel over independent frames (scenes): each device group
       renders different frames (golden-dump sweeps, animation batches).
  sp — spatial parallel over framebuffer tiles within one frame: the tile
       axis is sharded, command buffers + atlases are replicated, and the
       assembled frame is the all-gather of tile outputs (XLA inserts it
       from the out_spec).

Two consumers:

  * The PRODUCTION steady-state paths — the device-resident frame cache
    (render/frame.py) and the layer compose pipeline (render/compose.py)
    that the interactive app and bench actually run — shard through
    `set_render_mesh`: their per-tile kernels run under shard_map with
    the tile axis split across the mesh, and the compose blend carries a
    row-sharding constraint. The app installs this automatically when
    more than one chip is visible (render/meshstate.maybe_auto_mesh,
    called from Renderer.__init__). `render_scene_sharded` is a thin
    convenience over this path (install mesh → render → restore).
  * `render_batch_sharded` below exists for the
    BATCHED dp-axis sweep only (B frames data-parallel × tiles spatial —
    golden-dump sweeps, animation batches; the production frame paths
    have no frame-batch axis).

Numerics: the per-tile bodies are the single-chip kernels, so the paths
cannot drift structurally; EVERY sharded render is held to ±4/255 vs
single-chip (bf16 sampler re-association under shard_map and per
shard shape — typically ≤1 u8 in practice; tests/test_parallel.py
asserts the bound with the device caches cleared so the sharded
kernels provably run).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..render import rasterizer as R
from ..render.meshstate import (  # noqa: F401  (public re-exports)
    get_render_mesh,
    maybe_auto_mesh,
    set_render_mesh,
)


def make_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None
              ) -> Mesh:
    """Build a (dp, sp) mesh over the available devices. dp defaults to 1
    (pure spatial sharding)."""
    devices = jax.devices()
    n = n_devices or len(devices)
    devices = np.array(devices[:n])
    dp = dp or 1
    assert n % dp == 0, f"{n} devices not divisible by dp={dp}"
    return Mesh(devices.reshape(dp, n // dp), ("dp", "sp"))


def render_scene_sharded(scene, font_tex: np.ndarray, mesh: Mesh
                         ) -> np.ndarray:
    """Single frame over the mesh THROUGH THE PRODUCTION KERNELS.

    Installs `mesh` via set_render_mesh and renders with
    `render_scene_device` — the same frame-cache/compose pipeline the
    interactive app and bench run — then restores the previous mesh.
    One code path, one numerics story (module docstring: ±4/255 vs
    single-chip from bf16 sampler re-association, typically ≤1).
    Batched multi-frame sweeps keep `render_batch_sharded` below.

    Note: with WGIT_FRAME_CACHE=0 the device path falls back to the
    single-shot packed raster, which renders single-chip (the frame
    cache / compose pipelines are where the mesh plumbing lives)."""
    prev = get_render_mesh()
    set_render_mesh(mesh)
    try:
        return np.asarray(R.render_scene_device(scene, font_tex,
                                                scene.image_atlas))
    finally:
        set_render_mesh(prev)


def _render_tile_slice(layer_data, font_tex, image_atlas, background,
                       tiles_x: int, layer_sig: tuple, tile0, local_t: int):
    """Rasterize `local_t` tiles starting at global tile id `tile0`. The
    body reuses the single-chip passes (R._shapes_pass etc.)."""
    yy = jax.lax.broadcasted_iota(jnp.float32, (R.TILE_H, R.TILE_W), 0)
    xx = jax.lax.broadcasted_iota(jnp.float32, (R.TILE_H, R.TILE_W), 1)

    bins_flat = []
    for li in range(len(layer_sig)):
        bins_flat += [layer_data[li][7], layer_data[li][8],
                      layer_data[li][9]]

    local_ids = jnp.arange(local_t)
    global_ids = tile0 + local_ids
    org_x = (global_ids % tiles_x).astype(jnp.float32) * R.TILE_W
    org_y = (global_ids // tiles_x).astype(jnp.float32) * R.TILE_H

    def tile_fn(ox, oy, *tile_bins):
        px = xx + ox + 0.5
        py = yy + oy + 0.5
        fb = jnp.zeros((R.TILE_H, R.TILE_W, 4), jnp.float32)
        fb = fb.at[..., :3].set(jnp.asarray(background[:3], jnp.float32))
        fb = fb.at[..., 3].set(1.0)
        for li, (has_s, has_g, has_i) in enumerate(layer_sig):
            (shapes, shape_clips, glyphs, glyph_colors, glyph_clips,
             images, image_clips) = layer_data[li][:7]
            s_bins, g_bins, i_bins = (tile_bins[3 * li],
                                      tile_bins[3 * li + 1],
                                      tile_bins[3 * li + 2])
            if has_s:
                fb = R._shapes_pass(fb, px, py, shapes, shape_clips, s_bins)
            if has_i:
                fb = R._images_pass(fb, px, py, images, image_clips, i_bins,
                                    image_atlas)
            if has_g:
                fb = R._glyphs_pass(fb, px, py, glyphs, glyph_colors,
                                    glyph_clips, g_bins, font_tex)
        return fb

    return jax.vmap(tile_fn)(org_x, org_y, *bins_flat)


# ---------------------------------------------------------------------------
# Batched multi-frame step (the dp axis): B scenes with identical buffer
# shapes rendered in one sharded dispatch — the "training step" analog.
# ---------------------------------------------------------------------------

def render_batch_sharded(batched_layer_data, font_tex, image_atlas,
                         background, tiles_y: int, tiles_x: int,
                         layer_sig: tuple, mesh: Mesh):
    """batched_layer_data: like layer_data but every array has a leading
    frame axis B (divisible by mesh dp). Frames shard over 'dp'; tiles
    shard over 'sp'. Returns (B, T, TH, TW, 4) float32."""
    def layer_spec():
        # Commands: (B, N, …) shard B on dp. Bins: (B, T, K) shard B on dp
        # and T on sp.
        return tuple(P("dp", "sp") if j >= 7 else P("dp")
                     for j in range(10))

    in_specs = (tuple(layer_spec() for _ in layer_sig), P(), P())
    out_specs = P("dp", "sp")

    def shard_fn(ld, ftex, iatlas):
        n_sp = mesh.shape["sp"]
        idx_sp = jax.lax.axis_index("sp")
        t_total = ld[0][7].shape[1] * n_sp
        local_t = t_total // n_sp
        tile0 = idx_sp * local_t

        def one_frame(frame_ld):
            return _render_tile_slice(frame_ld, ftex, iatlas, background,
                                      tiles_x, layer_sig, tile0, local_t)

        return jax.vmap(one_frame)(ld)

    fn = jax.shard_map(shard_fn, mesh=mesh, in_specs=in_specs,
                       out_specs=out_specs, check_vma=False)
    return fn(batched_layer_data, font_tex, image_atlas)
