"""The Pallas raster kernel (render/pallas_raster.py, the GPU path) must
match the XLA scan reference.

Production runs the kernel compiled through Triton on the GPU
(`rasterizer._use_pallas`); here it runs in interpreter mode on the CPU, so
the kernel logic — occupancy-bounded loops, sub-tile origins, atlas cell
slicing, planar output — is exercised without the card
(tests/test_gpu_hw.py compares the compiled kernel on the card).
"""

from __future__ import annotations

import numpy as np
import pytest


@pytest.fixture(scope="module")
def small_scene():
    import __graft_entry__ as g

    renderer, scene = g._compiled_scene(256, 128)
    return renderer, scene


def _render_both(renderer, scene):
    import jax.numpy as jnp

    from whisper_git_tpu.render import frame as F
    from whisper_git_tpu.render import pallas_raster as PR
    from whisper_git_tpu.render import rasterizer as R

    fused, meta, ty, tx, win_list = R.pack_scene(scene)
    T = ty * tx
    wins = tuple(jnp.asarray(b) for _, _, b in win_list)
    layer_data, layer_sig = R.unpack_layers(jnp.asarray(fused), wins, meta,
                                            T)
    font = jnp.asarray(renderer.font_tex_device())
    atlas = jnp.asarray(renderer.image_atlas_device())
    bg = tuple(float(c) for c in scene.background[:3])

    tiles = R._render_tiles_impl(layer_data, font, atlas, bg, ty, tx,
                                 layer_sig)
    img_x = np.asarray(F.assemble_planar(tiles.transpose(0, 3, 1, 2), ty,
                                         tx, scene.height, scene.width))
    tiles_p = PR.render_tiles_blocks(R._layer_blocks(layer_data, layer_sig),
                                     font, atlas, bg, ty, tx,
                                     interpret=True)
    img_p = np.asarray(F.assemble_planar(tiles_p, ty, tx, scene.height,
                                         scene.width))
    return img_x, img_p


def test_pallas_matches_xla(small_scene):
    renderer, scene = small_scene
    img_x, img_p = _render_both(renderer, scene)
    assert img_x.shape == img_p.shape == (128, 256, 4)
    diff = np.abs(img_x.astype(int) - img_p.astype(int))
    # The glyph pass's bf16 products round in another order than the XLA
    # scan's; anything above 1 u8 would be a geometry/compositing bug.
    assert diff.max() <= 1, diff.max()


def test_pallas_empty_scene():
    """No commands at all → background-only frame, no division by zero."""
    import jax.numpy as jnp

    from whisper_git_tpu.render import frame as F
    from whisper_git_tpu.render import pallas_raster as PR
    from whisper_git_tpu.render import rasterizer as R
    from whisper_git_tpu.render.scene import Scene

    scene = Scene(layers=[], width=128, height=64,
                  background=(0.1, 0.2, 0.3, 1.0),
                  image_atlas=np.zeros((64, 64, 4), np.uint8))
    fused, meta, ty, tx, win_list = R.pack_scene(scene)
    wins = tuple(jnp.asarray(b) for _, _, b in win_list)
    layer_data, layer_sig = R.unpack_layers(jnp.asarray(fused), wins, meta,
                                            ty * tx)
    tiles = PR.render_tiles_blocks(R._layer_blocks(layer_data, layer_sig),
                                   jnp.zeros((64, 64), jnp.uint8),
                                   jnp.zeros((64, 64, 4), jnp.uint8),
                                   (0.1, 0.2, 0.3), ty, tx, interpret=True)
    img = np.asarray(F.assemble_planar(tiles, ty, tx, 64, 128))
    assert img.shape == (64, 128, 4)
    assert abs(int(img[0, 0, 0]) - int(0.1 * 255 + 0.5)) <= 1
    assert abs(int(img[0, 0, 2]) - int(0.3 * 255 + 0.5)) <= 1
