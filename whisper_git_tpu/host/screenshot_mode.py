"""Headless screenshot renderer: offscreen frame → PNG via the real
accelerator rasterizer pipeline — no window required.

Capability parity with reference src/screenshot_mode.rs: "bundle dumps
verify layout; this path renders through the real GPU pipeline and
verifies shader output" (:4-7). Ours renders through the real accelerator
pipeline (jit rasterizer), making it both the CI verification path and
the LLM/visual-review entry point.
"""

from __future__ import annotations

from ..app.ui_app import WhisperApp
from ..render.renderer import get_renderer, save_png
from ..ui.theme import DARK


def run(path: str, width: int, height: int, scale: float,
        app: WhisperApp) -> None:
    """reference: screenshot_mode.rs:38. `width`×`height` is the PHYSICAL
    output size; layout runs at the logical size (width/scale) and the
    compiled commands are scaled into physical pixels (Scene.scaled), so
    the SDF rasterizer produces crisp glyph/shape edges at any scale —
    true HiDPI, not an image upscale."""
    import numpy as np

    renderer = get_renderer()
    app.before_build()
    viewport = (float(width) / scale, float(height) / scale)
    tree = app.build(viewport)
    root = renderer.layout(tree, viewport)
    scene = renderer.compile(root, (int(viewport[0]), int(viewport[1])),
                             DARK.background)
    if scale != 1.0:
        scene = scene.scaled(scale, out_w=width, out_h=height)
    from ..render.rasterizer import render_scene_device

    img_dev = render_scene_device(scene, renderer.font_tex_device(),
                                  renderer.image_atlas_device())
    save_png(np.asarray(img_dev), path)


def render_frame(app: WhisperApp, width: int, height: int):
    """One frame through the pipeline → (H, W, 4) u8 (no file IO)."""
    renderer = get_renderer()
    app.before_build()
    tree = app.build((float(width), float(height)))
    return renderer.render(tree, (width, height), DARK.background)
