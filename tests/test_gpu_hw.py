"""GPU tier — what only the card can check:
`JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_gpu_hw.py`
(`python chip_smoke.py` runs it too).

The CPU suite runs the Pallas raster kernel in interpret mode and renders
the pixel goldens on the CPU backend; a Triton-level regression (block
shapes, registers, a lowering the route refuses), TF32 arithmetic, or a
GPU-only numerics drift would pass all of it. This tier runs those paths
on the card: the compiled raster kernel against the XLA scan, the pixel
goldens, the steady-state frame sequence, the fallback-bank texture and a
full screenshot frame. Without a card every test here skips (decided in
the module fixture, never at import).
"""

from __future__ import annotations

import os

import numpy as np
import pytest

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def gpu_renderer():
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip(f"no GPU backend (got {jax.default_backend()})")
    os.environ["WGIT_SKIP_AVATARS"] = "1"   # no network on the card host
    from whisper_git_tpu.render.renderer import get_renderer

    return get_renderer()


def _steady_scene(renderer, off: float, w=384, h=256):
    from whisper_git_tpu.tools.fixtures import steady_window_scene

    return steady_window_scene(renderer, off, (w, h))


def _clear_device_caches():
    from whisper_git_tpu.render import compose as C, frame as F

    C.clear_caches()
    F.clear_caches()


def _diff(a, b) -> int:
    a, b = np.asarray(a).astype(np.int16), np.asarray(b).astype(np.int16)
    assert a.shape == b.shape
    return int(np.abs(a - b).max())


def test_raster_kernel_matches_xla_on_gpu(gpu_renderer, monkeypatch):
    """The Pallas raster kernel compiled through Triton (not interpret
    mode) vs the XLA scan path, same card, same scene: ≤1 u8."""
    from whisper_git_tpu.render import rasterizer as R

    scene = _steady_scene(gpu_renderer, 16.0)
    monkeypatch.setenv("WGIT_FRAME_CACHE", "0")  # single-shot packed path
    out = {}
    for use_pallas in (True, False):
        monkeypatch.setattr(R, "_use_pallas", lambda p=use_pallas: p)
        _clear_device_caches()
        out[use_pallas] = R.render_scene_device(
            scene, gpu_renderer.font_tex_device(),
            gpu_renderer.image_atlas_device())
    assert _diff(out[True], out[False]) <= 1


@pytest.mark.parametrize("name", ["chrome", "diffish", "fallback", "graph",
                                  "images", "modal", "signatures",
                                  "unicode", "window"])
def test_pixel_golden_on_gpu(gpu_renderer, name):
    """The CPU-rendered goldens rendered on the card, at the CPU suite's
    own tolerance (tests/test_pixel_golden.py)."""
    from whisper_git_tpu.render.renderer import load_png
    from whisper_git_tpu.tools.goldens import (
        SCENES,
        TOLERANCE,
        golden_dir,
        render_scene_image,
    )

    assert name in SCENES
    if name == "fallback":
        # The bank rasterizes DejaVu tail glyphs through PIL + fontTools.
        pytest.importorskip("PIL")
        pytest.importorskip("fontTools")
    want = load_png(os.path.join(golden_dir(), f"{name}.png"))
    d = _diff(render_scene_image(name), want)
    assert d <= TOLERANCE, f"gpu render vs cpu golden {name}: {d} u8"


def test_steady_state_sequence_on_gpu(gpu_renderer, monkeypatch):
    """Three consecutive scroll frames through the production compose
    path vs the single-shot packed path, on the card: ≤1 u8 each."""
    from whisper_git_tpu.render import rasterizer as R

    monkeypatch.delenv("WGIT_FRAME_CACHE", raising=False)
    monkeypatch.delenv("WGIT_FRAME_COMPOSE", raising=False)
    _clear_device_caches()
    for off in (0.0, 16.0, 32.0):
        scene = _steady_scene(gpu_renderer, off)
        assert scene.windows, "fixture recorded no scroll window"
        got = R.render_scene_device(scene, gpu_renderer.font_tex_device(),
                                    gpu_renderer.image_atlas_device())
        monkeypatch.setenv("WGIT_FRAME_CACHE", "0")
        ref = R.render_scene_device(scene, gpu_renderer.font_tex_device(),
                                    gpu_renderer.image_atlas_device())
        monkeypatch.delenv("WGIT_FRAME_CACHE", raising=False)
        assert _diff(ref, got) <= 1, off


def test_fallback_bank_texture_on_gpu(gpu_renderer):
    """The EXTENDED font texture (resident + fallback-bank rows) sampled
    by the kernel on the card."""
    pytest.importorskip("PIL")
    pytest.importorskip("fontTools")
    from whisper_git_tpu.ui.el import El

    bank = gpu_renderer.fallback_bank
    bank.ensure([ord(c) for c in "שלום∮┌"])
    assert bank.used
    tree = El("stack", children=[
        El("text", text="fallback שלום ∮ ┌ on gpu", font_size=16.0,
           color=(1.0, 1.0, 1.0, 1.0))])
    img = np.asarray(gpu_renderer.render(tree, (384, 64)))
    assert (img[..., :3].max(axis=-1) > 128).sum() > 50


def test_cjk_fixture_chain_on_gpu(gpu_renderer, tmp_path, monkeypatch):
    """The WGIT_FALLBACK_FONTS → cmap → rasterize → bank path with real
    CJK codepoints, sampled on the card (the fixture TTF stands in for a
    system CJK font)."""
    pytest.importorskip("fontTools")
    pytest.importorskip("PIL")
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_fallback import _build_cjk_fixture_font

    import whisper_git_tpu.render.fallback as fb

    font_path = str(tmp_path / "cjk-fixture.ttf")
    _build_cjk_fixture_font(font_path)
    monkeypatch.setenv("WGIT_FALLBACK_FONTS", font_path)
    bank = fb.FallbackBank()
    bank.set_layout(v_base=gpu_renderer.font_tex.shape[0],
                    primary_ascent=gpu_renderer.regular.ascent)
    assert bank.ensure([0x4E2D, 0x6587])
    old = gpu_renderer.fallback_bank
    try:
        gpu_renderer.fallback_bank = bank
        gpu_renderer.regular.attach_fallback(bank)
        gpu_renderer._font_tex_dev = None
        from whisper_git_tpu.ui.el import El
        tree = El("stack", children=[
            El("text", text="中文 on gpu", font_size=18.0,
               color=(1.0, 1.0, 1.0, 1.0))])
        img = np.asarray(gpu_renderer.render(tree, (256, 64)))
        assert (img[..., :3].max(axis=-1) > 128).sum() > 80
    finally:
        gpu_renderer.fallback_bank = old
        gpu_renderer.regular.attach_fallback(old)
        gpu_renderer._font_tex_dev = None


def test_screenshot_frame_on_gpu(gpu_renderer, temp_repo):
    """A full app frame (repo open → refresh → build → layout → compile
    → raster → readback) — the screenshot surface end to end."""
    from whisper_git_tpu.app.repo_tab import RepoTab
    from whisper_git_tpu.app.ui_app import WhisperApp
    from whisper_git_tpu.host.screenshot_mode import render_frame

    tab = RepoTab.open(temp_repo)
    tab.refresh_sync(include_orphans=False)
    app = WhisperApp.with_tabs([tab])
    img = np.asarray(render_frame(app, 1280, 800))
    assert img.shape == (800, 1280, 4)
    assert len(np.unique(img[..., 0])) > 8
    for tb in app.tabs:
        tb.stop_workers()
