"""The device-resident frame cache (render/frame.py) must be pixel-exact
against the single-shot packed path at every scroll offset, across cache
hits AND misses, and must invalidate correctly when chrome or window
content actually changes. The Pallas raster kernel is exercised in
interpreter mode against the XLA blocks reference."""

from __future__ import annotations

import os

import numpy as np
import pytest

import whisper_git_tpu.render.frame as F
from whisper_git_tpu.render import rasterizer as R
from whisper_git_tpu.render.renderer import get_renderer
from whisper_git_tpu.ui.theme import DARK

VIEWPORT = (640, 480)


@pytest.fixture(scope="module")
def app_fixture(tmp_path_factory):
    from whisper_git_tpu.app.repo_tab import RepoTab
    from whisper_git_tpu.app.ui_app import WhisperApp
    from whisper_git_tpu.tools.dump_bundles import make_fixture_repo

    repo = make_fixture_repo(str(tmp_path_factory.mktemp("framecache")))
    tab = RepoTab.open(repo)
    tab.refresh_sync(include_orphans=False)
    app = WhisperApp.with_tabs([tab])
    return app, tab, get_renderer()


def _scene(app, tab, r, off: float):
    tab.history_scroll = float(off)
    tree = app.build((float(VIEWPORT[0]), float(VIEWPORT[1])))
    root = r.layout(tree, VIEWPORT)
    return r.compile(root, VIEWPORT, DARK.background)


def _render_old(scene, r):
    os.environ["WGIT_FRAME_CACHE"] = "0"
    try:
        return np.asarray(R.render_scene_device(
            scene, r.font_tex_device(), r.image_atlas_device()))
    finally:
        os.environ.pop("WGIT_FRAME_CACHE", None)


def _render_new(scene, r):
    return np.asarray(F.render_frame_device(
        scene, r.font_tex_device(), r.image_atlas_device()))


@pytest.mark.parametrize("off", [0.0, 17.0, 63.9, 64.0, 111.5])
def test_frame_cache_matches_packed_path(app_fixture, off):
    app, tab, r = app_fixture
    scene = _scene(app, tab, r, off)
    a = _render_new(scene, r)
    b = _render_old(scene, r)
    assert int(np.abs(a.astype(int) - b.astype(int)).max()) == 0


def test_cache_hits_render_identically(app_fixture):
    """Second render of the same scroll offset (warm caches everywhere)
    must be identical to the first (cold)."""
    app, tab, r = app_fixture
    F.clear_caches()
    scene = _scene(app, tab, r, 40.0)
    cold = _render_new(scene, r)
    warm = _render_new(_scene(app, tab, r, 40.0), r)
    assert np.array_equal(cold, warm)


def test_chrome_cache_hit_across_scroll(app_fixture):
    """Pure scrolling must reuse the chrome entry (the scrollbar thumb is
    volatile → dynamic tail, so the static prefix is byte-stable)."""
    app, tab, r = app_fixture
    F.clear_caches()
    _render_new(_scene(app, tab, r, 10.0), r)
    n_entries = len(F._CHROME_CACHE)
    _render_new(_scene(app, tab, r, 27.0), r)
    assert len(F._CHROME_CACHE) == n_entries  # no new chrome entries


def test_chrome_change_invalidates(app_fixture):
    """A real chrome change (different selected commit → details pane)
    must produce different pixels, not a stale cache hit."""
    app, tab, r = app_fixture
    base = _render_new(_scene(app, tab, r, 0.0), r)
    sel = next(c.oid for c in tab.commits if not c.is_synthetic)
    app.handle_action(f"select-commit:{sel}")
    changed = _render_new(_scene(app, tab, r, 0.0), r)
    assert not np.array_equal(base, changed)
    app.handle_action("escape")
    tab.select_commit(None)


def test_blocks_kernel_interpret_matches_xla(app_fixture, monkeypatch):
    """The Pallas raster kernel (interpret mode) vs the XLA blocks
    reference through the frame-cache path — same frame, ≤1 u8."""
    import jax.numpy as jnp

    from whisper_git_tpu.render import pallas_raster as PR

    app, tab, r = app_fixture
    scene = _scene(app, tab, r, 33.0)
    frame_blob, chrome_args, win_args, meta = F.pack_frame(scene)
    bg = tuple(float(c) for c in scene.background[:3])

    def render(use_pallas):
        return np.asarray(F._render_frame(
            jnp.asarray(frame_blob), chrome_args, win_args,
            jnp.asarray(r.font_tex_device()),
            jnp.asarray(r.image_atlas_device()), bg, scene.height,
            scene.width, meta, use_pallas=use_pallas))

    img_x = render(False)
    calls = []
    orig = PR.render_tiles_blocks

    def interpreted(*args, **kw):
        calls.append(1)
        return orig(*args, **dict(kw, interpret=True))

    monkeypatch.setattr(PR, "render_tiles_blocks", interpreted)
    img_p = render(True)
    assert calls, "kernel path not taken"
    diff = np.abs(img_x.astype(int) - img_p.astype(int))
    assert diff.max() <= 1, diff.max()


def test_wire_format_ranges_cover_real_coordinates():
    """Regression for the atlas-v clamp bug: every quantization scale in
    the i16 wire format must cover the coordinate ranges the app actually
    produces — atlas v up to the full (extended) font texture height,
    screen coords up to a 4K physical framebuffer, clip rects likewise.
    A scale whose representable range is exceeded clamps SILENTLY, so
    this asserts headroom explicitly."""
    from whisper_git_tpu.render.renderer import get_renderer

    r = get_renderer()
    tex_h = r.font_tex.shape[0]
    I16 = 32767.0

    def max_range(scale):
        return I16 / scale

    for name, cols, scale in R._PART_SPECS:
        s = R._part_scale(name, cols, scale)
        if name in ("glyphs", "images"):
            # cols 0-3 screen px, cols 4-7 atlas px
            assert max_range(s[0]) >= 3840, (name, "screen x range")
            assert max_range(s[5]) >= tex_h, (name, "atlas v range")
        elif name.endswith("clips"):
            assert max_range(s[0]) >= 3840, (name, "clip range")
    # shapes: geometry columns cover 4K, colors cover premultiplied 0..1
    ss = R._part_scale("shapes", 16, None)
    assert max_range(ss[1]) >= 3840
    assert max_range(ss[7]) >= 1.0


def test_oversized_scene_routes_around_i16_clamp():
    """A scene wider than the i16 wire range (±4095.875 px at 1/8 px)
    must render content at its far edge instead of silently collapsing
    everything beyond x≈4096 onto one column (5K/8K screenshots). The
    oversized path skips quantization entirely."""
    from whisper_git_tpu.render.renderer import get_renderer
    from whisper_git_tpu.ui import rect, row, spacer, stack, text

    W, H = 4480, 64  # > MAX_PACKED_PX wide, small area to keep it cheap
    r = get_renderer()
    tree = stack(
        row(spacer(),
            rect(text("edge", color=(1, 1, 1, 1)),
                 fill=(0.9, 0.2, 0.2, 1.0), width=128, height=32),
            width="fill", height="fill"),
        width="fill", height="fill", fill=(0.0, 0.0, 0.0, 1.0))
    root = r.layout(tree, (W, H))
    scene = r.compile(root, (W, H), (0.0, 0.0, 0.0, 1.0))
    assert W > R.MAX_PACKED_PX
    img = np.asarray(R.render_scene_device(
        scene, r.font_tex_device(), r.image_atlas_device()))
    assert img.shape == (H, W, 4)
    # The red rect occupies the last 128 px — far beyond the i16 range.
    strip = img[:32, W - 120:W - 8]
    assert strip[..., 0].mean() > 150, "far-edge rect missing (clamped?)"
    # And nothing smeared onto the would-be clamp column at x≈4095.
    col = img[40:, 4090:4100]
    assert col.max() == 0 or col[..., 0].mean() < 10


def test_quantization_roundtrip_preserves_high_atlas_v(app_fixture):
    """A glyph sampling the last atlas cell (v > 4096 with the extended
    charset) must survive the i16 round-trip exactly."""
    r = get_renderer()
    tex_h = r.font_tex.shape[0]
    assert tex_h > 4096, "test premise: extended atlas is tall"
    v = float(tex_h - 64)
    arr = np.zeros((1, 8), np.float32)
    arr[0] = [10.0, 20.0, 8.0, 12.0, 64.0, v, 64.0, 64.0]
    s = R._part_scale("glyphs", 8, 8.0)
    q = np.clip(np.rint(arr * s), -32767.0, 32767.0).astype(np.int16)
    back = q.astype(np.float32) / s
    assert back[0, 5] == v, (back[0, 5], v)
