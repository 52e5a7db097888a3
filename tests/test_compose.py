"""The layer-image compose pipeline (render/compose.py) must stay within
one u8 step of the packed path at every scroll offset (re-associating the
`over` operator across cached layer boundaries is a ≤1-ulp change; integer
scroll crops are exact — see the module docstring), must hit its slab and
chrome caches on pure scroll frames, and must fall back cleanly on
sub-pixel scroll."""

from __future__ import annotations

import os

import numpy as np
import pytest

import whisper_git_tpu.render.compose as C
import whisper_git_tpu.render.frame as F
from whisper_git_tpu.render import rasterizer as R
from whisper_git_tpu.render.renderer import get_renderer
from whisper_git_tpu.ui.theme import DARK

VIEWPORT = (640, 480)


@pytest.fixture(scope="module")
def app_fixture(tmp_path_factory):
    import subprocess

    from whisper_git_tpu.app.repo_tab import RepoTab
    from whisper_git_tpu.app.ui_app import WhisperApp
    from whisper_git_tpu.tools.dump_bundles import make_fixture_repo

    # The compose tests need real scrolling headroom: a history tall enough
    # that offsets past OVERSCAN are reachable at this viewport.
    repo = make_fixture_repo(str(tmp_path_factory.mktemp("compose")))
    env = dict(os.environ, GIT_TERMINAL_PROMPT="0")
    for i in range(60):
        env["GIT_AUTHOR_DATE"] = env["GIT_COMMITTER_DATE"] = str(
            1_750_000_000 + i * 3600)
        subprocess.run(["git", "-C", repo, "commit", "--allow-empty", "-m",
                        f"scroll filler {i}"], check=True,
                       capture_output=True, env=env)
    tab = RepoTab.open(repo)
    tab.refresh_sync(include_orphans=False)
    app = WhisperApp.with_tabs([tab])
    return app, tab, get_renderer()


def _scene(app, tab, r, off: float):
    tab.history_scroll = float(off)
    tree = app.build((float(VIEWPORT[0]), float(VIEWPORT[1])))
    root = r.layout(tree, VIEWPORT)
    return r.compile(root, VIEWPORT, DARK.background)


def _render_packed(scene, r):
    os.environ["WGIT_FRAME_CACHE"] = "0"
    try:
        return np.asarray(R.render_scene_device(
            scene, r.font_tex_device(), r.image_atlas_device()))
    finally:
        os.environ.pop("WGIT_FRAME_CACHE", None)


def _render_composed(scene, r):
    img = C.render_frame_composed(scene, r.font_tex_device(),
                                  r.image_atlas_device())
    return None if img is None else np.asarray(img)


def test_compose_matches_packed_across_scroll(app_fixture):
    app, tab, r = app_fixture
    C.clear_caches()
    F.clear_caches()
    for off in (0.0, 17.0, 51.0, 120.0, 203.0, 340.0):
        scene = _scene(app, tab, r, off)
        got = _render_composed(scene, r)
        assert got is not None, f"compose declined integer scroll {off}"
        want = _render_packed(scene, r)
        assert got.shape == want.shape
        diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
        assert diff.max() <= 1, (
            f"off={off}: max u8 diff {diff.max()} at "
            f"{np.unravel_index(diff.argmax(), diff.shape)}")
        # the re-association is a last-ulp effect: differing pixels are rare
        frac = (diff > 0).mean()
        assert frac < 0.02, f"off={off}: {frac:.2%} pixels differ"


def test_pure_scroll_hits_caches(app_fixture):
    app, tab, r = app_fixture
    C.clear_caches()
    scene = _scene(app, tab, r, 17.0)
    assert _render_composed(scene, r) is not None
    groups = dict(C._GROUP_CACHE)
    slabs = {k: v["y0s"] for k, v in C._SLAB_CACHE.items()}
    # A scroll inside the layout materialization bucket (window uid stable)
    # re-renders NOTHING: pure crop + compose.
    scene = _scene(app, tab, r, 34.0)
    assert _render_composed(scene, r) is not None
    assert list(C._GROUP_CACHE) == list(groups), "chrome group re-rendered"
    assert {k: v["y0s"] for k, v in C._SLAB_CACHE.items()} == slabs, \
        "slab re-rendered inside its overscan window"


def test_plan_rebuild_reuses_memoized_stacks(app_fixture):
    """A scroll-bucket plan rebuild (window uid moved with the 128 px
    layout materialization bucket) re-renders slabs but must REUSE the
    previously stacked chrome group images (same device array object),
    not re-copy full-frame f32 images through HBM."""
    app, tab, r = app_fixture
    C.clear_caches()
    scene = _scene(app, tab, r, 17.0)
    assert _render_composed(scene, r) is not None
    plans_before = dict(C._PLAN_CACHE)
    img_ids = {id(v["img_stack"]) for v in plans_before.values()}
    # One materialization bucket later: new window uid → new plan key;
    # chrome groups unchanged.
    scene = _scene(app, tab, r, 17.0 + 128.0)
    assert _render_composed(scene, r) is not None
    new_plans = [v for k, v in C._PLAN_CACHE.items()
                 if k not in plans_before]
    if not new_plans:
        pytest.skip("scroll did not produce a new plan key")
    for v in new_plans:
        assert id(v["img_stack"]) in img_ids, "chrome img stack re-built"


def test_slab_rebuild_outside_overscan(app_fixture):
    app, tab, r = app_fixture
    C.clear_caches()
    scene = _scene(app, tab, r, 0.0)
    assert _render_composed(scene, r) is not None
    before = {k: v["y0s"] for k, v in C._SLAB_CACHE.items()}
    if not before:
        pytest.skip("fixture produced no scroll windows")
    far = float(C.OVERSCAN + 200)
    scene = _scene(app, tab, r, far)
    got = _render_composed(scene, r)
    assert got is not None
    after = {k: v["y0s"] for k, v in C._SLAB_CACHE.items()}
    assert any(after.get(k) != y for k, y in before.items()
               if k in after) or set(after) != set(before)
    want = _render_packed(scene, r)
    assert np.abs(got.astype(np.int16) - want.astype(np.int16)).max() <= 1


def test_fractional_scroll_falls_back(app_fixture):
    app, tab, r = app_fixture
    scene = _scene(app, tab, r, 13.5)
    if not getattr(scene, "windows", None):
        pytest.skip("fixture produced no scroll windows")
    assert _render_composed(scene, r) is None
    # the public entry still renders (classic path) and matches packed
    img = np.asarray(R.render_scene_device(
        scene, r.font_tex_device(), r.image_atlas_device()))
    want = _render_packed(scene, r)
    assert np.array_equal(img, want)


def test_content_change_invalidates(app_fixture):
    app, tab, r = app_fixture
    C.clear_caches()
    scene = _scene(app, tab, r, 0.0)
    base = _render_composed(scene, r)
    assert base is not None
    # selecting a commit changes chrome + window content
    sel = tab.commits[2].oid if len(tab.commits) > 2 else tab.commits[0].oid
    tab.select_commit(sel)
    scene2 = _scene(app, tab, r, 0.0)
    got = _render_composed(scene2, r)
    want = _render_packed(scene2, r)
    assert np.abs(got.astype(np.int16) - want.astype(np.int16)).max() <= 1
    assert not np.array_equal(np.asarray(base), got), \
        "selection change did not change pixels"


def test_compose_random_walk_stays_exact(app_fixture):
    """Seeded random walk over scroll offsets and content changes: the
    compose path must hold its ≤1 u8 bound against the packed path at
    EVERY step — cache hits, slab rebuilds, selection invalidations,
    whatever the walk happens to trigger."""
    import random

    rng = random.Random(424242)
    app, tab, r = app_fixture
    C.clear_caches()
    oids = [c.oid for c in tab.commits if not c.is_synthetic]
    for step in range(8):
        roll = rng.random()
        if roll < 0.2 and oids:
            tab.select_commit(rng.choice(oids))
        elif roll < 0.3:
            tab.select_commit(None)
        off = float(rng.randrange(0, 600))
        scene = _scene(app, tab, r, off)
        got = _render_composed(scene, r)
        if got is None:
            continue  # fractional-scroll style fallback: packed path
        want = _render_packed(scene, r)
        diff = int(np.abs(got.astype(np.int16)
                          - want.astype(np.int16)).max())
        assert diff <= 1, (step, off, diff)


def test_dyn_class_appearing_under_identical_chrome():
    """A volatile (dyn) command class APPEARING while the chrome bytes
    stay identical must invalidate the cached plan — the ops list only
    carries ("dyn", li, ci) entries for classes present at build time,
    so a stale plan would silently drop the volatile (the pulsing-dot
    situation El.volatile exists for)."""
    from whisper_git_tpu.ui import rect, stack, text

    r = get_renderer()
    C.clear_caches()
    F.clear_caches()

    def build(with_dot: bool):
        # The dot nests INSIDE the single layer subtree: El.volatile
        # routes it to the layer's dyn tail, leaving the layer's static
        # command bytes — and therefore the chrome key — identical
        # between the two builds.
        header_kids = [text("steady chrome header", color=DARK.text)]
        if with_dot:
            header_kids.append(rect(width=10, height=10, radius=5,
                                    fill=(0.9, 0.7, 0.2, 0.8),
                                    volatile=True))
        from whisper_git_tpu.ui import row
        tree = stack(
            stack(rect(row(*header_kids, gap=8, align="center",
                           width="fill", height="fill"),
                       fill=DARK.surface_raised, width="fill", height=32,
                       padding=(6, 10, 6, 10)),
                  width="fill", height="fill"),
            width="fill", height="fill", fill=DARK.background)
        root = r.layout(tree, (256, 128))
        return r.compile(root, (256, 128), DARK.background)

    plain = C.render_frame_composed(build(False), r.font_tex_device(),
                                    r.image_atlas_device())
    with_dot = C.render_frame_composed(build(True), r.font_tex_device(),
                                       r.image_atlas_device())
    if plain is None or with_dot is None:
        pytest.skip("compose path declined this scene shape")
    a, b = np.asarray(plain), np.asarray(with_dot)
    assert (a != b).any(), \
        "volatile element invisible: stale plan reused for a frame " \
        "whose dyn class appeared under identical chrome bytes"


def test_chrome_layers_are_ink_cropped(app_fixture):
    """Single chip, cached chrome group layers store only their ink bbox
    (render/compose.py _group_bbox) — the steady-state blend's HBM
    traffic scales with visible ink, not layer count × frame area. At
    least one group in a real scene must be materially smaller than the
    frame, and every crop must carry consistent offsets."""
    app, tab, r = app_fixture
    C.clear_caches()
    scene = _scene(app, tab, r, 17.0)
    out = C.render_frame_composed(scene, r.font_tex_device(),
                                  r.image_atlas_device())
    assert out is not None
    assert C._GROUP_CACHE, "no chrome groups cached"
    # Entries are (h, w, 4) f16 images + pixel offsets.
    fractions = []
    full_h, full_w = scene.height, scene.width
    for img, oy, ox in C._GROUP_CACHE.values():
        h, w = int(img.shape[0]), int(img.shape[1])
        assert 0 <= oy and 0 <= ox
        assert oy + h <= full_h and ox + w <= full_w, (img.shape, oy, ox)
        fractions.append((h * w) / (full_h * full_w))
    assert min(fractions) < 0.5, \
        "every chrome layer is near-full-frame: bbox cropping inactive"


def test_dyn_subgrid_covers_only_thumb_columns(app_fixture):
    """The volatile tail's bins cover only the tile columns its commands
    touch (frame._dyn_layer subgrid) — and the column range stays STABLE
    across a scroll (the thumb moves vertically within its column), so
    the compose jit's static meta does not churn."""
    app, tab, r = app_fixture
    C.clear_caches()
    metas = []
    for off in (10.0, 40.0, 90.0):
        scene = _scene(app, tab, r, off)
        prep = C.prepare_compose_dispatch(scene, r.font_tex_device(),
                                          r.image_atlas_device())
        assert prep is not None
        _, statics = prep
        metas.append(statics["meta"][1])
    tiles_x = -(-scene.width // C.TILE_W)
    ranges = [(c0, c1) for dm in metas for (_, ks, c0, c1) in dm
              if any(ks)]
    assert ranges, "no volatile tails in the fixture scene"
    assert any(c1 - c0 < tiles_x for c0, c1 in ranges), \
        "dyn subgrid inactive: volatile tails render the full tile grid"
    assert metas[0] == metas[1] == metas[2], \
        "dyn meta churned across a scroll: compose jit recompiles per frame"


def test_kernel_blend_windowless_scene():
    """A scene with NO scroll windows (welcome view shape) through the
    compose path: empty slab tuple, empty starts vector, chrome +
    volatile ops only — must match the packed path within 1 u8."""
    from whisper_git_tpu.ui import column, rect, text

    r = get_renderer()
    ui = column(
        rect(text("No windows here", color=DARK.text, bold=True),
             fill=DARK.surface_raised, radius=6, padding=(6, 10, 6, 10),
             width="fill", height=40),
        rect(width=12, height=12, radius=6,
             fill=(0.9, 0.6, 0.2, 0.9), volatile=True),
        width="fill", height="fill", fill=DARK.background, gap=8)
    C.clear_caches()
    root = r.layout(ui, (256, 128))
    scene = r.compile(root, (256, 128), DARK.background)
    assert not scene.windows
    got = _render_composed(scene, r)
    assert got is not None
    want = _render_packed(scene, r)
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1, diff.max()


def test_kernel_inline_volatile_off_column_zero():
    """Volatile SHAPES whose tile-column range starts at c0 > 0 (the
    right-edge scrollbar-thumb case): the tail's tables are x-translated
    to its sub-grid at pack time (compose.py _shift_parts by -c0*TILE_W)
    and its layer is blended back at x0 = c0*TILE_W — each dot must land
    at its true position (packed path within 1 u8)."""
    from whisper_git_tpu.ui import rect, row, spacer, stack

    r = get_renderer()
    width, height = 512, 128   # 4 tile columns
    # One volatile dot per tile column >= 1 (x = 160, 288, 416), so the
    # tails' sub-grids start at c0 = 1, 2, 3.
    ui = stack(
        rect(width="fill", height="fill", fill=DARK.background),
        row(spacer(154),
            *[el for x in range(3) for el in
              (rect(width=12, height=12, radius=6,
                    fill=(0.9, 0.6, 0.2, 0.9), volatile=True),
               spacer(116))],
            width="fill", height=60),
        width="fill", height="fill")
    C.clear_caches()
    root = r.layout(ui, (width, height))
    scene = r.compile(root, (width, height), DARK.background)
    prepared = C.prepare_compose_dispatch(scene, r.font_tex_device(),
                                          r.image_atlas_device())
    assert prepared is not None
    dyn_meta = prepared[1]["meta"][1]
    cols = [(m[2], m[3]) for m in dyn_meta if m[3] > m[2]]
    assert any(c0 >= 1 for c0, _ in cols), \
        f"fixture regression: no volatile tail at column >= 1 ({cols})"
    got = _render_composed(scene, r)
    assert got is not None
    want = _render_packed(scene, r)
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1, \
        f"volatile at tile column >= 1: max u8 diff {diff.max()}"
