"""Mesh-sharded rendering tests on the 8-virtual-device CPU mesh.

ONE honest numerics story for sharding: every sharded render — the
production frame/compose paths under set_render_mesh, the
render_scene_sharded convenience, and the batched dp-axis sweep — is
held to ±4/255 vs single-chip: the glyph/image samplers run bf16
matmuls that XLA fuses and orders differently under shard_map (and per
shard SHAPE — a 1-tile-per-device program fuses differently than a
6-tile vmap). Measured: typically ≤1, worst observed 3 (small-T pad).
These comparisons CLEAR the compose/frame caches between passes — the
caches key without the mesh, and an interleaved comparison would reuse
single-chip-rendered images, certifying nothing."""

import numpy as np
import pytest

from whisper_git_tpu.parallel.mesh import (
    make_mesh,
    render_scene_sharded,
    set_render_mesh,
)
from whisper_git_tpu.ui import column, path, rect, row, scroll, spacer, \
    stack, text
from whisper_git_tpu.ui.theme import DARK


@pytest.fixture(scope="module")
def renderer():
    from whisper_git_tpu.render.renderer import get_renderer
    return get_renderer()


def _scene(renderer, w=256, h=128):
    ui = stack(
        column(
            rect(text("Sharded render", bold=True, color=DARK.text_bright),
                 fill=DARK.surface_raised, radius=6, padding=(6, 10, 6, 10),
                 width="fill", height=32),
            rect(path([("vline", 16, 0, 60, 2.0, (0.4, 0.6, 0.9, 1.0)),
                       ("circle", 16, 30, 5.0, (0.4, 0.6, 0.9, 1.0))]),
                 text("hello tiles", color=DARK.text),
                 flex=1, width="fill", fill=DARK.background,
                 padding=(8, 8, 8, 40)),
            width="fill", height="fill"),
        width="fill", height="fill", fill=DARK.background)
    root = renderer.layout(ui, (w, h))
    return renderer.compile(root, (w, h), DARK.background)


def test_sharded_matches_single_chip(renderer):
    scene = _scene(renderer)
    from whisper_git_tpu.render.rasterizer import render_scene
    single = render_scene(scene, renderer.font_tex)
    mesh = make_mesh(8, dp=1)
    sharded = render_scene_sharded(scene, renderer.font_tex, mesh)
    assert sharded.shape == single.shape
    diff = np.abs(sharded.astype(int) - single.astype(int))
    # ±4/255: bf16 sampler re-association under shard_map (docstring).
    assert diff.max() <= 4


def test_sharded_2d_mesh(renderer):
    scene = _scene(renderer, w=384, h=128)
    from whisper_git_tpu.render.rasterizer import render_scene
    single = render_scene(scene, renderer.font_tex)
    mesh = make_mesh(8, dp=2)  # (2, 4) mesh used jointly for tiles
    sharded = render_scene_sharded(scene, renderer.font_tex, mesh)
    diff = np.abs(sharded.astype(int) - single.astype(int))
    assert diff.max() <= 4  # bf16 re-association bound (see docstring)


# ---------------------------------------------------------------------------
# Production steady-state paths over the mesh: the frame cache and the
# compose pipeline — what the interactive app and the bench actually run
# every frame — sharded via set_render_mesh through render_scene_device.
# ---------------------------------------------------------------------------

def _steady_scene(renderer, off: float, w=384, h=256):
    """The canonical steady-state frame shape — the SAME builder the
    driver's multichip dryrun uses (whisper_git_tpu.tools.fixtures), so
    these tests pin exactly what the dryrun certifies."""
    from whisper_git_tpu.tools.fixtures import steady_window_scene

    return steady_window_scene(renderer, off, (w, h))


@pytest.mark.parametrize("compose", [True, False])
def test_production_frame_path_sharded(renderer, compose, monkeypatch):
    """Three consecutive scroll frames through render_scene_device with
    the mesh installed must match single-chip within ±4/255 (see module
    docstring — caches cleared between passes so the sharded kernels
    actually run)."""
    from whisper_git_tpu.render import compose as C
    from whisper_git_tpu.render import frame as F
    from whisper_git_tpu.render import rasterizer as R

    monkeypatch.setenv("WGIT_FRAME_COMPOSE", "1" if compose else "0")
    mesh = make_mesh(8, dp=2)
    # Two passes with a cache clear between: compose/frame caches hold
    # rendered device images keyed WITHOUT the mesh, so interleaving
    # ref/sharded renders would let the sharded pass reuse single-chip
    # images and never run the sharded kernels (vacuous certification).
    try:
        def render_all():
            out = []
            for off in (0.0, 16.0, 32.0):
                scene = _steady_scene(renderer, off)
                assert scene.windows, "no scroll window recorded"
                out.append(np.asarray(R.render_scene_device(
                    scene, renderer.font_tex_device(),
                    renderer.image_atlas_device())))
            return out

        set_render_mesh(None)
        C.clear_caches()
        F.clear_caches()
        refs = render_all()
        set_render_mesh(mesh)
        C.clear_caches()
        F.clear_caches()
        gots = render_all()
        for off, ref, got in zip((0.0, 16.0, 32.0), refs, gots):
            diff = np.abs(ref.astype(np.int16) - got.astype(np.int16))
            assert diff.max() <= 4, (off, diff.max())
    finally:
        set_render_mesh(None)


def test_sharded_tile_axis_not_divisible(renderer):
    """T not divisible by the device count: padded tiles must not leak
    into the assembled frame."""
    from whisper_git_tpu.render import rasterizer as R

    # 256×192 → 2×3 = 6 tiles < 8 devices (T_pad = 8, two padded tiles).
    from whisper_git_tpu.render import compose as C, frame as F

    mesh = make_mesh(8, dp=1)
    try:
        scene = _steady_scene(renderer, 16.0, w=256, h=192)
        set_render_mesh(None)
        C.clear_caches()
        F.clear_caches()
        ref = np.asarray(R.render_scene_device(
            scene, renderer.font_tex_device(),
            renderer.image_atlas_device()))
        set_render_mesh(mesh)
        C.clear_caches()  # force the sharded kernels to actually run
        F.clear_caches()
        got = np.asarray(R.render_scene_device(
            scene, renderer.font_tex_device(),
            renderer.image_atlas_device()))
        assert np.abs(ref.astype(np.int16)
                      - got.astype(np.int16)).max() <= 4
    finally:
        set_render_mesh(None)


def test_wgit_mesh_env_activation(monkeypatch, renderer):
    """WGIT_MESH=<n> forces mesh installation (the env path the verify
    recipe uses); 0 disables; auto stays off on the CPU backend."""
    from whisper_git_tpu.render.meshstate import (
        get_render_mesh, maybe_auto_mesh, set_render_mesh)

    try:
        monkeypatch.setenv("WGIT_MESH", "8")
        mesh = maybe_auto_mesh()
        assert mesh is not None and get_render_mesh() is mesh
        assert mesh.shape == {"dp": 1, "sp": 8}

        # The production frame path actually renders under it (cache
        # clears so the mesh render cannot reuse single-chip images).
        from whisper_git_tpu.render import compose as C, frame as F
        from whisper_git_tpu.render.rasterizer import render_scene_device

        scene = _steady_scene(renderer, 16.0)
        C.clear_caches()
        F.clear_caches()
        img_mesh = np.asarray(render_scene_device(
            scene, renderer.font_tex_device(),
            renderer.image_atlas_device()))
        set_render_mesh(None)
        C.clear_caches()
        F.clear_caches()
        img_single = np.asarray(render_scene_device(
            scene, renderer.font_tex_device(),
            renderer.image_atlas_device()))
        assert np.abs(img_mesh.astype(int)
                      - img_single.astype(int)).max() <= 4

        monkeypatch.setenv("WGIT_MESH", "0")
        assert maybe_auto_mesh() is None
        monkeypatch.setenv("WGIT_MESH", "auto")
        assert maybe_auto_mesh() is None  # cpu backend: auto stays off
    finally:
        set_render_mesh(None)


def test_mesh_flip_without_cache_clear_is_safe(renderer):
    """render_scene_sharded flips the render mesh per call WITHOUT
    clearing compose caches; a compose plan built single-chip (bbox-
    cropped layer tuples) must never serve the mesh blend (full-frame
    sharded stacks) or vice versa — the plan cache keys on mesh identity
    (render/compose.py prepare_compose_dispatch). Interleave the two
    paths on the SAME scene with NO cache clears and require agreement."""
    import whisper_git_tpu.render.compose as C
    import whisper_git_tpu.render.frame as F
    from whisper_git_tpu.parallel.mesh import make_mesh
    from whisper_git_tpu.render import rasterizer as R
    from whisper_git_tpu.render.meshstate import (
        get_render_mesh,
        set_render_mesh,
    )
    from whisper_git_tpu.tools.fixtures import steady_window_scene

    mesh = make_mesh(4)
    assert get_render_mesh() is None
    C.clear_caches()
    F.clear_caches()
    try:
        outs = {}
        for label, m in (("single1", None), ("mesh1", mesh),
                         ("single2", None), ("mesh2", mesh)):
            set_render_mesh(m)
            scene = steady_window_scene(renderer, 16.0, (256, 128))
            outs[label] = np.asarray(R.render_scene_device(
                scene, renderer.font_tex_device(),
                renderer.image_atlas_device()))
        assert (outs["single1"] == outs["single2"]).all()
        d = np.abs(outs["single1"].astype(np.int16)
                   - outs["mesh1"].astype(np.int16))
        assert d.max() <= 4, d.max()
        assert (outs["mesh1"] == outs["mesh2"]).all()
    finally:
        set_render_mesh(None)


def test_sharded_kernel_prerendered_volatile_class(renderer, monkeypatch):
    """A volatile IMAGE tail under the mesh: the sharded blend renders the
    tail over the full (row-padded) tile axis and blends it full-frame;
    it must match single-chip within ±4/255 and leave the mesh's row
    padding out of the frame."""
    import numpy as np

    from whisper_git_tpu.render import compose as C
    from whisper_git_tpu.render import frame as F
    from whisper_git_tpu.ui import image, rect, row, spacer, stack
    from whisper_git_tpu.ui.theme import DARK

    monkeypatch.setenv("WGIT_FRAME_COMPOSE", "1")
    tile = np.zeros((16, 16, 4), np.uint8)
    tile[:, :, 0] = 220
    tile[:, :, 3] = 255
    # Height 320 → 5 tile rows: pads to 8 on the mesh (3 pad rows).
    ui = stack(
        rect(width="fill", height="fill", fill=DARK.background),
        row(spacer(300),
            image(tile, width=16, height=16, volatile=True),
            width="fill", height=60),
        width="fill", height="fill")

    def render():
        C.clear_caches()
        F.clear_caches()
        root = renderer.layout(ui, (512, 320))
        scene = renderer.compile(root, (512, 320), DARK.background)
        out = C.render_frame_composed(scene, renderer.font_tex_device(),
                                      renderer.image_atlas_device())
        assert out is not None
        return np.asarray(out)

    set_render_mesh(None)
    ref = render()
    assert ref[:, :, 0].max() >= 200, "volatile image not rendered"
    set_render_mesh(make_mesh(8, dp=2))
    try:
        got = render()
    finally:
        set_render_mesh(None)
    diff = np.abs(ref.astype(np.int16) - got.astype(np.int16))
    assert diff.max() <= 4, f"sharded volatile image tail: {diff.max()} u8"
