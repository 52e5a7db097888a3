"""Smoke test of the git client's render path on one NVIDIA GPU.

    python chip_smoke.py             # every phase, one card
    python chip_smoke.py --chips 4   # only the 4-card mesh phase

Drives the main path through the entry points a user calls, on the
seeded 100k-commit / 25k-file repository (tools/scale_repo.py) in the
history view at 1280×800, and checks what comes out against the repo's
own references. Each phase prints one line; any failure exits non-zero.
The first line names the card and its power limit (nvidia-smi), the last
line is one JSON object {"ok": true, "device": {...}}.

Phases (one card):
  native  build native/libwgitcore.so (make -C native) and load it
  scroll  first frame (cold compile) + a few hundred history-scroll frames
          across slab rebuilds through app.build → layout → compile →
          render_scene_device, with the compiles inside the scroll
  cli     `python -m whisper_git_tpu --screenshot` (host.main.main) → PNG
  parity  the nine CPU goldens (±2 u8) and compose vs packed (≤1 u8)
  kernel  the Pallas raster kernel compiled for the card vs the XLA scan:
          pixels and device time (scan probe) on the packed frame
  memory  compiled.memory_analysis() of the compose step
  tier    pytest -m gpu tests/test_gpu_hw.py, in this process
With --chips 4 only the mesh phase runs: steady-state frames with the
render mesh over 4 cards against the same frames on one card (±4 u8).

Everything runs in this one process, so one JAX process holds the card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
VIEWPORT = (1280, 800)
COMMITS = 100_000   # the seeded fixture (tools/scale_repo.py)
FILES = 25_000
FRAMES = 300        # history-scroll frames per pass, 7 px apart


def _fail(msg: str) -> int:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    return 1


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0].strip()


def phase_native() -> str:
    proc = subprocess.run(["make", "-C", os.path.join(HERE, "native")],
                          capture_output=True, text=True, timeout=300)
    from whisper_git_tpu.gitcore import native

    return (f"native: make rc={proc.returncode}, libwgitcore loaded="
            f"{native.available()}")


def build_fixture() -> str:
    from whisper_git_tpu.tools.scale_repo import build_scale_repo

    root = os.path.join(HERE, ".smoke")
    os.makedirs(root, exist_ok=True)
    return build_scale_repo(COMMITS, FILES, cache_root=root)


def _open_app(repo: str):
    from whisper_git_tpu.app.repo_tab import RepoTab
    from whisper_git_tpu.app.ui_app import WhisperApp

    tab = RepoTab.open(repo)
    tab.refresh_sync(include_orphans=False)
    return WhisperApp.with_tabs([tab]), tab


def _frame(app, renderer, size=VIEWPORT):
    """One frame of the app's frame path (the calls bench.py makes)."""
    from whisper_git_tpu.render.rasterizer import render_scene_device
    from whisper_git_tpu.ui.theme import DARK

    tree = app.build((float(size[0]), float(size[1])))
    root = renderer.layout(tree, size)
    scene = renderer.compile(root, size, DARK.background)
    return render_scene_device(scene, renderer.font_tex_device(),
                               renderer.image_atlas_device())


def _check_frame(img, size=VIEWPORT) -> None:
    import numpy as np

    a = np.asarray(img)
    assert a.shape == (size[1], size[0], 4) and a.dtype == np.uint8, \
        (a.shape, a.dtype)
    assert len(np.unique(a[..., 0])) > 8, "frame is blank"


def phase_scroll(app, tab, renderer, frames: int, step: float) -> str:
    import jax

    from whisper_git_tpu.render import compose as C
    from whisper_git_tpu.render.renderer import compile_meter

    tab.history_scroll = 0.0
    t0 = time.perf_counter()
    img = jax.block_until_ready(_frame(app, renderer))
    first_s = time.perf_counter() - t0
    _check_frame(img)
    m0 = compile_meter()
    slabs = set()
    t0 = time.perf_counter()
    for i in range(1, frames + 1):
        tab.history_scroll = i * step
        img = _frame(app, renderer)
        slabs.update(id(v["img"]) for v in C._SLAB_CACHE.values())
    jax.block_until_ready(img)
    wall = time.perf_counter() - t0
    _check_frame(img)
    m1 = compile_meter()
    return (f"scroll: {frames} frames over {frames * step:.0f} px in "
            f"{wall:.3f} s ({frames / wall:.1f} frames/s host clock), "
            f"{len(slabs)} slabs built; first frame {first_s:.2f} s "
            f"(cold: {m0['compiles']} compiles, {m0['compile_s']} s "
            f"compiling); {m1['compiles'] - m0['compiles']} compiles "
            f"({m1['compile_s'] - m0['compile_s']:.2f} s) inside the "
            f"scroll")


def phase_cli(repo: str, out_dir: str) -> str:
    from whisper_git_tpu.host.main import main as cli_main
    from whisper_git_tpu.render.renderer import load_png

    out = os.path.join(out_dir, "screenshot-history-1280x800.png")
    t0 = time.perf_counter()
    rc = cli_main(["--screenshot", out, "--size", "1280x800",
                   "--repo", repo])
    dt = time.perf_counter() - t0
    assert rc == 0, f"CLI exit {rc}"
    _check_frame(load_png(out))
    return (f"cli: --screenshot of the fixture at 1280x800 in {dt:.2f} s "
            f"→ {out}")


def _diff(a, b) -> int:
    import numpy as np

    a, b = np.asarray(a).astype(np.int16), np.asarray(b).astype(np.int16)
    assert a.shape == b.shape, (a.shape, b.shape)
    return int(np.abs(a - b).max())


def phase_parity(app, tab, renderer) -> str:
    import importlib.util

    from whisper_git_tpu.app.views.widgets import freeze_pulse
    from whisper_git_tpu.render import compose as C, frame as F
    from whisper_git_tpu.render.renderer import load_png
    from whisper_git_tpu.tools.goldens import (
        SCENES,
        SIZE as GOLDEN_SIZE,
        TOLERANCE,
        golden_dir,
        render_scene_image,
    )

    # The fallback scene rasterizes DejaVu tail glyphs through PIL and
    # fontTools; without them it renders '?' and has no golden to match,
    # so it is only checked to render a frame.
    can_fallback = all(importlib.util.find_spec(m)
                       for m in ("PIL", "fontTools"))
    worst, checked = 0, []
    for name in sorted(SCENES):
        img = render_scene_image(name)
        if name == "fallback" and not can_fallback:
            _check_frame(img, GOLDEN_SIZE)
            continue
        d = _diff(img, load_png(os.path.join(golden_dir(), f"{name}.png")))
        assert d <= TOLERANCE, f"golden {name}: {d} u8 > {TOLERANCE}"
        worst = max(worst, d)
        checked.append(name)
    freeze_pulse(1.0)
    tab.history_scroll = 240.0
    C.clear_caches()
    F.clear_caches()
    composed = _frame(app, renderer)
    env = {k: os.environ.get(k) for k in ("WGIT_FRAME_COMPOSE",
                                          "WGIT_FRAME_CACHE")}
    os.environ["WGIT_FRAME_COMPOSE"] = "0"
    os.environ["WGIT_FRAME_CACHE"] = "0"
    try:
        packed = _frame(app, renderer)
    finally:
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        freeze_pulse(None)
    d_cp = _diff(composed, packed)
    assert d_cp <= 1, f"compose vs packed: {d_cp} u8 > 1"
    skipped = ("" if can_fallback else " (fallback: rendered, no golden "
               "— PIL/fontTools absent)")
    return (f"parity: goldens {len(checked)}/9 max {worst} u8 (bound "
            f"{TOLERANCE}){skipped}; history frame compose vs packed "
            f"max {d_cp} u8 (bound 1)")


def _packed_inputs(app, tab, renderer, scroll: float):
    import jax.numpy as jnp

    from whisper_git_tpu.render import rasterizer as R
    from whisper_git_tpu.ui.theme import DARK

    tab.history_scroll = scroll
    tree = app.build((float(VIEWPORT[0]), float(VIEWPORT[1])))
    root = renderer.layout(tree, VIEWPORT)
    scene = renderer.compile(root, VIEWPORT, DARK.background)
    fused, meta, ty, tx, win_list = R.pack_scene(scene)
    wins = tuple(jnp.asarray(b) for _, _, b in win_list)
    statics = (("background", tuple(float(c)
                                    for c in scene.background[:3])),
               ("tiles_y", ty), ("tiles_x", tx), ("meta", meta),
               ("height", scene.height), ("width", scene.width))
    return (fused, wins, renderer.font_tex_device(),
            renderer.image_atlas_device(), statics)


def packed_device_ms(inputs, use_pallas: bool, n_small=4, n_big=20):
    """Device ms per packed full-frame raster: N frames in one jitted
    lax.scan (distinct copies of the frame blob, so nothing is hoisted),
    the slope of two N values removing the dispatch and sync constant."""
    import functools

    import jax
    import jax.numpy as jnp
    import numpy as np

    from whisper_git_tpu.render import rasterizer as R

    fused, wins, font, atlas, statics = inputs

    @functools.partial(jax.jit, static_argnames=("statics", "use_pallas"))
    def probe(stack, wins, font, atlas, statics, use_pallas):
        def body(c, f):
            img = R._render_packed(f, wins, font, atlas, **dict(statics),
                                   use_pallas=use_pallas)
            return c ^ jnp.sum(img[..., 0].astype(jnp.uint32)), None

        return jax.lax.scan(body, jnp.uint32(0), stack)[0]

    def run(n):
        stack = jnp.asarray(np.tile(fused[None], (n, 1)))
        probe(stack, wins, font, atlas, statics, use_pallas)  # compile
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            jax.block_until_ready(
                probe(stack, wins, font, atlas, statics, use_pallas))
            best = min(best, time.perf_counter() - t0)
        return best

    return (run(n_big) - run(n_small)) * 1e3 / (n_big - n_small)


def scroll_pass(app, tab, renderer, use_pallas: bool, frames: int,
                step: float, block: bool = False):
    """The phase-(c) scroll from cleared frame caches (chrome layers and
    slabs re-rendered) with the raster kernel on or off → (seconds,
    per-frame blocked latencies in ms when `block`)."""
    import jax

    from whisper_git_tpu.render import compose as C, frame as F
    from whisper_git_tpu.render import rasterizer as R

    chosen = R._use_pallas
    R._use_pallas = lambda: use_pallas
    lat = []
    try:
        C.clear_caches()
        F.clear_caches()
        t0 = time.perf_counter()
        for i in range(1, frames + 1):
            tab.history_scroll = i * step
            t1 = time.perf_counter()
            img = _frame(app, renderer)
            if block:
                jax.block_until_ready(img)
                lat.append((time.perf_counter() - t1) * 1e3)
        jax.block_until_ready(img)
        return time.perf_counter() - t0, lat
    finally:
        R._use_pallas = chosen


def phase_kernel(app, tab, renderer) -> str:
    import jax
    import numpy as np

    from whisper_git_tpu.render import rasterizer as R

    inputs = _packed_inputs(app, tab, renderer, 240.0)
    fused, wins, font, atlas, statics = inputs
    imgs = {}
    for use_pallas in (True, False):
        t0 = time.perf_counter()
        imgs[use_pallas] = jax.block_until_ready(R._render_packed(
            fused, wins, font, atlas, **dict(statics),
            use_pallas=use_pallas))
        imgs[(use_pallas, "compile")] = time.perf_counter() - t0
    d = _diff(imgs[True], imgs[False])
    assert d <= 1, f"raster kernel vs XLA: {d} u8 > 1"
    ms = {p: packed_device_ms(inputs, p) for p in (True, False)}
    # End to end: the phase-(c) scroll from cleared caches after a warm-up
    # pass of each, pipelined and then blocked per frame, each in turns
    # (kernel, XLA, XLA, kernel) so drift falls on both sides alike.
    turns = (True, False, False, True)
    walls = {True: [], False: []}
    lat = {True: [], False: []}
    for p in (True, False):
        scroll_pass(app, tab, renderer, p, FRAMES, 7.0)
    for p in turns:
        walls[p].append(scroll_pass(app, tab, renderer, p, FRAMES, 7.0)[0])
    for p in turns:
        lat[p] += scroll_pass(app, tab, renderer, p, FRAMES, 7.0,
                              block=True)[1]
    e2e = {p: [1e3 * w / FRAMES for w in ws] for p, ws in walls.items()}
    pct = {p: np.percentile(v, (50, 90, 99)) for p, v in lat.items()}
    return (f"kernel: Pallas/Triton raster vs XLA scan on the packed "
            f"1280x800 history frame: max {d} u8 (bound 1); device "
            f"{ms[True]:.3f} vs {ms[False]:.3f} ms per frame (scan "
            f"probe); first call {imgs[(True, 'compile')]:.1f} vs "
            f"{imgs[(False, 'compile')]:.1f} s; scroll of {FRAMES} frames "
            f"from cleared caches pipelined {_ms(e2e[True])} vs "
            f"{_ms(e2e[False])} ms/frame per run (host clock, turns "
            f"K X X K); "
            f"blocked per frame (n = {len(lat[True])} each) p50/p90/p99 "
            f"{_ms(pct[True])} vs {_ms(pct[False])} ms")


def _ms(values) -> str:
    return "/".join(f"{v:.3f}" for v in values)


def phase_memory(app, tab, renderer) -> str:
    from whisper_git_tpu.render import compose as C
    from whisper_git_tpu.ui.theme import DARK

    tab.history_scroll = 240.0
    tree = app.build((float(VIEWPORT[0]), float(VIEWPORT[1])))
    root = renderer.layout(tree, VIEWPORT)
    scene = renderer.compile(root, VIEWPORT, DARK.background)
    args, statics = C.prepare_compose_dispatch(
        scene, renderer.font_tex_device(), renderer.image_atlas_device())
    ma = C._compose_frame.lower(*args, **statics).compile() \
        .memory_analysis()
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "generated_code_size_in_bytes")
    parts = ", ".join(f"{f.replace('_size_in_bytes', '')} "
                      f"{getattr(ma, f, None)} B" for f in fields)
    return f"memory: compose step {parts}"


class _Tally:
    """pytest plugin counting test outcomes."""

    def __init__(self):
        self.counts = {"passed": 0, "failed": 0, "skipped": 0}

    def pytest_runtest_logreport(self, report):
        if report.when == "call" or report.outcome != "passed":
            if report.outcome in self.counts:
                self.counts[report.outcome] += 1


def phase_tier() -> str:
    import pytest

    tally = _Tally()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(HERE, "tests", "test_gpu_hw.py")],
                     plugins=[tally])
    c = tally.counts
    assert rc == 0 and c["passed"] > 0, f"gpu tier rc={rc} {c}"
    return (f"tier: pytest -m gpu: {c['passed']} passed, {c['failed']} "
            f"failed, {c['skipped']} skipped")


def phase_mesh(app, tab, renderer, n: int) -> str:
    import jax
    import numpy as np
    from jax.sharding import Mesh

    from whisper_git_tpu.app.views.widgets import freeze_pulse
    from whisper_git_tpu.render import compose as C, frame as F
    from whisper_git_tpu.render.meshstate import set_render_mesh

    devices = jax.devices()
    assert len(devices) >= n, f"need {n} devices, found {len(devices)}"
    mesh = Mesh(np.array(devices[:n]).reshape(1, n), ("dp", "sp"))
    offsets = (0.0, 16.0, 32.0, 240.0, 400.0)
    freeze_pulse(1.0)

    def render_all():
        C.clear_caches()
        F.clear_caches()
        out = []
        for off in offsets:
            tab.history_scroll = off
            out.append(np.asarray(_frame(app, renderer)))
        return out

    set_render_mesh(None)
    single = render_all()
    set_render_mesh(mesh)
    try:
        t0 = time.perf_counter()
        sharded = render_all()
        dt = time.perf_counter() - t0
    finally:
        set_render_mesh(None)
        freeze_pulse(None)
    worst = max(_diff(a, b) for a, b in zip(single, sharded))
    assert worst <= 4, f"mesh vs one card: {worst} u8 > 4"
    return (f"mesh: {len(offsets)} steady-state history frames with the "
            f"render mesh over {n} cards vs one card: max {worst} u8 "
            f"(bound 4); sharded pass {dt:.1f} s incl. compiles")


ONE_CARD_PHASES = ("native", "scroll", "cli", "parity", "kernel", "memory",
                   "tier")


def phases_for(chips: int) -> tuple:
    """The phases a run makes: every one-card phase, or with more than
    one card only the mesh phase (and what it is compared with)."""
    return ONE_CARD_PHASES if chips == 1 else ("mesh",)


def result_line(devices) -> str:
    """The last line: the device as JAX reports it."""
    dev = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}})


def open_fixture() -> dict:
    """Build (or reuse) the seeded fixture and open it in the app."""
    from whisper_git_tpu.render.renderer import get_renderer

    t0 = time.perf_counter()
    repo = build_fixture()
    app, tab = _open_app(repo)
    print(f"fixture: {COMMITS} commits / {FILES} files, "
          f"{len(tab.commits)} commits loaded, built and opened in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return {"app": app, "tab": tab, "repo": repo, "renderer": get_renderer()}


def run_phase(name: str, ctx: dict | None, args) -> str:
    if name == "native":
        return phase_native()
    app, tab, renderer = ctx["app"], ctx["tab"], ctx["renderer"]
    if name == "scroll":
        return phase_scroll(app, tab, renderer, FRAMES, 7.0)
    if name == "cli":
        return phase_cli(ctx["repo"], args.out)
    if name == "parity":
        return phase_parity(app, tab, renderer)
    if name == "kernel":
        return phase_kernel(app, tab, renderer)
    if name == "memory":
        return phase_memory(app, tab, renderer)
    if name == "tier":
        return phase_tier()
    if name == "mesh":
        return phase_mesh(app, tab, renderer, args.chips)
    raise ValueError(f"unknown phase {name!r}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, default=1,
                    help="4: run only the mesh phase over 4 cards")
    ap.add_argument("--out", default=os.path.join(HERE, "chiprun_out",
                                                  "smoke"))
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(HERE, "whisper_git_tpu")):
        return _fail(f"no whisper_git_tpu package beside {__file__}")
    sys.path.insert(0, HERE)
    # No network: avatars would fetch from Gravatar.
    os.environ["WGIT_SKIP_AVATARS"] = "1"
    try:
        card = card_line()
    except (OSError, subprocess.SubprocessError) as exc:
        return _fail(f"nvidia-smi: {exc}")
    print(f"card: {card}", flush=True)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        return _fail(f"JAX found no GPU (platform {dev.platform})")
    # Keep pytest's conftest from pointing later JAX users at the CPU.
    os.environ["JAX_PLATFORMS"] = "cuda"
    os.makedirs(args.out, exist_ok=True)

    ctx = None
    try:
        for name in phases_for(args.chips):
            if ctx is None and name != "native":
                ctx = open_fixture()
            print(run_phase(name, ctx, args), flush=True)
    except Exception as exc:  # any phase failing fails the run
        import traceback

        traceback.print_exc()
        return _fail(f"{type(exc).__name__}: {exc}")
    finally:
        for t in ctx["app"].tabs if ctx else ():
            t.stop_workers()

    print(result_line(jax.devices()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
