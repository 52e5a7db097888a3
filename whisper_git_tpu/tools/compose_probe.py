"""On-chip compose device-time breakdown — `python -m
whisper_git_tpu.tools.compose_probe [--frames N] [--repo PATH]`.

The bench's `device_ms_per_frame` is one number; this tool decomposes
it by op kind so schedule changes can be attributed. Method: build a
steady-state history-view plan, collect per-frame blobs across scroll
offsets within one plan, then run the jitted-scan probe
(`compose_scan_probe`) with the op list FILTERED per variant — XLA
dead-code-elimination removes the unused work, so each variant isolates
one cost center. Timing is the slope between two scan lengths, which
cancels the dispatch+sync constant.

Variants: none (background + quantize + scan floor), imgs (chrome
layers), slabs (scroll-window crops), dyn (volatile tails), all.

Caveats: the deltas are not perfectly additive — the full schedule
overlaps memory traffic across ops — and single runs wobble; compare
medians of ≥3 runs when adjudicating a change.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=1920,
                    help="large scan length (small = frames//4)")
    ap.add_argument("--commits", type=int, default=240)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--repo", default=None,
                    help="repository to open (default: a generated "
                         "fixture of --commits commits)")
    args = ap.parse_args()

    import numpy as np

    import jax
    import jax.numpy as jnp

    from ..app.repo_tab import RepoTab
    from ..app.ui_app import WhisperApp
    from ..render import compose as CM
    from ..render.renderer import get_renderer
    from ..ui.theme import DARK
    from .dump_bundles import make_fixture_repo

    viewport = (1280, 800)
    repo = args.repo
    if repo is None:
        repo = make_fixture_repo(tempfile.mkdtemp(prefix="wgit_probe_"))
        env = dict(os.environ, GIT_TERMINAL_PROMPT="0")
        for i in range(args.commits):
            env["GIT_AUTHOR_DATE"] = env["GIT_COMMITTER_DATE"] = str(
                1_750_000_000 + i * 3600)
            subprocess.run(["git", "-C", repo, "commit", "--allow-empty",
                            "-m", f"filler {i}"], check=True,
                           capture_output=True, env=env)
    tab = RepoTab.open(repo)
    tab.refresh_sync(include_orphans=False)
    app = WhisperApp.with_tabs([tab])
    renderer = get_renderer()

    probe_blobs, shared0 = [], None
    probe_args = probe_statics = None
    for off in range(0, 121, 8):
        tab.history_scroll = float(off)
        tree = app.build((float(viewport[0]), float(viewport[1])))
        root = renderer.layout(tree, viewport)
        scene = renderer.compile(root, viewport, DARK.background)
        prep = CM.prepare_compose_dispatch(
            scene, renderer.font_tex_device(),
            renderer.image_atlas_device())
        if prep is None:
            continue
        a, st = prep
        shared = (id(a[1]), id(a[2]), a[0].shape, st["meta"])
        if shared0 is None:
            shared0, probe_args, probe_statics = shared, a, st
        if shared != shared0:
            continue  # plan changed (scroll bucket edge)
        probe_blobs.append(np.asarray(a[0]))
    if len(probe_blobs) < 4:
        print("not enough steady-state blobs", file=sys.stderr)
        return 1

    n_small, n_big = args.frames // 4, args.frames
    base = np.stack(probe_blobs)
    reps = -(-n_big // base.shape[0])
    blobs = np.tile(base, (reps, 1))[:n_big]
    imgs, slabs = probe_args[1], probe_args[2]
    ftex, iatlas = probe_args[3], probe_args[4]
    ops, dyn_meta, n_slabs = probe_statics["meta"]
    dev = jax.devices()[0]
    print(f"# device {dev.platform} ({dev.device_kind}); ops: {ops}",
          file=sys.stderr)

    def run_variant(name, keep):
        st = dict(probe_statics)
        st["meta"] = (tuple(op for op in ops if keep(op)), dyn_meta,
                      n_slabs)

        def probe(n):
            out = CM.compose_scan_probe(jnp.asarray(blobs[:n]), imgs,
                                        slabs, ftex, iatlas, st)
            return jax.block_until_ready(out)

        probe(n_small)
        probe(n_big)
        samples = []
        for _ in range(args.rounds):
            t0 = time.perf_counter()
            probe(n_small)
            ts = time.perf_counter() - t0
            t0 = time.perf_counter()
            probe(n_big)
            tb = time.perf_counter() - t0
            samples.append((tb - ts) / (n_big - n_small) * 1000.0)
        samples.sort()
        med = samples[len(samples) // 2]
        print(f"{name}: {med:.4f} ms/frame  "
              f"{[round(s, 4) for s in samples]}")
        return med

    run_variant("none (floor)", lambda op: False)
    run_variant("imgs only   ", lambda op: op[0] == "img")
    run_variant("slabs only  ", lambda op: op[0] == "slab")
    run_variant("dyn only    ", lambda op: op[0] == "dyn")
    run_variant("all         ", lambda op: True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
