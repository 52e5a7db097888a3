"""whisper_git_tpu — a JAX rebuild of the capabilities of
computer-whisperer/whisper-git (see SURVEY.md / ARCHITECTURE.md).

Subpackages:
  gitcore   — git backend (value types, GitRepo, refs/status/diff/hunks)
  engine    — async refresh engine (workers, watcher, debounce, safety nets)
  ui        — retained-mode El tree, layout, theme, lints, SVG dumps
  render    — accelerator rasterizer (scene buffers, SDF atlas, kernels)
  ops       — batched geometry/image ops (bezier, lanes, word-diff, resize)
  parallel  — device-mesh sharding of the render pipeline
  app       — WhisperApp / RepoTab state machine + views
  services  — config, tokens, recents, crash log, CI, avatars, AI
  host      — headless screenshot host + frame-loop driver
"""

__version__ = "0.1.0"

DEVICE_CHOICES = ("cpu", "gpu")


def _apply_device_override() -> None:
    """WGIT_DEVICE=cpu|gpu picks the JAX platform (the analog of the
    reference's WHISPER_GPU override, host.rs:567). It must run before any
    jax dispatch — graph layout (ops/) can touch jax well before the
    renderer exists, and the first dispatch locks the platform. Unset, JAX
    picks its own default (JAX_PLATFORMS is honoured as it is). A value
    outside DEVICE_CHOICES, or a platform this machine does not have, stops
    the process with an error instead of rendering somewhere else."""
    import os

    want = os.environ.get("WGIT_DEVICE")
    if not want:
        return
    if want not in DEVICE_CHOICES:
        raise SystemExit(f"wgit: WGIT_DEVICE={want!r} is not one of "
                         f"{', '.join(DEVICE_CHOICES)}")
    import jax

    if jax.config.jax_platforms != want:
        jax.config.update("jax_platforms", want)
    try:
        jax.devices(want)
    except RuntimeError as exc:
        raise SystemExit(f"wgit: WGIT_DEVICE={want!r} not usable: {exc}")


_apply_device_override()
