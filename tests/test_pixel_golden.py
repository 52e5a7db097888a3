"""Pixel-golden regression suite: nine deterministic scenes rendered
through the real pipeline must match the checked-in PNGs within
±TOLERANCE u8 — a shader-math regression that keeps layout intact fails
here even though every tree/lint dump still passes. (Beyond-reference:
the reference's §4 strategy has no pixel gate.)

Regenerate intentionally-changed goldens with
`python -m whisper_git_tpu.tools.goldens` and review the diff."""

from __future__ import annotations

import os

import numpy as np
import pytest

from whisper_git_tpu.tools.goldens import (
    SCENES,
    TOLERANCE,
    golden_dir,
    render_scene_image,
)


def _load(name: str) -> np.ndarray:
    from whisper_git_tpu.render.renderer import load_png

    p = os.path.join(golden_dir(), f"{name}.png")
    assert os.path.exists(p), \
        f"missing golden {p}; run python -m whisper_git_tpu.tools.goldens"
    return load_png(p)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_scene_matches_golden(name):
    got = render_scene_image(name)
    want = _load(name)
    assert got.shape == want.shape
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= TOLERANCE, (
        f"{name}: max pixel diff {diff.max()} > {TOLERANCE} "
        f"({(diff.max(axis=-1) > TOLERANCE).sum()} px changed)")


def test_suite_is_sensitive():
    """A sub-pixel geometry perturbation (0.5 px — the kind a shader/
    quantization regression produces) must FAIL the comparison, proving
    the tolerance actually gates."""
    got = render_scene_image("chrome")
    want = _load("chrome")
    shifted = np.roll(got, 1, axis=1)  # 1 px shift ≈ worst-case AA change
    diff = np.abs(shifted.astype(np.int16) - want.astype(np.int16))
    assert diff.max() > TOLERANCE
