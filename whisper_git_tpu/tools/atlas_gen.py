"""Regenerate the committed SDF font atlases from the bundled fonts.

    JAX_PLATFORMS=cpu python -m whisper_git_tpu.tools.atlas_gen [OUT_DIR]

Rasterizes render/atlas._CHARS from render/fonts/DejaVuSans{,-Bold}.ttf
(PIL) and writes render/fonts/atlas-{regular,bold}.npz, which the render
path loads with numpy alone. Needs PIL; run it on the CPU backend so the
committed arrays do not depend on an accelerator's arithmetic.
"""

from __future__ import annotations

import os
import sys

import numpy as np


def generate(out_dir: str | None = None) -> list[str]:
    from ..render.atlas import atlas_arrays, atlas_path, rasterize_atlas

    written = []
    for bold in (False, True):
        path = atlas_path(bold)
        if out_dir is not None:
            path = os.path.join(out_dir, os.path.basename(path))
        np.savez_compressed(path, **atlas_arrays(rasterize_atlas(bold)))
        written.append(path)
    return written


if __name__ == "__main__":
    for p in generate(sys.argv[1] if len(sys.argv) > 1 else None):
        print(f"wrote {p}")
