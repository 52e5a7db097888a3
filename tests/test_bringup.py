"""What the main path needs to start anywhere, checked on the CPU: the
platform override, the compile-cache placement, the committed font
atlas, the stdlib PNG codec, a CLI screenshot without PIL / matplotlib /
fontTools, and chip_smoke.py's contract (no result without a GPU or
without the repository; last-line format; phase selection)."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Put before site-packages on PYTHONPATH, this makes the named top-level
# modules unimportable in a child process.
_BLOCKER = '''
import os, sys
_BLOCK = set(filter(None, os.environ.get("WGIT_BLOCK_MODULES", "").split(",")))
class _Blocker:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in _BLOCK:
            raise ImportError(f"blocked for this test: {name}")
        return None
sys.meta_path.insert(0, _Blocker())
'''


def _child_env(tmp_path, **extra) -> dict:
    env = dict(os.environ, JAX_PLATFORMS="cpu", WGIT_SKIP_AVATARS="1",
               HOME=str(tmp_path), XDG_CONFIG_HOME=str(tmp_path / "cfg"),
               XDG_CACHE_HOME=str(tmp_path / "cache"),
               PYTHONPATH=REPO)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    env.pop("WGIT_DEVICE", None)
    env.update(extra)
    return env


def _python(code: str, env: dict, cwd=REPO, timeout=300):
    return subprocess.run([sys.executable, "-c", code], env=env, cwd=cwd,
                          capture_output=True, text=True, timeout=timeout)


# --- platform override -------------------------------------------------

def test_wgit_device_unusable_value_stops_the_process(tmp_path):
    r = _python("import whisper_git_tpu; print('imported')",
                _child_env(tmp_path, WGIT_DEVICE="bogus"))
    assert r.returncode != 0
    assert "imported" not in r.stdout
    assert "WGIT_DEVICE='bogus'" in r.stderr


def test_wgit_device_cpu_selects_the_cpu(tmp_path):
    r = _python("import whisper_git_tpu, jax; print(jax.default_backend())",
                _child_env(tmp_path, WGIT_DEVICE="cpu"))
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "cpu"


# --- compile cache -----------------------------------------------------

_CACHE_PROBE = '''
import jax
from whisper_git_tpu.render import renderer as R
jax.default_backend = lambda: "gpu"   # the cache is skipped on the CPU
R.enable_persistent_compile_cache()
print(jax.config.jax_compilation_cache_dir)
'''


def test_compile_cache_honours_env_dir(tmp_path):
    want = str(tmp_path / "jaxcache")
    r = _python(_CACHE_PROBE, _child_env(tmp_path,
                                         JAX_COMPILATION_CACHE_DIR=want))
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == [want]


def test_compile_cache_defaults_to_fixed_ignored_path(tmp_path):
    from whisper_git_tpu.render.renderer import DEFAULT_COMPILE_CACHE_DIR

    r = _python(_CACHE_PROBE, _child_env(tmp_path))
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == [DEFAULT_COMPILE_CACHE_DIR]
    assert os.path.dirname(DEFAULT_COMPILE_CACHE_DIR) == REPO
    with open(os.path.join(REPO, ".gitignore")) as f:
        ignored = f.read().split()
    assert os.path.basename(DEFAULT_COMPILE_CACHE_DIR) + "/" in ignored


def test_compile_meter_counts_backend_compiles():
    import jax
    import jax.numpy as jnp

    from whisper_git_tpu.render.renderer import (
        compile_meter,
        start_compile_meter,
    )

    start_compile_meter()
    before = compile_meter()["compiles"]
    jax.jit(lambda x: x * 3 + 17)(jnp.arange(11)).block_until_ready()
    assert compile_meter()["compiles"] > before


# --- PNG codec and font atlas ------------------------------------------

def test_png_roundtrip_is_lossless():
    from whisper_git_tpu.render.renderer import decode_png, encode_png

    img = (np.random.default_rng(7).random((37, 53, 4)) * 255).astype(
        np.uint8)
    data = encode_png(img)
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    assert np.array_equal(decode_png(data), img)


def test_png_decoder_rejects_what_the_encoder_never_writes():
    import struct
    import zlib

    from whisper_git_tpu.render.renderer import decode_png, encode_png

    data = encode_png(np.zeros((2, 3, 4), np.uint8))
    # Same image with scanline filter type 1 (Sub) on the first row.
    raw = bytearray(b"\x00" + bytes(12) + b"\x00" + bytes(12))
    raw[0] = 1
    idat = zlib.compress(bytes(raw))
    start = data.index(b"IDAT") - 4
    (n,) = struct.unpack(">I", data[start:start + 4])
    chunk = (struct.pack(">I", len(idat)) + b"IDAT" + idat
             + struct.pack(">I", zlib.crc32(b"IDAT" + idat) & 0xFFFFFFFF))
    filtered = data[:start] + chunk + data[start + 12 + n:]
    with pytest.raises(ValueError, match="filter"):
        decode_png(filtered)
    with pytest.raises(ValueError, match="not a PNG"):
        decode_png(b"GIF89a" + bytes(10))


def test_png_decoder_matches_pil_on_goldens():
    Image = pytest.importorskip("PIL.Image")
    from whisper_git_tpu.render.renderer import load_png
    from whisper_git_tpu.tools.goldens import SCENES, golden_dir

    for name in SCENES:
        path = os.path.join(golden_dir(), f"{name}.png")
        want = np.asarray(Image.open(path).convert("RGBA"))
        assert np.array_equal(load_png(path), want), name


@pytest.mark.parametrize("bold", [False, True])
def test_committed_atlas_equals_regeneration(bold):
    """render/fonts/atlas-*.npz must be exactly what tools/atlas_gen.py
    makes from the committed fonts."""
    pytest.importorskip("PIL")
    from whisper_git_tpu.render.atlas import (
        atlas_arrays,
        atlas_path,
        rasterize_atlas,
    )

    fresh = atlas_arrays(rasterize_atlas(bold))
    with np.load(atlas_path(bold)) as z:
        assert set(z.files) == set(fresh)
        for k, v in fresh.items():
            assert np.array_equal(z[k], v), k


# --- CLI screenshot without the optional packages ----------------------

def test_cli_screenshot_without_pil_matplotlib_fonttools(tmp_path,
                                                         temp_repo):
    blocker = tmp_path / "blocker"
    blocker.mkdir()
    (blocker / "sitecustomize.py").write_text(_BLOCKER)
    out = tmp_path / "shot.png"
    env = _child_env(tmp_path,
                     PYTHONPATH=f"{blocker}{os.pathsep}{REPO}",
                     WGIT_BLOCK_MODULES="PIL,matplotlib,fontTools")
    probe = _python("import PIL", env)
    assert probe.returncode != 0 and "blocked" in probe.stderr
    r = subprocess.run(
        [sys.executable, "-m", "whisper_git_tpu", "--screenshot", str(out),
         "--size", "320x200", "--repo", temp_repo],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    from whisper_git_tpu.render.renderer import load_png

    img = load_png(str(out))
    assert img.shape == (200, 320, 4)
    assert len(np.unique(img[..., 0])) > 4


# --- chip_smoke.py contract --------------------------------------------

def test_chip_smoke_fails_without_the_repository(tmp_path):
    lone = tmp_path / "lone"
    lone.mkdir()
    (lone / "chip_smoke.py").write_text(
        open(os.path.join(REPO, "chip_smoke.py")).read())
    env = _child_env(tmp_path)
    env.pop("PYTHONPATH")
    r = subprocess.run([sys.executable, "chip_smoke.py"], env=env,
                       cwd=str(lone), capture_output=True, text=True,
                       timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_fails_without_a_gpu(tmp_path):
    """Where JAX finds no GPU (the CPU test run), the smoke test exits
    non-zero and prints no result line."""
    r = subprocess.run([sys.executable, "chip_smoke.py"],
                       env=_child_env(tmp_path), cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_result_line_and_phases():
    sys.path.insert(0, REPO)
    import chip_smoke

    class Dev:
        platform, device_kind = "gpu", "NVIDIA H100 80GB HBM3"

    line = json.loads(chip_smoke.result_line([Dev()] * 4))
    assert line == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4}}
    assert chip_smoke.phases_for(4) == ("mesh",)
    one = chip_smoke.phases_for(1)
    assert "mesh" not in one
    assert {"scroll", "cli", "parity", "kernel", "tier"} <= set(one)
