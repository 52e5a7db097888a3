"""Test configuration: the CPU backend with 8 virtual devices by default,
so the multi-chip sharding paths are exercised hermetically.

The GPU tier (tests/test_gpu_hw.py, @pytest.mark.gpu) runs on the card:
`JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_gpu_hw.py` (or
`python chip_smoke.py`, which runs the tier in its own process). Whether a
card is present is decided inside that module's fixture; without one its
tests skip."""

import os
import subprocess

# setdefault: an explicit JAX_PLATFORMS (the GPU tier) is honoured as it
# is; subprocesses spawned by tests inherit the choice.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import tempfile  # noqa: E402

# Hermetic state dir: Project Rewind snapshots (services/rewind.py) must
# never land in the developer's real ~/.local/state during tests.
os.environ["XDG_STATE_HOME"] = tempfile.mkdtemp(prefix="wgit-test-state-")

# Deterministic pixels: pin the dirty-indicator pulse clock so two renders
# of the same state compare byte-for-byte (pixel-exactness tests).
from whisper_git_tpu.app.views.widgets import (  # noqa: E402
    freeze_cursor,
    freeze_pulse,
)

freeze_pulse(0.0)
freeze_cursor(True)

import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs an NVIDIA GPU; run JAX_PLATFORMS=cuda python -m pytest "
        "-m gpu tests/test_gpu_hw.py")
    config.addinivalue_line(
        "markers",
        "scale: large-repo budgets (100k commits / 25k files); run "
        "WGIT_SCALE_TESTS=1 pytest -m scale")


def pytest_collection_modifyitems(config, items):
    if not os.environ.get("WGIT_SCALE_TESTS"):
        skip_scale = pytest.mark.skip(
            reason="scale tier: run WGIT_SCALE_TESTS=1 pytest -m scale")
        for item in items:
            if "scale" in item.keywords:
                item.add_marker(skip_scale)


@pytest.fixture()
def temp_repo(tmp_path):
    """A real throwaway git repo with one initial commit (the reference's
    integration tier never mocks git — SURVEY §4.2)."""
    repo_dir = tmp_path / "repo"
    repo_dir.mkdir()
    _git(repo_dir, "init", "-b", "main")
    _git(repo_dir, "config", "user.email", "test@example.com")
    _git(repo_dir, "config", "user.name", "Test User")
    (repo_dir / "README.md").write_text("hello\n")
    _git(repo_dir, "add", ".")
    _git(repo_dir, "commit", "-m", "initial commit")
    return str(repo_dir)


def _git(cwd, *args):
    env = dict(os.environ, GIT_TERMINAL_PROMPT="0", LC_ALL="C")
    subprocess.run(["git", "-C", str(cwd), *args], check=True,
                   capture_output=True, env=env)


@pytest.fixture()
def git():
    """Helper to run raw git commands in tests."""
    return _git
