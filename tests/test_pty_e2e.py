"""Full-process end-to-end smoke: the REAL CLI on a REAL pty.

Everything else in the suite drives components in-process; this tier
spawns `python -m whisper_git_tpu <repo>` with its stdin/stdout on a
pseudo-terminal and speaks the actual wire protocol — alt-screen entry,
SGR mouse bytes, keystrokes, the Escape quit ladder — asserting the
process paints half-block frames, reacts to input, restores the terminal,
and exits cleanly. Catches the class of bug unit tests can't: broken
terminal setup/teardown ordering, input-parser/loop integration, crashes
on the app's own startup path. (The reference's closest tier is manual
windowed use; this is automated.)
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO_ROOT)

from whisper_git_tpu.tools.ptydrive import (  # noqa: E402
    ALT_ENTER,
    ALT_EXIT,
    HALF_BLOCK,
    drain,
    open_sized_pty,
    wait_for,
    wait_growth,
)


def _mk_repo(tmp_path) -> str:
    repo = str(tmp_path / "ptyrepo")
    os.makedirs(repo)

    def g(*args):
        subprocess.run(["git", "-C", repo, *args], check=True,
                       capture_output=True)

    g("init", "-q")
    g("config", "user.email", "t@t.t")
    g("config", "user.name", "T")
    for i in range(3):
        with open(os.path.join(repo, f"f{i}.txt"), "w") as f:
            f.write(f"line {i}\n")
        g("add", "-A")
        g("commit", "-qm", f"commit number {i}")
    with open(os.path.join(repo, "f0.txt"), "a") as f:
        f.write("dirty\n")
    return repo


_drain = drain
_wait_for = wait_for


def _wait_growth(master: int, buf: bytearray, timeout: float) -> bool:
    """Wait until new bytes arrive (a repaint) or timeout."""
    return wait_growth(master, buf, timeout) is not None


def test_pty_session_end_to_end(tmp_path):
    repo = _mk_repo(tmp_path)
    # A real terminal geometry (rows, cols, xpixel, ypixel) — the app
    # derives its half-block grid and SGR-Pixels mapping from this.
    master, slave = open_sized_pty(30, 100, 800, 480)

    env = dict(os.environ)
    env.update({
        "WGIT_DEVICE": "cpu",          # CPU backend in a smoke test
        "WGIT_SKIP_AVATARS": "1",
        "XDG_CONFIG_HOME": str(tmp_path / "cfg"),   # hermetic settings
        "XDG_CACHE_HOME": str(tmp_path / "cache"),
    })
    env.pop("XLA_FLAGS", None)          # child needs no virtual devices
    env.pop("JAX_PLATFORMS", None)
    # Small window = fewer tiles = fast CPU compile for the smoke.
    cfg_dir = tmp_path / "cfg" / "whisper-git"
    cfg_dir.mkdir(parents=True)
    (cfg_dir / "settings.json").write_text(
        '{"window_width": 480.0, "window_height": 320.0}')

    proc = subprocess.Popen(
        [sys.executable, "-m", "whisper_git_tpu", repo],
        stdin=slave, stdout=slave, stderr=subprocess.PIPE,
        env=env, cwd=REPO_ROOT, close_fds=True)
    os.close(slave)
    buf = bytearray()
    try:
        # 1) The host enters the alt screen and paints half-block frames.
        assert _wait_for(master, buf, ALT_ENTER, 60), \
            f"no alt-screen entry; stderr: {proc.stderr.peek()[:2000]}"
        assert _wait_for(master, buf, HALF_BLOCK, 300), \
            "no frame cells painted (compile stall or render crash)"

        # 2) Interact: click a history row, open search, type a query.
        os.write(master, b"\x1b[<0;40;6M\x1b[<0;40;6m")   # click+release
        os.write(master, b"/")
        time.sleep(0.2)
        os.write(master, b"commit")
        assert _wait_growth(master, buf, 8.0), \
            "no repaint after input events"

        # 2b) Command palette: Ctrl+P, fuzzy-type, close. Then a
        # right-click context menu on a history row, close.
        os.write(master, b"\x1b")          # close search first
        _drain(master, buf, 0.4)
        os.write(master, b"\x10")          # Ctrl+P
        _drain(master, buf, 0.6)
        os.write(master, b"rewi")
        assert _wait_growth(master, buf, 8.0), \
            "no repaint while typing in palette"
        os.write(master, b"\x1b")          # close palette
        _drain(master, buf, 0.4)
        os.write(master, b"\x1b[<2;40;6M\x1b[<2;40;6m")  # right-click
        assert _wait_growth(master, buf, 8.0), \
            "no repaint after right-click menu"

        # 3) Quit via the Escape ladder (search → selection → quit).
        # Keep DRAINING the pty while quitting: if the master buffer
        # fills, the child blocks writing its exit sequence.
        for _ in range(8):
            os.write(master, b"\x1b")
            _drain(master, buf, 0.35)
            if proc.poll() is not None:
                break
        end = time.monotonic() + 30
        while proc.poll() is None and time.monotonic() < end:
            _drain(master, buf, 0.25)
        assert proc.poll() is not None, "child did not exit after ladder"

        # 4) Terminal restored, clean exit.
        _drain(master, buf, 1.0)
        assert ALT_EXIT in buf, "terminal not restored on exit"
        assert buf.rindex(ALT_EXIT) > buf.index(ALT_ENTER)
        assert proc.returncode == 0, proc.stderr.read()[:2000].decode(
            "utf-8", "replace")
    finally:
        if proc.poll() is None:
            proc.kill()   # exact PID we spawned
            proc.wait(timeout=10)
        os.close(master)


def test_pty_live_watcher_end_to_end(tmp_path):
    """The full inotify → debounce → refresh → reducer → repaint path in
    ONE real process: mutate the repo externally (file edit, commit,
    branch) and assert the live UI repaints after each."""
    repo = _mk_repo(tmp_path)

    def g(*args):
        subprocess.run(["git", "-C", repo, *args], check=True,
                       capture_output=True)

    master, slave = open_sized_pty(30, 100, 800, 480)
    env = dict(os.environ, TERM="xterm-256color", WGIT_SKIP_AVATARS="1",
               WGIT_DEVICE="cpu")
    # Don't hand the child the suite's 8-virtual-device flag: the app
    # would auto-install a render mesh over virtual devices and XLA's
    # teardown can SIGABRT at exit under that config — the production
    # process runs single-device here.
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "whisper_git_tpu", repo],
        stdin=slave, stdout=slave, stderr=subprocess.PIPE,
        cwd=REPO_ROOT, env=env, close_fds=True)
    os.close(slave)
    buf = bytearray()
    try:
        assert _wait_for(master, buf, ALT_ENTER, 60), "no alt screen"
        assert _wait_for(master, buf, HALF_BLOCK, 120), "no first frame"
        _drain(master, buf, 2.0)

        # Working-tree lane (500 ms debounce): external edit → repaint.
        with open(os.path.join(repo, "f0.txt"), "a") as f:
            f.write("external edit\n")
        assert _wait_growth(master, buf, 20), "no repaint after edit"
        _drain(master, buf, 2.0)

        # Metadata lane (150 ms): external commit → graph repaint.
        g("add", "-A")
        g("commit", "-qm", "external commit while app runs")
        assert _wait_growth(master, buf, 20), "no repaint after commit"
        _drain(master, buf, 2.0)

        # Refs: external branch creation → sidebar repaint.
        g("branch", "watchbranch")
        assert _wait_growth(master, buf, 20), "no repaint after branch"
    finally:
        # Teardown only — this test asserts the WATCHER path above; the
        # quit-ladder/terminal-restore contract is the FIRST pty test's
        # job. Try the polite exit, then terminate.
        for _ in range(6):
            try:
                os.write(master, b"\x1b")
            except OSError:
                break
            time.sleep(0.4)
            if proc.poll() is not None:
                break
        for _ in range(10):
            if proc.poll() is not None:
                break
            time.sleep(0.5)
        if proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
        proc.stderr.close()
        os.close(master)
