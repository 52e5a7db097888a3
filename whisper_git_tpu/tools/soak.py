"""Scripted interactive soak on real hardware — `python -m
whisper_git_tpu.tools.soak [--secs N]`.

Spawns the REAL CLI on a pty against a realistic fixture repo (the
bench's 240-commit history), waits for the first presented frame, then
drives N seconds of scripted interaction at a human-ish cadence — scroll
wheel, row clicks, search open/type/close, command palette, hover
moves, Escape — asserting after warmup that:

  * every interaction repaints, and no repaint stalls > 1 s
    (reference bound: no sync work on the UI thread,
    /root/reference/docs/async-engine-redesign.md:27-31); up to 2
    stalls in (1 s, 3 s] are tolerated and RECORDED as present-path
    outliers;
  * RSS stays bounded (absolute cap + last-third growth < 10 %);
  * the process exits cleanly via the Escape ladder, restores the
    terminal, and leaves ZERO crash logs.

Writes SOAK.json at the repo root (git-ignored: a measurement, not a
source file)."""

from __future__ import annotations

import argparse
import datetime
import json
import os
import subprocess
import sys
import tempfile
import time

from .ptydrive import (
    ALT_EXIT,
    HALF_BLOCK,
    drain as _drain,
    drain_pending as _drain_pending,
    open_sized_pty,
    wait_growth as _wait_repaint,
)

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _tail(path, n=2000):
    try:
        with open(path, "rb") as f:
            f.seek(0, 2)
            f.seek(max(0, f.tell() - n))
            return f.read().decode("utf-8", "replace")
    except OSError:
        return "<unreadable>"


def _rss_mb(pid):
    try:
        with open(f"/proc/{pid}/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    return int(line.split()[1]) // 1024
    except OSError:
        return None
    return None


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--secs", type=int,
                    default=int(os.environ.get("WGIT_SOAK_SECS", "600")))
    ap.add_argument("--cpu", action="store_true",
                    help="CPU backend (harness smoke, not the real soak)")
    args = ap.parse_args()

    sys.path.insert(0, REPO)
    from bench import build_history_repo

    tmp = tempfile.mkdtemp(prefix="wgit-soak-")
    repo_path = build_history_repo(tmp)

    master, slave = open_sized_pty(40, 140, 1280, 800)
    env = dict(os.environ)
    env.update({
        "WGIT_SKIP_AVATARS": "1",
        "XDG_CONFIG_HOME": os.path.join(tmp, "cfg"),
        "XDG_CACHE_HOME": os.path.join(tmp, "cache"),
        "XDG_STATE_HOME": os.path.join(tmp, "state"),
    })
    if args.cpu:
        env["WGIT_DEVICE"] = "cpu"
    else:
        env.pop("WGIT_DEVICE", None)   # REAL device
    env.pop("XLA_FLAGS", None)
    env.pop("JAX_PLATFORMS", None)

    t_start = time.monotonic()
    # stderr to a FILE, not a pipe: JAX/XLA logging would fill a 64 KB
    # pipe and block the child mid-soak; a file also reads without the
    # risk of blocking on a live, silent child.
    err_path = os.path.join(tmp, "stderr.log")
    err_f = open(err_path, "wb")
    # App-side frame-loop heartbeat (host/loop.py): lets the gates below
    # distinguish an APP wedge from a stalled device — the presenter is
    # mailbox-async, so during a device stall the loop keeps beating
    # while presented bytes stall.
    hb_path = os.path.join(tmp, "heartbeat.log")
    env["WGIT_HEARTBEAT"] = hb_path
    # Present counters (host/term_display.py): how many frames were
    # DEVICE pixels vs degraded host-rasterized approximations — the
    # proof the degraded-present path ran during device stalls.
    stats_path = os.path.join(tmp, "present_stats.json")
    env["WGIT_PRESENT_STATS"] = stats_path
    # Aggregate cache ledger (whisper_git_tpu/ledger.py): per-cache
    # entries/bytes/caps, dumped by the frame loop every ~5 s.
    ledger_path = os.path.join(tmp, "ledger.json")
    env["WGIT_LEDGER"] = ledger_path
    proc = subprocess.Popen([sys.executable, "-m", "whisper_git_tpu",
                             repo_path],
                            stdin=slave, stdout=slave,
                            stderr=err_f, env=env, cwd=REPO,
                            close_fds=True)
    os.close(slave)
    buf = bytearray()
    result = {
        "date": datetime.datetime.now(
            datetime.timezone.utc).isoformat(timespec="seconds"),
        "git_head": subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], cwd=REPO,
            capture_output=True, text=True).stdout.strip(),
        "backend": "cpu" if args.cpu else "device",
        "secs_requested": args.secs,
    }
    ok = True
    notes = []
    try:
        # First frame (cold-compile budget).
        end = time.monotonic() + 480
        while HALF_BLOCK not in buf and time.monotonic() < end \
                and proc.poll() is None:
            _drain(master, buf, 0.5)
        assert HALF_BLOCK in buf, \
            "no first frame; stderr tail: " + _tail(err_path)
        result["first_frame_s"] = round(time.monotonic() - t_start, 1)
        # Let the initial refresh/compiles settle before the stall gate.
        _drain(master, buf, 8.0)

        rss0 = _rss_mb(proc.pid)
        rss_series = [(0.0, rss0)]
        stalls, repaint_ms = [], []
        t_script = time.monotonic()  # heartbeat gaps before this are
        # first-frame warmup, not soak behavior
        interactions = 0

        # One scripted "user minute", repeated until the budget ends:
        # wheel scrolls, row clicks, search, palette, hover sweeps.
        script = (
            [(b"\x1b[<64;60;%dM" % r, 0.10) for r in (8, 10, 12, 14)]
            + [(b"\x1b[<65;60;%dM" % r, 0.10) for r in (14, 12, 10, 8)]
            + [(b"\x1b[<0;40;9M\x1b[<0;40;9m", 0.25),
               (b"/", 0.2), (b"lane", 0.3), (b"\x1b", 0.2),
               (b"\x10", 0.25), (b"wor", 0.3), (b"\x1b", 0.2)]
            + [(b"\x1b[<35;%d;%dM" % (c, r), 0.06)
               for c, r in ((30, 6), (50, 9), (70, 12), (90, 15))]
            + [(b"\x1b[<0;40;12M\x1b[<0;40;12m", 0.25), (b"\x1b", 0.2)]
        )
        deadline = time.monotonic() + args.secs
        si = 0
        while time.monotonic() < deadline and proc.poll() is None:
            seq, pause = script[si % len(script)]
            si += 1
            _drain_pending(master, buf)   # ambient repaint traffic out
            os.write(master, seq)
            dt = _wait_repaint(master, buf, 3.0)
            interactions += 1
            warm = si <= len(script)  # first cycle: jit signatures for
            # search dim / palette / new overscan buckets still compile
            t_now = round(time.monotonic(), 3)
            if dt is None:
                stalls.append(("no-repaint>3s", si, warm, t_now))
            else:
                repaint_ms.append(dt * 1e3)
                if dt > 1.0:
                    stalls.append((round(dt, 2), si, warm, t_now))
            time.sleep(pause)
            if si % 25 == 0:
                rss_series.append(
                    (round(time.monotonic() - t_start, 1),
                     _rss_mb(proc.pid)))
            if len(buf) > 32 << 20:
                del buf[:16 << 20]   # keep memory of the SOAK bounded

        rss_series.append((round(time.monotonic() - t_start, 1),
                           _rss_mb(proc.pid)))
        assert proc.poll() is None, \
            "app died mid-soak; stderr tail: " + _tail(err_path)

        # Quit via Escape ladder.
        for _ in range(8):
            os.write(master, b"\x1b")
            _drain(master, buf, 0.35)
            if proc.poll() is not None:
                break
        end = time.monotonic() + 30
        while proc.poll() is None and time.monotonic() < end:
            _drain(master, buf, 0.25)
        _drain(master, buf, 1.0)
        result["exit_rc"] = proc.returncode
        result["alt_screen_restored"] = ALT_EXIT in buf

        # Crash logs (hermetic XDG_STATE/CONFIG dirs).
        crash_dirs = [os.path.join(tmp, "cfg", "whisper-git", "crashes"),
                      os.path.join(tmp, "state", "whisper-git", "crashes")]
        crashes = []
        for d in crash_dirs:
            if os.path.isdir(d):
                # the .clean-exit marker lives in the same dir — only
                # crash-*.log files are actual crashes
                crashes += [os.path.join(d, f) for f in os.listdir(d)
                            if f.startswith("crash-")]
        result["crash_logs"] = len(crashes)

        # Present counters (degraded host-side present).
        try:
            with open(stats_path) as sf:
                stats = json.load(sf)
            result["degraded_frames"] = stats.get("degraded_frames")
            result["device_frames"] = stats.get("device_frames")
        except (OSError, ValueError):
            result["degraded_frames"] = None

        repaint_ms.sort()
        # First-cycle stalls are compile warmup (recorded, not gated) —
        # the same reason bench.py sweeps the scroll range before timing.
        gated = [s for s in stalls if not s[2]]
        warmup_stalls = [s for s in stalls if s[2]]
        hard = [s for s in gated if s[0] == "no-repaint>3s"]
        soft = [s for s in gated if s[0] != "no-repaint>3s"]
        result.update({
            "interactions": interactions,
            "repaint_p50_ms": round(repaint_ms[len(repaint_ms) // 2], 1)
            if repaint_ms else None,
            "repaint_p95_ms": round(
                repaint_ms[int(len(repaint_ms) * 0.95)], 1)
            if repaint_ms else None,
            "stalls_over_1s": soft,
            "stalls_over_3s": hard,
            "warmup_stalls_excluded": warmup_stalls,
            "rss_mb_series": rss_series,
        })
        # Gates.
        if proc.returncode != 0:
            ok = False
            notes.append("nonzero exit")
        if not result["alt_screen_restored"]:
            ok = False
            notes.append("terminal not restored")
        if crashes:
            ok = False
            notes.append("crash logs present")
        # Three-signal stall attribution (host/loop.py WGIT_HEARTBEAT):
        #   1. pure-HOST timer-thread heartbeat — gaps mean the PROCESS
        #      wedged (deadlock, GIL hang): a genuine app failure in any
        #      environment → always fail.
        #   2. frame-LOOP heartbeat — the UI thread is host-pure since
        #      render dispatch moved to the render thread (before that, a
        #      slow device dispatch blocked the loop for up to ~11 s —
        #      the measurement that forced the split). A loop gap now
        #      means build/layout/reducers stalled; the
        #      20% budget is kept as a backstop, but any recurring gap
        #      here deserves investigation regardless of ok=true.
        #   3. presented bytes (the repaint gate) — stalls with a
        #      healthy loop are present-path congestion the mailbox
        #      presenter absorbed by dropping frames, as designed; the
        #      CLI backend (CPU) also lands here when frames render
        #      slower than the 1 s gate.
        def read_beats(path):
            try:
                with open(path) as hf:
                    return [float(x) for x in hf.read().split()]
            except (OSError, ValueError):
                return []

        def gaps_after(beats, t0, thresh):
            out = []
            for a, b in zip(beats, beats[1:]):
                if b > t0 and b - a > thresh:
                    out.append((round(b - a, 2), round(b, 3)))
            return out

        host_beats = read_beats(hb_path + ".host")
        loop_beats = read_beats(hb_path)
        host_gaps = gaps_after(host_beats, t_script, 1.5)
        loop_gaps = gaps_after(loop_beats, t_script, 1.5)
        loop_stall_s = round(sum(g for g, _ in loop_gaps), 1)
        result["host_thread_max_gap_s"] = round(
            max((g for g, _ in host_gaps), default=0.0), 2)
        result["app_loop_max_gap_s"] = round(
            max((g for g, _ in loop_gaps), default=0.0), 2)
        result["app_loop_blocked_s"] = loop_stall_s
        if host_gaps:
            ok = False
            notes.append(
                f"PROCESS wedged: {len(host_gaps)} host-thread heartbeat "
                f"gap(s) > 1.5 s (max {result['host_thread_max_gap_s']} s)")
        if loop_gaps:
            if loop_stall_s > args.secs * 0.2:
                ok = False
                notes.append(
                    f"frame loop blocked {loop_stall_s} s (> 20% of the "
                    "soak) — degraded window, not certifiable")
            else:
                notes.append(
                    f"frame loop blocked {loop_stall_s} s in "
                    f"{len(loop_gaps)} gap(s) (device dispatch stalls; "
                    "see repaint_p95)")

        # Presented-bytes stalls, clustered into EVENTS (consecutive
        # si ≤ 3 apart = one congestion window).
        gated_all = sorted(hard + soft, key=lambda s: s[1])
        events, prev_si = [], None
        for s in gated_all:
            if prev_si is None or s[1] - prev_si > 3:
                events.append([s])
            else:
                events[-1].append(s)
            prev_si = s[1]
        result["present_stall_events"] = len(events)
        if loop_beats:
            if events:
                outage_s = sum(
                    (3.0 if s[0] == "no-repaint>3s" else float(s[0]))
                    for e in events for s in e)
                result["present_outage_s"] = round(outage_s, 1)
                if outage_s > args.secs * 0.2:
                    ok = False
                    notes.append(
                        f"present outages consumed {outage_s:.0f} s "
                        "(> 20% of the soak)")
                else:
                    notes.append(
                        f"{len(events)} present-stall event(s) "
                        f"({outage_s:.1f} s total), tolerated "
                        "(present-path stalls; see repaint_p95)")
        else:
            # No heartbeat → fall back to the strict historical gates.
            notes.append("no heartbeat recorded — strict gates")
            if hard:
                ok = False
                notes.append(f"{len(hard)} post-warmup stalls > 3 s")
            if len(events) > 2:
                ok = False
                notes.append(
                    f"{len(events)} stall events > 1 s (tolerance 2)")
        # Cache ledger gate: every registered cache
        # must respect its cap at the last dump.
        try:
            with open(ledger_path) as lf:
                led = json.load(lf)
            result["cache_ledger"] = led
            cache_viol = led.pop("_violations", [])
            if cache_viol:
                ok = False
                notes.append("cache cap violations: "
                             + "; ".join(cache_viol[:4]))
            # Compile attribution: a run whose persistent cache was
            # mostly hot must not spend more than 3 s actually compiling.
            meter = led.pop("_compile_meter", None)
            if meter:
                result["compile_s"] = meter.get("compile_s")
                result["compile_trace_s"] = meter.get("trace_s")
                result["compile_cache_hits"] = meter.get("cache_hits")
                result["compile_cache_misses"] = meter.get(
                    "cache_misses")
                hits = meter.get("cache_hits") or 0
                misses = meter.get("cache_misses") or 0
                if not args.cpu and hits > 0 and misses <= 3 \
                        and (meter.get("compile_s") or 0) > 3.0:
                    ok = False
                    notes.append(
                        f"warm-cache compile budget: "
                        f"{meter['compile_s']:.1f} s compiling with "
                        f"{hits} cache hits / {misses} misses (<= 3 s)")
        except (OSError, ValueError):
            notes.append("no cache ledger recorded")

        rss_vals = [r for _, r in rss_series if r is not None]
        if rss_vals:
            result["rss_mb_final"] = rss_vals[-1]
            if rss_vals[-1] > 6000:
                ok = False
                notes.append(f"RSS {rss_vals[-1]} MB over 6 GB cap")
            third = max(1, len(rss_vals) // 3)
            if rss_vals[-1] > rss_vals[-third] * 1.10 + 64:
                ok = False
                notes.append("RSS still growing in the final third")
        # RSS plateau gate: least-squares slope over the post-warmup
        # tail (skip the first third — compiles/caches legitimately
        # fill there) must stay under ~2 MB/min.
        pts = [(t, r) for t, r in rss_series
               if r is not None and t >= rss_series[-1][0] / 3.0]
        if len(pts) >= 4 and pts[-1][0] > pts[0][0] + 60:
            n = len(pts)
            mt = sum(t for t, _ in pts) / n
            mr = sum(r for _, r in pts) / n
            denom = sum((t - mt) ** 2 for t, _ in pts)
            slope = (sum((t - mt) * (r - mr) for t, r in pts)
                     / denom * 60.0) if denom else 0.0
            result["rss_slope_mb_per_min"] = round(slope, 2)
            # Gate on the DEVICE backend: there the image caches live in
            # device memory and host RSS must plateau. The CPU smoke
            # holds those same caches in process RSS with glibc arena
            # bounce on top — recorded, not gated.
            #
            # The allowance term: a device-client term of ~22 KB of host
            # RSS per presented frame, fitted on an earlier accelerator
            # platform (the same loop WITHOUT dispatches was flat, every
            # registered cache bounded, the growth survived
            # malloc_trim). Whether the GPU client has it is unmeasured
            # (ROADMAP Y4); the app's own budget stays 2 MB/min on top.
            fpm = ((result.get("device_frames") or 0)
                   / max(args.secs / 60.0, 1.0))
            # 0.025 MB per presented frame-minute: the fitted term's
            # upper bound.
            allowed = 2.0 + 0.025 * fpm
            result["rss_slope_allowed_mb_per_min"] = round(allowed, 2)
            if slope > allowed and not args.cpu:
                ok = False
                notes.append(
                    f"RSS slope {slope:.1f} MB/min post-warmup over "
                    f"gate {allowed:.1f} (2.0 app budget + device-"
                    f"client term {0.025 * fpm:.1f} at "
                    f"{fpm:.0f} presented fps*60)")
    except AssertionError as e:
        ok = False
        notes.append(str(e)[:500])
    finally:
        if proc.poll() is None:
            proc.kill()   # exact PID we spawned
            proc.wait(timeout=10)
        os.close(master)
        try:
            err_f.close()
        except Exception:
            pass

    result["ok"] = ok
    result["notes"] = notes
    path = os.path.join(REPO, "SOAK.json")
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({k: result.get(k) for k in (
        "date", "backend", "ok", "first_frame_s", "interactions",
        "repaint_p50_ms", "repaint_p95_ms", "degraded_frames",
        "device_frames", "rss_mb_final", "notes")}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
