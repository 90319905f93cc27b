"""The port's own supervisor (``climate2weather_tpu_torch.training.supervisor``)
held to the cases of tests/test_supervisor.py: stall detection, kill and
restart, the quiet start, the crash-loop abort, the command line, the
steady pattern, the one-time startup grace and the SIGTERM that must reach
the child's group.

The supervised child is a tiny python script whose behavior flips on a state
file, standing in for the trainer's always-on checkpoint resume: the first
incarnation "wedges" (prints, then sleeps), the relaunched one finds the
state file and completes.
"""

import json
import os
import pathlib
import signal
import subprocess
import sys
import time

import pytest

from climate2weather_tpu_torch.training.supervisor import SupervisorConfig, main, supervise

PY = sys.executable
REPO = pathlib.Path(__file__).resolve().parents[1]


def _cfg(cmd, **kw):
    # generous margins: a loaded host may take seconds for a first line
    kw.setdefault("stall_timeout", 10.0)
    kw.setdefault("startup_grace", 120.0)
    kw.setdefault("term_grace", 5.0)
    kw.setdefault("restart_delay", 0.1)
    kw.setdefault("max_restarts", 3)
    return SupervisorConfig(cmd=list(cmd), **kw)


def test_clean_exit_passthrough(tmp_path):
    log = tmp_path / "out.log"
    res = supervise(_cfg([PY, "-c", "print('Status: tick'); print('done')"], log_path=str(log)))
    assert res.exit_code == 0
    assert res.restarts == 0 and res.stalls == 0
    text = log.read_bytes()
    assert b"Status: tick" in text and b"done" in text


def test_stall_is_killed_and_resumed(tmp_path):
    marker = tmp_path / "resumed"
    child = (
        "import pathlib,sys,time\n"
        f"m = pathlib.Path({str(marker)!r})\n"
        "if m.exists():\n"
        "    print('resumed ok'); sys.exit(0)\n"
        "m.touch()\n"
        "print('Status: tick', flush=True)\n"
        "time.sleep(600)\n"
    )
    journal = tmp_path / "journal.jsonl"
    res = supervise(_cfg([PY, "-c", child], journal_path=str(journal)))
    assert res.exit_code == 0
    assert res.stalls == 1 and res.restarts == 1
    kinds = [json.loads(line)["event"] for line in journal.read_text().splitlines()]
    assert kinds == ["start", "stall", "killed", "start", "exit"]


def test_quiet_startup_not_killed():
    # silent for longer than stall_timeout, but within startup_grace
    res = supervise(_cfg([PY, "-c", "import time; time.sleep(15); print('up'); exit(0)"], stall_timeout=3.0))
    assert res.exit_code == 0 and res.stalls == 0


def test_crash_loop_aborts_with_child_code():
    res = supervise(_cfg([PY, "-c", "raise SystemExit(3)"], max_restarts=2))
    assert res.exit_code == 3
    assert res.restarts == 2  # restarts exhausted, then gave up


@pytest.mark.parametrize("argv,code", [(["--stall-timeout", "5"], 2),
                                       (["--stall-timeout", "5", "--", PY, "-c", "print('hello')"], 0)],
                         ids=["requires_command", "runs_command"])
def test_cli(tmp_path, argv, code):
    """Without a command the CLI is an argparse error (2); with one it runs
    it and keeps the journal."""
    journal = tmp_path / "j.jsonl"
    try:
        got = main(["--journal", str(journal)] + argv)
    except SystemExit as e:
        got = e.code
    assert got == code
    assert journal.exists() == (code == 0)


def test_sigterm_kills_child_group(tmp_path):
    # terminating the supervisor must not orphan the (possibly wedged,
    # silent) trainer: the child's pgid is killed on the way out
    pid_file = tmp_path / "child.pid"
    child = (
        "import os,pathlib,time\n"
        f"pathlib.Path({str(pid_file)!r}).write_text(str(os.getpid()))\n"
        "time.sleep(600)\n"  # silent wedge
    )
    sup = subprocess.Popen(
        [PY, "-m", "climate2weather_tpu_torch.training.supervisor", "--stall-timeout", "300",
         "--startup-grace", "300", "--term-grace", "5", "--", PY, "-c", child],
        cwd=str(REPO),
    )
    deadline = time.time() + 120
    while not pid_file.exists() and time.time() < deadline:
        time.sleep(0.2)
    assert pid_file.exists(), "child never started"
    child_pid = int(pid_file.read_text())
    sup.send_signal(signal.SIGTERM)
    assert sup.wait(timeout=60) == 128 + signal.SIGTERM
    deadline = time.time() + 30
    while time.time() < deadline:
        try:
            os.kill(child_pid, 0)
        except ProcessLookupError:
            break
        time.sleep(0.2)
    else:
        os.kill(child_pid, 9)  # clean up before failing
        raise AssertionError("child survived supervisor SIGTERM")


@pytest.mark.parametrize("child,stalls", [
    # a setup line, then silent for 6 s (> stall_timeout, < startup_grace)
    # before its first Status line: not a stall
    ("import time\nprint('Setting up...', flush=True)\ntime.sleep(6)\nprint('Status: +++ 0', flush=True)\n", 0),
    # after a Status line, a silence > stall_timeout is one
    ("import time\nprint('Status: +++ 0', flush=True)\ntime.sleep(30)\n", 1),
], ids=["quiet_setup", "silent_after_status"])
def test_steady_pattern_gates_stall_timeout(child, stalls):
    """With a steady pattern, non-matching setup lines keep the child under
    startup_grace; the first matching line arms the steady stall_timeout."""
    res = supervise(_cfg([PY, "-c", child], stall_timeout=3.0, max_restarts=0, steady_pattern="Status:"))
    assert res.stalls == stalls
    if not stalls:
        assert res.exit_code == 0


def test_startup_grace_not_renewed_by_nonmatching_lines(tmp_path):
    """startup_grace is a one-time window from process start: a child that
    never reaches steady state but keeps printing non-matching lines is
    killed once the window has passed."""
    child = "import time\nwhile True:\n    print('retrying connection...', flush=True)\n    time.sleep(2)\n"
    journal = tmp_path / "journal.jsonl"
    res = supervise(_cfg([PY, "-c", child], stall_timeout=3.0, startup_grace=6.0, max_restarts=0,
                         steady_pattern="Status:", journal_path=str(journal)))
    assert res.stalls == 1
    evt = [json.loads(line) for line in journal.read_text().splitlines()
           if json.loads(line)["event"] == "stall"][0]
    assert evt["steady_seen"] is False and evt["timeout_s"] == 6.0
