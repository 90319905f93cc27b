"""External training supervisor: stall detection and automatic kill and
resume (own copy of climate2weather_tpu/training/supervisor.py, which needs
no JAX; the code is the same).

A long training run can wedge outside the training loop's own control: a
collective waits forever on a rank that died, a checkpoint write blocks on
a slow filesystem, or another process holds the card. In-process watchdogs
cannot help, since the wedged call never returns. The reference relies on
SLURM requeueing and its always-on ``load_latest`` resume for this; this
module does the same where no queue manager runs.

The supervisor runs the training command as a child process group, tails
its stdout, and treats *any* output line as liveness. If no line appears
for ``stall_timeout`` seconds the child is killed (SIGTERM, then SIGKILL)
and relaunched with the identical command line. Correctness rests entirely
on the training loop's exact resume (the checkpoint, the ndata-derived data
stream and the per-step generator), so a supervisor restart is the same as
any other restart from the last checkpoint.

Timing model (why "no output" is a safe stall signal):

- steady state prints a ``Status:`` line every ``--status`` interval;
- interval boundaries (snapshot, checkpoint, validation) are quiet for
  longer, hence the 15 min default timeout;
- startup (dataset, checkpoint load, network init, kernel builds) is quiet
  too, hence a separate, longer ``startup_grace``: a one-time window
  measured from process start that applies until steady state is reached
  (the first line matching ``steady_pattern``, or any line without one).

Every action is appended to ``<journal>`` as JSONL so a run's interruption
history is auditable next to its metrics.

Usage (a torchrun command works the same way: the whole launcher is the
child)::

    python -m climate2weather_tpu_torch.training.supervisor \
        --stall-timeout 900 --max-restarts 8 --steady-pattern 'Status:' \
        --log runs/train.log --journal runs/supervisor.jsonl \
        -- python -m climate2weather_tpu_torch.train --run-dir runs --run-id myrun ...
"""

from __future__ import annotations

import argparse
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field


@dataclass
class SupervisorConfig:
    cmd: list[str]
    stall_timeout: float = 900.0
    startup_grace: float = 3600.0
    max_restarts: int = 8
    term_grace: float = 30.0
    restart_delay: float = 10.0
    log_path: str | None = None
    journal_path: str | None = None
    # restarts older than this no longer count against max_restarts, so a
    # multi-day run survives rare periodic wedges while a crash loop
    # (max_restarts failures back to back) still aborts quickly.
    restart_window: float = 6 * 3600.0
    # When set, ``startup_grace`` applies until a line MATCHING this regex
    # is seen (not just any line).  The trainer prints setup lines within
    # seconds but then compiles silently for many minutes before its first
    # ``Status:`` line — with a tight stall_timeout and any-line liveness,
    # every (re)start would be falsely killed mid-compile, looping forever.
    # Pass ``--steady-pattern 'Status:'`` for the trainer.  None keeps
    # the original any-line behavior.
    steady_pattern: str | None = None


@dataclass
class SupervisorResult:
    exit_code: int
    restarts: int
    stalls: int
    events: list[dict] = field(default_factory=list)


class _ChildMonitor:
    """Owns one child process: forwards its stdout, tracks liveness."""

    def __init__(self, cmd: list[str], log_file, steady_re=None):
        self._log_file = log_file
        self._steady_re = steady_re
        self.start_time = time.monotonic()
        self.last_output = self.start_time
        self.saw_output = False
        # New session => the child and everything it spawns form a process
        # group we can kill by pgid (never by name pattern).
        self.proc = subprocess.Popen(
            cmd,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            start_new_session=True,
        )
        self._pump = threading.Thread(target=self._pump_output, daemon=True)
        self._pump.start()

    def _pump_output(self):
        assert self.proc.stdout is not None
        for line in iter(self.proc.stdout.readline, b""):
            self.last_output = time.monotonic()
            if self._steady_re is None or self._steady_re.search(
                line.decode("utf-8", "replace")
            ):
                self.saw_output = True
            # Child output always reaches the supervisor's stdout (the
            # supervisor is a transparent wrapper); --log adds a file copy.
            sys.stdout.buffer.write(line)
            sys.stdout.buffer.flush()
            if self._log_file is not None:
                self._log_file.write(line)
                self._log_file.flush()
        self.proc.stdout.close()

    def idle_seconds(self) -> float:
        return time.monotonic() - self.last_output

    def poll(self):
        return self.proc.poll()

    def kill(self, term_grace: float):
        """SIGTERM the child's process group, escalate to SIGKILL."""
        try:
            pgid = os.getpgid(self.proc.pid)
        except ProcessLookupError:
            return
        for sig, wait in ((signal.SIGTERM, term_grace), (signal.SIGKILL, 10.0)):
            try:
                os.killpg(pgid, sig)
            except ProcessLookupError:
                return
            deadline = time.monotonic() + wait
            while time.monotonic() < deadline:
                if self.proc.poll() is not None:
                    self._pump.join(timeout=5.0)
                    return
                time.sleep(0.2)
        self._pump.join(timeout=5.0)


def supervise(cfg: SupervisorConfig, _sleep=time.sleep) -> SupervisorResult:
    """Run ``cfg.cmd`` under stall supervision until it exits cleanly.

    Returns the final exit code (0 on clean success; the child's last exit
    code if restarts are exhausted; 125 if the run was abandoned mid-stall).
    """
    events: list[dict] = []
    journal = open(cfg.journal_path, "a") if cfg.journal_path else None
    log_file = open(cfg.log_path, "ab") if cfg.log_path else None

    def record(kind: str, **info):
        evt = {"ts": time.time(), "event": kind, **info}
        events.append(evt)
        if journal is not None:
            journal.write(json.dumps(evt) + "\n")
            journal.flush()
        print(f"[supervisor] {kind} {info}", file=sys.stderr, flush=True)

    restart_times: list[float] = []
    stalls = 0
    exit_code = 125
    child: _ChildMonitor | None = None

    # Terminating the supervisor must terminate the trainer: the child runs
    # in its own session (start_new_session=True, so we can kill its group
    # by pgid), which also detaches it from terminal/service signals — a
    # wedged child would otherwise be orphaned holding the device forever.
    def _on_signal(signum, frame):
        record("supervisor_signal", signum=signum)
        raise SystemExit(128 + signum)

    old_handlers = {}
    try:  # signal.signal only works from the main thread (fine in tests too)
        for s in (signal.SIGTERM, signal.SIGINT):
            old_handlers[s] = signal.signal(s, _on_signal)
    except ValueError:
        pass
    try:
        steady_re = re.compile(cfg.steady_pattern) if cfg.steady_pattern else None
        while True:
            record("start", cmd=cfg.cmd, restarts=len(restart_times))
            child = _ChildMonitor(cfg.cmd, log_file, steady_re)
            while True:
                code = child.poll()
                if code is not None:
                    record("exit", code=code)
                    if code == 0:
                        return SupervisorResult(0, len(restart_times), stalls, events)
                    exit_code = code
                    break
                if child.saw_output:
                    idle, timeout = child.idle_seconds(), cfg.stall_timeout
                else:
                    # startup_grace is a ONE-TIME window measured from process
                    # start: a child that never reaches steady state but emits
                    # sporadic non-matching lines (retry warnings etc.) must
                    # not renew its grace forever.
                    idle = time.monotonic() - child.start_time
                    timeout = cfg.startup_grace
                if idle > timeout:
                    stalls += 1
                    record(
                        "stall",
                        idle_s=round(idle, 1),
                        timeout_s=timeout,
                        steady_seen=child.saw_output,
                    )
                    child.kill(cfg.term_grace)
                    record("killed", code=child.poll())
                    break
                _sleep(min(5.0, cfg.stall_timeout / 10))

            now = time.monotonic()
            restart_times = [t for t in restart_times if now - t < cfg.restart_window]
            if len(restart_times) >= cfg.max_restarts:
                record("giving_up", restarts_in_window=len(restart_times))
                return SupervisorResult(exit_code, len(restart_times), stalls, events)
            restart_times.append(now)
            _sleep(cfg.restart_delay)
    finally:
        if child is not None and child.poll() is None:
            child.kill(cfg.term_grace)
        for s, h in old_handlers.items():
            signal.signal(s, h)
        if journal is not None:
            journal.close()
        if log_file is not None:
            log_file.close()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description=__doc__.split("\n", 1)[0],
        usage="%(prog)s [options] -- CMD [ARG ...]",
    )
    parser.add_argument("--stall-timeout", type=float, default=900.0)
    parser.add_argument("--startup-grace", type=float, default=3600.0)
    parser.add_argument("--max-restarts", type=int, default=8)
    parser.add_argument("--restart-window", type=float, default=6 * 3600.0)
    parser.add_argument("--term-grace", type=float, default=30.0)
    parser.add_argument("--restart-delay", type=float, default=10.0)
    parser.add_argument("--log", dest="log_path", default=None)
    parser.add_argument("--journal", dest="journal_path", default=None)
    parser.add_argument(
        "--steady-pattern", dest="steady_pattern", default=None,
        help="regex; startup_grace applies until a line matches it "
             "(e.g. 'Status:'), instead of until any output line",
    )
    parser.add_argument("cmd", nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)
    cmd = args.cmd
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        parser.error("no command given (expected: ... -- python -m climate2weather_tpu_torch.train ...)")
    cfg = SupervisorConfig(
        cmd=cmd,
        stall_timeout=args.stall_timeout,
        startup_grace=args.startup_grace,
        max_restarts=args.max_restarts,
        restart_window=args.restart_window,
        term_grace=args.term_grace,
        restart_delay=args.restart_delay,
        log_path=args.log_path,
        journal_path=args.journal_path,
        steady_pattern=args.steady_pattern,
    )
    return supervise(cfg).exit_code


if __name__ == "__main__":
    sys.exit(main())
