"""In-process periodic scheduler — the Celery-beat-equivalent capability.

Copy of ``mmdx_tpu/scheduler/cron.py`` whose daily jobs schedule the port's
commands (``scheduler/commands.py``), with one repair at the daylight-saving
fall-back: a wall time in the repeated hour is one occurrence, the first
(``fold=0``), and occurrences are compared as instants, not as wall times.
The JAX module, seen from the repeated hour (``fold=1``), found a second
01:30 that same day and ran the job twice. A wall time that the spring-forward
gap skips runs once, at the first instant after the gap (02:30 -> 03:30 in
the new offset), as in the JAX module.

The reference carries a vestigial Celery/Redis setup (compiled-only
``backend/backend/__pycache__/celery.*.pyc`` + ``api/__pycache__/tasks.*.pyc``
wiring daily feature/training tasks; SURVEY §2.3).  This scheduler provides the
same capability without a broker: named jobs on fixed intervals OR at a daily
wall-clock time, run in a daemon thread, with failure isolation, missed-run
catch-up across restarts, and persisted run history.

    sched = PeriodicScheduler(history_path="~/.cache/mmdx/sched.json")
    sched.add_job("hourly_sync", 3600, sync)                 # fixed interval
    sched.add_daily_job("daily_features", "02:00",           # Celery-beat style
                        run_daily_feature_pipeline)          # wall-clock daily
    sched.start()

Daily jobs replicate Celery-beat semantics: they fire at the given local
HH:MM; if the process was down across a scheduled occurrence, the job runs
once at startup (catch-up) — run history persists in a small JSON file so
this works across restarts.

Run outcomes fire pluggable ``on_failure`` / ``on_success`` notifiers (the
reference's Celery tasks wire ``send_mail`` into the daily pipelines —
bytecode-only ``api/__pycache__/tasks.cpython-311.pyc``; see
``scheduler/notify.py`` for the built-in log/webhook/email notifiers).
"""
from __future__ import annotations

import json
import os
import sys
import threading
import time
import traceback
from dataclasses import dataclass, field
from datetime import datetime, timedelta
from pathlib import Path
from typing import Callable

from mmdx_tpu_torch.scheduler.notify import Notifier, log_notifier, make_event


def _parse_at(at: str) -> tuple[int, int]:
    try:
        hh, mm = at.split(":")
        hh, mm = int(hh), int(mm)
        if not (0 <= hh < 24 and 0 <= mm < 60):
            raise ValueError
    except ValueError:
        raise ValueError(f"at must be 'HH:MM' (24h), got {at!r}") from None
    return hh, mm


def _wall_time(day: datetime, hh: int, mm: int) -> float:
    """Epoch seconds of local HH:MM on ``day``'s date: the first of two
    instants in a repeated hour (``fold=0``), the instant after the gap for
    a skipped one."""
    return day.replace(hour=hh, minute=mm, second=0, microsecond=0,
                       fold=0).timestamp()


def next_occurrence(at: str, now: float) -> float:
    """Epoch seconds of the next local-wall-clock HH:MM strictly after now."""
    hh, mm = _parse_at(at)
    dt = datetime.fromtimestamp(now)
    target = _wall_time(dt, hh, mm)
    if target <= now:
        target = _wall_time(dt + timedelta(days=1), hh, mm)
    return target


def prev_occurrence(at: str, now: float) -> float:
    """Epoch seconds of the latest local-wall-clock HH:MM at or before now."""
    hh, mm = _parse_at(at)
    dt = datetime.fromtimestamp(now)
    target = _wall_time(dt, hh, mm)
    if target > now:
        target = _wall_time(dt - timedelta(days=1), hh, mm)
    return target


class RunHistory:
    """Per-job last-run/outcome records persisted as one JSON file, so daily
    jobs can detect occurrences missed while the process was down."""

    def __init__(self, path: str | Path | None):
        self.path = Path(os.path.expanduser(str(path))) if path else None
        self._data: dict[str, dict] = {}
        if self.path and self.path.exists():
            try:
                self._data = json.loads(self.path.read_text())
            except Exception:  # corrupted history must not block scheduling
                self._data = {}

    def get(self, name: str) -> dict:
        return self._data.get(name, {})

    def record(self, name: str, *, ts: float, status: str) -> None:
        rec = self._data.setdefault(name, {"runs": 0, "failures": 0})
        rec["runs"] += 1
        if status != "ok":
            rec["failures"] += 1
        rec["last_run"] = ts
        rec["last_status"] = status
        self._flush()

    def _flush(self) -> None:
        if not self.path:
            return
        try:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            tmp = self.path.with_suffix(".tmp")
            tmp.write_text(json.dumps(self._data, indent=2))
            os.replace(tmp, self.path)
        except Exception as e:  # read-only FS: history degrades, loop lives
            print(f"[mmdx-scheduler] history write failed: {e}", file=sys.stderr)


@dataclass
class Job:
    name: str
    interval_s: float
    fn: Callable[[], None]
    next_run: float = 0.0
    at: str | None = None  # "HH:MM" daily wall-clock job when set
    runs: int = 0
    failures: int = 0
    last_error: str | None = None
    on_failure: Notifier | None = None  # falls back to the scheduler's
    on_success: Notifier | None = None


@dataclass
class PeriodicScheduler:
    jobs: dict[str, Job] = field(default_factory=dict)
    poll_s: float = 1.0
    on_failure: Notifier = log_notifier
    on_success: Notifier | None = None  # default: successes are quiet
    history_path: str | Path | None = None  # persists run records across restarts
    _stop: threading.Event = field(default_factory=threading.Event)
    _thread: threading.Thread | None = None
    _history: RunHistory | None = None

    @property
    def history(self) -> RunHistory:
        if self._history is None:
            self._history = RunHistory(self.history_path)
        return self._history

    def add_job(self, name: str, interval_s: float, fn: Callable[[], None],
                run_immediately: bool = False,
                on_failure: Notifier | None = None,
                on_success: Notifier | None = None) -> Job:
        job = Job(name=name, interval_s=interval_s, fn=fn,
                  next_run=time.time() if run_immediately else time.time() + interval_s,
                  on_failure=on_failure, on_success=on_success)
        self.jobs[name] = job
        return job

    def add_daily_job(self, name: str, at: str, fn: Callable[[], None],
                      catch_up: bool = True,
                      on_failure: Notifier | None = None,
                      on_success: Notifier | None = None,
                      now: float | None = None) -> Job:
        """Celery-beat-style daily job at local wall-clock ``at`` ("HH:MM").

        ``catch_up=True``: if the persisted history shows the last completed
        run predates the most recent scheduled occurrence (the process was
        down over the window), the job fires at the next tick instead of
        waiting up to 24h for the next occurrence.
        """
        now = time.time() if now is None else now
        nxt = next_occurrence(at, now)
        if catch_up:
            last = self.history.get(name).get("last_run")
            if last is not None and last < prev_occurrence(at, now):
                nxt = now  # missed at least one occurrence while down
        job = Job(name=name, interval_s=24 * 3600.0, fn=fn, next_run=nxt,
                  at=at, on_failure=on_failure, on_success=on_success)
        self.jobs[name] = job
        return job

    def _notify(self, hook: Notifier | None, job: Job, status: str) -> None:
        if hook is None:
            return
        try:
            hook(make_event(job.name, status, runs=job.runs,
                            failures=job.failures, error=job.last_error))
        except Exception as e:  # a dead mail relay must not kill the loop
            print(f"[mmdx-scheduler] notifier for {job.name} failed: {e}",
                  file=sys.stderr)

    def _tick(self, now: float | None = None) -> list[str]:
        """Run all due jobs once; returns the names that ran (tests call this
        directly for determinism)."""
        now = now if now is not None else time.time()
        ran = []
        for job in list(self.jobs.values()):
            if now >= job.next_run:
                # wall-clock jobs re-anchor to the next HH:MM occurrence
                # (no drift); interval jobs advance by their period
                job.next_run = (next_occurrence(job.at, now) if job.at
                                else now + job.interval_s)
                job.runs += 1
                status = "ok"
                try:
                    job.fn()
                    job.last_error = None
                    self._notify(job.on_success or self.on_success, job, "ok")
                except Exception as e:  # failure isolation: job errors don't kill the loop
                    status = "failed"
                    job.failures += 1
                    job.last_error = f"{e}\n{traceback.format_exc()}"
                    self._notify(job.on_failure or self.on_failure, job, "failed")
                self.history.record(job.name, ts=now, status=status)
                ran.append(job.name)
        return ran

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                self._tick()
                self._stop.wait(self.poll_s)

        self._thread = threading.Thread(target=loop, daemon=True, name="mmdx-scheduler")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


def default_daily_schedule() -> PeriodicScheduler:
    """Daily feature + training pipelines (the reference's Celery-beat intent):
    wall-clock daily jobs with missed-run catch-up. Env knobs:
    MMDX_SCHED_FEATURE_AT / MMDX_SCHED_TRAIN_AT ("HH:MM", default 02:00 /
    03:00), MMDX_SCHED_HISTORY (history JSON path)."""
    from mmdx_tpu_torch.scheduler.commands import (
        run_daily_feature_pipeline,
        run_daily_training_pipeline,
    )

    sched = PeriodicScheduler(history_path=os.environ.get(
        "MMDX_SCHED_HISTORY",
        os.path.join(os.path.expanduser("~"), ".cache", "mmdx_tpu",
                     "scheduler_history.json")))
    sched.add_daily_job("daily_feature_pipeline",
                        os.environ.get("MMDX_SCHED_FEATURE_AT", "02:00"),
                        run_daily_feature_pipeline)
    sched.add_daily_job("daily_training_pipeline",
                        os.environ.get("MMDX_SCHED_TRAIN_AT", "03:00"),
                        run_daily_training_pipeline)
    return sched
