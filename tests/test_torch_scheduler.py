"""The port's scheduler (``scheduler/cron.py``, ``notify.py``,
``commands.py``) on the CPU.

* the JAX package's wall-clock cases (``tests/test_scheduler_wallclock.py``)
  and notifier cases (``tests/test_scheduler_notify.py``) on the port's
  copies, all through ``_tick(now=...)`` with simulated clocks;
* the daylight-saving repair, under ``TZ=America/New_York``: from 01:10 EST
  on 2026-11-01 (the repeated hour) a 01:30 job's next occurrence is the next
  day's and its previous one that morning's 01:30 EDT; a spring-forward
  02:30 runs once, at 03:30 EDT; a sweep of ``_tick`` over two days with a
  restart inside the repeated hour runs the job twice, where the JAX module
  runs it three times;
* the commands through ``main``: ``--cpu`` prepares the data, runs the
  feature pipeline and trains and publishes a small bundle (to
  ``MMDX_BUNDLE_PATH`` and the registry); without a card a command raises;
  a command that raises notifies and re-raises.

Each test is held to 120 s by an alarm, and a watchdog ends a worker
blocked past 180 s.
"""
import dataclasses
import faulthandler
import http.server
import json
import os
import signal
import threading
import time
from datetime import datetime, timedelta

import pytest
import torch

from mmdx_tpu_torch.scheduler import commands, cron, notify
from mmdx_tpu_torch.scheduler.cron import (PeriodicScheduler, RunHistory,
                                           next_occurrence, prev_occurrence)
from mmdx_tpu_torch.scheduler.notify import (make_email_notifier, make_webhook_notifier,
                                             notifier_from_env)


@pytest.fixture(autouse=True)
def time_guard():
    def expire(signum, frame):
        raise TimeoutError("test exceeded its 120 s guard")

    previous = signal.signal(signal.SIGALRM, expire)
    signal.alarm(120)
    faulthandler.dump_traceback_later(180, exit=True)
    yield
    faulthandler.cancel_dump_traceback_later()
    signal.alarm(0)
    signal.signal(signal.SIGALRM, previous)


def ts(day_offset=0, hour=0, minute=0):
    base = datetime(2026, 3, 10) + timedelta(days=day_offset)
    return base.replace(hour=hour, minute=minute).timestamp()


# ---------------------------------------------------------------------------
# wall-clock jobs (tests/test_scheduler_wallclock.py)
# ---------------------------------------------------------------------------
def test_occurrence_math():
    assert next_occurrence("02:00", ts(hour=1)) == ts(hour=2)
    assert next_occurrence("02:00", ts(hour=3)) == ts(day_offset=1, hour=2)
    assert next_occurrence("02:00", ts(hour=2)) == ts(day_offset=1, hour=2)
    assert prev_occurrence("02:00", ts(hour=3)) == ts(hour=2)
    assert prev_occurrence("02:00", ts(hour=1)) == ts(day_offset=-1, hour=2)
    with pytest.raises(ValueError, match="HH:MM"):
        next_occurrence("25:00", ts())
    with pytest.raises(ValueError, match="HH:MM"):
        next_occurrence("2am", ts())


def test_daily_job_fires_at_wallclock_and_reanchors():
    runs = []
    sched = PeriodicScheduler()
    sched.add_daily_job("daily", "02:00", lambda: runs.append(1), now=ts(hour=1))
    assert sched._tick(now=ts(hour=1, minute=59)) == []
    assert sched._tick(now=ts(hour=2, minute=0)) == ["daily"]
    assert runs == [1]
    assert sched.jobs["daily"].next_run == ts(day_offset=1, hour=2)
    assert sched._tick(now=ts(hour=2, minute=37)) == []
    assert sched._tick(now=ts(day_offset=1, hour=2, minute=5)) == ["daily"]
    assert sched.jobs["daily"].next_run == ts(day_offset=2, hour=2)


def test_missed_run_catch_up_across_restart(tmp_path):
    hist = tmp_path / "history.json"
    runs = []
    s1 = PeriodicScheduler(history_path=hist)
    s1.add_daily_job("daily", "02:00", lambda: runs.append("p1"), now=ts(hour=1))
    assert s1._tick(now=ts(hour=2)) == ["daily"]
    rec = json.loads(hist.read_text())["daily"]
    assert rec["runs"] == 1 and rec["last_status"] == "ok"
    s2 = PeriodicScheduler(history_path=hist)
    s2.add_daily_job("daily", "02:00", lambda: runs.append("p2"),
                     now=ts(day_offset=2, hour=14))
    assert s2._tick(now=ts(day_offset=2, hour=14)) == ["daily"]
    assert runs == ["p1", "p2"]
    assert s2.jobs["daily"].next_run == ts(day_offset=3, hour=2)
    s3 = PeriodicScheduler(history_path=hist)
    s3.add_daily_job("daily", "02:00", lambda: runs.append("p3"),
                     now=ts(day_offset=2, hour=15))
    assert s3._tick(now=ts(day_offset=2, hour=15)) == []
    assert s3.jobs["daily"].next_run == ts(day_offset=3, hour=2)
    s4 = PeriodicScheduler(history_path=hist)
    s4.add_daily_job("daily", "02:00", lambda: runs.append("p4"), catch_up=False,
                     now=ts(day_offset=9, hour=14))
    assert s4._tick(now=ts(day_offset=9, hour=14)) == []


def test_first_ever_run_does_not_catch_up(tmp_path):
    sched = PeriodicScheduler(history_path=tmp_path / "h.json")
    sched.add_daily_job("daily", "02:00", lambda: None, now=ts(hour=14))
    assert sched._tick(now=ts(hour=14)) == []
    assert sched.jobs["daily"].next_run == ts(day_offset=1, hour=2)


def test_history_records_failures_and_survives_corruption(tmp_path):
    hist = tmp_path / "h.json"
    sched = PeriodicScheduler(history_path=hist)

    def boom():
        raise RuntimeError("pipeline exploded")

    sched.add_daily_job("daily", "02:00", boom, now=ts(hour=1))
    assert sched._tick(now=ts(hour=2)) == ["daily"]
    rec = json.loads(hist.read_text())["daily"]
    assert rec["failures"] == 1 and rec["last_status"] == "failed"
    s2 = PeriodicScheduler(history_path=hist)
    s2.add_daily_job("daily", "02:00", boom, now=ts(hour=5))
    assert s2.jobs["daily"].next_run == ts(day_offset=1, hour=2)
    hist.write_text("{not json")
    assert RunHistory(hist).get("daily") == {}


def test_interval_jobs_unchanged(tmp_path):
    sched = PeriodicScheduler(history_path=tmp_path / "h.json")
    runs = []
    j = sched.add_job("hourly", 3600, lambda: runs.append(1))
    j.next_run = ts(hour=1)
    assert sched._tick(now=ts(hour=1)) == ["hourly"]
    assert j.next_run == ts(hour=2)
    assert json.loads((tmp_path / "h.json").read_text())["hourly"]["runs"] == 1


def test_default_daily_schedule_runs_the_ports_commands(tmp_path, monkeypatch):
    monkeypatch.setenv("MMDX_SCHED_HISTORY", str(tmp_path / "h.json"))
    monkeypatch.setenv("MMDX_SCHED_TRAIN_AT", "04:15")
    sched = cron.default_daily_schedule()
    assert sched.jobs["daily_feature_pipeline"].fn is commands.run_daily_feature_pipeline
    assert sched.jobs["daily_training_pipeline"].fn is commands.run_daily_training_pipeline
    assert sched.jobs["daily_training_pipeline"].at == "04:15"


# ---------------------------------------------------------------------------
# daylight saving (America/New_York: back 2026-11-01 02:00 EDT, forward
# 2026-03-08 02:00 EST)
# ---------------------------------------------------------------------------
@pytest.fixture
def new_york():
    saved = os.environ.get("TZ")
    os.environ["TZ"] = "America/New_York"
    time.tzset()
    yield
    if saved is None:
        os.environ.pop("TZ")
    else:
        os.environ["TZ"] = saved
    time.tzset()


def local(y, mo, d, h, mi, fold=0) -> float:
    return datetime(y, mo, d, h, mi, fold=fold).timestamp()


def test_fall_back_repeated_hour_is_one_occurrence(new_york):
    est_0110 = local(2026, 11, 1, 1, 10, fold=1)
    assert time.strftime("%H:%M %Z", time.localtime(est_0110)) == "01:10 EST"
    edt_0130 = local(2026, 11, 1, 1, 30)
    assert time.strftime("%H:%M %Z", time.localtime(edt_0130)) == "01:30 EDT"
    assert next_occurrence("01:30", est_0110) == local(2026, 11, 2, 1, 30)
    assert prev_occurrence("01:30", est_0110) == edt_0130
    # from just before the first 01:30, the first one
    assert next_occurrence("01:30", local(2026, 11, 1, 1, 10)) == edt_0130


def test_spring_forward_gap_runs_once_after_it(new_york):
    at = next_occurrence("02:30", local(2026, 3, 8, 1, 0))
    assert time.strftime("%Y-%m-%d %H:%M %Z", time.localtime(at)) == "2026-03-08 03:30 EDT"
    assert next_occurrence("02:30", at) == local(2026, 3, 9, 2, 30)
    assert prev_occurrence("02:30", at) == at
    assert prev_occurrence("02:30", at - 60) == local(2026, 3, 7, 2, 30)


def sweep(module, history) -> list[str]:
    """Tick a 01:30 daily job every minute from 2026-10-31 12:00 to
    2026-11-02 12:00, restarting the process (a new scheduler on the same
    history) at 01:10 EST, inside the repeated hour. -> the runs' times."""
    runs = []
    start, restart = local(2026, 10, 31, 12, 0), local(2026, 11, 1, 1, 10, fold=1)
    end = local(2026, 11, 2, 12, 0)

    def job():
        runs.append(time.strftime("%m-%d %H:%M %Z", time.localtime(now)))

    sched = module.PeriodicScheduler(history_path=history)
    sched.add_daily_job("daily", "01:30", job, now=start)
    now, restarted = start, False
    while now <= end:
        if not restarted and now >= restart:
            sched = module.PeriodicScheduler(history_path=history)
            sched.add_daily_job("daily", "01:30", job, now=now)
            restarted = True
        sched._tick(now=now)
        now += 60
    return runs


def test_fall_back_sweep_runs_twice_not_three_times(new_york, tmp_path):
    from mmdx_tpu.scheduler import cron as jax_cron

    assert sweep(cron, tmp_path / "port.json") == ["11-01 01:30 EDT", "11-02 01:30 EST"]
    # the JAX module ran the job again at 01:30 EST, twenty minutes after
    # the restart
    assert sweep(jax_cron, tmp_path / "jax.json") == [
        "11-01 01:30 EDT", "11-01 01:30 EST", "11-02 01:30 EST"]


# ---------------------------------------------------------------------------
# notifiers (tests/test_scheduler_notify.py)
# ---------------------------------------------------------------------------
def test_on_failure_hook_fires_with_event():
    events = []
    sched = PeriodicScheduler(on_failure=events.append)

    def boom():
        raise RuntimeError("pipeline exploded")

    sched.add_job("daily_training", 10, boom, run_immediately=True)
    assert sched._tick() == ["daily_training"]
    assert len(events) == 1
    ev = events[0]
    assert ev["job"] == "daily_training" and ev["status"] == "failed"
    assert ev["failures"] == 1 and "pipeline exploded" in ev["error"]


def test_on_success_hook_and_per_job_override():
    sched_events, job_events = [], []
    sched = PeriodicScheduler(on_failure=sched_events.append,
                              on_success=sched_events.append)
    sched.add_job("a", 10, lambda: None, run_immediately=True)
    sched.add_job("b", 10, lambda: None, run_immediately=True,
                  on_success=job_events.append)
    sched._tick()
    assert [e["job"] for e in sched_events] == ["a"]
    assert [e["job"] for e in job_events] == ["b"]
    assert all(e["status"] == "ok" for e in sched_events + job_events)


def test_notifier_error_does_not_kill_the_loop_or_the_count(capsys):
    def bad_notifier(event):
        raise ConnectionError("mail relay down")

    sched = PeriodicScheduler(on_failure=bad_notifier)
    sched.add_job("j", 10, lambda: 1 / 0, run_immediately=True)
    sched.add_job("k", 10, lambda: None, run_immediately=True)
    assert set(sched._tick()) == {"j", "k"}
    assert sched.jobs["j"].failures == 1
    assert "notifier for j failed" in capsys.readouterr().err


class _Recorder(http.server.BaseHTTPRequestHandler):
    received: list = []

    def do_POST(self):
        body = self.rfile.read(int(self.headers["Content-Length"]))
        type(self).received.append(json.loads(body))
        self.send_response(200)
        self.end_headers()
        self.wfile.write(b"ok")

    def log_message(self, *a):
        pass


@pytest.fixture()
def webhook_server():
    _Recorder.received = []
    srv = http.server.HTTPServer(("127.0.0.1", 0), _Recorder)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_port}/hook"
    srv.shutdown()
    srv.server_close()


def test_webhook_notifier_posts_event_json(webhook_server):
    sched = PeriodicScheduler(on_failure=make_webhook_notifier(webhook_server))
    sched.add_job("daily_features", 10, lambda: 1 / 0, run_immediately=True)
    sched._tick()
    assert len(_Recorder.received) == 1
    ev = _Recorder.received[0]
    assert ev["job"] == "daily_features" and ev["status"] == "failed"
    assert "ZeroDivisionError" in ev["error"]


def test_email_notifier_builds_send_mail_equivalent():
    sent = []

    class FakeSMTP:
        def __init__(self, host, port, timeout=None):
            sent.append(("connect", host, port))

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

        def send_message(self, msg):
            sent.append(("send", msg["Subject"], msg["To"]))

    notify_ = make_email_notifier("smtp.local", 25, "mmdx@local", ["oncall@local"],
                                  smtp_factory=FakeSMTP)
    sched = PeriodicScheduler(on_failure=notify_)
    sched.add_job("daily_training", 10, lambda: 1 / 0, run_immediately=True)
    sched._tick()
    assert ("connect", "smtp.local", 25) in sent
    assert ("send", "[mmdx] daily_training: failed", "oncall@local") in sent


def test_notifier_from_env_composes(webhook_server, capsys):
    notifier_from_env({"MMDX_NOTIFY_WEBHOOK": webhook_server})(
        {"job": "j", "status": "failed", "error": "x", "runs": 1, "failures": 1,
         "time": "t"})
    assert len(_Recorder.received) == 1
    assert "[mmdx notify] j: failed" in capsys.readouterr().err
    notifier_from_env({})({"job": "j", "status": "ok", "error": None, "runs": 1,
                           "failures": 0, "time": "t"})
    notifier_from_env({"MMDX_NOTIFY_EMAIL": "no-port-here"})
    assert "bad MMDX_NOTIFY_EMAIL" in capsys.readouterr().err


def test_command_runner_notifies_on_failure(webhook_server, monkeypatch):
    monkeypatch.setenv("MMDX_NOTIFY_WEBHOOK", webhook_server)
    with pytest.raises(ValueError):
        commands._run("run_daily_training_pipeline",
                      lambda: (_ for _ in ()).throw(ValueError("bad features")))
    assert len(_Recorder.received) == 1
    ev = _Recorder.received[0]
    assert ev["job"] == "run_daily_training_pipeline"
    assert ev["status"] == "failed" and "bad features" in ev["error"]


# ---------------------------------------------------------------------------
# the commands through main
# ---------------------------------------------------------------------------
@pytest.fixture
def world(tmp_path, monkeypatch):
    """A data root, registry and local bundle path under tmp_path, and a
    local function notifier in place of the environment's."""
    events = []
    monkeypatch.setenv("MMDX_DATA_ROOT", str(tmp_path / "data"))
    monkeypatch.delenv("MMDX_REGISTRY_ROOT", raising=False)
    monkeypatch.setenv("MMDX_BUNDLE_PATH", str(tmp_path / "local" / "model_bundle.mmdx"))
    monkeypatch.setattr(notify, "notifier_from_env", lambda: events.append)
    return tmp_path, events


def test_commands_prepare_features_and_train_on_the_cpu(world, monkeypatch, capsys):
    """The daily jobs in order, through ``main(["--cpu", ...])``, with the
    training run on a small bundle (short reports) instead of the full
    widths; the registry then holds version 1 and the bundle is also at
    MMDX_BUNDLE_PATH."""
    from mmdx_tpu_torch.checkpoints.bundle import new_random_bundle, load_bundle
    from mmdx_tpu_torch.checkpoints.registry import LocalModelRegistry
    from mmdx_tpu_torch.pipelines import training_pipeline as tp

    tmp_path, events = world

    def small(seed=0):
        b = new_random_bundle(seed=seed, small=True)
        gen = dataclasses.replace(b.config.generation, max_new_tokens=8, min_new_tokens=2)
        b.config = dataclasses.replace(b.config, generation=gen)
        return b

    monkeypatch.setattr(tp, "new_random_bundle", small)
    monkeypatch.setenv("MMDX_PREP_EXAMPLES", "12")
    monkeypatch.setenv("MMDX_FUSION_STEPS", "2")
    for name in ("prepare_raw_data", "run_daily_feature_pipeline",
                 "run_daily_training_pipeline"):
        assert commands.main(["--cpu", name]) == 0
        assert f"{name} completed successfully." in capsys.readouterr().out
    registry = LocalModelRegistry(tmp_path / "data" / "registry")
    assert registry.versions("fusion_model_T5") == [1]
    local_bundle = load_bundle(tmp_path / "local" / "model_bundle.mmdx")
    assert local_bundle.version == 1 and local_bundle.config.fusion.d_img == 64
    assert events == []


def test_commands_need_a_card_unless_asked_for_the_cpu(world, monkeypatch):
    _, events = world
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in commands.COMMANDS.values():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        commands.main(["prepare_raw_data"])
    assert [(e["job"], e["status"]) for e in events] == [("prepare_raw_data", "failed")]
    assert commands.main(["--cpu"]) == 2 and commands.main(["no_such_command"]) == 2


def test_a_command_that_raises_notifies_and_reraises(world):
    """The feature pipeline on an empty data root has no raw data."""
    _, events = world
    with pytest.raises(Exception):
        commands.main(["--cpu", "run_daily_feature_pipeline"])
    assert len(events) == 1
    assert events[0]["job"] == "run_daily_feature_pipeline"
    assert events[0]["status"] == "failed" and events[0]["error"]
