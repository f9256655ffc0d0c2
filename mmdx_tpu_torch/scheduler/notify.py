"""Pipeline run notifications — the reference's Celery ``send_mail`` capability.

Copy of ``mmdx_tpu/scheduler/notify.py``.

The reference's vestigial Celery tasks wire Django's ``send_mail`` into the
daily feature/training pipeline tasks (compiled-only
``backend/api/__pycache__/tasks.cpython-311.pyc``, names: ``shared_task``,
``send_mail``, importing both pipeline entry functions; SURVEY §2.3).  This
module provides the same capability for our scheduler + commands: pluggable
notifiers invoked on job success/failure.

A notifier is any ``Callable[[dict], None]``; the event dict carries
``{"job", "status": "ok"|"failed", "runs", "failures", "error", "time"}``.
Notifier errors are swallowed by the callers (a dead mail relay must not take
the scheduler loop down with it).

Built-ins:
  * :func:`log_notifier` — stderr line (default everywhere).
  * :func:`make_webhook_notifier` — POST the event as JSON (Slack/PagerDuty
    style endpoints).
  * :func:`make_email_notifier` — smtplib equivalent of the reference's
    ``send_mail``.
  * :func:`notifier_from_env` — compose from ``MMDX_NOTIFY_WEBHOOK`` /
    ``MMDX_NOTIFY_EMAIL`` (comma ``host:port:from:to`` spec), falling back to
    the log notifier.
"""
from __future__ import annotations

import json
import os
import sys
import time
from typing import Callable

Notifier = Callable[[dict], None]


def make_event(job: str, status: str, *, runs: int = 0, failures: int = 0,
               error: str | None = None) -> dict:
    return {
        "job": job,
        "status": status,
        "runs": runs,
        "failures": failures,
        "error": error,
        "time": time.strftime("%Y-%m-%dT%H:%M:%S"),
    }


def log_notifier(event: dict) -> None:
    line = f"[mmdx notify] {event['job']}: {event['status']}"
    if event.get("error"):
        first = str(event["error"]).splitlines()[0]
        line += f" ({first})"
    print(line, file=sys.stderr)


def make_webhook_notifier(url: str, timeout_s: float = 10.0) -> Notifier:
    """POST the event JSON to ``url`` (the modern shape of 'send an alert')."""
    import urllib.request

    def notify(event: dict) -> None:
        req = urllib.request.Request(
            url, data=json.dumps(event).encode(),
            headers={"Content-Type": "application/json"}, method="POST",
        )
        urllib.request.urlopen(req, timeout=timeout_s).read()

    return notify


def make_email_notifier(host: str, port: int, sender: str,
                        recipients: list[str], timeout_s: float = 10.0,
                        smtp_factory=None) -> Notifier:
    """smtplib counterpart of the reference's Django ``send_mail`` wiring.

    ``smtp_factory`` is injectable for tests (defaults to ``smtplib.SMTP``).
    """

    def notify(event: dict) -> None:
        import smtplib
        from email.message import EmailMessage

        msg = EmailMessage()
        msg["Subject"] = f"[mmdx] {event['job']}: {event['status']}"
        msg["From"] = sender
        msg["To"] = ", ".join(recipients)
        msg.set_content(json.dumps(event, indent=2))
        factory = smtp_factory or smtplib.SMTP
        with factory(host, port, timeout=timeout_s) as smtp:
            smtp.send_message(msg)

    return notify


def notifier_from_env(env=os.environ) -> Notifier:
    """Compose notifiers from env knobs; always at least the log line.

    ``MMDX_NOTIFY_WEBHOOK=https://...`` adds a webhook POST;
    ``MMDX_NOTIFY_EMAIL=host:port:from:to[,to2...]`` adds an email.
    """
    notifiers: list[Notifier] = [log_notifier]
    url = env.get("MMDX_NOTIFY_WEBHOOK")
    if url:
        notifiers.append(make_webhook_notifier(url))
    spec = env.get("MMDX_NOTIFY_EMAIL")
    if spec:
        try:
            host, port, sender, rcpt = spec.split(":", 3)
            notifiers.append(
                make_email_notifier(host, int(port), sender, rcpt.split(",")))
        except ValueError:
            print(f"[mmdx notify] bad MMDX_NOTIFY_EMAIL spec: {spec!r} "
                  "(want host:port:from:to[,to...])", file=sys.stderr)

    def combined(event: dict) -> None:
        for n in notifiers:
            n(event)

    return combined
