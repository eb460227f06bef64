"""SMTP+TLS notifier (reference email_client.py:1-23; the port's own copy of
the JAX package's utils/email_client.py)."""

from __future__ import annotations

import os
import smtplib
from email.mime.text import MIMEText


def send_email(subject: str, body: str, receivers: list[str] | None = None,
               host: str | None = None, port: int | None = None,
               username: str | None = None, password: str | None = None) -> bool:
    host = host or os.environ.get("EMAIL_HOST")
    username = username or os.environ.get("EMAIL_USERNAME")
    password = password or os.environ.get("EMAIL_PASSWORD")
    port = port or int(os.environ.get("EMAIL_PORT", 587))
    receivers = receivers or ([username] if username else [])
    if not (host and username and password and receivers):
        return False
    msg = MIMEText(body)
    msg["Subject"] = subject
    msg["From"] = username
    msg["To"] = ", ".join(receivers)
    with smtplib.SMTP(host, port) as server:
        server.starttls()
        server.login(username, password)
        server.sendmail(username, receivers, msg.as_string())
    return True
