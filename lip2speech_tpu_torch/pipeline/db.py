"""SQLite usage DB + migrations (the port's own copy of the JAX package's
pipeline/db.py).

Rebuild of reference db.py:1-22 and migrations.py:1-124 (tables: audio,
usage, asr_transcription, model, vsg_service_usage).
"""

from __future__ import annotations

import sqlite3
import time
import uuid
from contextlib import contextmanager
from pathlib import Path

MIGRATIONS = [
    """CREATE TABLE IF NOT EXISTS audio (
        id TEXT PRIMARY KEY,
        name TEXT,
        created_at REAL
    )""",
    """CREATE TABLE IF NOT EXISTS usage (
        id TEXT PRIMARY KEY,
        audio_id TEXT,
        video_duration REAL,
        elapsed_time REAL,
        created_at REAL,
        FOREIGN KEY (audio_id) REFERENCES audio (id)
    )""",
    """CREATE TABLE IF NOT EXISTS asr_transcription (
        id TEXT PRIMARY KEY,
        usage_id TEXT,
        transcription TEXT,
        created_at REAL,
        FOREIGN KEY (usage_id) REFERENCES usage (id)
    )""",
    """CREATE TABLE IF NOT EXISTS model (
        id TEXT PRIMARY KEY,
        name TEXT,
        created_at REAL
    )""",
    """CREATE TABLE IF NOT EXISTS vsg_service_usage (
        id TEXT PRIMARY KEY,
        video_duration REAL,
        email TEXT,
        created_at REAL
    )""",
]


class DB:
    def __init__(self, path: str | Path = "server.db"):
        import threading

        self.path = str(path)
        self._lock = threading.Lock()
        # a ':memory:' database exists per-connection, so keep one shared
        # connection (guarded by the lock) for in-memory use
        self._conn = (sqlite3.connect(self.path, check_same_thread=False)
                      if self.path == ":memory:" else None)
        self.migrate()

    @contextmanager
    def connect(self):
        with self._lock:
            conn = self._conn or sqlite3.connect(self.path)
            try:
                yield conn
                conn.commit()
            finally:
                if conn is not self._conn:
                    conn.close()

    def migrate(self) -> None:
        with self.connect() as conn:
            for stmt in MIGRATIONS:
                conn.execute(stmt)

    def log_usage(self, video_duration: float, elapsed_time: float,
                  audio_name: str | None = None,
                  transcription: str | None = None) -> str:
        usage_id = str(uuid.uuid4())
        now = time.time()
        with self.connect() as conn:
            audio_id = None
            if audio_name is not None:
                audio_id = str(uuid.uuid4())
                conn.execute("INSERT INTO audio VALUES (?, ?, ?)",
                             (audio_id, audio_name, now))
            conn.execute("INSERT INTO usage VALUES (?, ?, ?, ?, ?)",
                         (usage_id, audio_id, video_duration, elapsed_time, now))
            if transcription is not None:
                conn.execute("INSERT INTO asr_transcription VALUES (?, ?, ?, ?)",
                             (str(uuid.uuid4()), usage_id, transcription, now))
        return usage_id

    def log_vsg_usage(self, video_duration: float, email: str | None) -> str:
        vid = str(uuid.uuid4())
        with self.connect() as conn:
            conn.execute("INSERT INTO vsg_service_usage VALUES (?, ?, ?, ?)",
                         (vid, video_duration, email, time.time()))
        return vid

    def usage_count(self) -> int:
        with self.connect() as conn:
            return conn.execute("SELECT COUNT(*) FROM usage").fetchone()[0]
