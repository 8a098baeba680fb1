"""Runtime log shipper — tails per-run log files and POSTs batches to a
log server (a copy of ``fedml_tpu/core/mlops/log_daemon.py``).

Parity target: reference ``core/mlops/mlops_runtime_log_daemon.py`` —
``log_process`` tails the run's log file from a persisted line index,
batches up to ``log_line_chunk_size`` lines, POSTs
``{run_id, edge_id, logs_list}`` to the platform endpoint with bounded
retries (:219 ``log_upload``, :333 the tail loop), and survives file
rotation. This is the same machine over stdlib ``urllib`` with the repo's
local-first defaults: the endpoint is any HTTP sink (``log_server_url``),
and the shipped file is the run's JSONL metric/event log or a run
registry's stdout log.

Rotation-awareness: the tail keeps (inode, offset); when the file is
rotated (inode change) or truncated (size < offset) it reopens from the
start of the new file instead of silently stopping (reference handles
this by re-reading the index each cycle).
"""

from __future__ import annotations

import atexit
import json
import logging
import os
import threading
import time
import urllib.error
import urllib.request
from typing import List, Optional

logger = logging.getLogger(__name__)


class LogShipper:
    """Tail ``path`` and POST line batches to ``url`` until stopped."""

    def __init__(self, path: str, url: str, run_id: str = "0",
                 device_id: str = "0", batch_lines: int = 100,
                 interval_s: float = 1.0, retries: int = 3,
                 timeout_s: float = 5.0):
        self.path = path
        self.url = url
        self.run_id = str(run_id)
        self.device_id = str(device_id)
        self.batch_lines = int(batch_lines)
        self.interval_s = float(interval_s)
        self.retries = int(retries)
        self.timeout_s = float(timeout_s)
        self._seq = 0
        self._offset = 0  # BYTE offset (file is read in binary mode: a
        # text-mode tell() is an opaque cookie that need not equal byte
        # counts on non-UTF-8 logs, which would desync the st_size
        # truncation check)
        self._inode: Optional[int] = None
        self._buf = b""  # partial trailing line across reads (bytes, so
        # a multi-byte char split across reads survives intact)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._flush_lock = threading.Lock()
        self._flushed = False
        self.shipped_lines = 0
        self.failed_batches = 0

    # -- tailing ------------------------------------------------------------

    def _read_new_lines(self) -> List[str]:
        try:
            st = os.stat(self.path)
        except OSError:
            return []
        if self._inode is not None and (st.st_ino != self._inode
                                        or st.st_size < self._offset):
            # rotated or truncated: start over on the new file
            logger.info("log shipper: %s rotated, re-tailing", self.path)
            self._offset = 0
            self._buf = b""
        self._inode = st.st_ino
        if st.st_size <= self._offset:
            return []
        with open(self.path, "rb") as f:
            f.seek(self._offset)
            raw = f.read()
            self._offset = f.tell()
        data = self._buf + raw
        # universal newlines by hand (binary mode): CR-only progress bars
        # (tqdm-style) and CRLF logs must still split into lines — buffering
        # until LF would hoard a \r-only stream forever
        import re as _re
        chunks = _re.split(b"\r\n|\r|\n", data)
        self._buf = chunks.pop()  # incomplete tail (or b"")
        return [ln for ln in
                (c.decode("utf-8", errors="replace") for c in chunks)
                if ln.strip()]

    # -- upload -------------------------------------------------------------

    def _post(self, lines: List[str]) -> bool:
        body = json.dumps({
            "run_id": self.run_id, "device_id": self.device_id,
            "seq": self._seq, "log_lines": lines}).encode()
        req = urllib.request.Request(
            self.url, data=body,
            headers={"Content-Type": "application/json"}, method="POST")
        delay = 0.2
        for attempt in range(self.retries):
            try:
                with urllib.request.urlopen(req,
                                            timeout=self.timeout_s) as r:
                    if 200 <= r.status < 300:
                        self._seq += 1
                        self.shipped_lines += len(lines)
                        return True
            except (urllib.error.URLError, OSError) as e:
                logger.debug("log upload attempt %d failed: %s",
                             attempt + 1, e)
            if self._stop.wait(delay):
                break
            delay *= 2
        self.failed_batches += 1
        return False

    def pump_once(self) -> int:
        """One tail+ship cycle; returns lines shipped. Public so tests (and
        a final flush on stop) can drive it synchronously."""
        shipped = 0
        while True:
            lines = self._read_new_lines()
            if not lines:
                return shipped
            for i in range(0, len(lines), self.batch_lines):
                batch = lines[i:i + self.batch_lines]
                if self._post(batch):
                    shipped += len(batch)
                else:
                    return shipped  # retry same region next cycle? no —
                    # offset already advanced; dropping is the reference's
                    # behavior after its retries are exhausted

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "LogShipper":
        def loop():
            while not self._stop.wait(self.interval_s):
                self.pump_once()
            self._final_flush()

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        # interpreter-exit flush: a short run can finish inside the first
        # poll interval and previously lost its entire tail (daemon
        # threads are killed, not joined, at exit) — the atexit hook
        # ships whatever is still unsent. Unregistered on stop().
        atexit.register(self._atexit_stop)
        return self

    def _atexit_stop(self) -> None:
        self.stop(flush=True, timeout_s=5.0)

    def _final_flush(self) -> None:
        """Ship everything, INCLUDING a trailing line with no newline — a
        crashed job's log usually ends mid-line and that last partial
        traceback line is the most diagnostic one. Runs at most once
        (the loop thread's exit path, ``stop()``, and the atexit hook
        can all race here)."""
        with self._flush_lock:
            if self._flushed:
                return
            self._flushed = True
            self.pump_once()
            tail = self._buf.decode("utf-8", errors="replace")
            if tail.strip():
                if self._post([tail]):
                    self._buf = b""

    def stop(self, flush: bool = True, timeout_s: float = 10.0) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=timeout_s)
            if t.is_alive():
                # the loop thread is stuck mid-POST past our patience: it
                # still owns _buf/_offset and will run its OWN final
                # flush when the socket call returns — flushing from here
                # too would race pump_once over unsynchronized tail state
                logger.warning(
                    "log shipper: loop thread still sending after %.1fs; "
                    "it will flush on its own exit", timeout_s)
                flush = False
        if flush:
            # guaranteed final flush even when the loop thread never ran
            # a cycle (short run) or was never started — _final_flush
            # itself dedups against the loop thread's exit-path flush
            self._final_flush()
        try:
            atexit.unregister(self._atexit_stop)
        except Exception:
            pass


_shippers: List[LogShipper] = []


def start_log_shipper(path: str, url: str, run_id: str = "0",
                      device_id: str = "0", **kw) -> LogShipper:
    """Module-level registry so ``mlops.init`` / the run registry can start
    shippers and tests can flush them."""
    s = LogShipper(path, url, run_id=run_id, device_id=device_id,
                   **kw).start()
    _shippers.append(s)
    return s


def stop_all_shippers() -> None:
    for s in _shippers:
        s.stop()
    _shippers.clear()
