"""TensorBoard event-file writers.

Reference: visualization/tensorboard/{FileWriter,EventWriter,RecordWriter}.scala
— a FileWriter owns an EventWriter (background thread draining a queue every
`flushMillis`), which frames Event protos as TFRecords with masked CRC32C
(RecordWriter.scala:44-57, netty/Crc32c.java).  Counterpart of
``bigdl_tpu/visualization/writer.py``; the CRC is the port's compiled
``csrc/host/crc32c.cc`` (``utils/crc32c.py``)."""

from __future__ import annotations

import os
import queue
import socket
import struct
import threading
import time

from ..utils.crc32c import masked_crc32c
from . import proto

__all__ = ["RecordWriter", "EventWriter", "FileWriter"]


class RecordWriter:
    """TFRecord framing of serialized Event protos onto an open file."""

    def __init__(self, f):
        self._f = f

    def write(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", masked_crc32c(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", masked_crc32c(payload)))

    def flush(self) -> None:
        self._f.flush()


_file_counter = [0]
_counter_lock = threading.Lock()


class EventWriter:
    """Queue + background flusher thread (EventWriter.scala).  All record
    writes happen under one lock, so `flush()` can drain synchronously
    without racing the background thread."""

    def __init__(self, log_dir: str, flush_secs: float = 2.0):
        os.makedirs(log_dir, exist_ok=True)
        with _counter_lock:
            _file_counter[0] += 1
            uniq = _file_counter[0]
        # pid + per-process counter keep same-second writers from
        # truncating each other
        fname = "events.out.tfevents.%d.%s.%d.%d" % (
            int(time.time()), socket.gethostname(), os.getpid(), uniq)
        self.path = os.path.join(log_dir, fname)
        self._file = open(self.path, "wb")
        self._writer = RecordWriter(self._file)
        self._queue: "queue.Queue[bytes]" = queue.Queue()
        self._flush_secs = flush_secs
        self._write_lock = threading.Lock()
        self._closed = False
        # out-of-band shutdown flag: an in-band queue sentinel could be
        # consumed by a concurrent flush() and leak the thread
        self._stop = threading.Event()
        # version record first, as TF does (EventWriter.scala init)
        self._writer.write(proto.event_bytes(
            time.time(), file_version="brain.Event:2"))
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def add_event(self, event: bytes) -> None:
        self._queue.put(event)

    def _drain(self) -> None:
        """Write everything currently queued, then flush the file."""
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            with self._write_lock:
                if not self._closed:
                    self._writer.write(item)
        with self._write_lock:
            if not self._closed:
                self._writer.flush()

    def _run(self) -> None:
        while not self._stop.wait(self._flush_secs):
            self._drain()
        self._drain()

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=30)
        self._drain()
        with self._write_lock:
            self._closed = True
            self._file.close()

    def flush(self) -> None:
        # synchronous: drain the queue ourselves under the write lock
        self._drain()


class FileWriter:
    """Public writer facade (FileWriter.scala)."""

    def __init__(self, log_dir: str, flush_secs: float = 2.0):
        self.log_dir = log_dir
        self._events = EventWriter(log_dir, flush_secs)

    def add_summary(self, summary: bytes, global_step: int = 0) -> "FileWriter":
        self._events.add_event(
            proto.event_bytes(time.time(), step=global_step, summary=summary))
        return self

    def flush(self) -> None:
        self._events.flush()

    def close(self) -> None:
        self._events.close()
