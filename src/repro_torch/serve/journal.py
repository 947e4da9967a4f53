"""Write-ahead serving journal: exactly-once results across crashes.

One JSONL file, appended synchronously (``fsync`` per record) by the
serving scheduler:

* ``{"t": "admit", "rid", "prompt", "max_new", "deadline"}`` — a request
  entered a decode slot.  Written *before* any compute for that request.
* ``{"t": "shed", "rid", "detail", "retry_after"}`` — the admission
  controller rejected the request (overload).  Written *before* the
  structured ``RequestError("overloaded")`` verdict is delivered, so a
  crash between shedding and delivery re-delivers the verdict on restart
  instead of silently re-admitting a request the client was already told
  to back off from.
* ``{"t": "tok", "rid", "tok"}`` — one emitted token.  Written as each
  token is appended to the slot, so the journal always knows the request's
  last position.
* ``{"t": "retire", "rid", "toks"}`` (success) or
  ``{"t": "retire", "rid", "status", "detail"}`` (structured error) —
  the request's final result.  Written *before* the result transaction is
  emitted to the collector (write-ahead), so a crash between journaling
  and delivery re-delivers from the journal on restart.

Replay folds the log into two maps:

* ``completed``: rid -> token list (or ``(status, detail)``) — requests
  whose result is durable.  Shed records fold to
  ``("overloaded", detail)`` here: a shed verdict is a final answer.  A re-submitted completed rid is answered
  straight from the journal, never recomputed: with the rid-keyed result
  store this is exactly-once delivery (a crash after retire-journal but
  before delivery re-emits the identical result; a duplicate submission
  reproduces it byte-for-byte).
* ``inflight``: rid -> {prompt, max_new, deadline, toks} — admitted but
  not retired.  The restarted scheduler re-admits these at their last
  journaled position: it re-prefills over ``prompt + toks`` and continues
  decoding, which for greedy (argmax) decoding of a causal model produces
  exactly the continuation the crashed process would have produced.

A record torn by the crash itself (partial last line) is dropped at
replay — every *complete* record was fsync'd before the corresponding
effect was externally visible, so dropping the torn tail loses nothing
that was promised.
"""

from __future__ import annotations

import json
import os
import threading
from pathlib import Path
from typing import Optional


class ServeJournal:
    """Append-only request journal; replays existing content at open."""

    def __init__(self, path):
        self.path = Path(path)
        self.completed, self.inflight = self.replay(self.path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._truncate_torn_tail()
        self._f = open(self.path, "a", encoding="utf-8")
        # under the thread engine the frontend (shed records) and the
        # scheduler (admit/tok/retire) append concurrently
        self._lock = threading.Lock()

    def _truncate_torn_tail(self) -> None:
        """Cut the file back to its last complete record before appending.

        A crash mid-append leaves a partial line at the tail; appending
        after it would concatenate the next record onto the fragment,
        making one unreadable line in the *middle* of the file — which
        replay (correctly) refuses to read past.  The torn record never
        had external effects, so dropping it is safe."""
        if not self.path.exists():
            return
        data = self.path.read_bytes()
        good = 0
        for line in data.splitlines(keepends=True):
            if not line.endswith(b"\n"):
                break
            try:
                json.loads(line)
            except ValueError:
                break
            good += len(line)
        if good < len(data):
            with open(self.path, "r+b") as f:
                f.truncate(good)

    # -- append (write-ahead: callers journal BEFORE acting) ---------------

    def _append(self, rec: dict) -> None:
        with self._lock:
            self._f.write(json.dumps(rec, separators=(",", ":")) + "\n")
            self._f.flush()
            os.fsync(self._f.fileno())

    def admit(self, rid: int, prompt: list, max_new: int,
              deadline: Optional[float]) -> None:
        self._append({"t": "admit", "rid": int(rid),
                      "prompt": [int(t) for t in prompt],
                      "max_new": int(max_new), "deadline": deadline})

    def shed(self, rid: int, detail: str = "",
             retry_after: float = 0.0) -> None:
        """Durable overload verdict (write-ahead, before delivery)."""
        self._append({"t": "shed", "rid": int(rid), "detail": detail,
                      "retry_after": retry_after})
        self.completed[int(rid)] = ("overloaded", detail)

    def tok(self, rid: int, tok: int) -> None:
        self._append({"t": "tok", "rid": int(rid), "tok": int(tok)})

    def retire(self, rid: int, toks: Optional[list] = None,
               status: Optional[str] = None, detail: str = "") -> None:
        rec: dict = {"t": "retire", "rid": int(rid)}
        if toks is not None:
            rec["toks"] = [int(t) for t in toks]
        else:
            rec["status"] = status or "error"
            rec["detail"] = detail
        self._append(rec)

    def close(self) -> None:
        self._f.close()

    # -- replay ------------------------------------------------------------

    @staticmethod
    def replay(path) -> tuple[dict, dict]:
        """Fold a journal file into ``(completed, inflight)`` maps.

        Stops at the first undecodable line — only the crash-torn tail
        record can be malformed, and it never had external effects.
        """
        completed: dict = {}
        inflight: dict = {}
        path = Path(path)
        if not path.exists():
            return completed, inflight
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    break                     # torn tail record
                t, rid = rec.get("t"), rec.get("rid")
                if t == "admit":
                    inflight[rid] = {"prompt": rec.get("prompt", []),
                                     "max_new": rec.get("max_new", 0),
                                     "deadline": rec.get("deadline"),
                                     "toks": []}
                elif t == "tok":
                    if rid in inflight:
                        inflight[rid]["toks"].append(rec["tok"])
                elif t == "shed":
                    inflight.pop(rid, None)
                    completed[rid] = ("overloaded", rec.get("detail", ""))
                elif t == "retire":
                    inflight.pop(rid, None)
                    if "toks" in rec:
                        completed[rid] = list(rec["toks"])
                    else:
                        completed[rid] = (rec.get("status", "error"),
                                          rec.get("detail", ""))
        return completed, inflight
