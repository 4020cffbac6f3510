"""Structured logging: DYN_LOG level filter, JSONL output, request-id spans.

- :func:`init_logging` configures the root logger from ``DYN_LOG``
  (level, e.g. ``debug`` or ``dynamo_tpu_torch.engine=debug,info``) and
  ``DYN_LOGGING_JSONL`` ("1"/"stderr" => JSON lines on stderr, any other
  value => append to that file path).
- :data:`request_id_var` is a contextvar carried across the async call
  chain; the data plane sets it server-side from the wire ``context_id`` and
  the HTTP frontend sets it at ingress, so one request's log lines share an
  id across frontend -> router -> worker processes.

Reference capability: lib/runtime/src/logging.rs:94-138 (DYN_LOG env filter +
JSONL event formatter) and the request_id span fields the preprocessor
attaches (lib/llm/src/preprocessor.rs:198-233).
"""

from __future__ import annotations

import contextvars
import json
import logging
import os
import sys
import time
from typing import Optional

request_id_var: contextvars.ContextVar[Optional[str]] = \
    contextvars.ContextVar("dynamo_request_id", default=None)


class RequestIdFilter(logging.Filter):
    """Attaches the current request id to every record (as ``request_id``)."""

    def filter(self, record: logging.LogRecord) -> bool:
        record.request_id = request_id_var.get()
        return True


class JsonlFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        out = {
            "ts": round(record.created, 6),
            "level": record.levelname,
            "target": record.name,
            "message": record.getMessage(),
        }
        rid = getattr(record, "request_id", None)
        if rid:
            out["request_id"] = rid
        if record.exc_info and record.exc_info[0] is not None:
            out["exception"] = self.formatException(record.exc_info)
        return json.dumps(out)


def _parse_dyn_log(spec: str):
    """``info`` or ``some.module=debug,warning`` -> (root level, overrides)."""
    root = None
    overrides = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" in part:
            mod, lvl = part.split("=", 1)
            overrides[mod.strip()] = lvl.strip().upper()
        else:
            root = part.upper()
    return root or "INFO", overrides


def init_logging(stream=None) -> None:
    """Configure logging from DYN_LOG / DYN_LOGGING_JSONL. Idempotent."""
    root_level, overrides = _parse_dyn_log(os.environ.get("DYN_LOG", "info"))
    jsonl = os.environ.get("DYN_LOGGING_JSONL", "")

    root = logging.getLogger()
    for h in list(root.handlers):
        if getattr(h, "_dynamo_tpu", False):
            root.removeHandler(h)

    if jsonl and jsonl not in ("0", "false"):
        if jsonl in ("1", "true", "stderr"):
            handler = logging.StreamHandler(stream or sys.stderr)
        else:
            handler = logging.FileHandler(jsonl)
        handler.setFormatter(JsonlFormatter())
    else:
        handler = logging.StreamHandler(stream or sys.stderr)
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s %(name)s%(request_tag)s %(message)s"))

        class _TagFilter(logging.Filter):
            def filter(self, record):
                # read the contextvar directly: filters run in insertion
                # order, so relying on RequestIdFilter having run would
                # silently drop the id in plain-text mode
                rid = request_id_var.get()
                record.request_tag = f" [{rid}]" if rid else ""
                return True

        handler.addFilter(_TagFilter())
    handler.addFilter(RequestIdFilter())
    handler._dynamo_tpu = True  # type: ignore[attr-defined]
    root.addHandler(handler)
    root.setLevel(root_level)
    for mod, lvl in overrides.items():
        logging.getLogger(mod).setLevel(lvl)
