"""LoggerFilter: send the dependencies' log records to a file.

Counterpart of ``bigdl_tpu/utils/logger_filter.py`` (reference
``utils/LoggerFilter.scala:34``, which redirects Spark's INFO chatter to
``bigdl.log`` so the console shows BigDL's own lines).  The noisy loggers
here are PyTorch's: ``torch``, ``torch._dynamo`` and
``torch.distributed``.  Knobs: ``BIGDL_TORCH_DISABLE_LOGGER_FILTER``
(1 = leave the loggers alone) and ``BIGDL_TORCH_LOG_FILE`` (the file;
default ``bigdl_torch.log`` in the working directory).
"""

from __future__ import annotations

import logging
import os
from typing import Iterable, Optional

from . import config

__all__ = ["redirect"]

_NOISY = ("torch", "torch._dynamo", "torch.distributed")

# one handler per log path for the process: a repeated redirect() reuses
# it instead of opening the file again
_handlers: dict = {}


def redirect(loggers: Optional[Iterable[str]] = None,
             log_file: Optional[str] = None) -> Optional[str]:
    """Send the records of ``loggers`` (default: PyTorch's) to the log
    file instead of the console.  Returns the file's path, or None when
    the filter is disabled."""
    if config.get_bool("DISABLE_LOGGER_FILTER"):
        return None
    path = log_file or config.get_str("LOG_FILE",
                                      os.path.abspath("bigdl_torch.log"))
    handler = _handlers.get(path)
    if handler is None:
        handler = logging.FileHandler(path)
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s %(name)s - %(message)s"))
        _handlers[path] = handler
    for name in (loggers or _NOISY):
        lg = logging.getLogger(name)
        # the handlers are shared per path, so detach without closing
        for old in list(lg.handlers):
            lg.removeHandler(old)
        lg.addHandler(handler)
        lg.propagate = False
        lg.setLevel(logging.INFO)
    return path
