"""Logging set from the environment.

Counterpart of ``finmlkit_tpu/utils/log.py``, under the root logger
``finmlkit_tpu_torch``: a console handler (level ``FMKT_CONSOLE_LOGGER_LEVEL``,
default WARNING), and, where ``FMKT_LOG_FILE_PATH`` names a file, a handler
that rotates it at midnight and keeps 7 old files (level
``FMKT_FILE_LOGGER_LEVEL``, default INFO; the file's directories are made).
The loggers of noisy libraries are set to WARNING, and the root does not
propagate. The handlers are added once, at the first :func:`get_logger`.

The JAX module prefixes every name that does not start with
``finmlkit_tpu``, a test that ``finmlkit_tpu_torch...`` also passes; here a
name is left as it is only when it is the root or a child of it.
"""
import logging
import logging.handlers
import os

ROOT = "finmlkit_tpu_torch"

_CONFIGURED = False

_FMT = "%(asctime)s | %(levelname)-8s | %(name)s | %(message)s"


def _level(name: str, default: str) -> int:
    return getattr(logging, os.environ.get(name, default).upper(), logging.INFO)


def _configure_root() -> None:
    global _CONFIGURED
    if _CONFIGURED:
        return
    root = logging.getLogger(ROOT)
    root.setLevel(logging.DEBUG)

    console = logging.StreamHandler()
    console.setLevel(_level("FMKT_CONSOLE_LOGGER_LEVEL", "WARNING"))
    console.setFormatter(logging.Formatter(_FMT))
    root.addHandler(console)

    file_path = os.environ.get("FMKT_LOG_FILE_PATH", "")
    if file_path:
        os.makedirs(os.path.dirname(os.path.abspath(file_path)), exist_ok=True)
        fh = logging.handlers.TimedRotatingFileHandler(
            file_path, when="midnight", backupCount=7)
        fh.setLevel(_level("FMKT_FILE_LOGGER_LEVEL", "INFO"))
        fh.setFormatter(logging.Formatter(_FMT))
        root.addHandler(fh)

    for noisy in ("torch", "urllib3", "matplotlib", "h5py"):
        logging.getLogger(noisy).setLevel(logging.WARNING)

    root.propagate = False
    _CONFIGURED = True


def get_logger(name: str) -> logging.Logger:
    """A logger under ``finmlkit_tpu_torch``: ``name`` itself where it is the
    root or below it, else ``finmlkit_tpu_torch.<name>``. The first call adds
    the handlers."""
    _configure_root()
    if name != ROOT and not name.startswith(ROOT + "."):
        name = f"{ROOT}.{name}"
    return logging.getLogger(name)
