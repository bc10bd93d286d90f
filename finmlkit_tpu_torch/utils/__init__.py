"""Utilities: the package's logger (``log.get_logger``)."""
from .log import get_logger

__all__ = ["get_logger"]
