"""Suggest algorithms: ``rand`` and ``tpe``."""

from . import rand, tpe

__all__ = ["rand", "tpe"]
