"""Coloured console reporting.

ReportInfo / ReportWarn / ReportError-style messages with ANSI colours,
built on the standard logger so applications can redirect or silence them.
"""

from __future__ import annotations

import logging
import sys

GREEN = "\033[32m"
YELLOW = "\033[33m"
RED = "\033[31m"
CYAN = "\033[36m"
RESET = "\033[0m"

_logger = logging.getLogger("feature_tracker_tpu_torch")
if not _logger.handlers:
    _handler = logging.StreamHandler(sys.stdout)
    _handler.setFormatter(logging.Formatter("%(message)s"))
    _logger.addHandler(_handler)
    _logger.setLevel(logging.INFO)
    _logger.propagate = False


def report_info(msg: str) -> None:
    _logger.info(f"{GREEN}[Info ]{RESET} {msg}")


def report_warn(msg: str) -> None:
    _logger.warning(f"{YELLOW}[Warn ]{RESET} {msg}")


def report_error(msg: str) -> None:
    _logger.error(f"{RED}[Error]{RESET} {msg}")


def report_debug(msg: str) -> None:
    _logger.debug(f"{CYAN}[Debug]{RESET} {msg}")
