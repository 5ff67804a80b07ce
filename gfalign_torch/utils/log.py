"""Verbose logging with elapsed-time stamps (reference: gfalibs log.h usage;
gfalign prints elapsed-stamped messages to stderr under --verbose,
src/main.cpp:52-56)."""

from __future__ import annotations

import sys
import time


class Log:
    def __init__(self) -> None:
        self.start = time.monotonic()
        self.verbose_flag = False

    def set_verbose(self, flag: bool) -> None:
        self.verbose_flag = bool(flag)

    def verbose(self, msg: str) -> None:
        if self.verbose_flag:
            elapsed = time.monotonic() - self.start
            print(f"[{elapsed:.2f}s] {msg}", file=sys.stderr)

    def warn(self, msg: str) -> None:
        """Always-on stderr warning (stdout byte-parity is never touched)."""
        elapsed = time.monotonic() - self.start
        print(f"[{elapsed:.2f}s] WARNING: {msg}", file=sys.stderr)


lg = Log()
