"""Logging / progress / run statistics.

Counterpart of the reference's L0 observability surface
(src/myutils.h Log/Progress/ProgressLog, -log FILE option;
src/reseek_main.cpp:61-62 elapsed-time + peak-RAM report): a process-wide
logger with an optional log file, single-line console progress updates,
and end-of-run resource stats.
"""

from __future__ import annotations

import atexit
import sys
import time
from typing import Optional, TextIO


def secs_to_hhmmss(secs: float) -> str:
    s = int(secs)
    return "%02d:%02d:%02d" % (s // 3600, (s // 60) % 60, s % 60)


def int_to_str(n: int) -> str:
    """IntToStr (src/myutils.cpp): thousands separators via magnitude
    suffix for large counts, plain digits otherwise."""
    if n >= 100_000_000_000:
        return "%.3gG" % (n / 1e9)
    if n >= 100_000_000:
        return "%.3gM" % (n / 1e6)
    if n >= 100_000:
        return "%.3gk" % (n / 1e3)
    return "%d" % n


def peak_rss_mb() -> float:
    try:
        import resource
        kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        return kb / 1024.0
    except Exception:
        return 0.0


class Logger:
    """Console progress + optional log file (the reference's -log FILE).

    Log()        -> log file only
    Progress()   -> single updating console line (stderr)
    ProgressLog()-> both
    """

    def __init__(self, log_file: Optional[TextIO] = None,
                 console: Optional[TextIO] = None, quiet: bool = False):
        self.log_file = log_file
        self.console = console if console is not None else sys.stderr
        self.quiet = quiet
        self._progress_open = False
        self.t0 = time.time()

    # -- file-only ------------------------------------------------------
    def log(self, msg: str) -> None:
        if self.log_file is not None:
            self.log_file.write(msg)
            self.log_file.flush()

    # -- console single-line progress ------------------------------------
    def progress(self, msg: str) -> None:
        if self.quiet:
            return
        self.console.write("\r" + msg.ljust(79)[:200])
        self.console.flush()
        self._progress_open = True

    def progress_done(self) -> None:
        if self._progress_open and not self.quiet:
            self.console.write("\n")
            self.console.flush()
        self._progress_open = False

    # -- both -------------------------------------------------------------
    def progress_log(self, msg: str) -> None:
        self.progress_done()
        if not self.quiet:
            self.console.write(msg)
            self.console.flush()
        self.log(msg)

    def log_elapsed_and_ram(self) -> None:
        """LogElapsedTimeAndRAM (src/reseek_main.cpp:61-62)."""
        elapsed = time.time() - self.t0
        self.log("Elapsed time %s, peak RAM %.1f MB\n"
                 % (secs_to_hhmmss(elapsed), peak_rss_mb()))

    def finished(self) -> None:
        """The test harness's crash detector greps for "Finished"
        (reference test_scripts/check_logs.py)."""
        self.log_elapsed_and_ram()
        self.log("Finished\n")


_global: Logger = Logger()


def get_logger() -> Logger:
    return _global


def open_log(path: Optional[str], quiet: bool = False) -> Logger:
    """Install the process logger; -log FILE semantics.  Closed at exit
    after writing the "Finished" marker."""
    global _global
    f = open(path, "w") if path else None
    _global = Logger(log_file=f, quiet=quiet)
    if f is not None:
        def _close():
            try:
                _global.finished()
                f.close()
            except Exception:
                pass
        atexit.register(_close)
    return _global
