"""Driver logging (the ConditionalOStream analogue, ``main.cc:206``).

Verbosity is a module switch so tests can silence the driver.
"""

from __future__ import annotations

import sys

_verbose = True


def set_verbose(v: bool):
    global _verbose
    _verbose = v


def get_logger():
    def log(msg: str):
        if _verbose:
            print(msg, file=sys.stdout, flush=True)

    return log
