"""stdout/stderr capture for log assertions (testutil/os.go:8-36); the
port's copy of ``gofr_tpu/testutil/capture.py``."""

from __future__ import annotations

import io
import sys
from typing import Callable


def stdout_output_for_func(fn: Callable[[], None]) -> str:
    buf = io.StringIO()
    old = sys.stdout
    sys.stdout = buf
    try:
        fn()
    finally:
        sys.stdout = old
    return buf.getvalue()


def stderr_output_for_func(fn: Callable[[], None]) -> str:
    buf = io.StringIO()
    old = sys.stderr
    sys.stderr = buf
    try:
        fn()
    finally:
        sys.stderr = old
    return buf.getvalue()
