"""Terminal output: colors, cursor control, spinners, progress bars (a copy of
``gofr_tpu/cli/terminal.py``).

Reference parity: pkg/gofr/cmd/terminal/ — the ``Output`` surface
(output.go:12-45: print/colors/cursor ops), dot/pulse/globe spinners
(spinner.go:24-47), and a progress bar (progress.go).
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Any

RESET = "\x1b[0m"
COLORS = {
    "black": 30, "red": 31, "green": 32, "yellow": 33,
    "blue": 34, "magenta": 35, "cyan": 36, "white": 37,
}

SPINNER_FRAMES = {
    "dot": ["⠋", "⠙", "⠹", "⠸", "⠼", "⠴", "⠦", "⠧", "⠇", "⠏"],
    "pulse": ["█", "▓", "▒", "░", "▒", "▓"],
    "globe": ["🌍", "🌎", "🌏"],
}


class Output:
    """The terminal facade handed to CMD contexts as ``ctx.out``."""

    def __init__(self, stream: Any = None) -> None:
        self.stream = stream if stream is not None else sys.stdout
        try:
            self.is_terminal = bool(self.stream.isatty())
        except (AttributeError, ValueError):
            self.is_terminal = False

    # -- printing --------------------------------------------------------------
    def print(self, *args: Any) -> None:
        self.stream.write(" ".join(str(a) for a in args))
        self.stream.flush()

    def println(self, *args: Any) -> None:
        self.stream.write(" ".join(str(a) for a in args) + "\n")
        self.stream.flush()

    def printf(self, fmt: str, *args: Any) -> None:
        self.stream.write(fmt % args if args else fmt)
        self.stream.flush()

    def error(self, message: str) -> None:
        self.println(self.colorize(f"error: {message}", "red"))

    def colorize(self, text: str, color: str, bold: bool = False) -> str:
        if not self.is_terminal:
            return text
        code = COLORS.get(color, 37)
        prefix = f"\x1b[{'1;' if bold else ''}{code}m"
        return f"{prefix}{text}{RESET}"

    # -- cursor ops (output.go cursor methods) ---------------------------------
    def _csi(self, seq: str) -> None:
        if self.is_terminal:
            self.stream.write(f"\x1b[{seq}")
            self.stream.flush()

    def clear_screen(self) -> None:
        self._csi("2J")
        self._csi("H")

    def clear_line(self) -> None:
        self._csi("2K")
        if self.is_terminal:  # piped output must not collect stray \r
            self.stream.write("\r")

    def clear_line_left(self) -> None:
        self._csi("1K")

    def clear_line_right(self) -> None:
        self._csi("0K")

    def clear_lines(self, n: int) -> None:
        """Clear the current line and the ``n`` lines above it
        (output.go ClearLines: the spinner/progress repaint primitive)."""
        self.clear_line()
        for _ in range(max(n, 0)):
            self.cursor_up(1)
            self.clear_line()

    def cursor_up(self, n: int = 1) -> None:
        self._csi(f"{n}A")

    def cursor_down(self, n: int = 1) -> None:
        self._csi(f"{n}B")

    def cursor_forward(self, n: int = 1) -> None:
        self._csi(f"{n}C")

    def cursor_back(self, n: int = 1) -> None:
        self._csi(f"{n}D")

    def cursor_next_line(self, n: int = 1) -> None:
        self._csi(f"{n}E")

    def cursor_prev_line(self, n: int = 1) -> None:
        self._csi(f"{n}F")

    def move_cursor(self, row: int, column: int) -> None:
        self._csi(f"{row};{column}H")

    def save_cursor_position(self) -> None:
        self._csi("s")

    def restore_cursor_position(self) -> None:
        self._csi("u")

    def hide_cursor(self) -> None:
        self._csi("?25l")

    def show_cursor(self) -> None:
        self._csi("?25h")

    # -- screen ops (output.go screen methods) ---------------------------------
    def alt_screen(self) -> None:
        self._csi("?1049h")

    def exit_alt_screen(self) -> None:
        self._csi("?1049l")

    def save_screen(self) -> None:
        self._csi("?47h")

    def restore_screen(self) -> None:
        self._csi("?47l")

    def change_scrolling_region(self, top: int, bottom: int) -> None:
        self._csi(f"{top};{bottom}r")

    def insert_lines(self, n: int = 1) -> None:
        self._csi(f"{n}L")

    def delete_lines(self, n: int = 1) -> None:
        self._csi(f"{n}M")

    def set_color(self, color_code: int) -> None:
        """Raw SGR color by numeric code (output.go SetColor)."""
        self._csi(f"{int(color_code)}m")

    def reset_color(self) -> None:
        self._csi("39;49m")

    def reset(self) -> None:
        if self.is_terminal:
            self.stream.write(RESET)
            self.stream.flush()

    def set_window_title(self, title: str) -> None:
        if self.is_terminal:
            self.stream.write(f"\x1b]2;{title}\x07")
            self.stream.flush()

    def get_size(self) -> tuple[int, int]:
        """(columns, rows) of the ATTACHED terminal (this Output's
        stream, not whatever stdout happens to be); (0, 0) off-tty
        (output.go getSize)."""
        import os

        if not self.is_terminal:
            return (0, 0)
        try:
            size = os.get_terminal_size(self.stream.fileno())
            return (size.columns, size.lines)
        except (OSError, ValueError, AttributeError):
            return (80, 24)


class Spinner:
    """spinner.go:24-47: animated spinner on a daemon thread."""

    def __init__(self, out: Output, kind: str = "dot", message: str = "") -> None:
        self.out = out
        self.frames = SPINNER_FRAMES.get(kind, SPINNER_FRAMES["dot"])
        self.message = message
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> "Spinner":
        if not self.out.is_terminal:
            return self
        self.out.hide_cursor()
        self._thread = threading.Thread(target=self._spin, daemon=True)
        self._thread.start()
        return self

    def _spin(self) -> None:
        i = 0
        while not self._stop.wait(0.1):
            self.out.clear_line()
            self.out.print(f"{self.frames[i % len(self.frames)]} {self.message}")
            i += 1

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=1)
        if self.out.is_terminal:
            self.out.clear_line()
            self.out.show_cursor()


class ProgressBar:
    """progress.go: ``[=====>    ] 52%`` on a single line."""

    def __init__(self, out: Output, total: int, width: int = 40) -> None:
        self.out = out
        self.total = max(1, total)
        self.width = width
        self.current = 0

    def incr(self, n: int = 1) -> None:
        self.current = min(self.total, self.current + n)
        self._render()

    def _render(self) -> None:
        frac = self.current / self.total
        filled = int(frac * self.width)
        bar = "=" * filled + (">" if filled < self.width else "") + " " * (self.width - filled - 1)
        if self.out.is_terminal:
            self.out.clear_line()
            self.out.print(f"[{bar}] {frac * 100:3.0f}%")
        if self.current >= self.total and self.out.is_terminal:
            self.out.print("\n")
