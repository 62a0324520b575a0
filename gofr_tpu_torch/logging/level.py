"""Log levels (a copy of ``gofr_tpu/logging/level.py``; reference:
pkg/gofr/logging/level.go:12-19)."""

from __future__ import annotations

import enum


class Level(enum.IntEnum):
    DEBUG = 1
    INFO = 2
    NOTICE = 3
    WARN = 4
    ERROR = 5
    FATAL = 6

    @property
    def color(self) -> int:
        # ANSI 256 colors, matching the reference's scheme (level.go:39-55)
        return {
            Level.DEBUG: 6,
            Level.INFO: 4,
            Level.NOTICE: 5,
            Level.WARN: 3,
            Level.ERROR: 1,
            Level.FATAL: 9,
        }[self]


def parse_level(name: str, default: Level = Level.INFO) -> Level:
    try:
        return Level[name.strip().upper()]
    except KeyError:
        return default
