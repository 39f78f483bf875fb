"""Test helpers for the port."""

from __future__ import annotations

import contextlib

from .framework import (
    Program,
    Scope,
    scope_guard,
    switch_main_program,
    switch_startup_program,
    unique_name,
)


@contextlib.contextmanager
def fresh_programs():
    """Fresh default programs, scope and name counters for the port —
    what tests/conftest.py's autouse fixture does for paddle_tpu."""
    old_main = switch_main_program(Program())
    old_startup = switch_startup_program(Program())
    try:
        with unique_name.guard(), scope_guard(Scope()):
            yield
    finally:
        switch_main_program(old_main)
        switch_startup_program(old_startup)
