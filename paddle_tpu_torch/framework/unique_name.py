"""Unique name generation for IR variables/ops.

Copy of paddle_tpu/framework/unique_name.py (the port imports nothing of
the JAX package): a process-wide counter per key plus a guard() context
manager that swaps in a fresh generator so program builds are
reproducible — and name-for-name equal to the JAX package's builds.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict


class UniqueNameGenerator:
    def __init__(self, prefix: str = ""):
        self.prefix = prefix
        self.ids = defaultdict(int)

    def __call__(self, key: str) -> str:
        tmp = self.ids[key]
        self.ids[key] += 1
        return self.prefix + "_".join([key, str(tmp)])


_generator = UniqueNameGenerator()


def generate(key: str) -> str:
    return _generator(key)


@contextlib.contextmanager
def guard(new_prefix: str = ""):
    global _generator
    old = _generator
    _generator = UniqueNameGenerator(new_prefix)
    try:
        yield
    finally:
        _generator = old
