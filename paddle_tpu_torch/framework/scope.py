"""Scope: hierarchical name -> runtime value map.

Counterpart of paddle_tpu/framework/scope.py; values are torch.Tensors
(or numpy arrays before staging) instead of jax Arrays.
"""

from __future__ import annotations

import contextlib


class Scope:
    def __init__(self, parent: "Scope" = None):
        self._vars = {}
        self.parent = parent

    def find_var(self, name):
        """Value or None, walking parents (reference Scope::FindVar)."""
        s = self
        while s is not None:
            if name in s._vars:
                return s._vars[name]
            s = s.parent
        return None

    def set_var(self, name, value):
        """Set in the scope that already owns `name` (parent walk), else here."""
        s = self
        while s is not None:
            if name in s._vars:
                s._vars[name] = value
                return
            s = s.parent
        self._vars[name] = value

    def set_local(self, name, value):
        self._vars[name] = value

    def local_var_names(self):
        return list(self._vars.keys())


_global_scope = Scope()


def global_scope() -> Scope:
    return _global_scope


@contextlib.contextmanager
def scope_guard(scope: Scope):
    global _global_scope
    old, _global_scope = _global_scope, scope
    try:
        yield
    finally:
        _global_scope = old
