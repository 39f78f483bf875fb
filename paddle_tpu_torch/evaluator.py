"""Legacy Evaluator API shim (reference python/paddle/fluid/evaluator.py).

The reference file itself opens with "Warning: better to use the
fluid.metrics.* things" — evaluator was the deprecated predecessor of
metrics.py (program-state-variable accumulators vs host-side streaming).
This shim keeps the import surface and maps the two shipped evaluators
onto their metrics equivalents so reference scripts keep working; new
code should use paddle_tpu_torch.metrics directly (the JAX package's
paddle_tpu/evaluator.py).
"""

from __future__ import annotations

from . import metrics as _metrics

__all__ = ["Evaluator", "ChunkEvaluator", "EditDistance"]


class Evaluator:
    """Base shim: host-side accumulator exposing the reference's
    reset/eval contract (executor args accepted and ignored — state lives
    on the host, as metrics.py does).  Subclasses must set _metric; the
    base itself is abstract."""

    def __init__(self, name=None, **kwargs):
        self._metric = None
        self.name = name

    def _require_metric(self):
        if self._metric is None:
            raise NotImplementedError(
                "Evaluator is an abstract shim — instantiate "
                "ChunkEvaluator/EditDistance, or use paddle_tpu_torch.metrics"
            )
        return self._metric

    def reset(self, executor=None, reset_program=None):
        self._require_metric().reset()

    def eval(self, executor=None, eval_program=None):
        return self._require_metric().eval()

    def update(self, *args, **kwargs):
        return self._require_metric().update(*args, **kwargs)


class ChunkEvaluator(Evaluator):
    """reference evaluator.py:126 — delegates to metrics.ChunkEvaluator
    (precision/recall/F1 over chunk counts).

    The reference's program-state mode (pass input/label vars and let
    executor.run accumulate in-graph) is NOT supported — counts must be
    fed via update(); constructing with input/label raises instead of
    silently reporting zeros."""

    def __init__(self, input=None, label=None, chunk_scheme=None,
                 num_chunk_types=None, excluded_chunk_types=None, **kwargs):
        super().__init__(name=kwargs.get("name"))
        if input is not None or label is not None:
            raise NotImplementedError(
                "program-state evaluator mode is not supported: compute "
                "chunk counts with layers ops and feed them to update() "
                "(see paddle_tpu_torch.metrics.ChunkEvaluator)"
            )
        self._metric = _metrics.ChunkEvaluator()


class EditDistance(Evaluator):
    """reference evaluator.py:217 — delegates to metrics.EditDistance
    (mean distance + exact-match ratio).  Same update()-driven contract
    as ChunkEvaluator (no program-state mode)."""

    def __init__(self, input=None, label=None, ignored_tokens=None,
                 **kwargs):
        super().__init__(name=kwargs.get("name"))
        if input is not None or label is not None:
            raise NotImplementedError(
                "program-state evaluator mode is not supported: compute "
                "distances with layers.edit_distance and feed update() "
                "(see paddle_tpu_torch.metrics.EditDistance)"
            )
        self._metric = _metrics.EditDistance()
