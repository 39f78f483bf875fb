"""Serving a saved inference model: Config, Predictor, create_predictor.

Counterpart of paddle_tpu/inference/__init__.py:21-131 (the reference's
PaddlePredictor contract, paddle_inference_api.h:141): load a model saved
by `io.save_inference_model` (by either package), run(feed) -> fetches,
generate() through a decode spec over the loaded weights, and clone() for
threads.  A Predictor owns its Scope and a jit-mode Executor on its
place: on the card every run is a replay of CUDA graphs
(framework/cuda_graph.py).  A program holding a batch_norm is transpiled
on load (transpiler.InferenceTranspiler: the conv+bn fold and the fuses),
unless it is the int8 deployed form (`quantized_matmul` /
`quantized_conv2d` ops, contrib.quantize.freeze_int8): its ops already
carry their dequant, and the fold does not apply to a frozen graph.

The JAX module's StableHLO exports (`export_stablehlo`,
`export_train_step`) are not ported.
"""

from __future__ import annotations

from ..framework.core_types import as_device

_QUANTIZED_OPS = ("quantized_matmul", "quantized_conv2d")


class Config:
    """reference NativeConfig/AnalysisConfig (paddle_inference_api.h:183,
    255).  `place` is where the model runs: the card (`default_place()`)
    unless the caller passes `CPUPlace()`."""

    def __init__(self, model_dir, use_transpiler=True, place=None):
        self.model_dir = model_dir
        self.use_transpiler = use_transpiler
        self.place = place


class Predictor:
    """Own scope and executor per predictor; clone() shares the weights
    with a run state of its own."""

    def __init__(self, config: Config):
        from .. import io as fluid_io
        from ..framework.executor import Executor
        from ..framework.scope import Scope, scope_guard

        self.config = config
        self._device = as_device(config.place)
        self._scope = Scope()
        self._exe = Executor(self._device, mode="jit")
        with scope_guard(self._scope):
            prog, feeds, fetches = fluid_io.load_inference_model(
                config.model_dir, self._exe)
        self._quantized = any(op.type in _QUANTIZED_OPS
                              for op in prog.global_block().ops)
        if config.use_transpiler and not self._quantized and any(
                op.type == "batch_norm" for op in prog.global_block().ops):
            from ..transpiler import InferenceTranspiler

            InferenceTranspiler().transpile(prog, scope=self._scope)
        self._program, self._feeds, self._fetches = prog, feeds, fetches
        # id(spec) -> (spec, Generator): the entry holds the spec, so that
        # its id cannot be reused by another spec after a collection
        self._generators = {}

    @property
    def feed_names(self):
        return list(self._feeds)

    @property
    def quantized(self):
        """Whether the loaded model is the int8 deployed form (holds
        quantized_matmul or quantized_conv2d ops)."""
        return self._quantized

    def run(self, feed: dict):
        return self._exe.run(self._program, feed=feed,
                             fetch_list=[v.name for v in self._fetches],
                             scope=self._scope)

    def generate(self, spec, feed, max_new_tokens, **kwargs):
        """Autoregressive generation over this predictor's loaded weights.
        `spec` is a decode.GenerationSpec (e.g.
        models.transformer.build_decode(...)) whose programs name the
        saved model's parameters, so they run over this predictor's
        scope; decode-only vars (position tables) are initialized on
        first use without touching the loaded weights.  One Generator per
        spec is kept, so a second call replays the graphs the first
        captured.  kwargs: method, beam_size, bos_id, eos_id."""
        from ..decode import Generator

        ent = self._generators.get(id(spec))
        if ent is None or ent[0] is not spec:
            ent = (spec, Generator(spec, scope=self._scope,
                                   place=self._device))
            self._generators[id(spec)] = ent
        return ent[1].generate(feed, max_new_tokens, **kwargs)

    def clone(self):
        """The same program and weights with a scope and an executor of
        its own (the reference's thread-per-predictor pattern,
        api_impl_tester.cc): run() stages feeds and outputs through the
        scope, so clones sharing one would race.  The clone's scope holds
        the same tensors, not copies; its executor captures its own
        graphs."""
        from ..framework.executor import Executor
        from ..framework.scope import Scope

        p = Predictor.__new__(Predictor)
        p.config = self.config
        p._device = self._device
        p._scope = Scope()
        for n in self._scope.local_var_names():
            p._scope.set_local(n, self._scope.find_var(n))
        p._program = self._program
        p._feeds = self._feeds
        p._fetches = self._fetches
        p._quantized = self._quantized
        p._generators = {}
        p._exe = Executor(self._device, mode="jit")
        return p


def create_predictor(config: Config) -> Predictor:
    """reference CreatePaddlePredictor."""
    return Predictor(config)
