"""ParallelExecutor: the reference's multi-device training engine
(counterpart of paddle_tpu/parallel/parallel_executor.py).

reference: paddle/fluid/framework/parallel_executor.cc:58-325 +
python/paddle/fluid/parallel_executor.py:32.  There, construction builds an
SSA graph with explicit NCCL AllReduce/Broadcast op handles and a thread
pool interprets it.  Here, construction picks a DeviceMesh and stamps the
JAX package's sharding annotations (BuildStrategy.Apply() -> annotation
passes, in its order: dp, Reduce, tp, then ZeRO last); `run` runs the
program in the Executor's mesh mode (parallel/spmd.py), one process per
rank, and DTensor issues the collectives.  The strategy objects keep the
reference's API shape; scheduling knobs are accepted and ignored.

The port is always multi-controller (parallel_executor.py:84-90 of the
JAX package): every rank constructs the ParallelExecutor and calls `run`
with the rows its data-axis coordinate owns (`local_batch` cuts them from
a global batch); ranks that differ only on tp or sp feed the same rows.

A mesh run takes the interpreter path (`executor_mode`,
`executor_mode_reason`): gloo collectives cannot be captured in a CUDA
graph, and capture of a mesh step under NCCL is ROADMAP.md A item 7.
"""

from __future__ import annotations

import enum

from ..framework.executor import Executor
from ..framework.framework import default_main_program
from ..framework.scope import global_scope
from .mesh import DeviceMesh, make_mesh
from .sharding import (apply_data_parallel, apply_tensor_parallel,
                       apply_zero_sharding)


class ReduceStrategy(enum.IntEnum):
    """reference details/build_strategy.h:34 ReduceStrategy."""

    AllReduce = 0  # replicated params, grads all-reduced
    Reduce = 1  # sharded ownership — maps to FSDP/ZeRO param sharding


class GradientScaleStrategy(enum.IntEnum):
    """reference build_strategy.h:41 — a mean over a batch-sharded dim is
    already the global mean, so CoeffNumDevice needs no scale op."""

    CoeffNumDevice = 0
    One = 1
    Customized = 2


class ExecutionStrategy:
    """reference details/execution_strategy.h:21 — scheduling knobs, kept
    for API parity."""

    def __init__(self):
        self.num_threads = 0
        self.allow_op_delay = False
        self.num_iteration_per_drop_scope = 100
        self.use_experimental_executor = False


class BuildStrategy:
    """reference details/build_strategy.h — what communication plan to build.

    reduce_strategy=AllReduce  -> pure DP (params replicated)
    reduce_strategy=Reduce     -> FSDP-style param/state sharding over dp axis
    tensor_parallel_rules      -> megatron TP annotations (new, no ref analog)
    zero_stage                 -> ZeRO-1/2 optimizer-state sharding over dp
                                  (params stay replicated; None reads
                                  FLAGS_zero_stage, 0 = off)
    debug_graphviz_path        -> raises: debugger.py is not ported
                                  (ROADMAP.md A item 8)
    """

    ReduceStrategy = ReduceStrategy
    GradientScaleStrategy = GradientScaleStrategy

    def __init__(self):
        self.reduce_strategy = ReduceStrategy.AllReduce
        self.gradient_scale_strategy = GradientScaleStrategy.CoeffNumDevice
        self.memory_optimize = False
        self.enable_inplace = True
        self.fuse_elewise_add_act_ops = True
        self.tensor_parallel_rules = None
        self.zero_stage = None
        self.debug_graphviz_path = ""


class ParallelExecutor:
    """Data-parallel (optionally TP/FSDP/ZeRO-annotated) program runner.

    Usage parity with the reference (python/paddle/fluid/parallel_executor.py):

        pe = ParallelExecutor(loss_name=loss.name, mesh=make_mesh(dp=2, tp=2))
        loss_val, = pe.run(fetch_list=[loss.name], feed=local_rows)

    Every rank runs this with its own rows (see the module docstring).
    The persistables already in the scope (a seeded startup run on every
    rank alike, or `convert.load_params`) are cut into each rank's blocks
    at construction (`_distribute_params`).
    """

    def __init__(
        self,
        use_cuda=True,
        loss_name=None,
        main_program=None,
        share_vars_from=None,
        exec_strategy=None,
        build_strategy=None,
        num_trainers=1,
        trainer_id=0,
        scope=None,
        mesh: DeviceMesh | None = None,
    ):
        del use_cuda  # the place is the mesh's
        self._program = (main_program if main_program is not None
                         else default_main_program())
        self._build_strategy = build_strategy or BuildStrategy()
        self._exec_strategy = exec_strategy or ExecutionStrategy()
        self._scope = scope if scope is not None else global_scope()
        self._loss_name = loss_name
        if share_vars_from is not None:
            self._scope = share_vars_from._scope

        self.mesh = mesh if mesh is not None else make_mesh(dp=-1)

        if self._build_strategy.debug_graphviz_path:
            raise NotImplementedError(
                "BuildStrategy.debug_graphviz_path: debugger.py is not "
                "ported (ROADMAP.md A item 8)")

        # BuildStrategy.Apply(): annotation passes instead of graph rewrites
        apply_data_parallel(self._program, self.mesh)
        if self._build_strategy.reduce_strategy == ReduceStrategy.Reduce and (
            self.mesh.axis_size("fsdp", 1) > 1
            or self.mesh.axis_size("dp", 1) > 1
        ):
            apply_zero_sharding(self._program, self.mesh)
        if self._build_strategy.tensor_parallel_rules:
            apply_tensor_parallel(
                self._program, self._build_strategy.tensor_parallel_rules
            )
        # ZeRO runs LAST: apply_tensor_parallel propagates param
        # annotations onto the accumulators, and apply_zero composes its
        # dp dim on top of whatever they inherited
        zero_stage = self._build_strategy.zero_stage
        if zero_stage is None:
            from .. import flags

            zero_stage = flags.get("zero_stage")
        if zero_stage:
            from .zero import apply_zero

            apply_zero(self._program, self.mesh, stage=int(zero_stage))

        self._exe = Executor(mesh=self.mesh)
        self._distribute_params()

    @property
    def executor_mode(self):
        """The Executor's path for this mesh: "interpret"."""
        return self._exe.mode

    @property
    def executor_mode_reason(self):
        return self._exe.mode_reason

    def _distribute_params(self):
        """The reference's BCastParamsToDevices (parallel_executor.cc:178):
        every persistable already in the scope becomes a DTensor in its
        resolved placements.  "local is global": the full value is the
        same on every rank (seeded startup, or load_params), so each rank
        keeps its own block and nothing is sent."""
        import torch

        from . import spmd
        from .sharding import sharding_for_var

        blk = self._program.global_block()
        for name, var in blk.vars.items():
            if not var.persistable:
                continue
            val = self._scope.find_var(name)
            if not isinstance(val, torch.Tensor):
                continue
            pl = sharding_for_var(var, self.mesh)
            if pl is None:
                continue
            if spmd.is_dtensor(val):
                if tuple(val.placements) != tuple(pl):
                    self._scope.set_var(name, spmd.to_layout(
                        val, self.mesh, pl))
                continue  # already distributed (share_vars_from path)
            self._scope.set_var(name, spmd.distribute(
                val.to(self.mesh.device), self.mesh, pl))

    def local_batch(self, value):
        """This rank's rows of a global batch (spmd.local_batch)."""
        from . import spmd

        return spmd.local_batch(self.mesh, value)

    @property
    def device_count(self):
        return self.mesh.size

    def run(self, fetch_list, feed=None, feed_dict=None, return_numpy=True):
        feed = feed if feed is not None else feed_dict
        return self._exe.run(
            self._program,
            feed=feed,
            fetch_list=fetch_list,
            scope=self._scope,
            return_numpy=return_numpy,
        )
