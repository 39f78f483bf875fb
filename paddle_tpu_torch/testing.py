"""Test helpers for the port."""

from __future__ import annotations

import contextlib
import zlib

import numpy as np
import torch

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
    what tests/conftest.py's autouse fixture does for paddle_tpu.

    It also pins torch to one intra-op thread for the rest of the
    process.  The suite runs in several worker processes on a few cores,
    and torch's default pool (a thread a core in every worker) spins at
    each small op's barrier: six heavy port test files took 404 s on 6
    workers of an 8-core host with the default pool, 113 s with one
    thread."""
    torch.set_num_threads(1)
    old_main = switch_main_program(Program())
    old_startup = switch_startup_program(Program())
    try:
        with unique_name.guard(), scope_guard(Scope()):
            yield
    finally:
        switch_main_program(old_main)
        switch_startup_program(old_startup)


def dropout_keep(name, shape, p):
    """A float32 0/1 keep array of `shape` with P(1) = 1 - p, drawn by numpy
    from a seed made of `name`: the same for the same name in any process
    and package."""
    rs = np.random.RandomState(zlib.crc32(name.encode()))
    return (rs.random_sample(tuple(shape)) < 1.0 - p).astype(np.float32)


def seeded_dropout(original, as_array):
    """A dropout lowering for either package's registry that takes `keep`
    from `dropout_keep`, seeded by the op's Mask var name, so that both
    packages draw the same masks (their own generators cannot).  In test
    mode it is `original`.  `as_array(keep, x)` makes the array in x's
    package, dtype and device.  Install it with pytest's monkeypatch on
    `OPS["dropout"].forward`, for one test only."""

    def lowering(ctx):
        if ctx.attr("is_test", False):
            return original(ctx)
        x = ctx.input("X")
        p = ctx.attr("dropout_prob", 0.5)
        keep = as_array(dropout_keep(ctx._out_names["Mask"][0], x.shape, p),
                        x)
        if ctx.attr("dropout_implementation") == "upscale_in_train":
            keep = keep / (1.0 - p)
        ctx.set_output("Out", x * keep)
        ctx.set_output("Mask", keep)

    return lowering


def nce_given_samples(samples):
    """A lowering for the port's `nce` that takes its negatives from
    `samples`, the [B, num_true + S] SampleLabels another run drew (the
    JAX package's), instead of the op's generator: both packages then
    price the same samples (their generators cannot draw alike).
    Install it with pytest's monkeypatch on `OPS["nce"].forward`, for one
    test only."""
    from .ops import sequence_loss_ops

    def lowering(ctx):
        label = ctx.input("Label")
        num_true = label.shape[1] if label.dim() == 2 else 1
        neg = np.asarray(samples)[:, num_true:]
        sequence_loss_ops.nce_cost(
            ctx, torch.as_tensor(neg, dtype=torch.int64,
                                 device=ctx.input("Input").device))

    return lowering
