"""Activation ops of the serving slice: relu (paddle_tpu/ops/activation_ops.py)."""

from __future__ import annotations

import torch

from .registry import register_op


@register_op("relu")
def relu(ctx):
    ctx.set_output("Out", torch.relu(ctx.input("X")))
