"""The port's op coverage against the JAX package's registry: each of the
JAX package's op types is registered in the port or named below with the
ROADMAP A item that will port it, and the list goes stale loudly: an op
the port registers may not stay on it, and the port registers no op
type the JAX package lacks.
"""

import pytest

from paddle_tpu.ops import registry as jreg
from paddle_tpu_torch.ops import registry as preg

_ITEM_8 = "ROADMAP A item 8: the host-side tiers (detection, io, the " \
    "distributed ops)"

STILL_TO_PORT = {
    # detection
    "anchor_generator": _ITEM_8, "bipartite_match": _ITEM_8,
    "box_coder": _ITEM_8, "detection_map": _ITEM_8,
    "generate_proposal_labels": _ITEM_8, "generate_proposals": _ITEM_8,
    "iou_similarity": _ITEM_8, "mine_hard_examples": _ITEM_8,
    "multiclass_nms": _ITEM_8, "prior_box": _ITEM_8, "roi_align": _ITEM_8,
    "roi_perspective_transform": _ITEM_8, "roi_pool": _ITEM_8,
    "rpn_target_assign": _ITEM_8, "ssd_loss": _ITEM_8,
    "target_assign": _ITEM_8,
    # io and the distributed ops
    "feed": _ITEM_8, "fetch": _ITEM_8, "print": _ITEM_8,
    "listen_and_serv": _ITEM_8, "checkpoint_notify": _ITEM_8,
}


def test_the_port_registers_no_op_the_jax_package_lacks():
    assert sorted(set(preg.OPS) - set(jreg.OPS)) == []


@pytest.mark.parametrize("op_type", sorted(jreg.OPS))
def test_each_jax_op_type_is_ported_or_named(op_type):
    registered = op_type in preg.OPS
    named = op_type in STILL_TO_PORT
    assert registered != named, (
        f"{op_type}: registered in the port and still named as to port"
        if registered else f"{op_type}: neither ported nor named")


def test_the_counts():
    assert len(jreg.OPS) == 274
    assert len(STILL_TO_PORT) == 21
    assert len(preg.OPS) == 253
    assert set(STILL_TO_PORT) <= set(jreg.OPS)
