"""Learning-rate schedules as ops over a global step counter.

Counterpart of paddle_tpu/layers/learning_rate_scheduler.py (:24-134):
`_global_step_counter`, a persistable int64 `@LR_DECAY_COUNTER@` whose
`increment` op is prepended to the main block (so it advances once a
run, before anything reads it), and seven schedules, each one
`lr_schedule` op (ops/math_ops.py) over the counter whose persistable
float32 [1] output is the optimizer's LearningRate.  Inside a captured
training step the counter is a donated persistable, written in place like
the parameters, and the update ops read the LearningRate tensor the
graph computes: every replay advances the counter and updates with its
step's rate.
"""

from __future__ import annotations

from ..layer_helper import LayerHelper

LR_COUNTER_NAME = "@LR_DECAY_COUNTER@"


def _global_step_counter():
    """Persistable int64 step counter, incremented once a run."""
    helper = LayerHelper("global_step_counter")
    counter, is_new = helper.create_or_get_global_variable(
        LR_COUNTER_NAME, shape=[1], dtype="int64")
    if is_new:
        from ..initializer import ConstantInitializer

        counter.stop_gradient = True
        helper.set_variable_initializer(counter, ConstantInitializer(0))
        helper.main_program.global_block()._prepend_op(
            type="increment",
            inputs={"X": [counter]},
            outputs={"Out": [counter]},
            attrs={"step": 1.0},
        )
    return counter


def _schedule(kind, attrs):
    helper = LayerHelper(f"lr_{kind}")
    step = _global_step_counter()
    lr = helper.create_variable_for_type_inference("float32",
                                                   stop_gradient=True)
    attrs = dict(attrs)
    attrs["kind"] = kind
    helper.append_op(type="lr_schedule", inputs={"Step": [step]},
                     outputs={"Out": [lr]}, attrs=attrs)
    lr.persistable = True
    return lr


def noam_decay(d_model, warmup_steps):
    """lr = d_model^-0.5 * min(step^-0.5, step * warmup^-1.5)."""
    return _schedule("noam", {"d_model": float(d_model),
                              "warmup_steps": float(warmup_steps)})


def _decay(kind, learning_rate, decay_steps, decay_rate, staircase):
    return _schedule(kind, {"learning_rate": float(learning_rate),
                            "decay_steps": float(decay_steps),
                            "decay_rate": float(decay_rate),
                            "staircase": staircase})


def exponential_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    """lr * decay_rate^(step / decay_steps)."""
    return _decay("exponential", learning_rate, decay_steps, decay_rate,
                  staircase)


def natural_exp_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    """lr * exp(-decay_rate * step / decay_steps)."""
    return _decay("natural_exp", learning_rate, decay_steps, decay_rate,
                  staircase)


def inverse_time_decay(learning_rate, decay_steps, decay_rate,
                       staircase=False):
    """lr / (1 + decay_rate * step / decay_steps)."""
    return _decay("inverse_time", learning_rate, decay_steps, decay_rate,
                  staircase)


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=0.0001,
                     power=1.0, cycle=False):
    return _schedule("polynomial", {
        "learning_rate": float(learning_rate),
        "decay_steps": float(decay_steps),
        "end_learning_rate": float(end_learning_rate),
        "power": float(power),
        "cycle": cycle,
    })


def piecewise_decay(boundaries, values):
    if len(values) - len(boundaries) != 1:
        raise ValueError("len(values) must be len(boundaries) + 1")
    return _schedule("piecewise", {
        "boundaries": [float(b) for b in boundaries],
        "values": [float(v) for v in values],
    })


def cosine_decay(learning_rate, step_each_epoch, epochs):
    return _schedule("cosine", {"learning_rate": float(learning_rate),
                                "step_each_epoch": float(step_each_epoch),
                                "epochs": float(epochs)})
