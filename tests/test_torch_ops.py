"""The port's op lowerings against the JAX package's, op by op.

Each of the 15 op types that `transformer.build_decode`'s prefill, step and
startup programs run goes through `registry.run_forward` in both packages
on the same numpy inputs (made from a seed), in float32 on the CPU, and
must agree to atol 1e-5.  JAX runs with x64 off, so its integer outputs
are int32 where the port keeps int64: values are compared, not dtypes.
`uniform_random` cannot match value for value (threefry vs torch's
generator); it is held to the same shape, dtype, range and moments.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import registry as jreg
from paddle_tpu_torch import testing
from paddle_tpu_torch.ops import registry as preg

ATOL = 1e-5


@pytest.fixture(autouse=True)
def _fresh_port():
    with testing.fresh_programs():
        yield


def _run_both(op_type, inputs, attrs, out_names=None):
    """inputs: {param: [ndarray | None]} -> (jax outs, port outs), each
    {param: [ndarray | None]}."""
    j_in = {p: [None if a is None else jnp.asarray(a) for a in lst]
            for p, lst in inputs.items()}
    p_in = {p: [None if a is None else torch.as_tensor(np.array(a))
                for a in lst]
            for p, lst in inputs.items()}
    j_out = jreg.run_forward(jreg.get_op_info(op_type), j_in, dict(attrs),
                             out_names=out_names)
    p_out = preg.run_forward(preg.get_op_info(op_type), p_in, dict(attrs),
                             out_names=out_names, device=torch.device("cpu"))

    def host(outs):
        return {k: [None if o is None else np.asarray(o) for o in v]
                for k, v in outs.items()}

    return host(j_out), {k: [None if o is None else o.numpy() for o in v]
                         for k, v in p_out.items()}


def _assert_same(op_type, inputs, attrs, out_names=None):
    j, p = _run_both(op_type, inputs, attrs, out_names)
    assert sorted(j) == sorted(p), (sorted(j), sorted(p))
    for param in j:
        assert len(j[param]) == len(p[param])
        for a, b in zip(j[param], p[param]):
            assert a.shape == b.shape, (param, a.shape, b.shape)
            np.testing.assert_allclose(b.astype(np.float64),
                                       a.astype(np.float64), rtol=0,
                                       atol=ATOL, err_msg=f"{op_type}.{param}")
    return j, p


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_mul_flattens_at_num_col_dims():
    rng = np.random.RandomState(0)
    _assert_same("mul", {"X": [_rand(rng, 2, 3, 16)], "Y": [_rand(rng, 16, 5)]},
                 {"x_num_col_dims": 2, "y_num_col_dims": 1})


@pytest.mark.parametrize("bias_after_scale", [True, False])
def test_scale(bias_after_scale):
    rng = np.random.RandomState(1)
    _assert_same("scale", {"X": [_rand(rng, 3, 7)]},
                 {"scale": 22.627417, "bias": 0.5,
                  "bias_after_scale": bias_after_scale})


@pytest.mark.parametrize("y_shape,axis", [((4,), 2), ((3, 4), 1),
                                          ((2, 3, 4), -1), ((4,), -1)])
def test_elementwise_add_broadcasts_from_axis(y_shape, axis):
    rng = np.random.RandomState(2)
    _assert_same("elementwise_add",
                 {"X": [_rand(rng, 2, 3, 4)], "Y": [_rand(rng, *y_shape)]},
                 {"axis": axis})


def test_relu():
    rng = np.random.RandomState(3)
    _assert_same("relu", {"X": [_rand(rng, 4, 9)]}, {})


def test_layer_norm_over_trailing_axes():
    rng = np.random.RandomState(4)
    _assert_same("layer_norm",
                 {"X": [3.0 * _rand(rng, 2, 5, 32) + 1.0],
                  "Scale": [_rand(rng, 32)], "Bias": [_rand(rng, 32)]},
                 {"epsilon": 1e-5, "begin_norm_axis": 2})


@pytest.mark.parametrize("ids_shape,strip,padding_idx", [
    ((3, 5), False, -1),      # [B, S] ids keep their shape
    ((4, 1), True, -1),       # [B, 1] ids drop the trailing 1
    ((2, 6), False, 3),       # padding_idx rows come out as zeros
])
def test_lookup_table(ids_shape, strip, padding_idx):
    rng = np.random.RandomState(5)
    ids = rng.randint(0, 10, size=ids_shape).astype(np.int64)
    ids.flat[0] = 3
    _assert_same("lookup_table", {"W": [_rand(rng, 10, 8)], "Ids": [ids]},
                 {"padding_idx": padding_idx, "strip_trailing_one": strip,
                  "is_sparse": False, "is_distributed": False})


@pytest.mark.parametrize("dtype,value", [("float32", 1.0), ("int64", 7)])
def test_fill_constant(dtype, value):
    _assert_same("fill_constant", {},
                 {"shape": [3, 4], "dtype": dtype, "value": value})


@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_assign_value(dtype):
    rng = np.random.RandomState(6)
    vals = (rng.standard_normal(12) * 10).astype(dtype)
    _assert_same("assign_value", {},
                 {"shape": [3, 4], "dtype": dtype, "values": vals.tolist()})


@pytest.mark.parametrize("shape", [[-1, 1, 8], [0, -1], [6, 0]])
def test_reshape_copies_zero_dims(shape):
    rng = np.random.RandomState(7)
    _assert_same("reshape", {"X": [_rand(rng, 6, 8)]}, {"shape": shape})


def test_gather_rows():
    rng = np.random.RandomState(8)
    _assert_same("gather", {"X": [_rand(rng, 16, 8)],
                            "Index": [np.array([0, 5, 15, 5], np.int64)]}, {})


def test_increment_keeps_integer_values():
    _, p = _assert_same("increment", {"X": [np.array([0, 3, 9], np.int64)]},
                        {"step": 1.0})
    assert p["Out"][0].dtype == np.int64


def test_uniform_random_shape_range_and_moments():
    """Values differ by generator; shape, dtype, bounds and the first two
    moments of U(lo, hi) must not."""
    import jax

    attrs = {"shape": [256, 512], "dtype": "float32", "min": -0.5,
             "max": 1.5, "seed": 0}
    j = jreg.run_forward(jreg.get_op_info("uniform_random"), {}, attrs,
                         rng=jax.random.key(0))["Out"][0]
    gen = torch.Generator().manual_seed(0)
    p = preg.run_forward(preg.get_op_info("uniform_random"), {}, attrs,
                         rng=gen, device=torch.device("cpu"))["Out"][0]
    j, p = np.asarray(j), p.numpy()
    assert j.shape == p.shape == (256, 512) and p.dtype == np.float32
    assert p.min() >= -0.5 and p.max() < 1.5
    # mean 0.5, std 2/sqrt(12); 131072 draws put the sample moments
    # within ~0.005 of them
    for a in (j, p):
        assert abs(a.mean() - 0.5) < 0.01
        assert abs(a.std() - 2 / np.sqrt(12)) < 0.01
    # the port's draw is a function of its generator's seed
    gen2 = torch.Generator().manual_seed(0)
    p2 = preg.run_forward(preg.get_op_info("uniform_random"), {}, attrs,
                          rng=gen2, device=torch.device("cpu"))["Out"][0]
    np.testing.assert_array_equal(p, p2.numpy())


@pytest.mark.parametrize("lengths", [[5, 1, 3, 0], None])
def test_sequence_pool_last_ragged(lengths):
    rng = np.random.RandomState(9)
    inputs = {"X": [_rand(rng, 4, 5, 6)]}
    if lengths is not None:
        inputs["SeqLen"] = [np.array(lengths, np.int64)]
    _assert_same("sequence_pool", inputs, {"pooltype": "LAST"},
                 out_names={"Out": ["out"], "MaxIndex": ["mi"]})


def test_kv_cache_append_clamps_the_cursor():
    """lax.dynamic_update_slice clamps the start so the write fits: a cursor
    past L - T writes at L - T (row 2), a cursor in range writes there."""
    rng = np.random.RandomState(10)
    ck, cv = _rand(rng, 3, 8, 4), _rand(rng, 3, 8, 4)
    k, v = _rand(rng, 3, 2, 4), _rand(rng, 3, 2, 4)
    lengths = np.array([0, 5, 7], np.int64)
    _, p = _assert_same("kv_cache_append",
                        {"CacheK": [ck], "CacheV": [cv], "K": [k], "V": [v],
                         "Lengths": [lengths]}, {})
    np.testing.assert_array_equal(p["OutK"][0][2, 6:8], k[2])
    np.testing.assert_array_equal(p["OutK"][0][2, :6], ck[2, :6])


@pytest.mark.parametrize("causal,seq_len,bias", [
    (False, True, False), (True, False, False), (False, False, True),
])
def test_fused_attention_composite(causal, seq_len, bias):
    """Both packages on the CPU with the default gate: the composite."""
    rng = np.random.RandomState(11)
    b, sq, sk, hd = 2, 4, 6, 16
    inputs = {"Q": [_rand(rng, b, sq, hd)], "K": [_rand(rng, b, sk, hd)],
              "V": [_rand(rng, b, sk, hd)]}
    if seq_len:
        inputs["SeqLen"] = [np.array([6, 2], np.int64)]
    if bias:
        inputs["Bias"] = [_rand(rng, b, 1, sq, sk)]
    _assert_same("fused_attention", inputs,
                 {"num_heads": 2, "causal": causal, "scale": 0.0})


def test_the_slice_registers_exactly_the_decode_op_types():
    """The decode slice's 15 op types, the training slice's loss,
    reduction, cast, update and hand-written grad ops, the Scheduler
    slice's paged append, the BERT slice's ops (with those behind
    Variable's operators), the ResNet slice's conv, pool, batch norm
    (with its hand-written grad), metric, loss, momentum and gaussian
    ops, the verify/chunk windows' concat, beam search's step op, and
    dropout with its grad: 55 op types."""
    assert sorted(preg.OPS) == sorted([
        "assign_value", "elementwise_add", "fill_constant", "fused_attention",
        "gather", "increment", "kv_cache_append", "layer_norm",
        "lookup_table", "mul", "relu", "reshape", "scale", "sequence_pool",
        "uniform_random",
        "adam", "cast", "lookup_table_grad", "mean", "sgd",
        "softmax_with_cross_entropy", "sum",
        "kv_cache_append_paged",
        "gelu", "tanh", "elementwise_mul", "elementwise_div", "matmul",
        "reduce_sum", "one_hot", "slice", "check_prefix_mask", "assign",
        "fill_constant_batch_size_like", "elementwise_sub",
        "elementwise_pow", "elementwise_mod", "less_than", "less_equal",
        "greater_than", "greater_equal",
        "conv2d", "pool2d", "batch_norm",
        "batch_norm_grad", "top_k", "accuracy", "softmax", "cross_entropy",
        "momentum", "gaussian_random", "concat", "beam_search",
        "dropout", "dropout_grad"])
    assert len(preg.OPS) == 55
