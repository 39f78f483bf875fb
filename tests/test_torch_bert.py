"""The BERT slice against the JAX package: the new op lowerings and their
grads, the Program dicts of bert.build + Adam.minimize, and masked-LM
pretraining end to end.

Model: `BertConfig(vocab_size=64, hidden=128, layers_=2, heads=2,
ffn=256, max_positions=S, max_predictions=4, dropout=0.0)` (head_dim 64:
`bert.tiny()` has head_dim 16, which every kernel gate sends to the
composite).  S 200 takes the streaming flash tier under
flash_attention="interpret" (off mha_block's 128 grid), so the JAX side
runs its Pallas kernels #3/#4/#5 in interpret mode and the port the plain
versions of its kernels; S 128 takes mha_block.  With use_input_mask the
ragged prefix masks of `synthetic_batch` ride the kernels' length masks.
The port starts from the JAX scope's persistables, carried with
`convert.load_params`.

Tolerances: op lowerings 1e-5; grads after one backward rtol 1e-4 / atol
1e-5; losses over three Adam steps rtol 2e-4; the AMP step-1 loss 2e-2
relative (both packages round to bfloat16 at other points).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu import amp as jamp
from paddle_tpu import flags as jflags
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.framework.scope import Scope as JScope
from paddle_tpu.models import bert as JB
from paddle_tpu.ops import registry as jreg
import paddle_tpu_torch as pt
from paddle_tpu_torch import amp as pamp
from paddle_tpu_torch import convert, flags as pflags, testing
from paddle_tpu_torch.models import bert as PB
from paddle_tpu_torch.ops import attention_ops as pattn
from paddle_tpu_torch.ops import registry as preg
from paddle_tpu_torch.ops.cuda import flash_attention as pfa
from paddle_tpu_torch.ops.cuda import mha_block as pmha

ATOL = 1e-5
BATCH, STEPS, LR = 4, 3, 1e-3


def _small(mod, s, dropout=0.0):
    return mod.BertConfig(vocab_size=64, hidden=128, layers_=2, heads=2,
                          ffn=256, max_positions=s, max_predictions=4,
                          dropout=dropout)


@pytest.fixture(autouse=True)
def _fresh_port():
    with testing.fresh_programs():
        yield
    for f in (jflags, pflags):
        f.reset("flash_attention")


# ------------------------------------------------------------ op lowerings


def _run(reg, backend, op_type, inputs, attrs, out_names):
    info = reg.get_runtime_info(op_type)
    if backend == "jax":
        ins = {p: [None if a is None else jnp.asarray(a) for a in v]
               for p, v in inputs.items()}
        outs = reg.run_forward(info, ins, dict(attrs), out_names=out_names)
        return {p: [None if o is None else np.asarray(o) for o in v]
                for p, v in outs.items()}
    ins = {p: [None if a is None else torch.as_tensor(np.array(a))
               for a in v] for p, v in inputs.items()}
    outs = reg.run_forward(info, ins, dict(attrs), out_names=out_names,
                           device=torch.device("cpu"))
    return {p: [None if o is None else o.numpy() for o in v]
            for p, v in outs.items()}


def _assert_same(op_type, inputs, attrs, out_names, dtypes=True):
    """Values at atol 1e-5, shapes equal and (for dtypes) the same kind:
    the JAX package narrows int64 to int32, so integers compare as one
    kind."""
    j = _run(jreg, "jax", op_type, inputs, attrs, out_names)
    p = _run(preg, "torch", op_type, inputs, attrs, out_names)
    assert sorted(p) == sorted(j), (sorted(p), sorted(j))
    for param in j:
        for a, b in zip(j[param], p[param], strict=True):
            assert (a is None) == (b is None), param
            if a is None:
                continue
            assert b.shape == a.shape, (param, b.shape, a.shape)
            if dtypes:
                assert (b.dtype == a.dtype
                        or b.dtype.kind == a.dtype.kind == "i"), \
                    (param, b.dtype, a.dtype)
            np.testing.assert_allclose(b.astype(np.float64),
                                       a.astype(np.float64), rtol=0,
                                       atol=ATOL, err_msg=f"{op_type}.{param}")
    return p


def _grad_case(op_type, fwd_inputs, attrs, diff, seed):
    """`<op_type>_grad` in both packages: forward inputs, forward outputs
    (from the JAX lowering) and a random cotangent per output; `diff` are
    the params whose grads are asked for."""
    rng = np.random.RandomState(seed)
    fwd = _run(jreg, "jax", op_type, fwd_inputs, attrs, {"Out": ["o"]})
    inputs = dict(fwd_inputs)
    inputs["Out"] = [v.astype(np.float32) for v in fwd["Out"]]
    inputs["Out@GRAD"] = [rng.standard_normal(v.shape).astype(np.float32)
                          for v in fwd["Out"]]
    out_names = {p + "@GRAD": [f"{p}@GRAD"] for p in diff}
    _assert_same(op_type + "_grad", inputs, attrs, out_names)


def _r(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("approximate", [False, True],
                         ids=["erf", "tanh_form"])
def test_gelu_and_its_grad(approximate):
    rng = np.random.RandomState(0)
    x = _r(rng, 3, 5, 16) * 2
    attrs = {"approximate": approximate}
    _assert_same("gelu", {"X": [x]}, attrs, {"Out": ["o"]})
    _grad_case("gelu", {"X": [x]}, attrs, ("X",), 1)


def test_tanh_and_its_out_based_grad():
    rng = np.random.RandomState(2)
    x = _r(rng, 4, 9) * 2
    _assert_same("tanh", {"X": [x]}, {}, {"Out": ["o"]})
    out = np.tanh(x)
    _assert_same("tanh_grad", {"Out": [out], "Out@GRAD": [_r(rng, 4, 9)]},
                 {}, {"X@GRAD": ["x@GRAD"]})
    # the grad op reads Out and dOut only
    op = _grad_maker_op("tanh")
    assert sorted(op["inputs"]) == ["Out", "Out@GRAD"]


def _grad_maker_op(op_type):
    main = pt.Program()
    blk = main.global_block()
    x = blk.create_var(name="x", shape=(2, 3), dtype="float32")
    out = blk.create_var(name="o", shape=(2, 3), dtype="float32")
    op = blk.append_op(type=op_type, inputs={"X": [x]},
                       outputs={"Out": [out]})
    (desc,) = preg.make_grad_ops(op, blk, set())
    return desc


@pytest.mark.parametrize("op_type", ["elementwise_mul", "elementwise_div"])
@pytest.mark.parametrize("y_shape,axis", [((3, 8), 1), ((8,), -1),
                                          ((2, 3, 8), -1), ((2, 1, 1), -1)],
                         ids=["axis1", "trailing", "same", "broadcast1"])
def test_mul_div_with_axis_and_grads(op_type, y_shape, axis):
    rng = np.random.RandomState(3)
    x = _r(rng, 2, 3, 8)
    y = _r(rng, *y_shape)
    if op_type == "elementwise_div":
        y = np.sign(y) * (np.abs(y) + 0.5)
    attrs = {"axis": axis}
    _assert_same(op_type, {"X": [x], "Y": [y]}, attrs, {"Out": ["o"]})
    _grad_case(op_type, {"X": [x], "Y": [y]}, attrs, ("X", "Y"), 4)


@pytest.mark.parametrize("op_type", ["elementwise_sub", "elementwise_pow",
                                     "elementwise_mod", "less_than",
                                     "less_equal", "greater_than",
                                     "greater_equal"])
def test_operator_overload_ops(op_type):
    """The other ops behind Variable's operators (math_op_patch)."""
    rng = np.random.RandomState(5)
    x = np.abs(_r(rng, 3, 4)) + 0.1
    y = _r(rng, 4)
    if op_type == "elementwise_pow":
        y = np.round(y * 2)
    _assert_same(op_type, {"X": [x], "Y": [y]}, {"axis": -1},
                 {"Out": ["o"]})


@pytest.mark.parametrize("xs,ys,tx,ty,alpha", [
    ((2, 3, 4), (2, 4, 5), False, False, 1.0),
    ((2, 4, 3), (2, 4, 5), True, False, 0.5),
    ((2, 3, 4), (2, 5, 4), False, True, 1.0),   # the tied MLM logits
    ((2, 4, 3), (5, 4), True, True, 2.0),
    ((4,), (4, 5), False, False, 1.0),          # 1-D promotions
    ((2, 3, 4), (4,), False, False, 1.0),
], ids=["plain", "tx_alpha", "ty", "both_broadcast", "vec_mat", "mat_vec"])
def test_matmul_flags_alpha_and_grad(xs, ys, tx, ty, alpha):
    rng = np.random.RandomState(6)
    inputs = {"X": [_r(rng, *xs)], "Y": [_r(rng, *ys)]}
    attrs = {"transpose_X": tx, "transpose_Y": ty, "alpha": alpha}
    _assert_same("matmul", inputs, attrs, {"Out": ["o"]})
    _grad_case("matmul", inputs, attrs, ("X", "Y"), 7)


def test_matmul_and_mul_promote_mixed_dtypes():
    """A float32 X against a bfloat16 Y (AMP's one-hot gather and loss
    head) promotes, and the product comes back in X's dtype, as
    jnp.matmul(x, y, preferred_element_type=x.dtype) does."""
    rng = np.random.RandomState(8)
    x = _r(rng, 2, 3, 16)
    y = _r(rng, 2, 16, 8)
    y16 = torch.as_tensor(y).to(torch.bfloat16)
    outs = preg.run_forward(preg.get_runtime_info("matmul"),
                            {"X": [torch.as_tensor(x)], "Y": [y16]}, {},
                            device=torch.device("cpu"))
    out = outs["Out"][0]
    assert out.dtype == torch.float32
    ref = np.asarray(jnp.matmul(jnp.asarray(x), jnp.asarray(y16.float()
                                                            .numpy(),
                                                            jnp.bfloat16),
                                preferred_element_type=jnp.float32))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=ATOL)
    outs = preg.run_forward(
        preg.get_runtime_info("mul"),
        {"X": [torch.as_tensor(x)], "Y": [y16[0]]},
        {"x_num_col_dims": 2, "y_num_col_dims": 1},
        device=torch.device("cpu"))
    assert outs["Out"][0].dtype == torch.float32


@pytest.mark.parametrize("attrs", [
    {"dim": [1], "keep_dim": False, "reduce_all": False},
    {"dim": [0, 2], "keep_dim": True, "reduce_all": False},
    {"dim": [0], "keep_dim": False, "reduce_all": True},
    {"dim": [0], "keep_dim": True, "reduce_all": True},
], ids=["dim1", "dims_keep", "all", "all_keep"])
def test_reduce_sum_and_grad(attrs):
    rng = np.random.RandomState(9)
    x = _r(rng, 3, 4, 5)
    _assert_same("reduce_sum", {"X": [x]}, attrs, {"Out": ["o"]})
    _grad_case("reduce_sum", {"X": [x]}, attrs, ("X",), 10)


def test_reduce_sum_keeps_int32_and_gives_shape_1_scalars():
    """bert.build sums cast(input_mask, int32) into the key lengths: the
    sum stays int32 (torch.sum would widen it to int64); a 1-D input
    reduced over its only dim is shape [1]."""
    mask = (np.arange(6)[None, :] < np.asarray([6, 2, 4])[:, None])
    p = _assert_same("reduce_sum", {"X": [mask.astype(np.int32)]},
                     {"dim": [1], "keep_dim": False, "reduce_all": False},
                     {"Out": ["o"]})
    assert p["Out"][0].dtype == np.int32
    np.testing.assert_array_equal(p["Out"][0], [6, 2, 4])
    p = _assert_same("reduce_sum", {"X": [np.arange(4, dtype=np.float32)]},
                     {"dim": [0], "keep_dim": False, "reduce_all": False},
                     {"Out": ["o"]})
    assert p["Out"][0].shape == (1,)


@pytest.mark.parametrize("ids_shape", [(2, 5, 1), (2, 5)],
                         ids=["trailing_one", "index_tensor"])
def test_one_hot_forms(ids_shape):
    rng = np.random.RandomState(11)
    ids = rng.randint(0, 7, size=ids_shape).astype(np.int64)
    ids.reshape(-1)[3] = 9                     # out of range: a zero row
    p = _assert_same("one_hot", {"X": [ids]}, {"depth": 7}, {"Out": ["o"]})
    assert p["Out"][0].dtype == np.float32
    assert not p["Out"][0].reshape(-1, 7)[3].any()


@pytest.mark.parametrize("axes,starts,ends", [
    ([1], [0], [1]),                   # BERT's [CLS] slice
    ([0, 2], [-2, 1], [10, -1]),       # negative and clamped bounds
    ([1], [-10], [-3]),
])
def test_slice_and_grad(axes, starts, ends):
    rng = np.random.RandomState(12)
    x = _r(rng, 3, 6, 5)
    attrs = {"axes": axes, "starts": starts, "ends": ends}
    _assert_same("slice", {"Input": [x]}, attrs, {"Out": ["o"]})
    rng2 = np.random.RandomState(13)
    fwd = _run(jreg, "jax", "slice", {"Input": [x]}, attrs, {"Out": ["o"]})
    g = rng2.standard_normal(fwd["Out"][0].shape).astype(np.float32)
    _assert_same("slice_grad", {"Input": [x], "Out": fwd["Out"],
                                "Out@GRAD": [g]}, attrs,
                 {"Input@GRAD": ["i@GRAD"]})


def test_fill_constant_batch_size_like_and_assign():
    x = np.zeros((5, 3), np.float32)
    _assert_same("fill_constant_batch_size_like", {"Input": [x]},
                 {"shape": [1, 7], "dtype": "float32", "value": 2.5,
                  "input_dim_idx": 0, "output_dim_idx": 0}, {"Out": ["o"]})
    _assert_same("assign", {"X": [x + 1]}, {}, {"Out": ["o"]})


def test_check_prefix_mask():
    good = (np.arange(6)[None, :] < np.asarray([6, 0, 3])[:, None]) \
        .astype(np.float32)
    p = _assert_same("check_prefix_mask", {"X": [good]}, {}, {"Out": ["o"]})
    np.testing.assert_array_equal(p["Out"][0], good)
    bad = good.copy()
    bad[2, 4] = 1.0          # a real token after padding in row 2
    bad[0, 2] = 0.0          # and a hole in row 0, named first
    for reg, backend in ((jreg, "jax"), (preg, "torch")):
        with pytest.raises(ValueError, match="input_mask row 0 is not a "
                                             "prefix mask"):
            _run(reg, backend, "check_prefix_mask", {"X": [bad]}, {},
                 {"Out": ["o"]})
    with pytest.raises(ValueError, match="row 1 "):   # bad's row 2
        _run(preg, "torch", "check_prefix_mask", {"X": [bad[1:]]}, {},
             {"Out": ["o"]})


def test_variable_operators_append_the_jax_ops():
    """`a / (b + 1e-6)`, `-a`, `a * 2`, `1 - a`, `a < b`: the same ops,
    attrs and var dtypes as the JAX package's patched Variable."""

    def build(pkg, guard):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup), guard():
            a = pkg.layers.data("a", shape=[4], dtype="float32")
            b = pkg.layers.data("b", shape=[4], dtype="float32")
            c = a / (b + 1e-6)
            d = 1.0 - (-c * 2.0)
            e = a < b
            f = (a - b) ** b
        return main, (c, d, e, f)

    jm, _ = build(fluid, jun.guard)
    pm, pvars = build(pt, pt.unique_name.guard)
    assert pm.to_dict() == jm.to_dict()
    assert [op.type for op in pm.global_block().ops] == [
        "scale", "elementwise_div", "scale", "scale",
        "fill_constant_batch_size_like", "elementwise_sub", "less_than",
        "elementwise_sub", "elementwise_pow"]
    feed = {"a": np.asarray([[1., 2., 3., 4.]], np.float32),
            "b": np.asarray([[2., 2., 1., 5.]], np.float32)}
    c, d, e, f = pt.Executor(pt.CPUPlace()).run(pm, feed=feed,
                                                fetch_list=list(pvars))
    a, b = feed["a"], feed["b"]
    np.testing.assert_allclose(c, a / (b + 1e-6), rtol=1e-6)
    np.testing.assert_allclose(d, 1.0 + 2.0 * c, rtol=1e-6)
    np.testing.assert_array_equal(e, a < b)
    np.testing.assert_allclose(f, (a - b) ** b, rtol=1e-6)


# --------------------------------------------------------------- programs


def _normalized(prog):
    """The program dict, with integer var dtypes read as one kind (the JAX
    package narrows int64 to int32 with x64 off)."""
    d = prog.to_dict()
    for blk in d["blocks"]:
        for v in blk["vars"]:
            if v["dtype"] in ("int32", "int64"):
                v["dtype"] = "int"
    return d


def _jax_build(s, use_amp, mask, dropout=0.0):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), jun.guard():
        loss = JB.build(_small(JB, s, dropout), use_input_mask=mask)[0]
        flipped = (jamp.cast_model_to_bf16(main, startup) if use_amp
                   else set())
        _, pg = fluid.optimizer.Adam(LR, multi_precision=use_amp).minimize(
            loss)
    return main, startup, loss, pg, flipped


def _port_build(s, use_amp, mask, dropout=0.0):
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        loss = PB.build(_small(PB, s, dropout), use_input_mask=mask)[0]
        flipped = (pamp.cast_model_to_bf16(main, startup) if use_amp
                   else set())
        _, pg = pt.optimizer.Adam(LR, multi_precision=use_amp).minimize(loss)
    return main, startup, loss, pg, flipped


@pytest.mark.parametrize("dropout", [0.0, 0.1], ids=["nodrop", "dropout"])
@pytest.mark.parametrize("use_amp", [False, True], ids=["f32", "amp"])
@pytest.mark.parametrize("mask", [False, True], ids=["unmasked", "masked"])
def test_bert_programs_are_identical(use_amp, mask, dropout):
    """After minimize: the same main and startup programs, op for op, var
    for var, the same (param, grad) pairs and the same AMP flips; at
    dropout 0.1 with every dropout and dropout_grad where the JAX package
    puts it."""
    jm, js, _, jpg, jflipped = _jax_build(128, use_amp, mask, dropout)
    pm, ps, _, ppg, pflipped = _port_build(128, use_amp, mask, dropout)
    n_drop = sum(op.type == "dropout" for op in pm.global_block().ops)
    assert n_drop == (5 if dropout else 0)
    for j, p in ((jm, pm), (js, ps)):
        jd, pd = _normalized(j), _normalized(p)
        jops, pops = jd["blocks"][0]["ops"], pd["blocks"][0]["ops"]
        assert [o["type"] for o in pops] == [o["type"] for o in jops]
        for jo, po in zip(jops, pops):
            assert po == jo, jo["type"]
        assert pd == jd
    assert [(p.name, g.name) for p, g in ppg] == \
        [(p.name, g.name) for p, g in jpg]
    assert pflipped == jflipped


def test_bert_base_op_census_and_unported_options():
    """BERT-base at 2048 tokens: 12 fused_attention ops and their grads;
    at its published dropout 0.1, 25 dropout ops (the embeddings, then the
    attention and FFN branches of 12 layers) and their grads; fused_head
    and MoE raise naming ROADMAP."""
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        loss = PB.build(PB.BertConfig(max_positions=2048, dropout=0.0),
                        use_input_mask=True)[0]
        pt.optimizer.Adam(1e-4).minimize(loss)
    types = [op.type for op in main.global_block().ops]
    assert types.count("fused_attention") == 12
    assert types.count("fused_attention_grad") == 12
    assert types.count("gelu") == 13 and types.count("tanh") == 1
    assert "dropout" not in types
    main = pt.Program()
    with pt.program_guard(main, pt.Program()), pt.unique_name.guard():
        loss = PB.build(PB.base())[0]
        pt.optimizer.Adam(1e-4).minimize(loss)
    types = [op.type for op in main.global_block().ops]
    assert types.count("dropout") == types.count("dropout_grad") == 25
    for cfg, kw in ((PB.BertConfig(dropout=0.0, moe_experts=4), {}),
                    (PB.BertConfig(dropout=0.0), {"fused_head": True})):
        with pt.program_guard(pt.Program(), pt.Program()), \
                pt.unique_name.guard():
            with pytest.raises(NotImplementedError, match="ROADMAP"):
                PB.build(cfg, **kw)


def test_synthetic_batch_matches():
    for mask in (False, True):
        j = JB.synthetic_batch(3, _small(JB, 64), seed=5,
                               use_input_mask=mask)
        p = PB.synthetic_batch(3, _small(PB, 64), seed=5,
                               use_input_mask=mask)
        assert sorted(p) == sorted(j)
        for name in j:
            np.testing.assert_array_equal(p[name], j[name])


# ------------------------------------------------------------- end to end


def _feed(s, mask):
    return JB.synthetic_batch(BATCH, _small(JB, s), seed=3,
                              use_input_mask=mask)


def _jax_train(s, mask, use_amp, steps, dropout=0.0):
    """The JAX package's startup persistables, per-step losses and the
    first step's param grads."""
    jflags.set("flash_attention", "interpret")
    try:
        main, startup, loss, pg, _ = _jax_build(s, use_amp, mask, dropout)
        scope = JScope()
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup, scope=scope)
        params = {v.name: np.asarray(scope.find_var(v.name))
                  for v in main.list_vars() if v.persistable}
        grads = [g.name for _, g in pg]
        losses, first = [], None
        for step in range(steps):
            outs = exe.run(main, feed=_feed(s, mask), scope=scope,
                           fetch_list=[loss.name] + (grads if not step
                                                     else []))
            losses.append(float(np.asarray(outs[0], np.float32).ravel()[0]))
            if not step:
                first = {n: np.asarray(o, np.float32)
                         for n, o in zip(grads, outs[1:])}
    finally:
        jflags.reset("flash_attention")
    return dict(params=params, losses=losses, grads=first)


def _port_train(jrun, s, mask, use_amp, steps, dropout=0.0):
    pflags.set("flash_attention", "interpret")
    main, _, loss, pg, _ = _port_build(s, use_amp, mask, dropout)
    scope = pt.Scope()
    convert.load_params(scope, jrun["params"], pt.CPUPlace(), [main])
    exe = pt.Executor(pt.CPUPlace())
    grads = [g.name for _, g in pg]
    losses, first = [], None
    pattn.TIER_CALLS.clear()
    counts = (pmha.launches, pmha.bwd_launches, pfa.launches,
              pfa.bwd_dq_launches, pfa.bwd_dkv_launches)
    for step in range(steps):
        outs = exe.run(main, feed=_feed(s, mask), scope=scope,
                       fetch_list=[loss] + (grads if not step else []))
        losses.append(float(outs[0].ravel()[0]))
        if not step:
            first = dict(zip(grads, outs[1:]))
    # on the CPU the wrappers run their plain versions and count nothing
    assert (pmha.launches, pmha.bwd_launches, pfa.launches,
            pfa.bwd_dq_launches, pfa.bwd_dkv_launches) == counts
    return dict(losses=losses, grads=first, tiers=dict(pattn.TIER_CALLS))


_E2E = {"s200_masked": (200, True), "s200": (200, False),
        "s128_masked": (128, True), "s128": (128, False)}


@pytest.fixture(scope="module", params=list(_E2E))
def jax_f32(request):
    s, mask = _E2E[request.param]
    return s, mask, _jax_train(s, mask, False, STEPS)


def test_bert_grads_and_adam_losses_match_jax(jax_f32):
    """One backward: every param@GRAD within rtol 1e-4 / atol 1e-5 of the
    JAX package's; three Adam steps: losses within rtol 2e-4.  Every
    attention took the tier the gate names for S (flash at 200, mha_block
    at 128)."""
    s, mask, ref = jax_f32
    port = _port_train(ref, s, mask, False, STEPS)
    tier = "flash" if s == 200 else "mha_block"
    assert port["tiers"] == {tier: STEPS * 2}
    assert sorted(port["grads"]) == sorted(ref["grads"])
    for name, want in ref["grads"].items():
        np.testing.assert_allclose(port["grads"][name], want, rtol=1e-4,
                                   atol=ATOL, err_msg=name)
    np.testing.assert_allclose(port["losses"], ref["losses"], rtol=2e-4)
    assert port["losses"][-1] < port["losses"][0]


def test_bert_dropout_training_matches_jax_with_carried_masks(monkeypatch):
    """At dropout 0.1 (S 128, masked), with both packages' dropout drawing
    the same masks (testing.seeded_dropout, keyed by each Mask var's
    name): every param@GRAD within rtol 1e-4 / atol 1e-5, three Adam
    losses within rtol 2e-4."""
    for reg, as_array in (
            (jreg, lambda k, x: jnp.asarray(k, dtype=x.dtype)),
            (preg, lambda k, x: torch.as_tensor(k).to(x.device, x.dtype))):
        info = reg.OPS["dropout"]
        monkeypatch.setattr(info, "forward",
                            testing.seeded_dropout(info.forward, as_array))
    ref = _jax_train(128, True, False, STEPS, dropout=0.1)
    port = _port_train(ref, 128, True, False, STEPS, dropout=0.1)
    assert sorted(port["grads"]) == sorted(ref["grads"])
    for name, want in ref["grads"].items():
        np.testing.assert_allclose(port["grads"][name], want, rtol=1e-4,
                                   atol=ATOL, err_msg=name)
    np.testing.assert_allclose(port["losses"], ref["losses"], rtol=2e-4)


def test_bert_amp_step_matches_jax():
    """bf16 AMP through the flash tier with ragged masks: the float32
    one-hot gather and loss head run as in the JAX package, and the step-1
    loss is within 2e-2 relative."""
    ref = _jax_train(200, True, True, 1)
    port = _port_train(ref, 200, True, True, 1)
    assert port["tiers"] == {"flash": 2}
    assert abs(port["losses"][0] - ref["losses"][0]) <= \
        2e-2 * abs(ref["losses"][0])
