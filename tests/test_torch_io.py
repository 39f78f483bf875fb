"""Saving and loading (paddle_tpu_torch/io.py, ops/io_ops.py,
Program.from_dict) against the JAX package (paddle_tpu/io.py,
paddle_tpu/ops/io_ops.py, Program.from_dict).

The two packages write the same bytes: a single-var file (magic,
`np.save`, the pickled dtype name; bfloat16 as its uint16 bits) and a
combined `np.savez` archive (bfloat16 under `__bf16__<name>`), for
float32, int64 and bfloat16 arrays; each package reads the other's files
to equal values and dtypes.  `save_inference_model` writes the same
`__model__` and parameter files in both, and a model saved by either
package loads in the other and computes the same outputs (rtol 1e-5, the
float32 products of a CPU run).  `Program.from_dict` inverts `to_dict` on
every model builder of the port (with its optimizer) and on the 11
programs the JAX package serialized under `tests/book/_programs/`, and
the book's MLP inference program, run by the port from the JAX startup's
weights, gives the JAX package's outputs (rtol 1e-5).
"""

import filecmp
import json
import os
import pathlib

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as fluid
from paddle_tpu import inference as jinference
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.framework.scope import Scope as JScope
from paddle_tpu.framework.scope import scope_guard as jscope_guard
from paddle_tpu.ops import io_ops as jio
from paddle_tpu.ops import registry as jreg
import paddle_tpu_torch as pt
from paddle_tpu_torch import convert, inference, testing
from paddle_tpu_torch.ops import io_ops as pio
from paddle_tpu_torch.ops import registry as preg
from port_models import BUILDERS

BOOK = pathlib.Path(__file__).parent / "book" / "_programs"
DTYPES = ("float32", "int64", "bfloat16")


@pytest.fixture(autouse=True)
def _fresh_port():
    with testing.fresh_programs():
        yield


def _array(dtype, seed=0, shape=(3, 5)):
    rng = np.random.RandomState(seed)
    if dtype == "int64":
        return rng.randint(-2 ** 40, 2 ** 40, shape).astype(np.int64)
    a = rng.standard_normal(shape).astype(np.float32)
    return a.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else a


def _as_port_tensor(arr):
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def _port_as_numpy(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _assert_same_array(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("dtype", DTYPES)
def test_single_var_files_are_identical_and_cross_load(tmp_path, dtype):
    arr = _array(dtype)
    jpath, ppath = tmp_path / "j", tmp_path / "p"
    jio.save_array(str(jpath), arr)
    pio.save_array(str(ppath), _as_port_tensor(arr))
    assert jpath.read_bytes() == ppath.read_bytes()
    # the port also takes a numpy array (a bfloat16 one included)
    pio.save_array(str(tmp_path / "pn"), arr)
    assert (tmp_path / "pn").read_bytes() == jpath.read_bytes()
    _assert_same_array(_port_as_numpy(pio.load_array(str(jpath))), arr)
    _assert_same_array(jio.load_array(str(ppath)), arr)


@pytest.mark.parametrize("dtype", DTYPES)
def test_combined_files_are_identical_and_cross_load(tmp_path, dtype):
    arrs = [_array(dtype, seed=i, shape=(2 + i, 3)) for i in range(3)]
    names = ["a", "b.w_0", "c@x"]
    attrs = {"var_names": names}
    jpath, ppath = str(tmp_path / "j.npz"), str(tmp_path / "p.npz")
    jreg.run_forward(jreg.OPS["save_combine"], {"X": arrs},
                     dict(attrs, file_path=jpath))
    preg.run_forward(preg.OPS["save_combine"],
                     {"X": [_as_port_tensor(a) for a in arrs]},
                     dict(attrs, file_path=ppath), device=torch.device("cpu"))
    assert filecmp.cmp(jpath, ppath, shallow=False)
    pouts = preg.run_forward(preg.OPS["load_combine"], {},
                             dict(attrs, file_path=jpath),
                             device=torch.device("cpu"))["Out"]
    jouts = jreg.run_forward(jreg.OPS["load_combine"], {},
                             dict(attrs, file_path=ppath))["Out"]
    for a, p, j in zip(arrs, pouts, jouts):
        _assert_same_array(_port_as_numpy(p), a)
        # the JAX package narrows int64 to int32 with x64 off
        want = a.astype(np.int32) if dtype == "int64" else a
        _assert_same_array(np.asarray(j), want)


def test_save_and_load_ops_through_executors(tmp_path):
    """save_persistables by the port's Executor, load_persistables by the
    JAX package's and back: per var and combined, float32 and bf16 vars."""
    def build(pkg):
        main = pkg.Program()
        blk = main.global_block()
        for name, dtype in (("w", "float32"), ("h", "bfloat16")):
            blk.create_var(name=name, shape=(3, 4), dtype=dtype,
                           persistable=True)
        return main

    values = {"w": _array("float32", 1, (3, 4)),
              "h": _array("bfloat16", 2, (3, 4))}
    pmain, jmain = build(pt), build(fluid)
    pscope = pt.Scope()
    for n, v in values.items():
        pscope.set_var(n, _as_port_tensor(v))
    for filename in (None, "params"):
        pdir, jdir = str(tmp_path / f"p{filename}"), str(tmp_path /
                                                         f"j{filename}")
        with pt.scope_guard(pscope):
            pt.io.save_persistables(pt.Executor(pt.CPUPlace()), pdir, pmain,
                                    filename)
        jscope = JScope()
        with jscope_guard(jscope):
            exe = fluid.Executor(fluid.CPUPlace())
            fluid.io.load_persistables(exe, pdir, jmain, filename)
            fluid.io.save_persistables(exe, jdir, jmain, filename)
        for n, v in values.items():
            _assert_same_array(np.asarray(jscope.find_var(n)), v)
        assert sorted(os.listdir(pdir)) == sorted(os.listdir(jdir))
        for f in os.listdir(pdir):
            assert filecmp.cmp(os.path.join(pdir, f), os.path.join(jdir, f),
                               shallow=False), f
        back = pt.Scope()
        with pt.scope_guard(back):
            pt.io.load_persistables(pt.Executor(pt.CPUPlace()), jdir, pmain,
                                    filename)
        for n, v in values.items():
            _assert_same_array(_port_as_numpy(back.find_var(n)), v)


# ---------------------------------------------------------------------------
# the inference model, across the packages
# ---------------------------------------------------------------------------


def _mlp(pkg, guard):
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 3
    with pkg.program_guard(main, startup), guard():
        x = pkg.layers.data(name="x", shape=[6], dtype="float32")
        h = pkg.layers.fc(input=x, size=8, act="relu", param_attr="pw0")
        out = pkg.layers.fc(input=h, size=3, act="softmax", param_attr="pw1")
    return main, startup, out


@pytest.fixture
def saved_both(tmp_path):
    """The same MLP saved by each package from the JAX startup's weights:
    (JAX dir, port dir, weights), per params_filename."""
    jm, js, jout = _mlp(fluid, jun.guard)
    pm, _, pout = _mlp(pt, pt.unique_name.guard)
    assert pm.to_dict() == jm.to_dict()
    jscope = JScope()
    dirs = {}
    with jscope_guard(jscope):
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(js)
        for fn in (None, "params"):
            dirs[("jax", fn)] = str(tmp_path / f"jax_{fn}")
            fluid.io.save_inference_model(dirs[("jax", fn)], ["x"], [jout],
                                          exe, main_program=jm,
                                          params_filename=fn)
    weights = {v.name: np.asarray(jscope.find_var(v.name))
               for v in jm.list_vars() if v.persistable}
    pscope = pt.Scope()
    convert.load_params(pscope, weights, pt.CPUPlace(), [pm])
    with pt.scope_guard(pscope):
        exe = pt.Executor(pt.CPUPlace())
        for fn in (None, "params"):
            dirs[("port", fn)] = str(tmp_path / f"port_{fn}")
            pt.io.save_inference_model(dirs[("port", fn)], ["x"], [pout],
                                       exe, main_program=pm,
                                       params_filename=fn)
    return dirs, weights


@pytest.mark.parametrize("params_filename", [None, "params"])
def test_inference_model_files_are_identical(saved_both, params_filename):
    dirs, _ = saved_both
    jdir, pdir = dirs[("jax", params_filename)], dirs[("port",
                                                       params_filename)]
    files = sorted(os.listdir(jdir))
    assert files == sorted(os.listdir(pdir))
    assert "__model__" in files
    for f in files:
        assert filecmp.cmp(os.path.join(jdir, f), os.path.join(pdir, f),
                           shallow=False), f


@pytest.mark.parametrize("saved_by", ["jax", "port"])
@pytest.mark.parametrize("params_filename", [None, "params"])
def test_each_package_serves_the_others_model(saved_both, saved_by,
                                              params_filename):
    """load_inference_model by the other package: the same program dict,
    the same weights, and the same outputs (rtol 1e-5)."""
    dirs, weights = saved_both
    d = dirs[(saved_by, params_filename)]
    pprog, pfeeds, pfetch = pt.io.load_inference_model(
        d, pt.Executor(pt.CPUPlace()), params_filename=params_filename)
    pscope = pt.global_scope()
    jscope = JScope()
    with jscope_guard(jscope):
        jexe = fluid.Executor(fluid.CPUPlace())
        jprog, jfeeds, jfetch = fluid.io.load_inference_model(
            d, jexe, params_filename=params_filename)
    assert pprog.to_dict() == jprog.to_dict()
    assert pfeeds == jfeeds == ["x"]
    assert [v.name for v in pfetch] == [v.name for v in jfetch]
    for n, w in weights.items():
        if pprog.global_block().has_var(n):
            _assert_same_array(pscope.find_var(n).numpy(), w)
    feed = {"x": np.random.RandomState(1).rand(4, 6).astype(np.float32)}
    (got,) = pt.Executor(pt.CPUPlace()).run(pprog, feed=feed,
                                            fetch_list=pfetch)
    (want,) = jexe.run(jprog, feed=feed, fetch_list=[v.name for v in jfetch],
                       scope=jscope)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-7)
    if params_filename is not None:
        return   # a Predictor reads per-var files (Config has no filename)
    # and through each package's Predictor
    (pgot,) = inference.create_predictor(
        inference.Config(d, place=pt.CPUPlace())).run(feed)
    (jgot,) = jinference.create_predictor(jinference.Config(d)).run(feed)
    np.testing.assert_allclose(pgot, np.asarray(jgot), rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# Program.from_dict
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model", sorted(BUILDERS))
def test_from_dict_inverts_to_dict_on_every_model(model):
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        loss, opt = BUILDERS[model]()
        opt.minimize(loss)
    for prog in (main, startup, main.clone(for_test=True)):
        d = prog.to_dict()
        back = pt.Program.from_dict(d)
        assert back.to_dict() == d
        # parameters come back as Parameters, with their trainable flag
        for v in prog.list_vars():
            w = back.global_block().var(v.name)
            assert type(w) is type(v) and w.persistable == v.persistable
            assert getattr(w, "trainable", None) == getattr(v, "trainable",
                                                            None)


@pytest.mark.parametrize("name", sorted(p.name for p in BOOK.glob("*.json")))
def test_from_dict_inverts_the_book_programs(name):
    d = json.loads((BOOK / name).read_text())
    back = pt.Program.from_dict(d)
    assert back.to_dict() == d
    assert back.to_dict() == fluid.Program.from_dict(d).to_dict()
    # BLOCK attrs resolve to the program's own blocks
    for blk in back.blocks:
        for op in blk.ops:
            for v in op.attrs.values():
                if isinstance(v, pt.Block):
                    assert v is back.block(v.idx)


def test_book_program_side_tables_survive():
    d = json.loads((BOOK / "fit_a_line.infer.json").read_text())
    d = dict(d, memory_opt_removed={"a": "b"}, reuse_plan={"x": "y"})
    assert pt.Program.from_dict(d).to_dict() == d


def test_book_mlp_inference_program_matches_jax():
    """recognize_digits_mlp.infer.json through both packages: the JAX
    startup (its own JSON) seeds the weights, the port runs the same
    program on them."""
    infer = json.loads((BOOK / "recognize_digits_mlp.infer.json").read_text())
    startup = json.loads(
        (BOOK / "recognize_digits_mlp.startup.json").read_text())
    jscope = JScope()
    jexe = fluid.Executor(fluid.CPUPlace())
    jexe.run(fluid.Program.from_dict(startup), scope=jscope)
    jprog = fluid.Program.from_dict(infer)
    pprog = pt.Program.from_dict(infer)
    rng = np.random.RandomState(5)
    feed = {"img": rng.rand(4, 784).astype(np.float32),
            "label": rng.randint(0, 10, (4, 1)).astype(np.int64)}
    fetch = ["fc_3.tmp_2", "mean_1.tmp_0"]
    want = jexe.run(jprog, feed=feed, fetch_list=fetch, scope=jscope)
    pscope = pt.Scope()
    for v in pprog.list_vars():
        value = jscope.find_var(v.name)
        if v.persistable and value is not None:
            pscope.set_var(v.name, torch.as_tensor(np.asarray(value)))
    got = pt.Executor(pt.CPUPlace()).run(pprog, feed=feed, fetch_list=fetch,
                                         scope=pscope)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-7)


def test_load_places_tensors_on_the_executors_device(tmp_path):
    """`load` and `load_combine` put the tensor where the Executor runs
    (the CPU here; the card test checks a bf16 file onto the card)."""
    arr = _array("float32")
    pio.save_array(str(tmp_path / "v"), torch.from_numpy(arr))
    out = preg.run_forward(preg.OPS["load"], {},
                           {"file_path": str(tmp_path / "v")},
                           device=torch.device("meta"))["Out"][0]
    assert out.device.type == "meta" and out.shape == arr.shape
    with pytest.raises(ValueError, match="not a paddle_tpu tensor file"):
        (tmp_path / "bad").write_bytes(b"garbage!")
        pio.load_array(str(tmp_path / "bad"))


def test_jnp_scope_values_save_as_the_port_saves(tmp_path):
    """A JAX scope's bf16 array and the port's bf16 tensor of the same
    bits write the same file (the AMP weights of a saved model)."""
    arr = _array("bfloat16", seed=4)
    jio.save_array(str(tmp_path / "j"), jnp.asarray(arr))
    pio.save_array(str(tmp_path / "p"), _as_port_tensor(arr))
    assert (tmp_path / "j").read_bytes() == (tmp_path / "p").read_bytes()
