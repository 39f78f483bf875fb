"""The loss tail, the metric ops, metrics.py and evaluator.py against the
JAX package.

- The eight loss ops and the four metric ops through both registries on
  the JAX package's own OpTest inputs (tests/test_ops_misc_tail.py,
  test_metric_ops.py) and seeded ones: float32 at atol 1e-5, counts
  exact, auc's float64 AUC at 1e-6 of the JAX package's float32 one.
- The losses' grads through both packages' `append_backward` (rtol 1e-4
  / atol 1e-5).
- `layers.auc`, `layers.chunk_eval` and `layers.smooth_l1` build the
  JAX package's programs; `layers.auc` streams batches through the
  port's Executor: its int64 stat vars equal the JAX package's counts
  exactly and its AUC equals `metrics.Auc` fed the same batches within
  1e-6.
- `metrics` and `evaluator`: each metric the JAX package's on the same
  streams.
"""

import numpy as np
import pytest

import paddle_tpu as fluid
import paddle_tpu.evaluator as jevaluator
import paddle_tpu.metrics as jmetrics
import paddle_tpu_torch as pt
import paddle_tpu_torch.evaluator as pevaluator
import paddle_tpu_torch.metrics as pmetrics
import test_metric_ops as jmetric_ops
import test_ops_misc_tail as jmisc
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.framework.scope import Scope as JScope
from paddle_tpu_torch import testing
from torch_op_parity import (
    assert_forward,
    assert_grads,
    assert_same_program,
    optest_case,
)


@pytest.fixture(autouse=True)
def _fresh_port():
    with testing.fresh_programs():
        yield


_R = np.random.RandomState(3)


def _f32(*shape, lo=-2.0, hi=2.0):
    return _R.uniform(lo, hi, shape).astype(np.float32)


X, Y = _f32(6, 5), _f32(6, 5)
PROB = _f32(6, 1, lo=0.05, hi=0.95)
LAB01 = _R.randint(0, 2, (6, 1)).astype(np.float32)
SIGN = (2.0 * _R.randint(0, 2, (6, 1)) - 1.0).astype(np.float32)
TARGET = np.where(_R.rand(6, 5) < 0.3, 0.0, _R.rand(6, 5)).astype(np.float32)

OPTESTS = {
    "huber_loss": jmisc.TestHuberLoss, "log_loss": jmisc.TestLogLoss,
    "hinge_loss": jmisc.TestHingeLoss, "rank_loss": jmisc.TestRankLoss,
    "margin_rank_loss": jmisc.TestMarginRankLoss,
    "kldiv_loss": jmisc.TestKLDivLossMean, "mse_loss": jmisc.TestMseLoss,
    "chunk_eval_IOB": jmetric_ops.TestChunkEvalIOB,
    "chunk_eval_IOE": jmetric_ops.TestChunkEvalIOE,
    "chunk_eval_IOBES": jmetric_ops.TestChunkEvalIOBES,
    "chunk_eval_plain": jmetric_ops.TestChunkEvalPlain,
    "chunk_eval_excluded": jmetric_ops.TestChunkEvalExcluded,
    "chunk_eval_exact": jmetric_ops.TestChunkEvalExactMatch,
    "precision_recall": jmetric_ops.TestPrecisionRecall,
    "precision_recall_no_weights": jmetric_ops.TestPrecisionRecallNoWeights,
    "positive_negative_pair": jmetric_ops.TestPositiveNegativePair,
}


@pytest.mark.parametrize("case", sorted(OPTESTS))
def test_optest_cases_match_jax(case):
    cls = OPTESTS[case]
    inputs, attrs = optest_case(cls)
    assert_forward(cls.op_type, inputs, attrs)


FORWARD = {
    "smooth_l1": ("smooth_l1_loss", {"X": [X], "Y": [Y]}, {"sigma": 1.5}),
    "smooth_l1_weights": ("smooth_l1_loss",
                          {"X": [X], "Y": [Y], "InsideWeight": [_f32(6, 5)],
                           "OutsideWeight": [_f32(6, 5)]}, {"sigma": 0.7}),
    "kldiv_sum": ("kldiv_loss", {"X": [X], "Target": [TARGET]},
                  {"reduction": "sum"}),
    "kldiv_batchmean": ("kldiv_loss", {"X": [X], "Target": [TARGET]},
                        {"reduction": "batchmean"}),
    "kldiv_none": ("kldiv_loss", {"X": [X], "Target": [TARGET]},
                   {"reduction": "none"}),
    "chunk_eval_no_seqlen": (
        "chunk_eval", {"Inference": [_R.randint(0, 7, (3, 9))],
                       "Label": [_R.randint(0, 7, (3, 9))]},
        {"chunk_scheme": "IOB", "num_chunk_types": 3}),
    "positive_negative_pair_bare": (
        "positive_negative_pair",
        {"Score": [_f32(20, 2)],
         "Label": [_R.randint(0, 3, (20, 1)).astype(np.float32)],
         "QueryID": [_R.randint(0, 3, (20, 1)).astype(np.int64)]},
        {"column": 0}),
}


@pytest.mark.parametrize("case", sorted(FORWARD))
def test_forward_matches_jax(case):
    assert_forward(*FORWARD[case])


def test_auc_op_matches_jax():
    """Stat vars in, their updated counts out (exact), and the AUC (the
    JAX package's float32 against the port's float64)."""
    n, nt = 200, 63
    p1 = _R.rand(n).astype(np.float32)
    predict = np.stack([1.0 - p1, p1], 1)
    label = (_R.rand(n, 1) < p1[:, None]).astype(np.int64)
    pos = _R.randint(0, 5, nt + 1).astype(np.int64)
    neg = _R.randint(0, 5, nt + 1).astype(np.int64)
    j, p = assert_forward("auc", {"Predict": [predict], "Label": [label],
                                  "StatPos": [pos], "StatNeg": [neg]},
                          {"num_thresholds": nt}, atol=1e-6)
    assert p["AUC"][0].dtype == np.float64
    assert p["StatPosOut"][0].dtype == np.int64


# id -> (op type, inputs, attrs, differentiable inputs, {output: count})
GRADS = {
    "smooth_l1": ("smooth_l1_loss",
                  {"X": [X], "Y": [Y], "InsideWeight": [_f32(6, 5)],
                   "OutsideWeight": [_f32(6, 5)]}, {"sigma": 1.2},
                  ["X", "Y"], {"Out": 1}),
    "huber": ("huber_loss", {"X": [X], "Y": [Y]}, {"delta": 0.8},
              ["X", "Y"], {"Out": 1}),
    "log_loss": ("log_loss", {"Predicted": [PROB], "Labels": [LAB01]},
                 {"epsilon": 1e-4}, ["Predicted"], {"Loss": 1}),
    "hinge": ("hinge_loss", {"Logits": [_f32(6, 1)], "Labels": [LAB01]}, {},
              ["Logits"], {"Loss": 1}),
    "rank": ("rank_loss", {"Label": [LAB01], "Left": [_f32(6, 1)],
                           "Right": [_f32(6, 1)]}, {}, ["Left", "Right"],
             {"Out": 1}),
    "margin_rank": ("margin_rank_loss",
                    {"Label": [SIGN], "X1": [_f32(6, 1)], "X2": [_f32(6, 1)]},
                    {"margin": 0.3}, ["X1", "X2"], {"Out": 1}),
    "mse": ("mse_loss", {"X": [X], "Y": [Y]}, {}, ["X", "Y"], {"Out": 1}),
    "kldiv": ("kldiv_loss", {"X": [X], "Target": [TARGET]},
              {"reduction": "batchmean"}, ["X"], {"Loss": 1}),
}


@pytest.mark.parametrize("case", sorted(GRADS))
def test_grads_match_jax(case):
    op_type, inputs, attrs, diff, outs = GRADS[case]
    assert_grads(op_type, inputs, attrs, diff, outs, seed=len(case))


# ------------------------------------------------------- the metric layers


def _metric_program(pkg, guard, nt):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup), guard():
        pred = pkg.layers.data(name="pred", shape=[2], dtype="float32")
        label = pkg.layers.data(name="label", shape=[1], dtype="int64")
        auc, stats = pkg.layers.auc(pred, label, num_thresholds=nt)
        inf = pkg.layers.data(name="inf", shape=[12], dtype="int64")
        lab = pkg.layers.data(name="lab", shape=[12], dtype="int64")
        lens = pkg.layers.data(name="lens", shape=[], dtype="int64")
        chunks = pkg.layers.chunk_eval(inf, lab, "IOBES", 2, seq_len=lens)
        x = pkg.layers.data(name="x", shape=[5], dtype="float32")
        y = pkg.layers.data(name="y", shape=[5], dtype="float32")
        sl1 = pkg.layers.smooth_l1(x, y, sigma=2.0)
    return main, startup, [auc] + stats + list(chunks) + [sl1]


def test_metric_layers_stream_as_the_jax_package():
    nt, batches = 255, 4
    jm, js, jfetch = _metric_program(fluid, jun.guard, nt)
    pm, ps, pfetch = _metric_program(pt, pt.unique_name.guard, nt)
    assert_same_program(jm, pm)
    assert_same_program(js, ps)
    assert pm.global_block().var(pfetch[1].name).dtype == "int64"
    assert pm.global_block().var(pfetch[1].name).persistable
    jscope, pscope = JScope(), pt.Scope()
    jexe = fluid.Executor(fluid.CPUPlace())
    pexe = pt.Executor(pt.CPUPlace())
    jexe.run(js, scope=jscope)
    pexe.run(ps, scope=pscope)
    host = pmetrics.Auc(num_thresholds=nt)
    chunk_metric = pmetrics.ChunkEvaluator()
    for b in range(batches):
        rng = np.random.RandomState(b)
        p1 = rng.rand(64).astype(np.float32)
        feed = {"pred": np.stack([1.0 - p1, p1], 1),
                "label": (rng.rand(64, 1) < p1[:, None]).astype(np.int64),
                "inf": rng.randint(0, 9, (4, 12)).astype(np.int64),
                "lab": rng.randint(0, 9, (4, 12)).astype(np.int64),
                "lens": rng.randint(1, 13, (4,)).astype(np.int64),
                "x": rng.standard_normal((3, 5)).astype(np.float32),
                "y": rng.standard_normal((3, 5)).astype(np.float32)}
        want = jexe.run(jm, feed=feed, fetch_list=[v.name for v in jfetch],
                        scope=jscope)
        got = pexe.run(pm, feed=feed, fetch_list=[v.name for v in pfetch],
                       scope=pscope)
        host.update(feed["pred"], feed["label"])
        chunk_metric.update(*got[6:9])
        np.testing.assert_array_equal(got[1], np.asarray(want[1]))
        np.testing.assert_array_equal(got[2], np.asarray(want[2]))
        np.testing.assert_allclose(got[0], np.asarray(want[0]), atol=1e-6)
        assert abs(float(got[0][0]) - host.eval()) < 1e-6
        for g, w in zip(got[3:9], want[3:9]):
            np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-6)
        np.testing.assert_allclose(got[9], np.asarray(want[9]), atol=1e-5)
    np.testing.assert_array_equal(got[1], host._stat_pos)
    np.testing.assert_array_equal(got[2], host._stat_neg)
    assert chunk_metric.num_infer_chunks > 0


# ----------------------------------------------------- metrics, evaluator


def _streams(seed):
    rng = np.random.RandomState(seed)
    return [(rng.rand(32, 2).astype(np.float32),
             rng.randint(0, 2, (32, 1)).astype(np.int64)) for _ in range(3)]


@pytest.mark.parametrize("name", ["Precision", "Recall", "Auc",
                                  "Accuracy", "ChunkEvaluator",
                                  "EditDistance", "DetectionMAP",
                                  "CompositeMetric"])
def test_metrics_match_jax(name):
    mine, theirs = getattr(pmetrics, name)(), getattr(jmetrics, name)()
    if name == "CompositeMetric":
        for m in (mine, theirs):
            mod = pmetrics if m is mine else jmetrics
            m.add_metric(mod.Precision())
            m.add_metric(mod.Recall())
    for i, (pred, lab) in enumerate(_streams(len(name))):
        for m in (mine, theirs):
            if name in ("Precision", "Recall", "CompositeMetric"):
                m.update(pred[:, 1], lab)
            elif name == "Auc":
                m.update(pred, lab)
            elif name in ("Accuracy", "DetectionMAP"):
                m.update(np.array([pred[0, 0]]), 3 + i)
            elif name == "ChunkEvaluator":
                m.update(np.array([7 + i]), np.array([9]), np.array([4 + i]))
            else:
                m.update(np.round(pred[:, 0] * 3), 32)
    assert mine.eval() == theirs.eval()
    mine.reset()
    theirs.reset()
    if name not in ("Accuracy", "EditDistance", "DetectionMAP"):
        assert mine.eval() == theirs.eval()


def test_evaluator_shims_match_jax():
    for name in ("ChunkEvaluator", "EditDistance"):
        mine, theirs = getattr(pevaluator, name)(), getattr(jevaluator,
                                                            name)()
        args = (([np.array([5]), np.array([6]), np.array([3])],
                 [np.array([2]), np.array([4]), np.array([2])])
                if name == "ChunkEvaluator"
                else ([np.array([0.0, 2.0, 1.0]), 3],
                      [np.array([1.0, 0.0]), 2]))
        for a in args:
            mine.update(*a)
            theirs.update(*a)
        assert mine.eval() == theirs.eval()
        with pytest.raises(NotImplementedError):
            getattr(pevaluator, name)(input=object())
    with pytest.raises(NotImplementedError):
        pevaluator.Evaluator().eval()
