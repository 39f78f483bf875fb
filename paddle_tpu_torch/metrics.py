"""Host-side streaming metrics (the JAX package's paddle_tpu/metrics.py,
reference python/paddle/fluid/metrics.py :53-542): MetricBase,
CompositeMetric, Precision, Recall, Accuracy, ChunkEvaluator,
EditDistance, Auc, DetectionMAP.  They accumulate numpy values across
batches on the host, apart from the in-graph metric ops (layers.accuracy,
layers.auc, layers.chunk_eval); fetched tensors and arrays both feed
them.
"""

from __future__ import annotations

import numpy as np


class MetricBase:
    def __init__(self, name=None):
        self._name = name or self.__class__.__name__

    def reset(self):
        for attr, value in self.__dict__.items():
            if attr.startswith("_"):
                continue
            if isinstance(value, (int, float)):
                setattr(self, attr, 0 if isinstance(value, int) else 0.0)
            elif isinstance(value, np.ndarray):
                setattr(self, attr, np.zeros_like(value))

    def update(self, *args, **kwargs):
        raise NotImplementedError

    def eval(self):
        raise NotImplementedError


class CompositeMetric(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self._metrics = []

    def add_metric(self, metric):
        self._metrics.append(metric)

    def update(self, preds, labels):
        for m in self._metrics:
            m.update(preds, labels)

    def eval(self):
        return [m.eval() for m in self._metrics]


class Precision(MetricBase):
    """binary precision (reference metrics.py:53)"""

    def __init__(self, name=None):
        super().__init__(name)
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        preds = np.rint(np.asarray(preds)).astype("int32").reshape(-1)
        labels = np.asarray(labels).astype("int32").reshape(-1)
        self.tp += int(np.sum((preds == 1) & (labels == 1)))
        self.fp += int(np.sum((preds == 1) & (labels == 0)))

    def eval(self):
        ap = self.tp + self.fp
        return float(self.tp) / ap if ap != 0 else 0.0


class Recall(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        preds = np.rint(np.asarray(preds)).astype("int32").reshape(-1)
        labels = np.asarray(labels).astype("int32").reshape(-1)
        self.tp += int(np.sum((preds == 1) & (labels == 1)))
        self.fn += int(np.sum((preds == 0) & (labels == 1)))

    def eval(self):
        recall = self.tp + self.fn
        return float(self.tp) / recall if recall != 0 else 0.0


class Accuracy(MetricBase):
    """weighted streaming accuracy (reference metrics.py Accuracy)"""

    def __init__(self, name=None):
        super().__init__(name)
        self.value = 0.0
        self.weight = 0.0

    def update(self, value, weight):
        self.value += float(np.asarray(value).reshape(-1)[0]) * weight
        self.weight += weight

    def eval(self):
        if self.weight == 0:
            raise ValueError("Accuracy has no data; call update first")
        return self.value / self.weight


class ChunkEvaluator(MetricBase):
    """F1 over chunk counts (reference metrics.py ChunkEvaluator)"""

    def __init__(self, name=None):
        super().__init__(name)
        self.num_infer_chunks = 0
        self.num_label_chunks = 0
        self.num_correct_chunks = 0

    def update(self, num_infer_chunks, num_label_chunks, num_correct_chunks):
        self.num_infer_chunks += int(np.asarray(num_infer_chunks).reshape(-1)[0])
        self.num_label_chunks += int(np.asarray(num_label_chunks).reshape(-1)[0])
        self.num_correct_chunks += int(np.asarray(num_correct_chunks).reshape(-1)[0])

    def eval(self):
        precision = (
            float(self.num_correct_chunks) / self.num_infer_chunks
            if self.num_infer_chunks
            else 0.0
        )
        recall = (
            float(self.num_correct_chunks) / self.num_label_chunks
            if self.num_label_chunks
            else 0.0
        )
        f1 = (
            2 * precision * recall / (precision + recall)
            if self.num_correct_chunks
            else 0.0
        )
        return precision, recall, f1


class EditDistance(MetricBase):
    """reference metrics.py EditDistance"""

    def __init__(self, name=None):
        super().__init__(name)
        self.total_distance = 0.0
        self.seq_num = 0
        self.instance_error = 0

    def update(self, distances, seq_num):
        distances = np.asarray(distances)
        self.instance_error += int(np.sum(distances != 0))
        self.total_distance += float(np.sum(distances))
        self.seq_num += int(seq_num)

    def eval(self):
        if self.seq_num == 0:
            raise ValueError("EditDistance has no data")
        avg_distance = self.total_distance / self.seq_num
        avg_instance_error = self.instance_error / float(self.seq_num)
        return avg_distance, avg_instance_error


class Auc(MetricBase):
    """streaming AUC on the host (reference metrics.py Auc)"""

    def __init__(self, name=None, curve="ROC", num_thresholds=4095):
        super().__init__(name)
        self._curve = curve
        self._num_thresholds = num_thresholds
        self._stat_pos = np.zeros(num_thresholds + 1, dtype="int64")
        self._stat_neg = np.zeros(num_thresholds + 1, dtype="int64")

    def update(self, preds, labels):
        preds = np.asarray(preds)
        labels = np.asarray(labels).reshape(-1)
        pos_prob = preds[:, 1] if preds.ndim == 2 else preds.reshape(-1)
        idx = np.clip(
            (pos_prob * self._num_thresholds).astype("int64"), 0, self._num_thresholds
        )
        for i, lab in zip(idx, labels):
            if lab:
                self._stat_pos[i] += 1
            else:
                self._stat_neg[i] += 1

    def eval(self):
        tot_pos = float(self._stat_pos.sum())
        tot_neg = float(self._stat_neg.sum())
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        tp = np.cumsum(self._stat_pos[::-1]).astype("float64")
        fp = np.cumsum(self._stat_neg[::-1]).astype("float64")
        tp_prev = np.concatenate([[0.0], tp[:-1]])
        fp_prev = np.concatenate([[0.0], fp[:-1]])
        area = np.sum((fp - fp_prev) * (tp + tp_prev) / 2.0)
        return float(area / (tot_pos * tot_neg))


class DetectionMAP(MetricBase):
    """Mean average precision for detection (reference metrics.py:481):
    accumulates the per-batch mAP values produced by layers.detection_map /
    the detection_map op and divides by the accumulated weight on eval —
    the reference's exact (raw sum / sum-of-weights) semantics, NOT a
    weighted average of the values (update(value, weight=1) per batch
    yields the mean batch mAP; weight=batch_size reproduces the
    reference's docstring usage and its scaling).

        batch_map = layers.detection_map(detect_res, gt_label, class_num)
        metric = fluid.metrics.DetectionMAP()
        ... per batch: metric.update(value=map_val, weight=batch_size)
        print(metric.eval())
    """

    def __init__(self, name=None):
        super().__init__(name)
        self.value = 0.0
        self.weight = 0.0

    def reset(self):
        self.value = 0.0
        self.weight = 0.0

    def update(self, value, weight):
        # reference semantics (metrics.py:524): raw accumulation of the
        # op's value and the caller-provided weight
        self.value += float(np.asarray(value).reshape(-1)[0])
        self.weight += float(weight)

    def eval(self):
        if self.weight == 0:
            raise ValueError(
                "There is no data in DetectionMAP Metrics. Please check "
                "layers.detection_map output has added to DetectionMAP."
            )
        return self.value / self.weight
