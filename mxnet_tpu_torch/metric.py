"""Evaluation metrics (the port's copy of ``mxnet_tpu/metric.py``, the
whole file): the ``EvalMetric`` registry with Accuracy, TopK, F1, MCC,
PCC, Perplexity, MAE/MSE/RMSE, CrossEntropy, NLL, PearsonCorrelation,
Loss, Torch, Caffe and CustomMetric.

The metric math runs on host numpy: reading a prediction (``asnumpy``)
waits for the device, so in ``Module.fit`` the metric is the per-batch sync
point, as in MXNet's fit loop.
"""
from __future__ import annotations

import math
from collections import OrderedDict

import numpy

from .ndarray import NDArray


def check_label_shapes(labels, preds, wrap=False, shape=False):
    """Reference ``metric.py:38``."""
    if not shape:
        label_shape, pred_shape = len(labels), len(preds)
    else:
        label_shape, pred_shape = labels.shape, preds.shape
    if label_shape != pred_shape:
        raise ValueError(f"Shape of labels {label_shape} does not match shape "
                         f"of predictions {pred_shape}")
    if wrap:
        if isinstance(labels, NDArray):
            labels = [labels]
        if isinstance(preds, NDArray):
            preds = [preds]
    return labels, preds


class EvalMetric:
    """Base metric (reference ``metric.py:68``)."""

    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self._global_num_inst = 0
        self._global_sum_metric = 0.0
        self.reset()

    def __str__(self):
        return f"EvalMetric: {dict(self.get_name_value())}"

    def get_config(self):
        config = self._kwargs.copy()
        config.update({
            "metric": self.__class__.__name__,
            "name": self.name,
            "output_names": self.output_names,
            "label_names": self.label_names})
        return config

    def update_dict(self, label, pred):
        if self.output_names is not None:
            pred = [pred[name] for name in self.output_names if name in pred]
        else:
            pred = list(pred.values())
        if self.label_names is not None:
            label = [label[name] for name in self.label_names if name in label]
        else:
            label = list(label.values())
        self.update(label, pred)

    def update(self, labels, preds):
        raise NotImplementedError()

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0
        self._global_num_inst = 0
        self._global_sum_metric = 0.0

    def reset_local(self):
        """Fold the local tallies into the global ones and clear them
        (reference 1.5 local/global split — ``metric.py:141``): Speedometer's
        ``auto_reset`` wipes the interval window without losing the epoch
        totals reported by ``get_global``."""
        self._global_num_inst += self.num_inst
        self._global_sum_metric += self.sum_metric
        self.num_inst = 0
        self.sum_metric = 0.0

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.sum_metric / self.num_inst)

    def get_global(self):
        num = self._global_num_inst + self.num_inst
        if num == 0:
            return (self.name, float("nan"))
        return (self.name,
                (self._global_sum_metric + self.sum_metric) / num)

    def get_global_name_value(self):
        name, value = self.get_global()
        if not isinstance(name, list):
            name, value = [name], [value]
        return list(zip(name, value))

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))


# ---------------------------------------------------------------------------
# registry (reference metric.py register/create)
# ---------------------------------------------------------------------------
_METRIC_REGISTRY = {}


def register(klass):
    _METRIC_REGISTRY[klass.__name__.lower()] = klass
    return klass


def alias(*aliases):
    def deco(klass):
        for a in aliases:
            _METRIC_REGISTRY[a.lower()] = klass
        return register(klass)
    return deco


def create(metric, *args, **kwargs):
    """Reference ``metric.py create``: accepts instance / callable / name /
    list of names / config dict."""
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        composite = CompositeEvalMetric()
        for child in metric:
            composite.add(create(child, *args, **kwargs))
        return composite
    if isinstance(metric, dict):
        cfg = dict(metric)
        name = cfg.pop("metric")
        cfg.update(kwargs)
        return _METRIC_REGISTRY[name.lower()](*args, **cfg)
    if isinstance(metric, str):
        return _METRIC_REGISTRY[metric.lower()](*args, **kwargs)
    raise TypeError(f"cannot create metric from {metric!r}")


@register
class CompositeEvalMetric(EvalMetric):
    """Manage multiple metrics (reference ``metric.py:314``)."""

    def __init__(self, metrics=None, name="composite", output_names=None,
                 label_names=None):
        super().__init__(name, output_names=output_names, label_names=label_names)
        if metrics is None:
            metrics = []
        self.metrics = [create(i) for i in metrics]

    def add(self, metric):
        self.metrics.append(create(metric))

    def get_metric(self, index):
        try:
            return self.metrics[index]
        except IndexError:
            return ValueError(f"Metric index {index} is out of range 0 and "
                              f"{len(self.metrics)}")

    def update_dict(self, labels, preds):
        def keep(table, wanted):
            if wanted is None:
                return table
            return OrderedDict((k, v) for k, v in table.items()
                               if k in wanted)
        labels = keep(labels, self.label_names)
        preds = keep(preds, self.output_names)
        for metric in self.metrics:
            metric.update_dict(labels, preds)

    def update(self, labels, preds):
        for metric in self.metrics:
            metric.update(labels, preds)

    def reset(self):
        # base __init__ resets before self.metrics exists
        for metric in getattr(self, "metrics", ()):
            metric.reset()

    def reset_local(self):
        """Each child's ``reset_local`` (MXNet 1.5's; the JAX package's
        composite lacks it, so a ``Speedometer`` over a list of metrics
        fails there)."""
        for metric in self.metrics:
            metric.reset_local()

    def get_global(self):
        return self._collect("get_global")

    def get(self):
        return self._collect("get")

    def _collect(self, how):
        names = []
        values = []
        for metric in self.metrics:
            name, value = getattr(metric, how)()
            if isinstance(name, str):
                name = [name]
            if isinstance(value, (float, int, numpy.generic)):
                value = [value]
            names.extend(name)
            values.extend(value)
        return (names, values)

    def get_config(self):
        config = super().get_config()
        config.update({"metrics": [i.get_config() for i in self.metrics]})
        return config


def _asnumpy(x):
    return x.asnumpy() if isinstance(x, NDArray) else numpy.asarray(x)


@alias("acc")
class Accuracy(EvalMetric):
    """Classification accuracy (reference ``metric.py:394``)."""

    def __init__(self, axis=1, name="accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, axis=axis, output_names=output_names,
                         label_names=label_names)
        self.axis = axis

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred_label in zip(labels, preds):
            pred_label = _asnumpy(pred_label)
            label = _asnumpy(label)
            if pred_label.shape != label.shape:
                pred_label = pred_label.argmax(axis=self.axis)
            pred_label = pred_label.astype("int32").ravel()
            label = label.astype("int32").ravel()
            check_label_shapes(label, pred_label)
            self.sum_metric += (pred_label == label).sum()
            self.num_inst += len(pred_label)


@alias("top_k_accuracy", "top_k_acc")
class TopKAccuracy(EvalMetric):
    """Top-k accuracy (reference ``metric.py:467``)."""

    def __init__(self, top_k=1, name="top_k_accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, top_k=top_k, output_names=output_names,
                         label_names=label_names)
        self.top_k = top_k
        assert self.top_k > 1, "Please use Accuracy if top_k is no more than 1"
        self.name += "_%d" % self.top_k

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred_label in zip(labels, preds):
            assert len(pred_label.shape) <= 2, "Predictions should be no more than 2 dims"
            pred_label = numpy.argsort(_asnumpy(pred_label).astype("float32"),
                                       axis=-1)
            label = _asnumpy(label).astype("int32")
            check_label_shapes(label, pred_label)
            num_samples = pred_label.shape[0]
            num_dims = len(pred_label.shape)
            if num_dims == 1:
                self.sum_metric += (pred_label.ravel() == label.ravel()).sum()
            elif num_dims == 2:
                num_classes = pred_label.shape[1]
                top_k = min(num_classes, self.top_k)
                for j in range(top_k):
                    self.sum_metric += (pred_label[:, num_classes - 1 - j].ravel()
                                        == label.ravel()).sum()
            self.num_inst += num_samples


class _BinaryClassificationMetrics:
    """Confusion-matrix bookkeeping shared by F1/MCC (reference
    ``metric.py:540``)."""

    def __init__(self):
        self.true_positives = 0
        self.false_negatives = 0
        self.false_positives = 0
        self.true_negatives = 0

    def update_binary_stats(self, label, pred):
        pred = _asnumpy(pred)
        label = _asnumpy(label).astype("int32")
        check_label_shapes(label, pred)
        pred_label = numpy.argmax(pred, axis=1)
        if numpy.unique(label).size > 2:
            raise ValueError("%s currently only supports binary classification."
                             % self.__class__.__name__)
        pred_true = (pred_label == 1)
        pred_false = 1 - pred_true
        label_true = (label == 1)
        label_false = 1 - label_true
        self.true_positives += (pred_true * label_true).sum()
        self.false_positives += (pred_true * label_false).sum()
        self.false_negatives += (pred_false * label_true).sum()
        self.true_negatives += (pred_false * label_false).sum()

    @property
    def precision(self):
        if self.true_positives + self.false_positives > 0:
            return float(self.true_positives) / (self.true_positives + self.false_positives)
        return 0.0

    @property
    def recall(self):
        if self.true_positives + self.false_negatives > 0:
            return float(self.true_positives) / (self.true_positives + self.false_negatives)
        return 0.0

    @property
    def fscore(self):
        if self.precision + self.recall > 0:
            return 2 * self.precision * self.recall / (self.precision + self.recall)
        return 0.0

    @property
    def matthewscc(self):
        if not self.total_examples:
            return 0.0
        true_pos = float(self.true_positives)
        false_pos = float(self.false_positives)
        false_neg = float(self.false_negatives)
        true_neg = float(self.true_negatives)
        terms = [(true_pos + false_pos), (true_pos + false_neg),
                 (true_neg + false_pos), (true_neg + false_neg)]
        denom = 1.0
        for t in filter(lambda t: t != 0.0, terms):
            denom *= t
        return ((true_pos * true_neg) - (false_pos * false_neg)) / math.sqrt(denom)

    @property
    def total_examples(self):
        return (self.false_negatives + self.false_positives +
                self.true_negatives + self.true_positives)

    def reset_stats(self):
        self.false_positives = 0
        self.false_negatives = 0
        self.true_positives = 0
        self.true_negatives = 0


@register
class F1(EvalMetric):
    """Binary F1 (reference ``metric.py:625``)."""

    def __init__(self, name="f1", output_names=None, label_names=None,
                 average="macro"):
        self.average = average
        self.metrics = _BinaryClassificationMetrics()
        EvalMetric.__init__(self, name=name, output_names=output_names,
                            label_names=label_names)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            self.metrics.update_binary_stats(label, pred)
        if self.average == "macro":
            self.sum_metric += self.metrics.fscore
            self.num_inst += 1
            self.metrics.reset_stats()
        else:
            self.sum_metric = self.metrics.fscore * self.metrics.total_examples
            self.num_inst = self.metrics.total_examples

    def reset(self):
        self.sum_metric = 0.0
        self.num_inst = 0
        if hasattr(self, "metrics"):
            self.metrics.reset_stats()


@register
class MCC(EvalMetric):
    """Matthews correlation coefficient (reference ``metric.py:714``)."""

    def __init__(self, name="mcc", output_names=None, label_names=None,
                 average="macro"):
        self._average = average
        self._metrics = _BinaryClassificationMetrics()
        EvalMetric.__init__(self, name=name, output_names=output_names,
                            label_names=label_names)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            self._metrics.update_binary_stats(label, pred)
        if self._average == "macro":
            self.sum_metric += self._metrics.matthewscc
            self.num_inst += 1
            self._metrics.reset_stats()
        else:
            self.sum_metric = self._metrics.matthewscc * self._metrics.total_examples
            self.num_inst = self._metrics.total_examples

    def reset(self):
        self.sum_metric = 0.0
        self.num_inst = 0.0
        if hasattr(self, "_metrics"):
            self._metrics.reset_stats()


@register
class Perplexity(EvalMetric):
    """Perplexity (reference ``metric.py:834``)."""

    def __init__(self, ignore_label, axis=-1, name="perplexity",
                 output_names=None, label_names=None):
        super().__init__(name, ignore_label=ignore_label, axis=axis,
                         output_names=output_names, label_names=label_names)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        assert len(labels) == len(preds)
        loss = 0.0
        num = 0
        for label, pred in zip(labels, preds):
            label = _asnumpy(label)
            pred = _asnumpy(pred)
            assert label.size == pred.size / pred.shape[self.axis], \
                "shape mismatch: %s vs. %s" % (label.shape, pred.shape)
            # labels may arrive flattened (the common RNN case: label (N,)
            # against pred (T, B, V)); pick along the class axis after moving
            # it last so indexing works for any label layout the size
            # assertion admits.
            axis = self.axis if self.axis >= 0 else pred.ndim + self.axis
            flat = numpy.moveaxis(pred, axis, -1).reshape(-1, pred.shape[axis])
            label = label.reshape((label.size,)).astype("int32")
            probs = flat[numpy.arange(label.size), label]
            if self.ignore_label is not None:
                ignore = (label == self.ignore_label).astype(probs.dtype)
                num -= int(ignore.sum())
                probs = probs * (1 - ignore) + ignore
            loss -= numpy.sum(numpy.log(numpy.maximum(1e-10, probs)))
            num += label.size
        self.sum_metric += numpy.exp(loss / num) * num
        self.num_inst += num


@alias("mae")
class MAE(EvalMetric):
    """Mean absolute error (reference ``metric.py:915``)."""

    def __init__(self, name="mae", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names, label_names=label_names)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            label = _asnumpy(label)
            pred = _asnumpy(pred)
            if len(label.shape) == 1:
                label = label.reshape(label.shape[0], 1)
            if len(pred.shape) == 1:
                pred = pred.reshape(pred.shape[0], 1)
            self.sum_metric += numpy.abs(label - pred).mean()
            self.num_inst += 1


@alias("mse")
class MSE(EvalMetric):
    """Mean squared error (reference ``metric.py:970``)."""

    def __init__(self, name="mse", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names, label_names=label_names)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            label = _asnumpy(label)
            pred = _asnumpy(pred)
            if len(label.shape) == 1:
                label = label.reshape(label.shape[0], 1)
            if len(pred.shape) == 1:
                pred = pred.reshape(pred.shape[0], 1)
            self.sum_metric += ((label - pred) ** 2.0).mean()
            self.num_inst += 1


@alias("rmse")
class RMSE(EvalMetric):
    """Root mean squared error (reference ``metric.py:1024``)."""

    def __init__(self, name="rmse", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names, label_names=label_names)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            label = _asnumpy(label)
            pred = _asnumpy(pred)
            if len(label.shape) == 1:
                label = label.reshape(label.shape[0], 1)
            if len(pred.shape) == 1:
                pred = pred.reshape(pred.shape[0], 1)
            self.sum_metric += numpy.sqrt(((label - pred) ** 2.0).mean())
            self.num_inst += 1


@alias("ce")
class CrossEntropy(EvalMetric):
    """Cross entropy over class probabilities (reference ``metric.py:1079``)."""

    def __init__(self, eps=1e-12, name="cross-entropy", output_names=None,
                 label_names=None):
        super().__init__(name, eps=eps, output_names=output_names,
                         label_names=label_names)
        self.eps = eps

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            label = _asnumpy(label)
            pred = _asnumpy(pred)
            label = label.ravel()
            assert label.shape[0] == pred.shape[0]
            prob = pred[numpy.arange(label.shape[0]), numpy.int64(label)]
            self.sum_metric += (-numpy.log(prob + self.eps)).sum()
            self.num_inst += label.shape[0]


@alias("nll_loss")
class NegativeLogLikelihood(EvalMetric):
    """NLL over predicted probabilities (reference ``metric.py:1144``)."""

    def __init__(self, eps=1e-12, name="nll-loss", output_names=None,
                 label_names=None):
        super().__init__(name, eps=eps, output_names=output_names,
                         label_names=label_names)
        self.eps = eps

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            label = _asnumpy(label)
            pred = _asnumpy(pred)
            label = label.ravel()
            num_examples = pred.shape[0]
            assert label.shape[0] == num_examples, (label.shape[0], num_examples)
            prob = pred[numpy.arange(num_examples, dtype=numpy.int64),
                        numpy.int64(label)]
            self.sum_metric += (-numpy.log(prob + self.eps)).sum()
            self.num_inst += num_examples


@alias("pearsonr")
class PearsonCorrelation(EvalMetric):
    """Pearson correlation (reference ``metric.py:1208``)."""

    def __init__(self, name="pearsonr", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names, label_names=label_names)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            check_label_shapes(label, pred, False, True)
            label = _asnumpy(label)
            pred = _asnumpy(pred)
            self.sum_metric += numpy.corrcoef(pred.ravel(), label.ravel())[0, 1]
            self.num_inst += 1


@register
class PCC(EvalMetric):
    """Multiclass Pearson correlation of the confusion matrix (the
    k-category correlation coefficient, reference ``metric.py:900`` PCC);
    reduces to MCC for binary problems."""

    def __init__(self, name="pcc", output_names=None, label_names=None):
        self.k = 2
        super().__init__(name, output_names=output_names,
                         label_names=label_names)

    def _grow(self, inc):
        self.lcm = numpy.pad(self.lcm, ((0, inc), (0, inc)))
        self.gcm = numpy.pad(self.gcm, ((0, inc), (0, inc)))
        self.k += inc

    @staticmethod
    def _calc_mcc(cmat):
        n = cmat.sum()
        row, col = cmat.sum(axis=1), cmat.sum(axis=0)
        var_true = numpy.sum(row * (n - row))
        var_pred = numpy.sum(col * (n - col))
        if var_true == 0 or var_pred == 0:
            return float("nan")
        cov = numpy.sum(cmat.diagonal() * n - row * col)
        return cov / (var_true * var_pred) ** 0.5

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            label = _asnumpy(label).ravel().astype("int64")
            p = _asnumpy(pred)
            pred_cls = p.argmax(axis=-1).ravel().astype("int64") \
                if p.ndim > 1 else (p.ravel() > 0.5).astype("int64")
            n = int(max(pred_cls.max(), label.max())) + 1
            if n > self.k:
                self._grow(n - self.k)
            bcm = numpy.zeros((self.k, self.k))
            numpy.add.at(bcm, (label, pred_cls), 1)
            self.lcm += bcm
            self.gcm += bcm
        self.num_inst += 1
        self.global_num_inst += 1

    @property
    def sum_metric(self):
        return self._calc_mcc(self.lcm) * self.num_inst

    @sum_metric.setter
    def sum_metric(self, _):
        pass                           # derived from the confusion matrix

    def get_global(self):
        if self.global_num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self._calc_mcc(self.gcm))

    def reset(self):
        self.global_num_inst = 0
        self.num_inst = 0
        self.gcm = numpy.zeros((self.k, self.k))
        self.lcm = numpy.zeros((self.k, self.k))

    def reset_local(self):
        self.num_inst = 0
        self.lcm = numpy.zeros((self.k, self.k))


@register
class Loss(EvalMetric):
    """Dummy metric averaging a loss output (reference ``metric.py:1254``)."""

    def __init__(self, name="loss", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names, label_names=label_names)

    def update(self, _, preds):
        if isinstance(preds, NDArray):
            preds = [preds]
        for pred in preds:
            loss = _asnumpy(pred).sum()
            self.sum_metric += loss
            self.num_inst += pred.size


@register
class Torch(Loss):
    """Dummy metric for torch criterions (reference ``metric.py:1285``)."""

    def __init__(self, name="torch", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names, label_names=label_names)


@register
class Caffe(Loss):
    """Dummy metric for caffe criterions (reference ``metric.py:1294``)."""

    def __init__(self, name="caffe", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names, label_names=label_names)


@register
class CustomMetric(EvalMetric):
    """Metric from a ``feval(label, pred)`` function (reference
    ``metric.py:1304``)."""

    def __init__(self, feval, name=None, allow_extra_outputs=False,
                 output_names=None, label_names=None):
        if name is None:
            name = feval.__name__
            if name.find("<") != -1:
                name = "custom(%s)" % name
        super().__init__(name, feval=feval, allow_extra_outputs=allow_extra_outputs,
                         output_names=output_names, label_names=label_names)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        if not self._allow_extra_outputs:
            labels, preds = check_label_shapes(labels, preds, True)
        for pred, label in zip(preds, labels):
            label = _asnumpy(label)
            pred = _asnumpy(pred)
            reval = self._feval(label, pred)
            if isinstance(reval, tuple):
                (sum_metric, num_inst) = reval
                self.sum_metric += sum_metric
                self.num_inst += num_inst
            else:
                self.sum_metric += reval
                self.num_inst += 1

    def get_config(self):
        raise NotImplementedError("CustomMetric cannot be serialized")


def np(numpy_feval, name=None, allow_extra_outputs=False):
    """Wrap a numpy feval as a metric (reference ``metric.py:1372``)."""

    def feval(label, pred):
        return numpy_feval(label, pred)

    feval.__name__ = numpy_feval.__name__
    return CustomMetric(feval, name, allow_extra_outputs)
