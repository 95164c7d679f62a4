"""``BaseModule``: the training loop and the inference helpers of MXNet's
Module API (the port's copy of ``mxnet_tpu/module/base_module.py``):
``fit``, ``score``, ``predict``, ``iter_predict``, ``forward_backward``,
``set_params``, ``save_params``/``load_params`` and ``_parse_data_desc``.

``fit`` is MXNet's loop: bind, initialise, make the optimizer, then per
batch ``forward_backward``, ``update``, ``update_metric`` (a host read of
the outputs: the per-batch sync point of MXNet's loop too) and the
batch-end callbacks; per epoch the epoch-end callbacks and ``score`` on the
validation data.  A ``monitor`` (``mx.monitor``) is not ported (ROADMAP.md,
queue 1 item 7).
"""
from __future__ import annotations

import logging
import time

from .. import metric as metric_mod
from .. import ndarray as nd
from ..context import cpu
from ..io import DataDesc


def _as_list(obj):
    if obj is None:
        return []
    if isinstance(obj, (list, tuple)):
        return list(obj)
    return [obj]


def _parse_data_desc(data_names, label_names, data_shapes, label_shapes):
    """Normalize (name, shape) pairs into DataDesc lists (reference
    ``base_module.py:33 _parse_data_desc``)."""
    data_shapes = [x if isinstance(x, DataDesc) else DataDesc(*x)
                   for x in data_shapes]
    _check_names_match(data_names, data_shapes, "data", True)
    if label_shapes is not None:
        label_shapes = [x if isinstance(x, DataDesc) else DataDesc(*x)
                        for x in label_shapes]
        _check_names_match(label_names, label_shapes, "label", False)
    else:
        _check_names_match(label_names, [], "label", False)
    return data_shapes, label_shapes


def _check_names_match(data_names, data_shapes, name, throw):
    actual = [x[0] for x in data_shapes]
    if sorted(data_names) != sorted(actual):
        msg = "Data provided by %s_shapes don't match names specified by " \
              "%s_names (%s vs. %s)" % (name, name, str(data_shapes),
                                        str(data_names))
        if throw:
            raise ValueError(msg)
        logging.warning(msg)


class BaseModule:
    """Abstract training/inference module (reference ``base_module.py:66``)."""

    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.inputs_need_grad = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._symbol = None
        self._total_exec_bytes = 0

    # ------------------------------------------------------------ properties
    @property
    def data_names(self):
        raise NotImplementedError()

    @property
    def output_names(self):
        raise NotImplementedError()

    @property
    def data_shapes(self):
        raise NotImplementedError()

    @property
    def label_shapes(self):
        raise NotImplementedError()

    @property
    def output_shapes(self):
        raise NotImplementedError()

    @property
    def symbol(self):
        return self._symbol

    # -------------------------------------------------------------- abstract
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        raise NotImplementedError()

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False,
                    allow_extra=False):
        raise NotImplementedError()

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        raise NotImplementedError()

    def forward(self, data_batch, is_train=None):
        raise NotImplementedError()

    def backward(self, out_grads=None):
        raise NotImplementedError()

    def update(self):
        raise NotImplementedError()

    def get_outputs(self, merge_multi_context=True):
        raise NotImplementedError()

    def get_input_grads(self, merge_multi_context=True):
        raise NotImplementedError()

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        raise NotImplementedError()

    def get_params(self):
        raise NotImplementedError()

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        # reference module.py:589: set_params (NOT init_params — fit's
        # arg_params resume path stays permissive) rejects unknown keys
        # unless allow_extra; silently dropping them hides checkpoint typos
        if not allow_extra:
            known_args = getattr(self, "_param_names", None)
            known_aux = getattr(self, "_aux_names", None)
            extra = set()
            if known_args is not None:
                extra |= set(arg_params or ()) - set(known_args)
            if known_aux is not None:
                extra |= set(aux_params or ()) - set(known_aux)
            if extra:
                raise ValueError(
                    f"parameters {sorted(extra)} are not present in the "
                    "symbol (pass allow_extra=True to ignore)")
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init, allow_extra=allow_extra)

    # ------------------------------------------------------------- train API
    def forward_backward(self, data_batch):
        self.forward(data_batch, is_train=True)
        self.backward()

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, score_end_callback=None, reset=True,
              epoch=0, sparse_row_id_fn=None):
        """Evaluate on ``eval_data`` (reference ``base_module.py:213``)."""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)
        eval_metric.reset()
        actual_num_batch = 0
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            self.update_metric(eval_metric, eval_batch.label)
            if batch_end_callback is not None:
                from ..model import BatchEndParam
                params = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                       eval_metric=eval_metric, locals=locals())
                for callback in _as_list(batch_end_callback):
                    callback(params)
            actual_num_batch += 1
        if score_end_callback:
            from ..model import BatchEndParam
            params = BatchEndParam(epoch=epoch, nbatch=actual_num_batch,
                                   eval_metric=eval_metric, locals=locals())
            for callback in _as_list(score_end_callback):
                callback(params)
        return eval_metric.get_name_value()

    def iter_predict(self, eval_data, num_batch=None, reset=True):
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            pad = eval_batch.pad
            outputs = [out[0:out.shape[0] - pad] for out in self.get_outputs()]
            yield outputs, nbatch, eval_batch

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True, always_output_list=False, sparse_row_id_fn=None):
        """Run prediction, collecting outputs (reference
        ``base_module.py:321``)."""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        output_list = []
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            pad = eval_batch.pad
            outputs = [out[0:out.shape[0] - pad].copy()
                       for out in self.get_outputs()]
            output_list.append(outputs)
        if len(output_list) == 0:
            return output_list
        if merge_batches:
            num_outputs = len(output_list[0])
            for out in output_list:
                assert len(out) == num_outputs, \
                    "Cannot merge batches: different number of outputs."
            output_list2 = [nd.concat(*[out[i] for out in output_list], dim=0)
                            for i in range(num_outputs)]
            if num_outputs == 1 and not always_output_list:
                return output_list2[0]
            return output_list2
        return output_list

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None, kvstore="local",
            optimizer="sgd", optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=None, arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None, sparse_row_id_fn=None):
        """The classic training loop (reference ``base_module.py:409``)."""
        from .. import initializer as init_mod
        assert num_epoch is not None, "please specify number of epochs"
        if initializer is None:
            initializer = init_mod.Uniform(0.01)

        if monitor is not None:
            raise NotImplementedError("monitor (mx.monitor) is not ported "
                                      "yet (ROADMAP.md, queue 1 item 7)")
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label, for_training=True,
                  force_rebind=force_rebind)
        if not self.params_initialized or force_init:
            # an already-initialized module resuming fit() keeps its
            # params (init_params would only warn-and-ignore here)
            self.init_params(initializer=initializer, arg_params=arg_params,
                             aux_params=aux_params,
                             allow_missing=allow_missing,
                             force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)

        if validation_metric is None:
            validation_metric = eval_metric
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)

        from ..model import BatchEndParam
        for epoch in range(begin_epoch, num_epoch):
            tic = time.time()
            eval_metric.reset()
            nbatch = 0
            data_iter = iter(train_data)
            end_of_batch = False
            next_data_batch = next(data_iter)
            while not end_of_batch:
                data_batch = next_data_batch
                self.forward_backward(data_batch)
                self.update()
                if isinstance(data_batch, list):
                    self.update_metric(eval_metric,
                                       [db.label for db in data_batch],
                                       pre_sliced=True)
                else:
                    self.update_metric(eval_metric, data_batch.label)
                try:
                    next_data_batch = next(data_iter)
                    self.prepare(next_data_batch,
                                 sparse_row_id_fn=sparse_row_id_fn)
                except StopIteration:
                    end_of_batch = True
                if end_of_batch:
                    eval_name_vals = eval_metric.get_name_value()
                if batch_end_callback is not None:
                    batch_end_params = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                                     eval_metric=eval_metric,
                                                     locals=locals())
                    for callback in _as_list(batch_end_callback):
                        callback(batch_end_params)
                nbatch += 1
            for name, val in eval_name_vals:
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            toc = time.time()
            self.logger.info("Epoch[%d] Time cost=%.3f", epoch, (toc - tic))

            arg_params_, aux_params_ = self.get_params()
            self.set_params(arg_params_, aux_params_)
            if epoch_end_callback is not None:
                for callback in _as_list(epoch_end_callback):
                    callback(epoch, self.symbol, arg_params_, aux_params_)
            if eval_data is not None:
                res = self.score(eval_data, validation_metric,
                                 score_end_callback=eval_end_callback,
                                 batch_end_callback=eval_batch_end_callback,
                                 epoch=epoch)
                for name, val in res:
                    self.logger.info("Epoch[%d] Validation-%s=%f", epoch,
                                     name, val)
            train_data.reset()

    # ----------------------------------------------------------------- misc
    def prepare(self, data_batch, sparse_row_id_fn=None):
        """Pre-batch hook (a row-sparse pull in MXNet; nothing here)."""

    def save_params(self, fname):
        arg_params, aux_params = self.get_params()
        save_dict = {("arg:%s" % k): v.as_in_context(cpu())
                     for k, v in arg_params.items()}
        save_dict.update({("aux:%s" % k): v.as_in_context(cpu())
                          for k, v in aux_params.items()})
        nd.save(fname, save_dict)

    def load_params(self, fname):
        save_dict = nd.load(fname)
        arg_params = {}
        aux_params = {}
        for k, value in save_dict.items():
            arg_type, name = k.split(":", 1)
            if arg_type == "arg":
                arg_params[name] = value
            elif arg_type == "aux":
                aux_params[name] = value
            else:
                raise ValueError("Invalid param file " + fname)
        self.set_params(arg_params, aux_params)

    def get_states(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        assert not merge_multi_context
        return []

    def set_states(self, states=None, value=None):
        assert self.binded and self.params_initialized
        assert not states and not value
