"""``Module``: a Symbol bound to one Executor, trained with an optimizer
through a KVStore (counterpart of ``mxnet_tpu/module/module.py``).

The device rule departs from the JAX package on purpose.  There,
``Module(context=None)`` runs on ``cpu()``; here, as everywhere in the
port, it runs on the current context: the GPU, unless the caller passes
``context=mx.cpu()`` or builds the module under ``with mx.cpu():``.
Without a GPU it raises, naming the missing device; nothing falls back to
the CPU.  One context only: several (MXNet's ``DataParallelExecutorGroup``)
raise, naming ROADMAP.md queue 1 item 9.

Training follows MXNet 1.5 and the JAX package: ``init_optimizer`` makes
the optimizer with ``rescale_grad = 1 / batch size`` and, with a kvstore
(``'local'`` by default), updates on the store (``update_on_kvstore``):
``update`` pushes every gradient in one call (one grouped optimizer update
on the store's copies) and pulls the new weights back into the executor.
``fixed_param_names`` take no gradient and are never updated.
"""
from __future__ import annotations

import logging
import warnings

import torch

from .. import optimizer as opt
from .. import random as _rnd
from ..executor import check_single_context, tensor_like
from ..initializer import InitDesc, Initializer, Uniform
from ..kvstore import KVStore, create as kv_create
from .base_module import BaseModule, _parse_data_desc

__all__ = ["Module"]


def _check_input_names(symbol, names, typename, throw):
    args = symbol.list_arguments()
    for name in names:
        if name in args:
            continue
        candidates = [a for a in args if not a.endswith(
            ("_weight", "_bias", "_gamma", "_beta"))]
        msg = (f"You created Module with Module(..., {typename}_names="
               f"{names}) but input with name '{name}' is not found in "
               f"symbol.list_arguments(). Did you mean one of:\n\t"
               + "\n\t".join(candidates))
        if throw:
            raise ValueError(msg)
        logging.warning(msg)


class Module(BaseModule):
    """``Module(symbol, data_names, label_names, context, ...)``."""

    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None,
                 compression_params=None):
        super().__init__(logger=logger)
        self._context = check_single_context(context)
        if compression_params is not None:
            raise NotImplementedError("gradient compression is not ported "
                                      "yet (ROADMAP.md, queue 1 item 9)")
        self._symbol = symbol
        data_names = list(data_names or [])
        label_names = list(label_names or [])
        state_names = list(state_names or [])
        fixed_param_names = list(fixed_param_names or [])
        _check_input_names(symbol, data_names, "data", True)
        _check_input_names(symbol, label_names, "label", False)
        _check_input_names(symbol, state_names, "state", True)
        _check_input_names(symbol, fixed_param_names, "fixed_param", True)
        inputs = data_names + label_names + state_names
        self._param_names = [x for x in symbol.list_arguments()
                             if x not in inputs]
        self._fixed_param_names = fixed_param_names
        self._aux_names = symbol.list_auxiliary_states()
        self._data_names = data_names
        self._label_names = label_names
        self._state_names = state_names
        self._output_names = symbol.list_outputs()
        self._arg_params = self._aux_params = None
        self._optimizer = self._kvstore = self._updater = None
        self._exec = None
        self._data_shapes = self._label_shapes = None
        self._grad_req = None
        self._preload_opt_states = None

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """A module from ``prefix-symbol.json`` and ``prefix-%04d.params``
        (and the optimizer states of ``prefix-%04d.states``)."""
        from ..model import load_checkpoint
        sym, args, auxs = load_checkpoint(prefix, epoch)
        mod = Module(symbol=sym, **kwargs)
        mod._arg_params, mod._aux_params = args, auxs
        mod.params_initialized = True
        if load_optimizer_states:
            mod._preload_opt_states = "%s-%04d.states" % (prefix, epoch)
        return mod

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False,
                        remove_amp_cast=True):
        self._symbol.save("%s-symbol.json" % prefix)
        param_name = "%s-%04d.params" % (prefix, epoch)
        self.save_params(param_name)
        logging.info("Saved checkpoint to \"%s\"", param_name)
        if save_optimizer_states:
            state_name = "%s-%04d.states" % (prefix, epoch)
            self.save_optimizer_states(state_name)
            logging.info("Saved optimizer state to \"%s\"", state_name)

    # ------------------------------------------------------------ properties
    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        assert self.binded
        return self._data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        _, out_shapes, _ = self._symbol.infer_shape(**self._input_shapes())
        return list(zip(self._output_names, out_shapes))

    def _input_shapes(self):
        shapes = {d.name: d.shape for d in self._data_shapes}
        shapes.update({d.name: d.shape for d in self._label_shapes or ()})
        return shapes

    # ------------------------------------------------------------------ bind
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Allocate the executor for these input shapes."""
        if force_rebind:
            self._reset_bind()
        if self.binded:
            self.logger.warning("Already bound, ignoring bind()")
            return
        assert for_training or not inputs_need_grad
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._data_shapes, self._label_shapes = _parse_data_desc(
            self.data_names, self.label_names, data_shapes, label_shapes)
        if isinstance(grad_req, str):
            reqs = {}
            for name in self._symbol.list_arguments():
                if name in self._data_names:
                    reqs[name] = "write" if inputs_need_grad else "null"
                elif name in self._label_names or \
                        name in self._state_names or \
                        name in self._fixed_param_names:
                    reqs[name] = "null"
                else:
                    reqs[name] = grad_req if for_training else "null"
        else:
            reqs = dict(grad_req)
        self._grad_req = reqs
        types = {d.name: d.dtype for d in self._data_shapes}
        self._exec = self._symbol.simple_bind(
            ctx=self._context, grad_req=reqs, type_dict=types,
            **self._input_shapes())
        self.binded = True
        if shared_module is not None and shared_module.params_initialized:
            self.set_params(*shared_module.get_params(), allow_extra=True)
        elif self.params_initialized:
            self._exec.copy_params_from(self._arg_params, self._aux_params)

    def _reset_bind(self):
        self.binded = False
        self._exec = None
        self._data_shapes = self._label_shapes = None

    # ------------------------------------------------------------ parameters
    def init_params(self, initializer="default", arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        """Fill the parameters from ``arg_params``/``aux_params`` (NDArrays,
        tensors or numpy arrays, by name) and ``initializer`` (default
        ``Uniform(0.01)``) for the rest, drawing from the device's
        generator (``mx.random``)."""
        if initializer == "default":
            initializer = Uniform(0.01)
        if self.params_initialized and not force_init:
            warnings.warn("Parameters already initialized and "
                          "force_init=False. init_params call ignored.",
                          stacklevel=2)
            return
        assert self.binded, "call bind before initializing the parameters"
        attrs = self._symbol.attr_dict()
        gen = _rnd.generator(self._context.torch_device())

        def fill(names, arrays, given):
            for name in names:
                arr = arrays[name]
                if given is not None and name in given:
                    with torch.no_grad():
                        arr._data.copy_(tensor_like(given[name], arr._data))
                    continue
                if given is not None and not allow_missing:
                    raise RuntimeError(f"{name} is not presented")
                desc = InitDesc(name, attrs.get(name, {}))
                if isinstance(initializer, Initializer):
                    initializer(desc, arr, gen)
                elif initializer is not None:
                    initializer(desc, arr)

        fill(self._param_names, self._exec.arg_dict, arg_params)
        fill(self._aux_names, self._exec.aux_dict, aux_params)
        self.params_initialized = True
        self._sync_params_from_exec()

    def _sync_params_from_exec(self):
        self._arg_params = {n: self._exec.arg_dict[n]
                            for n in self._param_names}
        self._aux_params = {n: self._exec.aux_dict[n]
                            for n in self._aux_names}

    def get_params(self):
        """Copies of ``(arg_params, aux_params)``, on the module's
        device."""
        assert self.binded and self.params_initialized
        self._sync_params_from_exec()
        return ({k: v.copy() for k, v in self._arg_params.items()},
                {k: v.copy() for k, v in self._aux_params.items()})

    # ------------------------------------------------------------- optimizer
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """Make the optimizer (``rescale_grad = 1 / batch size`` unless
        given) and the kvstore; with a kvstore the update runs on it."""
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring...")
            return
        if isinstance(optimizer, str):
            optimizer_params = dict(optimizer_params)
            optimizer_params.setdefault(
                "rescale_grad", 1.0 / self._data_shapes[0].shape[0])
            optimizer = opt.create(
                optimizer, param_idx2name=dict(enumerate(self._param_names)),
                **optimizer_params)
        self._optimizer = optimizer
        kv = None
        if kvstore:
            kv = kvstore if isinstance(kvstore, KVStore) else \
                kv_create(kvstore)
        self._kvstore = kv
        self._updater = opt.get_updater(optimizer)
        if kv is not None:
            for i, name in enumerate(self._param_names):
                kv.init(i, self._exec.arg_dict[name])
            kv.set_optimizer(self._optimizer)
        self.optimizer_initialized = True
        if self._preload_opt_states:
            self.load_optimizer_states(self._preload_opt_states)
            self._preload_opt_states = None

    # --------------------------------------------------------------- compute
    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        if is_train is None:
            is_train = self.for_training
        feeds = dict(zip(self._data_names, data_batch.data))
        if self._label_shapes and data_batch.label is not None:
            feeds.update(zip(self._label_names, data_batch.label))
        self._exec.forward(is_train=is_train, **feeds)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        assert self.for_training, \
            "backward() on a module bound with for_training=False"
        self._exec.backward(out_grads=out_grads)

    def update(self):
        """One optimizer step over every parameter that takes a gradient:
        one push and one pull of all of them through the kvstore, or one
        updater call without one."""
        assert self.binded and self.params_initialized \
            and self.optimizer_initialized
        grads = self._exec.grad_dict
        live = [(i, name) for i, name in enumerate(self._param_names)
                if self._grad_req.get(name, "write") != "null"
                and name in grads]
        if not live:
            return
        keys = [i for i, _ in live]
        gs = [grads[n] for _, n in live]
        ws = [self._exec.arg_dict[n] for _, n in live]
        if self._kvstore is not None:
            self._kvstore.push(keys, gs, priority=-keys[0])
            self._kvstore.pull(keys, ws, priority=-keys[0])
        else:
            self._updater(keys, [g._data for g in gs], [w._data for w in ws])

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._exec.outputs

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized \
            and self.inputs_need_grad
        return [self._exec.grad_dict[n] for n in self._data_names]

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        eval_metric.update_dict(
            dict(zip(self._label_names, labels)),
            dict(zip(self._output_names, self.get_outputs())))

    # ----------------------------------------------------- optimizer states
    def save_optimizer_states(self, fname):
        assert self.optimizer_initialized
        if self._kvstore is not None:
            self._kvstore.save_optimizer_states(fname)
        else:
            with open(fname, "wb") as fout:
                fout.write(self._updater.get_states())

    def load_optimizer_states(self, fname):
        assert self.optimizer_initialized
        if self._kvstore is not None:
            self._kvstore.load_optimizer_states(fname)
        else:
            with open(fname, "rb") as f:
                self._updater.set_states(f.read())

    def reshape(self, data_shapes, label_shapes=None):
        """Re-bind for new input shapes, keeping the parameters."""
        assert self.binded
        arg_params, aux_params = self.get_params()
        self.bind(data_shapes, label_shapes, self.for_training,
                  self.inputs_need_grad, force_rebind=True)
        self.set_params(arg_params, aux_params)
