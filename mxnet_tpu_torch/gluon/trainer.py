"""Gluon ``Trainer`` (counterpart of ``mxnet_tpu/gluon/trainer.py``, the part
one device needs): applies an optimizer to a set of ``Parameter``s.

With one device there is nothing to reduce: ``allreduce_grads`` does no
work and no kvstore is made (multi-device training is ROADMAP queue 1
item 9).
``step`` records the ``trainer.step`` and ``trainer.update`` spans and the
``trainer.steps`` counter on the telemetry bus when it is enabled.
``contrib.amp.init_trainer`` gives a Trainer a loss scaler
(``_amp_loss_scaler``) and keeps its ``_scale`` as ``_amp_original_scale``;
``amp.scale_loss`` then sets ``_scale`` to that over the loss scale, so
``step``'s ``rescale_grad = _scale / batch_size`` unscales the gradients.
``save_states``/``load_states`` write and read the optimizer and its
states (the JAX package's durability layer, atomic writes and retries, is
not ported).
"""
from __future__ import annotations

from .. import optimizer as opt
from ..telemetry import bus as _tel
from .parameter import Parameter

__all__ = ["Trainer"]


class Trainer:
    """``Trainer(params, optimizer, optimizer_params)``
    (``mxnet_tpu/gluon/trainer.py:25``).  ``params`` is a
    ``ParameterDict`` or dict (taken in the order of its sorted names:
    ``net.collect_params()``'s prefixed names give the JAX package's
    order) or a list of ``Parameter``s; each parameter's ``lr_mult`` and
    ``wd_mult`` reach the optimizer (``collect_params('.*beta|.*gamma|
    .*bias').setattr('wd_mult', 0.0)``); ``optimizer`` a name (``"sgd"``,
    ``"adam"``) or an ``Optimizer``, and ``optimizer_params`` its keyword
    arguments, an ``lr_scheduler`` among them.  ``kvstore`` is accepted
    for MXNet's signature; one device uses none."""

    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device"):
        if hasattr(params, "items"):
            params = [params[key] for key in sorted(params)]
        if not isinstance(params, (list, tuple)):
            raise ValueError(f"First argument must be a list or dict of "
                             f"Parameters, got {type(params)}.")
        for param in params:
            if not isinstance(param, Parameter):
                raise ValueError(f"First argument must be a list or dict of "
                                 f"Parameters, got list of {type(param)}.")
        self._params = list(params)
        optimizer_params = dict(optimizer_params or {})
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        self._amp_loss_scaler = None
        self._amp_original_scale = self._scale
        param_dict = dict(enumerate(self._params))
        if isinstance(optimizer, opt.Optimizer):
            if optimizer_params:
                raise ValueError("optimizer_params must be None if optimizer "
                                 "is an Optimizer instance")
            self._optimizer = optimizer
            self._optimizer.param_dict = param_dict
        else:
            self._optimizer = opt.create(optimizer, param_dict=param_dict,
                                         **optimizer_params)
        self._updater = opt.get_updater(self._optimizer)

    @property
    def learning_rate(self):
        """The optimizer's learning rate: its scheduler's at the current
        update count when ``optimizer_params`` gave it an
        ``lr_scheduler``."""
        return self._optimizer.learning_rate

    def set_learning_rate(self, lr):
        """Set the optimizer's learning rate; raises ``UserWarning`` when an
        ``lr_scheduler`` owns it, as ``mxnet_tpu/gluon/trainer.py:149-154``
        does."""
        self._optimizer.set_learning_rate(lr)

    def step(self, batch_size, ignore_stale_grad=False):
        """One update with gradients scaled by ``rescale_grad / batch_size``
        (``mxnet_tpu/gluon/trainer.py:161``).  ``ignore_stale_grad`` is
        accepted for MXNet's signature: a gradient here is whatever the last
        ``backward`` wrote, zeros before the first."""
        self._optimizer.rescale_grad = self._scale / batch_size
        with _tel.span("trainer.step", batch_size=batch_size,
                       n_params=len(self._params)):
            self.allreduce_grads()
            with _tel.span("trainer.update"):
                self._update()
        _tel.count("trainer.steps")

    def allreduce_grads(self):
        """Reduce gradients across devices: nothing to do on one."""

    def update(self, batch_size, ignore_stale_grad=False):
        """The update of :meth:`step` without the reduction."""
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update()

    def _update(self):
        """One batched updater call over every parameter that takes a
        gradient (``mxnet_tpu/gluon/trainer.py:239``)."""
        updates = [(i, param.grad_tensor(), param.tensor())
                   for i, param in enumerate(self._params)
                   if param.grad_req != "null"]
        if updates:
            self._updater(*(list(col) for col in zip(*updates)))

    def save_states(self, fname):
        """Write the optimizer and its states to ``fname``
        (``mxnet_tpu/gluon/trainer.py:272``; ``Updater.get_states`` with
        the optimizer, tensors on the CPU)."""
        with open(fname, "wb") as f:
            f.write(self._updater.get_states(dump_optimizer=True))

    def load_states(self, fname):
        """Read what :meth:`save_states` wrote; the loaded optimizer takes
        this Trainer's parameters (``mxnet_tpu/gluon/trainer.py:312``), and
        each state moves to its weight's device at its next update."""
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())
        self._optimizer = self._updater.optimizer
        self._optimizer.param_dict = dict(enumerate(self._params))
