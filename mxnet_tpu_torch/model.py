"""Checkpoints and ``BatchEndParam`` (counterpart of ``mxnet_tpu/model.py``).

A checkpoint is MXNet's pair of files: ``prefix-symbol.json`` (the graph,
``Symbol.save``) and ``prefix-%04d.params`` (the arrays, named
``arg:<name>`` and ``aux:<name>``, in MXNet's ``.params`` format), so the
JAX package and the port read each other's checkpoints.  ``FeedForward``
is not ported (ROADMAP.md, queue 1 item 7).
"""
from __future__ import annotations

import logging
from collections import namedtuple

from . import ndarray as nd
from . import symbol as sym_mod

__all__ = ["BatchEndParam", "save_checkpoint", "load_checkpoint"]

BatchEndParam = namedtuple("BatchEndParams",
                           ["epoch", "nbatch", "eval_metric", "locals"])


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params,
                    remove_amp_cast=True):
    """Write ``prefix-symbol.json`` (when ``symbol`` is given) and
    ``prefix-%04d.params``."""
    if symbol is not None:
        symbol.save("%s-symbol.json" % prefix)
    save_dict = {("arg:%s" % k): v for k, v in arg_params.items()}
    save_dict.update({("aux:%s" % k): v for k, v in aux_params.items()})
    param_name = "%s-%04d.params" % (prefix, epoch)
    nd.save(param_name, save_dict)
    logging.info("Saved checkpoint to \"%s\"", param_name)


def load_checkpoint(prefix, epoch):
    """``(symbol, arg_params, aux_params)``, the arrays on the CPU."""
    symbol = sym_mod.load("%s-symbol.json" % prefix)
    arg_params, aux_params = {}, {}
    for k, v in nd.load("%s-%04d.params" % (prefix, epoch)).items():
        tp, name = k.split(":", 1)
        if tp == "arg":
            arg_params[name] = v
        elif tp == "aux":
            aux_params[name] = v
    return symbol, arg_params, aux_params
