"""AMP core (counterpart of ``mxnet_tpu/contrib/amp/amp.py``).

The JAX package puts one hook on its imperative dispatch path
(``ndarray.invoke``) and its Gluon layers reach it because they call
``F.<Op>``.  The port's layers call torch directly, so the policy here is
one function keyed by MXNet op name, :func:`_amp_policy`, installed as
``ops.registry.amp_policy``: ``invoke`` applies it to every ``mx.nd`` op,
and each gluon layer, loss and model applies it (``registry.amp_inputs``)
at the torch call where the JAX package dispatches that op.  Inputs of a
target-list op that are float32 become bfloat16; inputs of an fp32-list
op that are bfloat16 become float32; nothing else is cast, and auxiliary
inputs (BatchNorm's moving statistics) never are.  The casts are torch's
``Tensor.to``, differentiable, so an fp32 parameter gets an fp32
gradient, and the products of a cast op run on the tensor cores in bf16
both ways.  As in the JAX package, the symbolic Executor calls op
functions directly and sees no policy: ``mx.sym`` takes AMP through
:func:`convert_symbol`.
"""
from __future__ import annotations

import contextlib
import logging
import warnings

import torch

from ...base import np_dtype
from ...ops import registry as _reg
from ...symbol.symbol import AUX_INPUTS, Symbol, _Node
from . import lists
from .loss_scaler import LossScaler, grads_of

_state = {"initialized": False, "target_dtype": None,
          "lp16": set(), "fp32": set()}


def list_lp16_ops(target_dtype="bfloat16"):
    return list(lists.TARGET_DTYPE_OPS)


def list_fp32_ops(target_dtype="bfloat16"):
    return list(lists.FP32_OPS)


def _amp_policy(names, tensors):
    """The inputs of the op called any of ``names`` as AMP runs them."""
    if any(n in _state["lp16"] for n in names):
        src, dst = torch.float32, _state["target_dtype"]
    elif any(n in _state["fp32"] for n in names):
        src, dst = _state["target_dtype"], torch.float32
    else:
        return tensors
    aux = AUX_INPUTS.get(names[0], {})
    return [t.to(dst) if t is not None and t.dtype == src and i not in aux
            else t for i, t in enumerate(tensors)]


def init(target_dtype="bfloat16", target_precision_ops=None,
         conditional_fp32_ops=None, fp32_ops=None):
    """Enable AMP (reference ``amp.py:init``); a second call does nothing.
    A ``float16`` request is mapped to bfloat16 with a warning, as the JAX
    package maps it."""
    if _state["initialized"]:
        return
    if str(target_dtype) in ("float16", "fp16", "np.float16"):
        warnings.warn("AMP uses bfloat16; float16 request mapped to "
                      "bfloat16 (same API, wider exponent range).")
    _state["target_dtype"] = torch.bfloat16
    _state["lp16"] = set(lists.TARGET_DTYPE_OPS) | set(
        target_precision_ops or ())
    _state["fp32"] = set(lists.FP32_OPS) | set(fp32_ops or ())
    _state["initialized"] = True
    _reg.amp_policy = _amp_policy
    logging.info("AMP initialized (target dtype bfloat16)")


def deinit():
    """Remove the policy (a testing helper, as in the JAX package)."""
    _reg.amp_policy = None
    _state["initialized"] = False


def init_trainer(optimizer_or_trainer):
    """Attach a dynamic loss scaler to a Trainer (reference
    ``amp.py:init_trainer``)."""
    from ...gluon.trainer import Trainer
    if isinstance(optimizer_or_trainer, Trainer):
        optimizer_or_trainer._amp_loss_scaler = LossScaler()
        optimizer_or_trainer._amp_original_scale = optimizer_or_trainer._scale
    else:
        raise TypeError("optimizer_or_trainer should be a Gluon Trainer; "
                        f"got {type(optimizer_or_trainer)}")


def unscale(optimizer_or_trainer):
    """Divide the gradients by the current loss scale (reference
    ``amp.py:unscale``)."""
    scaler = getattr(optimizer_or_trainer, "_amp_loss_scaler", None)
    if scaler is None:
        return
    with torch.no_grad():
        for g in grads_of(optimizer_or_trainer._params):
            g.div_(scaler.loss_scale)


@contextlib.contextmanager
def scale_loss(loss, optimizer_or_trainer):
    """Scale the loss for the backward; on exit set the trainer's rescale
    so that ``step`` unscales, zero the gradients on overflow and move the
    dynamic scale (reference ``amp.py:scale_loss``)."""
    scaler = getattr(optimizer_or_trainer, "_amp_loss_scaler", None)
    if scaler is None:
        yield loss
        return
    optimizer_or_trainer._scale = (optimizer_or_trainer._amp_original_scale
                                   / scaler.loss_scale)
    if isinstance(loss, (list, tuple)):
        yield [l * scaler.loss_scale for l in loss]
    else:
        yield loss * scaler.loss_scale
    overflow = scaler.has_overflow(optimizer_or_trainer._params)
    if overflow:
        with torch.no_grad():
            for g in grads_of(optimizer_or_trainer._params):
                g.zero_()
    scaler.update_scale(overflow)


def _conditions(conditional_fp32_ops):
    cond = {}
    for (opname, attr, values) in (conditional_fp32_ops or ()):
        cond.setdefault(opname, []).append((attr, set(values)))
    return cond


def convert_symbol(sym, target_dtype="bfloat16", target_dtype_ops=None,
                   fp32_ops=None, conditional_fp32_ops=None,
                   excluded_sym_names=None, data_names=None,
                   cast_optional_params=False):
    """Graph rewrite inserting ``amp_cast``/``amp_multicast`` (reference
    ``amp.py:convert_symbol`` -> ``src/nnvm/low_precision_pass.cc:257``),
    node for node the JAX package's, so the two give the same JSON.

    Inputs of target-list ops are cast to ``target_dtype`` and inputs of
    fp32-list ops back to float32, auxiliary inputs excepted; a
    multi-input widest-type op gets one ``amp_multicast``.  Casts are
    shared per (tensor, dtype).  ``conditional_fp32_ops`` is ``[(op_name,
    attr_name, [values]), ...]``: matching nodes are forced to fp32.
    ``data_names`` and ``cast_optional_params`` are taken for the
    reference's signature and do nothing, as in the JAX package."""
    lp16 = set(target_dtype_ops if target_dtype_ops is not None
               else lists.TARGET_DTYPE_OPS)
    fp32 = set(fp32_ops if fp32_ops is not None else lists.FP32_OPS)
    widest = set(lists.WIDEST_TYPE_OPS)
    excluded = set(excluded_sym_names or ())
    cond = _conditions(conditional_fp32_ops)
    tgt_str = "bfloat16" if target_dtype == "bfloat16" \
        else str(np_dtype(target_dtype))
    cast_op = _reg.require("amp_cast")
    multi_op = _reg.require("amp_multicast")

    new_out = {}          # (id(old node), output) -> (new node, output)
    cast_cache = {}       # (id(new node), output, dtype) -> (node, output)
    counter = [0]

    def cast_to(pair, dtype_str):
        key = (id(pair[0]), pair[1], dtype_str)
        if key not in cast_cache:
            counter[0] += 1
            cnode = _Node(cast_op, f"amp_cast_{counter[0]}", [pair],
                          {"dtype": dtype_str}, 1)
            cast_cache[key] = (cnode, 0)
        return cast_cache[key]

    for node in sym._topo():
        if node.op is None:
            nn = _Node(None, node.name, [], dict(node.attrs or {}), 1,
                       dict(node.attr_dict))
        else:
            ins = [new_out[(id(p), i)] for (p, i) in node.inputs]
            opname = node.op.name
            aux = AUX_INPUTS.get(opname, {})    # positions, never cast
            force_fp32 = opname in fp32 or any(
                str(node.attrs.get(attr)) in values
                for (attr, values) in cond.get(opname, ()))
            if node.name in excluded:
                pass
            elif force_fp32:
                ins = [p if i in aux else cast_to(p, "float32")
                       for i, p in enumerate(ins)]
            elif opname in lp16:
                ins = [p if i in aux else cast_to(p, tgt_str)
                       for i, p in enumerate(ins)]
            elif opname in widest and len(ins) > 1:
                counter[0] += 1
                mnode = _Node(multi_op, f"amp_multicast_{counter[0]}", ins,
                              {"num_outputs": str(len(ins))}, len(ins))
                ins = [(mnode, i) for i in range(len(ins))]
            nn = _Node(node.op, node.name, ins, dict(node.attrs),
                       node.num_outputs, dict(node.attr_dict))
        for i in range(node.num_outputs):
            new_out[(id(node), i)] = (nn, i)
    return Symbol([new_out[(id(n), i)] for (n, i) in sym._outputs])


def convert_model(sym, arg_params, aux_params, target_dtype="bfloat16",
                  target_dtype_ops=None, fp32_ops=None,
                  conditional_fp32_ops=None, excluded_sym_names=None,
                  cast_optional_params=False):
    """Convert a symbolic checkpoint for low-precision inference (reference
    ``amp.py:convert_model``): :func:`convert_symbol`'s graph, and the
    weights of target-list layers stored in ``target_dtype`` (their
    inserted ``amp_cast`` then changes nothing).  A parameter that any
    fp32-forced op reads stays float32.  ``arg_params`` and
    ``aux_params`` are ``{name: NDArray}``; the auxiliary states are
    returned as they are."""
    new_sym = convert_symbol(
        sym, target_dtype=target_dtype, target_dtype_ops=target_dtype_ops,
        fp32_ops=fp32_ops, conditional_fp32_ops=conditional_fp32_ops,
        excluded_sym_names=excluded_sym_names,
        cast_optional_params=cast_optional_params)
    tgt = np_dtype(target_dtype)
    excluded = set(excluded_sym_names or ())
    lp16_layers = set(target_dtype_ops if target_dtype_ops is not None
                      else lists.TARGET_DTYPE_OPS)
    fp32_layers = set(fp32_ops if fp32_ops is not None else lists.FP32_OPS)
    cond = _conditions(conditional_fp32_ops)
    lp16_params, fp32_params = set(), set()
    for node in sym._topo():
        if node.op is None or node.name in excluded:
            continue
        opname = node.op.name
        force_fp32 = opname in fp32_layers or any(
            str(node.attrs.get(attr)) in values
            for (attr, values) in cond.get(opname, ()))
        if force_fp32 or opname in lp16_layers:
            for p, _ in node.inputs:
                if p.op is None:
                    (fp32_params if force_fp32 else lp16_params).add(p.name)
    lp16_params -= fp32_params
    new_args = {k: (v.astype(tgt) if k in lp16_params else v)
                for k, v in arg_params.items()}
    return new_sym, new_args, dict(aux_params)


def convert_hybrid_block(block, target_dtype="bfloat16",
                         target_dtype_ops=None, fp32_ops=None,
                         conditional_fp32_ops=None, excluded_sym_names=None,
                         ctx=None, cast_optional_params=False):
    """Store a block's product weights in bfloat16 (reference
    ``amp.py:convert_hybrid_block``): every float32 parameter of two or
    more axes (dense and convolution weights, embeddings) becomes bf16;
    biases and normalisation parameters stay float32.  Returns
    ``block``."""
    for param in block.collect_params().values():
        t = param._data
        if t is not None and t.dim() >= 2 and t.dtype == torch.float32:
            t.data = t.data.to(torch.bfloat16)
            param._dtype = torch.bfloat16
    return block
