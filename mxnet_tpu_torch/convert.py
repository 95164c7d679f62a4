"""Carry weights from the JAX package's Gluon models into the port.

``load_from_gluon`` carries any Gluon block whose port counterpart has the
same structure (the ResNets, for one): the JAX block's ``save_parameters``
writes an MXNet ``.params`` file and the port's ``load_parameters`` reads it
by structural name, so nothing but the file crosses over.

``module_params`` carries a Module's weights: its ``get_params()`` (the
JAX package's or the port's) as ``{name: numpy array}`` dicts, which the
other package's ``Module.set_params`` takes by name; symbolic parameter
names are the graph's own, identical in both packages, so nothing is
renamed.  Checkpoint files (``model.save_checkpoint``,
``Module.save_checkpoint``) are MXNet's format in both packages and load
in either with ``model.load_checkpoint`` or ``Module.load``.

Low precision: float16 crosses as float16.  numpy has no bfloat16 (the
JAX package's arrays carry ``ml_dtypes``' type, whose ``dtype.name`` is
``"bfloat16"``), so a bf16 value crosses as its exact float32 values and
is cast back on arrival: ``bert_state_dict_from_gluon`` gives a bf16
tensor, ``module_params`` float32 arrays that ``Module.set_params`` casts
to the bound arrays' dtypes, and ``load_from_gluon`` reads the JAX
package's ``.params`` file, which holds bf16 as float32, with
``cast_dtype=True``.

``bert_state_dict_from_gluon`` takes a JAX ``BERTModel``'s
``collect_params()`` as numpy arrays (``{name: p.data().asnumpy()}``), strips
the net's own ``prefix`` (``bertmodel0_``; its counter depends on how many
models the process built) and maps each remaining name by its place in the
model, not by a global counter.  Dense weights are already ``(out, in)`` as
``nn.Linear`` stores them, so nothing is transposed.
"""
from __future__ import annotations

import re

import numpy as np
import torch

__all__ = ["load_from_gluon", "module_params", "bert_state_dict_from_gluon"]


def load_from_gluon(gluon_block, port_block, filename):
    """Write ``gluon_block``'s parameters to ``filename`` with its own
    ``save_parameters`` and load them into ``port_block``; deferred shapes
    in the port take the file's.  Returns ``port_block``."""
    gluon_block.save_parameters(str(filename))
    port_block.load_parameters(str(filename), cast_dtype=True)
    return port_block


def _host_array(value):
    """``value`` as numpy, a bf16 one as its exact float32 values."""
    a = np.asarray(value)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _tensor(value):
    """A float tensor of ``value``: float16 stays float16, bfloat16 is
    carried as float32 and cast back, anything else becomes float32."""
    a = np.asarray(value)
    if a.dtype == np.float16:
        return torch.from_numpy(a.copy())
    t = torch.from_numpy(np.array(a, dtype=np.float32))
    return t.to(torch.bfloat16) if a.dtype.name == "bfloat16" else t

def module_params(module):
    """``(arg_params, aux_params)`` of a bound, initialised Module of either
    package, as ``{name: numpy array}`` on the host."""
    arg_params, aux_params = module.get_params()
    return ({k: _host_array(v.asnumpy()) for k, v in arg_params.items()},
            {k: _host_array(v.asnumpy()) for k, v in aux_params.items()})

# Gluon name (prefix stripped) -> port state-dict key.  The norms are
# positional inside their scope: the model's first LayerNorm is the
# embedding norm, its second the masked-LM decoder's; in a layer, the first
# is the attention norm and the FFN's own is under ``ffn_``.
_BERT_RULES = [
    (r"word_embed_weight", "word_embed.weight"),
    (r"type_embed_weight", "token_type_embed.weight"),
    (r"pos_embed_weight", "position_embed.weight"),
    (r"layernorm0_(gamma|beta)", r"embed_norm.\1"),
    (r"enc_layer(\d+)_attn_qkv_(weight|bias)",
     r"encoder.layers.\1.attention.qkv.\2"),
    (r"enc_layer(\d+)_attn_out_(weight|bias)",
     r"encoder.layers.\1.attention.proj.\2"),
    (r"enc_layer(\d+)_layernorm0_(gamma|beta)",
     r"encoder.layers.\1.attn_norm.\2"),
    (r"enc_layer(\d+)_ffn_ffn1_(weight|bias)",
     r"encoder.layers.\1.ffn.ffn_1.\2"),
    (r"enc_layer(\d+)_ffn_ffn2_(weight|bias)",
     r"encoder.layers.\1.ffn.ffn_2.\2"),
    (r"enc_layer(\d+)_ffn_layernorm0_(gamma|beta)",
     r"encoder.layers.\1.ffn.layer_norm.\2"),
    (r"pooler_(weight|bias)", r"pooler.\1"),
    (r"dec_t_(weight|bias)", r"decoder_transform.\1"),
    (r"layernorm1_(gamma|beta)", r"decoder_norm.\1"),
    (r"decoder_bias", "decoder_bias"),
    (r"nsp_(weight|bias)", r"nsp_classifier.\1"),
]


def bert_state_dict_from_gluon(params, prefix):
    """``{gluon name: ndarray}`` -> ``{port key: float tensor}`` for
    ``BERTModel.load_state_dict``.  Raises ``KeyError`` on a name outside
    ``prefix`` or one the port has no place for."""
    out = {}
    for name, value in params.items():
        if not name.startswith(prefix):
            raise KeyError(f"{name!r} does not start with prefix {prefix!r}")
        rest = name[len(prefix):]
        for pattern, target in _BERT_RULES:
            m = re.fullmatch(pattern, rest)
            if m:
                out[m.expand(target)] = _tensor(value)
                break
        else:
            raise KeyError(f"no port parameter for {name!r}")
    return out
