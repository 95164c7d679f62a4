"""Dtype inference for ``Symbol.infer_type`` (the port's copy of
``mxnet_tpu/symbol/dtype_infer.py``, limited to the ops of the port's
table).

A fixpoint pass over the graph.  Each op has a rule that, given partly
known input and output dtypes (``None`` is unknown), fills in what it can,
in both directions, as the reference's ``type_assign`` does.  The default
rule is the reference's ``ElemwiseType``: every input and output takes one
dtype.  Ops with dtype-forcing attributes (``Cast``, ``amp_cast``,
``Embedding``, ``one_hot``, ``topk``/``argsort``, the creation and sampling
ops) or mixed-dtype signatures (BatchNorm's float32 statistics for float16
data, the index inputs of ``take``/``pick``/``gather_nd``/``where``) have
rules of their own.  One departure: ``shape_array``/``size_array`` are
int64, as MXNet 1.5 and the port's ops make them (the JAX package runs
without 64-bit integers and makes them int32).
"""

import numpy as _np

from ..base import np_dtype

__all__ = ["infer_dtypes", "parse_dtype"]


def parse_dtype(v):
    """Normalise a user/attr dtype spec to a numpy dtype (``None`` stays
    ``None`` = unknown; otherwise base.np_dtype, incl. bfloat16 and MX
    int codes)."""
    if v is None:
        return None
    if isinstance(v, str) and v == "bf16":
        v = "bfloat16"
    return np_dtype(v)


_F32 = _np.dtype(_np.float32)


def _is_f16(dt):
    return dt is not None and dt == _np.dtype(_np.float16)


class _TypeError_(ValueError):
    pass


def _assign(slot_list, i, dt, where):
    """reference ``type_assign``: fill an unknown slot or check equality."""
    if dt is None or i >= len(slot_list):
        return False
    cur = slot_list[i]
    if cur is None:
        slot_list[i] = dt
        return True
    if cur != dt:
        raise _TypeError_(
            "inferred dtype %s conflicts with %s at %s" % (dt, cur, where))
    return False


def _unify(ins, outs, name, in_idx=None, out_idx=None):
    """ElemwiseType: one dtype across the chosen input/output slots."""
    in_idx = range(len(ins)) if in_idx is None else in_idx
    out_idx = range(len(outs)) if out_idx is None else out_idx
    known = None
    for i in in_idx:
        if i < len(ins) and ins[i] is not None:
            known = ins[i]
            break
    if known is None:
        for i in out_idx:
            if i < len(outs) and outs[i] is not None:
                known = outs[i]
                break
    if known is None:
        return False
    ch = False
    for i in in_idx:
        ch |= _assign(ins, i, known, name)
    for i in out_idx:
        ch |= _assign(outs, i, known, name)
    return ch


def _attr_dtype(attrs, key="dtype", default=None):
    v = attrs.get(key)
    if v is None or str(v) in ("None", ""):
        return parse_dtype(default) if default is not None else None
    return parse_dtype(v)


# ------------------------------------------------------------------ rules
# rule(attrs, ins, outs, name) -> bool (changed); may raise _TypeError_.

def _rule_cast(attrs, ins, outs, name):
    return _assign(outs, 0, _attr_dtype(attrs, "dtype", "float32"), name)


def _rule_creation(attrs, ins, outs, name):
    # _zeros/_ones/_arange/_full/_eye/samplers: dtype attr, default f32
    ch = False
    dt = _attr_dtype(attrs, "dtype", "float32")
    for i in range(len(outs)):
        ch |= _assign(outs, i, dt, name)
    return ch


def _rule_embedding(attrs, ins, outs, name):
    # indexing_op.h EmbeddingOpType: weight<->output unify, seeded by the
    # dtype attr; the index input is unconstrained
    ch = _unify(ins, outs, name, in_idx=(1,), out_idx=(0,))
    if len(ins) > 1 and ins[1] is None and outs[0] is None:
        dt = _attr_dtype(attrs, "dtype", "float32")
        ch |= _assign(ins, 1, dt, name)
        ch |= _assign(outs, 0, dt, name)
    return ch


def _rule_batchnorm(attrs, ins, outs, name):
    # batch_norm.cc BatchNormType: float16 data keeps float32
    # gamma/beta/moving stats; other dtypes keep the data dtype
    d = ins[0] if ins else None
    if d is None and outs and outs[0] is not None:
        d = outs[0]
    if d is None:
        return False
    ch = _assign(ins, 0, d, name)
    p = _F32 if _is_f16(d) else d
    for i in range(1, len(ins)):
        ch |= _assign(ins, i, p, name)
    ch |= _assign(outs, 0, d, name)
    for i in range(1, len(outs)):
        ch |= _assign(outs, i, p, name)
    return ch


def _rule_norm_stats(attrs, ins, outs, name):
    # LayerNorm: out[0] follows data; the saved mean/std outputs are
    # float32 accumulators (verified vs ops/nn.py; moments is NOT here —
    # its var output keeps the data dtype)
    ch = _unify(ins, outs, name, out_idx=(0,))
    for i in range(1, len(outs)):
        ch |= _assign(outs, i, _F32, name)
    return ch


def _rule_data_index(attrs, ins, outs, name):
    # take/pick/batch_take/gather_nd/boolean_mask: data<->out unify,
    # the index input (pos 1) is unconstrained
    return _unify(ins, outs, name,
                  in_idx=[i for i in range(len(ins)) if i != 1])


def _rule_scatter_like(attrs, ins, outs, name):
    # scatter_nd(data, indices, ...): indices free at pos 1
    return _unify(ins, outs, name,
                  in_idx=[i for i in range(len(ins)) if i != 1])


def _rule_where(attrs, ins, outs, name):
    # condition is unconstrained; branches and output unify
    return _unify(ins, outs, name,
                  in_idx=[i for i in range(len(ins)) if i != 0])


def _rule_topk(attrs, ins, outs, name):
    ret = str(attrs.get("ret_typ", "indices"))
    idt = _attr_dtype(attrs, "dtype", "float32")
    ch = False
    if ret == "value":
        ch |= _unify(ins, outs, name)
    elif ret == "both":
        ch |= _unify(ins, outs, name, out_idx=(0,))
        ch |= _assign(outs, 1, idt, name)
    elif ret == "mask":
        ch |= _unify(ins, outs, name)
    else:  # indices
        ch |= _assign(outs, 0, idt, name)
    return ch


def _rule_argsort(attrs, ins, outs, name):
    return _assign(outs, 0, _attr_dtype(attrs, "dtype", "float32"), name)


def _rule_one_hot(attrs, ins, outs, name):
    return _assign(outs, 0, _attr_dtype(attrs, "dtype", "float32"), name)


def _rule_shape_array(attrs, ins, outs, name):
    return _assign(outs, 0, _np.dtype(_np.int64), name)


def _rule_amp_multicast(attrs, ins, outs, name):
    # cast every output to the widest known input float
    order = ["float16", "bfloat16", "float32", "float64"]
    widest = None
    for dt in ins:
        if dt is not None and str(dt) in order:
            if widest is None or order.index(str(dt)) > order.index(str(widest)):
                widest = dt
    if widest is None:
        return False
    ch = False
    for i in range(len(outs)):
        ch |= _assign(outs, i, widest, name)
    return ch


def _rule_same(attrs, ins, outs, name):
    return _unify(ins, outs, name)


_RULES = {
    "Cast": _rule_cast, "cast": _rule_cast, "amp_cast": _rule_cast,
    "amp_multicast": _rule_amp_multicast,
    "Embedding": _rule_embedding,
    "BatchNorm": _rule_batchnorm,
    "LayerNorm": _rule_norm_stats,
    "take": _rule_data_index, "pick": _rule_data_index,
    "batch_take": _rule_data_index, "gather_nd": _rule_data_index,
    "scatter_nd": _rule_scatter_like,
    "_contrib_boolean_mask": _rule_data_index,
    "where": _rule_where,
    "topk": _rule_topk, "argsort": _rule_argsort,
    "one_hot": _rule_one_hot,
    "shape_array": _rule_shape_array, "size_array": _rule_shape_array,
}

# creation/sampling ops: no (typed) inputs, dtype attr decides
for _n in ("_zeros", "_ones", "_full", "_arange", "_eye", "_linspace",
           "_random_uniform", "_random_normal",
           "_random_gamma", "_random_exponential", "_random_poisson",
           "_random_negative_binomial",
           "_random_generalized_negative_binomial", "_random_randint"):
    _RULES.setdefault(_n, _rule_creation)


def infer_dtypes(sym, given, raise_on_conflict=True):
    """Run the fixpoint dtype pass over ``sym``.

    ``given``: {variable name: dtype}.  Returns {(id(node), out_idx):
    numpy dtype or None} covering every variable and op output.  Variables
    also honour their stored ``__dtype__`` attr (explicit ``given``
    entries win, like repeated type_assign in the reference pass).
    """
    nodes = sym._topo()
    t = {}          # (id(node), out_idx) -> dtype | None
    for node in nodes:
        for i in range(node.num_outputs if node.op is not None else 1):
            t[(id(node), i)] = None
    for node in nodes:
        if node.op is None:
            dt = given.get(node.name)
            if dt is None:
                dt = node.attr_dict.get("__dtype__")
            if dt is not None:
                t[(id(node), 0)] = parse_dtype(dt)

    def step(node):
        name = node.name
        attrs = node.attrs or {}
        n_out = node.num_outputs if node.op is not None else 1
        ins = [t[(id(p), i)] for (p, i) in node.inputs]
        outs = [t[(id(node), i)] for i in range(n_out)]
        rule = _RULES.get(node.op.name, _rule_same)
        try:
            rule(attrs, ins, outs, name)
        except _TypeError_:
            if raise_on_conflict:
                raise
            return False
        # Merge results back into the global map.  Only newly-known slots
        # count as change (so the fixpoint terminates), and a slot left
        # None by the rule never clobbers a known dtype — the same
        # producer output may feed several input positions of one node
        # (e.g. take(d, d)) with the rule filling only one of them.
        changed = False
        pairs = list(zip(((id(p), i) for (p, i) in node.inputs), ins)) + \
            list(zip(((id(node), i) for i in range(n_out)), outs))
        for key, dt in pairs:
            if dt is None:
                continue
            cur = t[key]
            if cur is None:
                t[key] = dt
                changed = True
            elif cur != dt:
                if raise_on_conflict:
                    raise _TypeError_(
                        "inferred dtype %s conflicts with %s at %s"
                        % (dt, cur, name))
        return changed

    op_nodes = [n for n in nodes if n.op is not None]
    for _ in range(64):
        changed = False
        for node in op_nodes:
            changed |= step(node)
        for node in reversed(op_nodes):
            changed |= step(node)
        if not changed:
            break
    return t
