"""Symbol: MXNet's declarative graph over the op table (the port's
counterpart of ``mxnet_tpu/symbol/symbol.py``).

A Symbol is a list of outputs of ``_Node``s: an op of the port's table
(``ops/registry.py``) with its attributes and input entries, or a variable
(``op is None``).  The graph, its auto-names (``convolution0``,
``fullyconnected1_weight``), its listing order and its JSON are the JAX
package's, so that a graph written by either package loads in the other
and names parameters alike.

What differs from the JAX package, and why:

- Shapes.  ``infer_shape`` runs every op on ``meta`` tensors (shapes and
  dtypes, no data), after the per-layer rules fill the parameter shapes
  (:func:`_infer_layer_param_shapes`), instead of ``jax.eval_shape``.
- Execution.  There is no whole-graph compiler: the Executor
  (``executor.py``) walks :meth:`Symbol._plan`, the graph in topological
  order, one op-table call per node, and torch autograd takes the
  gradient of that walk.
- ``_num_outputs_of`` counts ``split_v2``'s outputs from
  ``indices_or_sections`` too; the JAX package reads only ``sections`` /
  ``indices`` and gives ``split_v2(x, 2)`` one output (a reference-side
  defect, ROADMAP.md).
- No attribute scopes (``mx.AttrScope``) and no control-flow nodes
  (``contrib.foreach``/``while_loop``, ROADMAP.md).
"""
from __future__ import annotations

import ast
import inspect
import json

import numpy as np
import torch

from ..base import np_dtype, parse_bool, parse_float, parse_int, \
    parse_tuple, torch_dtype
from ..ndarray.register import _FRONTEND_ATTRS as _FRONTEND, _signature
from ..ops import registry as _reg
from ..ops.random_ops import STOCHASTIC_OPS

__all__ = ["Symbol", "Variable", "var", "Group", "load", "load_json",
           "make_sym_func"]

# Ops with auxiliary-state inputs (input position -> aux name suffix)
AUX_INPUTS = {"BatchNorm": {3: "moving_mean", 4: "moving_var"}}
# Ops that read the executor's training flag
MODE_DEPENDENT = {"Dropout", "BatchNorm"}
# Ops that draw from a generator
STOCHASTIC = STOCHASTIC_OPS | {"Dropout"}
# Loss heads: their gradient ignores the head gradient
LOSS_OPS = {"SoftmaxOutput", "Softmax"}

_SIG_CACHE = {}


def _op_params(op):
    """(names of keyword parameters, takes ``**kwargs``, takes ``ctx``)."""
    sig = _SIG_CACHE.get(id(op.fn))
    if sig is None:
        params = inspect.signature(op.fn).parameters
        sig = (set(params),
               any(p.kind is inspect.Parameter.VAR_KEYWORD
                   for p in params.values()),
               "ctx" in params)
        _SIG_CACHE[id(op.fn)] = sig
    return sig


def _filter_attrs(op, attrs):
    """Drop the generic attributes MXNet JSON stores beside an op's own
    (``ctx_group``, ``__lr_mult__``...) that its function does not take."""
    names, var_kw, _ = _op_params(op)
    if var_kw:
        return dict(attrs)
    return {k: v for k, v in attrs.items() if k in names or k in _FRONTEND}


class _Node:
    """One op instantiation in the graph (a variable when ``op is None``)."""

    __slots__ = ("op", "name", "inputs", "attrs", "num_outputs", "attr_dict")

    def __init__(self, op, name, inputs, attrs, num_outputs=1,
                 attr_dict=None):
        self.op = op                 # OpDef, or None for a variable
        self.name = name
        self.inputs = inputs         # [(producing _Node, output index)]
        self.attrs = attrs
        self.num_outputs = num_outputs
        self.attr_dict = attr_dict or {}


class Symbol:
    """A list of graph outputs (an MXNet Symbol is a list of outputs)."""

    def __init__(self, outputs):
        self._outputs = outputs      # [(_Node, output index)]

    # ------------------------------------------------------------- structure
    @property
    def name(self):
        node, idx = self._outputs[0]
        if len(self._outputs) == 1:
            if node.op is None or node.num_outputs == 1:
                return node.name
            return f"{node.name}_output{idx}"
        return None

    def __len__(self):
        return len(self._outputs)

    def __getitem__(self, idx):
        if isinstance(idx, str):
            idx = self.list_outputs().index(idx)
        return Symbol([self._outputs[idx]])

    def __iter__(self):
        for i in range(len(self._outputs)):
            yield self[i]

    def get_internals(self):
        """Every node's outputs, in topological order."""
        outs = []
        for node in self._topo():
            n = 1 if node.op is None else node.num_outputs
            outs.extend((node, i) for i in range(n))
        return Symbol(outs)

    def get_children(self):
        node, _ = self._outputs[0]
        return Symbol(list(node.inputs)) if node.inputs else None

    def _topo(self):
        seen, order = set(), []
        for root, _ in self._outputs:
            stack = [(root, False)]
            while stack:
                node, done = stack.pop()
                if done:
                    order.append(node)
                    continue
                if id(node) in seen:
                    continue
                seen.add(id(node))
                stack.append((node, True))
                for p, _i in reversed(node.inputs):
                    if id(p) not in seen:
                        stack.append((p, False))
        return order

    # --------------------------------------------------------------- listing
    def _aux_ids(self):
        """Variables at an op's auxiliary-state positions in this graph."""
        aux = set()
        for node in self._topo():
            for pos in AUX_INPUTS.get(getattr(node.op, "name", None), ()):
                if pos < len(node.inputs) and node.inputs[pos][0].op is None:
                    aux.add(id(node.inputs[pos][0]))
        return aux

    def _is_aux(self, node, aux_ids):
        return node.op is None and (bool(node.attr_dict.get("__aux__"))
                                    or id(node) in aux_ids)

    def list_arguments(self):
        aux_ids = self._aux_ids()
        return [n.name for n in self._topo()
                if n.op is None and not self._is_aux(n, aux_ids)]

    def list_auxiliary_states(self):
        aux_ids = self._aux_ids()
        return [n.name for n in self._topo() if self._is_aux(n, aux_ids)]

    def list_inputs(self):
        return [n.name for n in self._topo() if n.op is None]

    def list_outputs(self):
        names = []
        for node, idx in self._outputs:
            if node.op is None:
                names.append(node.name)
            elif node.num_outputs == 1:
                names.append(node.name + "_output")
            else:
                names.append(f"{node.name}_output{idx}")
        return names

    def list_attr(self):
        return dict(self._outputs[0][0].attr_dict)

    def attr(self, key):
        return self._outputs[0][0].attr_dict.get(key)

    def attr_dict(self):
        out = {}
        for node in self._topo():
            d = {k: v for k, v in node.attr_dict.items()
                 if not k.startswith("__")}
            d.update({k: str(v) for k, v in (node.attrs or {}).items()})
            if d:
                out[node.name] = d
        return out

    def _set_attr(self, **kwargs):
        self._outputs[0][0].attr_dict.update(kwargs)

    # ------------------------------------------------------------- inference
    def infer_shape(self, *args, **kwargs):
        """``(arg_shapes, out_shapes, aux_shapes)`` from the shapes of some
        arguments (positional in ``list_arguments`` order, or by name);
        ``(None, None, None)`` when they do not determine every shape."""
        try:
            specs, outs = self._infer(self._given(args, kwargs))
        except KeyError:
            return None, None, None
        return ([tuple(specs[n].shape) for n in self.list_arguments()],
                [tuple(o.shape) for o in outs],
                [tuple(specs[n].shape) for n in self.list_auxiliary_states()])

    def infer_shape_partial(self, *args, **kwargs):
        try:
            return self.infer_shape(*args, **kwargs)
        except Exception:
            return None, None, None

    def _given(self, args, kwargs):
        shapes = {n: s for n, s in zip(self.list_arguments(), args)
                  if s is not None}
        shapes.update({k: v for k, v in kwargs.items() if v is not None})
        return shapes

    def infer_type(self, *args, **kwargs):
        """``(arg_types, out_types, aux_types)`` as numpy dtypes, by the
        fixpoint pass of ``dtype_infer.py``; unconstrained ones are
        float32."""
        t, by_name = self._run_type_pass(args, kwargs)
        f32 = np.dtype(np.float32)
        return ([by_name.get(n) or f32 for n in self.list_arguments()],
                [t[(id(n), i)] or f32 for n, i in self._outputs],
                [by_name.get(n) or f32
                 for n in self.list_auxiliary_states()])

    def infer_type_partial(self, *args, **kwargs):
        t, by_name = self._run_type_pass(args, kwargs,
                                         raise_on_conflict=False)
        return ([by_name.get(n) for n in self.list_arguments()],
                [t[(id(n), i)] for n, i in self._outputs],
                [by_name.get(n) for n in self.list_auxiliary_states()])

    def _run_type_pass(self, args, kwargs, raise_on_conflict=True):
        from .dtype_infer import infer_dtypes, parse_dtype
        arg_names = self.list_arguments()
        var_nodes = {n.name: n for n in self._topo() if n.op is None}
        given = {n: parse_dtype(ty) for n, ty in zip(arg_names, args)
                 if ty is not None}
        for k, v in kwargs.items():
            if v is None:
                continue
            if k not in var_nodes:
                raise ValueError(
                    f"infer_type keyword {k!r} matches no variable in this "
                    f"symbol (arguments: {arg_names})")
            given[k] = parse_dtype(v)
        t = infer_dtypes(self, given, raise_on_conflict=raise_on_conflict)
        return t, {name: t[(id(node), 0)] for name, node in var_nodes.items()}

    def _infer(self, shapes, dtypes=None):
        """``({variable name: meta tensor}, [output meta tensors])``.

        Parameter shapes come from the layer rules (the reference's
        FInferShape registrations) and every op runs on ``meta`` tensors
        in inference mode.  Sweeps repeat while they make progress, so a
        parameter behind a shape-preserving op is found on a later sweep.
        Raises ``KeyError`` naming a variable whose shape stays unknown."""
        dtypes = dtypes or {}
        specs, out_specs = {}, {}

        def var_spec(name, shape, dtype=None):
            dt = dtype or dtypes.get(name) or np.float32
            try:
                tdt = torch_dtype(dt)
            except (TypeError, KeyError, ValueError):
                tdt = torch.float32
            s = torch.empty(tuple(int(x) for x in shape), dtype=tdt,
                            device="meta")
            specs[name] = s
            return s

        for node in self._topo():
            if node.op is not None:
                continue
            vdt = node.attr_dict.get("__dtype__") or None
            if node.name in shapes:
                out_specs[(id(node), 0)] = var_spec(
                    node.name, shapes[node.name], vdt)
            elif node.attr_dict.get("__shape__"):
                shp = ast.literal_eval(node.attr_dict["__shape__"])
                if shp is not None and all(isinstance(x, int) and x > 0
                                           for x in shp):
                    out_specs[(id(node), 0)] = var_spec(node.name, shp, vdt)
        pending, progress = self._plan(False), True
        while pending and progress:
            progress, still = False, []
            for step in pending:
                node, fn, attrs, slots, _ = step
                _infer_layer_param_shapes(node, out_specs, var_spec)
                ins = [out_specs.get(s) for s in slots]
                if any(s is None for s in ins):
                    still.append(step)
                    continue
                if not slots and _op_params(node.op)[2]:
                    attrs["ctx"] = "meta"
                outs = fn(*ins, **attrs)
                if not isinstance(outs, (tuple, list)):
                    outs = (outs,)
                for i, o in enumerate(outs):
                    out_specs[(id(node), i)] = o
                progress = True
            pending = still
        if pending:
            missing = next(p.name for step in pending
                           for p, i in step[0].inputs
                           if (id(p), i) not in out_specs)
            raise KeyError(missing)
        return specs, [out_specs[(id(n), i)] for n, i in self._outputs]

    # ------------------------------------------------------------ execution
    def _plan(self, is_train):
        """The graph as a list of steps for the Executor: ``(node, op
        function, attrs, input slots, aux update)``, attributes filtered and
        parsed once; a slot is ``(id(node), output index)``."""
        steps = []
        for node in self._topo():
            if node.op is None:
                continue
            attrs = {k: _literal(v) for k, v in
                     _filter_attrs(node.op, node.attrs).items()}
            if node.op.name in MODE_DEPENDENT:
                attrs["__training__"] = bool(is_train)
            aux = None
            if node.op.name in AUX_INPUTS and is_train and \
                    not parse_bool(node.attrs.get("use_global_stats", False)):
                aux = (parse_float(node.attrs.get("momentum", 0.9), 0.9),
                       [node.inputs[pos][0].name
                        for pos in sorted(AUX_INPUTS[node.op.name])])
            steps.append((node, node.op.fn, attrs,
                          [(id(p), i) for p, i in node.inputs], aux))
        return steps

    # ------------------------------------------------------------------ bind
    def simple_bind(self, ctx=None, grad_req="write", type_dict=None,
                    stype_dict=None, group2ctx=None, shared_arg_names=None,
                    shared_exec=None, shared_buffer=None, **kwargs):
        """Make zeroed argument, gradient and auxiliary arrays from the
        shapes in ``kwargs`` and bind them.  ``ctx=None`` is the current
        context: the GPU unless the caller runs under ``with mx.cpu():``."""
        from ..executor import Executor, check_single_context
        from ..ndarray import zeros
        ctx = check_single_context(ctx)
        arg_names = self.list_arguments()
        type_dict = dict(type_dict or {})
        try:
            specs, _ = self._infer(dict(kwargs), type_dict)
        except KeyError as e:
            raise ValueError(f"cannot infer shapes from the provided inputs "
                             f"{sorted(kwargs)}: {e} stays unknown") from None
        args = {n: zeros(specs[n].shape, ctx=ctx,
                         dtype=type_dict.get(n, np_dtype(specs[n].dtype)))
                for n in arg_names}
        auxs = {n: zeros(specs[n].shape, ctx=ctx,
                         dtype=np_dtype(specs[n].dtype))
                for n in self.list_auxiliary_states()}
        reqs = _grad_reqs(grad_req, arg_names)
        grads = {n: zeros(a.shape, ctx=ctx, dtype=a.dtype)
                 for n, a in args.items() if reqs.get(n, "write") != "null"}
        return Executor(self, ctx, args, grads, reqs, auxs)

    def bind(self, ctx=None, args=None, args_grad=None, grad_req="write",
             aux_states=None, group2ctx=None, shared_exec=None):
        """Bind given arrays (lists in ``list_arguments`` /
        ``list_auxiliary_states`` order, or dicts by name)."""
        from ..executor import Executor, check_single_context
        ctx = check_single_context(ctx)
        arg_names = self.list_arguments()
        aux_names = self.list_auxiliary_states()
        if isinstance(args, (list, tuple)):
            args = dict(zip(arg_names, args))
        if isinstance(args_grad, (list, tuple)):
            args_grad = dict(zip(arg_names, args_grad))
        if isinstance(aux_states, (list, tuple)):
            aux_states = dict(zip(aux_names, aux_states))
        aux_states = dict(aux_states or {})
        missing = [n for n in aux_names if n not in aux_states]
        if missing:
            raise ValueError(f"aux states {missing} must be provided to bind")
        return Executor(self, ctx, dict(args or {}), dict(args_grad or {}),
                        _grad_reqs(grad_req, arg_names), aux_states)

    def eval(self, ctx=None, **kwargs):
        return self.bind(ctx=ctx, args=kwargs, grad_req="null").forward()

    # ------------------------------------------------------------- serialize
    def tojson(self):
        """MXNet graph JSON (the JAX package's ``tojson``, byte for byte)."""
        order = self._topo()
        index = {id(n): i for i, n in enumerate(order)}
        nodes, arg_nodes = [], []
        for i, node in enumerate(order):
            if node.op is None:
                arg_nodes.append(i)
                nodes.append({"op": "null", "name": node.name,
                              "attrs": {k: str(v) for k, v in
                                        node.attr_dict.items()
                                        if k != "__aux__"},
                              "inputs": []})
            else:
                nodes.append({
                    "op": node.op.name, "name": node.name,
                    "attrs": {k: str(v) for k, v in node.attrs.items()},
                    "inputs": [[index[id(p)], idx, 0]
                               for p, idx in node.inputs]})
        heads = [[index[id(n)], i, 0] for n, i in self._outputs]
        return json.dumps({"nodes": nodes, "arg_nodes": arg_nodes,
                           "node_row_ptr": list(range(len(nodes) + 1)),
                           "heads": heads,
                           "attrs": {"mxnet_version": ["int", 10500]}},
                          indent=2)

    def save(self, fname):
        with open(fname, "w") as f:
            f.write(self.tojson())

    def __getstate__(self):
        return {"json": self.tojson()}

    def __setstate__(self, state):
        self._outputs = load_json(state["json"])._outputs

    def __copy__(self):
        return load_json(self.tojson())

    def __deepcopy__(self, memo):
        return self.__copy__()

    # ------------------------------------------------------------ arithmetic
    def __add__(self, other):
        return _binary_sym("broadcast_add", "_plus_scalar", self, other)

    __radd__ = __add__

    def __sub__(self, other):
        return _binary_sym("broadcast_sub", "_minus_scalar", self, other)

    def __rsub__(self, other):
        if isinstance(other, Symbol):
            return other.__sub__(self)
        return _scalar_sym("_rminus_scalar", self, other)

    def __mul__(self, other):
        return _binary_sym("broadcast_mul", "_mul_scalar", self, other)

    __rmul__ = __mul__

    def __truediv__(self, other):
        return _binary_sym("broadcast_div", "_div_scalar", self, other)

    def __rtruediv__(self, other):
        if isinstance(other, Symbol):
            return other.__truediv__(self)
        return _scalar_sym("_rdiv_scalar", self, other)

    def __pow__(self, other):
        return _binary_sym("broadcast_power", "_power_scalar", self, other)

    def __neg__(self):
        return _scalar_sym("_mul_scalar", self, -1.0)

    def __gt__(self, other):
        return _binary_sym("broadcast_greater", "_greater_scalar", self,
                           other)

    def __ge__(self, other):
        return _binary_sym("broadcast_greater_equal",
                           "_greater_equal_scalar", self, other)

    def __lt__(self, other):
        return _binary_sym("broadcast_lesser", "_lesser_scalar", self, other)

    def __le__(self, other):
        return _binary_sym("broadcast_lesser_equal", "_lesser_equal_scalar",
                           self, other)

    def __eq__(self, other):
        if isinstance(other, (Symbol, int, float)):
            return _binary_sym("broadcast_equal", "_equal_scalar", self,
                               other)
        return NotImplemented

    def __ne__(self, other):
        if isinstance(other, (Symbol, int, float)):
            return _binary_sym("broadcast_not_equal", "_not_equal_scalar",
                               self, other)
        return NotImplemented

    def __hash__(self):
        return id(self)

    def __bool__(self):
        raise TypeError(
            "The truth value of a Symbol is ambiguous (comparisons build "
            "graph nodes); use explicit ops or identity checks instead")

    def __repr__(self):
        name = self.name
        return f"<Symbol {name if name else 'Grouped'}>"

    def reshape(self, shape):
        return _invoke_sym(_reg.require("reshape"), [self], {"shape": shape})

    def astype(self, dtype):
        return _invoke_sym(_reg.require("cast"), [self], {"dtype": str(dtype)})

    def sum(self, axis=None, keepdims=False):
        return _invoke_sym(_reg.require("sum"), [self],
                           {"axis": axis, "keepdims": keepdims})

    def mean(self, axis=None, keepdims=False):
        return _invoke_sym(_reg.require("mean"), [self],
                           {"axis": axis, "keepdims": keepdims})

    def transpose(self, axes=None):
        return _invoke_sym(_reg.require("transpose"), [self], {"axes": axes})

    def __call__(self, *args, name=None, **kwargs):
        """Compose: bind this symbol's variables to other symbols,
        positionally in ``list_arguments`` order or by name."""
        repl = {}
        for k, v in kwargs.items():
            if not isinstance(v, Symbol):
                raise TypeError(f"compose expects Symbol for {k!r}")
            repl[k] = v
        if args:
            free = [n for n in self.list_arguments() if n not in repl]
            if len(args) > len(free):
                raise ValueError("too many positional compose arguments")
            for a, n in zip(args, free):
                if not isinstance(a, Symbol):
                    raise TypeError("compose expects Symbol arguments")
                repl[n] = a
        unknown = set(repl) - set(self.list_inputs())
        if unknown:
            raise ValueError(f"compose: no variable named {sorted(unknown)}")
        for k, v in repl.items():
            if len(v._outputs) != 1:
                raise ValueError(
                    f"compose: {k!r} is bound to a grouped symbol with "
                    f"{len(v._outputs)} outputs; composition takes "
                    f"single-output operands only")
        new_out = {}
        for node in self._topo():
            if node.op is None:
                new_out[id(node)] = list(repl[node.name]._outputs) \
                    if node.name in repl else \
                    [(_Node(None, node.name, [], {}, 1,
                            dict(node.attr_dict)), 0)]
                continue
            nn_ = _Node(node.op, node.name,
                        [new_out[id(p)][i] for p, i in node.inputs],
                        dict(node.attrs), node.num_outputs,
                        dict(node.attr_dict))
            new_out[id(node)] = [(nn_, i) for i in range(node.num_outputs)]
        result = Symbol([new_out[id(n)][i] for n, i in self._outputs])
        if name is not None and len(result._outputs) == 1 \
                and result._outputs[0][0].op is not None:
            result._outputs[0][0].name = name
        return result


def _literal(v):
    """A JSON attribute string as the value it spells (``"(3, 3)"`` ->
    ``(3, 3)``, ``"True"`` -> ``True``, ``"1e-05"`` -> ``1e-05``); other
    strings (``"relu"``, ``"float32"``) and non-strings as they are."""
    if not isinstance(v, str):
        return v
    try:
        return ast.literal_eval(v)
    except (ValueError, SyntaxError):
        return {"true": True, "false": False}.get(v.lower(), v)


def _grad_reqs(grad_req, arg_names):
    if isinstance(grad_req, str):
        return {n: grad_req for n in arg_names}
    if isinstance(grad_req, (list, tuple)):
        return dict(zip(arg_names, grad_req))
    return dict(grad_req)


# ---------------------------------------------------------------------------
# Construction
# ---------------------------------------------------------------------------
def Variable(name, attr=None, shape=None, lr_mult=None, wd_mult=None,
             dtype=None, init=None, stype=None, **kwargs):
    """``mx.sym.Variable``: a named input, with optional shape, dtype,
    learning-rate and weight-decay multipliers and initializer."""
    ad = dict(attr or {})
    if shape is not None:
        ad["__shape__"] = str(tuple(shape))
    if dtype is not None:
        try:
            ad["__dtype__"] = np_dtype(dtype).name
        except (TypeError, KeyError, ValueError):
            ad["__dtype__"] = str(dtype)
    if lr_mult is not None:
        ad["lr_mult"] = str(lr_mult)
    if wd_mult is not None:
        ad["wd_mult"] = str(wd_mult)
    if init is not None:
        ad["__init__"] = init if isinstance(init, str) else init.dumps()
    return Symbol([(_Node(None, name, [], {}, 1, ad), 0)])


var = Variable


def Group(symbols):
    outs = []
    for s in symbols:
        outs.extend(s._outputs)
    return Symbol(outs)


def load_json(json_str):
    """A Symbol from MXNet graph JSON: the current format and the pre-1.0
    one (2-element input entries, ``attr``/``param`` keys, BatchNorm
    without its auxiliary inputs)."""
    g = json.loads(json_str)
    nodes = []
    for spec in g["nodes"]:
        attrs = {}
        attrs.update(spec.get("param") or {})
        attrs.update(spec.get("attr") or {})
        attrs.update(spec.get("attrs") or {})
        if spec["op"] == "null":
            nodes.append(_Node(None, spec["name"], [], {}, 1, attrs))
            continue
        if spec.get("subgraphs"):
            raise NotImplementedError(
                f"node {spec['name']!r}: control-flow subgraphs are not "
                f"ported (ROADMAP.md, queue 1 item 7)")
        op = _reg.get(spec["op"])
        if op is None:
            raise ValueError(f"unknown op in JSON: {spec['op']}")
        inputs = [(nodes[e[0]], e[1]) for e in spec["inputs"]]
        node = _Node(op, spec["name"], inputs, attrs,
                     _num_outputs_of(op, attrs, len(inputs)))
        if op.name in AUX_INPUTS:
            if len(inputs) == 3:
                # legacy graphs omit the aux inputs; they are appended, and
                # do not join ``nodes``, which mirrors the JSON numbering
                for suffix in ("moving_mean", "moving_var"):
                    inputs.append((_Node(None, f"{spec['name']}_{suffix}",
                                         [], {}, 1, {"__aux__": "1"}), 0))
            else:
                for pos in AUX_INPUTS[op.name]:
                    if pos < len(inputs) and inputs[pos][0].op is None:
                        inputs[pos][0].attr_dict["__aux__"] = "1"
        nodes.append(node)
    return Symbol([(nodes[e[0]], e[1]) for e in g["heads"]])


def load(fname):
    with open(fname) as f:
        return load_json(f.read())


_NAME_COUNTER = {}


def _auto_name(opname):
    base = opname.lower().lstrip("_")
    c = _NAME_COUNTER.get(base, 0)
    _NAME_COUNTER[base] = c + 1
    return f"{base}{c}"


def _num_outputs_of(op, attrs, n_inputs):
    """Visible outputs of a node (BatchNorm's statistics are not
    composable, as in the reference)."""
    name = op.name
    if name in AUX_INPUTS:
        return 1
    if name == "split":
        return parse_int(attrs.get("num_outputs", 1), 1)
    if name == "split_v2":
        ios = attrs.get("indices_or_sections")
        if ios is not None:
            ios = _literal(ios)
            if isinstance(ios, int):
                return ios
            return len(parse_tuple(ios)) + 1
        sections = parse_int(attrs.get("sections", 0), 0)
        if sections:
            return sections
        return len(parse_tuple(attrs.get("indices", ())) or ()) + 1
    if name == "moments":
        return 2
    if name == "_contrib_MultiBoxTarget":
        return 3
    if name in ("topk", "histogram"):
        return 2 if name == "histogram" or attrs.get("ret_typ") == "both" \
            else 1
    return 1


def _invoke_sym(op, sym_inputs, attrs, name=None):
    inputs = []
    for s in sym_inputs:
        if not isinstance(s, Symbol):
            raise TypeError(f"symbol op {op.name} requires Symbol inputs, "
                            f"got {type(s)}")
        inputs.extend(s._outputs)
    attrs = {k: v for k, v in attrs.items() if v is not None}
    node = _Node(op, name or _auto_name(op.name), inputs, attrs,
                 _num_outputs_of(op, attrs, len(inputs)))
    return Symbol([(node, i) for i in range(node.num_outputs)])


def _scalar_sym(opname, s, scalar):
    return _invoke_sym(_reg.require(opname), [s], {"scalar": float(scalar)})


def _binary_sym(opname, scalar_opname, lhs, rhs):
    if isinstance(lhs, Symbol) and isinstance(rhs, Symbol):
        return _invoke_sym(_reg.require(opname), [lhs, rhs], {})
    if isinstance(lhs, Symbol):
        return _scalar_sym(scalar_opname, lhs, rhs)
    return _scalar_sym(scalar_opname, rhs, lhs)


def make_sym_func(op):
    """The ``mx.sym`` function of an op: leading Symbols are its inputs,
    Symbol keywords named inputs (``data=``, ``weight=``), anything else an
    attribute.  A layer op makes the variables it is not given, named
    ``<node name>_<role>`` (``fc1_weight``)."""
    attr_names = _signature(op)[1]

    def fn(*args, name=None, attr=None, **kwargs):
        i, sym_inputs = 0, []
        while i < len(args) and isinstance(args[i], Symbol):
            sym_inputs.append(args[i])
            i += 1
        attrs = {}
        for v, pname in zip(args[i:], attr_names):
            attrs.setdefault(pname, v)
        named = {}
        for k, v in kwargs.items():
            if isinstance(v, Symbol):
                named[k] = v
            else:
                attrs[k] = v
        auto = name if name is not None else _auto_name(op.name)
        if op.name in LAYER_INPUTS:
            order = LAYER_INPUTS[op.name](attrs)
            supplied = dict(zip(order, sym_inputs))
            supplied.update(named)
            ins = []
            for k in order:
                if k not in supplied:
                    v = Variable(f"{auto}_{k}")
                    if k in AUX_INPUTS_BY_NAME.get(op.name, ()):
                        v._outputs[0][0].attr_dict["__aux__"] = True
                    supplied[k] = v
                ins.append(supplied[k])
        elif named:
            ins = sym_inputs + [named[k] for k in _input_order(named)]
        else:
            ins = sym_inputs
        res = _invoke_sym(op, ins, attrs, name=auto)
        if attr:
            res._outputs[0][0].attr_dict.update(attr)
        return res

    fn.__name__ = op.name
    fn.__doc__ = op.doc
    return fn


def _with_bias(default_no_bias):
    def inputs(attrs):
        no_bias = parse_bool(attrs.get("no_bias", default_no_bias))
        return ["data", "weight"] if no_bias else ["data", "weight", "bias"]
    return inputs


# The named inputs of layer ops (each op's ``ListArguments`` in MXNet)
LAYER_INPUTS = {
    "FullyConnected": _with_bias(False),
    "Convolution": _with_bias(False),
    "Deconvolution": _with_bias(True),
    "BatchNorm": lambda a: ["data", "gamma", "beta", "moving_mean",
                            "moving_var"],
    "LayerNorm": lambda a: ["data", "gamma", "beta"],
    "InstanceNorm": lambda a: ["data", "gamma", "beta"],
    "Embedding": lambda a: ["data", "weight"],
    "LeakyReLU": lambda a: (["data", "gamma"] if a.get("act_type") == "prelu"
                            else ["data"]),
    "SoftmaxOutput": lambda a: ["data", "label"],
    "Softmax": lambda a: ["data", "label"],
}

AUX_INPUTS_BY_NAME = {"BatchNorm": {"moving_mean", "moving_var"}}

# ops a parameter may sit behind without its shape changing
_SHAPE_PRESERVING = {"Cast", "cast", "_copy", "identity", "BlockGrad",
                     "stop_gradient", "amp_cast"}


def _infer_layer_param_shapes(node, out_specs, var_spec):
    """Fill the unknown shapes of a layer node's parameter variables from
    its attributes and its data's shape (FullyConnected's weight is
    ``(num_hidden, in_features)``, and so on)."""
    name = node.op.name
    if name not in LAYER_INPUTS:
        return
    roles = LAYER_INPUTS[name](node.attrs)
    data = out_specs.get((id(node.inputs[0][0]), node.inputs[0][1]))
    if data is None:
        return
    dshape, a = tuple(data.shape), node.attrs

    def fill(role, shape):
        if role not in roles:
            return
        pos = roles.index(role)
        if pos >= len(node.inputs):
            return
        p, i = node.inputs[pos]
        while p.op is not None and p.op.name in _SHAPE_PRESERVING and i == 0:
            p, i = p.inputs[0]
        if p.op is None and out_specs.get((id(p), i)) is None:
            out_specs[(id(p), i)] = var_spec(p.name, shape)

    if name == "FullyConnected":
        nh = parse_int(_literal(a.get("num_hidden")))
        flat = parse_bool(_literal(a.get("flatten", True)), True)
        fill("weight", (nh, int(np.prod(dshape[1:])) if flat
                        else int(dshape[-1])))
        fill("bias", (nh,))
    elif name in ("Convolution", "Deconvolution"):
        kernel = tuple(parse_tuple(a.get("kernel")))
        nf = parse_int(_literal(a.get("num_filter")))
        ng = parse_int(_literal(a.get("num_group", 1)), 1)
        layout = _literal(a.get("layout"))
        cax = 1 if layout in (None, "None", "") else str(layout).find("C")
        cin = int(dshape[cax])
        # Convolution (O, I / g, *k), Deconvolution (I, O / g, *k); the
        # weight follows the data's layout: (lead, tail, *k) or (lead, *k,
        # tail)
        lead, tail = (nf, cin // ng) if name == "Convolution" \
            else (cin, nf // ng)
        fill("weight", (lead, tail) + kernel if cax == 1
             else (lead,) + kernel + (tail,))
        fill("bias", (nf,))
    elif name == "BatchNorm":
        c = int(dshape[parse_int(_literal(a.get("axis", 1)), 1)])
        for r in ("gamma", "beta", "moving_mean", "moving_var"):
            fill(r, (c,))
    elif name == "LayerNorm":
        c = int(dshape[parse_int(_literal(a.get("axis", -1)), -1)])
        fill("gamma", (c,))
        fill("beta", (c,))
    elif name == "InstanceNorm":
        fill("gamma", (int(dshape[1]),))
        fill("beta", (int(dshape[1]),))
    elif name == "Embedding":
        fill("weight", (parse_int(_literal(a.get("input_dim"))),
                        parse_int(_literal(a.get("output_dim")))))
    elif name == "LeakyReLU":
        fill("gamma", (int(dshape[1]),))
    elif name in ("SoftmaxOutput", "Softmax"):
        if parse_bool(_literal(a.get("multi_output", False))):
            fill("label", (int(dshape[0]),) + dshape[2:])
        elif parse_bool(_literal(a.get("preserve_shape", False))):
            fill("label", dshape[:-1])
        else:
            fill("label", (int(dshape[0]),))


_COMMON_INPUTS = ["data", "lhs", "rhs", "label", "weight", "bias", "index",
                  "indices", "condition", "x", "y", "a", "b"]


def _input_order(named):
    return sorted(named, key=lambda k: _COMMON_INPUTS.index(k)
                  if k in _COMMON_INPUTS else 99)


# Fluent methods (MXNet generates them from the registry; the same list as
# the JAX package, limited to the names the port's table has)
_FLUENT_METHODS = (
    "max", "min", "prod", "argmax", "argmin", "argsort", "sort", "topk",
    "sqrt", "rsqrt", "cbrt", "log", "log2", "log10", "log1p", "exp",
    "expm1", "square", "abs", "sign", "round", "rint", "floor", "ceil",
    "trunc", "sigmoid", "tanh", "relu", "softmax", "log_softmax", "erf",
    "flatten", "norm", "nansum", "nanprod", "clip", "expand_dims",
    "squeeze", "split", "slice_axis", "slice_like", "take", "one_hot",
    "tile", "repeat", "pad", "flip", "reshape_like", "broadcast_to",
    "broadcast_like", "swapaxes", "diag", "sin", "cos", "tan", "arcsin",
    "arccos", "arctan", "sinh", "cosh", "arctanh", "degrees", "radians",
    "gamma", "gammaln",
)

for _name in _FLUENT_METHODS:
    if not hasattr(Symbol, _name) and _reg.get(_name) is not None:
        setattr(Symbol, _name, make_sym_func(_reg.get(_name)))
del _name
