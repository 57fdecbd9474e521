"""SameDiff — the declarative autodiff graph engine (counterpart:
``deeplearning4j_tpu/autodiff/samediff.py``; ref:
org.nd4j.autodiff.samediff.SameDiff + SDVariable + internal sessions).

A graph of named variables and op nodes over the op registry
(``ops/registry.py``): the graph namespaces (``sd.math``, ``sd.nn``,
``sd.cnn``, ``sd.rnn``, ``sd.loss``, ``sd.image``, ``sd.random``,
``sd.bitwise``, ``sd.linalg``, ``sd.reduce``, ``sd.shapes``,
``sd.updaters``) read the same registry as the eager namespaces.

The reference compiles the interpreted DAG into one executable with
``jax.jit``. Here ``output()``, ``fit()`` and ``calculateGradients()``
interpret the DAG eagerly, op by op, over the registry's torch functions
on the graph's device (``"cuda"`` unless ``device="cpu"``); gradients
come from autograd through that interpretation, so no op has gradient
code of its own. A node of the fused attention op on CUDA tensors
launches the attention kernels, as the registry routes it.

What a graph records matches the reference's, so graphs and files cross
between the packages:

- node and variable names: a node's outputs are ``base``, or
  ``base#i`` for an op with several outputs and ``base#i.j`` for a nested
  one, learned by running the op once on ``meta`` tensors (a
  placeholder's unknown dims read as 2, as the reference's
  ``jax.eval_shape``), else once on zeros on the host; an op that runs on
  neither records one output of unknown shape;
- the variable table's entries and the ``lit_N``/``const_N`` counter, so
  ``var(..., weightInit=)`` draws from ``fold_in(key(seed), len(vars))``
  the reference's bits (``models/random.py``);
- dtypes, written as the reference's strings (``"float32"``);
- the zip format of ``save``/``load`` (``graph.json``, ``values/*.npy``,
  ``values.json``, ``training.json`` and ``updaterState/*.npy`` in the
  optimizer state's flatten order).

A Python number given to an op becomes a ``lit_N`` constant that keeps
JAX's weak typing: it takes the dtype of the op's other operand (a
float32 tensor times ``2.0`` stays float32). As in the reference, a saved
and reloaded literal is an ordinary constant.

Control flow (``ifCond``, ``whileLoop``, ``forLoop``) runs host-side
over eager sub-graph runs. As the reference (whose ``lax.while_loop`` has
no reverse mode), a gradient through a ``while`` node is refused.
"""
from __future__ import annotations

import io
import json
import re
import warnings
import zipfile
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from deeplearning4j_tpu_torch import default_device
from deeplearning4j_tpu_torch.ndarray import dtypes as _dt
from deeplearning4j_tpu_torch.ndarray.array import NDArray, as_tensor
from deeplearning4j_tpu_torch.ops import registry as _registry
from deeplearning4j_tpu_torch.train import regularization as _rega
from deeplearning4j_tpu_torch.train import updaters as _upd


class VariableType:
    VARIABLE = "VARIABLE"      # trainable
    CONSTANT = "CONSTANT"
    PLACEHOLDER = "PLACEHOLDER"
    ARRAY = "ARRAY"            # op output


def _dtype_name(dtype) -> Optional[str]:
    """The reference's string for a dtype ('float32', 'int32', 'bool')."""
    if dtype is None:
        return None
    return str(_dt.resolve(dtype)).replace("torch.", "")


def _dtype_of(value) -> Optional[torch.dtype]:
    """A torch dtype for a recorded dtype (torch, numpy or a name), None
    where there is none (a dtype the port has no counterpart of)."""
    if value is None:
        return None
    try:
        return _dt.resolve(value)
    except (TypeError, KeyError):
        return None


@dataclass
class SDVariable:
    """Symbolic variable (ref: org.nd4j.autodiff.samediff.SDVariable)."""
    sd: "SameDiff"
    name: str
    varType: str
    shape: Optional[Tuple] = None
    dtype: Any = None

    # -- fluent math (all route via the registry)
    def _bin(self, other, opname):
        return self.sd._op("math", opname, [self, other])

    def add(self, other):
        return self._bin(other, "add")

    def sub(self, other):
        return self._bin(other, "sub")

    def mul(self, other):
        return self._bin(other, "mul")

    def div(self, other):
        return self._bin(other, "div")

    def rsub(self, other):
        return self.sd._op("math", "sub", [other, self])

    def rdiv(self, other):
        return self.sd._op("math", "div", [other, self])

    def pow(self, other):
        return self._bin(other, "pow")

    def neg(self):
        return self.sd._op("math", "neg", [self])

    __add__ = add
    __radd__ = add
    __sub__ = sub
    __rsub__ = rsub
    __mul__ = mul
    __rmul__ = mul
    __truediv__ = div
    __rtruediv__ = rdiv
    __pow__ = pow
    __neg__ = neg

    def mmul(self, other):
        return self.sd._op("linalg", "matmul", [self, other])

    __matmul__ = mmul

    def sum(self, *dims, keepdims=False):
        return self.sd._op("reduce", "sum", [self], dims=list(dims) or None, keepdims=keepdims)

    def mean(self, *dims, keepdims=False):
        return self.sd._op("reduce", "mean", [self], dims=list(dims) or None, keepdims=keepdims)

    def max(self, *dims, keepdims=False):
        return self.sd._op("reduce", "max", [self], dims=list(dims) or None, keepdims=keepdims)

    def min(self, *dims, keepdims=False):
        return self.sd._op("reduce", "min", [self], dims=list(dims) or None, keepdims=keepdims)

    def std(self, *dims, biasCorrected=True):
        return self.sd._op("reduce", "std", [self], dims=list(dims) or None,
                           biasCorrected=biasCorrected)

    def argmax(self, dim=None):
        return self.sd._op("reduce", "argmax", [self], dims=dim)

    def reshape(self, *shape):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return self.sd._op("shape", "reshape", [self], shape=list(shape))

    def transpose(self, *axes):
        return self.sd._op("shape", "transpose", [self], axes=list(axes) or None)

    def rename(self, new_name: str) -> "SDVariable":
        self.sd._rename(self.name, new_name)
        return self

    # -- evaluation
    def eval(self, placeholders: Optional[dict] = None) -> NDArray:
        return self.sd.output(placeholders or {}, [self.name])[self.name]

    def getArr(self) -> Optional[NDArray]:
        v = self.sd._values.get(self.name)
        return NDArray(v) if v is not None else None

    def setArray(self, arr):
        self.sd._values[self.name] = self.sd._tensor(arr)
        self.sd._weak.pop(self.name, None)

    def gradient(self) -> Optional["SDVariable"]:
        return self.sd._vars.get(f"grad::{self.name}")


@dataclass
class SameDiffOp:
    """One graph node (ref: org.nd4j.autodiff.samediff.internal.SameDiffOp)."""
    namespace: str
    opname: str
    inputs: List[str]           # var names (positional)
    outputs: List[str]
    kwargs: dict = field(default_factory=dict)


def _compute_dtype(cfg) -> Optional[torch.dtype]:
    """TrainingConfig.computeDtype -> torch dtype (None = as-imported)."""
    return {"HALF": torch.bfloat16, "BFLOAT16": torch.bfloat16,
            "FLOAT": None, None: None}[
                (cfg.computeDtype or "").upper() or None]


def _cast_fp32_leaves(tree: Dict[str, Any], cdt) -> Dict[str, Any]:
    """Float32 leaves cast to the compute dtype (no-op for cdt None and
    for leaves already cast)."""
    if cdt is None:
        return tree
    return {k: (v.to(cdt) if isinstance(v, torch.Tensor)
                and v.dtype == torch.float32 else v)
            for k, v in tree.items()}


@dataclass
class TrainingConfig:
    """(ref: org.nd4j.autodiff.samediff.TrainingConfig).

    ``computeDtype``: mixed-precision training — float32 leaves (params,
    constants, float placeholders) are cast to this dtype at the top of
    the step, the loss is reduced in float32, and gradients land back on
    the float32 master params through the cast's backward. "BFLOAT16",
    and "HALF" as the reference's alias for it, mean bfloat16; None or
    "FLOAT" run in the imported dtype."""
    updater: _upd.Updater = field(default_factory=lambda: _upd.Adam(1e-3))
    dataSetFeatureMapping: List[str] = field(default_factory=list)
    dataSetLabelMapping: List[str] = field(default_factory=list)
    regularization: List[_rega.Regularization] = field(default_factory=list)
    minimize: bool = True
    computeDtype: Optional[str] = None  # None | "BFLOAT16"/"HALF" | "FLOAT"

    def __post_init__(self):
        if (self.computeDtype or "").upper() == "HALF":
            warnings.warn(
                "TrainingConfig.computeDtype='HALF' maps to bfloat16 (the "
                "reference's HALF is IEEE float16; bf16 shares fp32's "
                "exponent range, so checkpoints/losses will differ from an "
                "IEEE float16 run in the tails). Use 'BFLOAT16' to state "
                "the dtype explicitly.", stacklevel=3)


class GraphNamespace:
    """Graph op surface generated from the registry (ref: generated SDMath etc.)."""

    def __init__(self, sd: "SameDiff", namespace: str):
        self._sd = sd
        self._namespace = namespace

    def __getattr__(self, opname: str):
        if f"{self._namespace}.{opname}" not in _registry.REGISTRY:
            raise AttributeError(f"no op {self._namespace}.{opname}")

        def call(*args, **kwargs):
            name = None
            if args and isinstance(args[0], str) and self._namespace != "shape":
                name, args = args[0], args[1:]
            return self._sd._op(self._namespace, opname, list(args), name=name,
                                **kwargs)

        return call


def _is_scalar(a) -> bool:
    """A Python number (weakly typed in JAX), not a numpy scalar."""
    return isinstance(a, (int, float, bool)) and not isinstance(a, np.generic)


class SameDiff:
    """The graph container (ref: org.nd4j.autodiff.samediff.SameDiff), on
    ``device`` (default ``"cuda"``; without CUDA it raises unless
    ``device="cpu"``)."""

    # Accepted for the reference's API; the port runs every step on its own
    # (the reference's fused chunks are value-identical to that loop).
    fuseSteps: int = 8
    listenerReplayLag: int = 16

    def __init__(self, device=None):
        self.device = default_device(device)
        self._vars: Dict[str, SDVariable] = {}
        self._ops: List[SameDiffOp] = []
        self._values: Dict[str, torch.Tensor] = {}  # VARIABLE/CONSTANT values
        self._weak: Dict[str, Any] = {}  # literal name -> its Python number
        self._counter = 0
        self._loss_vars: List[str] = []
        self._training_config: Optional[TrainingConfig] = None
        self._opt_state = None
        self._tx = None
        self._plan_cache: Dict = {}
        self._removed_by_rewrite: Optional[Dict[str, str]] = None
        self._last_grads: Optional[Dict[str, torch.Tensor]] = None
        self.listeners: List[Any] = []
        # graph namespaces
        self.math = GraphNamespace(self, "math")
        self.nn = GraphNamespace(self, "nn")
        self.cnn = GraphNamespace(self, "cnn")
        self.rnn = GraphNamespace(self, "rnn")
        self.loss = GraphNamespace(self, "loss")
        self.image = GraphNamespace(self, "image")
        self.bitwise = GraphNamespace(self, "bitwise")
        self.linalg = GraphNamespace(self, "linalg")
        self.reduce = GraphNamespace(self, "reduce")
        self.shapes = GraphNamespace(self, "shape")
        self.random = GraphNamespace(self, "random")    # ref: SDRandom
        self.updaters = GraphNamespace(self, "updaters")  # ref: updater ops

    @staticmethod
    def create(device=None) -> "SameDiff":
        return SameDiff(device)

    def _tensor(self, x, dtype=None) -> torch.Tensor:
        """``x`` (NDArray, tensor, numpy or Python data) as a tensor on the
        graph's device; numpy and Python data in their canonical dtype."""
        if isinstance(x, NDArray):
            x = x.torch
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=dtype)
        return as_tensor(x, self.device, dtype)

    # ------------------------------------------------------------- variables
    def _fresh(self, base: str) -> str:
        while True:
            self._counter += 1
            name = f"{base}_{self._counter}"
            if name not in self._vars:
                return name

    def var(self, name: str, shape_or_value=None, dtype=torch.float32,
            weightInit: Optional[str] = None, seed: int = 0) -> SDVariable:
        """Trainable variable (ref: SameDiff.var). Accepts an initial value or
        a shape (+ optional WeightInit scheme)."""
        dt = _dt.canonical(_dt.resolve(dtype))
        if isinstance(shape_or_value, (tuple, list)) and all(
                isinstance(s, int) for s in shape_or_value):
            shape = tuple(shape_or_value)
            if weightInit:
                from deeplearning4j_tpu_torch.models import random as _prng
                from deeplearning4j_tpu_torch.nn.conf import weights as _w
                fan_in = shape[0] if len(shape) > 1 else 1
                fan_out = shape[-1]
                key = _prng.fold_in(_prng.prng_key(seed), len(self._vars))
                value = _w.init(weightInit, key, shape, fan_in, fan_out, dt,
                                self.device)
            else:
                value = torch.zeros(shape, dtype=dt, device=self.device)
        else:
            value = self._tensor(shape_or_value, dt)
        v = SDVariable(self, name, VariableType.VARIABLE, tuple(value.shape), value.dtype)
        self._vars[name] = v
        self._values[name] = value
        self._weak.pop(name, None)
        return v

    def constant(self, name_or_value, value=None) -> SDVariable:
        if value is None:
            name, value = self._fresh("const"), name_or_value
        else:
            name = name_or_value
        arr = self._tensor(value)
        v = SDVariable(self, name, VariableType.CONSTANT, tuple(arr.shape), arr.dtype)
        self._vars[name] = v
        self._values[name] = arr
        # a Python number is weakly typed, as jnp.asarray makes it
        if _is_scalar(value):
            self._weak[name] = value
        else:
            self._weak.pop(name, None)
        return v

    def placeHolder(self, name: str, shape=None, dtype=torch.float32) -> SDVariable:
        v = SDVariable(self, name, VariableType.PLACEHOLDER,
                       tuple(shape) if shape else None,
                       _dt.canonical(_dt.resolve(dtype)))
        self._vars[name] = v
        return v

    def _rename(self, old: str, new: str):
        v = self._vars.pop(old)
        v.name = new
        self._vars[new] = v
        if old in self._values:
            self._values[new] = self._values.pop(old)
        if old in self._weak:
            self._weak[new] = self._weak.pop(old)
        for op in self._ops:
            op.inputs = [new if i == old else i for i in op.inputs]
            op.outputs = [new if o == old else o for o in op.outputs]
        self._loss_vars = [new if l == old else l for l in self._loss_vars]
        self._plan_cache.clear()

    def variables(self) -> List[SDVariable]:
        return list(self._vars.values())

    def getVariable(self, name: str) -> SDVariable:
        return self._vars[name]

    def hasVariable(self, name: str) -> bool:
        return name in self._vars

    # ------------------------------------------------------------------ ops
    def _weak_args(self, names: Sequence[str], args: list) -> list:
        """JAX's weak typing of literals: each literal input takes the
        dtype of its weak promotion with the node's first other tensor."""
        if not self._weak or not any(n in self._weak for n in names):
            return args
        ref = next((a for n, a in zip(names, args) if n not in self._weak
                    and isinstance(a, torch.Tensor)), None)
        if ref is None:
            return args
        return [a.to(torch.result_type(ref, self._weak[n]))
                if n in self._weak else a for n, a in zip(names, args)]

    def _abstract(self, name: str) -> torch.Tensor:
        """A meta tensor of what ``name`` holds: its value's shape and
        dtype, or its recorded ones with unknown dims read as 2 (the
        reference's abstract-eval convention)."""
        if name in self._values:
            v = self._values[name]
            return torch.empty(v.shape, dtype=v.dtype, device="meta")
        v = self._vars[name]
        shape = tuple(2 if s is None else s for s in (v.shape or ()))
        return torch.empty(shape, dtype=v.dtype or torch.float32, device="meta")

    @staticmethod
    def _shape_run(fn, metas: List[torch.Tensor]):
        """``fn(*inputs)`` on meta tensors, else on zeros on the host — what
        it returns, or None where it runs on neither."""
        try:
            return fn(*metas)
        except Exception:
            pass
        try:
            zeros = [torch.zeros(m.shape, dtype=m.dtype) for m in metas]
            with torch.no_grad():
                return fn(*zeros)
        except Exception:
            return None

    def _op(self, namespace: str, opname: str, sym_inputs: Sequence, name=None,
            **kwargs) -> Union[SDVariable, Tuple]:
        """Append a node. Inputs may be SDVariables or literals (literals become
        constants). Output arity is discovered by a run on meta tensors."""
        spec = _registry.get(opname, namespace)
        in_names = []
        for a in sym_inputs:
            if isinstance(a, SDVariable):
                in_names.append(a.name)
            elif isinstance(a, (int, float, bool)):   # np.float64 too, as there
                c = self.constant(self._fresh("lit"), a)
                in_names.append(c.name)
            else:
                c = self.constant(self._fresh("const"), a)
                in_names.append(c.name)

        with _dt.device_scope(self.device):
            out_struct = self._shape_run(
                lambda *xs: spec.fn(*self._weak_args(in_names, list(xs)), **kwargs),
                [self._abstract(n) for n in in_names])

        multi = isinstance(out_struct, (tuple, list))
        count = len(out_struct) if multi else 1
        base = name or self._fresh(opname)
        out_names = [base] if not multi else [f"{base}#{i}" for i in range(count)]
        self._ops.append(SameDiffOp(namespace, opname, in_names, out_names, dict(kwargs)))
        outs = []
        flat_struct = out_struct if multi else [out_struct]
        for i, on in enumerate(out_names):
            st = flat_struct[i]
            if isinstance(st, (tuple, list)):
                # nested (e.g. lstmLayer's second output (h, c)): name.j
                sub = []
                for j, s in enumerate(st):
                    v = _struct_var(self, f"{on}.{j}", s)
                    self._vars[v.name] = v
                    sub.append(v)
                self._vars[on] = SDVariable(self, on, VariableType.ARRAY, None, None)
                outs.append(tuple(sub))
            else:
                v = _struct_var(self, on, st)
                self._vars[on] = v
                outs.append(v)
        self._plan_cache.clear()
        return tuple(outs) if multi else outs[0]

    def convertToVariable(self, var) -> SDVariable:
        """Constant -> trainable VARIABLE in place (ref:
        SameDiff.convertToVariable; used to fine-tune imported frozen graphs
        whose weights arrive as constants)."""
        v = var if isinstance(var, SDVariable) else self._vars[var]
        if v.varType == VariableType.CONSTANT:
            v.varType = VariableType.VARIABLE
            self._weak.pop(v.name, None)
            self._plan_cache.clear()
        return v

    def convertAllConstantsToVariables(self, min_size: int = 3) -> int:
        """Make every float constant with ≥ min_size elements trainable —
        the standard prelude to fine-tuning an imported frozen graph (small
        constants are attribute carriers: axes, scales, epsilons). Returns
        the number converted."""
        n = 0
        for v in list(self._vars.values()):
            if v.varType == VariableType.CONSTANT and v.shape \
                    and v.dtype is not None and "float" in _dtype_name(v.dtype) \
                    and int(np.prod(v.shape)) >= min_size:
                self.convertToVariable(v)
                n += 1
        return n

    def fuseAttention(self) -> int:
        """Collapse imported matmul->[scale]->softmax->matmul attention
        chains onto the kernel-backed ``scaledDotProductAttentionFused``
        op (see autodiff/rewrites.py for the matched pattern and its
        guarantees). Returns the number of sites fused. Typical use::

            sd = TensorflowFrameworkImporter.runImport(graph_def)
            sd.convertAllConstantsToVariables()
            sd.fuseAttention()        # optional kernel-fusion pass
        """
        from deeplearning4j_tpu_torch.autodiff.rewrites import fuse_attention
        return fuse_attention(self)

    def convertToConstant(self, var) -> SDVariable:
        """VARIABLE -> frozen constant in place (ref: SameDiff.convertToConstant)."""
        v = var if isinstance(var, SDVariable) else self._vars[var]
        if v.varType == VariableType.VARIABLE:
            v.varType = VariableType.CONSTANT
            self._plan_cache.clear()
        return v

    # ----------------------------------------------------------- control flow
    # Each construct is one graph node holding sub-graphs (the reference's
    # lax.cond / lax.while_loop / lax.scan lowering); here the host decides
    # the branch or the next trip from the device's answer and runs the
    # sub-graph eagerly.

    def _trace_subgraph(self, fn, arg_vars: Sequence[SDVariable], extra_args: int = 0):
        """Run a SameDiffLambda-style ``fn(sub_sd, *args)`` against a fresh
        sub-SameDiff whose placeholders mirror ``arg_vars`` (+ ``extra_args``
        leading scalar int args, e.g. a loop counter)."""
        sub = SameDiff(self.device)
        args = []
        for i in range(extra_args):
            args.append(sub.placeHolder(f"__arg{i}", shape=(), dtype=torch.int32))
        for v in arg_vars:
            shape = tuple(2 if s is None else s for s in (v.shape or ()))
            args.append(sub.placeHolder(f"__sgin{len(args)}", shape=shape,
                                        dtype=v.dtype or torch.float32))
        out = fn(sub, *args)
        outs = list(out) if isinstance(out, (tuple, list)) else [out]
        return sub, [a.name for a in args], [o.name for o in outs]

    @staticmethod
    def _run_subgraph(sub: "SameDiff", in_names, in_vals, out_names, like=None):
        """The sub-graph's outputs for inputs ``in_vals``; with ``like`` (a
        tensor) its constants are moved to that tensor's device first
        (``meta`` for a shape run)."""
        values = sub._values
        if like is not None:
            values = {n: torch.empty(v.shape, dtype=v.dtype, device="meta")
                      if like.is_meta else v.to(like.device)
                      for n, v in values.items()}
        env = {**values, **dict(zip(in_names, in_vals))}
        env = sub._interpret(env)
        return [env[n] for n in out_names]

    def _control_op(self, opname: str, input_vars: Sequence[SDVariable],
                    kwargs: dict, name: Optional[str]):
        """Append a control-flow node; output shapes from one run of its
        sub-graphs on meta tensors."""
        in_names = [v.name for v in input_vars]
        base = name or self._fresh(opname)

        def absval(v):
            shape = tuple(2 if s is None else s for s in (v.shape or ()))
            return torch.empty(shape, dtype=v.dtype or torch.float32, device="meta")

        node = SameDiffOp("control", opname, in_names, [], kwargs)
        out_struct = self._shape_run(lambda *xs: _abstract_control(node, list(xs)),
                                     [absval(v) for v in input_vars])
        # fallback arity: while/for return one value per input; "if" returns
        # one per input minus the predicate
        count = len(out_struct) if out_struct is not None else (
            len(in_names) - 1 if opname == "if" else len(in_names))
        node.outputs = [base] if count == 1 else [f"{base}#{i}" for i in range(count)]
        self._ops.append(node)
        outs = []
        for i, on in enumerate(node.outputs):
            v = _struct_var(self, on, out_struct[i] if out_struct is not None else None)
            self._vars[on] = v
            outs.append(v)
        self._plan_cache.clear()
        return outs[0] if len(outs) == 1 else tuple(outs)

    def _exec_control(self, node: SameDiffOp, args: list):
        """Run one control node on the host over its sub-graphs."""
        kw = node.kwargs
        if node.opname == "if":
            (sub_t, tin, tout) = kw["true_graph"]
            (sub_f, fin, fout) = kw["false_graph"]
            pred, rest = args[0], args[1:]
            if bool(torch.as_tensor(pred).reshape(()).to(torch.bool)):
                return tuple(self._run_subgraph(sub_t, tin, rest, tout))
            return tuple(self._run_subgraph(sub_f, fin, rest, fout))
        if node.opname == "while":
            (sub_c, cin, cout) = kw["cond_graph"]
            (sub_b, bin_, bout) = kw["body_graph"]
            state = [self._tensor(a) for a in args]
            if torch.is_grad_enabled() and any(s.requires_grad for s in state):
                raise ValueError(
                    f"while loop '{node.outputs[0]}': reverse-mode "
                    "differentiation does not flow through a while loop (as "
                    "the reference's lax.while_loop); use forLoop for "
                    "trainable iteration")
            # loop vars keep their initial dtypes (TF while-loop semantics;
            # also guards against literal-promotion drift after serde)
            dts = [s.dtype for s in state]
            while bool(torch.as_tensor(self._run_subgraph(sub_c, cin, state, cout)[0])
                       .to(torch.bool).reshape(())):
                new = self._run_subgraph(sub_b, bin_, state, bout)
                state = [self._tensor(n).to(d) for n, d in zip(new, dts)]
            return tuple(state)
        if node.opname == "for":
            (sub_b, bin_, bout) = kw["body_graph"]
            state = [self._tensor(a) for a in args]
            dts = [s.dtype for s in state]
            for i in range(kw["n_iter"]):
                it = torch.tensor(i, dtype=_dt.int_(), device=self.device)
                new = self._run_subgraph(sub_b, bin_, [it, *state], bout)
                state = [self._tensor(n).to(d) for n, d in zip(new, dts)]
            return tuple(state)
        raise ValueError(f"unknown control op {node.opname}")

    def ifCond(self, cond, trueBody, falseBody, inputs=(), name: Optional[str] = None):
        """Conditional (ref: SameDiff.ifCond — Switch/Merge in the
        reference). ``cond`` is a scalar-bool SDVariable in THIS graph;
        trueBody/falseBody are ``fn(sub_sd, *inputs)`` lambdas (ref:
        SameDiffLambda.define) returning one or more sub-graph vars.
        Differentiable through the branch taken."""
        inputs = list(inputs)
        tg = self._trace_subgraph(trueBody, inputs)
        fg = self._trace_subgraph(falseBody, inputs)
        assert len(tg[2]) == len(fg[2]), "branches must return the same arity"
        return self._control_op("if", [cond, *inputs],
                                {"true_graph": tg, "false_graph": fg}, name)

    def whileLoop(self, loopVars, condBody, loopBody, name: Optional[str] = None):
        """While loop (ref: SameDiff.whileLoop — Enter/Exit/NextIteration in
        the reference). ``condBody(sub_sd, *state)`` must return a scalar
        bool; ``loopBody(sub_sd, *state)`` returns the next state (same
        arity/shapes). As in the reference, gradients do not flow through
        a while loop (asking for one raises) — use forLoop for trainable
        iteration."""
        loopVars = list(loopVars)
        cg = self._trace_subgraph(condBody, loopVars)
        bg = self._trace_subgraph(loopBody, loopVars)
        assert len(bg[2]) == len(loopVars), "body must return one var per loop var"
        return self._control_op("while", loopVars,
                                {"cond_graph": cg, "body_graph": bg}, name)

    def forLoop(self, n_iter: int, loopVars, loopBody, name: Optional[str] = None):
        """Fixed-trip-count loop — differentiable, the replacement for
        trainable while loops. ``loopBody(sub_sd, i, *state)`` returns the
        next state."""
        loopVars = list(loopVars)
        bg = self._trace_subgraph(loopBody, loopVars, extra_args=1)
        assert len(bg[2]) == len(loopVars), "body must return one var per loop var"
        return self._control_op("for", loopVars,
                                {"body_graph": bg, "n_iter": int(n_iter)}, name)

    # ------------------------------------------------------------- execution
    def _needed_ops(self, output_names) -> List[SameDiffOp]:
        """Ancestor-subgraph pruning (ref: AbstractSession executes only ops
        required for the requested variables); cached per output set."""
        key = tuple(output_names)
        if key not in self._plan_cache:
            needed = set()
            for n in output_names:
                needed.add(n.split(".")[0] if "." in n else n)
            keep = []
            for node in reversed(self._ops):
                if any(o in needed for o in node.outputs):
                    keep.append(node)
                    needed.update(node.inputs)
            self._plan_cache[key] = list(reversed(keep))
        return self._plan_cache[key]

    def _interpret(self, values: Dict[str, Any], only_ops: Optional[List[SameDiffOp]] = None
                   ) -> Dict[str, Any]:
        """Interpret the DAG in topological (recorded) order over concrete
        values; each node is one call of its registry function, with the
        graph's device as this thread's array device (an op that makes a
        tensor from nothing, ``arange``, makes it there; other threads and
        ``nd.setDefaultDevice``'s setting are untouched)."""
        with _dt.device_scope(self.device):
            return self._interpret_nodes(dict(values), only_ops)

    def _interpret_nodes(self, env: Dict[str, Any], only_ops) -> Dict[str, Any]:
        for node in (only_ops if only_ops is not None else self._ops):
            args = [env[i] for i in node.inputs]
            if node.namespace == "control":
                out = self._exec_control(node, args)
                if len(node.outputs) == 1:
                    out = out[0]
            else:
                spec = _registry.get(node.opname, node.namespace)
                out = spec.fn(*self._weak_args(node.inputs, args), **node.kwargs)
            if len(node.outputs) == 1 and not isinstance(out, (tuple, list)):
                env[node.outputs[0]] = out
            else:
                for on, o in zip(node.outputs, out):
                    if isinstance(o, (tuple, list)):
                        for j, oo in enumerate(o):
                            env[f"{on}.{j}"] = oo
                    env[on] = o
        return env

    def _placeholders(self, placeholders: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        return {k: self._tensor(v) for k, v in placeholders.items()}

    def output(self, placeholders: Dict[str, Any], outputs: Union[str, Sequence[str]]
               ) -> Dict[str, NDArray]:
        """Whole-graph inference (ref: SameDiff.output/batchOutput)."""
        if isinstance(outputs, str):
            outputs = [outputs]
        removed = self._removed_by_rewrite
        if removed:
            for n in outputs:
                base = n.split(".")[0] if "." in n else n
                if base in removed:
                    raise ValueError(
                        f"variable '{n}' was an attention-chain intermediate "
                        f"removed by the {removed[base]} graph rewrite and "
                        f"can no longer be computed; request it before "
                        f"fusing, or skip the rewrite to keep it")
        ph = self._placeholders(placeholders)
        with torch.no_grad():
            env = self._interpret({**self._values, **ph},
                                  only_ops=self._needed_ops(tuple(outputs)))
        return {n: NDArray(env[n]) for n in outputs}

    def batchOutput(self):
        return _BatchOutputBuilder(self)

    def evaluate(self, iterator, outputVariable: str, evaluation=None):
        """Evaluate a dataset against one output variable (ref:
        SameDiff.evaluate(DataSetIterator, String, IEvaluation...)).
        Placeholder names come from the TrainingConfig's feature/label
        mappings; labels feed the evaluation, not the graph."""
        from deeplearning4j_tpu_torch.eval import Evaluation
        cfg = self._training_config
        assert cfg is not None and cfg.dataSetFeatureMapping, \
            "setTrainingConfig with dataSetFeatureMapping first"
        ev = evaluation if evaluation is not None else Evaluation()
        if hasattr(iterator, "reset"):
            iterator.reset()
        for ds in iterator:
            feats = ds.features if isinstance(ds.features, (list, tuple)) \
                else [ds.features]
            ph = {n: f for n, f in zip(cfg.dataSetFeatureMapping, feats)}
            out = self.output(ph, outputVariable)[outputVariable]
            ev.eval(ds.labels, out.toNumpy(),
                    mask=getattr(ds, "labels_mask", None))
        return ev

    # ------------------------------------------------------------- training
    def setLossVariables(self, *names):
        self._loss_vars = [n.name if isinstance(n, SDVariable) else n for n in names]

    def getLossVariables(self):
        return list(self._loss_vars)

    def setTrainingConfig(self, cfg: TrainingConfig):
        self._training_config = cfg
        self._tx = cfg.updater.to_transform()
        self._opt_state = None

    def _trainable_names(self) -> List[str]:
        return [n for n, v in self._vars.items() if v.varType == VariableType.VARIABLE]

    def _train_step(self, trainables: Dict[str, torch.Tensor],
                    frozen: Dict[str, torch.Tensor],
                    placeholders: Dict[str, torch.Tensor]):
        """One training step (forward, backward, update) on the live
        trainables; returns (new trainables, the loss as a 0-d tensor)."""
        cfg = self._training_config
        loss_names = tuple(self._loss_vars)
        cdt = _compute_dtype(cfg)
        params = {n: t.detach().requires_grad_() for n, t in trainables.items()}
        env = {**_cast_fp32_leaves(frozen, cdt), **_cast_fp32_leaves(params, cdt),
               **_cast_fp32_leaves(placeholders, cdt)}
        env = self._interpret(env, only_ops=self._needed_ops(loss_names))
        loss = sum(torch.sum(env[l].to(torch.float32)) for l in loss_names)
        for reg in cfg.regularization:
            for n in params:
                loss = loss + reg.penalty(params[n])
        if not cfg.minimize:
            loss = -loss
        leaves = list(params.values())
        grads = torch.autograd.grad(loss, leaves, allow_unused=True) if leaves else []
        grads = {n: torch.zeros_like(p) if g is None else g
                 for (n, p), g in zip(params.items(), grads)}
        with torch.no_grad():
            updates, self._opt_state = self._tx.update(grads, self._opt_state,
                                                       trainables)
            trainables = {n: trainables[n] + updates[n] for n in trainables}
        if any(getattr(l, "requiresGradients", False) for l in self.listeners):
            self._last_grads = grads   # what a gradient-checking listener reads
        return trainables, loss.detach()

    def fit(self, data, epochs: int = 1):
        """Train (ref: SameDiff.fit(MultiDataSetIterator)): each batch is
        one step of forward, backward and updater. ``data`` is a
        DataSetIterator/DataSet, a dict of placeholder arrays (one batch)
        or a list of such dicts. Returns the per-step losses."""
        from deeplearning4j_tpu_torch.data.dataset import DataSet, ListDataSetIterator
        cfg = self._training_config
        assert cfg is not None, "call setTrainingConfig first"
        assert self._loss_vars, "call setLossVariables first"
        if isinstance(data, DataSet):
            data = ListDataSetIterator([data])
        elif isinstance(data, dict):
            data = [data]  # one batch of explicit placeholder arrays

        t_names = self._trainable_names()
        trainables = {n: self._values[n] for n in t_names}
        # frozen float32 leaves are cast once per fit call; trainables keep
        # float32 masters (cast inside the step so gradients land on them)
        frozen = _cast_fp32_leaves(
            {n: v for n, v in self._values.items() if n not in trainables},
            _compute_dtype(cfg))
        if self._opt_state is None:
            self._opt_state = self._tx.init(trainables)

        def placeholders(ds):
            if isinstance(ds, dict):
                return self._placeholders(ds)
            ph = {}
            feats = ds.features if isinstance(ds.features, (list, tuple)) else [ds.features]
            labs = ds.labels if isinstance(ds.labels, (list, tuple)) else [ds.labels]
            for nm, arr in zip(cfg.dataSetFeatureMapping, feats):
                ph[nm] = self._tensor(arr)
            for nm, arr in zip(cfg.dataSetLabelMapping, labs):
                ph[nm] = self._tensor(arr)
            return ph

        history: list = []
        try:
            for _ in range(epochs):
                for ds in data:
                    trainables, loss = self._train_step(trainables, frozen,
                                                        placeholders(ds))
                    history.append(loss)   # 0-d tensor; read in bulk below
                    self._score = loss
                    # listeners read current values (param stats)
                    self._values.update(trainables)
                    for lst in self.listeners:
                        lst.iterationDone(self, len(history), 0)
        finally:
            self._values.update(trainables)
        if history:
            history = torch.stack([h.float() for h in history]).cpu().double().tolist()
        return history

    def score(self) -> float:
        """Last training loss."""
        return float(getattr(self, "_score", float("nan")))

    def numParams(self) -> int:
        return int(sum(self._values[n].numel() for n in self._trainable_names()))

    @property
    def _params(self) -> Dict[str, torch.Tensor]:
        """The trainable values by name (what ``ProfilingListener`` checks)."""
        return {n: self._values[n] for n in self._trainable_names()}

    def calculateGradients(self, placeholders: Dict[str, Any], wrt: Sequence[str]
                           ) -> Dict[str, NDArray]:
        """Explicit gradient computation (ref: SameDiff.calculateGradients).
        Also materializes grad::<name> variables (ref: SDVariable.gradient())."""
        assert self._loss_vars, "setLossVariables first"
        loss_names = tuple(self._loss_vars)
        wrt = [w.name if isinstance(w, SDVariable) else w for w in wrt]
        sel = {n: self._values[n].detach().requires_grad_() for n in wrt}
        env = {**self._values, **sel, **self._placeholders(placeholders)}
        env = self._interpret(env, only_ops=self._needed_ops(loss_names))
        loss = sum(torch.sum(env[l]) for l in loss_names)
        grads = torch.autograd.grad(loss, list(sel.values()), allow_unused=True)
        out = {}
        for (n, p), g in zip(sel.items(), grads):
            g = torch.zeros_like(p) if g is None else g.detach()
            gname = f"grad::{n}"
            self._vars[gname] = SDVariable(self, gname, VariableType.ARRAY,
                                           tuple(g.shape), g.dtype)
            self._values[gname] = g
            out[n] = NDArray(g)
        return out

    # ------------------------------------------------------------ persistence
    def save(self, path: str, save_updater_state: bool = False):
        """Zip: graph.json + weights .npy blobs, the reference's container
        (graph + weights + optional updater state). bfloat16 values are
        written as float32 (exact)."""
        graph = {
            "vars": [_var_to_dict(v) for v in self._vars.values() if "." not in v.name],
            "ops": [_op_to_dict(o) for o in self._ops],
            "loss": self._loss_vars,
        }
        if self._removed_by_rewrite:
            # keep the targeted removed-by-rewrite error working across a
            # save/load roundtrip
            graph["removed_by_rewrite"] = self._removed_by_rewrite
        with zipfile.ZipFile(path, "w") as zf:
            zf.writestr("graph.json", json.dumps(graph, indent=2))
            manifest = []
            for n, val in self._values.items():
                if self._vars[n].varType in (VariableType.VARIABLE, VariableType.CONSTANT):
                    zf.writestr(f"values/{n}.npy", _npy_bytes(val))
                    manifest.append({"name": n, "type": self._vars[n].varType})
            zf.writestr("values.json", json.dumps(manifest))
            if save_updater_state and self._training_config is not None:
                cfg = self._training_config
                zf.writestr("training.json", json.dumps({
                    "updater": cfg.updater.to_dict(),
                    "dataSetFeatureMapping": cfg.dataSetFeatureMapping,
                    "dataSetLabelMapping": cfg.dataSetLabelMapping,
                    "minimize": cfg.minimize,
                    "computeDtype": cfg.computeDtype,
                    "hasOptState": self._opt_state is not None,
                }))
                if self._opt_state is not None:
                    for i, leaf in enumerate(_upd.tree_leaves(self._opt_state)):
                        zf.writestr(f"updaterState/{i}.npy", _npy_bytes(leaf))

    @staticmethod
    def load(path: str, device=None) -> "SameDiff":
        sd = SameDiff(device)
        with zipfile.ZipFile(path) as zf:
            graph = json.loads(zf.read("graph.json"))
            manifest = json.loads(zf.read("values.json"))
            values = {m["name"]: (m["type"], _npy_load(zf.read(f"values/{m['name']}.npy")))
                      for m in manifest}
            names = set(zf.namelist())
            training = json.loads(zf.read("training.json")) \
                if "training.json" in names else None
            opt_leaves = [_npy_load(zf.read(f"updaterState/{i}.npy"))
                          for i in range(sum(1 for n in names
                                             if n.startswith("updaterState/")))]
        for vd in graph["vars"]:
            name = vd["name"]
            if name in values:
                vtype, arr = values[name]
                if vtype == VariableType.VARIABLE:
                    sd.var(name, arr, dtype=arr.dtype)
                else:
                    sd.constant(name, arr)
            elif vd["type"] == VariableType.PLACEHOLDER:
                sd.placeHolder(name, shape=vd["shape"],
                               dtype=_dtype_of(vd["dtype"]) or torch.float32)
            else:
                sd._vars[name] = _var_from_dict(sd, vd)
        for od in graph["ops"]:
            sd._ops.append(_op_from_dict(od, sd.device))
            for on in od["outputs"]:
                if on not in sd._vars:
                    sd._vars[on] = SDVariable(sd, on, VariableType.ARRAY)
        sd._loss_vars = graph.get("loss", [])
        if graph.get("removed_by_rewrite"):
            sd._removed_by_rewrite = dict(graph["removed_by_rewrite"])

        # updater state: rebuild the state's tree (init on the restored
        # trainables) and refill its leaves in flatten order — exact resume
        if training is not None:
            sd.setTrainingConfig(TrainingConfig(
                updater=_upd.from_dict(training["updater"]),
                dataSetFeatureMapping=training.get("dataSetFeatureMapping", []),
                dataSetLabelMapping=training.get("dataSetLabelMapping", []),
                minimize=training.get("minimize", True),
                computeDtype=training.get("computeDtype")))
            if training.get("hasOptState"):
                skeleton = sd._tx.init({n: sd._values[n] for n in sd._trainable_names()})
                like = _upd.tree_leaves(skeleton)
                sd._opt_state = _upd.tree_unflatten(skeleton, [
                    torch.from_numpy(np.array(a, copy=True)).reshape(r.shape)
                    .to(device=r.device, dtype=r.dtype)
                    for a, r in zip(opt_leaves, like)])
        return sd

    def summary(self) -> str:
        lines = [f"SameDiff: {len(self._vars)} variables, {len(self._ops)} ops"]
        for o in self._ops:
            lines.append(f"  {','.join(o.outputs)} = {o.namespace}.{o.opname}({', '.join(o.inputs)})")
        return "\n".join(lines)


def _struct_var(sd: SameDiff, name: str, st) -> SDVariable:
    """An ARRAY variable with the shape and dtype of ``st`` (a tensor, or
    anything else for unknown)."""
    if isinstance(st, torch.Tensor):
        return SDVariable(sd, name, VariableType.ARRAY, tuple(st.shape), st.dtype)
    return SDVariable(sd, name, VariableType.ARRAY, None, None)


def _abstract_control(node: SameDiffOp, xs: List[torch.Tensor]) -> tuple:
    """What a control node returns, for tensors like ``xs``: the branch's
    outputs of an ``if`` (its true branch run once), the loop vars of a
    ``while``/``for`` (its body run once and cast back to their dtypes, as
    the loop does) — without deciding a branch or a trip count."""
    kw = node.kwargs
    like = xs[0] if xs else torch.empty((), device="meta")
    if node.opname == "if":
        sub, ins, outs = kw["true_graph"]
        return tuple(SameDiff._run_subgraph(sub, ins, xs[1:], outs, like))
    sub, ins, outs = kw["body_graph"]
    if node.opname == "while":
        csub, cins, couts = kw["cond_graph"]
        SameDiff._run_subgraph(csub, cins, xs, couts, like)
        new = SameDiff._run_subgraph(sub, ins, xs, outs, like)
    else:
        it = torch.zeros((), dtype=_dt.int_(), device=like.device)
        new = SameDiff._run_subgraph(sub, ins, [it, *xs], outs, like)
    for n, x in zip(new, xs):   # the carry keeps its shape (lax's rule)
        if tuple(n.shape) != tuple(x.shape):
            raise ValueError("loop body changes a loop var's shape")
    return tuple(xs)


def _npy_bytes(t: torch.Tensor) -> bytes:
    t = t.detach().cpu()
    buf = io.BytesIO()
    np.save(buf, (t.float() if t.dtype == torch.bfloat16 else t).numpy())
    return buf.getvalue()


def _npy_load(raw: bytes) -> np.ndarray:
    """A .npy member; a reference bfloat16 member (two-byte records) reads
    as float32 (exact)."""
    a = np.load(io.BytesIO(raw))
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        a = (a.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    return a


def _var_to_dict(v: SDVariable) -> dict:
    return {"name": v.name, "type": v.varType,
            "shape": list(v.shape) if v.shape else None,
            "dtype": _dtype_name(v.dtype) if _dtype_of(v.dtype) is not None
            else (None if v.dtype is None else str(v.dtype))}


def _var_from_dict(sd: SameDiff, vd: dict) -> SDVariable:
    return SDVariable(sd, vd["name"], vd["type"],
                      tuple(vd["shape"]) if vd["shape"] else None,
                      _dtype_of(vd["dtype"]))


# a dtype as the reference writes one (``str(jnp.float32)``)
_CLASS_DTYPE = re.compile(r"^<class '(?:jax\.)?numpy\.(\w+)'>$")


def _enc_kw_val(v):
    """JSON-encode one kwarg value. Python slice objects (stridedSlice's
    'slices' tuple — what TF's mask[:, newaxis, newaxis, :] imports to)
    get a tagged form so load() restores REAL slices, not their repr; a
    dtype is written by its name ('float32'), which both packages read."""
    if isinstance(v, slice):
        return {"__slice__": [v.start, v.stop, v.step]}
    if isinstance(v, (list, tuple)):
        return [_enc_kw_val(x) for x in v]
    if isinstance(v, (int, float, str, bool)) or v is None:
        return v
    if isinstance(v, torch.dtype):
        return _dtype_name(v)
    return str(v)


def _dec_kw_val(v):
    if isinstance(v, dict) and "__slice__" in v:
        s = v["__slice__"]
        return slice(s[0], s[1], s[2])
    if isinstance(v, list):
        return [_dec_kw_val(x) for x in v]
    if isinstance(v, str):
        m = _CLASS_DTYPE.match(v)
        if m:
            return m.group(1)
    return v


_SUBGRAPH_KEYS = ("true_graph", "false_graph", "cond_graph", "body_graph")


def _op_to_dict(o: SameDiffOp) -> dict:
    """Serialize one node; control nodes recurse into their sub-graphs."""
    kw = {}
    for k, v in o.kwargs.items():
        if o.namespace == "control" and k in _SUBGRAPH_KEYS:
            sub, ins, outs = v
            kw[k] = {"__subgraph__": _subgraph_to_dict(sub), "in": ins, "out": outs}
        else:
            kw[k] = _enc_kw_val(v)
    return {"namespace": o.namespace, "op": o.opname, "inputs": o.inputs,
            "outputs": o.outputs, "kwargs": kw}


def _op_from_dict(od: dict, device) -> SameDiffOp:
    kw = {}
    for k, v in od["kwargs"].items():
        if od["namespace"] == "control" and k in _SUBGRAPH_KEYS:
            kw[k] = (_subgraph_from_dict(v["__subgraph__"], device), v["in"], v["out"])
        else:
            kw[k] = _dec_kw_val(v)
    return SameDiffOp(od["namespace"], od["op"], od["inputs"], od["outputs"], kw)


def _subgraph_to_dict(sd: SameDiff) -> dict:
    """Control sub-graphs carry their constants inline (they are small —
    literals and shape params; top-level weights stay in npy blobs)."""
    return {
        "vars": [_var_to_dict(v) for v in sd._vars.values() if "." not in v.name],
        "ops": [_op_to_dict(o) for o in sd._ops],
        "values": {n: {"data": v.detach().cpu().float().tolist()
                       if v.dtype == torch.bfloat16 else v.detach().cpu().tolist(),
                       "dtype": _dtype_name(v.dtype)}
                   for n, v in sd._values.items()},
    }


def _subgraph_from_dict(d: dict, device) -> SameDiff:
    sub = SameDiff(device)
    for vd in d["vars"]:
        sub._vars[vd["name"]] = _var_from_dict(sub, vd)
    for n, spec in d["values"].items():
        t = torch.as_tensor(np.asarray(spec["data"]), device=sub.device)
        dt = _dtype_of(spec["dtype"])
        sub._values[n] = t.to(_dt.canonical(dt)) if dt is not None \
            else _dt.canonical_tensor(t)
    for od in d["ops"]:
        sub._ops.append(_op_from_dict(od, device))
        for on in od["outputs"]:
            if on not in sub._vars:
                sub._vars[on] = SDVariable(sub, on, VariableType.ARRAY)
    return sub


class _BatchOutputBuilder:
    """(ref: SameDiff.batchOutput fluent API)."""

    def __init__(self, sd: SameDiff):
        self._sd = sd
        self._ph = {}
        self._outputs = []

    def input(self, name, arr):
        self._ph[name] = arr
        return self

    def output(self, *names):
        self._outputs.extend(n.name if isinstance(n, SDVariable) else n for n in names)
        return self

    def execSingle(self) -> NDArray:
        return self._sd.output(self._ph, self._outputs)[self._outputs[0]]

    def exec(self) -> Dict[str, NDArray]:
        return self._sd.output(self._ph, self._outputs)
