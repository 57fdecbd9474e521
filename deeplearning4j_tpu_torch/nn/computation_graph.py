"""ComputationGraph (counterpart: ``deeplearning4j_tpu/nn/computation_graph.py``;
ref: org.deeplearning4j.nn.graph.ComputationGraph) — the DAG network
runtime.

The DAG is walked in topological order every step, on the network's
device (``device``, ``"cuda"`` unless the caller passes ``"cpu"``).
Multiple inputs (fit(MultiDataSet)) and multiple outputs (the loss is the
sum over the output layers, as the reference sums a graph's scores). The
same seed and data give the reference's trajectory:

- ``init`` splits the seed's threefry key once per node that has
  parameters (layers and ``AttentionVertex`` alike), in topological order;
- each step splits the network's key, and ``_forward`` splits the step's
  key once per LAYER node (vertices take none) and folds in 7 for
  conf-level dropout on the layer input (not on ``DropoutLayer``);
- the updater is the port's (init, update) pair over the node-name dict,
  whose leaves flatten in sorted-name order as optax's do.

``params()``/``setParams`` flatten in topological order, sorted keys
within a node. As in ``MultiLayerNetwork``, the reference's fused
multi-step executable, listener replay and host-transfer cache only
amortize XLA dispatch: ``fuseSteps``, ``listenerReplayLag``,
``setHostTransferCache`` and ``warmup`` are accepted and change no result.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch import default_device
from deeplearning4j_tpu_torch.data.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.eval import Evaluation
from deeplearning4j_tpu_torch.models import params_from_numpy
from deeplearning4j_tpu_torch.models import random as _prng
from deeplearning4j_tpu_torch.ndarray import dtypes as _dt
from deeplearning4j_tpu_torch.ndarray.array import NDArray
from deeplearning4j_tpu_torch.nn.conf.dropout import apply_dropout
from deeplearning4j_tpu_torch.nn.conf.graph import (
    ComputationGraphConfiguration, GraphNode, GraphVertex)
from deeplearning4j_tpu_torch.nn.conf.layers import (
    BaseOutputLayer, BaseRecurrentLayer, Bidirectional, CenterLossOutputLayer, DropoutLayer,
    GlobalPoolingLayer, LastTimeStep, Layer, LossLayer, needs_flatten,
)
from deeplearning4j_tpu_torch.nn.data_shard import sync_loss_and_grads
from deeplearning4j_tpu_torch.nn.multilayer import _DTYPES, _clip_grads, _detach
from deeplearning4j_tpu_torch.train.updaters import (
    apply_updates, tree_leaves, tree_map, tree_unflatten,
)


class ComputationGraph:
    """DAG network over a ComputationGraphConfiguration, on ``device``
    (default ``"cuda"``; without CUDA it raises unless ``device="cpu"``)."""

    # Accepted for the reference's API; the port runs every step on its own.
    fuseSteps: int = 8
    listenerReplayLag: int = 16

    def __init__(self, conf: ComputationGraphConfiguration, device=None):
        self.device = default_device(device)
        self.conf = conf
        self._order: List[GraphNode] = conf.topo_order()
        self._by_name: Dict[str, GraphNode] = {n.name: n for n in self._order}
        self._params: Optional[Dict[str, dict]] = None
        self._state: Optional[Dict[str, dict]] = None
        self._opt_state = None
        self._tx = None
        self._iteration = 0
        self._epoch = 0
        self._score = float("nan")
        self.listeners: List[Any] = []
        self._host_transfer_cache = True
        self._rng_key = _prng.as_key(_prng.prng_key(conf.seed))
        self._dtype = _dt.canonical(_DTYPES[conf.dataType])

    # ------------------------------------------------------------------ init
    def init(self):
        """Seeded params/state (ref: ComputationGraph.init): one key per
        node with parameters, in topological order."""
        param_nodes = [n for n in self._order
                       if isinstance(n.op, Layer) or getattr(n.op, "has_params", False)]
        keys = _prng.split(_prng.prng_key(self.conf.seed), max(len(param_nodes), 1))
        self._params, self._state = {}, {}
        for i, n in enumerate(param_nodes):
            self._params[n.name] = n.op.init_params(keys[i], self._dtype, self.device)
            self._state[n.name] = n.op.init_state(self._dtype, self.device) \
                if isinstance(n.op, Layer) else {}
        self._tx = self.conf.updater.to_transform()
        self._opt_state = self._tx.init(self._params)
        return self

    def setParamTrees(self, params, state=None):
        """Take the reference's ``_params``/``_state`` trees (dicts by node
        name) as numpy onto this graph's device, params in its dtype; the
        updater state restarts from ``init`` of them."""
        self._params = tree_map(lambda t: t.to(self._dtype),
                                params_from_numpy(dict(params), self.device))
        if state is not None:
            self._state = params_from_numpy(dict(state), self.device)
        if self._tx is None:
            self._tx = self.conf.updater.to_transform()
        self._opt_state = self._tx.init(self._params)
        return self

    # -------------------------------------------------------------- forward
    def _tensor(self, x) -> torch.Tensor:
        """Features, labels or a mask on this graph's device."""
        if isinstance(x, NDArray):
            x = x.torch
        if not isinstance(x, torch.Tensor):
            x = _dt.canonical_tensor(torch.tensor(np.asarray(x)))
        return x.to(self.device)

    def _input_dict(self, features: Sequence) -> Dict[str, torch.Tensor]:
        return {name: self._tensor(f) for name, f in zip(self.conf.networkInputs, features)}

    def _mask_dict(self, masks) -> Optional[Dict[str, torch.Tensor]]:
        out = {name: self._tensor(m) for name, m in zip(self.conf.networkInputs, masks or [])
               if m is not None}
        return out or None

    def _forward(self, params, state, inputs: Dict[str, Any], *, training, rng,
                 masks: Optional[Dict[str, Any]] = None):
        # float inputs join the conf dtype (torch's matmuls and convs take
        # one dtype); integer inputs (embedding ids) stay as they are
        acts: Dict[str, Any] = {k: (v.to(self._dtype)
                                    if v.is_floating_point() and v.dtype != self._dtype else v)
                                for k, v in inputs.items()}
        new_state: Dict[str, dict] = {}
        n_layers = max(sum(1 for n in self._order if isinstance(n.op, Layer)), 1)
        rngs = _prng.split(rng, n_layers) if rng is not None else None
        li = 0
        for node in self._order:
            xs = [acts[i] for i in node.inputs]
            if isinstance(node.op, GraphVertex):
                if getattr(node.op, "has_params", False):
                    acts[node.name] = node.op.apply(
                        xs, params=params.get(node.name, {}), training=training)
                else:
                    acts[node.name] = node.op.apply(xs, training=training)
                continue
            layer = node.op
            x = xs[0]
            if needs_flatten(layer, x.dim()):
                x = x.reshape(x.shape[0], -1)
            r = rngs[li] if rngs is not None else None
            li += 1
            # conf-level input dropout — not for DropoutLayer itself, whose
            # apply() already drops
            if training and layer.dropOut is not None and r is not None \
                    and not isinstance(layer, DropoutLayer):
                x = apply_dropout(layer.dropOut, _prng.fold_in(r, 7), x)
            kwargs = {}
            mask = (masks or {}).get(node.inputs[0])
            if isinstance(layer, (BaseRecurrentLayer, Bidirectional, LastTimeStep,
                                  GlobalPoolingLayer)) and mask is not None:
                kwargs["mask"] = mask
            out, st = layer.apply(params.get(node.name, {}), x, training=training,
                                  rng=r, state=state.get(node.name) or None, **kwargs)
            acts[node.name] = out
            new_state[node.name] = st if st is not None else {}
        return acts, new_state

    def _loss_for(self, params, state, inputs, labels, rng, lmasks, fmasks=None):
        acts, new_state = self._forward(params, state, inputs, training=True, rng=rng,
                                        masks=fmasks)
        loss = 0.0
        for i, out_name in enumerate(self.conf.networkOutputs):
            layer = self._by_name[out_name].op
            y = labels[i]
            lm = lmasks[i] if lmasks is not None else None
            if isinstance(layer, CenterLossOutputLayer):
                loss = loss + layer.compute_loss_ext(
                    params.get(out_name, {}), y, acts[out_name],
                    new_state[out_name]["features"], lm)
                new_state = dict(new_state)
                new_state[out_name] = {}  # aux features must not persist
            elif hasattr(layer, "loss_with_params"):
                loss = loss + layer.loss_with_params(
                    params.get(out_name, {}), y, acts[out_name], lm)
            elif isinstance(layer, (BaseOutputLayer, LossLayer)):
                loss = loss + layer.compute_loss(y, acts[out_name], lm)
            else:
                loss = loss + torch.mean((acts[out_name] - y) ** 2)
        # regularization over the nodes in sorted-name order (the order the
        # reference's traced dict iterates in)
        for reg in self.conf.regularization:
            for name in sorted(params):
                p = params[name]
                for k in self._by_name[name].op.regularizable():
                    if k in p:
                        loss = loss + reg.penalty(p[k])
        return loss, new_state

    # ------------------------------------------------------------- the step
    def _frozen(self) -> set:
        return {n.name for n in self._order if getattr(n.op, "frozen", False)}

    def _zero_frozen(self, tree: dict, frozen: set) -> dict:
        if not frozen:
            return tree
        return {k: (tree_map(torch.zeros_like, g) if k in frozen else g)
                for k, g in tree.items()}

    def _clip(self, grads: dict) -> dict:
        """Gradient normalization per node (the sequential network's rule
        over the nodes in sorted-name order)."""
        if self.conf.gradientNormalization is None:
            return grads
        names = sorted(grads)
        clipped = _clip_grads([grads[k] for k in names], self.conf.gradientNormalization,
                              self.conf.gradientNormalizationThreshold)
        return dict(zip(names, clipped))

    def _stats_requested(self) -> bool:
        return any(getattr(l, "requiresGradients", False)
                   or getattr(l, "requiresUpdates", False)
                   for l in self.listeners)

    def _train_step(self, inputs, labels, rng, lmasks, fmasks):
        """grad -> clip -> update on the live params; returns the loss (a
        0-d tensor on the device). Frozen nodes' gradients and updates are
        zeroed (ref: FrozenLayer)."""
        frozen = self._frozen()
        params = tree_map(lambda p: p.detach().requires_grad_(), self._params)
        leaves = tree_leaves(params)
        loss, new_state = self._loss_for(params, self._state, inputs, labels, rng,
                                         lmasks, fmasks)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True) if leaves else []
        grads = tree_unflatten(self._params, [torch.zeros_like(l) if g is None else g
                                              for l, g in zip(leaves, grads)])
        with torch.no_grad():
            loss, grads = sync_loss_and_grads(loss.detach(), grads)
            grads = self._zero_frozen(grads, frozen)
            grads = self._clip(grads)
            updates, self._opt_state = self._tx.update(grads, self._opt_state, self._params)
            # AdamW's decoupled decay must not touch frozen params either
            updates = self._zero_frozen(updates, frozen)
            self._params = apply_updates(self._params, updates)
        self._state = _detach(new_state)
        if self._stats_requested():
            self._last_grads, self._last_updates = grads, updates
        return loss

    def _next_key(self):
        self._rng_key, sub = _prng.split(self._rng_key)
        return sub

    # ------------------------------------------------------------------ fit
    def fit(self, data, labels=None, epochs: int = 1):
        """fit(DataSet/MultiDataSet), fit(iterator), fit(features, labels).
        A crash during training writes a diagnostic dump (ref:
        CrashReportingUtil), then re-raises."""
        try:
            return self._fit_impl(data, labels, epochs)
        except Exception as e:  # dump-and-reraise; reporting never masks the error
            from deeplearning4j_tpu_torch.util import crash_reporting
            if not getattr(e, "_control_flow", False):  # early-stop signals etc.
                crash_reporting.writeMemoryCrashDump(self, e, device=self.device)
            raise

    def _fit_impl(self, data, labels=None, epochs: int = 1):
        if labels is not None:
            data = [MultiDataSet([data], [labels])]
        elif isinstance(data, (DataSet, MultiDataSet)):
            data = [data]
        for _ in range(epochs):
            for ds in data:
                self._fit_one(ds)
            self._epoch += 1
            for lst in self.listeners:
                if hasattr(lst, "onEpochEnd"):
                    lst.onEpochEnd(self)
        return self

    def _fit_one(self, ds):
        mds = ds.toMultiDataSet() if isinstance(ds, DataSet) else ds
        inputs = self._input_dict(mds.features)
        ys = [self._tensor(y) for y in mds.labels]
        lmasks = [None if m is None else self._tensor(m)
                  for m in (mds.labels_masks or [None] * len(ys))]
        if all(m is None for m in lmasks):
            lmasks = None
        fmasks = self._mask_dict(mds.features_masks)
        self._score = self._train_step(inputs, ys, self._next_key(), lmasks, fmasks)
        self._iteration += 1
        for lst in self.listeners:
            lst.iterationDone(self, self._iteration, self._epoch)

    # ------------------------------------------------------------- inference
    def output(self, *features, train: bool = False, features_masks=None) -> List[NDArray]:
        """(ref: ComputationGraph.output) — one NDArray per network output."""
        with torch.no_grad():
            acts, _ = self._forward(self._params, self._state, self._input_dict(features),
                                    training=False, rng=None,
                                    masks=self._mask_dict(features_masks))
        return [NDArray(acts[o]) for o in self.conf.networkOutputs]

    def outputSingle(self, *features) -> NDArray:
        return self.output(*features)[0]

    def warmup(self, *example_rows, batch_sizes=(1,)) -> "ComputationGraph":
        """One throwaway forward per batch size; one example row (no batch
        dim) per network input (the serving registry's warmup hook)."""
        exs = [np.asarray(e) for e in example_rows]
        for b in batch_sizes:
            feats = [np.broadcast_to(e, (b,) + e.shape).copy() for e in exs]
            for o in self.output(*feats):
                o.toNumpy()
        return self

    def feedForward(self, *features) -> Dict[str, NDArray]:
        with torch.no_grad():
            acts, _ = self._forward(self._params, self._state, self._input_dict(features),
                                    training=False, rng=None)
        return {k: NDArray(v) for k, v in acts.items()}

    # ---------------------------------------------------------------- score
    def score(self, dataset=None) -> float:
        """Last-minibatch loss, or the loss on ``dataset`` (its masks are
        not read, as in the reference)."""
        if dataset is None:
            return float(self._score)
        mds = dataset.toMultiDataSet() if isinstance(dataset, DataSet) else dataset
        with torch.no_grad():
            loss, _ = self._loss_for(self._params, self._state,
                                     self._input_dict(mds.features),
                                     [self._tensor(y) for y in mds.labels], None, None, None)
        return float(loss)

    # ----------------------------------------------------------- evaluation
    def evaluate(self, iterator, num_classes: Optional[int] = None) -> Evaluation:
        ev = Evaluation(num_classes)
        for ds in iterator:
            mds = ds.toMultiDataSet() if isinstance(ds, DataSet) else ds
            out = self.output(*mds.features, features_masks=mds.features_masks)[0]
            ev.eval(mds.labels[0], out.toNumpy(),
                    mask=mds.labels_masks[0] if mds.labels_masks else None)
        return ev

    # ---------------------------------------------------- flat param surface
    def _param_names(self) -> List[str]:
        return [n.name for n in self._order if n.name in (self._params or {})]

    def params(self) -> NDArray:
        """Flat params in topological node order, sorted keys within a node
        (nested dicts such as Bidirectional's flatten the same way)."""
        leaves = [l.detach().reshape(-1) for name in self._param_names()
                  for l in tree_leaves(self._params[name])]
        if not leaves:
            return NDArray(torch.zeros((0,), dtype=self._dtype, device=self.device))
        return NDArray(torch.cat(leaves))

    def setParams(self, flat):
        """Inverse of params()."""
        flat = self._tensor(flat).reshape(-1)
        pos = 0
        for name in self._param_names():
            new = []
            for l in tree_leaves(self._params[name]):
                n = l.numel()
                new.append(flat[pos:pos + n].reshape(l.shape).to(l.dtype))
                pos += n
            self._params[name] = tree_unflatten(self._params[name], new)

    def numParams(self) -> int:
        return int(sum(l.numel() for l in tree_leaves(self._params)))

    # ------------------------------------------------------------- listeners
    def setListeners(self, *listeners):
        self.listeners = list(listeners)
        return self

    def addListeners(self, *listeners):
        self.listeners.extend(listeners)
        return self

    def setHostTransferCache(self, enabled: bool):
        """Accepted for the reference's API; every batch is moved to the
        device as it comes."""
        self._host_transfer_cache = bool(enabled)
        return self

    def getIterationCount(self) -> int:
        return self._iteration

    def getEpochCount(self) -> int:
        return self._epoch

    def clone(self) -> "ComputationGraph":
        other = ComputationGraph(self.conf, device=self.device)
        if self._params is not None:
            other._params = tree_map(lambda a: a.detach().clone(), self._params)
            other._state = tree_map(lambda a: a.detach().clone(), self._state)
            other._tx = self.conf.updater.to_transform()
            other._opt_state = other._tx.init(other._params)
        return other

    def summary(self) -> str:
        rows = [("name", "type", "inputs", "nParams")]
        total = 0
        for n in self._order:
            p = (self._params or {}).get(n.name, {})
            cnt = int(sum(v.numel() for v in tree_leaves(p)))
            total += cnt
            rows.append((n.name, type(n.op).__name__, ",".join(n.inputs), str(cnt)))
        widths = [max(len(r[c]) for r in rows) for c in range(4)]
        lines = ["  ".join(r[c].ljust(widths[c]) for c in range(4)) for r in rows]
        lines.append(f"Total params: {total}")
        return "\n".join(lines)
