"""Model persistence (counterpart: ``deeplearning4j_tpu/util/
model_serializer.py``; ref: org.deeplearning4j.util.ModelSerializer — zip
containing configuration.json + coefficients.bin + updaterState.bin).

The reference's container, member for member, so a file written by either
package restores in the other:
- ``configuration.json`` — the network config (JSON round-trip DSL) plus a
  ``networkType`` discriminator and iteration/epoch counters,
- ``coefficients.npy``  — the flat parameter vector in float64
  (``params()``: layer order — a graph's topological node order — sorted
  keys within a layer),
- ``updaterState.npz``  — updater-state leaves in optax's tree order
  (``train/updaters.py`` keeps that order; the structure is rebuilt from
  a fresh ``init`` on load, so only leaves are stored),
- ``state.npz``         — layer-state leaves in tree order (BatchNorm
  running mean/var).
``MultiLayerNetwork`` and ``ComputationGraph``; anything else raises the
reference's ``TypeError``. bfloat16 leaves are written as float32 (exact);
a reference file's bfloat16 members (two-byte records) are read too.
"""
from __future__ import annotations

import io
import json
import zipfile
from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.train.updaters import tree_leaves, tree_unflatten


def _host(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _save_leaves(z: zipfile.ZipFile, name: str, tree) -> None:
    """Serialize a tree's leaves (tree order) into an npz archive member."""
    leaves = tree_leaves(tree)
    if not leaves:
        return
    buf = io.BytesIO()
    np.savez(buf, **{f"leaf_{i}": _host(l) for i, l in enumerate(leaves)})
    z.writestr(name, buf.getvalue())


def _as_tensor_like(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:  # bfloat16 bits
        bits = a.view(np.uint16).astype(np.uint32) << 16
        a = bits.view(np.float32)
    t = torch.from_numpy(np.array(a, copy=True)).reshape(like.shape)
    return t.to(device=like.device, dtype=like.dtype)


def _load_leaves(z: zipfile.ZipFile, name: str, like):
    """Restore a tree saved by _save_leaves, taking structure/dtypes/shapes
    and devices from a freshly initialized ``like`` tree."""
    data = np.load(io.BytesIO(z.read(name)))
    leaves = tree_leaves(like)
    if len(data.files) != len(leaves):
        raise ValueError(
            f"{name}: checkpoint has {len(data.files)} leaves but the model "
            f"expects {len(leaves)} — incompatible framework version?")
    return tree_unflatten(like, [_as_tensor_like(data[f"leaf_{i}"], l)
                                 for i, l in enumerate(leaves)])


class ModelSerializer:

    @staticmethod
    def writeModel(model, path: str, saveUpdater: bool = True):
        """(ref: ModelSerializer.writeModel)."""
        from deeplearning4j_tpu_torch.nn.computation_graph import ComputationGraph
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

        if isinstance(model, MultiLayerNetwork):
            net_type = "MultiLayerNetwork"
        elif isinstance(model, ComputationGraph):
            net_type = "ComputationGraph"
        else:
            raise TypeError(f"cannot serialize {type(model).__name__}")
        meta = {
            "networkType": net_type,
            "configuration": json.loads(model.conf.to_json()),
            "iterationCount": model.getIterationCount(),
            "epochCount": model.getEpochCount(),
            "saveUpdater": bool(saveUpdater),
        }
        with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
            z.writestr("configuration.json", json.dumps(meta, indent=2))
            buf = io.BytesIO()
            np.save(buf, _host(model.params().torch).astype(np.float64))
            z.writestr("coefficients.npy", buf.getvalue())
            _save_leaves(z, "state.npz", model._state)
            if saveUpdater and model._opt_state is not None:
                _save_leaves(z, "updaterState.npz", model._opt_state)

    @staticmethod
    def _restore(path: str, expect_type: Optional[str], loadUpdater: bool, device):
        from deeplearning4j_tpu_torch.nn.computation_graph import ComputationGraph
        from deeplearning4j_tpu_torch.nn.conf.builder import MultiLayerConfiguration
        from deeplearning4j_tpu_torch.nn.conf.graph import ComputationGraphConfiguration
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

        with zipfile.ZipFile(path, "r") as z:
            meta = json.loads(z.read("configuration.json"))
            net_type = meta["networkType"]
            if expect_type and net_type != expect_type:
                raise ValueError(f"{path} contains a {net_type}, expected {expect_type}")
            conf_json = json.dumps(meta["configuration"])
            if net_type == "MultiLayerNetwork":
                model = MultiLayerNetwork(MultiLayerConfiguration.from_json(conf_json),
                                          device=device).init()
            else:
                model = ComputationGraph(ComputationGraphConfiguration.from_json(conf_json),
                                         device=device).init()
            flat = np.load(io.BytesIO(z.read("coefficients.npy")))
            model.setParams(torch.from_numpy(flat))
            if "state.npz" in z.namelist():
                model._state = _load_leaves(z, "state.npz", model._state)
            model._iteration = meta.get("iterationCount", 0)
            model._epoch = meta.get("epochCount", 0)
            if loadUpdater and meta.get("saveUpdater") and "updaterState.npz" in z.namelist():
                model._opt_state = _load_leaves(
                    z, "updaterState.npz", model._tx.init(model._params))
        return model

    @staticmethod
    def restoreMultiLayerNetwork(path: str, loadUpdater: bool = True, device=None):
        """(ref: ModelSerializer.restoreMultiLayerNetwork) onto ``device``
        (default ``"cuda"``)."""
        return ModelSerializer._restore(path, "MultiLayerNetwork", loadUpdater, device)

    @staticmethod
    def restoreComputationGraph(path: str, loadUpdater: bool = True, device=None):
        """(ref: ModelSerializer.restoreComputationGraph) onto ``device``
        (default ``"cuda"``)."""
        return ModelSerializer._restore(path, "ComputationGraph", loadUpdater, device)

    @staticmethod
    def restoreModel(path: str, loadUpdater: bool = True, device=None):
        """Type-sniffing restore (ref: ModelGuesser.loadModelGuess)."""
        return ModelSerializer._restore(path, None, loadUpdater, device)
