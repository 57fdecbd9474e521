"""Graph-level kernel-fusion rewrites for SameDiff (counterpart:
``deeplearning4j_tpu/autodiff/rewrites.py``).

An imported graph computes attention as four nodes — matmul, scale,
softmax, matmul — and materializes the (B, H, T, T) score tensor between
them. ``fuse_attention`` pattern-matches that chain and collapses it onto
the ``scaledDotProductAttentionFused`` registry op, which on CUDA tensors
routes to the hand-written attention kernels (``ops/nn_defs.py``: the
packed kernels at 768 <= T <= 1024, the streamed ones past T = 1024, the
einsum below).

Matched shape (what the TF importer emits for BERT-style attention,
verified against tools/tf_bert.py's frozen graph):

    q ----------------------------\
    k -> permute(0,1,3,2) -> matmul -> [mul(scalar)] -> [add(mask)] -> softmax -> matmul -> out
    v ---------------------------------------------------------------------------^

Intermediates must be single-consumer and not loss variables (a later
``sd.output(...)`` request for a fused-away intermediate raises an error
naming the rewrite); the optional ``mul`` must be by a scalar constant
(the 1/sqrt(D) scale — trainable scalar scales are left unfused). The
optional ``add`` is the BERT-import additive padding mask: it becomes the
fused op's ``mask`` input (still a graph variable — masks are usually
placeholder-derived, so they must stay dynamic), which pins the einsum
path (kernels are causal/none only).
"""
from __future__ import annotations

from collections import defaultdict
from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.autodiff.samediff import SameDiffOp, VariableType


def _scalar_const(sd, name) -> Optional[float]:
    """The float value of a size-1 CONSTANT, else None. Trainable scalars
    (varType VARIABLE) are rejected: baking their current value into the
    fused op's static kwargs would silently freeze a learnable scale."""
    try:
        v = sd.getVariable(name)
        if v.varType != VariableType.CONSTANT:
            return None
        arr = v.getArr()
    except Exception:
        return None
    if arr is None:
        return None
    a = np.asarray(arr.toNumpy() if hasattr(arr, "toNumpy") else arr)
    if a.size != 1:
        return None
    return float(a.reshape(()))


def fuse_attention(sd) -> int:
    """Collapse matmul->[scale]->softmax->matmul chains onto
    ``scaledDotProductAttentionFused``. Returns the number of sites fused.
    Output names are preserved, so downstream nodes and graph outputs are
    untouched; numerics are identical on the einsum path and within the
    kernels' tolerance on the card."""
    ops = sd._ops
    producer = {}
    consumers = defaultdict(list)
    for i, node in enumerate(ops):
        for out in node.outputs:
            producer[out] = i
        for inp in node.inputs:
            consumers[inp].append(i)

    def prod(name):
        i = producer.get(name)
        return (i, ops[i]) if i is not None else (None, None)

    loss_vars = set(getattr(sd, "_loss_vars", []))

    def single_internal(name):
        """name has exactly one op consumer and is not a loss variable
        (fusing away a loss var's producer would break fit())."""
        return len(consumers.get(name, [])) == 1 and name not in loss_vars

    to_remove = set()
    replacements = {}
    fused = 0
    for i, node in enumerate(ops):
        if (node.namespace, node.opname) != ("nn", "softmax"):
            continue
        if node.kwargs.get("dim", -1) not in (-1,):
            continue
        # upward: [add(mask)] <- [mul(scale)] <- matmul(q, permute(k))

        def match_score_chain(name):
            """name -> (mm_i, mm, mul_i, scale) when it is produced by
            matmul or mul(scalar-const)<-matmul, else None."""
            ci, cop = prod(name)
            if cop is None:
                return None
            if (cop.namespace, cop.opname) == ("math", "mul"):
                a, b = cop.inputs
                mm_i, mm = prod(a)
                scale_name = b
                if mm is None or mm.opname != "matmul":
                    mm_i, mm = prod(b)
                    scale_name = a
                if mm is None or mm.opname != "matmul":
                    return None
                sc = _scalar_const(sd, scale_name)
                if sc is None:
                    return None
                return mm_i, mm, ci, sc
            if cop.opname == "matmul":
                return ci, cop, None, 1.0
            return None

        add_i = None
        mask_name = None
        chain = match_score_chain(node.inputs[0])
        if chain is None:
            up_i, up = prod(node.inputs[0])
            if up is None or (up.namespace, up.opname) != ("math", "add"):
                continue
            # additive mask: try BOTH orientations fully — the mask side
            # may itself be mul-produced (e.g. (1-m) * -1e4), so "has a
            # mul producer" does not identify the score side; only a
            # complete chain match does
            a, b = up.inputs
            for cand, other in ((a, b), (b, a)):
                chain = match_score_chain(cand)
                if chain is not None and single_internal(cand):
                    add_i, mask_name = up_i, other
                    break
            if chain is None or add_i is None:
                continue
        mm_i, mm, mul_i, scale = chain
        q_name, kt_name = mm.inputs
        kt_i, kt = prod(kt_name)
        if kt is None or kt.opname != "permute" \
                or tuple(kt.kwargs.get("axes", ())) != (0, 1, 3, 2):
            continue
        k_name = kt.inputs[0]
        # downward: softmax -> matmul(p, v)
        p_name = node.outputs[0]
        cons = consumers.get(p_name, [])
        if len(cons) != 1:
            continue
        pv_i = cons[0]
        pv = ops[pv_i]
        if pv.opname != "matmul" or pv.inputs[0] != p_name:
            continue
        v_name = pv.inputs[1]
        # all pattern intermediates single-consumer (and the kT permute
        # removable only if nothing else reads it)
        mids = [mm.outputs[0], p_name] \
            + ([ops[mul_i].outputs[0]] if mul_i is not None else []) \
            + ([ops[add_i].outputs[0]] if add_i is not None else [])
        if not all(single_internal(m) for m in mids):
            continue
        # shapes: split-head rank-4 with consistent (T, D) trailing dims.
        # Leading dims may differ (or be dynamic-dim sentinels in the
        # recorded metadata): the fused op's einsum path uses broadcasting
        # torch.matmul with EXACTLY the original chain's semantics, and its
        # kernel gate re-checks the true shapes at execution time
        q_v, k_v, v_v = (sd.getVariable(n) for n in (q_name, k_name, v_name))
        shapes = [getattr(x, "shape", None) for x in (q_v, k_v, v_v)]
        if any(s is None or len(s) != 4 for s in shapes):
            continue
        if not (shapes[0][2:] == shapes[1][2:] == shapes[2][2:]):
            continue
        inputs = [q_name, k_name, v_name] \
            + ([mask_name] if mask_name is not None else [])
        replacements[pv_i] = SameDiffOp(
            "nn", "scaledDotProductAttentionFused",
            inputs, [pv.outputs[0]], {"scale": scale})
        to_remove.update(x for x in (mm_i, mul_i, add_i, i)
                         if x is not None)
        if single_internal(kt_name):
            to_remove.add(kt_i)
        fused += 1

    if fused:
        # the fused op reproduces only the chain's FINAL output; every other
        # output of a removed node (scores, softmax probs, kT permute) no
        # longer exists. Record them so SameDiff.output() can raise a
        # targeted error naming this rewrite instead of a deep KeyError
        # when one is requested later.
        removed_names = {o for idx in to_remove for o in ops[idx].outputs}
        registry = sd._removed_by_rewrite
        if registry is None:
            registry = sd._removed_by_rewrite = {}
        for name in removed_names:
            registry[name] = "fuseAttention"
        sd._ops = [replacements.get(idx, node) for idx, node in enumerate(ops)
                   if idx not in to_remove]
        sd._plan_cache.clear()
    return fused
