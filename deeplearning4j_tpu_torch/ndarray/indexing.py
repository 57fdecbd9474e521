"""NDArrayIndex — the reference's view-selection DSL at the API boundary
(ref: org.nd4j.linalg.indexing.NDArrayIndex + INDArrayIndex implementations:
PointIndex, IntervalIndex, NDArrayIndexAll, NewAxis, SpecifiedIndex).

Semantics preserved exactly where observable (SURVEY §2.2 / §7.3 item 4):

- ``point(i)``        selects index i and REMOVES the dimension
- ``all()``           keeps the whole dimension
- ``interval(a, b)``  half-open [a, b), keeps the dimension;
  ``interval(a, stride, b)`` strided; ``interval(a, b, inclusive=True)``
  closes the upper bound (the reference's 4-arg boolean form)
- ``newAxis()``       inserts a size-1 dimension
- ``indices(i...)``   fancy selection along the dimension (SpecifiedIndex)
- fewer indices than rank → trailing dimensions behave as ``all()``

Internally everything lowers to one numpy-style index tuple; the compute
path stays functional (``put`` writes a copy that the handle then holds —
the reference mutates the view in place, observable through the SAME
handle, which the rebind preserves). A copy of
``deeplearning4j_tpu/ndarray/indexing.py``, which imports no JAX; the port
keeps its own so that it imports nothing of the JAX package."""
from __future__ import annotations

from typing import Tuple


class INDArrayIndex:
    """Base marker (ref: org.nd4j.linalg.indexing.INDArrayIndex)."""

    def lower(self):
        raise NotImplementedError


class _Point(INDArrayIndex):
    def __init__(self, i: int):
        self.i = int(i)

    def lower(self):
        return self.i

    def __repr__(self):
        return f"point({self.i})"


class _All(INDArrayIndex):
    def lower(self):
        return slice(None)

    def __repr__(self):
        return "all()"


class _Interval(INDArrayIndex):
    def __init__(self, start: int, stride: int, end: int, inclusive: bool):
        self.start, self.stride, self.end = int(start), int(stride), int(end)
        self.inclusive = inclusive

    def lower(self):
        end = self.end + 1 if self.inclusive else self.end
        return slice(self.start, end, self.stride)

    def __repr__(self):
        return f"interval({self.start},{self.stride},{self.end}" \
            + (",inclusive)" if self.inclusive else ")")


class _NewAxis(INDArrayIndex):
    def lower(self):
        return None  # numpy newaxis

    def __repr__(self):
        return "newAxis()"


class _Specified(INDArrayIndex):
    def __init__(self, idxs):
        self.idxs = [int(i) for i in idxs]

    def lower(self):
        import numpy as np
        return np.asarray(self.idxs)

    def __repr__(self):
        return f"indices({self.idxs})"


class NDArrayIndex:
    """Static factories (ref: NDArrayIndex.point/all/interval/newAxis)."""

    @staticmethod
    def point(i: int) -> INDArrayIndex:
        return _Point(i)

    @staticmethod
    def all() -> INDArrayIndex:
        return _All()

    @staticmethod
    def interval(start: int, *args, inclusive: bool = False) -> INDArrayIndex:
        """interval(a, b) | interval(a, stride, b) | the reference's 4-arg
        form interval(a, stride, b, inclusive) via the keyword."""
        if len(args) == 1:
            stride, end = 1, args[0]
        elif len(args) == 2:
            stride, end = args
        elif len(args) == 3:
            stride, end, inclusive = args
        else:
            raise TypeError("interval(start, [stride,] end[, inclusive])")
        return _Interval(start, stride, end, inclusive)

    @staticmethod
    def newAxis() -> INDArrayIndex:
        return _NewAxis()

    @staticmethod
    def indices(*idxs) -> INDArrayIndex:
        return _Specified(idxs)


def lower_indices(indices) -> Tuple:
    """INDArrayIndex / raw int / slice sequence -> numpy index tuple.
    Trailing unspecified dimensions are implicit all() (numpy already
    behaves this way for a short tuple)."""
    out = []
    for ix in indices:
        out.append(ix.lower() if isinstance(ix, INDArrayIndex) else ix)
    return tuple(out)
