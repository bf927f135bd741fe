"""The collectives of a traced step (the port's counterpart of the
reference's HLO collective parser).

The reference regexes the compiled HLO for all-reduce, all-gather,
reduce-scatter, all-to-all and collective-permute ops and sums their
result-shape bytes. The port has no HLO; it reads a ``torch.profiler``
trace taken with ``record_shapes=True`` instead. ``torch.distributed``
records each collective call as a ``c10d::`` op (its tensor-list arguments
carry no shapes in the events) and, inside it, one event of the backend
that ran it, named ``<backend>:<collective>`` (``gloo:all_reduce``;
``nccl:all_reduce`` on the card) whose inputs are the tensors. Each
collective is counted once, from its backend event on the host, as the
bytes of its first input: for an all-reduce the reduced tensor (the
reference's result shape); for a gather or scatter what the rank hands
in. ``as_dict()`` has the reference's keys.
"""
from __future__ import annotations

import math
import re
from collections import defaultdict
from dataclasses import dataclass, field

#: bytes of an element, by the profiler's type name of a tensor input
DTYPE_BYTES = {
    "bool": 1, "signed char": 1, "unsigned char": 1, "short int": 2,
    "c10::BFloat16": 2, "c10::Half": 2, "int": 4, "unsigned int": 4, "float": 4,
    "long int": 8, "double": 8, "c10::complex<float>": 8,
    "c10::Float8_e4m3fn": 1, "c10::Float8_e5m2": 1,
}

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")

#: a backend's event name -> the reference's collective name
_EVENT_RE = re.compile(r"^(gloo|nccl|ucc|mpi):(.+)$")
_OP_OF = {
    "all_reduce": "all-reduce", "allreduce": "all-reduce",
    "all_gather": "all-gather", "allgather": "all-gather",
    "all_gather_into_tensor": "all-gather", "_allgather_base": "all-gather",
    "reduce_scatter": "reduce-scatter", "reduce_scatter_tensor": "reduce-scatter",
    "_reduce_scatter_base": "reduce-scatter",
    "all_to_all": "all-to-all", "alltoall": "all-to-all", "all_to_all_single": "all-to-all",
    "alltoall_base": "all-to-all",
    "send": "collective-permute", "recv": "collective-permute",
}


@dataclass
class CollectiveStats:
    per_op: dict = field(default_factory=lambda: defaultdict(int))  # op -> bytes
    per_op_count: dict = field(default_factory=lambda: defaultdict(int))
    total_bytes: int = 0

    def as_dict(self):
        return {
            "total_bytes": self.total_bytes,
            "by_op_bytes": dict(self.per_op),
            "by_op_count": dict(self.per_op_count),
        }


def _events(trace) -> list:
    """(name, first input's shape or None, its dtype name or None, start)
    of every host-side event of ``trace``, in the order they started. A
    ``torch.profiler.profile`` is read through its kineto events, which
    carry the inputs' dtypes on torch 2.11 (the card's: its
    ``FunctionEvent``s have shapes only) as on 2.13; a list of
    ``FunctionEvent``-like objects is read as it is."""
    from torch.autograd import DeviceType

    out = []
    kineto = getattr(getattr(trace, "profiler", None), "kineto_results", None)
    if kineto is not None:
        for e in kineto.events():
            if e.device_type() == DeviceType.CPU:
                shapes, types = e.shapes(), e.dtypes()
                out.append((e.name(), tuple(shapes[0]) if shapes else None,
                            types[0] if types else None, e.start_ns()))
    else:
        for e in (trace.events() if hasattr(trace, "events") else trace):
            if getattr(e, "device_type", DeviceType.CPU) == DeviceType.CPU:
                shapes, types = e.input_shapes or [], getattr(e, "input_dtypes", None) or []
                out.append((e.name, tuple(shapes[0]) if shapes else None,
                            types[0] if types else None, e.time_range.start))
    return sorted(out, key=lambda ev: ev[3])


def parse_collectives(trace) -> CollectiveStats:
    """Bytes and counts of the collectives in ``trace`` (a profile taken with
    ``record_shapes=True``), by the reference's op names."""
    stats = CollectiveStats()
    for name, shape, dtype, _ in _events(trace):
        m = _EVENT_RE.match(name)
        if not m or m.group(2) not in _OP_OF:
            continue
        if shape is None or dtype not in DTYPE_BYTES:
            raise ValueError(f"{name} carries no tensor shape or dtype ({shape}, {dtype}): "
                             f"profile with record_shapes=True")
        op = _OP_OF[m.group(2)]
        nbytes = math.prod(shape) * DTYPE_BYTES[dtype]
        stats.per_op[op] += nbytes
        stats.per_op_count[op] += 1
        stats.total_bytes += nbytes
    return stats
