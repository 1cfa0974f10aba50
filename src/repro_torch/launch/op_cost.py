"""What one step of the port costs, counted op by op as it runs: the
counterpart of the reference's ``launch/hlo_cost.py`` and
``launch/hlo_analysis.py``, which walk compiled HLO. The port has no HLO:
``OpCost`` is a ``TorchDispatchMode`` that sees every aten op a step
dispatches (on the meta device, where nothing is computed, or on any
other) and adds up:

* FLOPs by dtype. A product (``mm``, ``addmm``, ``bmm``, ``baddbmm``,
  ``convolution``) counts 2 x output x contracted elements, as
  ``hlo_cost._dot_flops`` does (an ``addmm``'s bias add one more FLOP an
  output element); every other op that computes counts one FLOP an output
  element, as ``hlo_cost`` counts elementwise ops and reductions (a
  reduction by its input). Views and allocations count nothing, copies and
  gathers bytes only.
* Bytes at each op's boundary, its inputs plus its outputs: what eager
  PyTorch moves, op by op. XLA fuses and PyTorch does not, so these are
  not the reference's bytes.
* Collective bytes by kind, from the ``c10d`` and ``_c10d_functional``
  ops, counted as ``hlo_analysis.collective_bytes`` and
  ``collective_wire_bytes`` count them. On one card there are none.
* Peak live bytes, by storage: each storage an op's output brings into
  being is live from then until it is freed (a finalizer on the storage,
  keyed by its ``StorageWeakRef``), so views never count twice; what
  exists before the step (``track``) is live from the start.
* The hand-written kernels. A kernel wrapper on the meta device launches
  nothing and reports its call (``kernels/_build.py::launch``); it is
  counted by the cost function beside it in its ``ops.py``, as one call
  under its launch counter's name, never as the aten ops of its plain
  version. Its outputs' allocations are the wrapper's own aten ops.
"""
from __future__ import annotations

import weakref
from typing import Callable, Dict, Iterable, Tuple

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.mlstm import ops as mlstm_ops
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.kernels.slstm import ops as slstm_ops
from repro_torch.kernels.ssm_scan import ops as scan_ops

# the rate a FLOP is counted at (``roofline.PEAKS``): bf16 and f16 on the
# tensor cores, split TF32 (the f32 kernels' products as hi + lo halves,
# three products each), everything else at the f32 FMA rate
SPLIT_TF32 = "tf32x3"


# each kernel launch counter's cost function (kernels/*/ops.py) and the
# rate its operations run at, by the counter's name
KERNELS: Dict[str, Tuple[Callable[..., tuple], Callable[[dict], str]]] = {
    "flash_attention_tc": (flash_ops.fwd_cost, lambda s: "bf16"),
    "flash_attention_tf32": (flash_ops.fwd_cost, lambda s: SPLIT_TF32),
    "flash_attention_bwd_dkdv_tc": (flash_ops.dkdv_cost, lambda s: "bf16"),
    "flash_attention_bwd_dkdv_tf32": (flash_ops.dkdv_cost, lambda s: SPLIT_TF32),
    "flash_attention_bwd_dq_tc": (flash_ops.dq_cost, lambda s: "bf16"),
    "flash_attention_bwd_dq_tf32": (flash_ops.dq_cost, lambda s: SPLIT_TF32),
    "paged_attention_tc": (paged_ops.cost, lambda s: "bf16"),
    "paged_attention_fma": (paged_ops.cost, lambda s: "f32"),
    "paged_attention_int8_tc": (paged_ops.int8_cost, lambda s: "bf16"),
    "paged_attention_int8_fma": (paged_ops.int8_cost, lambda s: "f32"),
    "ssm_scan": (scan_ops.cost, lambda s: "f32"),
    "ssm_scan_bwd": (scan_ops.bwd_cost, lambda s: "f32"),
    "mlstm_tc": (mlstm_ops.cost, lambda s: "bf16"),
    "mlstm_tf32": (mlstm_ops.cost, lambda s: SPLIT_TF32),
    "mlstm_step": (mlstm_ops.cost, lambda s: "f32"),
    "mlstm_bwd": (mlstm_ops.bwd_cost, lambda s: "bf16" if s["el"] == 2 else SPLIT_TF32),
    "slstm": (slstm_ops.cost, lambda s: "f32"),
    # its wrapper's dr is an aten product, counted as such
    "slstm_bwd": (lambda **s: slstm_ops.bwd_cost(**s, dr=False), lambda s: "f32"),
}

# ops that make a view, an alias or an allocation: no FLOP, no byte
_FREE = {
    "view", "_unsafe_view", "alias", "as_strided", "t", "transpose", "permute", "expand",
    "unsqueeze", "squeeze", "select", "slice", "split", "split_with_sizes", "unbind",
    "chunk", "narrow", "detach", "view_as_real", "view_as_complex", "unfold", "diagonal",
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided", "lift_fresh",
    "_reshape_alias", "set_", "resize_", "_to_copy_meta", "is_same_size", "sym_size",
    "sym_stride", "sym_numel", "sym_storage_offset", "_local_scalar_dense", "item",
    "is_nonzero", "equal",
}
# ops that move data and compute nothing: bytes only
_MOVE = {
    "copy_", "clone", "_to_copy", "contiguous", "cat", "stack", "index_select", "gather",
    "index", "index_put_", "index_put", "index_copy", "index_copy_", "scatter", "scatter_",
    "slice_scatter", "select_scatter", "as_strided_scatter", "pad", "constant_pad_nd",
    "repeat", "roll", "flip", "zero_", "fill_", "zeros", "zeros_like", "ones", "ones_like",
    "full", "full_like", "new_zeros", "new_ones", "new_full", "scalar_tensor", "arange",
    "embedding", "masked_select", "tril", "triu", "fill", "_unsafe_index",
}
_PRODUCTS = {"mm", "addmm", "bmm", "baddbmm", "convolution"}
# collectives by kind, as hlo_analysis.COLLECTIVE_KINDS names them
_COLLECTIVES = {
    "all_reduce": "all-reduce", "allreduce_": "all-reduce", "all_reduce_coalesced":
    "all-reduce", "all_gather_into_tensor": "all-gather", "allgather_": "all-gather",
    "_allgather_base_": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter", "all_to_all_single": "all-to-all",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all", "send": "collective-permute",
    "recv_": "collective-permute", "broadcast_": "collective-permute",
}
COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                    "collective-permute")

_DTYPES = {torch.bfloat16: "bf16", torch.float16: "f16", torch.float32: "f32",
           torch.float64: "f64"}


def tensors(tree, out=None) -> list:
    """The tensors among an op's arguments or results (lists, tuples and
    dicts walked), in order."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            tensors(x, out)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _dtype(t: torch.Tensor) -> str:
    return _DTYPES.get(t.dtype, str(t.dtype).replace("torch.", ""))


def collective_wire_bytes(coll: Dict[str, float]) -> float:
    """Per-card wire traffic from per-kind bytes, as the reference counts it
    (a ring all-reduce moves about twice its buffer)."""
    return (2.0 * coll["all-reduce"] + coll["all-gather"] + coll["reduce-scatter"]
            + coll["all-to-all"] + coll["collective-permute"])


class OpCost(TorchDispatchMode):
    """Counts a step's cost while it is on (``with OpCost() as c: step()``)."""

    def __init__(self):
        super().__init__()
        self.flops_by_dtype: Dict[str, float] = {}
        self.product_flops = 0.0          # the aten products' share: what FlopCounterMode sees
        self.bytes = 0.0
        self.collectives = dict.fromkeys(COLLECTIVE_KINDS, 0.0)
        self.collective_count = 0
        self.kernel_calls: Dict[str, int] = {}
        self.live = 0
        self.peak = 0
        self._storages: Dict[int, int] = {}

    # -- peak live bytes ---------------------------------------------------
    def track(self, tensors: Iterable[torch.Tensor]) -> None:
        """Count the storages of ``tensors`` (what exists before the step:
        params, optimizer state, inputs, caches) as live from now."""
        for t in tensors:
            self._alloc(t)

    def _alloc(self, t: torch.Tensor) -> None:
        storage = t.untyped_storage()
        key = StorageWeakRef(storage).cdata
        if key in self._storages:
            return
        n = storage.nbytes()
        self._storages[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(storage, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._storages.pop(key, 0)

    # -- counting ------------------------------------------------------------
    def _add_flops(self, dtype: str, n: float) -> None:
        self.flops_by_dtype[dtype] = self.flops_by_dtype.get(dtype, 0.0) + n

    def kernel(self, name: str, **shape) -> None:
        """A hand-written kernel's call on the meta device
        (``_build.meta_sinks``)."""
        fn, rate = KERNELS[name]
        flops, nbytes = fn(**shape)
        self._add_flops(rate(shape), flops)
        self.bytes += nbytes
        self.kernel_calls[name] = self.kernel_calls.get(name, 0) + 1

    def __enter__(self):
        _build.meta_sinks.append(self.kernel)
        return super().__enter__()

    def __exit__(self, *exc):
        _build.meta_sinks.remove(self.kernel)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ns, name = _names(func)
        ins, outs = tensors((args, kwargs)), tensors(out)
        for t in outs:
            self._alloc(t)
        if ns in ("c10d", "_c10d_functional", "c10d_functional"):
            kind = _COLLECTIVES.get(name)
            if kind is not None:
                nbytes = sum(map(_nbytes, outs or ins))
                self.collectives[kind] += nbytes
                self.collective_count += 1
                self.bytes += nbytes
            return out
        if name in _FREE or not outs:
            return out
        moved = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        if name == "copy_":            # the destination is written, not read
            moved -= _nbytes(ins[0])
        self.bytes += moved
        if name in _MOVE:
            return out
        if name in _PRODUCTS:
            flops = _product_flops(name, args, outs[0])
            self.product_flops += flops
            self._add_flops(_dtype(outs[0]), flops)
            if name in ("addmm", "baddbmm"):
                self._add_flops(_dtype(outs[0]), outs[0].numel())
            return out
        # elementwise and reductions: one FLOP an element of the larger side
        self._add_flops(_dtype(outs[0]), max(t.numel() for t in ins + outs))
        return out

    def record(self) -> dict:
        """The counts in the dry run's record's names."""
        return {
            "flops": sum(self.flops_by_dtype.values()),
            "flops_by_dtype": dict(sorted(self.flops_by_dtype.items())),
            "product_flops": self.product_flops,
            "hbm_bytes": self.bytes,
            "collectives": {**self.collectives, "count": self.collective_count},
            "collective_wire_bytes": collective_wire_bytes(self.collectives),
            "peak_bytes_per_device": self.peak,
            "kernel_calls": dict(sorted(self.kernel_calls.items())),
        }


_NAMES: Dict[object, Tuple[str, str]] = {}


def _names(func) -> Tuple[str, str]:
    """(namespace, op name without overload) of an op, remembered."""
    got = _NAMES.get(func)
    if got is None:
        got = _NAMES[func] = (func.namespace, func._schema.name.split("::")[-1])
    return got


def _product_flops(name: str, args, out: torch.Tensor) -> float:
    """2 x output elements x contracted elements."""
    if name in ("mm", "bmm"):
        return 2.0 * out.numel() * args[0].shape[-1]
    if name in ("addmm", "baddbmm"):
        return 2.0 * out.numel() * args[1].shape[-1]
    w = args[1]                        # convolution: (out_ch, in_ch / groups, *kernel)
    return 2.0 * out.numel() * w[0].numel()
