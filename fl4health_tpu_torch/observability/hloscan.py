"""Per-stage cost attribution from the ATen op stream (counterpart of
``fl4health_tpu/observability/hloscan.py``; the name is kept so a reader
finds it).

JAX walks a compiled program's optimized-HLO text. The port has no HLO: it
runs the round function once under ``FakeTensorMode`` (no device memory, no
kernel, ``observability/introspect.py``) with :class:`OpCounter`, a
``TorchDispatchMode``, inside it. Every ATen op the run dispatches (the
forward, the backward that ``torch.func.grad`` runs, every client at once
under ``torch.func.vmap``) is charged to the innermost ``fl_stage::`` scope
open on the thread (``observability/stages.py``), with JAX's counting
rules:

- a dot (``mm``, ``addmm``, ``bmm``, ``baddbmm``, ``mv``, ``dot``: what
  ``matmul``, ``linear`` and ``einsum`` decompose to): ``2 *
  prod(result dims) * prod(contracted dims)`` (observability/flops.py);
  ``addmm``'s and ``baddbmm``'s add is one more flop per output element;
- a convolution: ``2 * prod(output) * prod(weight) / out_channels`` (the
  input's spatial dims in place of the output's for a transposed one),
  client-grouped convolutions included; each of ``convolution_backward``'s
  input and weight gradients counts as one forward-sized convolution;
- a reduction: input elements minus output elements;
- an elementwise op: one flop per output element, except transcendentals
  (exp/log/tanh/sqrt/...), which land in ``transcendentals``; a softmax
  counts as its decomposition (two reductions, two elementwise passes, one
  exp pass);
- view, alias and metadata ops are free; data movement (copies, gathers,
  concatenations, factories) costs bytes and no flops;
- bytes per op: operand bytes plus result bytes. Eager PyTorch fuses
  nothing, so every op reads and writes memory and
  ``fusion_headroom_bytes`` (per-op bytes minus unique-buffer bytes) is
  what a fused kernel of that stage could save;
- a hand-written kernel is a black box, as a Pallas call is in JAX: 0
  flops, its boundary bytes, and one more ``custom_calls`` on its stage.
  The kernels are pybind functions, which a dispatch mode cannot see, so
  each wrapper reports itself (:func:`note_custom_call`) from the branch it
  takes on fake tensors.

Ops are charged to the stage open on the thread that entered the counter,
whichever thread runs them: on a card, autograd runs a backward (and the
kernels' backward calls) on its device thread, which inherits the dispatch
mode, while the dispatching thread waits.

The counter's dot and convolution flops (``dot_flops``) equal
``torch.utils.flop_counter.FlopCounterMode``'s total for the same call,
with one correction: FlopCounterMode charges a grouped convolution's
weight gradient ``groups`` times a forward-sized convolution (its formula
takes the whole input's channels as each group's). A per-example or
per-client weight gradient is such a grouped convolution, so
:func:`reference_flop_counter` divides that term by ``groups``; on
ungrouped programs it is FlopCounterMode unchanged.

Per-stage sums plus the ``_unattributed`` remainder equal the counter's
program totals by construction; :func:`conservation` reconciles them with
a program total within :data:`FLOPS_RTOL`/:data:`BYTES_RTOL`, as in JAX.
"""

from __future__ import annotations

import threading
import weakref
from math import prod
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from fl4health_tpu_torch.observability import device_specs
from fl4health_tpu_torch.observability import flops as flops_rules
from fl4health_tpu_torch.observability import stages as stage_attr
from fl4health_tpu_torch.observability.stages import SPINE_STAGES, UNATTRIBUTED

# Conservation tolerances against a whole-program total (JAX's).
FLOPS_RTOL = 0.15
BYTES_RTOL = 0.60

_DOT = frozenset(("mm", "addmm", "bmm", "baddbmm", "mv", "addmv", "dot", "vdot"))
# dots whose beta * C + alpha * AB add is one flop per output element
_DOT_WITH_ADD = frozenset(("addmm", "baddbmm", "addmv"))
_CONV = frozenset(("convolution", "_convolution", "convolution_overrideable",
                   "cudnn_convolution", "mkldnn_convolution", "_slow_conv2d_forward"))
_CONV_BACKWARD = frozenset(("convolution_backward", "convolution_backward_overrideable"))
_REDUCE = frozenset((
    "sum", "mean", "amax", "amin", "prod", "argmax", "argmin", "any", "all", "norm",
    "linalg_vector_norm", "var", "std", "var_mean", "std_mean", "logsumexp", "nansum",
    "nanmean", "count_nonzero", "aminmax",
))
# a reduction with one operand, an elementwise op with two
_MAX_MIN = frozenset(("max", "min"))
_TRANSCENDENTAL = frozenset((
    "exp", "exp2", "expm1", "log", "log1p", "log2", "log10", "tanh", "sigmoid", "sqrt",
    "rsqrt", "sin", "cos", "tan", "asin", "acos", "atan", "atan2", "sinh", "cosh",
    "asinh", "acosh", "atanh", "erf", "erfc", "erfinv", "lgamma", "digamma", "gelu",
    "silu", "softplus", "logit", "float_power",
))
_ELEMENTWISE = frozenset((
    "add", "sub", "rsub", "mul", "div", "neg", "abs", "sign", "sgn", "floor", "ceil",
    "round", "trunc", "frac", "clamp", "clamp_min", "clamp_max", "clip", "maximum",
    "minimum", "fmax", "fmin", "where", "eq", "ne", "lt", "le", "gt", "ge",
    "logical_and", "logical_or", "logical_xor", "logical_not", "bitwise_and",
    "bitwise_or", "bitwise_xor", "bitwise_not", "__lshift__", "__rshift__",
    "bitwise_left_shift", "bitwise_right_shift", "relu", "threshold",
    "threshold_backward", "hardtanh", "leaky_relu", "remainder", "fmod", "reciprocal",
    "isfinite", "isnan", "isinf", "isneginf", "isposinf", "addcmul", "addcdiv", "lerp",
    "masked_fill", "nan_to_num", "sigmoid_backward", "tanh_backward", "gelu_backward",
    "square", "copysign", "signbit", "xlogy", "hypot", "heaviside",
))
_SOFTMAX = frozenset(("_softmax", "_log_softmax", "_softmax_backward_data",
                      "_log_softmax_backward_data"))
# allocation, alias and metadata ops: no work, no bytes
_FREE = frozenset((
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided", "detach",
    "alias", "lift_fresh", "_unsafe_view", "sym_size", "sym_stride", "sym_numel",
    "sym_storage_offset", "is_same_size", "_has_compatible_shallow_copy_type",
    "record_stream", "promote_types", "result_type", "_record_function_enter",
    "_record_function_enter_new", "_record_function_exit",
))
_FREE_NAMESPACES = frozenset(("prim", "profiler"))

# the counters entered and not yet left. Process-wide, not a thread's: on a
# card autograd runs a backward on its device thread, where the kernels'
# fake branches report; only the introspection's run makes fake tensors
_ACTIVE: list["OpCounter"] = []


def note_custom_call(name: str, inputs, outputs) -> None:
    """A hand-written kernel's call, reported by its wrapper's fake-tensor
    branch to the active counters: 0 flops, its boundary bytes, one more
    ``custom_calls`` on the current stage."""
    for counter in list(_ACTIVE):
        counter.custom_call(name, inputs, outputs)


def _tensors(tree) -> list[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> float:
    return float(t.numel() * t.element_size())


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _op_name(func) -> str:
    name = func.overloadpacket.__name__
    if name.endswith("_") and not name.endswith("__"):
        name = name[:-1]  # in place: the out-of-place op's work
    return name


def conv_flops(x_shape, w_shape, out_shape, transposed: bool) -> float:
    """``2 * prod(output) * prod(weight) / out_channels`` (the input's
    spatial size in place of the output's for a transposed convolution,
    whose weight's first axis is its input channels); a grouped weight's
    second axis is already one group's channels."""
    side = x_shape if transposed else out_shape
    return 2.0 * prod(side) * prod(w_shape) / max(w_shape[0], 1)


def _dot_flops(name: str, args, out: torch.Tensor) -> float:
    """2 * prod(result) * prod(contracted) of one dot op."""
    if name in ("addmm", "baddbmm", "addmv"):
        a = args[1]
    else:
        a = args[0]
    contracted = (a.shape[-1],)
    if name in ("dot", "vdot"):
        return flops_rules.dot_flops((1,), contracted)
    return flops_rules.dot_flops(tuple(out.shape), contracted)


def _conv_backward_flops(args, outs) -> float:
    """Each requested gradient (input, weight) is one forward-sized
    convolution of ``grad_out`` from ``input`` by ``weight``."""
    grad_out, x, w = args[0], args[1], args[2]
    transposed, mask = bool(args[7]), args[10]
    one = conv_flops(tuple(x.shape), tuple(w.shape), tuple(grad_out.shape), transposed)
    return one * (int(bool(mask[0])) + int(bool(mask[1])))


def _softmax_flops(name: str, args, out: torch.Tensor) -> tuple[float, float]:
    """(flops, transcendentals) of a softmax as its decomposition: max and
    sum reductions, subtract and normalise passes, one exp pass (and the
    log of the sums, or the backward's products)."""
    n = out.numel()
    dim = args[1] if name in ("_softmax", "_log_softmax") else args[2]
    size = out.shape[dim] if out.ndim else 1
    m = n // max(size, 1)
    reduced = max(n - m, 0)
    if name == "_softmax":
        return 2.0 * reduced + 2.0 * n, float(n)
    if name == "_log_softmax":
        return 2.0 * reduced + 2.0 * n, float(n + m)
    if name == "_softmax_backward_data":
        return 3.0 * n + reduced, 0.0
    return 2.0 * n + reduced, float(n)  # _log_softmax_backward_data


def op_flops(func, args, kwargs, outs: list[torch.Tensor]) -> tuple[float, float, float]:
    """(flops, transcendentals, dot and convolution flops) of one op."""
    name = _op_name(func)
    out = outs[0] if outs else None
    out_elems = float(sum(t.numel() for t in outs))
    if name in _DOT and out is not None:
        dot = _dot_flops(name, args, out)
        extra = out_elems if name in _DOT_WITH_ADD else 0.0
        return dot + extra, 0.0, dot
    if name in _CONV and out is not None:
        transposed = bool(args[6]) if len(args) > 6 else False
        f = conv_flops(tuple(args[0].shape), tuple(args[1].shape), tuple(out.shape),
                       transposed)
        return f, 0.0, f
    if name in _CONV_BACKWARD:
        f = _conv_backward_flops(args, outs)
        return f, 0.0, f
    if name in _SOFTMAX and out is not None:
        f, t = _softmax_flops(name, args, out)
        return f, t, 0.0
    tensor_args = [a for a in args if isinstance(a, torch.Tensor)]
    if name in _REDUCE or (name in _MAX_MIN and len(tensor_args) == 1):
        in_elems = float(tensor_args[0].numel()) if tensor_args else 0.0
        first_out = float(out.numel()) if out is not None else 0.0
        return max(in_elems - first_out, 0.0), 0.0, 0.0
    if name == "pow":
        exponent = args[1] if len(args) > 1 else kwargs.get("exponent")
        if isinstance(exponent, (int, float)) and float(exponent).is_integer():
            return out_elems, 0.0, 0.0  # an integer power is multiplies
        return 0.0, out_elems, 0.0
    if name in _TRANSCENDENTAL:
        return 0.0, out_elems, 0.0
    if name in _ELEMENTWISE or name in _MAX_MIN:
        return out_elems, 0.0, 0.0
    if name in ("_to_copy", "copy") and out is not None and tensor_args:
        src = tensor_args[-1] if name == "copy" else tensor_args[0]
        # a dtype change is XLA's convert (one flop an element); a copy is free
        return (out_elems if src.dtype != out.dtype else 0.0), 0.0, 0.0
    return 0.0, 0.0, 0.0


def _is_free(func, name: str, in_keys: set, outs: list[torch.Tensor]) -> bool:
    if func.namespace in _FREE_NAMESPACES or name in _FREE or func.is_view:
        return True
    if func._schema.is_mutable or not outs:
        return not outs
    # an op whose every output aliases an operand moved no data
    return all(_storage_key(t) in in_keys for t in outs)


class _StageAcc:
    __slots__ = ("flops", "transcendentals", "bytes", "ops", "custom_calls", "buffers",
                 "dot_flops")

    def __init__(self):
        self.flops = 0.0
        self.transcendentals = 0.0
        self.bytes = 0.0
        self.ops = 0
        self.custom_calls = 0
        self.dot_flops = 0.0
        self.buffers: dict[int, float] = {}


class OpCounter(TorchDispatchMode):
    """Charges every dispatched op's flops and bytes to the innermost open
    stage and tracks the live bytes of the buffers the run makes (their
    peak is the program's temporaries). Enter it INSIDE a
    ``FakeTensorMode`` (``count_program``), so it sees each op first."""

    def __init__(self):
        super().__init__()
        self.accs: dict[str, _StageAcc] = {}
        self.kernel_calls: dict[str, int] = {}
        self._serial: dict[int, int] = {}
        self._next_serial = 0
        self._live: dict[int, float] = {}
        self._live_bytes = 0.0
        self.peak_live_bytes = 0.0
        self.argument_bytes = 0
        self.output_bytes = 0
        self._owner = threading.get_ident()

    # -- context -----------------------------------------------------------
    def __enter__(self):
        # the thread whose open stage every op is charged to, wherever it runs
        self._owner = threading.get_ident()
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    # -- buffers -----------------------------------------------------------
    def _buffer(self, t: torch.Tensor) -> int:
        key = _storage_key(t)
        serial = self._serial.get(key)
        if serial is None:
            serial = self._serial[key] = self._next_serial
            self._next_serial += 1
        return serial

    def _allocated(self, t: torch.Tensor) -> None:
        """A buffer the run made: a fresh serial (the storage's address may
        be a freed one's), live until its tensor dies."""
        key = _storage_key(t)
        self._serial[key] = self._next_serial
        self._next_serial += 1
        nbytes = float(t.untyped_storage().nbytes())
        self._live[key] = nbytes
        self._live_bytes += nbytes
        self.peak_live_bytes = max(self.peak_live_bytes, self._live_bytes)
        weakref.finalize(t, self._freed, key, nbytes)

    def _freed(self, key: int, nbytes: float) -> None:
        if self._live.get(key) == nbytes:
            del self._live[key]
            self._live_bytes -= nbytes

    def note_arguments(self, args) -> None:
        seen: dict[int, float] = {}
        for t in _tensors(args):
            seen[_storage_key(t)] = float(t.untyped_storage().nbytes())
            self._buffer(t)
        self.argument_bytes = int(sum(seen.values()))

    def note_outputs(self, out) -> None:
        seen: dict[int, float] = {}
        for t in _tensors(out):
            seen[_storage_key(t)] = float(t.untyped_storage().nbytes())
        self.output_bytes = int(sum(seen.values()))

    # -- charging ----------------------------------------------------------
    def _acc(self) -> _StageAcc:
        key = stage_attr.current(self._owner) or UNATTRIBUTED
        acc = self.accs.get(key)
        if acc is None:
            acc = self.accs[key] = _StageAcc()
        return acc

    def _charge_bytes(self, acc: _StageAcc, ins: list[torch.Tensor],
                      outs: list[torch.Tensor]) -> None:
        for t in (*ins, *outs):
            nbytes = _nbytes(t)
            acc.bytes += nbytes
            serial = self._buffer(t)
            acc.buffers[serial] = max(acc.buffers.get(serial, 0.0), nbytes)

    def custom_call(self, name: str, inputs, outputs) -> None:
        acc = self._acc()
        acc.ops += 1
        acc.custom_calls += 1
        self.kernel_calls[name] = self.kernel_calls.get(name, 0) + 1
        self._charge_bytes(acc, _tensors(inputs), _tensors(outputs))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = _tensors((args, kwargs))
        in_keys = {_storage_key(t) for t in ins}
        out = func(*args, **kwargs)
        outs = _tensors(out)
        for t in outs:
            key = _storage_key(t)
            if key not in in_keys and key not in self._live:
                self._allocated(t)
        name = _op_name(func)
        if _is_free(func, name, in_keys, outs):
            return out
        acc = self._acc()
        f, tr, dot = op_flops(func, args, kwargs, outs)
        acc.flops += f
        acc.transcendentals += tr
        acc.dot_flops += dot
        acc.ops += 1
        self._charge_bytes(acc, ins, outs)
        return out

    # -- results -----------------------------------------------------------
    @property
    def dot_flops(self) -> float:
        return sum(a.dot_flops for a in self.accs.values())

    @property
    def temp_bytes(self) -> int:
        """Peak live bytes of the buffers the run made, less its outputs'."""
        return int(max(self.peak_live_bytes - self.output_bytes, 0.0))

    def rows(self, device_kind: str | None = None, scale: float = 1.0) -> list[dict]:
        """One row per stage in JAX's schema and order (spine order, then
        extras, then ``_unattributed``); every additive number times
        ``scale``. Roofline keys appear only where classifiable."""
        rows = []
        for stage_name, a in self.accs.items():
            unique = sum(a.buffers.values())
            headroom = max(a.bytes - unique, 0.0)
            row: dict[str, Any] = {
                "stage": stage_name,
                "flops": a.flops * scale,
                "transcendentals": a.transcendentals * scale,
                "bytes_accessed": a.bytes * scale,
                "ops": int(a.ops * scale),
                "custom_calls": int(a.custom_calls * scale),
                "fusion_headroom_bytes": headroom * scale,
                "fusion_headroom_frac": (headroom / a.bytes) if a.bytes > 0 else None,
            }
            roof = device_specs.roofline(row["flops"], row["bytes_accessed"], device_kind)
            if roof:
                row.update(roof)
                if "compute_bound" in roof:
                    row["bound"] = "compute" if roof["compute_bound"] else "hbm"
            rows.append(row)
        return order_rows(rows)


def order_rows(rows: list[dict[str, Any]]) -> list[dict[str, Any]]:
    """JAX's row order: spine stages in pipeline order, then extras by
    name, then ``_unattributed`` last."""
    def order(row: dict[str, Any]) -> tuple[int, str]:
        s = row["stage"]
        if s in SPINE_STAGES:
            return (0, f"{SPINE_STAGES.index(s):02d}")
        if s == UNATTRIBUTED:
            return (2, s)
        return (1, s)

    return sorted(rows, key=order)


def count_program(fn, args: tuple, device="cpu") -> OpCounter:
    """Run ``fn(*args)`` once on fake tensors with an :class:`OpCounter`
    inside the fake mode: shapes and dtypes propagate, no device memory is
    taken and no kernel runs. Meta tensors in ``args`` stand for arguments
    by shape and dtype alone (JAX's ``ShapeDtypeStruct``) and become fake
    tensors on ``device``; tensors the function reaches from its closure
    become fake on first use. Returns the counter."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._pytree import tree_map_only

    mode = FakeTensorMode(allow_non_fake_inputs=True)

    def fake(t: torch.Tensor) -> torch.Tensor:
        if t.is_meta:
            with mode:
                return torch.empty(t.shape, dtype=t.dtype, device=device)
        return mode.from_tensor(t)

    fake_args = tree_map_only(torch.Tensor, fake, args)
    counter = OpCounter()
    with mode, counter:
        counter.note_arguments(fake_args)
        out = fn(*fake_args)
        counter.note_outputs(out)
    return counter


def _conv_backward_reference(grad_out_shape, x_shape, w_shape, _bias, _stride, _padding,
                             _dilation, transposed, _output_padding, groups, output_mask,
                             out_shape, **kwargs) -> int:
    """FlopCounterMode's ``convolution_backward`` formula with its weight
    gradient term divided by ``groups``."""
    from torch.utils import flop_counter

    # the registered formula is wrapped to take tensors; its raw form takes
    # shapes, as this function does
    raw = flop_counter.conv_backward_flop
    conv_backward_flop = getattr(raw, "__wrapped__", raw)
    common = (grad_out_shape, x_shape, w_shape, _bias, _stride, _padding, _dilation,
              transposed, _output_padding, groups)
    dx = conv_backward_flop(*common, [output_mask[0], False], out_shape)
    dw = conv_backward_flop(*common, [False, output_mask[1]], out_shape)
    return dx + dw // max(int(groups), 1)


def _mv_reference(a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
    return 2 * prod(a_shape)


def _addmv_reference(self_shape, a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
    return 2 * prod(a_shape)


def reference_flop_counter(display: bool = False):
    """``FlopCounterMode`` with the grouped weight-gradient correction of
    the module docstring, and rules for the vector dots it has none for
    (``mv``, ``addmv``, ``dot``): the reference that ``OpCounter.dot_flops``
    is held to."""
    from torch.utils.flop_counter import FlopCounterMode

    aten = torch.ops.aten
    return FlopCounterMode(display=display, custom_mapping={
        aten.convolution_backward: _conv_backward_reference,
        aten.mv: _mv_reference, aten.dot: _mv_reference, aten.vdot: _mv_reference,
        aten.addmv: _addmv_reference})


def totals(stages: list[dict[str, Any]]) -> dict[str, float]:
    """The stage rows' program totals (stage sums + _unattributed)."""
    return {
        "flops": sum(s["flops"] for s in stages),
        "transcendentals": sum(s["transcendentals"] for s in stages),
        "bytes_accessed": sum(s["bytes_accessed"] for s in stages),
    }


def conservation(
    stages: list[dict[str, Any]],
    program_flops: float | None,
    program_bytes: float | None,
    flops_rtol: float = FLOPS_RTOL,
    bytes_rtol: float = BYTES_RTOL,
) -> dict[str, Any]:
    """Reconcile per-stage sums with whole-program totals. Relative errors
    are None when the program total is unknown — absence, never a fake
    zero."""
    own = totals(stages)

    def rel(mine: float, theirs: float | None) -> float | None:
        if theirs is None:
            return None
        denom = max(abs(theirs), 1.0)
        return abs(mine - theirs) / denom

    flops_err = rel(own["flops"], program_flops)
    bytes_err = rel(own["bytes_accessed"], program_bytes)
    checked = [e <= t for e, t in ((flops_err, flops_rtol),
                                   (bytes_err, bytes_rtol)) if e is not None]
    return {
        "flops_rel_err": flops_err,
        "bytes_rel_err": bytes_err,
        "ok": all(checked) if checked else None,
    }
