"""Kernel-level attribution of a training step (counterpart of
``paddle_tpu.profiling.fusion``).

The JAX package parses the compiled executable's optimized HLO into
per-fusion **units** (bytes, analytic FLOPs, the source-level op names
XLA recorded) and names the top-k by a roofline cost estimate. That
text half reads no JAX, so the port keeps its own copy of it
(:func:`parse_hlo_module`, :func:`module_units`,
:func:`attribute_units`, :func:`unit_row`,
:func:`fusion_report_from_text`), its roofline keyed by the card's name
(``_HBM_BW`` and ``core.flops._PEAK_BF16``).

PyTorch runs eagerly and compiles no HLO, so :func:`fusion_report` is the
**step's kernel table**: it runs one training step of the trainer's
program under ``torch.profiler`` (``record_shapes``, ``profile_memory``)
with the report scopes on (``core.profiler.report_scopes``: a range per
layer and per hand-kernel wrapper), then restores the trainer's state. On
the card a warm-up round of the same step opens the trace, and a trace
that lost device events (runtime launches with no device event) is taken
again (``lost_device_events``).

- On the card a unit is one device kernel, grouped by its name, the op
  that launched it (the innermost profiled op, joined by the profiler's
  correlation id: an aten op, or a hand kernel's wrapper range) and that
  op's layer, with its launches and device µs; its ``cost`` is the
  measured device time (``roofline_source`` ``"measured"``).
- On the CPU a unit is one leaf aten op (an op doing work none of whose
  descendants does: views, allocations and no-ops do none), and its
  ``cost`` is the roofline estimate, as in the JAX package, so the
  ranking is deterministic there.
- ``flops`` follow the JAX ``_instr_flops`` rule from the op's input
  shapes: 2·M·N·K for a product, 2·out·(C/g)·kh·kw for a convolution (each
  computed grad of its backward), none for data movement, one per element
  of the largest operand otherwise (an elementwise op's output, a
  reduction's input). ``bytes`` are operand bytes plus result bytes (the
  op's net allocation, or for an in-place op its first operand); a
  ``TensorList`` operand (the ``_foreach`` ops) records no shape, so it
  counts none.
- ``source_ops`` name the layer (``fc_0``, ``gpt/encoder_stack``) and the
  op; a backward op takes the layer of the forward op that made its
  autograd node (their sequence number), marked ``grad``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import re
from collections import Counter
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

# dtype byte widths as HLO spells them (shared convention with
# debugger._DTYPE_BYTES; duplicated literally so neither module imports
# the other at module scope)
_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1, "c64": 8, "c128": 16,
}

_SHAPE_ELEM_RE = re.compile(r"(\w+)\[([0-9,]*)\]")
# params may be tuple-typed — "(param.26: (s32[], f32[8,10]))" — so the
# arg list is matched greedily up to the "->"
_COMP_HEAD_RE = re.compile(
    r"^(ENTRY\s+)?%?([\w.\-]+)\s*\(.*\)\s*->\s*\S.*\{\s*$")
_INSTR_RE = re.compile(
    r"^\s+(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*"
    r"(\((?:[^()]|\([^()]*\))*\)|\w+\[[^\]]*\](?:\{[^}]*\})?)\s*"
    r"([\w\-]+)\(")
_OPERAND_SHAPE_RE = re.compile(r"(\w+\[[0-9,]*\])(?:\{[^}]*\})?\s+%")
_CALLS_RE = re.compile(r"(?:calls|to_apply)=%?([\w.\-]+)")
_BODY_RE = re.compile(
    r"(?:body|condition|true_computation|false_computation)=%?([\w.\-]+)")
_BRANCH_RE = re.compile(r"branch_computations=\{([^}]*)\}")
_OP_NAME_RE = re.compile(r'op_name="([^"]*)"')
_DIMS_RE = {
    "lhs_contracting": re.compile(r"lhs_contracting_dims=\{([0-9,]*)\}"),
    "lhs_batch": re.compile(r"lhs_batch_dims=\{([0-9,]*)\}"),
}
_KIND_RE = re.compile(r"kind=k(\w+)")
_TARGET_RE = re.compile(r'custom_call_target="([^"]*)"')
_DIM_LABELS_RE = re.compile(r"dim_labels=([\w?]+)_([\w?]+)->([\w?]+)")

# ops that move/alias data without arithmetic
_ZERO_FLOP_OPS = frozenset({
    "parameter", "constant", "broadcast", "reshape", "bitcast", "copy",
    "copy-start", "copy-done", "transpose", "tuple", "get-tuple-element",
    "iota", "slice", "dynamic-slice", "dynamic-update-slice", "concatenate",
    "pad", "reverse", "gather", "scatter", "after-all", "partition-id",
    "replica-id", "rng-bit-generator", "optimization-barrier", "domain",
    "send", "send-done", "recv", "recv-done", "infeed", "outfeed",
})

_COLLECTIVE_OPS = frozenset({
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute", "collective-broadcast",
})

# HBM bandwidth table (bytes/s) for the ranking roofline, keyed like
# flops._PEAK_BF16 by a substring of the lowercased device name (first
# match wins). The TPU rows are the JAX package's (public TPU spec
# sheets); the H100 rows are NVIDIA's H100 data sheet (SXM5 "NVIDIA H100
# 80GB HBM3" 3.35 TB/s, PCIe 2.0 TB/s, NVL 3.9 TB/s).
_HBM_BW = [
    ("v6 lite", 1640e9), ("v6e", 1640e9),
    ("v5 lite", 819e9), ("v5e", 819e9),
    ("v5p", 2765e9),
    ("v4", 1228e9),
    ("v3", 900e9),
    ("v2", 700e9),
    ("h100 pcie", 2.0e12), ("h100 nvl", 3.9e12),
    ("h100", 3.35e12),
]
# unknown backends (CPU in CI): fixed constants — the report only needs
# RELATIVE cost for ranking, and fixed values keep it deterministic
_FALLBACK_PEAK = 5e12
_FALLBACK_BW = 100e9


def _shape_bytes(s: str) -> int:
    """Total byte size of every array inside an HLO shape string."""
    total = 0
    for m in _SHAPE_ELEM_RE.finditer(s):
        dt, dims = m.group(1), m.group(2)
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES.get(dt, 4)
    return total


def _shape_elems(s: str) -> int:
    """Element count of the FIRST array in an HLO shape string."""
    m = _SHAPE_ELEM_RE.search(s)
    if not m:
        return 0
    n = 1
    for d in m.group(2).split(","):
        if d:
            n *= int(d)
    return n


def _shape_dims(s: str) -> Tuple[int, ...]:
    m = _SHAPE_ELEM_RE.search(s)
    if not m:
        return ()
    return tuple(int(d) for d in m.group(2).split(",") if d)


def _operand_segment(line: str, op_end: int) -> str:
    """The operand text between the opcode's parens (handles nested
    tuple-typed operands)."""
    depth = 0
    for i in range(op_end - 1, len(line)):
        c = line[i]
        if c == "(":
            depth += 1
        elif c == ")":
            depth -= 1
            if depth == 0:
                return line[op_end:i]
    return line[op_end:]


@dataclasses.dataclass
class Instruction:
    name: str
    opcode: str
    shape: str                    # result shape string
    operand_shapes: List[str]
    attrs: str                    # text after the operand parens
    op_name: str = ""             # metadata op_name (source mapping)

    @property
    def out_bytes(self) -> int:
        return _shape_bytes(self.shape)

    @property
    def operand_bytes(self) -> int:
        return sum(_shape_bytes(s) for s in self.operand_shapes)


@dataclasses.dataclass
class Computation:
    name: str
    is_entry: bool
    instructions: List[Instruction]


@dataclasses.dataclass
class Unit:
    """One attributable cost unit: an instruction of an executed
    computation, with any absorbed (fused / reducer) computations'
    FLOPs folded in."""

    name: str
    op: str                       # opcode ("-start" stripped for async)
    kind: str                     # fusion kind (loop/input/output) or op
    computation: str              # computation the instruction lives in
    in_loop: bool                 # computation is (inside) a while body
    flops: float
    bytes: int                    # operand + result bytes (HBM traffic)
    out_bytes: int
    source_ops: List[str]         # cleaned metadata op_names, ranked
    cost: float = 0.0             # roofline seconds estimate
    cost_frac: float = 0.0

    @property
    def key(self) -> str:
        """Stable identity for cross-run diffing: top source op +
        opcode + result shape (instruction NAMES are not stable across
        compiles; source structure is)."""
        src = self.source_ops[0] if self.source_ops else ""
        return f"{self.op}|{src}|{self.shape_sig}"

    shape_sig: str = ""


def parse_hlo_module(text: str) -> Dict[str, Computation]:
    """Parse optimized-HLO text into ``{name: Computation}``."""
    comps: Dict[str, Computation] = {}
    cur: Optional[Computation] = None
    for line in text.splitlines():
        if cur is None:
            m = _COMP_HEAD_RE.match(line)
            if m:
                cur = Computation(name=m.group(2),
                                  is_entry=m.group(1) is not None,
                                  instructions=[])
            continue
        if line.startswith("}"):
            comps[cur.name] = cur
            cur = None
            continue
        m = _INSTR_RE.match(line)
        if not m:
            continue
        name, shape, opcode = m.group(1), m.group(2), m.group(3)
        seg = _operand_segment(line, m.end())
        operands = [s.group(1) for s in _OPERAND_SHAPE_RE.finditer(seg)]
        attrs = line[m.end() + len(seg):]
        op_name = ""
        nm = _OP_NAME_RE.search(line)
        if nm:
            op_name = nm.group(1)
        cur.instructions.append(Instruction(
            name=name, opcode=opcode, shape=shape,
            operand_shapes=operands, attrs=attrs, op_name=op_name))
    if cur is not None:  # unterminated tail (defensive)
        comps[cur.name] = cur
    return comps


def _instr_flops(ins: Instruction) -> float:
    """Analytic FLOPs of one instruction (undercount-never-overcount,
    the core/flops.py convention): matmul/conv from shapes, one FLOP
    per output element for elementwise/transcendental math, zero for
    data movement."""
    op = ins.opcode
    if op in _ZERO_FLOP_OPS or op in ("fusion", "while", "conditional",
                                     "call", "reduce", "reduce-window",
                                     "sort", "custom-call", "select-and-scatter"):
        # handled by the caller (absorbed computations) or below
        if op == "reduce" or op == "reduce-window":
            return float(sum(_shape_elems(s) for s in ins.operand_shapes))
        if op == "custom-call":
            return _custom_call_flops(ins)
        return 0.0
    out = float(_shape_elems(ins.shape))
    if op == "dot":
        m = _DIMS_RE["lhs_contracting"].search(ins.attrs)
        contract = 1
        if m and ins.operand_shapes:
            lhs = _shape_dims(ins.operand_shapes[0])
            for d in m.group(1).split(","):
                if d and int(d) < len(lhs):
                    contract *= lhs[int(d)]
        return 2.0 * out * contract
    if op == "convolution":
        if len(ins.operand_shapes) >= 2:
            kernel = _shape_dims(ins.operand_shapes[1])
            ktotal = float(np.prod(kernel or (1,)))
            dl = _DIM_LABELS_RE.search(ins.attrs)
            cout = 1.0
            if dl and kernel:
                o_idx = dl.group(2).find("o")
                if 0 <= o_idx < len(kernel):
                    cout = float(kernel[o_idx])
            return 2.0 * out * ktotal / max(cout, 1.0)
        return 2.0 * out
    # elementwise / compare / transcendental / convert / rng ...
    return out


def _custom_call_flops(ins: Instruction) -> float:
    """Backend library calls (oneDNN matmul on CPU, cublas on GPU):
    recover matmul FLOPs heuristically from two rank-2 operands."""
    t = _TARGET_RE.search(ins.attrs)
    target = t.group(1).lower() if t else ""
    if any(k in target for k in ("matmul", "gemm", "dot")):
        shapes = [_shape_dims(s) for s in ins.operand_shapes[:2]]
        if len(shapes) == 2 and all(len(s) >= 2 for s in shapes):
            k = shapes[0][-1]
            return 2.0 * _shape_elems(ins.shape) * k
    return 0.0


def _referenced(ins: Instruction, kind: str) -> List[str]:
    """Computations ``ins`` references, split by execution class:
    ``absorb`` = folded into this instruction's cost (fusion ``calls=``,
    reducer ``to_apply=``); ``control`` = executed in place, their
    instructions are units of their own (while bodies/conditions,
    conditional branches, and ``call`` targets — XLA:CPU unrolls small
    scans into ``call`` computations, whose collectives/fusions must
    not vanish into one opaque call unit)."""
    calls = _CALLS_RE.findall(ins.attrs)
    control = _BODY_RE.findall(ins.attrs)
    b = _BRANCH_RE.search(ins.attrs)
    if b:
        control += [n.strip().lstrip("%") for n in b.group(1).split(",")
                    if n.strip()]
    if ins.opcode == "call":
        control += calls
        calls = []
    return calls if kind == "absorb" else control


def _clean_op_name(op_name: str) -> str:
    """Source mapping: drop jit(...) scope wrappers from the recorded
    op_name path and keep the informative tail (``transpose(jvp(...))``
    components are kept — they distinguish backward from forward).
    Loop-body membership must survive the truncation — the
    ``collective:hlo-unrolled-loop`` lint keys on ``while/body`` in the
    cleaned source — so a dropped ``while`` prefix is re-marked."""
    parts = [p for p in op_name.split("/")
             if p and not re.fullmatch(r"jit\(.*\)", p)]
    if not parts:
        return op_name
    name = "/".join(parts[-3:])
    if "while" in parts[:-3]:
        name = "while/body/" + name
    return name


def _comp_metrics(comps: Dict[str, Computation]):
    """Per-computation absorbed totals: (flops, source-op counter),
    folding in computations referenced via calls=/to_apply=."""
    memo: Dict[str, Tuple[float, Counter]] = {}

    def total(name: str, stack=()) -> Tuple[float, Counter]:
        if name in memo:
            return memo[name]
        if name in stack or name not in comps:
            return 0.0, Counter()
        f, names = 0.0, Counter()
        for ins in comps[name].instructions:
            f += _instr_flops(ins)
            if ins.op_name and ins.opcode not in ("parameter", "constant"):
                names[_clean_op_name(ins.op_name)] += 1
            for sub in _referenced(ins, "absorb"):
                sf, sn = total(sub, stack + (name,))
                f += sf
                names += sn
        memo[name] = (f, names)
        return memo[name]

    return total


def module_units(comps: Dict[str, Computation]) -> List[Unit]:
    """Flatten a parsed module into cost units: instructions of the
    entry computation plus while bodies/conditions and conditional
    branches (tagged ``in_loop`` when under a while), with absorbed
    fusion/reducer computations folded into their calling unit."""
    absorbed = set()
    control: Dict[str, bool] = {}    # name -> in_loop
    for comp in comps.values():
        for ins in comp.instructions:
            for sub in _referenced(ins, "absorb"):
                absorbed.add(sub)
    entry = [c for c in comps.values() if c.is_entry]
    # walk the control-flow tree from entry so nested whiles inherit
    # loop membership; anything absorbed never becomes a unit source
    stack = [(c.name, False) for c in entry]
    seen = set()
    while stack:
        name, in_loop = stack.pop()
        if name in seen or name not in comps or name in absorbed:
            # absorbed computations' FLOPs are folded into their
            # calling unit — visiting one via a control edge too would
            # double-count it
            continue
        seen.add(name)
        control[name] = in_loop
        for ins in comps[name].instructions:
            is_while = ins.opcode == "while"
            for sub in _referenced(ins, "control"):
                stack.append((sub, in_loop or is_while))
    total = _comp_metrics(comps)
    units: List[Unit] = []
    for name, in_loop in control.items():
        for ins in comps[name].instructions:
            if ins.opcode in ("parameter", "constant", "tuple",
                              "get-tuple-element", "bitcast", "after-all"):
                continue
            if ins.opcode in ("while", "conditional", "call"):
                # container: its body's instructions are their own units
                continue
            flops = _instr_flops(ins)
            names: Counter = Counter()
            if ins.op_name:
                names[_clean_op_name(ins.op_name)] += 1
            for sub in _referenced(ins, "absorb"):
                sf, sn = total(sub)
                flops += sf
                names += sn
            km = _KIND_RE.search(ins.attrs)
            op = ins.opcode
            if op.endswith("-start"):
                op = op[:-len("-start")]
            elif op.endswith("-done"):
                continue  # async second half: counted at -start
            units.append(Unit(
                name=ins.name, op=op,
                kind=(km.group(1).lower() if km else op),
                computation=name, in_loop=in_loop,
                flops=flops,
                bytes=ins.operand_bytes + ins.out_bytes,
                out_bytes=ins.out_bytes,
                source_ops=[n for n, _ in names.most_common(4)],
                shape_sig=re.sub(r"\{[^}]*\}", "", ins.shape),
            ))
    return units


def _device_roofline(device=None) -> Tuple[float, float, str]:
    """(peak FLOP/s, HBM bytes/s, source) for the ranking roofline.
    Table-driven and fixed-fallback so reports are deterministic: the
    card's name (``torch.cuda.get_device_name``) keys the tables; the CPU
    (and a card they lack) takes the fixed constants."""
    import torch

    device = torch.device(("cuda" if torch.cuda.is_available() else "cpu")
                          if device is None else device)
    kind = (torch.cuda.get_device_name(device).lower()
            if device.type == "cuda" and torch.cuda.is_available() else "")
    from ..core.flops import _PEAK_BF16
    peak = next((p for sub, p in _PEAK_BF16 if sub in kind), _FALLBACK_PEAK)
    bw = next((b for sub, b in _HBM_BW if sub in kind), _FALLBACK_BW)
    src = "table" if kind and any(s in kind for s, _ in _HBM_BW) else "fallback"
    return peak, bw, src


def attribute_units(units: List[Unit], peak_flops: float,
                    mem_bw: float) -> List[Unit]:
    """Assign each unit its roofline cost estimate and cost fraction;
    returns units sorted most-expensive first (ties broken by the
    stable key so the ordering is deterministic)."""
    for u in units:
        u.cost = max(u.flops / peak_flops, u.bytes / mem_bw)
    total = sum(u.cost for u in units) or 1.0
    for u in units:
        u.cost_frac = u.cost / total
    return sorted(units, key=lambda u: (-u.cost, u.key))


def _xla_cost_totals(compiled) -> Dict[str, Optional[float]]:
    """Aggregate XLA cost_analysis totals of a compiled object (None when
    it hides them); handles the list-of-dicts and plain-dict API shapes."""
    try:
        ca = compiled.cost_analysis()
    except Exception:
        return {"xla_flops": None, "xla_bytes_accessed": None}
    if isinstance(ca, (list, tuple)):
        ca = ca[0] if ca else {}
    if not isinstance(ca, dict):
        return {"xla_flops": None, "xla_bytes_accessed": None}
    return {"xla_flops": ca.get("flops"),
            "xla_bytes_accessed": ca.get("bytes accessed")}


def unit_row(u: Unit) -> Dict[str, Any]:
    """JSON-ready rendering of one unit (the bench ``top_fusions``
    row schema; tools/profile_diff.py matches rows by ``key``)."""
    return {
        "key": u.key,
        "name": u.name,
        "op": u.op,
        "kind": u.kind,
        "computation": u.computation,
        "in_loop": u.in_loop,
        "flops": float(u.flops),
        "bytes": int(u.bytes),
        "out_bytes": int(u.out_bytes),
        "source_ops": list(u.source_ops),
        "cost_frac": round(float(u.cost_frac), 6),
    }


def fusion_report_from_text(text: str, top_k: int = 8, device=None,
                            compiled=None) -> Dict[str, Any]:
    """The fusion report over already-dumped optimized HLO text."""
    comps = parse_hlo_module(text)
    units = module_units(comps)
    peak, bw, src = _device_roofline(device)
    units = attribute_units(units, peak, bw)
    top = units[:max(1, int(top_k))]
    out = {
        "n_units": len(units),
        "n_in_loop": sum(1 for u in units if u.in_loop),
        "total_flops": float(sum(u.flops for u in units)),
        "total_bytes": int(sum(u.bytes for u in units)),
        "peak_flops": peak,
        "mem_bw": bw,
        "roofline_source": src,
        "top_fusions": [unit_row(u) for u in top],
        "coverage_top_k": round(sum(u.cost_frac for u in top), 6),
    }
    if compiled is not None:
        out.update(_xla_cost_totals(compiled))
    else:
        out.update({"xla_flops": None, "xla_bytes_accessed": None})
    return out



# -- the step's kernel table ----------------------------------------------------

_LAYER = "layer:"
_GRAD_NODE = "autograd::engine::evaluate_function: "
_REGIONS = ("trainer.forward", "trainer.backward", "trainer.update")
# profiled runs of a step whose trace lost device events, at most
_TRACE_ATTEMPTS = 3
# the hand kernels' wrapper ranges (core.profiler.kernel_range)
_KERNEL_RANGES = frozenset({"flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"})

# aten ops that do no work of their own: views, metadata, allocation, no-ops
_NO_WORK = frozenset("aten::" + n for n in (
    "view", "_unsafe_view", "reshape", "_reshape_alias", "as_strided", "as_strided_",
    "t", "transpose", "permute", "expand", "expand_as", "unsqueeze", "squeeze",
    "select", "slice", "narrow", "alias", "detach", "detach_", "lift_fresh",
    "resolve_conj", "resolve_neg", "empty", "empty_like", "empty_strided", "resize_",
    "to", "contiguous", "split", "split_with_sizes", "chunk", "unbind", "view_as",
    "unflatten", "flatten", "numpy_T", "result_type", "set_", "_has_compatible_shallow_copy_type",
    "requires_grad_", "is_nonzero", "item", "movedim", "diagonal", "unfold"))
# work a reduction or a creation op runs inside itself (its output's
# initial value): a unit of its own that does not make its caller composite
_INIT_WORK = frozenset({"aten::fill_", "aten::zero_"})
_PRODUCTS = frozenset("aten::" + n for n in (
    "mm", "addmm", "bmm", "baddbmm", "matmul", "mv", "addmv", "dot", "vdot",
    "linear", "_int_mm", "_addmm_activation"))
_CONVS = ("convolution", "conv")
# data movement: no arithmetic (fusion.py's _ZERO_FLOP_OPS in aten's terms)
_MOVES = frozenset("aten::" + n for n in (
    "copy_", "_copy_from", "_copy_from_and_resize", "clone", "cat", "stack", "index",
    "index_select", "gather", "scatter", "scatter_", "index_put_", "_index_put_impl_",
    "embedding", "embedding_dense_backward", "fill_", "zero_", "zeros", "zeros_like",
    "ones", "ones_like", "full", "full_like", "arange", "scalar_tensor", "masked_select",
    "nonzero", "flip", "roll", "repeat", "constant_pad_nd", "take_along_dim", "sort",
    "argsort", "topk", "_local_scalar_dense", "slice_backward", "select_backward",
    "index_copy_", "index_fill_", "masked_scatter_", "tril", "triu", "_to_copy", "randperm",
    "random_", "uniform_", "normal_", "bernoulli_"))

# torch.profiler's operand dtype names → (bytes, HLO-style name)
_PROF_DTYPES = {
    "float": (4, "f32"), "double": (8, "f64"), "c10::Half": (2, "f16"),
    "c10::BFloat16": (2, "bf16"), "long int": (8, "s64"), "int": (4, "s32"),
    "short int": (2, "s16"), "signed char": (1, "s8"), "unsigned char": (1, "u8"),
    "bool": (1, "pred"), "c10::complex<float>": (8, "c64"),
    "c10::complex<double>": (16, "c128"), "c10::Float8_e4m3fn": (1, "f8e4m3fn"),
    "c10::Float8_e5m2": (1, "f8e5m2"),
}


@dataclasses.dataclass
class KernelUnit(Unit):
    """A unit of the step's kernel table: on the card its ``launches``
    and measured ``device_us``; on the CPU one op (launches 1, device_us
    0)."""

    device_us: float = 0.0
    launches: int = 0


def kernel_row(u: KernelUnit) -> Dict[str, Any]:
    """:func:`unit_row` plus the unit's ``device_us`` and ``launches``."""
    return {**unit_row(u), "device_us": round(float(u.device_us), 3),
            "launches": int(u.launches)}


class _Op:
    """One CPU op (or range) of a profiled step, from its kineto event: its
    name, correlation id, thread and time span, recorded operand shapes,
    dtypes and concrete inputs, autograd sequence number, parent and
    children (by nesting on its thread), the bytes allocated inside it
    (``alloc``, children included, frees subtracted) and the device
    kernels it launched (``kernels``: (name, µs))."""

    __slots__ = ("name", "id", "thread", "start", "end", "input_shapes", "dtypes",
                 "concrete_inputs", "sequence_nr", "cpu_parent", "cpu_children",
                 "alloc", "kernels")

    def __init__(self, k):
        self.name = k.name()
        self.id = k.correlation_id()
        self.thread = k.start_thread_id()
        self.start, self.end = k.start_ns(), k.end_ns()
        self.input_shapes = k.shapes()
        self.dtypes = k.dtypes()
        self.concrete_inputs = k.concrete_inputs() if hasattr(k, "concrete_inputs") else []
        self.sequence_nr = k.sequence_nr()
        self.cpu_parent = None
        self.cpu_children: List["_Op"] = []
        self.alloc = 0
        self.kernels: List[Tuple[str, float]] = []


def _nest(items) -> None:
    """Parent each op of one thread's ``items`` (ops and memory records,
    as (start, -end, kind, obj)) to the innermost op enclosing it, and add
    each memory record's bytes to the op it lands in."""
    stack: List[_Op] = []
    for start, neg_end, kind, obj in sorted(items, key=lambda t: (t[0], t[1], t[2])):
        while stack and stack[-1].end <= start and not (kind == 1 and stack[-1].end == start):
            stack.pop()
        if kind == 0:
            if stack:
                obj.cpu_parent = stack[-1]
                stack[-1].cpu_children.append(obj)
            stack.append(obj)
        elif stack:
            stack[-1].alloc += obj


def _profiled_ops(prof):
    """(CPU ops, device events as (name, µs), device events lost) of a
    profiled step, from the profiler's raw kineto events (no
    ``prof.events()``, whose parse of a whole step's ops and memory records
    takes seconds): each device event joined to the op that launched it by
    its linked correlation id, every allocation to the innermost op around
    it on its thread. A device event is a device operation when a call of
    the CUDA runtime or driver carries its correlation id (the copies of
    the ranges on the device's timeline carry none). A trace now and then
    loses device events (24 of a GPT-base step's 2,960 kernels in one
    report of 24); a launch, copy or memset call whose correlation id no
    device event carries counts one lost."""
    import torch

    cpu = torch.autograd.DeviceType.CPU
    ops: Dict[int, _Op] = {}
    by_thread: Dict[int, list] = {}
    device = []
    calls, launches = set(), set()
    for k in prof.profiler.kineto_results.events():
        name = k.name()
        if name == "[memory]":
            by_thread.setdefault(k.start_thread_id(), []).append(
                (k.start_ns(), 0, 1, k.nbytes()))
        elif k.device_type() == cpu:
            if k.linked_correlation_id() > 0:  # a CUDA runtime call's own event
                calls.add(k.correlation_id())
                if any(w in name for w in ("Launch", "Memcpy", "Memset")):
                    launches.add(k.correlation_id())
                continue
            op = ops[k.correlation_id()] = _Op(k)
            by_thread.setdefault(op.thread, []).append((op.start, -op.end, 0, op))
        else:
            device.append((name, (k.end_ns() - k.start_ns()) / 1e3, k.correlation_id(),
                           k.linked_correlation_id()))
    for items in by_thread.values():
        _nest(items)
    for op in sorted(ops.values(), key=lambda o: -o.start):  # children before parents
        if op.cpu_parent is not None:
            op.cpu_parent.alloc += op.alloc
    real = []
    for name, us, corr, linked in device:
        if corr not in calls:
            continue
        real.append((name, us))
        op = ops.get(linked)
        if op is not None:
            op.kernels.append((name, us))
    lost = len(launches - {corr for _, _, corr, _ in device})
    return sorted(ops.values(), key=lambda o: (o.thread, o.start)), real, lost


def _operands(evt) -> List[Tuple[Tuple[int, ...], int, str]]:
    """(shape, bytes per element, dtype name) of each tensor operand the
    profiler recorded for ``evt``."""
    shapes = list(evt.input_shapes or [])
    dtypes = list(evt.dtypes or [])
    out = []
    for i, shape in enumerate(shapes):
        dt = dtypes[i] if i < len(dtypes) else ""
        if dt not in _PROF_DTYPES or not isinstance(shape, (list, tuple)):
            continue
        if shape and not all(isinstance(d, int) for d in shape):
            continue
        size, name = _PROF_DTYPES[dt]
        out.append((tuple(shape), size, name))
    return out


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _op_cost(evt) -> Tuple[float, int, int, str]:
    """(flops, bytes, result bytes, operand signature) of one profiled op
    (the module docstring's rules)."""
    name = evt.name
    ops = _operands(evt)
    operand_b = sum(_numel(s) * size for s, size, _ in ops)
    result_b = (_numel(ops[0][0]) * ops[0][1] if ops else 0) if name.endswith("_") \
        else max(evt.alloc, 0)
    sig = ",".join(f"{dt}[{','.join(map(str, s))}]" for s, _, dt in ops)
    short = name.split("::")[-1]
    shapes = [s for s, _, _ in ops]
    flops = 0.0
    if name in _PRODUCTS and len(shapes) >= 2:
        a, b = (shapes[1], shapes[2]) if short in ("addmm", "baddbmm", "addmv") and \
            len(shapes) >= 3 else (shapes[0], shapes[1])
        if short == "linear":  # input [..., K] · weight [N, K]
            flops = 2.0 * _numel(a[:-1]) * b[0] * a[-1] if a and b else 0.0
        elif short in ("dot", "vdot", "mv", "addmv"):
            flops = 2.0 * _numel(a)
        elif len(a) >= 2 and len(b) >= 2:
            flops = 2.0 * _numel(a[:-1]) * b[-1] * a[-1]
    elif any(c in short for c in _CONVS) and len(shapes) >= 2:
        if short == "convolution_backward" and len(shapes) >= 3:
            go, w = shapes[0], shapes[2]
            mask = (list(evt.concrete_inputs or []) or [None])[-1]
            grads = sum(bool(m) for m in mask[:2]) if isinstance(mask, (list, tuple)) else 2
            flops = 2.0 * _numel(go) * _numel(w[1:]) * grads
        else:
            out_elems = result_b // ops[0][1] if ops else 0
            flops = 2.0 * out_elems * _numel(shapes[1][1:])
    elif name not in _MOVES:
        flops = float(max((_numel(s) for s in shapes), default=0))
    return flops, operand_b + result_b, result_b, sig


def _ancestry(evt):
    """(layer, region, grad node) of an op: its innermost ``layer:`` range
    (itself included), its ``trainer.*`` range and the autograd node it
    runs in (None for each it lacks)."""
    layer = region = node = None
    e = evt
    while e is not None:
        n = e.name
        if layer is None and n.startswith(_LAYER):
            layer = n[len(_LAYER):]
        elif node is None and n.startswith(_GRAD_NODE):
            node = e
        elif region is None and n in _REGIONS:
            region = n
        e = e.cpu_parent
    return layer, region, node


class _Sources:
    """The layer and region of every op of a profiled step, a backward op
    taking the layer of the forward op that made its autograd node."""

    def __init__(self, cpu_events):
        self.of = {}
        by_seq: Dict[int, str] = {}
        for e in cpu_events:
            layer, region, node = _ancestry(e)
            self.of[id(e)] = (layer, region, node)
            seq = e.sequence_nr
            if node is None and layer is not None and seq is not None and seq >= 0:
                by_seq.setdefault(seq, layer)
        self.by_seq = by_seq

    def source(self, evt) -> Tuple[str, str]:
        """(source op name, computation) of ``evt``."""
        layer, region, node = self.of[id(evt)]
        op = evt.name.split("::")[-1]
        if node is not None:
            fwd = self.by_seq.get(node.sequence_nr)
            src = f"{fwd}/grad/{op}" if fwd else f"grad/{op}"
            return src, "trainer.backward"
        return (f"{layer}/{op}" if layer else op), (region or "step")


def _is_work(evt) -> bool:
    return evt.name.startswith("aten::") and evt.name not in _NO_WORK


def _leaf_ops(cpu_events) -> List[Any]:
    """The CPU units: working aten ops none of whose descendants works
    (an output's initial fill inside a reduction aside)."""
    out = []
    for e in cpu_events:
        if not _is_work(e):
            continue
        stack, composite = list(e.cpu_children), False
        while stack and not composite:
            c = stack.pop()
            if _is_work(c) and c.name not in _INIT_WORK:
                composite = True
            stack.extend(c.cpu_children)
        if not composite:
            out.append(e)
    return out


def _kind(op: str) -> str:
    if op in _PRODUCTS:
        return "matmul"
    if op in _KERNEL_RANGES:
        return "hand_kernel"
    short = op.split("::")[-1]
    if any(c in short for c in _CONVS):
        return "conv"
    return "move" if op in _MOVES else "elementwise"


def _cpu_units(cpu_events, sources) -> List[KernelUnit]:
    units = []
    for e in _leaf_ops(cpu_events):
        flops, nbytes, out_b, sig = _op_cost(e)
        src, comp = sources.source(e)
        units.append(KernelUnit(
            name=e.name.split("::")[-1], op=e.name, kind=_kind(e.name), computation=comp,
            in_loop=False, flops=flops, bytes=nbytes, out_bytes=out_b, source_ops=[src],
            shape_sig=sig, launches=1))
    return units


def _card_units(cpu_events, device_events, sources) -> Tuple[List[KernelUnit], float, int]:
    """(units, the step's device µs, its device operations): each kernel a
    profiled op launched, grouped by (kernel, op, source); the op's FLOPs
    and bytes go to its first kernel. The device total sums every device
    event (``device_events``: (name, µs)), the device copies of the ranges
    aside."""
    total_us = sum(us for _, us in device_events)
    groups: Dict[Tuple[str, str, str], KernelUnit] = {}
    for e in cpu_events:
        kernels = e.kernels
        if not kernels:
            continue
        flops, nbytes, out_b, sig = _op_cost(e)
        src, comp = sources.source(e)
        for i, (kname, us) in enumerate(kernels):
            key = (kname, e.name, src)
            u = groups.get(key)
            if u is None:
                u = groups[key] = KernelUnit(
                    name=kname, op=e.name, kind=_kind(e.name), computation=comp,
                    in_loop=False, flops=0.0, bytes=0, out_bytes=0, source_ops=[src],
                    shape_sig=sig)
            u.launches += 1
            u.device_us += us
            if i == 0:
                u.flops += flops
                u.bytes += nbytes
                u.out_bytes += out_b
    return list(groups.values()), total_us, len(device_events)


def _clone_tree(tree):
    import torch

    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    return tree.detach().clone() if isinstance(tree, torch.Tensor) else tree


def _prune_to(dst, like) -> None:
    """Drop the keys ``dst`` gained over ``like`` (trees of dicts)."""
    for k in list(dst):
        if k not in like:
            del dst[k]
        elif isinstance(dst[k], dict) and isinstance(like[k], dict):
            _prune_to(dst[k], like[k])


@contextlib.contextmanager
def isolated_step(trainer, feed):
    """Yield ``step()``, which runs one training step of ``trainer`` on
    ``feed`` (its ``_step_body``: the same seed, wire decode, forward,
    backward and update as :meth:`Trainer.step` at this global step), and
    put the trainer back as it was at exit (and at ``step.restore()``):
    params, optimizer, program and loss-scale state restored in place (a
    captured step keeps its addresses), the params' grads, the process
    generators, and nothing recorded in the step timer, the pipeline
    metrics, the journal or the guard; ``global_step`` does not move."""
    import torch

    from ..core.errors import enforce
    from ..data.feeder import PipelineMetrics
    from ..executor import write_in_place
    from ..framework import RngStream

    enforce(trainer.scope.opt_state is not None, "call startup() before a step report")
    metrics, trainer.pipeline_metrics = trainer.pipeline_metrics, PipelineMetrics()
    try:
        dfeed = trainer._put_feed(feed)
    finally:
        trainer.pipeline_metrics = metrics
    state = trainer._state_trees()
    snap = _clone_tree(state)
    grads = {k: (None if p.grad is None else p.grad.detach().clone())
             for k, p in trainer.scope.params.items()}
    dev = trainer.device
    gens = (torch.get_rng_state(),
            torch.cuda.get_rng_state(dev) if dev.type == "cuda" else None)
    base = trainer.global_step

    def step():
        stream = RngStream(dev).reset(trainer._step_seed(None, base))
        return trainer._step_body(dfeed, stream)

    def restore():
        _prune_to(state, snap)
        write_in_place(state, snap)
        for k, p in trainer.scope.params.items():
            # a copy of its own, which the next step frees as a real step does
            p.grad = None if grads[k] is None else grads[k].clone()
        torch.set_rng_state(gens[0])
        if gens[1] is not None:
            torch.cuda.set_rng_state(gens[1], dev)

    step.restore = restore
    try:
        yield step
    finally:
        restore()


def measured_step(trainer, feed, profile: bool = False):
    """(the profiler or None, the step's temp bytes or None) of one
    isolated step (:func:`isolated_step`): on the card the peak allocated
    during the step less the allocation before it; with ``profile`` the
    step runs under ``torch.profiler`` with the report scopes on, on the
    card after a warm-up round of the same step, run and put back while
    the trace keeps nothing (late in a long process a trace lost the first
    ~60 device events of the step it opened with, every time)."""
    import torch
    from torch.profiler import ProfilerActivity, schedule
    from torch.profiler import profile as _profile

    from ..core.profiler import report_scopes

    dev = trainer.device
    card = dev.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card else [])
    warm = profile and card
    prof = (_profile(activities=acts, record_shapes=True, profile_memory=True,
                     schedule=schedule(wait=0, warmup=1, active=1) if warm else None)
            if profile else None)
    with isolated_step(trainer, feed) as step:
        if card:
            # garbage freed mid-step would count against the step's own
            # allocations: collect what earlier work left in reference cycles
            gc.collect()
        with report_scopes() if profile else contextlib.nullcontext(), \
                prof if profile else contextlib.nullcontext():
            if warm:
                step()
                step.restore()
                torch.cuda.synchronize(dev)
                prof.step()
            if card:
                torch.cuda.synchronize(dev)
                torch.cuda.reset_peak_memory_stats(dev)
                before = torch.cuda.memory_allocated(dev)
            step()
            if card:
                torch.cuda.synchronize(dev)
        temp = (torch.cuda.max_memory_allocated(dev) - before) if card else None
    return prof, temp


def _step_table(trainer, feed):
    """(units, the step's temp bytes or None, the card's totals) of one
    profiled isolated step."""
    from ..core.errors import EnforceError

    for _ in range(_TRACE_ATTEMPTS):  # a trace that lost device events runs again
        prof, temp = measured_step(trainer, feed, profile=True)
        cpu_events, device_events, lost = _profiled_ops(prof)
        if not lost:
            break
    sources = _Sources(cpu_events)
    if trainer.device.type != "cuda":
        return _cpu_units(cpu_events, sources), temp, {}
    units, total_us, n_ops = _card_units(cpu_events, device_events, sources)
    if not n_ops or not units:
        raise EnforceError(
            f"fusion_report: the profiler saw no device kernel of the step on "
            f"{trainer.device} (torch.profiler's CUDA activity recorded nothing)")
    return units, temp, {"device_us": round(total_us, 3), "device_ops": n_ops,
                         "units_device_us": round(sum(u.device_us for u in units), 3),
                         "lost_device_events": lost}


def fusion_report(trainer, feed, top_k: int = 8) -> Dict[str, Any]:
    """The step's kernel table: one training step of ``trainer`` on
    ``feed`` under ``torch.profiler`` (the trainer left as it was,
    :func:`isolated_step`), its units (the module docstring) ranked by
    cost, the top ``top_k`` as ``top_fusions`` rows (:func:`kernel_row`)
    with the JAX report's keys; ``xla_flops`` and ``xla_bytes_accessed``
    are None. On the card ``device_us`` and ``device_ops`` are the step's
    device time and operations, ``units_device_us`` what its units hold,
    ``lost_device_events`` what the trace lost (the step is profiled again,
    up to three times, while it loses any), and ``temp_mb`` the step's
    peak allocation over what was allocated before it (None on the CPU). A
    CUDA trainer whose profile shows no device kernel raises."""
    units, temp, extra = _step_table(trainer, feed)
    peak, bw, src = _device_roofline(trainer.device)
    if extra:  # the card: the measured device time is the cost
        for u in units:
            u.cost = u.device_us * 1e-6
        total = sum(u.cost for u in units) or 1.0
        for u in units:
            u.cost_frac = u.cost / total
        units.sort(key=lambda u: (-u.cost, u.key))
        src = "measured"
    else:
        units = attribute_units(units, peak, bw)
    top = units[:max(1, int(top_k))]
    return {
        "n_units": len(units),
        "n_in_loop": sum(1 for u in units if u.in_loop),
        "total_flops": float(sum(u.flops for u in units)),
        "total_bytes": int(sum(u.bytes for u in units)),
        "peak_flops": peak,
        "mem_bw": bw,
        "roofline_source": src,
        "top_fusions": [kernel_row(u) for u in top],
        "coverage_top_k": round(sum(u.cost_frac for u in top), 6),
        "xla_flops": None,
        "xla_bytes_accessed": None,
        "temp_mb": None if temp is None else temp / 1e6,
        **extra,
    }


__all__ = [
    "Unit", "KernelUnit", "parse_hlo_module", "module_units", "attribute_units",
    "unit_row", "kernel_row", "fusion_report_from_text", "fusion_report",
    "isolated_step", "measured_step",
]
