"""Standalone Python source emission from the program IR (paper §5).

A copy of ``repro/exec/emit.py``: a source emitted here equals the
reference's for the same program but for the module named in its header.

The paper's reference compiler emits one self-contained multithreaded
program per location; here that emission is driven by the per-location
op arrays and control skeleton of :class:`~repro_torch.exec.program.ExecProgram`
instead of the recursive trace trees.  The generated module contract is
unchanged from the historical :func:`repro_torch.core.compile.emit_python_source`
(which is now a deprecation shim over this module): a ``run(channels,
steps, initial_data)`` function where ``channels[(src, dst, port)]`` are
queue-likes with ``put``/``get`` and ``steps[name](inputs) -> outputs``.
"""

from __future__ import annotations

from .program import (
    K_ACT,
    K_PAR,
    K_SEQ,
    ControlSpec,
    ExecOp,
    ExecProgram,
    LocationProgram,
    RecvOp,
    SendOp,
)

__all__ = ["emit_location_source", "emit_program_sources"]

_PROGRAM_TEMPLATE = '''\
"""Auto-generated SWIRL bundle for location {location!r}.

Generated by repro_torch.exec.emit from the per-location program IR — a
self-contained, decentralised executor for this location's ops.  Channels
are injected by the harness as `channels[(src, dst, port)]` queue-like
objects with ``put(payload)`` / ``get()``; step commands as
`steps[name](inputs) -> outputs`.
"""


def run(channels, steps, initial_data):
    data = dict(initial_data)

{body}
    return data
'''


def _emit_op(lp: LocationProgram, idx: int, pad: str) -> str:
    op = lp.ops[idx]
    if isinstance(op, ExecOp):
        ins = list(op.inputs)
        outs = list(op.outputs)
        return (
            f"{pad}_out = steps[{op.step!r}]({{k: data[k] for k in {ins!r}}})\n"
            f"{pad}data.update({{k: _out[k] for k in {outs!r}}})\n"
        )
    if isinstance(op, SendOp):
        return (
            f"{pad}channels[({op.src!r}, {op.dst!r}, {op.port!r})]"
            f".put(({op.data!r}, data[{op.data!r}]))\n"
        )
    if isinstance(op, RecvOp):
        return (
            f"{pad}_k, _v = channels[({op.src!r}, {op.dst!r}, {op.port!r})].get()\n"
            f"{pad}data[_k] = _v\n"
        )
    raise TypeError(f"not a program op: {op!r}")


def _emit_node(
    lp: LocationProgram, spec: ControlSpec, nid: int, indent: int, uid: list[int]
) -> str:
    pad = "    " * indent
    kind = spec.kind[nid]
    if kind == K_ACT:
        return _emit_op(lp, spec.instr[nid], pad)
    if kind == K_SEQ:
        return "".join(
            _emit_node(lp, spec, child, indent, uid)
            for child in spec.children[nid]
        )
    assert kind == K_PAR
    # Parallel branches become threads — the generated program is
    # multithreaded exactly like the reference implementation's output.
    uid[0] += 1
    gid = uid[0]
    lines = [f"{pad}import threading as _th_{gid}\n"]
    names = []
    for bi, child in enumerate(spec.children[nid]):
        fname = f"_branch_{gid}_{bi}"
        names.append(fname)
        lines.append(f"{pad}def {fname}():\n")
        lines.append(_emit_node(lp, spec, child, indent + 1, uid))
    lines.append(
        f"{pad}_ts_{gid} = [_th_{gid}.Thread(target=f) for f in [{', '.join(names)}]]\n"
    )
    lines.append(f"{pad}[t.start() for t in _ts_{gid}]\n")
    lines.append(f"{pad}[t.join() for t in _ts_{gid}]\n")
    return "".join(lines)


def emit_location_source(lp: LocationProgram) -> str:
    """Emit a standalone Python program for one location's op array."""
    spec = lp.control()
    if spec.root is None:
        body = "    pass\n"
    else:
        body = _emit_node(lp, spec, spec.root, indent=1, uid=[0])
    return _PROGRAM_TEMPLATE.format(location=lp.location, body=body)


def emit_program_sources(program: ExecProgram) -> dict[str, str]:
    """Per-location sources for a whole lowered program."""
    return {
        lp.location: emit_location_source(lp) for lp in program.programs
    }
