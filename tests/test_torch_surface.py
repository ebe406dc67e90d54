"""The port's public surface against the JAX package's.

One case per module of ``radioframe/``: every public top-level function and
class, every public method (and ``__init__``) of a public class, and every
parameter of those must exist under the same name in the same module of
``radioframe_torch/``, or be listed in ``TPU_ONLY`` with the reason the
port has no counterpart of that name. An entry covers what is nested under
it (a class its methods, a function its parameters). An entry that names
something the JAX package no longer has, or something the port now has,
fails too, so the list cannot go stale.

Both packages are read with ``ast``; neither is imported.

    python -m pytest tests/test_torch_surface.py -q
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
JAX_PKG, PORT_PKG = ROOT / "radioframe", ROOT / "radioframe_torch"
MODULES = sorted(p.relative_to(JAX_PKG).as_posix() for p in JAX_PKG.rglob("*.py"))

_INTERPRET = ("Pallas interpret mode", "the wrapper runs its plain version on CPU tensors")
_TILE = ("a body, table or gate of a Pallas tile", "computed inside the CUDA kernels")
_NATIVE = ("the kernels' native (k1, k2) channel order, not carried over",
           "the port's kernels read and write channel order")
_MXU = ("a DFT built for the TPU's matrix unit (the bf16x3 split is not carried over)",
        "torch.fft, and rf::fft in kernels/csrc/channelizer.cuh")
_AXIS_NAMES = ("the axis names of a user-built JAX mesh",
               "the port's Mesh names its axes \"channel\" and \"time\" (shard/mesh.py)")
_WALK_ATTACK = ("attack constants baked into the Pallas kernel",
                "per-channel attack constants: the ``al`` argument of the walk")

# "module:name" -> (why the port has no counterpart of that name, the
# port's counterpart or None)
TPU_ONLY = {
    "kernels/channelizer_one.py:FusedChannelizerOne.__init__(attack_alphas)": _WALK_ATTACK,
    "kernels/channelizer_one.py:FusedChannelizerOne.__init__(interpret)": _INTERPRET,
    "kernels/demod_agc.py:FusedDemodAgc.__init__(attack_alphas)": _WALK_ATTACK,
    "kernels/demod_agc.py:FusedDemodAgc.__init__(interpret)": _INTERPRET,
    "kernels/demod_agc.py:agc_prefix_consts": _TILE,
    "kernels/demod_agc.py:atan_coeffs": _TILE,
    "kernels/demod_agc.py:demod_agc_tile": _TILE,
    "kernels/demod_agc.py:demod_pre_tables": _TILE,
    "kernels/fused_frontend.py:FusedFrontend.__init__(interpret)": _INTERPRET,
    "kernels/fused_frontend2.py:FusedFrontend2.__init__(interpret)": _INTERPRET,
    "kernels/fused_frontend2.py:FusedFrontend2.y1_history": (
        "stage 2's history computed outside the Pallas kernel",
        "K1 runs stage 1 over the history inside the kernel"),
    "kernels/halo_dma.py:causal_halo_dma(axis)": (
        "a shard_map axis name", "the ``dma`` argument, a HaloDma endpoint on a mesh axis"),
    "kernels/halo_dma.py:causal_halo_dma(interpret)": _INTERPRET,
    "kernels/halo_dma.py:ring_halo_dma(axis_name)": (
        "a shard_map axis name", "the ``dma`` argument, a HaloDma endpoint on a mesh axis"),
    "kernels/halo_dma.py:ring_halo_dma(interpret)": _INTERPRET,
    "kernels/ols_demod.py:FusedOlsDemod.__init__(interpret)": _INTERPRET,
    "kernels/pfb_dft.py:FusedPfbDft.__init__(interpret)": _INTERPRET,
    "kernels/pfb_dft.py:FusedPfbDft.call_planes(native)": _NATIVE,
    "kernels/pfb_dft.py:batched_dft_consts": _TILE,
    "kernels/pfb_dft.py:dft_tile": _TILE,
    "kernels/pfb_dft.py:fused_channels_ok": (
        "the Pallas gate: a power of two, and whole 128-lane tiles under Mosaic",
        "a power of two (cli.py; kernels/fft_plan.py raises otherwise)"),
    "ops/agc.py:AgcBank.apply": (
        "the port's AgcBank is an nn.Module, whose apply keeps torch's meaning",
        "AgcBank.forward"),
    "ops/ols.py:CtDft": _MXU,
    "ops/ols.py:OverlapSaveBank.__init__(mxu_dft)": _MXU,
    "pipelines/channelizer.py:channel_order": _NATIVE,
    "pipelines/channelizer.py:fused_backend_apply(kernel)": (
        "the port passes one launch closure, not the kernel and its planes",
        "fused_backend_apply(call)"),
    "pipelines/channelizer.py:fused_backend_apply(yi)": (
        "the port passes one launch closure, not the kernel and its planes",
        "fused_backend_apply(call)"),
    "pipelines/channelizer.py:fused_backend_apply(yr)": (
        "the port passes one launch closure, not the kernel and its planes",
        "fused_backend_apply(call)"),
    "pipelines/channelizer.py:native_order": _NATIVE,
    "shard/duplex.py:ShardedDuplex.__init__(channel_axis)": _AXIS_NAMES,
    "shard/duplex.py:ShardedDuplex.__init__(time_axis)": _AXIS_NAMES,
    "shard/mesh.py:make_mesh(devices)": ("a JAX device list", "make_mesh(device=)"),
    "shard/mesh.py:place_state": ("device_put onto shard_map's shardings", "shard_state"),
    "shard/rx.py:ShardedRxChain.__init__(channel_axis)": _AXIS_NAMES,
    "shard/rx.py:ShardedRxChain.__init__(time_axis)": _AXIS_NAMES,
    "shard/tx.py:ShardedTxChain.__init__(channel_axis)": _AXIS_NAMES,
    "shard/tx.py:ShardedTxChain.__init__(time_axis)": _AXIS_NAMES,
}


def _params(fn) -> list[str]:
    a = fn.args
    names = [p.arg for p in (*a.posonlyargs, *a.args, *a.kwonlyargs)]
    names += [p.arg for p in (a.vararg, a.kwarg) if p is not None]
    return [n for n in names if n not in ("self", "cls")]


def surface(source: str) -> set[str]:
    """The public names of a module's source: "f", "f(p)", "C", "C.m",
    "C.m(p)" ("C.__init__" counts as public)."""
    out = set()

    def add(head, fn):
        out.add(head)
        out.update(f"{head}({p})" for p in _params(fn))

    defs = (ast.FunctionDef, ast.AsyncFunctionDef)
    for node in ast.parse(source).body:
        if not isinstance(node, (*defs, ast.ClassDef)) or node.name.startswith("_"):
            continue
        if isinstance(node, defs):
            add(node.name, node)
        else:
            out.add(node.name)
            for m in node.body:
                if isinstance(m, defs) and (not m.name.startswith("_") or m.name == "__init__"):
                    add(f"{node.name}.{m.name}", m)
    return out


def _ancestors(name: str) -> list[str]:
    """"C.m(p)" -> ["C.m", "C"]; "f(p)" -> ["f"]."""
    head = name.split("(")[0]
    parts = head.split(".")
    out = [head] if head != name else []
    return out + [".".join(parts[:i]) for i in range(len(parts) - 1, 0, -1)]


def problems(module: str, jax_source: str, port_source: str, tpu_only: dict) -> list[str]:
    """What breaks the rule for one module: a JAX name with no counterpart
    and no entry (reported at its outermost missing name), and an entry
    that names nothing in the JAX package or something the port has."""
    jax_names, port_names = surface(jax_source), surface(port_source)
    listed = {k.split(":", 1)[1] for k in tpu_only if k.split(":", 1)[0] == module}
    missing = jax_names - port_names
    out = [f"{module}:{n} has no counterpart in the port and no TPU_ONLY entry"
           for n in sorted(missing)
           if n not in listed and not any(a in missing for a in _ancestors(n))]
    for n in sorted(listed):
        if n not in jax_names:
            out.append(f"TPU_ONLY {module}:{n} names nothing in the JAX package")
        elif n in port_names:
            out.append(f"TPU_ONLY {module}:{n} names something the port has")
    return out


@pytest.mark.parametrize("module", MODULES)
def test_port_has_the_public_surface(module):
    port = PORT_PKG / module
    assert port.is_file(), f"radioframe_torch/{module} is missing"
    found = problems(module, (JAX_PKG / module).read_text(), port.read_text(), TPU_ONLY)
    assert not found, "\n".join(found)


def test_every_entry_names_a_module_and_a_reason():
    for key, (reason, counterpart) in TPU_ONLY.items():
        assert key.split(":", 1)[0] in MODULES, key
        assert reason and (counterpart is None or counterpart), key


JAX_SRC = '''
def f(a, b): pass
def _private(a): pass
class C:
    def __init__(self, x): pass
    def m(self, y, *, z): pass
    def _hidden(self): pass
class D:
    def n(self): pass
'''
PORT_SRC = '''
def f(a): pass
class C:
    def __init__(self, x): pass
    def m(self, y): pass
'''


def test_guard_reports_missing_names_at_their_outermost():
    assert problems("m.py", JAX_SRC, PORT_SRC, {}) == [
        "m.py:C.m(z) has no counterpart in the port and no TPU_ONLY entry",
        "m.py:D has no counterpart in the port and no TPU_ONLY entry",
        "m.py:f(b) has no counterpart in the port and no TPU_ONLY entry"]


def test_guard_accepts_entries_and_what_they_cover():
    listed = {"m.py:C.m(z)": ("r", None), "m.py:D": ("r", None), "m.py:f(b)": ("r", None),
              "other.py:D": ("r", None)}
    assert problems("m.py", JAX_SRC, PORT_SRC, listed) == []


def test_guard_reports_stale_entries():
    listed = {"m.py:C.m(z)": ("r", None), "m.py:D": ("r", None), "m.py:f(b)": ("r", None),
              "m.py:C.m(y)": ("the port has it", None), "m.py:g": ("gone", None)}
    assert problems("m.py", JAX_SRC, PORT_SRC, listed) == [
        "TPU_ONLY m.py:C.m(y) names something the port has",
        "TPU_ONLY m.py:g names nothing in the JAX package"]
