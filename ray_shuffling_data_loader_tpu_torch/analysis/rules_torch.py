"""Torch/CUDA hot-path hygiene rules (the port's counterpart of the JAX
package's ``rules_jax``).

The loader's throughput rests on keeping the host out of the device
path. A function compiled by ``torch.compile`` or ``torch.jit.script``,
or a region captured by ``torch.cuda.graph``, must not read a device
value on the host: ``float(t)``, ``.item()``, ``.tolist()``, ``.cpu()``,
``.numpy()`` or ``np.asarray(t)`` there breaks the graph (a graph break
or a failed capture) or waits for the device at every call. The
prefetch producer's loops must not wait for the device either: an
``.item()``, ``.cpu()`` or ``.synchronize()`` inside them serializes the
copy against compute and shows up as trainer stall. And in the SPMD
layers (``Config.sharded_path_globs``) a placement must name its device:
``.cuda()``, ``.to("cuda")`` and ``torch.device("cuda")`` without an
index land on the current device, whichever rank set it, as an
unsharded ``device_put`` lands on device 0.
"""

from __future__ import annotations

import ast
import fnmatch
from typing import Dict, Iterator, List, Optional, Set

from ray_shuffling_data_loader_tpu_torch.analysis.core import (
    FileContext, Rule, Violation, dotted_name, get_keyword, register)

#: Builtin conversions that read a device value on the host.
_SYNC_BUILTINS = {"float", "int", "bool"}
#: Dotted names that copy a tensor to a host array.
_SYNC_FUNCTIONS = {"np.asarray", "numpy.asarray"}
#: Tensor methods that read the value on the host.
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
#: Device waits worth flagging inside prefetch/ingest hot loops (host
#: numpy work is normal there, so the builtin/np.* set does not apply).
_LOOP_SYNC_METHODS = {"item", "tolist", "cpu", "synchronize"}


def _is_compiler(node: ast.expr) -> bool:
    """``torch.compile`` / ``torch.jit.script`` (bare or called with
    options, as a decorator factory) / ``partial(torch.compile, ...)``."""
    if isinstance(node, ast.Call):
        name = dotted_name(node.func)
        if name.rsplit(".", 1)[-1] == "partial" and node.args:
            return _is_compiler(node.args[0])
        return _is_compiler(node.func)
    name = dotted_name(node)
    return name in ("torch.compile", "torch.jit.script", "jit.script")


def _is_graph_capture(node: ast.expr) -> bool:
    """``torch.cuda.graph(g)`` / ``cuda.graph(g)`` in a ``with``."""
    return isinstance(node, ast.Call) and dotted_name(node.func) in (
        "torch.cuda.graph", "cuda.graph")


class _CompiledIndex:
    """Which function bodies and ``with`` blocks of a module run as a
    compiled or captured graph."""

    def __init__(self, tree: ast.Module):
        self.defs: Dict[str, List[ast.AST]] = {}
        self.compiled_names: Set[str] = set()
        self.compiled_lambdas: List[ast.Lambda] = []
        self.decorated: List[ast.AST] = []
        self.captures: List[ast.AST] = []
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.defs.setdefault(node.name, []).append(node)
                if any(_is_compiler(d) for d in node.decorator_list):
                    self.decorated.append(node)
            elif isinstance(node, (ast.With, ast.AsyncWith)):
                if any(_is_graph_capture(item.context_expr)
                       for item in node.items):
                    self.captures.append(node)
            elif (isinstance(node, ast.Call) and node.args
                  and _is_compiler(node.func)):
                target = node.args[0]
                if isinstance(target, ast.Name):
                    self.compiled_names.add(target.id)
                elif isinstance(target, ast.Lambda):
                    self.compiled_lambdas.append(target)

    def bodies(self) -> Iterator[ast.AST]:
        seen: Set[int] = set()
        for node in self.decorated:
            seen.add(id(node))
            yield node
        for name in sorted(self.compiled_names):
            for node in self.defs.get(name, []):
                if id(node) not in seen:
                    seen.add(id(node))
                    yield node
        yield from self.compiled_lambdas
        yield from self.captures


def _sync_reason(call: ast.Call) -> Optional[str]:
    if isinstance(call.func, ast.Name) and call.func.id in _SYNC_BUILTINS:
        return f"`{call.func.id}()` reads the value on the host"
    name = dotted_name(call.func)
    if name in _SYNC_FUNCTIONS:
        return f"`{name}` copies the tensor to the host"
    if isinstance(call.func, ast.Attribute) \
            and call.func.attr in _SYNC_METHODS:
        return f"`.{call.func.attr}()` reads the value on the host"
    return None


@register
class TorchHostSyncRule(Rule):
    id = "torch-host-sync"
    category = "torch-hygiene"
    description = ("host read (float()/np.asarray/.item()/.cpu()/"
                   ".numpy()) in a torch.compile'd, torch.jit.script'ed or "
                   "CUDA-graph-captured region, or a device wait (.item()/"
                   ".cpu()/.synchronize()) in a prefetch hot loop")

    def check(self, tree: ast.Module,
              ctx: FileContext) -> Iterator[Violation]:
        seen: Set[int] = set()
        for body in _CompiledIndex(tree).bodies():
            yield from self._check_compiled(body, ctx, seen)
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and any(fnmatch.fnmatch(node.name, pat)
                            for pat in ctx.config.hot_loop_functions):
                yield from self._check_hot_loops(node, ctx)

    def _check_compiled(self, region: ast.AST, ctx: FileContext,
                        seen: Set[int]) -> Iterator[Violation]:
        for node in ast.walk(region):
            if not isinstance(node, ast.Call) or id(node) in seen:
                continue
            reason = _sync_reason(node)
            if reason is not None:
                seen.add(id(node))
                yield ctx.violation(
                    self, node,
                    f"{reason} inside a compiled or captured region; it "
                    "breaks the graph or waits for the device on every "
                    "call; keep host reads outside it")

    def _check_hot_loops(self, fn: ast.AST,
                         ctx: FileContext) -> Iterator[Violation]:
        loops = [n for n in ast.walk(fn)
                 if isinstance(n, (ast.For, ast.While, ast.AsyncFor))]
        seen: Set[int] = set()
        for loop in loops:
            for node in ast.walk(loop):
                if not isinstance(node, ast.Call) or id(node) in seen:
                    continue
                if isinstance(node.func, ast.Attribute) \
                        and node.func.attr in _LOOP_SYNC_METHODS:
                    seen.add(id(node))
                    yield ctx.violation(
                        self, node,
                        f"`{dotted_name(node.func)}` inside the "
                        f"`{fn.name}` hot loop waits for the device; "
                        "prefetch loops must stay asynchronous (wait on "
                        "an event from the consumer's stream instead)")


def _is_bare_cuda(node: Optional[ast.expr]) -> bool:
    return isinstance(node, ast.Constant) and node.value == "cuda"


@register
class CudaDeviceImplicitRule(Rule):
    id = "cuda-device-implicit"
    category = "torch-hygiene"
    description = ("`.cuda()`, `.to(\"cuda\")` or `torch.device(\"cuda\")` "
                   "without a device index in SPMD (parallel/) code paths")

    def check(self, tree: ast.Module,
              ctx: FileContext) -> Iterator[Violation]:
        if not ctx.path_matches(ctx.config.sharded_path_globs):
            return
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            name = dotted_name(node.func)
            what = None
            if isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "cuda":
                if not node.args and get_keyword(node, "device") is None:
                    what = "`.cuda()` without a device index"
            elif isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "to":
                target = (node.args[0] if node.args
                          else get_keyword(node, "device"))
                if _is_bare_cuda(target):
                    what = "`.to(\"cuda\")`"
            elif name == "torch.device":
                if (len(node.args) == 1 and _is_bare_cuda(node.args[0])
                        and get_keyword(node, "index") is None):
                    what = "`torch.device(\"cuda\")` without an index"
            if what is not None:
                yield ctx.violation(
                    self, node,
                    f"{what} in an SPMD path lands on the current device, "
                    "whichever rank set it; name the rank's device "
                    "(`cuda:{local_rank}` or the mesh's device)")
