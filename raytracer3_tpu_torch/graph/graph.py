"""Declarative frame graph (port of ``raytracer3_tpu/graph/graph.py``):
passes declare the named resources they read and write; the graph derives
the execution order once and returns a step function called per frame.

The shape is the reference render graph's (``src/renderer/render_graph/``):
named transient resources, pass builders with read/write declarations, a
DFS bake from the pass that writes the output (unreachable passes are
culled), and the builder's construction-time assertions (duplicate pass
names, a resource declared twice by one pass, a read that no pass writes,
two writers of one resource). Barriers and layout tracking have no
counterpart: eager PyTorch runs the passes in order on one stream.

Temporal state is a ping-pong resource: a pass reads ``name@prev`` and
writes ``name``; the step returns the new state dict, which the caller
feeds back. Each pass body runs inside ``torch.profiler.record_function(
"pass:<name>")``, so a profile names the passes.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Callable, Dict, List, Sequence

import torch


class GraphError(RuntimeError):
    pass


@dataclasses.dataclass
class _Pass:
    name: str
    fn: Callable[..., Dict[str, Any]]
    reads: tuple[str, ...]
    writes: tuple[str, ...]


@dataclasses.dataclass
class _Resource:
    name: str
    shape: tuple
    dtype: torch.dtype
    temporal: bool  # has a @prev ping-pong slot


class FrameGraph:
    """Build once, compile once, call per frame.

    Example::

        g = FrameGraph()
        g.image("depth", (H, W))
        g.temporal("light", (H, W, 3))            # has light@prev
        g.add_pass("gbuffer", fn, writes=["depth"])
        g.add_pass("shade", fn2, reads=["depth", "light@prev"], writes=["light"])
        step = g.compile(output="light")
        state = g.init_state(device)
        out, state = step(state, camera=cam, frame_index=0)
    """

    def __init__(self):
        self._resources: Dict[str, _Resource] = {}
        self._passes: List[_Pass] = []
        self._pass_names = set()

    def _declare(self, name: str, shape: Sequence[int], dtype, temporal: bool) -> str:
        if name in self._resources:
            raise GraphError(f"duplicate resource {name!r}")
        self._resources[name] = _Resource(name, tuple(shape), dtype, temporal)
        return name

    def image(self, name: str, shape: Sequence[int], dtype=torch.float32) -> str:
        """Declare a transient resource, written anew every frame."""
        return self._declare(name, shape, dtype, temporal=False)

    buffer = image  # buffers and images are both tensors here

    def temporal(self, name: str, shape: Sequence[int], dtype=torch.float32) -> str:
        """Declare a ping-pong resource: passes may read ``name@prev`` and
        write ``name``; the value persists across frames in the state."""
        return self._declare(name, shape, dtype, temporal=True)

    def add_pass(self, name: str, fn: Callable[..., Dict[str, Any]], reads: Sequence[str] = (),
                 writes: Sequence[str] = ()) -> None:
        """``fn(resources_dict, **constants) -> {written_name: tensor}``.

        Raises as the reference builder does: a duplicate pass name, a
        resource listed twice by one pass (read and written in one frame
        takes the @prev slot), an undeclared resource, @prev of a
        non-temporal resource, a pass that writes nothing."""
        if name in self._pass_names:
            raise GraphError(f"duplicate pass name {name!r}")
        self._pass_names.add(name)
        seen = set()
        for r in tuple(reads) + tuple(writes):
            if r in seen:
                raise GraphError(f"pass {name!r} declares resource {r!r} twice")
            seen.add(r)
            base = r.split("@")[0]
            if base not in self._resources:
                raise GraphError(f"pass {name!r} references undeclared resource {r!r}")
            if r.endswith("@prev") and not self._resources[base].temporal:
                raise GraphError(f"pass {name!r} reads {r!r} but {base!r} is not temporal")
        if not writes:
            raise GraphError(f"pass {name!r} writes nothing")
        self._passes.append(_Pass(name, fn, tuple(reads), tuple(writes)))

    def _order(self, output: str) -> List[_Pass]:
        """The passes the output needs, in execution order: a DFS from its
        writer; @prev reads add no edge (they come from the state)."""
        writer_of: Dict[str, _Pass] = {}
        for p in self._passes:
            for w in p.writes:
                if w in writer_of:
                    raise GraphError(f"resource {w!r} written by both {writer_of[w].name!r} and {p.name!r}")
                writer_of[w] = p
        if output not in writer_of:
            raise GraphError(f"no pass writes the requested output {output!r}")

        order: List[_Pass] = []
        visiting: set[str] = set()
        done: set[str] = set()

        def visit(p: _Pass):
            if p.name in done:
                return
            if p.name in visiting:
                raise GraphError(f"cycle through pass {p.name!r}")
            visiting.add(p.name)
            for r in p.reads:
                if r.endswith("@prev"):
                    continue
                w = writer_of.get(r)
                if w is None:
                    raise GraphError(f"pass {p.name!r} reads {r!r} which no pass writes")
                visit(w)
            visiting.discard(p.name)
            done.add(p.name)
            order.append(p)

        visit(writer_of[output])
        return order

    def init_state(self, device) -> Dict[str, torch.Tensor]:
        """The temporal state: every ping-pong resource, zeroed, on
        ``device``."""
        return {r.name: torch.zeros(r.shape, dtype=r.dtype, device=device)
                for r in self._resources.values() if r.temporal}

    def _check_decl(self, pass_name: str, name: str, value) -> None:
        """A written value must match its declaration."""
        r = self._resources[name.split("@")[0]]
        if tuple(value.shape) != r.shape:
            raise GraphError(f"pass {pass_name!r} wrote {name!r} with shape {tuple(value.shape)} but it was "
                             f"declared {r.shape}")
        if value.dtype != r.dtype:
            raise GraphError(f"pass {pass_name!r} wrote {name!r} with dtype {value.dtype} but it was declared "
                             f"{r.dtype}")

    def compile(self, output: str, bindings: Any = None):
        """Bake the execution order and return ``step(state, **constants)
        -> (output_value, new_state)``. ``bindings`` (the scene, a
        backend's tables: the bindless heap's counterpart) is passed to
        every pass whose function has a ``bindings`` parameter. The step
        leaves the caller's state dict as it is."""
        order = self._order(output)
        wants_bindings = {p.name: "bindings" in inspect.signature(p.fn).parameters for p in order}
        temporal = [r.name for r in self._resources.values() if r.temporal]

        def step(state: Dict[str, torch.Tensor], **constants):
            env: Dict[str, Any] = {name + "@prev": state[name] for name in temporal}
            for p in order:
                with torch.profiler.record_function(f"pass:{p.name}"):
                    kw = dict(constants, bindings=bindings) if wants_bindings[p.name] else constants
                    out = p.fn({r: env[r] for r in p.reads}, **kw)
                if set(out) != set(p.writes):
                    raise GraphError(f"pass {p.name!r} returned {sorted(out)} but declared writes "
                                     f"{sorted(p.writes)}")
                for k, v in out.items():
                    self._check_decl(p.name, k, v)
                env.update(out)
            return env[output], {name: env.get(name, state[name]) for name in temporal}

        return step
