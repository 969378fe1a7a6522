"""Layer spans: ``record_function`` spans named after the layer that
opens them, read by ``train.profiling``'s trace reader (the device time
by layer).

They cost nothing unless :func:`layer_spans` turns them on: then every
forward of a model's modules up to ``depth`` names below it, and each
:func:`layer_span` of the models' graph building, opens a span
``layer:<name>``.
"""

from __future__ import annotations

import collections
import contextlib

import torch

LAYER_PREFIX = "layer:"
_LAYER_SPANS = False


def layer_span(name: str):
    """A ``record_function`` span ``layer:<name>`` while :func:`layer_spans`
    is on; otherwise a context that does nothing."""
    if not _LAYER_SPANS:
        return contextlib.nullcontext()
    return torch.profiler.record_function(LAYER_PREFIX + name)


@contextlib.contextmanager
def layer_spans(model: torch.nn.Module | None = None, depth: int = 3):
    """Turn the layer spans on while open; with ``model``, also span every
    forward of its modules up to ``depth`` names below it (``conv1``,
    ``conv1._1``, ``backbone.conv1._1``)."""
    global _LAYER_SPANS
    handles, stacks = [], collections.defaultdict(list)

    def enter(name):
        def hook(module, args):
            span = torch.profiler.record_function(LAYER_PREFIX + name)
            span.__enter__()
            stacks[name].append(span)
        return hook

    def leave(name):
        def hook(module, args, out):
            stacks[name].pop().__exit__(None, None, None)
        return hook

    if model is not None:
        for name, module in model.named_modules():
            if name and name.count(".") < depth:
                handles.append(module.register_forward_pre_hook(enter(name)))
                handles.append(module.register_forward_hook(leave(name)))
    previous, _LAYER_SPANS = _LAYER_SPANS, True
    try:
        yield
    finally:
        _LAYER_SPANS = previous
        for h in handles:
            h.remove()
