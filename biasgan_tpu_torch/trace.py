"""The port's own profiler spans: named stretches of the host's work at
each layer boundary (the served field's phases, the training step's, the
generators' stages, the reflect / wrap pads, each kernel launch), recorded
on ``torch.profiler``'s clock, the clock its device activity is aligned
to, so an idle gap on the card can be put down to the span the host was
in.

Every name starts with ``port.``. The spans are off unless a caller turns
them on for a stretch (``enabled()``): off, ``span`` returns one shared
null context and calls nothing in torch, so the served and training paths
pay a function call a span.
"""

from __future__ import annotations

import contextlib

import torch

_on = False
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager over a stretch named ``name`` (which starts with
    ``port.``): ``torch.autograd.profiler.record_function(name)`` while
    the spans are on, else the shared null context."""
    if not _on:
        return _OFF
    return torch.autograd.profiler.record_function(name)


@contextlib.contextmanager
def enabled():
    """The spans on for the body; as they were afterwards."""
    global _on
    before, _on = _on, True
    try:
        yield
    finally:
        _on = before
