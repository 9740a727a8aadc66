"""Named ranges at the port's layer boundaries, for a profiler to show.

    with trace.span("render.coarse"):
        ...

    @trace.spanned("gan.g_step")
    def g_step(...):

Under a torch.profiler session (an operator's Chrome trace or
TensorBoard profile, or the benchmark's traced run) each range is a
`record_function` range named PREFIX + name, on the thread that entered
it; autograd's device thread shows the ranges entered in a backward.
Without a session `span` returns one shared null context: no clock is
read, nothing is recorded or allocated, and no range ever synchronizes
the device or reads a tensor. The ranges live in the profiler's session
and whoever opened it reads them; nothing is kept here.

The ranges: render.{synthesis,coarse,fine,composite} (engine/render.py),
gan.{g_step,d_step,augment,disc,regularizers,backward,optimizer}
(engine/gan.py), invert.{target_features,step,loss,backward,optimizer}
(engine/inversion.py), first_guess.{encoder,pnp} (invert.py),
eval.metrics (engine/evaluate.py), distill.{targets,encoder,optimizer}
(engine/coord_regressor.py) and splat.backward (kernels/splat.py).
"""

from __future__ import annotations

import contextlib
import functools

import torch

# The repository's trace reduction (port_bench/trace.py) reads a range
# whose name starts with this as host time, never as device work, and
# names each idle gap of the device by the innermost such range.
PREFIX = "pb."

_NULL = contextlib.nullcontext()


def span(name: str):
    """A profiler range named PREFIX + `name` while a profiler session is
    on; otherwise a shared null context."""
    if not torch.autograd._profiler_enabled():
        return _NULL
    return torch.profiler.record_function(PREFIX + name)


def spanned(name: str):
    """Decorator: each call of the function runs inside span(name)."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return inner

    return wrap
