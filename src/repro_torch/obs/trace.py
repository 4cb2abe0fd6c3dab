"""Trace spans for the consensus round (port of ``repro/obs/trace.py``).

Both span kinds are ``torch.profiler.record_function`` ranges: they show in
a ``torch.profiler`` trace (``--profile-rounds``) as named ranges on the
host thread, with the device work launched inside them correlated to them.

  * ``span(name)`` — a phase of the round (the reference's
    ``jax.named_scope`` inside the jitted step);
  * ``host_span(name)`` — a whole round in the executor or launcher loop
    (the reference's ``jax.profiler.TraceAnnotation``).

Span names (a hierarchy on ``/``):

    consensus/pack            flat-buffer pack + wire encode
    consensus/exchange/off<k> one graph offset's roll
    consensus/probe           objective probes f_i(theta_j)
    consensus/fused_round     the fused round kernel
    consensus/penalty         penalty + topology update
    wire/encode  wire/decode  codec work inside the phases above
    round/sync  round/async   host-side whole-round annotations

Spans are built through ``span_factory(enabled)``, so that with
observability off the round runs ``nullcontext`` and records nothing.
"""
from __future__ import annotations

import contextlib

import torch


def span(name: str):
    """A named profiler range around a phase of the round."""
    return torch.profiler.record_function(name)


# the reference's two span kinds are one kind of range here
host_span = span


def _null_span(name: str):
    return contextlib.nullcontext()


def span_factory(enabled: bool):
    """The phase-span factory: ``span`` when on, nullcontext off."""
    return span if enabled else _null_span


def host_span_factory(enabled: bool):
    return host_span if enabled else _null_span
