"""Host spans at the port's layer boundaries, for the torch profiler.

``span(name)`` is a context manager. While a torch profiler runs (the
check the profiler itself makes, ``torch.autograd._profiler_enabled()``)
it is ``torch.profiler.record_function(name)``: the span lands in the
profiler's trace, on the same clock as the device kernels, nested in
whatever span the caller is in. Otherwise it is one shared no-op, so a
span costs a flag read when nobody traces. There is no switch: spans
record exactly when the profiler runs, and the profiler's trace is the
only store.

The spans, by layer (each covers the named work; nesting follows the
calls):

- aggregation round (``core/topology.run_round``): ``agg.plan``
  (membership, cuts, every program build), ``agg.upload``,
  ``agg.invoke`` (the simulated Lambda phases), ``agg.fold``
  (``backend.end_round``), ``agg.readback``, ``codec.error``; and in
  ``api.FederatedSession``, ``agg.plan`` (the gradients' conversion to
  the session's device, before ``run_round``) and ``agg.compact``
  (``_finish_round``).
- wire codec: ``codec.encode`` (one program build's encodes, in
  ``sharded_client_uploads`` and ``full_grad_uploads``) and
  ``codec.decode`` (one wave's decodes before a fold launch).
- fold kernel: ``fold.launch`` (one wave's ``fedavg_stream.fold_nodes``).
- model step (``core/fedavg``): ``step.forward``, ``step.backward``,
  ``step.optimizer``, ``client.delta``, ``apply.delta``; and
  ``flat.flatten`` and ``flat.unflatten`` (``core/sharding``).
"""
from __future__ import annotations

import contextlib

import torch

#: the span while no profiler runs
NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """``record_function(name)`` while a torch profiler runs, else the
    shared no-op."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return NO_SPAN
