"""The one home of every ``REPRO_AGG_*`` environment knob.

Every runtime knob the aggregation stack accepts can be pinned by an
explicit argument or deferred to the environment; this module owns the
environment side so the precedence contract is stated (and tested) once:

    explicit argument  >  ``REPRO_AGG_*`` env var  >  built-in default

Resolvers (``core.agg_engine.get_backend``, ``core.topology.get_schedule``
/ ``get_readahead``, ``core.wire_codec.get_codec``,
``core.fold_pool.get_workers``) call the ``env_*`` functions below instead
of reading ``os.environ`` ad hoc, and :meth:`repro_torch.api.SessionConfig
.from_env` snapshots all of them into one fully-pinned config.  The knobs
keep the reference package's names and precedence:

===================== ======================================= ============
env var               values                                  default
===================== ======================================= ============
``REPRO_AGG_ENGINE``    streaming | batched | incremental       batched
``REPRO_AGG_SCHEDULE``  barrier | pipelined | quorum            barrier
``REPRO_AGG_READAHEAD`` int >= 1 (pipelined prefetch window)    1
``REPRO_AGG_CODEC``     identity                                identity
``REPRO_AGG_FAULTS``    off | on | rate in [0, 1]               off
``REPRO_AGG_WORKERS``   int >= 1 (fold-pool threads) | auto     real cores
===================== ======================================= ============

Validation stays with each knob's resolver — this module only answers
"what does the environment say"; a bad value raises at resolve time with
the resolver's usual error message.

There is no kernel switch: a fold over CUDA tensors always runs the
hand-written kernel, and a fold over CPU tensors its plain version.
"""
from __future__ import annotations

import os

ENV_ENGINE = "REPRO_AGG_ENGINE"
ENV_SCHEDULE = "REPRO_AGG_SCHEDULE"
ENV_READAHEAD = "REPRO_AGG_READAHEAD"
ENV_CODEC = "REPRO_AGG_CODEC"
ENV_FAULTS = "REPRO_AGG_FAULTS"
ENV_WORKERS = "REPRO_AGG_WORKERS"

ALL_KNOBS = (ENV_ENGINE, ENV_SCHEDULE, ENV_READAHEAD, ENV_CODEC,
             ENV_FAULTS, ENV_WORKERS)


def env_raw(name: str, default: str = "") -> str:
    """Read an arbitrary env var through the single env home.

    For callers whose variable *name* is itself a parameter (e.g.
    ``fault_model_from_env(env=...)``) — everything with a fixed name
    should use its dedicated ``env_*`` reader so the knob table above
    stays the complete inventory.
    """
    return os.environ.get(name, default)


def env_engine(default: str) -> str:
    return os.environ.get(ENV_ENGINE, default)


def env_schedule(default: str) -> str:
    return os.environ.get(ENV_SCHEDULE, default)


def env_readahead(default: int):
    return os.environ.get(ENV_READAHEAD, default)


def env_codec(default: str) -> str:
    return os.environ.get(ENV_CODEC, default)


def env_faults(default: str = "") -> str:
    return os.environ.get(ENV_FAULTS, default)


def env_workers(default=None):
    return os.environ.get(ENV_WORKERS, default)
