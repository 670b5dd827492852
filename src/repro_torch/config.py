"""Federated-learning and serverless platform configuration.

The aggregation stack's share of the reference package's configuration:
the FL round settings and the AWS Lambda platform constants the cost
model and the simulated runtime price every round with. No model, mesh
or hardware configuration lives here yet.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class FLConfig:
    n_clients: int = 20
    n_shards: int = 4                    # M
    rounds: int = 3
    local_epochs: int = 1
    lr: float = 0.01
    momentum: float = 0.9
    batch_size: int = 32
    topology: str = "gradssharding"      # "gradssharding" | "lambda_fl" | "lifl"
    partition: str = "uniform"           # gradient partition strategy
    dirichlet_alpha: float = 0.0         # 0 = IID
    seed: int = 0


@dataclass(frozen=True)
class LambdaLimits:
    """AWS Lambda platform constants used by the paper."""

    max_memory_mb: int = 10_240
    max_timeout_s: int = 900
    payload_limit_mb: float = 6.0
    runtime_overhead_mb: float = 450.0   # Python 3.12 + AWSSDKPandas layer
    mem_multiplier: float = 3.0          # empirical 3x input_size formula
    gb_s_price: float = 0.0000166667     # $/GB-s
    s3_put_price: float = 0.005 / 1000   # $/PUT
    s3_get_price: float = 0.0004 / 1000  # $/GET
    s3_read_mbps: float = 52.0           # 45-68 MB/s measured, midpoint
    s3_write_mbps: float = 75.0
    s3_get_latency_s: float = 0.04       # per-GET first-byte latency floor
    cold_start_s: float = 3.0            # 2-4 s measured
    min_memory_mb: int = 128


# Shared default instance: LambdaLimits is frozen, so every hot-path consumer
# (per-invocation cost properties, runtime construction) reuses this one
# object instead of re-running the dataclass constructor per call.
DEFAULT_LIMITS = LambdaLimits()

# Effective aggregation arithmetic throughput on a Lambda vCPU, calibrated to
# the paper's RQ2-B: 1.96 s to accumulate 20 x 512.3 MB => ~5.2 GB/s. Lives
# here (not in core.cost_model) so the serverless runtime can import it
# without initializing the repro_torch.core package (import-cycle hygiene);
# cost_model re-exports it.
AGG_COMPUTE_BPS = 5.2e9
