"""Federated-learning, serverless platform and model configuration.

The reference package's configuration as far as the port runs it: the FL
round settings and the AWS Lambda platform constants the cost model and
the simulated runtime price every round with, the model configuration
(``ModelConfig``, ``ArchSpec``, ``smoke_of``), the input-shape cells
of the language models (``ShapeConfig``, ``LM_SHAPES``,
``shape_applicable``), the device mesh and the trainer's sharding plan
(``MeshConfig``, ``ShardingPlan``) and the card's published peaks
(``GPUSpec``, ``H100_SXM``), which take the place of the reference's TPU
model.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Mapping

import torch


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


# ---------------------------------------------------------------------------
# Model configuration (the dense LM stack of the federated trainer)
# ---------------------------------------------------------------------------

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm", "audio", "cnn")


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 16
    top_k: int = 2
    capacity_factor: float = 1.25
    # Router jitter / aux losses are off for dry-run determinism.
    router_aux_weight: float = 0.0


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-style SSM block config (v1 selective scan or v2/SSD)."""

    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    version: int = 1            # 1 = Mamba-1 selective scan, 2 = Mamba-2 / SSD
    head_dim: int = 64          # Mamba-2 only
    chunk: int = 256            # SSD chunk length for prefill/train


@dataclass(frozen=True)
class ModelConfig:
    """The reference's model configuration, field for field; the numeric
    types are torch dtypes (parameters f32, compute bf16 by default)."""

    name: str
    family: str                          # one of FAMILIES
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                    # 0 -> d_model // n_heads
    # --- attention flavour flags -------------------------------------------
    qk_norm: bool = False                # qwen3
    qkv_bias: bool = False               # qwen2.5
    sliding_window: int = 0              # 0 = full attention; >0 = SWA width
    rope_theta: float = 10_000.0
    gated_mlp: bool = True               # SwiGLU (llama family); False = GELU
    # --- mixture of experts ------------------------------------------------
    moe: MoEConfig | None = None
    # --- state-space -------------------------------------------------------
    ssm: SSMConfig | None = None
    attn_every: int = 0                  # hybrid: shared attn block every k layers
    # --- encoder-decoder ---------------------------------------------------
    encoder_layers: int = 0              # >0 -> enc-dec (whisper-style)
    encoder_seq: int = 1500              # stub frontend frame count (whisper 30s)
    frontend_dim: int = 0                # stub modality frontend embed dim (0 = vocab)
    # --- numerics ----------------------------------------------------------
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    # --- structural --------------------------------------------------------
    scan_layers: bool = True             # reference: lax.scan over stacked layers
    unroll_scans: bool = False           # reference: unrolled inner chunk scans
    decode_grouped_attn: bool = False    # GQA decode without KV expansion
    attn_causal_skip: bool = False       # 2-D chunked attn, skip masked blocks
    moe_dispatch: str = "global"         # "global" | "local" (shard_map)
    remat: bool = True                   # activation checkpointing per layer
    attn_chunk: int = 2048               # online-softmax KV chunk (0 = dense)
    subquadratic: bool = False           # eligible for long_500k
    notes: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(1, self.n_heads))

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.resolved_head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.resolved_head_dim

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def param_count(self) -> int:
        """Exact parameter count, from the parameter shapes."""
        from repro_torch.models import registry  # lazy, avoids a cycle
        return registry.param_count(self)

    def grad_bytes(self, dtype_bytes: int = 4) -> int:
        return self.param_count() * dtype_bytes


# ---------------------------------------------------------------------------
# Input shapes
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # "train" | "prefill" | "decode"

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


LM_SHAPES: tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", seq_len=4_096, global_batch=256, kind="train"),
    ShapeConfig("prefill_32k", seq_len=32_768, global_batch=32, kind="prefill"),
    ShapeConfig("decode_32k", seq_len=32_768, global_batch=128, kind="decode"),
    ShapeConfig("long_500k", seq_len=524_288, global_batch=1, kind="decode"),
)

SHAPES_BY_NAME: Mapping[str, ShapeConfig] = {s.name: s for s in LM_SHAPES}


def shape_applicable(model: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Is this (arch, shape) cell runnable? Returns (ok, reason_if_not)."""
    if shape.name == "long_500k" and not model.subquadratic:
        return False, "skip: full quadratic attention at 512k context (see DESIGN.md)"
    return True, ""


# ---------------------------------------------------------------------------
# Mesh / parallelism
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MeshConfig:
    shape: tuple[int, ...] = (16, 16)
    axes: tuple[str, ...] = ("data", "model")

    @property
    def n_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def replica_axes(self) -> tuple[str, ...]:
        """Axes that replicate the model = data-parallel/gradient-shard axes."""
        return tuple(a for a in self.axes if a != "model")

    @property
    def data_parallel_size(self) -> int:
        n = 1
        for s, a in zip(self.shape, self.axes):
            if a != "model":
                n *= s
        return n

    @property
    def model_parallel_size(self) -> int:
        for s, a in zip(self.shape, self.axes):
            if a == "model":
                return s
        return 1


SINGLE_POD_MESH = MeshConfig((16, 16), ("data", "model"))
MULTI_POD_MESH = MeshConfig((2, 16, 16), ("pod", "data", "model"))


@dataclass(frozen=True)
class ShardingPlan:
    """How the trainer distributes parameters/grads/optimizer state.

    ``grad_sharding`` is the paper's technique as device collectives:
      - "none"  : full-gradient aggregation (lambda-FL / LIFL analogue) —
                  all-reduce, optimizer state replicated on every replica.
      - "zero1" : GradsSharding analogue — reduce-scatter gradients over the
                  replica axes; each device owns |theta|/M of the optimizer.
      - "zero3" : parameters also stored sharded (FSDP) — all-gather on use.
    """

    grad_sharding: str = "zero1"
    partition: str = "balanced"          # "uniform" | "balanced" (layer-aware)
    compress: str = "none"               # "none" | "qsgd8" | "topk"
    hierarchical: bool = True            # pod-local reduce then cross-pod
    overlap: bool = True                 # bucketed RS inside scan
    remat_policy: str = "dots"           # "none" | "dots" | "full"


# ---------------------------------------------------------------------------
# GPU hardware model for rooflines
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class GPUSpec:
    """Published peaks of one card, for bounds: every value is a data-sheet
    constant at the card's full power limit, not a measurement."""

    name: str = "H100 SXM"
    hbm_bw: float = 3.35e12              # bytes/s, data sheet (HBM3)
    peak_flops_f32: float = 67e12        # /s outside the tensor cores, data sheet
    peak_flops_f64: float = 34e12        # /s outside the tensor cores, data sheet
    peak_flops_bf16: float = 989e12      # /s dense tensor cores, data sheet
    hbm_bytes: int = 80 * 10**9          # data sheet
    # bytes/s, NVLink 4 between the cards of one 8-card host, 18 links,
    # total of both directions, data sheet; a collective sends at half
    nvlink_bw: float = 900e9


H100_SXM = GPUSpec()


@dataclass(frozen=True)
class ArchSpec:
    """A registered architecture and its input-shape cells."""

    arch_id: str
    model: ModelConfig
    smoke: ModelConfig                   # reduced same-family config for CPU tests
    shapes: tuple[ShapeConfig, ...] = LM_SHAPES
    source: str = ""

    def cells(self) -> list[tuple[ShapeConfig, bool, str]]:
        out = []
        for s in self.shapes:
            ok, why = shape_applicable(self.model, s)
            out.append((s, ok, why))
        return out


def smoke_of(m: ModelConfig, **over) -> ModelConfig:
    """Derive a tiny same-family config: small dims, few layers/experts."""
    kw: dict[str, Any] = dict(
        name=m.name + "-smoke",
        n_layers=min(m.n_layers, 2),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(m.n_kv_heads, 2) if m.n_kv_heads < m.n_heads else 4,
        d_ff=128,
        vocab=256,
        head_dim=16,
        scan_layers=m.scan_layers,
        remat=False,
        attn_chunk=0,
    )
    if m.moe is not None:
        kw["moe"] = replace(m.moe, n_experts=4, top_k=min(m.moe.top_k, 2))
    if m.ssm is not None:
        kw["ssm"] = replace(m.ssm, d_state=min(m.ssm.d_state, 8), chunk=16,
                            head_dim=16)
    if m.encoder_layers:
        kw["encoder_layers"] = 2
        kw["encoder_seq"] = 16
    if m.attn_every:
        kw["attn_every"] = 2
    kw.update(over)
    return replace(m, **kw)
