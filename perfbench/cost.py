"""The benchmark's frozen arithmetic: the card's published peaks, the
least bytes and operations of the port's kernels, and a model step's
FLOPs.

``wave_cost`` is the fold's cost as ``chip_smoke.py`` reckons it (each
input read once, each output written once; an add per input element, a
multiply more when weighted, a divide per output element), and
``model_flops_train`` the train-step count of
``repro_torch.models.registry.model_flops`` (6 · N · tokens plus the
causal attention term), copied here so that a change to the program
cannot move the yardstick. Nothing here imports the program.
"""
from __future__ import annotations

#: NVIDIA H100 SXM (HBM3) data sheet, dense rates without sparsity, at the
#: full 700 W power limit: HBM bytes/s, f32 and f64 operations/s outside
#: the tensor cores, and the bf16 tensor-core rate.
HBM_BPS = 3.35e12
F32_FLOPS = 67e12
F64_FLOPS = 34e12
BF16_FLOPS = 989e12

#: bytes a parameter of the fused SGD-momentum update moves: p and v read
#: and written (f32), g read (f32)
FUSED_SGD_BYTES_PER_PARAM = 20
#: bytes an element of the qsgd8 codec moves, each way: quantize reads 4
#: and writes 1, dequantize reads 1 and writes 4
CODEC_BYTES_PER_ELEM = 5
CODEC_TILE = 4096


def wave_cost(nodes, elem_bytes: int = 4) -> tuple[int, int, float]:
    """One fold wave: ``nodes`` is a sequence of ``(n_inputs, length,
    weighted)``. Returns the bytes (each input read once, each f32 output
    written once), the operations, and the least time in seconds: the
    larger of bytes over the HBM rate and operations over the f32 rate
    (f64 when weighted: the weighted route accumulates in f64)."""
    nbytes = ops = 0
    weighted = any(w for _, _, w in nodes)
    for n_inputs, length, w in nodes:
        nbytes += (n_inputs * elem_bytes + 4) * length
        ops += (2 if w else 1) * n_inputs * length + length
    t_bytes = nbytes / HBM_BPS
    t_ops = ops / (F64_FLOPS if weighted else F32_FLOPS)
    return nbytes, ops, max(t_bytes, t_ops)


def codec_bound_s(n_elems: int) -> float:
    """Quantize then dequantize ``n_elems`` f32 elements (qsgd8): 5 bytes
    an element each way, and one f32 scale a 4096-element tile written
    and read."""
    tiles = -(-n_elems // CODEC_TILE)
    return 2 * (CODEC_BYTES_PER_ELEM * n_elems + 4 * tiles) / HBM_BPS


def fused_sgd_bound_s(n_params: int) -> float:
    """One SGD-momentum update of ``n_params`` f32 parameters."""
    return FUSED_SGD_BYTES_PER_PARAM * n_params / HBM_BPS


def model_flops_train(n_params: int, n_layers: int, n_heads: int,
                      head_dim: int, batch: int, seq: int) -> float:
    """A dense decoder's train step: 6 · N · tokens, plus 3 × the forward
    attention products (QKᵀ and PV, 4 · S² · H · hd a sequence a layer,
    halved by the causal mask)."""
    attn_fwd = batch * n_layers * 4.0 * seq * seq * n_heads * head_dim * 0.5
    return 6.0 * n_params * batch * seq + 3.0 * attn_fwd
