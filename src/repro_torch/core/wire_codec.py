"""Pluggable on-the-wire representation of a client contribution.

A :class:`WireCodec` declares

  * ``encode(shard) -> WirePayload`` — what a client PUTs,
  * ``decode(payload) -> torch.Tensor`` — what an aggregator folds
    (decode-before-fold; the batched engine uses :meth:`decode_range`
    so the decode fuses into its chunked fold),
  * ``wire_bytes(nbytes)`` — the *modeled* on-the-wire size of a raw
    f32 object of ``nbytes`` (a pure function, shared verbatim by the
    simulator's upload schedule and the analytical cost model — which is
    what keeps event-sim / cost-model parity to float epsilon), and
  * ``decode_cost_s(nbytes)`` — modeled per-contribution decode CPU time.

Codecs register through :func:`register_codec`, mirroring the topology
registry; resolution follows the same knob discipline as engines and
schedules (``SessionConfig.codec`` / ``aggregate_round(codec=)`` / env
``REPRO_AGG_CODEC``, default ``"identity"``).

Builtins, those of the reference package with its payload layout:

  * ``identity`` — the raw f32 passthrough: ``encode`` returns its input
    object unchanged (zero-copy shard views survive), so nothing in the
    round path can observe the codec at all.
  * ``fp16`` — half-precision truncation, 2× smaller (``.to(float16)``
    on every device; the reference has no kernel for it).
  * ``qsgd8`` — per-tile symmetric int8 round-to-nearest with one f32
    scale per 4096-element tile, ~4× smaller. Encode and decode go through
    :mod:`repro_torch.kernels.quantize`: the hand-written kernels on a CUDA
    tensor, their plain versions on a CPU tensor.
  * ``topk`` — per-tile magnitude top-k (the bisection threshold of
    :mod:`repro_torch.kernels.topk_sparsify`, a kernel on CUDA), shipped
    as a sparse int32 index + f32 value payload with a fixed per-tile
    budget.

Lossy codecs are deterministic: encode and decode are pure functions of
the input bytes, equal bit for bit to the reference's on every device, so
``avg_flat`` stays identical across engines, schedules, read-ahead windows
and arrival permutations.
"""
from __future__ import annotations

import torch

from repro_torch import knobs
from repro_torch.config import AGG_COMPUTE_BPS
from repro_torch.kernels import ops as kops
from repro_torch.kernels.quantize import (BLOCK_ROWS, LANES, QMAX,  # noqa: F401
                                          TILE)
from repro_torch.kernels.quantize import tiles_of as _tiles_of
from repro_torch.kernels.topk_sparsify import BISECT_ITERS  # noqa: F401


# ---------------------------------------------------------------------------
# Payload
# ---------------------------------------------------------------------------

class WirePayload:
    """One encoded contribution as stored / transferred.

    ``nbytes`` is the codec's *declared* wire size (``codec.wire_bytes`` of
    the raw f32 size) — the store's op log, the runtime's GET latency and
    the memory accounting all read it, so every layer of the simulation
    sees the reduced transfer volume without knowing the codec exists.
    ``parts`` holds the in-memory representation (codes/scales/indices…);
    its exact tensor layout is a simulation artifact, not the wire format.
    ``codec_obj`` is the encoding codec *instance* — decode always goes
    back through the object that produced the payload, so an unregistered
    ``WireCodec`` instance passed as the knob round-trips correctly and a
    name collision with a registered codec can never mis-decode.
    """

    __slots__ = ("codec_obj", "parts", "n_elems", "raw_nbytes",
                 "_wire_nbytes")

    def __init__(self, codec_obj: "WireCodec", parts: dict, n_elems: int,
                 raw_nbytes: int, wire_nbytes: int):
        self.codec_obj = codec_obj
        self.parts = parts
        self.n_elems = int(n_elems)
        self.raw_nbytes = int(raw_nbytes)
        self._wire_nbytes = int(wire_nbytes)

    @property
    def codec(self) -> str:
        return self.codec_obj.name

    @property
    def nbytes(self) -> int:
        return self._wire_nbytes

    @property
    def shape(self) -> tuple:
        return (self.n_elems,)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"WirePayload(codec={self.codec!r}, elems={self.n_elems}, "
                f"wire={self._wire_nbytes}B of raw {self.raw_nbytes}B)")


class EncodedView:
    """Lazy decoded view of a :class:`WirePayload` (batched engine).

    Presents the payload as a logical f32 vector whose chunks decode on
    demand (:meth:`read`), so the deferred DAG evaluator fuses the decode
    into its cache-resident fold instead of materializing every decoded
    contribution up front. ``read(s, e)`` is bitwise
    ``decode(payload)[s:e]`` — chunking never moves arithmetic.
    """

    __slots__ = ("codec_obj", "payload", "_mat")

    dtype = torch.float32

    def __init__(self, codec_obj: "WireCodec", payload: WirePayload):
        self.codec_obj = codec_obj
        self.payload = payload
        self._mat: torch.Tensor | None = None

    @property
    def size(self) -> int:
        return self.payload.n_elems

    @property
    def shape(self) -> tuple:
        return (self.payload.n_elems,)

    @property
    def nbytes(self) -> int:
        return self.payload.n_elems * 4       # the *decoded* f32 size

    def read(self, start: int, stop: int) -> torch.Tensor:
        if self._mat is not None:
            return self._mat[start:stop]
        return self.codec_obj.decode_range(self.payload, start, stop)

    def materialize(self) -> torch.Tensor:
        if self._mat is None:
            self._mat = self.codec_obj.decode(self.payload)
        return self._mat


def _as_f32(shard) -> torch.Tensor:
    """Encoder input normalization: a tensor, an array or a zero-copy
    ShardView, as a contiguous 1-D f32 tensor on its own device."""
    if hasattr(shard, "materialize") and not isinstance(shard, torch.Tensor):
        shard = shard.materialize()
    return torch.as_tensor(shard, dtype=torch.float32).reshape(-1) \
        .contiguous()


# ---------------------------------------------------------------------------
# Codec interface + registry
# ---------------------------------------------------------------------------

class WireCodec:
    """Strategy interface for the on-the-wire contribution format."""

    name = "?"
    #: True when decode(encode(x)) == x bit-for-bit for every f32 input
    lossless = False

    # -- data plane ----------------------------------------------------------
    def encode(self, shard):
        """Shard (tensor or zero-copy view) -> what the client PUTs."""
        raise NotImplementedError

    def decode(self, payload: WirePayload) -> torch.Tensor:
        """Payload -> the f32 vector the aggregator folds."""
        raise NotImplementedError

    def decode_range(self, payload: WirePayload, start: int,
                     stop: int) -> torch.Tensor:
        """Bitwise ``decode(payload)[start:stop]`` without materializing
        the rest — the fused chunked-fold entry point. The default decodes
        fully; codecs override with a real ranged decode."""
        return self.decode(payload)[start:stop]

    # -- modeled platform terms ---------------------------------------------
    def wire_bytes(self, nbytes: int) -> int:
        """Declared wire size of a raw f32 object of ``nbytes``. Pure
        function — the upload schedule, the stored payload's ``nbytes``
        and the analytical cost model all use this one definition."""
        raise NotImplementedError

    def decode_cost_s(self, nbytes: int) -> float:
        """Modeled CPU seconds to decode one contribution of raw size
        ``nbytes`` (charged inside the aggregator invocation)."""
        return nbytes / AGG_COMPUTE_BPS

    # -- helpers -------------------------------------------------------------
    def _payload(self, parts: dict, n_elems: int) -> WirePayload:
        raw = n_elems * 4
        return WirePayload(self, parts, n_elems, raw,
                           self.wire_bytes(raw))


_REGISTRY: dict[str, WireCodec] = {}


def register_codec(name: str, *, replace: bool = False):
    """Class decorator: register a :class:`WireCodec` under ``name`` —
    the same public extension discipline as ``@register_topology``."""

    def deco(cls):
        if not replace and name in _REGISTRY:
            raise ValueError(
                f"codec {name!r} is already registered "
                f"({type(_REGISTRY[name]).__name__}); pass replace=True "
                f"to override")
        instance = cls() if isinstance(cls, type) else cls
        instance.name = name
        _REGISTRY[name] = instance
        return cls

    return deco


DEFAULT_CODEC = "identity"


def get_codec(codec: str | WireCodec | None = None) -> WireCodec:
    """Resolve the codec knob: an instance, a name, or ``None``/"auto"
    (env ``REPRO_AGG_CODEC``, else ``"identity"``)."""
    if isinstance(codec, WireCodec):
        return codec
    if codec is None or codec == "auto":
        codec = knobs.env_codec(DEFAULT_CODEC)
    try:
        return _REGISTRY[codec]
    except KeyError:
        raise ValueError(
            f"unknown wire codec {codec!r} (registered: "
            f"{sorted(_REGISTRY)})") from None


def available_codecs() -> tuple:
    return tuple(sorted(_REGISTRY))


# ---------------------------------------------------------------------------
# Builtins
# ---------------------------------------------------------------------------

@register_codec("identity")
class IdentityCodec(WireCodec):
    """Raw f32 passthrough — the pre-codec wire format, bit-identical by
    construction: ``encode`` returns the input object itself (zero-copy
    shard views included), so nothing downstream can tell the codec layer
    exists."""

    lossless = True

    def encode(self, shard):
        return shard

    def decode(self, payload):
        raise TypeError("identity contributions are stored raw — there is "
                        "no payload to decode")

    def wire_bytes(self, nbytes: int) -> int:
        return int(nbytes)

    def decode_cost_s(self, nbytes: int) -> float:
        return 0.0


@register_codec("fp16")
class Fp16Codec(WireCodec):
    """Half-precision truncation: 2× smaller, ~3 decimal digits kept."""

    def encode(self, shard):
        flat = _as_f32(shard)
        return self._payload({"half": flat.to(torch.float16)},
                             flat.shape[0])

    def decode(self, payload):
        return payload.parts["half"].to(torch.float32)

    def decode_range(self, payload, start, stop):
        return payload.parts["half"][start:stop].to(torch.float32)

    def wire_bytes(self, nbytes: int) -> int:
        return (int(nbytes) // 4) * 2


@register_codec("qsgd8")
class Qsgd8Codec(WireCodec):
    """Deterministic QSGD: per-``TILE`` symmetric int8 round-to-nearest
    with one f32 scale per tile. ~4× smaller. Codes and scales equal the
    reference's numpy mirror and Pallas kernel bit for bit."""

    def encode(self, shard):
        flat = _as_f32(shard)
        codes, scales, n = kops.qsgd_compress(flat)
        return self._payload({"codes": codes, "scales": scales}, n)

    def decode(self, payload):
        return self.decode_range(payload, 0, payload.n_elems)

    def decode_range(self, payload, start, stop):
        return kops.qsgd_decompress(payload.parts["codes"],
                                    payload.parts["scales"], start, stop)

    def wire_bytes(self, nbytes: int) -> int:
        elems = int(nbytes) // 4
        return elems + 4 * _tiles_of(elems)    # int8/elem + f32 scale/tile


@register_codec("topk")
class TopkCodec(WireCodec):
    """Per-tile magnitude top-k sparsification shipped sparse.

    The keep-mask is the bisection threshold of the reference's Pallas
    ``topk_sparsify`` (a block-local relaxation of global top-k; ties at
    the threshold may keep slightly more than k). The payload carries
    (int32 index, f32 value) pairs of the nonzero survivors (``-0.0``
    counts as zero, as in ``np.flatnonzero``); the declared wire size is
    the fixed per-tile budget ``k_per_block · 8`` bytes — a pure function
    of the raw size, which is what the cost model needs. Compaction and
    scatter are plain torch ops; on CUDA the compaction syncs the host
    once per encode (``torch.nonzero``).
    """

    k_per_block = 128                 # of TILE=4096: 32× fewer survivors,
                                      # 16× fewer bytes at 8 B/survivor

    def _sparsify(self, flat: torch.Tensor) -> torch.Tensor:
        """Dense tile-local top-k mask application (kernel semantics)."""
        return kops.topk_sparsify(flat, self.k_per_block)

    def encode(self, shard):
        flat = _as_f32(shard)
        dense = self._sparsify(flat)
        idx = torch.nonzero(dense).reshape(-1)
        return self._payload({"idx": idx.to(torch.int32),
                              "val": dense[idx]}, flat.shape[0])

    def decode(self, payload):
        idx = payload.parts["idx"]
        out = torch.zeros(payload.n_elems, dtype=torch.float32,
                          device=idx.device)
        out[idx.long()] = payload.parts["val"]
        return out

    def decode_range(self, payload, start, stop):
        idx = payload.parts["idx"]
        lo, hi = torch.searchsorted(
            idx, torch.tensor([start, stop], dtype=idx.dtype,
                              device=idx.device)).tolist()
        out = torch.zeros(stop - start, dtype=torch.float32,
                          device=idx.device)
        out[idx[lo:hi].long() - start] = payload.parts["val"][lo:hi]
        return out

    def wire_bytes(self, nbytes: int) -> int:
        elems = int(nbytes) // 4
        return _tiles_of(elems) * self.k_per_block * 8


# ---------------------------------------------------------------------------
# Decode plumbing shared by the engines and the round driver
# ---------------------------------------------------------------------------

def is_encoded(value) -> bool:
    return isinstance(value, WirePayload)


def decode_eager(payload: WirePayload) -> torch.Tensor:
    """Decode a payload with its own codec (streaming/incremental path)."""
    return payload.codec_obj.decode(payload)


def decode_lazy(payload: WirePayload) -> EncodedView:
    """Chunk-decodable view of a payload (batched engine path)."""
    return EncodedView(payload.codec_obj, payload)
