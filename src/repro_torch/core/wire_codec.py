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

The one builtin is ``identity``, the raw f32 passthrough: ``encode``
returns its input object unchanged (zero-copy shard views survive), so
nothing in the round path can observe the codec at all. The lossy codecs
of the reference package (``fp16``, ``qsgd8``, ``topk``) are not ported
yet; the interface, the payload and the lazy decode view they plug into
are.
"""
from __future__ import annotations

import torch

from repro_torch import knobs
from repro_torch.config import AGG_COMPUTE_BPS


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
