"""repro_torch: GradsSharding — serverless federated aggregation via
gradient partitioning, on PyTorch and CUDA.

Paper: "Shard the Gradient, Scale the Model" (A. Barrak, CS.DC 2026).
Client gradients, shard views and the round's mean are torch tensors on
the session's device; the event heap, Lambda runtime, cost model and the
seeded numpy streams that drive them are host-side control plane.
"""

__version__ = "0.1.0"

__all__ = ["FederatedSession", "SessionConfig", "register_topology",
           "available_topologies", "register_codec", "available_codecs"]


def __getattr__(name):
    # lazy: `import repro_torch` stays light; `from repro_torch import
    # FederatedSession` pulls the session API (and torch) on demand
    if name in ("FederatedSession", "SessionConfig"):
        from repro_torch import api
        return getattr(api, name)
    if name in ("register_topology", "available_topologies"):
        from repro_torch.core import topology
        return getattr(topology, name)
    if name in ("register_codec", "available_codecs"):
        from repro_torch.core import wire_codec
        return getattr(wire_codec, name)
    raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")
