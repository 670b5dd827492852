"""Launch layer of the port: device meshes (``mesh``), partition specs
(``partitioning``), the single-program trainer and the multi-round
federated loop (``train``), the federated LM trainer (``federated_lm``),
the serving loop (``serve``) and the host helpers (``hostenv``)."""
