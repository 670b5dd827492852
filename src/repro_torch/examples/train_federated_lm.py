"""End to end: federated training of a transformer LM through the
serverless GradsSharding aggregation substrate.

The port's trainer is :mod:`repro_torch.launch.federated_lm`; this module
forwards to its ``main`` (``--smoke`` trains the reduced configuration;
without it, the full-width model).

Run:  PYTHONPATH=src python -m repro_torch.examples.train_federated_lm \
          --smoke --rounds 10 --clients 4 --shards 4 [--device cpu]
"""
from repro_torch.launch.federated_lm import main

if __name__ == "__main__":
    main()
