"""The reference's seven examples on the port, one module each:
``python -m repro_torch.examples.<name> [--device cuda|cpu]``.

Each keeps the reference's command line, defaults, printout and
self-checks, adds only ``--device`` (``cuda`` unless the caller asks for
the CPU; ``cuda`` without a card raises), makes its gradients with numpy
from the reference's seeds, and its ``main(argv)`` returns what it
printed as a dict."""
